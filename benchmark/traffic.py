"""The one traffic generator: a mix is a data file ``traffic/<mix>.json``
of parameters, and this turns it into the stream of requests a cell's
single client sends, one after another (a closed loop).

A mix gives:

* ``geometries``: ``[[name, w_mm, d_mm], ...]``, sent round and round in
  the listed order (one entry: every request on one sulcus);
* ``columns``: for each per-column quantity (``mu_factor``; ``Pe`` for an
  advective configuration) its values, one per sweep column, the same in
  every request.

Each request is a study's first visit to its geometry: the port's
in-process memos are emptied before it (``Port.request``).  The stream is
the studies' own, the same for every seed; the seed draws the check's
sample (``check.Sampler``).
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["load_mix", "Traffic"]

HERE = Path(__file__).resolve().parent


def load_mix(name):
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


class Traffic:
    """The requests of one mix: ``next()`` gives the next one, a dict with
    ``id``, ``geometry`` (name, w_mm, d_mm) and one list per column
    quantity."""

    def __init__(self, mix):
        self.geometries = [(str(n), float(w), float(d))
                           for n, w, d in mix["geometries"]]
        self.columns = {q: [float(v) for v in vs]
                        for q, vs in mix["columns"].items()}
        if len({len(vs) for vs in self.columns.values()}) != 1:
            raise ValueError(f"columns of unequal length: {mix['columns']}")
        self.sent = 0

    def next(self):
        req = {"id": self.sent,
               "geometry": self.geometries[self.sent % len(self.geometries)],
               **{q: list(vs) for q, vs in self.columns.items()}}
        self.sent += 1
        return req
