"""What decides ``correct``: the program's outputs of a sample of the
window's requests, drawn from the seed, held to the plain reference
(``reference/``) once the window has closed.

Numbers compared, each against the limit in ``limits/<workload>.json``:

* ``mesh_gap``: the program's mesh against the remade one (exact: 0);
* ``residual``: the widest relative residual of a sampled column under the
  reference operator;
* ``metrics_gap``: the widest gap between a sampled column's flux, uptake,
  exchange, mass and mu_eff numbers and the reference's, from the same X;
* ``stokes_residual`` (advective cells): the widest relative residual of
  a sampled request's Stokes field under the reference Stokes operator.

``control=True`` puts the nearest lower precision in the program's place,
layer by layer: the program's own f32 solve (``Port`` is built with
``precision="f32"``), the reference's metrics computed in float32, and
the mesh and the Stokes field rounded to float32.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .reference import Geometry, metrics_gap, program_metrics

__all__ = ["Sampler", "load_limits", "host_copy", "judge"]

HERE = Path(__file__).resolve().parent


def load_limits(workload):
    with open(HERE / "limits" / f"{workload}.json") as f:
        return json.load(f)


class Sampler:
    """Keeps ``k`` of the window's completed requests, uniformly at random
    (reservoir sampling with a generator drawn from the seed), with their
    outputs; nothing is copied off the device while the window runs."""

    def __init__(self, k, seed):
        self.k = int(k)
        self.rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), 7]))
        self.kept = []
        self.seen = 0

    def offer(self, req, out):
        self.seen += 1
        item = (req, out)
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.kept[j] = item


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def host_copy(out):
    """A sampled outcome with its arrays on the host and the program's
    heavy objects dropped."""
    stokes = out["stokes"]
    return {"X": out["X"].detach().cpu().numpy(), "D": out["D"],
            "mu": out["mu"], "mesh": out["mesh"],
            "stokes": None if stokes is None else tuple(map(_host, stokes)),
            "metrics": program_metrics(*out["dicts"])}


def judge(cfg, samples, limits, control=False):
    """{name: [value, limit]} for every number compared, in the order
    above."""
    nums = {"mesh_gap": 0.0, "residual": 0.0, "metrics_gap": 0.0}
    if any(s["stokes"] is not None for _, s in samples):
        nums["stokes_residual"] = 0.0
    low = torch.float32 if control else torch.float64
    h, L, H = cfg["mesh_size_dim"], cfg["L_dim"], cfg["H_dim"]
    rf = cfg["refinement_factor"]
    refs = {}
    for req, s in samples:
        _, w, d = req["geometry"]
        u = None if s["stokes"] is None else s["stokes"][0]
        key = (w, d, id(u))           # one Stokes field judged once
        if key not in refs:
            g = Geometry(L / H, 1.0, w / H, d / H, h / H, rf)
            if u is not None:
                g.set_velocity(u)
                fu, fp = (a.astype(np.float32 if control else np.float64)
                          for a in s["stokes"])
                nums["stokes_residual"] = max(nums["stokes_residual"],
                                              g.stokes_residual(fu, fp))
            refs[key] = g
        g = refs[key]
        nums["mesh_gap"] = max(nums["mesh_gap"], g.mesh_gap(s["mesh"], low))
        nums["residual"] = max(nums["residual"], float(np.max(
            g.transport_residual(s["X"], s["D"], s["mu"]))))
        ref = g.metrics(s["X"], s["D"], s["mu"], u=u)
        prog = (g.metrics(s["X"], s["D"], s["mu"], u=u, dtype=low)
                if control else s["metrics"])
        nums["metrics_gap"] = max(nums["metrics_gap"],
                                  metrics_gap(prog, ref, g.area))
    return {k: [v, limits[k]] for k, v in nums.items()}
