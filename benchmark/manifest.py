"""``BENCHMARK.json`` read by name: a cell, its configuration file, its
traffic mix and the metrics it reports."""

from __future__ import annotations

import json
from pathlib import Path

from .traffic import load_mix

__all__ = ["Cell", "load_manifest"]

ROOT = Path(__file__).resolve().parents[1]


def load_manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _for(metrics, workload):
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]


class Cell:
    """One entry of ``workloads`` with what it names."""

    def __init__(self, workload, manifest=None):
        man = manifest or load_manifest()
        cells = {w["name"]: w for w in man["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(cells: {sorted(cells)})")
        w = cells[workload]
        self.name = workload
        self.chips = int(w["chips"])
        conf = {c["name"]: c for c in man["configs"]}[w["config"]]
        with open(ROOT / conf["file"]) as f:
            self.config = json.load(f)
        self.mix = load_mix(w["traffic"])
        self.end_to_end = _for(man["end_to_end"], workload)
        self.per_layer = _for(man["per_layer"], workload)
