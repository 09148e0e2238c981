"""The graded cell's path at a size a test run holds, on the CPU: the
factor-4 rung of w0.4/d2.0 at h = 0.07 (the ``el1.rung8`` configuration
with the mesh coarsened and the factor halved) through the benchmark's
``Port``, judged by its check against the plain reference.

* A sound request at the ladder's Pe (0.1, 1, 10) and mu = 0 reads
  correct under the cell's own limits: the mesh exact, every column's
  residual within twice rtol, its metrics within 1e-9 of the reference's,
  the Stokes field within twice its rtol.
* The control (the port's f32 solve, the reference's float32 metrics,
  mesh and Stokes field rounded to float32) reads not correct.
* On a mix of two geometries the Stokes field is solved again at every
  change of geometry: ``stokes_solves`` rises by one a request.
"""

import contextlib
import copy

import pytest
import torch

from benchmark.check import host_copy, judge, load_limits
from benchmark.manifest import Cell
from benchmark.port import Port
from fenics_eff_uptake_tpu_torch.utils import profiling

torch.set_num_threads(2)

CELL = "el1.rung8"
REQ = {"id": 0, "geometry": ("deep_large", 0.4, 2.0),
       "Pe": [0.1, 1.0, 10.0], "mu_factor": [0.0, 0.0, 0.0]}


def stage(name):
    return contextlib.nullcontext()


def config(**changes):
    cfg = copy.deepcopy(Cell(CELL).config)
    cfg.update({"mesh_size_dim": 0.07, "refinement_factor": 4, **changes})
    return cfg


@pytest.fixture(autouse=True)
def _cold(monkeypatch):
    monkeypatch.setenv("FEU_DISK_CACHE", "0")


def judged(control):
    cfg = config()
    port = Port(cfg, "cpu", control=control)
    port.setup(REQ["geometry"], stage)
    out = port.request(REQ, stage)
    sample = host_copy({k: out[k] for k in
                        ("X", "D", "mu", "mesh", "dicts", "stokes")})
    port.release()
    assert sample["mesh"].num_cells == 5670       # graded: 4,523 at 1
    return judge(cfg, [(REQ, sample)], load_limits(CELL), control=control)


def test_sound_request_is_correct():
    nums = judged(control=False)
    assert set(nums) == {"mesh_gap", "residual", "metrics_gap",
                         "stokes_residual"}
    assert nums["mesh_gap"][0] == 0.0
    assert nums["residual"] == [pytest.approx(nums["residual"][0]), 2e-12]
    assert nums["residual"][0] <= 2e-12
    assert nums["metrics_gap"][0] <= 1e-9
    assert nums["stokes_residual"][0] <= 2e-9


def test_control_is_not_correct():
    nums = judged(control=True)
    assert any(v > lim for v, lim in nums.values())
    assert nums["residual"][0] > nums["residual"][1]


def test_stokes_is_solved_again_at_every_change_of_geometry():
    port = Port(config(mesh_size_dim=0.1, refinement_factor=1), "cpu")
    a, b = ("square_small", 0.2, 0.2), ("mod_wide_small", 0.5, 0.3)
    n0 = profiling.stokes_solves
    port.setup(a, stage)
    assert profiling.stokes_solves == n0 + 1
    seen = []
    for i, g in enumerate((a, b, a)):
        port.request(dict(REQ, id=i, geometry=g), stage)
        seen.append(profiling.stokes_solves - n0)
    port.release()
    # the first request is on the set-up's geometry; then one a request
    assert seen == [1, 2, 3]
