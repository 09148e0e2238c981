"""The reader of the program's solve counters, and the program's span
recorder left off by the benchmark's runs."""

import sys
from types import SimpleNamespace

import pytest

from benchmark.harness import Run, _reader, run_cell
from benchmark.manifest import Cell

PROGRAM = "fenics_eff_uptake_tpu_torch.utils.profiling"
SEED = 2**35 + 7


def empty_run():
    return Run([{"id": 0, "seconds": 1.0, "points": 1, "traced": False,
                 "iters": [1], "stages": {"solve": 0.5}}], [])


@pytest.mark.parametrize("counters,value", [
    (SimpleNamespace(host_syncs=130, krylov_steps=100), 1.3),
    (SimpleNamespace(host_syncs=0, krylov_steps=0), None),
    (SimpleNamespace(), None),          # a program without the counters
    (None, None)])                      # the program not loaded
def test_host_syncs_per_step(monkeypatch, counters, value):
    if counters is None:
        monkeypatch.delitem(sys.modules, PROGRAM, raising=False)
    else:
        monkeypatch.setitem(sys.modules, PROGRAM, counters)
    got = _reader("host_syncs_per_step")(empty_run())
    assert got == (None if value is None else pytest.approx(value))


@pytest.mark.parametrize("trace", [0, 1])
def test_runs_leave_the_recorder_off(trace):
    """No run of the benchmark records a span; ``--trace 0`` reports the
    end-to-end metrics only, ``--trace 1`` the counter reader's ratio."""
    from fenics_eff_uptake_tpu_torch.utils import profiling
    seen = []

    def hook(port):
        for name in ("build_multilevel_for", "solve_sweep"):
            call = getattr(port, name)

            def watched(*a, _call=call, **kw):
                seen.append(profiling._recording)
                return _call(*a, **kw)
            setattr(port, name, watched)

    profiling.take()
    cell = Cell("noadv.mu_sweep")
    cell.config["mesh_size_dim"] = 0.07
    result = run_cell(cell, SEED, 1.0, trace, device="cpu", port_hook=hook)
    assert seen and not any(seen)
    assert profiling.take() == []
    assert result["correct"]
    if trace:
        assert 1.0 < result["metrics"]["host_syncs_per_step"]["value"] < 2.0
    else:
        assert set(result["metrics"]) == {"points_per_s", "setup_s"}
