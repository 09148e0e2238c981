"""The check at a size a test run holds (h = 0.07 mm, the multigrid path,
on the CPU): a sound run is correct; the control (the port's f32 solve,
the reference's float32 metrics, mesh and Stokes field rounded to float32)
is not; and nor is a run whose timed path is broken underneath, once for
each fault a one-chip sweep can have: a solve that returns its state
unchanged, half of the batch left out, and an answer altered where it is
produced (one entry of X; one metric).  These runs skip the harness's
look for a chip; ``readings.py`` makes the control's readings on the card
at the cells' own sizes."""

import pytest

from benchmark.harness import run_cell
from benchmark.manifest import Cell

CELLS = ("noadv.mu_sweep", "advdiff.flow_sweep", "noadv.geometry_sweep")
SEED = 2**35 + 99


def run(workload, **kw):
    cell = Cell(workload)
    cell.config["mesh_size_dim"] = 0.07
    return run_cell(cell, SEED, 1.0, 0, device="cpu", **kw)


def unchanged(port):
    from fenics_eff_uptake_tpu_torch.parallel.sweep import \
        unpermute_columns
    solve = port.solve_sweep

    def fault(sys, D, mu_values=None, **kw):
        X, info = solve(sys, D, mu_values=mu_values, **kw)
        lift = sys.bc_values[None].expand(X.shape[0], -1)
        return unpermute_columns(sys, lift).clone(), info
    port.solve_sweep = fault


def half(port):
    """Only the first half of the columns kept; the rest copied from it."""
    solve = port.solve_sweep

    def fault(sys, D, mu_values=None, **kw):
        X, info = solve(sys, D, mu_values=mu_values, **kw)
        h = (len(D) + 1) // 2
        return X[[i % h for i in range(len(D))]], info
    port.solve_sweep = fault


def altered_x(port):
    solve = port.solve_sweep

    def fault(sys, D, mu_values=None, **kw):
        X, info = solve(sys, D, mu_values=mu_values, **kw)
        X = X.clone()
        X[0, X.shape[1] // 2] *= 1.0 + 1e-6
        return X, info
    port.solve_sweep = fault


def altered_metric(port):
    metrics = port.metrics_to_dicts

    def fault(*a, **kw):
        flux, mass, mueff = metrics(*a, **kw)
        flux[0]["uptake_flux"] *= 1.0 + 1e-6
        return flux, mass, mueff
    port.metrics_to_dicts = fault


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "check"
    assert r["check"]["mesh_gap"][0] == 0.0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    r = run(workload, control=True)
    assert not r["correct"]
    # every number fails under the control
    assert all(v > lim for v, lim in r["check"].values()), r["check"]


@pytest.mark.parametrize("fault,number", [
    (unchanged, "residual"), (half, "residual"), (altered_x, "residual"),
    (altered_metric, "metrics_gap")])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, number):
    r = run(workload, port_hook=fault)
    assert not r["correct"]
    value, limit = r["check"][number]
    assert value > limit, r["check"]


def test_no_answer_is_not_correct():
    def raising(port):
        def fault(*a, **kw):
            raise RuntimeError("columns did not converge")
        port.solve_sweep = fault

    cell = Cell("noadv.mu_sweep")
    cell.config["mesh_size_dim"] = 0.07
    with pytest.raises(RuntimeError):      # the warm-up request raises
        run_cell(cell, SEED, 1.0, 0, device="cpu", port_hook=raising)
