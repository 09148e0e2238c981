"""The traffic generator, and each mix the request stream of the study it
stands for."""

import pytest

from benchmark.traffic import Traffic, load_mix

MIXES = ("mu_sweep", "flow_sweep", "geometry_sweep")


def take(mix, n):
    t = Traffic(load_mix(mix) if isinstance(mix, str) else mix)
    return [t.next() for _ in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_columns(mix):
    m = load_mix(mix)
    for r in take(mix, 40):
        for q, vs in m["columns"].items():
            assert r[q] == vs


def test_geometries_cycle_in_order():
    mix = {"geometries": [["a", 1, 2], ["b", 3, 4]],
           "columns": {"mu_factor": [1, 2], "Pe": [3, 4]}}
    reqs = take(mix, 5)
    assert [r["geometry"] for r in reqs] == [
        ("a", 1.0, 2.0), ("b", 3.0, 4.0)] * 2 + [("a", 1.0, 2.0)]
    assert [r["id"] for r in reqs] == list(range(5))
    reqs[0]["mu_factor"].append(9.0)          # a request is its own copy
    assert reqs[1]["mu_factor"] == [1.0, 2.0]


def test_unequal_columns_raise():
    with pytest.raises(ValueError):
        Traffic({"geometries": [["a", 1, 2]],
                 "columns": {"mu_factor": [1, 2], "Pe": [3]}})


def test_mu_sweep_is_run_mu_sweep():
    from fenics_eff_uptake_tpu_torch.studies.phase_a import MU_SWEEP_REGIMES
    r = take("mu_sweep", 1)[0]
    assert r["geometry"][1:] == (0.25, 0.25)
    assert r["mu_factor"] == [f for fs in MU_SWEEP_REGIMES.values()
                              for f in fs]


def test_flow_sweep_is_the_step_validation_grid():
    from fenics_eff_uptake_tpu_torch.studies.adv_diff import (
        MU_FACTORS, PE_VALUES, REFERENCE_GEOMETRY)
    r = take("flow_sweep", 1)[0]
    assert r["geometry"][1:] == (REFERENCE_GEOMETRY["sulci_w_dim"],
                                 REFERENCE_GEOMETRY["sulci_h_dim"])
    cells = [(pe, mf) for pe in PE_VALUES for mf in MU_FACTORS]
    assert list(zip(r["Pe"], r["mu_factor"])) == cells


def test_geometry_sweep_is_the_studys_order():
    from fenics_eff_uptake_tpu_torch.params import (
        Parameters, create_geometry_variations)
    study = create_geometry_variations(Parameters(mode="no-adv"),
                                       max_width=1.0)
    want = [(k, v["sulci_w_dim"], v["sulci_h_dim"]) for k, v in study.items()]
    assert len(want) == 23
    reqs = take("geometry_sweep", 46)
    assert [r["geometry"] for r in reqs] == want + want
    assert all(r["mu_factor"] == [0.1, 1.0, 10.0] for r in reqs)
