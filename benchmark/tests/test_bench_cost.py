"""The frozen cost arithmetic: against hand counts, the terms it shares with
the port's ``utils/roofline.py``, and below the port's count at a tiny
size."""

from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from benchmark import cost


def band(T, R, W, nnz_per_row):
    b = torch.zeros((T, R, W))
    b[:, :, :nnz_per_row] = 1.0
    return b


def fake(T=2, R=4, W=8, nnz=3, coarse=5, adv=False):
    K = band(T, R, W, nnz)
    sys = NS(Kband=K, Advband=band(T, R, W, 1) if adv else None,
             ndofs=T * R)
    p = band(T, R, 2, 1)
    lev = NS(sys=sys, bands=NS(p=p, r=p))
    ml = NS(levels=(lev,), Ainv=torch.zeros((3, coarse, coarse)))
    return sys, ml


def test_band_cost_by_hand():
    by, fl = cost._band_cost(100, 10, 3, dtype_bytes=4)
    assert by == 100 * 4 + 2 * 10 * 3 * 4
    assert fl == 2 * 100 * 3


def test_nonzeros():
    assert cost._nonzeros(band(2, 4, 8, 3)) == 24


def test_cg_solve_cost_by_hand():
    sys, ml = fake()
    B, n = 3, 8
    it = cost.iteration_cost(sys, ml, B, "cg", "hybrid")
    apply = (24 * 4 + 2 * n * B * 4, 2 * 24 * B)
    transfer = (8 * 4 + 2 * n * B * 4, 2 * 8 * B)
    coarse = (B * 25 * 4, 2 * B * 25)
    vectors = (6 * n * B * 4, 0)
    # hybrid: the one (fine) level is additive, so no level applies
    want_b = apply[0] + 2 * transfer[0] + coarse[0] + vectors[0]
    want_f = apply[1] + 2 * transfer[1] + coarse[1]
    assert it["bytes_per_iter"] == want_b
    assert it["flops_per_iter"] == want_f
    work = cost.solve_cost(sys, ml, B, iters=10, passes=3, krylov="cg",
                           cycle="hybrid")
    f64 = (24 * 8 + 2 * n * B * 8, 2 * 24 * B)
    assert work["bytes"] == 10 * want_b + 3 * f64[0]
    assert work["flops_f32"] == 10 * want_f
    assert work["flops_f64"] == 3 * f64[1]


@pytest.mark.parametrize("n_smooth", [1, 2])
def test_bicgstab_counts_two_applies_and_cycles(n_smooth):
    sys, ml = fake(adv=True)
    B, n = 3, 8
    it = cost.iteration_cost(sys, ml, B, "bicgstab", "mult", n_smooth)
    nnz = 24 + 8                      # K and the advection band
    apply_b = nnz * 4 + 2 * n * B * 4
    transfer_b = 8 * 4 + 2 * n * B * 4
    want = (2 * apply_b + 2 * (2 * n_smooth * apply_b + 2 * transfer_b)
            + 2 * B * 25 * 4 + 9 * n * B * 4)
    assert it["bytes_per_iter"] == want


def test_bound_seconds():
    pk = cost.chip_peaks("NVIDIA H100 80GB HBM3")
    c = {"bytes": 3.35e12, "flops_f32": 0.0, "flops_f64": 0.0}
    assert cost.bound_seconds(c, pk) == pytest.approx(1.0)
    c = {"bytes": 0.0, "flops_f32": 67e12, "flops_f64": 34e12}
    assert cost.bound_seconds(c, pk) == pytest.approx(2.0)
    with pytest.raises(ValueError):
        cost.chip_peaks("Some Other Card")


@pytest.fixture(scope="module")
def tiny_system():
    from fenics_eff_uptake_tpu_torch.parallel.sweep import \
        build_transport_system
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import \
        build_multilevel_for
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params)
    g = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                           mesh_size_dim=0.07)
    mesh = make_mesh(g, "sulcus")
    sys = build_transport_system(mesh, "cpu", element="P2")
    B = 4
    ml = build_multilevel_for(sys, mesh, [1.0] * B,
                              mu_values=list(np.linspace(0.1, 10, B)))
    assert ml is not None
    return sys, ml, B


def test_per_entry_terms_are_the_ports():
    """The terms the frozen copy shares with ``utils/roofline.py``: an
    element apply is the port's; a band whose every entry is nonzero costs
    the port's FLOPs and the port's bytes less its third vector stream."""
    from fenics_eff_uptake_tpu_torch.utils import roofline
    assert cost._elem_cost((50, 6, 6), 7) == roofline._elem_cost((50, 6, 6),
                                                                 7)
    T, R, W, B = 3, 16, 40, 5
    by, fl = cost._band_cost(T * R * W, T * R, B)
    pby, pfl = roofline._band_cost((T, R, W), B)
    assert fl == pfl and by == pby - T * R * B * 4


@pytest.mark.parametrize("cycle", ["hybrid", "mult", "add"])
def test_least_work_is_below_the_port_count(tiny_system, cycle):
    from fenics_eff_uptake_tpu_torch.utils.roofline import \
        ml_cg_iteration_cost as port_cost
    sys, ml, B = tiny_system
    least = cost.iteration_cost(sys, ml, B, "cg", cycle)
    port = port_cost(sys, ml, B, cycle=cycle)
    assert 0 < least["bytes_per_iter"] < port["bytes_per_iter"]
    assert least["flops_per_iter"] <= port["flops_per_iter"]
