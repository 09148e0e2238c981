"""Multigrid transfers on a mouth-refined mesh, where the windowed bands
need wider windows than the JAX package's width menu holds.

On a mesh refined toward the sulcus the restriction of a coarse P1 dof
gathers fine dofs whose bandwidth-ordered numbers spread over thousands of
columns: at h = 0.05 and refinement factor 16 (w0.4/d2.0, 27,589 cells)
the first mid level's restriction needs more than 4,096 columns at every
tile size.  The JAX package then falls back to its gather transfer; the
port widens the windows (``ops/band_plans._RECT_W_STEP``) so kernel B
still applies them.

* The JAX plan builder returns None on that restriction; the port's plan
  widens past the menu (a multiple of 1,024 columns), and a transfer that
  fits the menu gets the JAX package's plan as before.
* Every level's restriction and prolongation through the bands (plain
  version) equals the product with the transfer's sparse matrix (scipy,
  f64) to 1e-6 of its largest entry.
* On the card (marker ``cuda``): kernel B on the widened bands equals
  plain and the full-span launch bit for bit.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
import torch.nn.functional as F

from fenics_eff_uptake_tpu_torch.ops import band_plans as bp
from fenics_eff_uptake_tpu_torch.ops import banded as tb

torch.set_num_threads(2)


def _hierarchy(device):
    from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
    from fenics_eff_uptake_tpu_torch.parallel.sweep import \
        build_transport_system
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel, level_meshes_for)
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params
    p = _make_params(0.1, 0.4, 2.0, 0.05)
    p.refinement_factor = 16
    mesh = generate_mesh(domain_type="sulcus",
                         **p.get_mesh_generator_params())
    sys = build_transport_system(mesh, device)
    ml = build_multilevel(sys, level_meshes_for(mesh), np.ones(2),
                          np.zeros(2))
    return mesh, ml


@pytest.fixture(scope="module")
def graded():
    return _hierarchy("cpu")


def _matrix(tr, n_fine):
    cols = np.asarray(tr.cols)
    w = np.asarray(tr.weights, np.float64)
    rows = np.repeat(np.arange(cols.shape[0]), cols.shape[1])
    return sps.csr_matrix((w.ravel(), (rows, cols.ravel())),
                          shape=(n_fine, tr.n_coarse))


def test_wide_restriction_plan_where_jax_has_none(graded):
    from fenics_eff_uptake_tpu.ops.banded import aligned_transfer_plans
    mesh, ml = graded
    assert mesh.num_cells == 27589
    widths = [la.bands.r.shape[2] for la in ml.levels]
    wide = [l for l, w in enumerate(widths) if w > bp._RECT_W_MENU[-1]]
    assert wide, widths
    for l, la in enumerate(ml.levels):
        tr = la.transfer
        n_fine = la.free.shape[0]
        jax_plans = aligned_transfer_plans(np.asarray(tr.cols),
                                           np.asarray(tr.weights), n_fine,
                                           tr.n_coarse)
        if l in wide:
            assert jax_plans is None, l
            assert widths[l] % bp._RECT_W_STEP == 0
        else:
            assert jax_plans is not None, l
            # within the menu the plan is the one the menu gives
            assert widths[l] in bp._RECT_W_MENU


def test_graded_transfers_equal_their_matrices(graded):
    _, ml = graded
    rng = np.random.default_rng(5)
    for l, la in enumerate(ml.levels):
        t, tr = la.bands, la.transfer
        n_fine = la.free.shape[0]
        P = _matrix(tr, n_fine)
        R = rng.standard_normal((n_fine, 2)).astype(np.float32)
        Xq = F.pad(torch.as_tensor(R), (0, 0, 0, t.pad_r - n_fine))
        got = tb.rect_band_apply_plain(t.r, t.ro, Xq)[:tr.n_coarse][t.isig]
        want = P.T @ R.astype(np.float64)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
        Xc = rng.standard_normal((tr.n_coarse, 2)).astype(np.float32)
        Xs = torch.as_tensor(Xc)[t.sig]
        Xq = F.pad(Xs, (0, 0, 0, t.pad_p - tr.n_coarse))
        got = tb.rect_band_apply_plain(t.p, t.po, Xq)[:n_fine]
        want = P @ Xc.astype(np.float64)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_b_on_widened_bands(cuda):
    _, ml = _hierarchy(cuda)
    rng = np.random.default_rng(6)
    for la in ml.levels:
        t = la.bands
        for band, offs, spans, rows in ((t.r, t.ro, t.rs, t.pad_r),
                                        (t.p, t.po, t.ps, t.pad_p)):
            X = torch.as_tensor(rng.standard_normal((rows, 3)).astype(
                np.float32), device=cuda)
            Y = tb.rect_band_apply(band, offs, X, spans)
            ref = tb.rect_band_apply_plain(band, offs, X)
            err = float((Y - ref).abs().max() / ref.abs().max())
            assert err < 1e-5, band.shape
            full = torch.zeros_like(spans)
            full[..., 1] = -(-band.shape[2] // tb.SPAN_COLS)
            assert torch.equal(Y, tb.rect_band_apply(band, offs, X, full))
