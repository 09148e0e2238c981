"""The port's three kernels and their plain versions.

* Plain versions against the JAX package: kernel C against
  ``_Block.apply_batched`` and against ``element_apply_pallas`` (interpret
  mode) + sorted segment-sum; kernel A against ``ops.banded.band_apply``
  and ``band_apply_pallas`` (interpret); kernel B against
  ``rect_band_apply_ref`` and ``rect_band_apply_pallas``, with window
  starts that are not multiples of 8 or 16.  Tolerances: 1e-12 relative in
  f64; in f32 2e-5 for kernel C (as tests/test_banded.py holds the element
  and band paths) and 1e-5 for the band kernels (as test_banded.py holds
  band_apply_pallas), both from summation order.
* Wrapper guards: CPU tensors take the plain version and count no launch;
  input the CUDA kernels do not take raises in the argument checkers.
* Kernel against plain on the card (marker ``cuda``; skipped without one).

The JAX side is imported inside a fixture, so the file also runs where jax
is absent: ``python -m pytest tests/test_torch_kernels.py -m cuda
--noconftest`` on the GPU machine.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.ops import band_plans as bp
from fenics_eff_uptake_tpu_torch.ops import banded as tb
from fenics_eff_uptake_tpu_torch.ops import elemspmv as te

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from fenics_eff_uptake_tpu.ops import banded, pallas_kernels
    from fenics_eff_uptake_tpu.parallel.sweep import _Block
    return SimpleNamespace(jax=jax, jnp=jnp, banded=banded,
                           pk=pallas_kernels, Block=_Block)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _element_case(nd, dtype, seed=0, N=200, n=150, B=5):
    rng = np.random.default_rng(seed + nd)
    dofs = np.stack([rng.choice(n, nd, replace=False) for _ in range(N)])
    A = rng.standard_normal((N, nd, nd)).astype(dtype)
    X = rng.standard_normal((n, B)).astype(dtype)
    coef = (rng.random(B) + 0.5).astype(dtype)
    return A, dofs, X, coef


def _band_case(halo, seed=7, T=6, R=8, B=5):
    rng = np.random.default_rng(seed)
    W = (2 * halo + 1) * R
    band = rng.standard_normal((T, R, W)).astype(np.float32)
    X = rng.standard_normal((T * R, B)).astype(np.float32)
    coef = (rng.random(B) + 0.5).astype(np.float32)
    return band, X, coef


_UNALIGNED_OFFS = np.array([0, 3, 17, 41, 70, 77], np.int32)


def _rect_case(offs, seed=11, R=8, W=24, B=4):
    rng = np.random.default_rng(seed)
    T = len(offs)
    band = rng.standard_normal((T, R, W)).astype(np.float32)
    Xp = rng.standard_normal((int(offs.max()) + W + 3, B)).astype(
        np.float32)
    return band, Xp


# ---------------------------------------------------------------------------
# plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_coef", [False, True])
@pytest.mark.parametrize("nd", [2, 3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_element_apply_plain_matches_jax(jx, dtype, nd, with_coef):
    jnp = jx.jnp
    A, dofs, X, coef = _element_case(nd, dtype)
    n, B = X.shape
    c = coef if with_coef else None
    sc = te.make_scatter(dofs, n, "cpu")
    Y = te.element_apply(torch.as_tensor(A),
                         torch.as_tensor(dofs, dtype=torch.int32), sc,
                         torch.as_tensor(X),
                         None if c is None else torch.as_tensor(c)).numpy()
    perm = np.argsort(dofs.ravel(), kind="stable")
    ids = dofs.ravel()[perm]
    blk = jx.Block(A64=jnp.asarray(A), A32=jnp.asarray(A),
                   dofs=jnp.asarray(dofs, jnp.int32),
                   perm=jnp.asarray(perm, jnp.int32),
                   ids_sorted=jnp.asarray(ids, jnp.int32), ndofs=n)
    Yj = blk.apply_batched(jnp.asarray(X), f32=dtype == np.float32,
                           coef=None if c is None else jnp.asarray(c))
    ones = np.ones(B, dtype)
    Ye = jx.pk.element_apply_pallas(jnp.asarray(A),
                                    jnp.asarray(X)[jnp.asarray(dofs)],
                                    jnp.asarray(ones if c is None else c),
                                    tile=64)
    Yp = jx.jax.ops.segment_sum(
        Ye.reshape(-1, B)[jnp.asarray(perm)], jnp.asarray(ids),
        num_segments=n, indices_are_sorted=True)
    assert Y.dtype == dtype
    tol = 1e-12 if dtype == np.float64 else 2e-5
    assert _rel(Y, Yj) < tol
    assert _rel(Y, Yp) < tol


@pytest.mark.parametrize("with_coef", [False, True])
@pytest.mark.parametrize("halo", [1, 2])
def test_band_apply_plain_matches_jax(jx, halo, with_coef):
    jnp = jx.jnp
    band, X, coef = _band_case(halo)
    c = coef if with_coef else None
    Y = tb.band_apply(torch.as_tensor(band), torch.as_tensor(X),
                      None if c is None else torch.as_tensor(c)).numpy()
    cj = None if c is None else jnp.asarray(c)
    Yj = jx.banded.band_apply(jnp.asarray(band), jnp.asarray(X), coef=cj)
    Yp = jx.pk.band_apply_pallas(jnp.asarray(band), jnp.asarray(X),
                                 coef=cj, interpret=True)
    assert _rel(Y, Yj) < 1e-5
    assert _rel(Y, Yp) < 1e-5


@pytest.mark.parametrize("offs", [np.array([0, 16, 32, 48, 64], np.int32),
                                  _UNALIGNED_OFFS],
                         ids=["aligned16", "unaligned"])
def test_rect_band_apply_plain_matches_jax(jx, offs):
    jnp = jx.jnp
    band, Xp = _rect_case(offs)
    Y = tb.rect_band_apply(torch.as_tensor(band), torch.as_tensor(offs),
                           torch.as_tensor(Xp)).numpy()
    Yj = jx.banded.rect_band_apply_ref(jnp.asarray(band), jnp.asarray(offs),
                                       jnp.asarray(Xp))
    Yp = jx.pk.rect_band_apply_pallas(jnp.asarray(band), jnp.asarray(offs),
                                      jnp.asarray(Xp))
    assert _rel(Y, Yj) < 1e-5
    assert _rel(Y, Yp) < 1e-5


def test_band_from_elements_matches_jax(jx):
    jnp = jx.jnp
    A, dofs, _, _ = _element_case(6, np.float64, N=120, n=512)
    plan = bp.build_band_plan(dofs, 512, tile=128)
    got = tb.band_from_elements(torch.as_tensor(A), plan).numpy()
    jplan = jx.banded.BandPlan(
        perm=jnp.asarray(plan.perm), ids_sorted=jnp.asarray(plan.ids_sorted),
        tiles=plan.tiles, tile=plan.tile, width=plan.width, halo=plan.halo)
    ref = np.asarray(jx.banded.band_from_elements(jnp.asarray(A), jplan))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # the band reproduces the assembled operator
    Y = tb.band_apply(torch.as_tensor(got),
                      torch.eye(512)[:, :8].contiguous()).numpy()
    dense = np.zeros((512, 512))
    for li in range(6):
        for lj in range(6):
            np.add.at(dense, (dofs[:, li], dofs[:, lj]), A[:, li, lj])
    assert _rel(Y, dense[:, :8]) < 1e-6


def _random_transfer(rng, nf, nc):
    base = (np.arange(nf) * nc) // nf
    cols = np.clip(base[:, None] + rng.integers(-3, 4, size=(nf, 3)), 0,
                   nc - 1)
    w = rng.random((nf, 3)).astype(np.float32)
    w[rng.random(nf) < 0.1] = 0.0
    return cols, w


def test_transfer_plans_and_values_match_jax(jx):
    """Windowed transfer bands built by the port (unaligned window starts,
    no pad rounding) apply the same restriction / prolongation as the JAX
    plans and values (f32, 2e-4 absolute as tests/test_banded.py)."""
    jnp = jx.jnp
    rng = np.random.default_rng(7)
    nf, nc, B = 1024, 273, 5
    cols, w = _random_transfer(rng, nf, nc)
    mine = bp.aligned_transfer_plans(cols, w, nf, nc)
    ref = jx.banded.aligned_transfer_plans(cols, w, nf, nc)
    np.testing.assert_array_equal(mine[2], ref[2])
    np.testing.assert_array_equal(mine[3], ref[3])
    Xc = rng.random((nc, B)).astype(np.float32)[mine[2]]
    Xf = rng.random((nf, B)).astype(np.float32)
    for k, (X, n_out) in enumerate(((Xc, nf), (Xf, nc))):
        pm, pr = mine[k], ref[k]
        band = tb.rect_band_values(pm, torch.as_tensor(w))
        Xq = torch.zeros((pm.n_cols_pad, B))
        Xq[:len(X)] = torch.as_tensor(X)
        Y = tb.rect_band_apply(band, torch.as_tensor(pm.offs), Xq)[:n_out]
        band_j = jx.banded.rect_band_values(pr, jnp.asarray(w))
        Xqj = jnp.pad(jnp.asarray(X), ((0, pr.n_cols_pad - len(X)), (0, 0)))
        Yj = jx.banded.rect_band_apply_ref(band_j, jnp.asarray(pr.offs),
                                           Xqj)[:n_out]
        np.testing.assert_allclose(Y.numpy(), np.asarray(Yj), atol=2e-4)


def test_bandwidth_permutation_matches_jax(jx):
    from fenics_eff_uptake_tpu.fem.space import FunctionSpace
    from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
    m = generate_mesh(width=10.0, height=1.0, sulcus_depth=0.25,
                      sulcus_width=0.25, mesh_size=0.15, refinement_factor=1,
                      domain_type="sulcus")
    sp = FunctionSpace(m, "P2")
    ed, xy, n = np.asarray(sp.cell_dofs), np.asarray(sp.dof_coords), \
        sp.ndofs
    npad = -(-n // 256) * 256
    for mine, ref in ((bp.rcm_permutation(ed, n, npad),
                       jx.banded.rcm_permutation(ed, n, npad)),
                      (bp.best_bandwidth_permutation(ed, xy, n, npad),
                       jx.banded.best_bandwidth_permutation(ed, xy, n,
                                                            npad))):
        np.testing.assert_array_equal(mine[0], ref[0])
        np.testing.assert_array_equal(mine[1], ref[1])


# ---------------------------------------------------------------------------
# wrapper guards (CPU)
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_plain_and_count_no_launch():
    before = (tb.band_apply.launches, tb.rect_band_apply.launches,
              te.element_apply.launches)
    band, X, coef = _band_case(1)
    bt, Xt, ct = map(torch.as_tensor, (band, X, coef))
    assert torch.equal(tb.band_apply(bt, Xt, ct),
                       tb.band_apply_plain(bt, Xt, ct))
    rband, Xp = _rect_case(_UNALIGNED_OFFS)
    args = (torch.as_tensor(rband), torch.as_tensor(_UNALIGNED_OFFS),
            torch.as_tensor(Xp))
    assert torch.equal(tb.rect_band_apply(*args),
                       tb.rect_band_apply_plain(*args))
    A, dofs, Xe, c = _element_case(6, np.float64)
    sc = te.make_scatter(dofs, Xe.shape[0], "cpu")
    eargs = (torch.as_tensor(A), torch.as_tensor(dofs, dtype=torch.int32),
             sc, torch.as_tensor(Xe), torch.as_tensor(c))
    assert torch.equal(te.element_apply(*eargs),
                       te.element_apply_plain(*eargs))
    after = (tb.band_apply.launches, tb.rect_band_apply.launches,
             te.element_apply.launches)
    assert after == before


def test_checkers_refuse_unsupported_input():
    """What the CUDA kernels do not take raises in their argument checks
    (the CUDA path calls them before every launch); nothing truncates."""
    band, X, coef = (torch.as_tensor(a) for a in _band_case(1))
    with pytest.raises(TypeError, match="f32"):
        tb.check_band_apply_args(band.bfloat16(), X, coef)
    wide = torch.zeros((X.shape[0], tb.MAX_BAND_COLS + 1))
    with pytest.raises(ValueError, match="B=33"):
        tb.check_band_apply_args(band, wide)
    with pytest.raises(ValueError, match="CUDA device"):
        tb.check_band_apply_args(band, X, coef)

    rband, Xp = _rect_case(_UNALIGNED_OFFS)
    rband, offs, Xp = (torch.as_tensor(rband),
                       torch.as_tensor(_UNALIGNED_OFFS), torch.as_tensor(Xp))
    with pytest.raises(TypeError, match="f32"):
        tb.check_rect_band_apply_args(rband.bfloat16(), offs, Xp)
    with pytest.raises(ValueError, match="B=33"):
        tb.check_rect_band_apply_args(
            rband, offs, torch.zeros((Xp.shape[0], tb.MAX_BAND_COLS + 1)))
    with pytest.raises(ValueError, match="CUDA device"):
        tb.check_rect_band_apply_args(rband, offs, Xp)

    A, dofs, Xe, c = _element_case(3, np.float32)
    At = torch.as_tensor(A)
    dt = torch.as_tensor(dofs, dtype=torch.int32)
    sc = te.make_scatter(dofs, Xe.shape[0], "cpu")
    Xt = torch.as_tensor(Xe)
    with pytest.raises(NotImplementedError, match="per-sample"):
        te.check_element_apply_args(At[None].expand(5, -1, -1, -1), dt, sc,
                                    Xt)
    with pytest.raises(TypeError):
        te.check_element_apply_args(At.double(), dt, sc, Xt)
    with pytest.raises(ValueError, match="nd=4"):
        te.check_element_apply_args(torch.zeros((7, 4, 4)),
                                    torch.zeros((7, 4), dtype=torch.int32),
                                    sc, Xt)
    with pytest.raises(ValueError, match="CUDA device"):
        te.check_element_apply_args(At, dt, sc, Xt)


def test_sorted_segment_sum_is_sequential():
    """The deterministic segment sum adds each segment in sorted order."""
    vals = torch.tensor([1e8, 1.0, -1e8, 3.0, 4.0], dtype=torch.float32)
    ids = torch.tensor([0, 0, 0, 2, 2])
    out = te.sorted_segment_sum(vals, ids, 4)
    ref = ((np.float32(1e8) + np.float32(1.0)) - np.float32(1e8))
    assert out[0].item() == ref
    assert out.tolist()[1:] == [0.0, 7.0, 0.0]


# ---------------------------------------------------------------------------
# kernels against plain versions on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("with_coef", [False, True])
@pytest.mark.parametrize("halo", [1, 2])
def test_band_apply_kernel_matches_plain(cuda, halo, with_coef):
    band, X, coef = (torch.as_tensor(a, device=cuda)
                     for a in _band_case(halo, T=40, R=256, B=20))
    c = coef if with_coef else None
    n0 = tb.band_apply.launches
    Y = tb.band_apply(band, X, c)
    assert tb.band_apply.launches == n0 + 1
    assert _rel(Y.cpu(), tb.band_apply_plain(band, X, c).cpu()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("R,W,B", [(256, 1536, 20), (8, 24, 3)])
def test_rect_band_apply_kernel_matches_plain(cuda, R, W, B):
    offs = np.array([5, 77, 300, 301, 999], np.int32)
    band, Xp = _rect_case(offs, R=R, W=W, B=B)
    band, offs, Xp = (torch.as_tensor(a, device=cuda)
                      for a in (band, offs, Xp))
    n0 = tb.rect_band_apply.launches
    Y = tb.rect_band_apply(band, offs, Xp)
    assert tb.rect_band_apply.launches == n0 + 1
    assert _rel(Y.cpu(), tb.rect_band_apply_plain(band, offs, Xp).cpu()) \
        < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [2, 3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_element_apply_kernel_matches_plain(cuda, dtype, nd):
    A, dofs, X, coef = _element_case(nd, dtype, N=5000, n=3000, B=20)
    sc = te.make_scatter(dofs, X.shape[0], cuda)
    args = (torch.as_tensor(A, device=cuda),
            torch.as_tensor(dofs, dtype=torch.int32, device=cuda), sc,
            torch.as_tensor(X, device=cuda), torch.as_tensor(coef,
                                                             device=cuda))
    n0 = te.element_apply.launches
    Y = te.element_apply(*args)
    assert te.element_apply.launches == n0 + 1
    tol = 1e-12 if dtype == np.float64 else 2e-5
    assert _rel(Y.cpu(), te.element_apply_plain(*args).cpu()) < tol
    # no atomics: two launches agree bit for bit
    assert torch.equal(Y, te.element_apply(*args))
