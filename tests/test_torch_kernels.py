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
  input the CUDA kernels do not take raises in the argument checkers.  The
  band kernels take any batch width (B = 33 and 96 on the card).
* Column spans (``band_spans``): they cover every nonzero and are tight on
  random banded matrices, on the real K, Adv and transfer bands at
  h = 0.15 and on those of a mouth-refined mesh (factor 4, h = 0.1,
  larger than unrefined); a block without nonzeros gets an empty span;
  masking a band outside its spans changes nothing; malformed spans are
  refused.
* Kernel against plain on the card (marker ``cuda``; skipped without one),
  at one column (B = 1, the per-run models' width: kernels A and B, and C
  in both forms and per-sample) and
  including the no-uptake path's cases: wide batches (B = 33, 96) and the
  nonsymmetric advection band and element block; a span launch equals a
  full-span launch bit for bit, a B = 96 launch's columns equal a B = 3
  launch's, empty-span blocks and padding tiles give zero rows, kernel B
  with unaligned window starts and spans past ``n_cols`` matches plain, and
  a launch without spans raises; on the graded bands (factor 4) A and B
  match plain and equal the full-span launch.

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


def _sparse_band(rng, T, R, W, empty_tiles=(), empty_blocks=()):
    """A (T, R, W) f32 band whose rows hold nonzeros only in a random
    window of columns (as an assembled operator's do), with the given
    tiles and (tile, 64-row block) pairs all zero."""
    band = np.zeros((T, R, W), np.float32)
    for t in range(T):
        for r in range(R):
            a = int(rng.integers(0, W))
            b = min(W, a + 1 + int(rng.integers(0, W // 3 + 1)))
            band[t, r, a:b] = rng.standard_normal(b - a)
            band[t, r, a:b][rng.random(b - a) < 0.5] = 0.0
    for t in empty_tiles:
        band[t] = 0.0
    for t, k in empty_blocks:
        band[t, k * tb.SPAN_ROWS:(k + 1) * tb.SPAN_ROWS] = 0.0
    return band


def _full_spans(band):
    T, R, W = band.shape
    sp = torch.zeros((T, -(-R // tb.SPAN_ROWS), 2), dtype=torch.int32,
                     device=band.device)
    sp[..., 1] = -(-W // tb.SPAN_COLS)
    return sp


def _assert_spans_tight(band, spans):
    """Every nonzero of each row block lies in its span's chunks, the
    span's first and last chunk hold one, and empty blocks get [0, 0)."""
    band, spans = np.asarray(band), np.asarray(spans)
    T, R, W = band.shape
    SR, SC = tb.SPAN_ROWS, tb.SPAN_COLS
    assert spans.shape == (T, -(-R // SR), 2) and spans.dtype == np.int32
    for t in range(T):
        for k in range(spans.shape[1]):
            cols = np.flatnonzero(band[t, k * SR:(k + 1) * SR].any(0))
            lo, hi = spans[t, k]
            if len(cols) == 0:
                assert (lo, hi) == (0, 0)
                continue
            assert (lo, hi) == (cols[0] // SC, cols[-1] // SC + 1)


def _mask_outside(band, spans):
    """The band with every entry outside its blocks' spans set to zero."""
    T, R, W = band.shape
    w = torch.arange(W) // tb.SPAN_COLS
    rows = torch.arange(R) // tb.SPAN_ROWS
    lo = spans[:, rows, 0][..., None]
    hi = spans[:, rows, 1][..., None]
    return torch.where((w >= lo) & (w < hi), band, 0.0)


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
    Y = te.element_apply_plain(
        torch.as_tensor(A), torch.as_tensor(dofs, dtype=torch.int32), sc,
        torch.as_tensor(X), None if c is None else torch.as_tensor(c)).numpy()
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
    from fenics_eff_uptake_tpu_torch.parallel.sweep import _Block
    before = (tb.band_apply.launches, tb.rect_band_apply.launches,
              te.ElementKernel.launches)
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
    blk = _Block.build(eargs[0], dofs, Xe.shape[0])
    assert blk.kernels is None
    assert torch.equal(blk.apply_batched(*eargs[3:]),
                       te.element_apply_plain(*eargs))
    after = (tb.band_apply.launches, tb.rect_band_apply.launches,
             te.ElementKernel.launches)
    assert after == before


def test_checkers_refuse_unsupported_input():
    """What the CUDA kernels do not take raises in their argument checks
    (the CUDA path calls them before every launch); nothing truncates."""
    band, X, coef = (torch.as_tensor(a) for a in _band_case(1))
    # a dtype pair the kernel has no form for (f16 band; bf16 band, f32 X)
    with pytest.raises(TypeError, match="kernel takes"):
        tb.check_band_apply_args(band.half(), X, coef)
    with pytest.raises(TypeError, match="kernel takes"):
        tb.check_band_apply_args(band.bfloat16(), X, coef)
    # any width >= 1 is taken (wide batches run as column blocks)
    with pytest.raises(ValueError, match="B=0"):
        tb.check_band_apply_args(band, torch.zeros((X.shape[0], 0)))
    with pytest.raises(ValueError, match="CUDA device"):
        tb.check_band_apply_args(band, X, coef)

    rband, Xp = _rect_case(_UNALIGNED_OFFS)
    rband, offs, Xp = (torch.as_tensor(rband),
                       torch.as_tensor(_UNALIGNED_OFFS), torch.as_tensor(Xp))
    with pytest.raises(TypeError, match="kernel takes"):
        tb.check_rect_band_apply_args(rband.half(), offs, Xp)
    with pytest.raises(TypeError, match="kernel takes"):
        tb.check_rect_band_apply_args(rband, offs, Xp.bfloat16())
    with pytest.raises(ValueError, match="B=0"):
        tb.check_rect_band_apply_args(rband, offs,
                                      torch.zeros((Xp.shape[0], 0)))
    with pytest.raises(ValueError, match="CUDA device"):
        tb.check_rect_band_apply_args(rband, offs, Xp)

    A, dofs, Xe, c = _element_case(3, np.float32)
    At = torch.as_tensor(A)
    dt = torch.as_tensor(dofs, dtype=torch.int32)
    sc = te.make_scatter(dofs, Xe.shape[0], "cpu")
    Xt = torch.as_tensor(Xe)
    # kernel C checks a block where it binds it (ElementKernel)
    # a per-sample (B, N, nd, nd) block is taken like a shared one (here
    # refused only because it lies on the CPU); more dimensions are not
    with pytest.raises(ValueError, match="CUDA device"):
        te.ElementKernel(At[None].expand(5, -1, -1, -1).contiguous(), dt, sc)
    with pytest.raises(ValueError, match="nd, nd"):
        te.ElementKernel(At[None, None], dt, sc)
    with pytest.raises(TypeError):
        te._check_block(At.double(), dt, sc, Xt.dtype)
    with pytest.raises(ValueError, match="nd=4"):
        te.ElementKernel(torch.zeros((7, 4, 4)),
                         torch.zeros((7, 4), dtype=torch.int32), sc)
    with pytest.raises(ValueError, match="CUDA device"):
        te.ElementKernel(At, dt, sc)


# ---------------------------------------------------------------------------
# column spans (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,R,W", [(5, 256, 768), (3, 8, 24), (4, 100, 196)])
def test_band_spans_cover_and_are_tight(T, R, W):
    rng = np.random.default_rng(T * R + W)
    band = torch.as_tensor(_sparse_band(rng, T, R, W, empty_tiles=[T - 1]))
    spans = tb.band_spans(band)
    _assert_spans_tight(band, spans)
    assert torch.equal(_mask_outside(band, spans), band)
    # the plain versions ignore spans
    X = torch.as_tensor(rng.standard_normal((T * R, 3)).astype(np.float32))
    if (W // R) % 2 == 1 and W % R == 0:
        assert torch.equal(tb.band_apply(band, X, spans=spans),
                           tb.band_apply_plain(band, X))


def test_band_spans_of_empty_blocks():
    """A 64-row block without a nonzero (a padding tile, or padding rows)
    gets the empty span [0, 0); a block with one nonzero a one-chunk
    span."""
    band = torch.zeros((3, 256, 768))
    band[0, 70, 100] = 1.0           # block 1 of tile 0, chunk 3
    band[2, 255, 767] = -2.0         # last block and chunk of tile 2
    spans = tb.band_spans(band)
    want = np.zeros((3, 4, 2), np.int32)
    want[0, 1] = (3, 4)
    want[2, 3] = (23, 24)
    np.testing.assert_array_equal(spans.numpy(), want)
    assert spans.dtype == torch.int32 and spans.is_contiguous()


@pytest.fixture(scope="module")
def real_bands():
    """The port's K and Adv bands and fine transfer bands at h = 0.15 (the
    reference sulcus, a Poiseuille-like velocity)."""
    from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
    from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
    from fenics_eff_uptake_tpu_torch.parallel.sweep import \
        build_transport_system
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel, level_meshes_for)
    mesh = generate_mesh(width=10.0, height=1.0, sulcus_depth=1.0,
                         sulcus_width=0.5, mesh_size=0.15,
                         refinement_factor=1, domain_type="sulcus")
    V = FunctionSpace(mesh, "P2", vs=2)
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * V.dof_coords[:, 1] * (1.0 - V.dof_coords[:, 1])
    sys = build_transport_system(mesh, "cpu", u_values=u, u_space=V)
    ml = build_multilevel(sys, level_meshes_for(mesh), np.ones(2),
                          np.zeros(2))
    out = [("K", sys.Kband, sys.Kspans), ("Adv", sys.Advband, sys.Advspans)]
    for i, la in enumerate(ml.levels):
        tbs = la.bands
        out += [(f"level {i} K", la.sys.Kband, la.sys.Kspans),
                (f"level {i} p", tbs.p, tbs.ps),
                (f"level {i} r", tbs.r, tbs.rs)]
    return out


def test_band_spans_of_real_bands(real_bands):
    """The spans carried beside every band of a system and hierarchy cover
    its nonzeros tightly, and masking outside them changes nothing."""
    assert len(real_bands) >= 5
    for name, band, spans in real_bands:
        assert torch.equal(spans, tb.band_spans(band)), name
        _assert_spans_tight(band, spans)
        assert torch.equal(_mask_outside(band, spans), band), name
        # the spans skip something: less than the full width on average
        full = -(-band.shape[2] // tb.SPAN_COLS)
        assert float((spans[..., 1] - spans[..., 0]).float().mean()) < full


def _graded_bands(device, factor=4):
    """The K and Adv bands and the fine restriction and prolongation on
    the reference sulcus at h = 0.1 with its mouth refined ``factor``
    times (a Poiseuille-like velocity), on ``device``: [(name, band,
    spans, offs or None)], and the fine mesh."""
    from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
    from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
    from fenics_eff_uptake_tpu_torch.parallel.sweep import \
        build_transport_system
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel, level_meshes_for)
    mesh = generate_mesh(width=10.0, height=1.0, sulcus_depth=1.0,
                         sulcus_width=0.5, mesh_size=0.1,
                         refinement_factor=factor, domain_type="sulcus")
    V = FunctionSpace(mesh, "P2", vs=2)
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * V.dof_coords[:, 1] * (1.0 - V.dof_coords[:, 1])
    sys = build_transport_system(mesh, device, u_values=u, u_space=V)
    ml = build_multilevel(sys, level_meshes_for(mesh), np.ones(3),
                          np.zeros(3))
    t = ml.levels[0].bands
    return [("K", sys.Kband, sys.Kspans, None),
            ("Adv", sys.Advband, sys.Advspans, None),
            ("restrict", t.r, t.rs, t.ro),
            ("prolong", t.p, t.ps, t.po)], mesh


def test_band_spans_of_graded_bands():
    """On a mouth-refined mesh (factor 4) the bands are larger than on
    the same geometry unrefined, and their spans stay tight and cover
    every nonzero."""
    graded, mesh = _graded_bands("cpu")
    plain, mesh1 = _graded_bands("cpu", factor=1)
    assert mesh.hmin() < mesh1.hmin() / 2
    for g, p in zip(graded, plain):
        assert g[1].numel() > p[1].numel(), g[0]
    for name, band, spans, _ in graded:
        assert torch.equal(spans, tb.band_spans(band)), name
        _assert_spans_tight(band, spans)
        assert torch.equal(_mask_outside(band, spans), band), name
        assert tb.span_elements(band, spans) < band.numel(), name
    band, spans = graded[0][1], graded[0][2]
    assert tb.span_elements(band, _full_spans(band)) == band.numel()


def test_malformed_spans_are_refused():
    band = torch.zeros((3, 256, 768))
    dev = torch.device("cpu")
    good = tb.band_spans(band)
    tb._check_spans("band_apply", band, good, dev)
    with pytest.raises(ValueError, match="needs the band's spans"):
        tb._check_spans("band_apply", band, None, dev)
    with pytest.raises(ValueError, match="int32"):
        tb._check_spans("band_apply", band, good.long(), dev)
    with pytest.raises(ValueError, match=r"\(3, 4, 2\)"):
        tb._check_spans("band_apply", band, good[:, :3].contiguous(), dev)
    with pytest.raises(ValueError, match="contiguous"):
        tb._check_spans("rect_band_apply", band, good,
                        torch.device("meta"))


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_segment_sum_is_sequential(presorted):
    """The deterministic segment sum adds each segment in entry order,
    whether the plan sorts the ids itself or is handed a stable argsort,
    and leaves segments without entries at zero."""
    vals = torch.tensor([3.0, 1e8, 1.0, 4.0, -1e8], dtype=torch.float32)
    ids = np.array([2, 0, 0, 2, 0])
    if presorted:
        order = np.argsort(ids, kind="stable")
        plan = te.make_segment_plan(ids[order], 4, "cpu", order=order)
    else:
        plan = te.make_segment_plan(ids, 4, "cpu")
    assert plan.segs.tolist() == [0, 2]
    out = te.planned_segment_sum(vals, plan)
    ref = ((np.float32(1e8) + np.float32(1.0)) - np.float32(1e8))
    assert out[0].item() == ref
    assert out.tolist()[1:] == [0.0, 7.0, 0.0]
    full = te.make_segment_plan(np.array([1, 0, 1]), 2, "cpu")
    assert full.segs is None
    assert te.planned_segment_sum(torch.tensor([[1.0], [2.0], [3.0]]),
                                  full).tolist() == [[2.0], [4.0]]


# ---------------------------------------------------------------------------
# kernels against plain versions on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3, 20])
@pytest.mark.parametrize("with_coef", [False, True])
@pytest.mark.parametrize("halo", [1, 2])
def test_band_apply_kernel_matches_plain(cuda, halo, with_coef, B):
    band, X, coef = (torch.as_tensor(a, device=cuda)
                     for a in _band_case(halo, T=40, R=256, B=B))
    c = coef if with_coef else None
    n0 = tb.band_apply.launches
    spans = tb.band_spans(band)
    Y = tb.band_apply(band, X, c, spans=spans)
    assert tb.band_apply.launches == n0 + 1
    assert _rel(Y.cpu(), tb.band_apply_plain(band, X, c).cpu()) < 1e-5
    if B == 1:
        # one column sums in the order of any column of a wider launch
        Y2 = tb.band_apply(band, torch.cat([X, X], 1).contiguous(),
                           None if c is None else c.repeat(2), spans=spans)
        assert torch.equal(Y, Y2[:, :1]) and torch.equal(Y, Y2[:, 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [33, 96, 200])
def test_band_apply_kernel_wide_batch(cuda, B):
    """Wide batches take one band pass (one column block up to 96, blocks
    of 96 above); each column equals the plain version's and a narrow
    (B = 3) launch's bit for bit, across the 96-column block boundaries and
    in the last, partial block too."""
    band, X, coef = (torch.as_tensor(a, device=cuda)
                     for a in _band_case(2, T=40, R=256, B=B))
    spans = tb.band_spans(band)
    n0 = tb.band_apply.launches
    Y = tb.band_apply(band, X, coef, spans=spans)
    assert tb.band_apply.launches == n0 + 1
    assert _rel(Y.cpu(), tb.band_apply_plain(band, X, coef).cpu()) < 1e-5
    starts = [30] + ([95, 190, B - 3] if B > 96 else [])
    for c in starts:
        narrow = tb.band_apply(band, X[:, c:c + 3].contiguous(),
                               coef[c:c + 3].contiguous(), spans=spans)
        assert torch.equal(Y[:, c:c + 3], narrow), c


@pytest.mark.cuda
@pytest.mark.parametrize("R,W,B", [(256, 1536, 20), (8, 24, 3), (256, 1536, 2),
                                   (256, 1536, 1), (8, 24, 1),
                                   (256, 1536, 3), (256, 256, 33),
                                   (256, 1536, 96), (256, 384, 200)])
def test_rect_band_apply_kernel_matches_plain(cuda, R, W, B):
    offs = np.array([5, 77, 300, 301, 999], np.int32)
    band, Xp = _rect_case(offs, R=R, W=W, B=B)
    band, offs, Xp = (torch.as_tensor(a, device=cuda)
                      for a in (band, offs, Xp))
    n0 = tb.rect_band_apply.launches
    Y = tb.rect_band_apply(band, offs, Xp, tb.band_spans(band))
    assert tb.rect_band_apply.launches == n0 + 1
    assert _rel(Y.cpu(), tb.rect_band_apply_plain(band, offs, Xp).cpu()) \
        < 1e-5
    if B == 1:
        Y2 = tb.rect_band_apply(band, offs, torch.cat([Xp, Xp], 1)
                                .contiguous(), tb.band_spans(band))
        assert torch.equal(Y, Y2[:, :1]) and torch.equal(Y, Y2[:, 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 20])
@pytest.mark.parametrize("nd", [2, 3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_element_apply_kernel_matches_plain(cuda, dtype, nd, B):
    """Both forms (full; out=, added into a random out); B = 1 is the
    per-run models' width."""
    A, dofs, X, coef = _element_case(nd, dtype, N=5000, n=3000, B=B)
    sc = te.make_scatter(dofs, X.shape[0], cuda)
    args = (torch.as_tensor(A, device=cuda),
            torch.as_tensor(dofs, dtype=torch.int32, device=cuda), sc,
            torch.as_tensor(X, device=cuda), torch.as_tensor(coef,
                                                             device=cuda))
    k = te.ElementKernel(*args[:3])
    n0 = (te.ElementKernel.launches, te.ElementKernel.launches_out)
    Y = k(*args[3:])
    assert te.ElementKernel.launches == n0[0] + 1
    tol = 1e-12 if dtype == np.float64 else 2e-5
    assert _rel(Y.cpu(), te.element_apply_plain(*args).cpu()) < tol
    # no atomics: two launches agree bit for bit
    assert torch.equal(Y, k(*args[3:]))
    out = torch.randn(Y.shape, dtype=Y.dtype, device=cuda)
    got = k(*args[3:], out=out.clone())
    want = te.element_apply_plain(*args, out=out.clone())
    assert (te.ElementKernel.launches, te.ElementKernel.launches_out) == (
        n0[0] + 3, n0[1] + 1)
    assert _rel((got - out).cpu(), (want - out).cpu()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [2, 3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_element_apply_per_sample_kernel_at_one_column(cuda, dtype, nd):
    """Kernel C's per-sample form at B = 1 (a callable mu of one run), both
    forms, against plain."""
    A, dofs, X, _ = _element_case(nd, dtype, N=5000, n=3000, B=1)
    sc = te.make_scatter(dofs, X.shape[0], cuda)
    Ab = torch.as_tensor(A[None], device=cuda)
    dt = torch.as_tensor(dofs, dtype=torch.int32, device=cuda)
    Xt = torch.as_tensor(X, device=cuda)
    k = te.ElementKernel(Ab, dt, sc)
    n0 = te.ElementKernel.launches_sample
    Y = k(Xt)
    tol = 1e-12 if dtype == np.float64 else 2e-5
    assert _rel(Y.cpu(), te.element_apply_plain(Ab, dt, sc, Xt).cpu()) < tol
    out = torch.randn(Y.shape, dtype=Y.dtype, device=cuda)
    got = k(Xt, out=out.clone())
    want = te.element_apply_plain(Ab, dt, sc, Xt, out=out.clone())
    assert _rel((got - out).cpu(), (want - out).cpu()) < tol
    assert te.ElementKernel.launches_sample == n0 + 2


@pytest.mark.cuda
def test_band_values_on_card_equal_cpu(cuda):
    """The planned segment sums that scatter band values add in entry order
    on the card too: the square and transfer bands equal the CPU's bit for
    bit."""
    A, dofs, _, _ = _element_case(6, np.float64, N=120, n=512)
    plan = bp.build_band_plan(dofs, 512, tile=128)
    At = torch.as_tensor(A)
    assert torch.equal(tb.band_from_elements(At.to(cuda), plan).cpu(),
                       tb.band_from_elements(At, plan))
    cols, w = _random_transfer(np.random.default_rng(4), 1024, 273)
    for pm in bp.aligned_transfer_plans(cols, w, 1024, 273)[:2]:
        wt = torch.as_tensor(w)
        assert torch.equal(tb.rect_band_values(pm, wt.to(cuda)).cpu(),
                           tb.rect_band_values(pm, wt))


@pytest.mark.cuda
def test_advection_kernels_match_plain(cuda):
    """Kernels A and C on a real nonsymmetric advection operator: the Adv
    band at B = 3 (f32, 1e-5) and the f64 Adv element block at B = 3
    (1e-12), as the no-uptake transport solve applies them."""
    from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
    from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
    from fenics_eff_uptake_tpu_torch.parallel.sweep import \
        build_transport_system
    mesh = generate_mesh(width=10.0, height=1.0, sulcus_depth=1.0,
                         sulcus_width=0.5, mesh_size=0.1,
                         refinement_factor=1, domain_type="sulcus")
    V = FunctionSpace(mesh, "P2", vs=2)
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * V.dof_coords[:, 1] * (1.0 - V.dof_coords[:, 1])
    sys = build_transport_system(mesh, cuda, u_values=u, u_space=V)
    rng = np.random.default_rng(12)
    X = torch.as_tensor(rng.standard_normal((sys.ndofs, 3)), device=cuda)
    Y = tb.band_apply(sys.Advband, X.float(), spans=sys.Advspans)
    assert _rel(Y.cpu(), tb.band_apply_plain(sys.Advband, X.float()).cpu()) \
        < 1e-5
    blk = sys.Adv
    Ye = blk.apply_batched(X)
    Yp = te.element_apply_plain(blk.A64, blk.dofs, blk.scatter, X)
    assert _rel(Ye.cpu(), Yp.cpu()) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 20, 96])
def test_span_launch_equals_full_span_launch(cuda, B):
    """Streaming only the spans' chunks changes no bit against streaming
    every chunk, on a sparse band with empty tiles and empty blocks, whose
    rows in those blocks come out zero (coef applied)."""
    rng = np.random.default_rng(B)
    band = torch.as_tensor(_sparse_band(rng, 12, 256, 1280,
                                        empty_tiles=[0, 11],
                                        empty_blocks=[(4, 1), (5, 3)]),
                           device=cuda)
    X = torch.as_tensor(rng.standard_normal((12 * 256, B)).astype(
        np.float32), device=cuda)
    coef = torch.as_tensor(rng.random(B).astype(np.float32) + 0.5,
                           device=cuda)
    spans = tb.band_spans(band)
    Y = tb.band_apply(band, X, coef, spans=spans)
    assert torch.equal(Y, tb.band_apply(band, X, coef,
                                        spans=_full_spans(band)))
    assert _rel(Y.cpu(), tb.band_apply_plain(band, X, coef).cpu()) < 1e-5
    Yc = Y.cpu().reshape(12, 256, B)
    for t, rows in ((0, slice(None)), (11, slice(None)),
                    (4, slice(64, 128)), (5, slice(192, 256))):
        assert not Yc[t, rows].any()
    if B >= 3:
        narrow = tb.band_apply(band, X[:, :3].contiguous(),
                               coef[:3].contiguous(), spans=spans)
        assert torch.equal(Y[:, :3], narrow)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
def test_graded_band_kernels_match_plain(cuda, B):
    """Kernels A and B on the bands of a mouth-refined mesh (factor 4):
    A on the K band (with coef) and the Adv band, B on the fine
    restriction and prolongation, each within 1e-5 of plain and equal to
    the full-span launch bit for bit."""
    bands, _ = _graded_bands(cuda)
    rng = np.random.default_rng(70 + B)
    coef = torch.as_tensor(rng.random(B).astype(np.float32) + 0.5,
                           device=cuda)
    for name, band, spans, offs in bands:
        T, R, W = band.shape
        if offs is None:
            X = torch.as_tensor(rng.standard_normal((T * R, B)).astype(
                np.float32), device=cuda)
            cf = coef if name == "K" else None
            Y = tb.band_apply(band, X, cf, spans=spans)
            ref = tb.band_apply_plain(band, X, cf)
            full = tb.band_apply(band, X, cf, spans=_full_spans(band))
        else:
            n = int(offs.max()) + W
            X = torch.as_tensor(rng.standard_normal((n, B)).astype(
                np.float32), device=cuda)
            Y = tb.rect_band_apply(band, offs, X, spans)
            ref = tb.rect_band_apply_plain(band, offs, X)
            full = tb.rect_band_apply(band, offs, X, _full_spans(band))
        assert _rel(Y.cpu(), ref.cpu()) < 1e-5, name
        assert torch.equal(Y, full), name


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3, 20, 96])
def test_rect_span_launch_unaligned_past_n_cols(cuda, B):
    """Kernel B with unaligned window starts, windows and spans reaching
    past the last row of Xp: matches plain (which reads zeros there), and
    equals the full-span launch bit for bit."""
    rng = np.random.default_rng(40 + B)
    T, R, W = 6, 256, 384
    band = torch.as_tensor(_sparse_band(rng, T, R, W, empty_tiles=[2]),
                           device=cuda)
    offs = torch.tensor([0, 3, 97, 301, 555, 700], dtype=torch.int32,
                        device=cuda)
    n_cols = 800                     # offs[-1] + W = 1084 > n_cols
    Xp = torch.as_tensor(rng.standard_normal((n_cols, B)).astype(
        np.float32), device=cuda)
    spans = tb.band_spans(band)
    Y = tb.rect_band_apply(band, offs, Xp, spans)
    Xpad = torch.cat([Xp, torch.zeros((W, B), device=cuda)])
    ref = tb.rect_band_apply_plain(band, offs, Xpad)
    assert _rel(Y.cpu(), ref.cpu()) < 1e-5
    assert torch.equal(Y, tb.rect_band_apply(band, offs, Xp,
                                             _full_spans(band)))
    assert not Y.reshape(T, R, B)[2].any()


@pytest.mark.cuda
def test_launch_without_spans_raises(cuda):
    band, X, coef = (torch.as_tensor(a, device=cuda)
                     for a in _band_case(1, T=4, R=256, B=3))
    n0 = (tb.band_apply.launches, tb.rect_band_apply.launches)
    with pytest.raises(ValueError, match="spans"):
        tb.band_apply(band, X, coef)
    with pytest.raises(ValueError, match="spans"):
        tb.band_apply(band, X, coef, spans=tb.band_spans(band).cpu())
    offs = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="spans"):
        tb.rect_band_apply(band, offs, X)
    assert (tb.band_apply.launches, tb.rect_band_apply.launches) == n0
