"""The bf16 operand forms of kernels A, B and C.

* Plain versions against the JAX package on bf16 inputs made from a numpy
  seed: kernel A against ``band_apply_pallas`` and kernel B (both forms)
  against ``rect_band_apply_pallas`` in interpret mode, kernel C against
  ``_Block.apply_batched``.  Both sides of A and B sum exact bf16 x bf16
  products in f32 and round once, so they differ by summation order only:
  f32 outputs within 1e-5 of the row's sum of |terms|, bf16 outputs within
  one bf16 ulp of each other where no cancellation enlarges the rounding
  step (and within 2^-8 of the sum of |terms| everywhere).  JAX's element
  apply rounds every multiply-add and every segment-sum step to bf16, the
  port rounds once: they are held within (nd + entries per row) * 2^-8 of
  the sum of |terms|, and the port within one rounding of the exact value.
* The plain versions compute what they say: upcast, f32 sums, one rounding,
  never a bf16 accumulator.
* ``check_*_args`` take exactly the listed dtype pairs.  The spans of an f32
  band are the spans of its bf16 copy.
* Kernel against plain on the card (marker ``cuda``; skipped without one),
  for every way the kernels copy X (B odd, even, a multiple of 8), with and
  without coef, full and ``out=`` forms, shared and per-sample A: f32
  output within 1e-5 of the sum of |terms|; bf16 output equal to plain's in
  at least 99% of the entries and within one bf16 ulp of it, except where
  cancellation leaves a result so far below its terms that the f32 sums'
  order (1e-5 of the sum of |terms|, the f32 bound) spans several of its
  ulps: there that bound holds.

Runs without jax too (``-m cuda --noconftest`` on the GPU machine).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.ops import banded as tb
from fenics_eff_uptake_tpu_torch.ops import elemspmv as te

torch.set_num_threads(2)
BF16 = torch.bfloat16
EPS = 2.0 ** -8          # half a bf16 ulp of 1: the relative rounding error


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from fenics_eff_uptake_tpu.ops import pallas_kernels
    from fenics_eff_uptake_tpu.parallel.sweep import _Block
    return SimpleNamespace(jax=jax, jnp=jnp, pk=pallas_kernels, Block=_Block)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16_np(a):
    """numpy f32 values rounded to bf16 (kept as f32)."""
    return torch.as_tensor(a, dtype=torch.float32).to(BF16).float().numpy()


def _jbf16(jx, a):
    return jx.jnp.asarray(a, dtype=jx.jnp.bfloat16)


def ulps(a, b):
    """Distance of two bf16 tensors in bf16 steps, elementwise."""
    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def _band_case(halo, seed, T=6, R=8, B=5, sparse=False):
    rng = np.random.default_rng(seed)
    W = (2 * halo + 1) * R
    band = _bf16_np(rng.standard_normal((T, R, W)))
    if sparse:
        band[rng.random(band.shape) < 0.6] = 0.0
    X = _bf16_np(rng.standard_normal((T * R, B)))
    coef = _bf16_np(rng.random(B) + 0.5)
    return band, X, coef


def _rect_case(offs, seed, R=8, W=24, B=4):
    rng = np.random.default_rng(seed)
    band = _bf16_np(rng.standard_normal((len(offs), R, W)))
    Xp = rng.standard_normal((int(offs.max()) + W + 3, B)).astype(np.float32)
    return band, Xp


def _band_terms(band, X, coef=None):
    """(exact f64 result, sum of |terms|) of kernel A on these values."""
    T, R, W = band.shape
    halo = (W // R - 1) // 2
    Xp = np.pad(X.astype(np.float64), ((halo * R, halo * R), (0, 0)))
    win = np.stack([Xp[t * R:t * R + W] for t in range(T)])
    Y = np.einsum("trw,twb->trb", band.astype(np.float64), win)
    S = np.einsum("trw,twb->trb", np.abs(band.astype(np.float64)),
                  np.abs(win))
    c = 1.0 if coef is None else coef.astype(np.float64)
    return (Y * c).reshape(T * R, -1), (S * np.abs(c)).reshape(T * R, -1)


def _rect_terms(band, offs, Xp):
    T, R, W = band.shape
    win = np.stack([Xp[o:o + W] for o in offs]).astype(np.float64)
    Y = np.einsum("trw,twb->trb", band.astype(np.float64), win)
    S = np.einsum("trw,twb->trb", np.abs(band.astype(np.float64)),
                  np.abs(win))
    return Y.reshape(T * R, -1), S.reshape(T * R, -1)


_OFFS = np.array([0, 3, 17, 41, 70, 77], np.int32)


# ---------------------------------------------------------------------------
# plain versions against the JAX package (CPU, interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("halo,with_coef", [(1, True), (2, False)])
def test_plain_band_bf16_matches_pallas_interpret(jx, halo, with_coef):
    band, X, coef = _band_case(halo, seed=3 + halo)
    c = coef if with_coef else None
    want = jx.pk.band_apply_pallas(
        _jbf16(jx, band), _jbf16(jx, X),
        None if c is None else _jbf16(jx, c), interpret=True)
    assert want.dtype == jx.jnp.bfloat16
    got = tb.band_apply_plain(
        torch.as_tensor(band).to(BF16), torch.as_tensor(X).to(BF16),
        None if c is None else torch.as_tensor(c).to(BF16))
    assert got.dtype == BF16
    want = torch.as_tensor(np.asarray(want.astype(jx.jnp.float32))).to(BF16)
    exact, S = _band_terms(band, X, c)
    # both round the same f32-accurate sum once: at most one step apart
    # unless the sum sits within f32 noise of a rounding boundary, and then
    # still within one rounding of the terms' scale
    assert np.abs(got.float().numpy() - want.float().numpy()).max() \
        <= (2 * EPS * S).max()
    assert (ulps(got, want) <= 1).float().mean() >= 0.99
    assert (np.abs(got.float().numpy() - exact)
            <= EPS * np.abs(exact) + 1e-6 * S).all()


@pytest.mark.parametrize("x_bf16", [False, True])
def test_plain_rect_band_bf16_matches_pallas_interpret(jx, x_bf16):
    band, Xp = _rect_case(_OFFS, seed=11)
    if x_bf16:
        Xp = _bf16_np(Xp)
    jX = _jbf16(jx, Xp) if x_bf16 else jx.jnp.asarray(Xp)
    want = jx.pk.rect_band_apply_pallas(_jbf16(jx, band),
                                        jx.jnp.asarray(_OFFS), jX)
    tX = torch.as_tensor(Xp).to(BF16) if x_bf16 else torch.as_tensor(Xp)
    got = tb.rect_band_apply_plain(torch.as_tensor(band).to(BF16),
                                   torch.as_tensor(_OFFS), tX)
    exact, S = _rect_terms(band, _OFFS, _bf16_np(Xp))
    if x_bf16:
        assert got.dtype == BF16 and want.dtype == jx.jnp.bfloat16
        want = torch.as_tensor(
            np.asarray(want.astype(jx.jnp.float32))).to(BF16)
        assert (ulps(got, want) <= 1).float().mean() >= 0.99
        assert np.abs(got.float().numpy() - want.float().numpy()).max() \
            <= (2 * EPS * S).max()
    else:
        # form 1: f32 out, X rounded to bf16 on the way in by both
        assert got.dtype == torch.float32 and want.dtype == jx.jnp.float32
        assert (np.abs(got.numpy() - np.asarray(want)) <= 1e-5 * S).all()
        assert (np.abs(got.numpy() - exact) <= 1e-5 * S).all()


@pytest.mark.parametrize("nd", [3, 6])
@pytest.mark.parametrize("per_sample", [False, True])
def test_plain_element_bf16_matches_jax_block(jx, nd, per_sample):
    rng = np.random.default_rng(20 + nd)
    N, n, B = 120, 90, 5
    dofs = np.stack([rng.choice(n, nd, replace=False) for _ in range(N)])
    A = _bf16_np(rng.standard_normal(((B, N, nd, nd) if per_sample
                                      else (N, nd, nd))))
    X = _bf16_np(rng.standard_normal((n, B)))
    coef = None if per_sample else _bf16_np(rng.random(B) + 0.5)
    sc = te.make_scatter(dofs, n, "cpu")
    dt = torch.as_tensor(dofs, dtype=torch.int32)
    got = te.element_apply_plain(
        torch.as_tensor(A).to(BF16), dt, sc, torch.as_tensor(X).to(BF16),
        None if coef is None else torch.as_tensor(coef).to(BF16))
    assert got.dtype == BF16
    jb = jx.Block(A64=None, A32=None, dofs=jx.jnp.asarray(dofs),
                  perm=jx.jnp.asarray(sc.perm.numpy()),
                  ids_sorted=jx.jnp.asarray(sc.ids_sorted.numpy()), ndofs=n)
    want = jb.apply_batched(
        _jbf16(jx, X), A_override=_jbf16(jx, A),
        coef=None if coef is None else _jbf16(jx, coef))
    assert want.dtype == jx.jnp.bfloat16
    want = np.asarray(want.astype(jx.jnp.float32))
    # exact value and the sum of |terms| per output
    A64 = A.astype(np.float64)
    Xe = X.astype(np.float64)[dofs]                     # (N, nd, B)
    sub = "bnij,njb->nib" if per_sample else "nij,njb->nib"
    c = 1.0 if coef is None else coef.astype(np.float64)
    Ye = np.einsum(sub, A64, Xe) * c
    Se = np.einsum(sub, np.abs(A64), np.abs(Xe)) * c
    exact, S = np.zeros((n, B)), np.zeros((n, B))
    np.add.at(exact, dofs.ravel(), Ye.reshape(N * nd, B))
    np.add.at(S, dofs.ravel(), Se.reshape(N * nd, B))
    per_row = np.bincount(dofs.ravel(), minlength=n).max()
    # the port: f32 sums and one rounding
    assert (np.abs(got.float().numpy() - exact)
            <= EPS * np.abs(exact) + 1e-6 * S + 1e-30).all()
    # JAX rounds each of the nd multiply-adds, the coef product and each
    # segment-sum step to bf16
    assert (np.abs(got.float().numpy() - want)
            <= (nd + per_row + 2) * EPS * S + 1e-30).all()


def test_plain_element_bf16_out_form_rounds_once():
    rng = np.random.default_rng(5)
    N, n, B, nd = 60, 50, 4, 6
    dofs = np.stack([rng.choice(n - 10, nd, replace=False)
                     for _ in range(N)])
    A = torch.as_tensor(rng.standard_normal((N, nd, nd))).to(BF16)
    X = torch.as_tensor(rng.standard_normal((n, B))).to(BF16)
    coef = torch.as_tensor(rng.random(B) + 0.5).to(BF16)
    out = torch.as_tensor(rng.random((n, B))).to(BF16)
    sc = te.make_scatter(dofs, n, "cpu")
    dt = torch.as_tensor(dofs, dtype=torch.int32)
    full32 = te.element_apply_plain(A.float(), dt, sc, X.float(),
                                    coef.float())
    got = te.element_apply_plain(A, dt, sc, X, coef, out=out.clone())
    assert got.dtype == BF16
    assert torch.equal(got, (out.float() + full32).to(BF16))
    assert torch.equal(got[n - 10:], out[n - 10:])     # untouched rows
    assert torch.equal(te.element_apply_plain(A, dt, sc, X, coef),
                       full32.to(BF16))


def test_plain_band_bf16_is_f32_sums_rounded_once():
    """Not a bf16 einsum: the plain versions equal the f32 einsum of the
    upcast operands, rounded once (A after the f32 coef product)."""
    band, X, coef = _band_case(1, seed=9, T=5, R=16, B=7)
    b16, X16, c16 = (torch.as_tensor(a).to(BF16) for a in (band, X, coef))
    want = (tb.band_apply_plain(b16.float(), X16.float())
            * c16.float()).to(BF16)
    assert torch.equal(tb.band_apply_plain(b16, X16, c16), want)
    rband, Xp = _rect_case(_OFFS, seed=4)
    r16, offs = torch.as_tensor(rband).to(BF16), torch.as_tensor(_OFFS)
    Xp = torch.as_tensor(Xp)
    want = tb.rect_band_apply_plain(r16.float(), offs, Xp.to(BF16).float())
    assert torch.equal(tb.rect_band_apply_plain(r16, offs, Xp), want)
    assert torch.equal(tb.rect_band_apply_plain(r16, offs, Xp.to(BF16)),
                       want.to(BF16))
    # the wrappers send CPU tensors to these and count nothing
    n0 = (tb.band_apply.launches, tb.band_apply.launches_bf16,
          tb.rect_band_apply.launches_bf16,
          tb.rect_band_apply.launches_bf16_band)
    assert torch.equal(tb.band_apply(b16, X16, c16),
                       tb.band_apply_plain(b16, X16, c16))
    assert torch.equal(tb.rect_band_apply(r16, offs, Xp), want)
    assert n0 == (tb.band_apply.launches, tb.band_apply.launches_bf16,
                  tb.rect_band_apply.launches_bf16,
                  tb.rect_band_apply.launches_bf16_band)


# ---------------------------------------------------------------------------
# argument checks and spans (CPU)
# ---------------------------------------------------------------------------

_F32, _F64, _F16 = torch.float32, torch.float64, torch.float16


@pytest.mark.parametrize("bd,xd,ok", [
    (_F32, _F32, True), (BF16, BF16, True), (BF16, _F32, False),
    (_F32, BF16, False), (_F16, _F16, False), (_F64, _F64, False)])
def test_band_apply_checker_takes_exactly_its_dtype_pairs(bd, xd, ok):
    band, X, coef = (torch.as_tensor(a) for a in _band_case(1, seed=1))
    args = (band.to(bd), X.to(xd), coef.to(xd))
    if ok:   # passes the dtype check; refused only for lying on the CPU
        with pytest.raises(ValueError, match="CUDA device"):
            tb.check_band_apply_args(*args)
        with pytest.raises(ValueError, match="coef"):
            tb.check_band_apply_args(args[0], args[1], coef.to(_F64))
    else:
        with pytest.raises(TypeError, match="kernel takes"):
            tb.check_band_apply_args(*args)


@pytest.mark.parametrize("bd,xd,ok", [
    (_F32, _F32, True), (BF16, _F32, True), (BF16, BF16, True),
    (_F32, BF16, False), (_F16, _F32, False), (BF16, _F16, False),
    (_F64, _F64, False)])
def test_rect_band_apply_checker_takes_exactly_its_dtype_pairs(bd, xd, ok):
    rband, Xp = _rect_case(_OFFS, seed=2)
    args = (torch.as_tensor(rband).to(bd), torch.as_tensor(_OFFS),
            torch.as_tensor(Xp).to(xd))
    with pytest.raises(ValueError if ok else TypeError,
                       match="CUDA device" if ok else "kernel takes"):
        tb.check_rect_band_apply_args(*args)


def test_element_block_checker_takes_bf16_and_refuses_f16():
    rng = np.random.default_rng(0)
    dofs = np.stack([rng.choice(40, 3, replace=False) for _ in range(30)])
    sc = te.make_scatter(dofs, 40, "cpu")
    dt = torch.as_tensor(dofs, dtype=torch.int32)
    A = torch.as_tensor(rng.standard_normal((30, 3, 3)))
    with pytest.raises(ValueError, match="CUDA device"):
        te._check_block(A.to(BF16), dt, sc, BF16)
    with pytest.raises(TypeError, match="bf16"):
        te._check_block(A.to(_F16), dt, sc)
    with pytest.raises(TypeError, match="bf16"):
        te._check_block(A.to(BF16), dt, sc, _F32)
    assert te.KERNEL_DTYPES == {_F32: 0, _F64: 1, BF16: 2}


def test_bf16_copy_keeps_the_f32_band_spans():
    """bf16 has f32's exponent range: rounding a band to bf16 turns no
    nonzero into zero, so the f32 band's spans are the bf16 copy's."""
    rng = np.random.default_rng(8)
    band = np.zeros((4, 128, 384), np.float32)
    for t in range(4):
        for r in range(128):
            a = int(rng.integers(0, 300))
            band[t, r, a:a + 40] = rng.standard_normal(40) * 10.0 ** float(
                rng.integers(-30, 30))
    band[0, 0, 5] = 1.2e-38            # f32's smallest normal scale
    band[3, 127, 383] = -3.4e38        # rounds to -inf in bf16: a nonzero
    band = torch.as_tensor(band)
    b16 = band.to(BF16)
    assert torch.equal(b16 != 0, band != 0)
    assert torch.equal(tb.band_spans(b16), tb.band_spans(band))


def test_block_with_bf16_binds_a_third_dtype():
    from fenics_eff_uptake_tpu_torch.parallel.sweep import _Block
    rng = np.random.default_rng(1)
    dofs = np.stack([rng.choice(40, 6, replace=False) for _ in range(30)])
    blk = _Block.build(torch.as_tensor(rng.standard_normal((30, 6, 6))),
                       dofs, 40)
    X = torch.as_tensor(rng.standard_normal((40, 3)))
    with pytest.raises(TypeError, match="bfloat16"):
        blk.apply_batched(X.to(BF16))
    b16 = blk.with_bf16()
    assert b16.with_bf16() is b16 and b16.A16.dtype == BF16
    assert torch.equal(b16.A16, blk.A32.to(BF16))
    got = b16.apply_batched(X.to(BF16))
    assert torch.equal(got, te.element_apply_plain(
        b16.A16, b16.dofs, b16.scatter, X.to(BF16)))
    # the f64 and f32 applies are the block's own still
    assert torch.equal(b16.apply_batched(X), blk.apply_batched(X))
    assert b16.to("cpu").A16 is not None
    ps = blk.per_sample(rng.standard_normal((3, 30, 6, 6))).with_bf16()
    assert ps.A16.shape == (3, 30, 6, 6)
    assert ps.apply_batched(X.to(BF16)).dtype == BF16


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

def _assert_bf16_close(got, want, S):
    """Equal to plain in >= 99% of the entries; within one bf16 step of it,
    or (a result far below its terms) within the f32 bound 1e-5 * S, S the
    sum of |terms|."""
    d = ulps(got, want)
    ok = (d <= 1) | ((got.float() - want.float()).abs() <= 1e-5 * S)
    assert bool(ok.all()), int(d.max())
    assert float((d == 0).float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 4, 8, 9, 16, 20, 33, 48, 96, 200])
@pytest.mark.parametrize("with_coef", [True, False])
def test_band_kernel_bf16_matches_plain(cuda, B, with_coef):
    band, X, coef = _band_case(1, seed=B, T=7, R=256, B=B, sparse=True)
    b16 = torch.as_tensor(band, device=cuda).to(BF16)
    X16 = torch.as_tensor(X, device=cuda).to(BF16)
    c16 = torch.as_tensor(coef, device=cuda).to(BF16) if with_coef else None
    spans = tb.band_spans(b16)
    n0 = (tb.band_apply.launches, tb.band_apply.launches_bf16)
    got = tb.band_apply(b16, X16, c16, spans=spans)
    assert (tb.band_apply.launches, tb.band_apply.launches_bf16) == (
        n0[0] + 1, n0[1] + 1)
    assert got.dtype == BF16 and torch.isfinite(got).all()
    S = tb.band_apply_plain(b16.float().abs(), X16.float().abs(),
                            None if c16 is None else c16.float())
    _assert_bf16_close(got, tb.band_apply_plain(b16, X16, c16), S)
    assert torch.equal(got, tb.band_apply(b16, X16, c16, spans=spans))
    # a column's values do not depend on the batch it rides in
    if B > 3:
        one = tb.band_apply(b16, X16[:, 2:3].contiguous(),
                            None if c16 is None else c16[2:3].contiguous(),
                            spans=spans)
        assert torch.equal(one[:, 0], got[:, 2])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3, 8, 9, 20, 24, 33, 96, 200])
@pytest.mark.parametrize("x_bf16", [False, True])
def test_rect_band_kernel_bf16_matches_plain(cuda, B, x_bf16):
    rng = np.random.default_rng(B)
    T, R, W = 9, 256, 512
    offs = np.sort(rng.integers(0, 3000, T)).astype(np.int32)
    band = _bf16_np(rng.standard_normal((T, R, W)))
    band[rng.random(band.shape) < 0.5] = 0.0
    n_cols = int(offs.max()) + W - 100        # windows run past the end
    Xp = rng.standard_normal((n_cols, B)).astype(np.float32)
    b16 = torch.as_tensor(band, device=cuda).to(BF16)
    offs_t = torch.as_tensor(offs, device=cuda)
    Xt = torch.as_tensor(Xp, device=cuda)
    Xt = Xt.to(BF16) if x_bf16 else Xt
    spans = tb.band_spans(b16)
    # plain reads the zero rows the kernel fills in by itself
    Xpad = torch.nn.functional.pad(Xt, (0, 0, 0, 100))
    want = tb.rect_band_apply_plain(b16, offs_t, Xpad)
    n0 = (tb.rect_band_apply.launches, tb.rect_band_apply.launches_bf16,
          tb.rect_band_apply.launches_bf16_band)
    got = tb.rect_band_apply(b16, offs_t, Xt, spans)
    assert (tb.rect_band_apply.launches, tb.rect_band_apply.launches_bf16,
            tb.rect_band_apply.launches_bf16_band) == (
        n0[0] + 1, n0[1] + x_bf16, n0[2] + (not x_bf16))
    assert got.dtype == Xt.dtype and torch.isfinite(got).all()
    S = tb.rect_band_apply_plain(b16.abs().float(), offs_t,
                                 Xpad.to(BF16).float().abs())
    if x_bf16:
        _assert_bf16_close(got, want, S)
    else:
        assert bool(((got - want).abs() <= 1e-5 * S).all())
    assert torch.equal(got, tb.rect_band_apply(b16, offs_t, Xt, spans))


@pytest.mark.cuda
def test_bf16_band_kernels_refuse_other_dtype_pairs_on_the_card(cuda):
    band, X, coef = (torch.as_tensor(a, device=cuda)
                     for a in _band_case(1, seed=1, R=256))
    spans = tb.band_spans(band)
    with pytest.raises(TypeError, match="kernel takes"):
        tb.band_apply(band.to(BF16), X, coef, spans=spans)
    with pytest.raises(TypeError, match="kernel takes"):
        tb.band_apply(band, X.to(BF16), spans=spans)
    with pytest.raises(ValueError, match="coef"):
        tb.band_apply(band.to(BF16), X.to(BF16), coef, spans=spans)
    with pytest.raises(TypeError, match="kernel takes"):
        tb.rect_band_apply(band, torch.zeros(6, dtype=torch.int32,
                                             device=cuda),
                           X.to(BF16), spans)
    # a bf16 band is copied 8 values at a time
    odd = torch.zeros((2, 4, 12), dtype=BF16, device=cuda)
    with pytest.raises(ValueError, match="W % 8"):
        tb.band_apply(odd, torch.zeros((8, 2), dtype=BF16, device=cuda),
                      spans=tb.band_spans(odd))


def _random_block(nd, N, n, B, seed, per_sample=False):
    rng = np.random.default_rng(seed)
    dofs = np.stack([rng.choice(n - n // 4, nd, replace=False)
                     for _ in range(N)])
    A = rng.standard_normal((B, N, nd, nd) if per_sample else (N, nd, nd))
    X = rng.standard_normal((n, B))
    coef = rng.random(B) + 0.5
    return A, dofs, X, coef


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 9, 20, 96])
@pytest.mark.parametrize("nd", [2, 3, 6])
@pytest.mark.parametrize("per_sample", [False, True])
def test_element_kernel_bf16_matches_plain(cuda, nd, B, per_sample):
    A, dofs, X, coef = _random_block(nd, 2500, 3000, B, seed=nd * B,
                                     per_sample=per_sample)
    sc = te.make_scatter(dofs, X.shape[0], cuda)
    At = torch.as_tensor(A, device=cuda).to(BF16)
    dt = torch.as_tensor(dofs, dtype=torch.int32, device=cuda)
    Xt = torch.as_tensor(X, device=cuda).to(BF16)
    ct = torch.as_tensor(coef, device=cuda).to(BF16)
    k = te.ElementKernel(At, dt, sc)
    untouched = torch.ones(sc.ndofs, dtype=torch.bool, device=cuda)
    untouched[dt.long().reshape(-1)] = False
    n0 = (te.ElementKernel.launches, te.ElementKernel.launches_bf16)
    for c in ((None,) if per_sample else (None, ct)):
        Y = k(Xt, c)
        assert Y.dtype == BF16 and torch.isfinite(Y).all()
        S = te.element_apply_plain(At.float().abs(), dt, sc,
                                   Xt.float().abs(),
                                   None if c is None else c.float())
        _assert_bf16_close(Y, te.element_apply_plain(At, dt, sc, Xt, c), S)
        assert bool((Y[untouched] == 0).all())
        assert torch.equal(Y, k(Xt, c))
        out = torch.rand(Y.shape, device=cuda).to(BF16)
        got = k(Xt, c, out=out.clone())
        want = te.element_apply_plain(At, dt, sc, Xt, c, out=out.clone())
        _assert_bf16_close(got, want, S + out.float())
        assert torch.equal(got[untouched], out[untouched])
    calls = 3 if per_sample else 6
    assert (te.ElementKernel.launches, te.ElementKernel.launches_bf16) == (
        n0[0] + calls, n0[1] + calls)
    with pytest.raises(TypeError, match="bf16"):
        k(Xt.float())
