"""The f32 band kernels' work list and bound forms, on the CPU.

The f32 forms of kernels A and B (``csrc/band_f32.cu``) walk a work list:
persistent CTAs take the bands' span blocks (tile, 64-row block, and a
column block of 96 above 96 columns) longest span first, in a snake over
the sorted list, and stream each block's span in chunks of
``chunk_subs`` sub-boxes of 32 columns, every output one ascending
chain.  These tests hold that walk in numpy:

* the work list covers every (tile, row block, column block) exactly once,
  longest span first, on every band of a system and hierarchy at
  h = 0.15 and of a graded hierarchy (factor 16, h = 0.05, whose mid
  restriction has 16-row tiles), and every CTA of a persistent grid takes
  its share once;
* the walk stores every row, those of empty spans too (zeros, times the
  coef);
* the walk equals ``band_apply_plain`` / ``rect_band_apply_plain`` bit for
  bit on those bands, at the widths the paths use and across column
  blocks (B = 1, 3, 9, 20, 96, 97).  The bands keep their sparsity and
  take small integer values, and X and coef small integers, so that every
  sum is exact in f32 whatever its order: what the walk can get wrong is
  coverage (a chunk, a window row, a column block), and any miss shows;
* the bound forms refuse bad input at bind time and at call time, take
  the plain versions on CPU tensors and count no launch there, and the
  systems and hierarchies carry them; a band's work list is kept with
  its spans until they change;
* ``_BandStruct`` has the layout that ``band_f32.cu`` asserts for
  ``BandPlan``.

The kernels themselves run only on the card: ``tests/test_torch_kernels.py
-m cuda``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.ops import banded as tb

torch.set_num_threads(2)

CSRC = Path(tb.__file__).resolve().parent / "csrc" / "band_f32.cu"


def _h015():
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
    return sys, ml


def _graded():
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
    sys = build_transport_system(mesh, "cpu")
    ml = build_multilevel(sys, level_meshes_for(mesh), np.ones(2),
                          np.zeros(2))
    return sys, ml


def _bands_of(sys, ml, tag):
    """[(name, band, spans, offs or None)] of a system and its hierarchy."""
    out = [(f"{tag} K", sys.Kband, sys.Kspans, None)]
    if sys.Advband is not None:
        out.append((f"{tag} Adv", sys.Advband, sys.Advspans, None))
    for i, la in enumerate(ml.levels):
        t = la.bands
        if i:
            out.append((f"{tag} level {i} K", la.sys.Kband, la.sys.Kspans,
                        None))
        out += [(f"{tag} level {i} restrict", t.r, t.rs, t.ro),
                (f"{tag} level {i} prolong", t.p, t.ps, t.po)]
    return out


@pytest.fixture(scope="module")
def systems():
    return {"h015": _h015(), "graded": _graded()}


@pytest.fixture(scope="module")
def bands(systems):
    out = []
    for tag, (sys, ml) in systems.items():
        out += _bands_of(sys, ml, tag)
    return out


def work_items(spans, W, B, items):
    """The f32 kernels' work list as the kernel walks it: per item (t, row
    block, column block, lo, nk), the span [lo, lo + nk) in sub-boxes of
    SPAN_COLS columns clamped as the kernel clamps it; the records of
    ``items`` (``band_items``: block, lo, hi, offs) in their order, each
    over the ceil(B / MAX_COLS) column blocks."""
    nrb = spans.shape[1]
    out = []
    for blk, lo, hi in (tuple(r[:3]) for r in items.cpu().tolist()):
        lo = max(int(lo), 0)
        nk = max(0, min(int(hi), -(-W // tb.SPAN_COLS)) - lo)
        out += [(blk // nrb, blk % nrb, cb, lo, nk)
                for cb in range(-(-B // tb.MAX_COLS))]
    return out


def cta_items(n_items, grid, b):
    """The items CTA ``b`` of a persistent grid of ``grid`` CTAs takes, in
    its order: round j gives it item j * grid + b (j even) or
    j * grid + grid - 1 - b (j odd), a snake over the sorted list."""
    out = []
    for j in range(-(-n_items // grid)):
        v = j * grid + (grid - 1 - b if j % 2 else b)
        if v < n_items:
            out.append(v)
    return out


def _walk(band, spans, X, coef=None, offs=None, grid=7):
    """Kernel A (offs None) or B as the f32 kernels walk it, in numpy: a
    persistent grid of ``grid`` CTAs, each over its items (``cta_items``)
    of the sorted work list; per item, its span in chunks of
    ``chunk_subs`` sub-boxes, each sub-box's 32 window columns in
    ascending order into f32 accumulators (window rows outside X read
    zero, band columns past W zero), then the item's rows stored (times
    the coef).  Y starts as NaN: a row no item stores stays NaN."""
    band = band.numpy()
    X = X.numpy()
    T, R, W = band.shape
    n, B = X.shape
    RB = tb.box_rows(R)
    sp = torch.as_tensor(spans)
    nsub = tb.chunk_subs(R, B, T * sp.shape[1])
    items = work_items(sp, W, B, tb.band_items(
        sp, W, None if offs is None else torch.as_tensor(offs)))
    halo = (W // R - 1) // 2
    Y = np.full((T * R, B), np.nan, np.float32)
    for b in range(grid):
        for v in cta_items(len(items), grid, b):
            t, rb, cb, lo, nk = items[v]
            col0 = cb * tb.MAX_COLS
            nb = min(tb.MAX_COLS, B - col0)
            r0 = rb * tb.SPAN_ROWS
            rows = min(RB, R - r0)
            start = int(offs[t]) if offs is not None else (t - halo) * R
            acc = np.zeros((rows, nb), np.float32)
            for s0 in range(0, nk, nsub):
                for s in range(s0, min(s0 + nsub, nk)):
                    for k in range(tb.SPAN_COLS):
                        w = (lo + s) * tb.SPAN_COLS + k
                        if w >= W:
                            continue
                        xr = start + w
                        if not 0 <= xr < n:
                            continue
                        acc = acc + (band[t, r0:r0 + rows, w][:, None]
                                     * X[xr, col0:col0 + nb][None, :])
            if coef is not None:
                acc = acc * coef.numpy()[col0:col0 + nb]
            Y[t * R + r0:t * R + r0 + rows, col0:col0 + nb] = acc
    return Y


def _integers(band, seed):
    """The band's sparsity with values in {-3..-1, 1..3}: every sum of
    products with small integer X exact in f32."""
    rng = np.random.default_rng(seed)
    v = rng.integers(1, 4, band.shape) * rng.choice([-1, 1], band.shape)
    return torch.as_tensor(np.where(band.numpy() != 0, v, 0)
                           .astype(np.float32))


def _ints(rng, shape):
    return torch.as_tensor(rng.integers(-4, 5, shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the work list
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 20, 96, 97, 200])
def test_work_list_covers_every_block_once_longest_first(bands, B):
    ncb = -(-B // tb.MAX_COLS)
    for name, band, spans, offs in bands:
        T, R, W = band.shape
        nrb = spans.shape[1]
        recs = tb.band_items(spans, W, offs)
        assert recs.dtype == torch.int32 and recs.shape == (T * nrb, 4)
        assert torch.equal(recs[:, 0], tb.band_order(spans, W))
        # each record carries its window start: kernel B's offs[t], 0 for A
        t_of = recs[:, 0].long() // nrb
        assert torch.equal(recs[:, 3], torch.zeros_like(recs[:, 3])
                           if offs is None else offs[t_of])
        items = work_items(spans, W, B, recs)
        keys = [(t, rb, cb) for t, rb, cb, _, _ in items]
        assert sorted(keys) == [(t, rb, cb) for t in range(T)
                                for rb in range(nrb)
                                for cb in range(ncb)], name
        nk = [it[4] for it in items]
        assert nk == sorted(nk, reverse=True), name
        sp = spans.numpy()
        for t, rb, _, lo, k in items:
            assert (lo, lo + k) == (tuple(sp[t, rb]) if k else (lo, lo))
        # ties keep index order
        base = [(-k, t * nrb + rb) for t, rb, cb, _, k in items if cb == 0]
        assert base == sorted(base), name


@pytest.mark.parametrize("n_items,grid", [(1, 1), (5, 7), (7, 7), (8, 7),
                                          (100, 7), (1604, 264), (416, 264)])
def test_persistent_grid_takes_every_item_once(n_items, grid):
    taken = [cta_items(n_items, grid, b) for b in range(grid)]
    flat = sorted(v for t in taken for v in t)
    assert flat == list(range(n_items))
    # round j holds items [j * grid, (j + 1) * grid): one per CTA, and the
    # snake gives the CTA with the largest item of an even round the
    # smallest of the next
    for b, t in enumerate(taken):
        assert [v // grid for v in t] == list(range(len(t)))
        if len(t) > 1:
            assert t[1] == 2 * grid - 1 - b


def test_chunk_widths_and_box_rows():
    assert [tb.box_rows(R) for R in (8, 16, 17, 64, 100, 256)] == [
        16, 16, 64, 64, 64, 64]
    assert tb.chunk_subs(8, 3, 416) == 8 and tb.chunk_subs(16, 20, 48) == 2
    assert [tb.chunk_subs(256, B, 1604) for B in (1, 9, 20, 24, 33, 96,
                                                  200)] == [1, 1, 1, 1, 1,
                                                            2, 2]
    assert [tb.chunk_subs(256, B, 408) for B in (1, 3, 9)] == [2, 2, 1]
    for R in (8, 256):
        for B in (1, 20, 96, 200):
            for blocks in (1, 408, 1604):
                assert 1 <= tb.chunk_subs(R, B, blocks) <= 8
                assert 2 <= tb.ring_stages(R, B, blocks) <= 16
    assert [tb.ring_stages(256, 20, n) for n in (408, 1604)] == [3, 2]


# ---------------------------------------------------------------------------
# the walk against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 3, 9, 20, 96, 97])
def test_walk_equals_plain_bit_for_bit(bands, B):
    rng = np.random.default_rng(B)
    for i, (name, band, spans, offs) in enumerate(bands):
        if B in (96, 97) and i % 3:      # the wide cases on a third
            continue
        bi = _integers(band, seed=i)
        assert torch.equal(tb.band_spans(bi), spans), name
        T, R, W = band.shape
        if offs is None:
            X = _ints(rng, (T * R, B))
            coef = torch.as_tensor(rng.integers(1, 4, B).astype(np.float32))
            want = tb.band_apply_plain(bi, X, coef).numpy()
            got = _walk(bi, spans, X, coef)
        else:
            X = _ints(rng, (int(offs.max()) + W, B))
            want = tb.rect_band_apply_plain(bi, offs, X).numpy()
            got = _walk(bi, spans, X, offs=offs)
        assert not np.isnan(got).any(), name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_walk_stores_rows_of_empty_spans():
    """A band with empty tiles and empty 64-row blocks: every row is
    stored, those of the empty spans as zeros (times the coef), and the
    rest equals plain bit for bit."""
    rng = np.random.default_rng(5)
    T, R, W = 6, 128, 384
    band = np.zeros((T, R, W), np.float32)
    for t in range(T):
        for r in range(R):
            a = int(rng.integers(0, W - 40))
            band[t, r, a:a + 40] = rng.integers(1, 4, 40)
    band[2] = 0.0
    band[4, 64:] = 0.0
    band = torch.as_tensor(band)
    spans = tb.band_spans(band)
    assert (spans[2] == 0).all() and (spans[4, 1] == 0).all()
    X = _ints(rng, (T * R, 5))
    coef = torch.as_tensor([1.0, 2.0, 3.0, 1.0, 2.0])
    got = _walk(band, spans, X, coef)
    assert not np.isnan(got).any()
    Yt = got.reshape(T, R, 5)
    assert not Yt[2].any() and not Yt[4, 64:].any()
    np.testing.assert_array_equal(got, tb.band_apply_plain(band, X,
                                                           coef).numpy())


def test_walk_of_rect_band_with_windows_past_x():
    """Kernel B with unaligned window starts, some running past the end of
    Xp (rows that read zero), on a 16-row band (16-row boxes, chunks of
    8 sub-boxes) and a 100-row band (a partial second row block)."""
    rng = np.random.default_rng(9)
    for R, W, B in ((16, 512, 3), (100, 256, 20), (8, 96, 1)):
        T = 5
        band = torch.as_tensor(rng.integers(-3, 4, (T, R, W))
                               .astype(np.float32))
        offs = torch.as_tensor(np.array([0, 3, 17, 41, 70], np.int32))
        X = _ints(rng, (70 + W // 2, B))
        spans = tb.band_spans(band)
        got = _walk(band, spans, X, offs=offs)
        # the plain version needs the rows the windows reach: zeros
        Xz = torch.cat([X, torch.zeros((70 + W - X.shape[0], B))])
        np.testing.assert_array_equal(
            got, tb.rect_band_apply_plain(band, offs, Xz).numpy())


# ---------------------------------------------------------------------------
# the bound forms
# ---------------------------------------------------------------------------

def test_bound_forms_take_plain_on_cpu_and_count_no_launch(systems):
    sys, ml = systems["h015"]
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.standard_normal((sys.ndofs, 4))
                        .astype(np.float32))
    coef = torch.as_tensor([0.5, 1.0, 2.0, 3.0])
    n_a, n_b = tb.band_apply.launches, tb.rect_band_apply.launches
    assert isinstance(sys.Kkern, tb.BandKernel)
    assert sys.Kkern.band is sys.Kband and sys.Kkern.spans is sys.Kspans
    assert sys.Kkern.items is None       # no work list on the CPU
    assert torch.equal(sys.Kkern(X, coef),
                       tb.band_apply_plain(sys.Kband, X, coef))
    assert torch.equal(sys.Advkern(X), tb.band_apply_plain(sys.Advband, X))
    t = ml.levels[0].bands
    for k, band, offs, rows in ((t.rk, t.r, t.ro, t.pad_r),
                                (t.pk, t.p, t.po, t.pad_p)):
        assert isinstance(k, tb.RectBandKernel) and k.band is band
        Xq = torch.as_tensor(rng.standard_normal((rows, 3))
                             .astype(np.float32))
        assert torch.equal(k(Xq), tb.rect_band_apply_plain(band, offs, Xq))
        assert torch.equal(tb.rect_band_apply(band, offs, Xq),
                           tb.rect_band_apply_plain(band, offs, Xq))
    assert torch.equal(tb.band_apply(sys.Kband, X, coef),
                       tb.band_apply_plain(sys.Kband, X, coef))
    assert (tb.band_apply.launches, tb.rect_band_apply.launches) == (n_a,
                                                                     n_b)


def test_systems_and_hierarchies_carry_bound_kernels(systems):
    """Every system with bands carries kernel A bound to each, every
    transfer kernel B bound to each band, and the kernels follow the
    system to another device (here the CPU again) and compare equal."""
    from fenics_eff_uptake_tpu_torch.parallel.sweep import system_to
    from fenics_eff_uptake_tpu_torch.parallel.sharded_solve import \
        host_system
    for sys, ml in systems.values():
        for la in ml.levels:
            s = la.sys
            assert s.Kkern is not None and s.Kkern.band is s.Kband
            assert (s.Advkern is None) == (s.Advband is None)
            t = la.bands
            assert t.pk.band is t.p and t.pk.offs is t.po
            assert t.rk.band is t.r and t.rk.offs is t.ro
        moved = system_to(sys, "cpu")
        assert moved.Kkern is not sys.Kkern and moved.Kkern == sys.Kkern
        h = host_system(sys)
        assert h.Kkern is None and h.Advkern is None
        h = host_system(sys, elements_only=True)
        assert h.Kkern is None and h.Advkern is None


def test_bound_forms_refuse_bad_input():
    rng = np.random.default_rng(2)
    band = torch.as_tensor(rng.standard_normal((4, 8, 24))
                           .astype(np.float32))
    spans = tb.band_spans(band)
    offs = torch.tensor([0, 3, 5, 9], dtype=torch.int32)
    # at bind time
    with pytest.raises(ValueError):
        tb.BandKernel(band[:, :, :20].contiguous(), spans)   # W != 3 R
    with pytest.raises(ValueError):
        tb.BandKernel(band[0], spans)
    with pytest.raises(TypeError):
        tb.BandKernel(band.half(), spans)
    with pytest.raises(TypeError):
        tb.RectBandKernel(band.double(), offs, spans)
    with pytest.raises(ValueError):
        tb.RectBandKernel(band, offs.long(), spans)
    with pytest.raises(ValueError):
        tb.RectBandKernel(band, offs[:3], spans)
    # at call time
    k = tb.BandKernel(band, spans)
    X = torch.zeros((32, 3))
    k.check(X, torch.ones(3))
    for bad, coef in ((X.double(), None), (X[:31], None),
                      (torch.zeros((32, 0)), None), (torch.zeros(32), None),
                      (torch.zeros((3, 32)).t(), None),
                      (X, torch.ones(4)), (X, torch.ones(3).double()),
                      (X, torch.ones(6)[::2])):
        with pytest.raises((TypeError, ValueError)):
            k.check(bad, coef)
    kb = tb.RectBandKernel(band, offs, spans)
    kb.check(torch.zeros((40, 2)))
    for bad in (torch.zeros((40, 2)).double(), torch.zeros(40),
                torch.zeros((2, 40)).t(), torch.zeros((40, 0))):
        with pytest.raises((TypeError, ValueError)):
            kb.check(bad)
    k16 = tb.BandKernel(band.bfloat16(), spans)
    k16.check(X.bfloat16())
    with pytest.raises(TypeError):
        k16.check(X)


def test_work_list_is_kept_with_the_spans_until_they_change():
    """``work_list`` gives ``band_items`` once per spans, W and offs: the
    same tensor again (a band bound again launches no work-list ops), a
    new one after spans or offs change in place or for another W or
    offs."""
    rng = np.random.default_rng(4)
    band = torch.as_tensor(rng.standard_normal((6, 80, 240))
                           .astype(np.float32))
    band[:, :, 100:] = 0
    band[2] = 0
    spans = tb.band_spans(band)
    offs = torch.tensor([0, 3, 5, 9, 11, 20], dtype=torch.int32)
    W = band.shape[2]
    a = tb.work_list(spans, W)
    assert torch.equal(a, tb.band_items(spans, W))
    assert tb.work_list(spans, W) is a
    b = tb.work_list(spans, W, offs)
    assert b is not a and torch.equal(b, tb.band_items(spans, W, offs))
    assert tb.work_list(spans, W, offs) is b
    assert tb.work_list(spans, W, offs.clone()) is not b
    c = tb.work_list(spans, W, offs)
    offs[1] = 4
    d = tb.work_list(spans, W, offs)
    assert d is not c and torch.equal(d, tb.band_items(spans, W, offs))
    e = tb.work_list(spans, W)
    spans[0, 1] = torch.tensor([0, 0], dtype=torch.int32)
    f = tb.work_list(spans, W)
    assert f is not e and torch.equal(f, tb.band_items(spans, W))
    assert tb.work_list(spans, W - 4) is not f


def test_band_struct_layout_matches_the_source():
    """``_BandStruct`` mirrors ``BandPlan``: its fields in the source's
    order, and every offset and the size that the source asserts."""
    src = CSRC.read_text()
    body = re.search(r"struct BandPlan \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"\b(\w+)(?:\[16\])?[,;]", body)
    assert names == [f for f, _ in tb._BandStruct._fields_]
    asserted = dict(re.findall(
        r"static_assert\(offsetof\(BandPlan, (\w+)\) == (\d+)", src))
    assert set(asserted) == set(names) - {"map"}
    for f, off in asserted.items():
        assert getattr(tb._BandStruct, f).offset == int(off), f
    size = re.search(r"static_assert\(sizeof\(BandPlan\) == (\d+)", src)
    assert ctypes.sizeof(tb._BandStruct) == int(size.group(1))
    assert tb._BandStruct.map.offset == 0
    assert tb._BandStruct.map.size == 128        # a CUtensorMap
