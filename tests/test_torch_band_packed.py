"""Kernel A's packed f32 form (``ops/banded.band_pack``, ``band_form``,
``csrc/band_packed.cu``).

On the CPU, on an assembled P2 stiffness band and an advection band
(h = 0.07), each a case of the parametrised tests:

* unpacking the layout gives back the band exactly; each row's entries
  are its nonzeros in ascending window column; padding holds only zeros,
  at the row's own column; each slice is padded to its longest row;
* the kernel's arithmetic on the layout (a chain per output in slot
  order, X rows outside [0, n) read as zero), done in f32 on small
  integers so that every sum is exact, equals ``band_apply_plain``;
* the bind rule picks the packed form for the FEM bands and the span form
  for a dense random band, and the counters count each bind;
* a band wider than 65,535 columns packs int32 columns, and unpacks and
  applies as the band does;
* ``_PackedStruct`` mirrors ``PackedPlan`` of the source; a CPU band
  binds no form.

On the card (marker ``cuda``, ``--noconftest``), at B = 1, 2, 3, 20, 96:
the packed Y equals the span form's Y bit for bit (the span form reached
through the private ``_SpanBandKernel``) and ``band_apply_plain`` within
1e-5, on the fine uniform K of the mu sweep (h = 0.02) and on the graded
K and Adv (w0.4/d2.0, mouth refined 8 times, h = 0.07).
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.ops import banded as tb
from fenics_eff_uptake_tpu_torch.utils import profiling

torch.set_num_threads(2)

CSRC = Path(tb.__file__).resolve().parent / "csrc" / "band_packed.cu"
BANDS = ["K", "Adv"]


def _velocity_system(mesh, device):
    from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
    from fenics_eff_uptake_tpu_torch.parallel.sweep import \
        build_transport_system
    V = FunctionSpace(mesh, "P2", vs=2)
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * V.dof_coords[:, 1] * (1.0 - V.dof_coords[:, 1])
    return build_transport_system(mesh, device, u_values=u, u_space=V)


@pytest.fixture(scope="module")
def fem():
    """{"K": (band, spans), "Adv": (band, spans)} at h = 0.07."""
    from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
    mesh = generate_mesh(width=10.0, height=1.0, sulcus_depth=1.0,
                         sulcus_width=0.5, mesh_size=0.07,
                         refinement_factor=1, domain_type="sulcus")
    sys = _velocity_system(mesh, "cpu")
    return {"K": (sys.Kband, sys.Kspans), "Adv": (sys.Advband,
                                                  sys.Advspans)}


def _rows_of(pk, R):
    """(slot row, slot) of every slot: row s * 32 + i of slot
    offs[s] + 32 j + i."""
    offs = pk.offs.long()
    ns = offs.numel() - 1
    k = (offs[1:] - offs[:-1]) // tb.PACK_ROWS
    s = torch.repeat_interleave(torch.arange(ns), k * tb.PACK_ROWS)
    within = torch.arange(pk.slots) - offs[:-1][s]
    return s * tb.PACK_ROWS + within % tb.PACK_ROWS, within // tb.PACK_ROWS


def _cols(pk):
    c = pk.cols.long()
    return c & 0xFFFF if pk.cols.dtype == torch.int16 else c


def _unpack(pk, shape):
    T, R, W = shape
    rows, _ = _rows_of(pk, R)
    out = torch.zeros(T * R + tb.PACK_ROWS, W)
    out.index_put_((rows, _cols(pk)), pk.vals, accumulate=True)
    return out[:T * R].reshape(T, R, W)


@pytest.mark.parametrize("name", BANDS)
def test_unpacking_gives_back_the_band(fem, name):
    band, _ = fem[name]
    pk = tb.band_pack(band)
    assert pk.vals.dtype == torch.float32 and pk.offs.dtype == torch.int32
    assert pk.cols.dtype == torch.int16          # W <= 65,535: uint16 bits
    assert pk.entries == int(torch.count_nonzero(band))
    assert torch.equal(_unpack(pk, band.shape), band)


@pytest.mark.parametrize("name", BANDS)
def test_entries_ascend_and_slices_pad_to_their_longest_row(fem, name):
    band, _ = fem[name]
    T, R, W = band.shape
    pk = tb.band_pack(band)
    rows, slot = _rows_of(pk, R)
    cols, vals = _cols(pk), pk.vals
    live = vals != 0
    # row by row, slot by slot: the nonzeros first, in ascending column
    order = torch.argsort(rows * (W + 1) * 4096 + slot, stable=True)
    r, c, v = rows[order], cols[order], live[order]
    same = r[1:] == r[:-1]
    assert bool((c[1:][same & v[1:]] > c[:-1][same & v[1:]]).all())
    assert not bool((v[1:] & ~v[:-1] & same).any())   # no nonzero after pad
    # each slice: as many slots a row as its longest row has nonzeros
    cnt = (band != 0).sum(-1).reshape(-1)
    ns = pk.offs.numel() - 1
    cnt = torch.cat([cnt, cnt.new_zeros(ns * tb.PACK_ROWS - T * R)])
    k = (pk.offs[1:] - pk.offs[:-1]).long() // tb.PACK_ROWS
    assert torch.equal(k, cnt.reshape(ns, tb.PACK_ROWS).amax(1))
    assert int(pk.offs[0]) == 0 and int(pk.offs[-1]) == pk.slots


@pytest.mark.parametrize("name", BANDS)
def test_padding_holds_zeros_at_the_rows_own_column(fem, name):
    band, _ = fem[name]
    T, R, W = band.shape
    halo = (W // R - 1) // 2
    pk = tb.band_pack(band)
    rows, slot = _rows_of(pk, R)
    cnt = (band != 0).sum(-1).reshape(-1)
    cnt = torch.cat([cnt, cnt.new_zeros(tb.PACK_ROWS)])
    pad = slot >= cnt[rows]
    assert bool(pad.any())
    assert not bool(pk.vals[pad].any())
    assert bool((pk.vals[~pad] != 0).all())
    real = pad & (rows < T * R)
    assert torch.equal(_cols(pk)[real], halo * R + rows[real] % R)


def _packed_apply(pk, shape, X, coef=None):
    """The kernel's arithmetic on the layout, in torch: each output a sum
    over its row's slots in slot order (X rows outside [0, n) zero), coef
    in the store."""
    T, R, W = shape
    halo = (W // R - 1) // 2
    n, B = X.shape
    rows, slot = _rows_of(pk, R)
    xr = (rows // R - halo) * R + _cols(pk)
    inside = (xr >= 0) & (xr < n)
    Xz = torch.cat([X, X.new_zeros(1, B)])
    terms = pk.vals[:, None] * Xz[torch.where(inside, xr, n)]
    Y = torch.zeros(T * R + tb.PACK_ROWS, B, dtype=X.dtype)
    for j in range(int(slot.max()) + 1):
        at = slot == j
        Y[rows[at]] += terms[at]
    Y = Y[:n]
    return Y if coef is None else Y * coef


def _integer_band(band, seed):
    """The band's sparsity with small integer values: every f32 sum of
    the tests is exact, in any order."""
    rng = np.random.default_rng(seed)
    vals = torch.as_tensor(rng.integers(-4, 5, band.shape).astype(
        np.float32))
    vals[vals == 0] = 1
    return torch.where(band != 0, vals, 0.0)


@pytest.mark.parametrize("B", [1, 3, 20])
@pytest.mark.parametrize("name", BANDS)
def test_packed_arithmetic_equals_plain(fem, name, B):
    band = _integer_band(fem[name][0], B)
    rng = np.random.default_rng(10 + B)
    X = torch.as_tensor(rng.integers(-3, 4, (band.shape[0] * band.shape[1],
                                              B)).astype(np.float32))
    coef = torch.as_tensor(rng.integers(1, 4, B).astype(np.float32))
    pk = tb.band_pack(band)
    assert torch.equal(_packed_apply(pk, band.shape, X, coef),
                       tb.band_apply_plain(band, X, coef))


def _dense_band(seed=5, T=4, R=64, W=192):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((T, R, W)).astype(
        np.float32))


@pytest.mark.parametrize("name", BANDS + ["dense"])
def test_bind_rule_picks_the_form_of_fewer_bytes(fem, name):
    band, spans = ((_dense_band(), None) if name == "dense"
                   else fem[name])
    if spans is None:
        spans = tb.band_spans(band)
    form = tb.band_form(band, spans)
    packed = tb.band_pack(band).nbytes()
    span = tb.span_elements(band, spans) * 4
    if name == "dense":
        assert form is None and packed >= span
    else:
        # an assembled band: under a fifth of the span form's bytes
        assert form is not None and 5 * packed < span
        assert torch.equal(form.vals, tb.band_pack(band).vals)


@pytest.mark.parametrize("name", BANDS + ["dense"])
def test_counters_count_each_bind(fem, name):
    band, spans = ((_dense_band(seed=6), None) if name == "dense"
                   else fem[name])
    if spans is None:
        spans = tb.band_spans(band)
    pk = tb.band_pack(band)

    def counters():
        return (profiling.band_packed_binds, profiling.band_span_binds,
                profiling.band_packed_entries, profiling.band_packed_slots)
    c0 = counters()
    for _ in range(2):                     # the second bind reuses the form
        form = tb.band_form(band, spans)
    d = [b - a for a, b in zip(c0, counters())]
    if name == "dense":
        assert form is None and d == [0, 2, 0, 0]
    else:
        assert d == [2, 0, 2 * pk.entries, 2 * pk.slots]
    assert band._feu_band_form[3] is form
    band.mul_(1.0)                         # an in-place change: bound anew
    c0 = counters()
    again = tb.band_form(band, spans)
    assert counters()[:2] == ((c0[0], c0[1] + 1) if name == "dense"
                              else (c0[0] + 1, c0[1]))
    if name != "dense":
        assert again is not form and torch.equal(again.vals, form.vals)


def test_wide_band_packs_int32_columns():
    """W = 65,538 (R = 2, halo 16,384): columns past uint16 go as int32;
    unpacking gives back the band, and the layout's arithmetic on small
    integers equals ``band_apply_plain`` (X rows outside [0, n) zero)."""
    T, R, halo = 3, 2, 16384
    W = (2 * halo + 1) * R
    band = torch.zeros(T, R, W)
    rng = np.random.default_rng(7)
    for t in range(T):
        for r in range(R):
            own = halo * R + r
            # near the diagonal (X rows inside) and far out (outside)
            for w in (own - 2 * t - r, own, own + 1, W - 1 - r, 3 + t):
                band[t, r, w] = float(rng.integers(1, 5))
    pk = tb.band_pack(band)
    assert pk.cols.dtype == torch.int32
    assert int(pk.cols.max()) > 65535
    assert pk.entries == int(torch.count_nonzero(band))
    assert torch.equal(_unpack(pk, band.shape), band)
    X = torch.as_tensor(rng.integers(-3, 4, (T * R, 2)).astype(np.float32))
    coef = torch.as_tensor([2.0, 3.0])
    assert torch.equal(_packed_apply(pk, band.shape, X, coef),
                       tb.band_apply_plain(band, X, coef))


@pytest.mark.parametrize("name", BANDS)
def test_cpu_band_binds_no_form(fem, name):
    band, spans = fem[name]
    c0 = (profiling.band_packed_binds, profiling.band_span_binds)
    kern = tb.BandKernel(band, spans)
    assert kern.packed is None and kern.items is None
    assert (profiling.band_packed_binds, profiling.band_span_binds) == c0
    X = torch.ones((band.shape[0] * band.shape[1], 2))
    assert torch.equal(kern(X), tb.band_apply_plain(band, X))


def test_packed_struct_layout_matches_the_source():
    """``_PackedStruct`` mirrors ``PackedPlan``: its fields in the
    source's order, and every offset and the size the source asserts."""
    src = CSRC.read_text()
    body = re.search(r"struct PackedPlan \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [n for decl in body.split(";") if decl.strip()
             for n in re.findall(r"(\w+)\s*(?:,|$)", decl.strip())]
    S = tb._PackedStruct
    assert names == [f for f, _ in S._fields_]
    asserted = dict(re.findall(
        r"static_assert\(offsetof\(PackedPlan, (\w+)\) == (\d+)", src))
    assert set(asserted) == set(names)
    for f, off in asserted.items():
        assert getattr(S, f).offset == int(off), f
    size = re.search(r"static_assert\(sizeof\(PackedPlan\) == (\d+)", src)
    assert ctypes.sizeof(S) == int(size.group(1))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_bands():
    """The fine uniform K of the mu sweep (h = 0.02) and the graded K and
    Adv (w0.4/d2.0 refined 8 times, h = 0.07), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
    from fenics_eff_uptake_tpu_torch.parallel.sweep import \
        build_transport_system
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params)
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params
    dev = torch.device("cuda")
    uni = build_transport_system(make_mesh(make_no_adv_params(
        1.0, sulci_w_dim=0.25, sulci_h_dim=0.25, mesh_size_dim=0.02)), dev)
    p = _make_params(0.1, 0.4, 2.0, 0.07)
    p.refinement_factor = 8
    graded = _velocity_system(
        generate_mesh(domain_type="sulcus", **p.get_mesh_generator_params()),
        dev)
    return {"uniform K": (uni.Kband, uni.Kspans),
            "graded K": (graded.Kband, graded.Kspans),
            "graded Adv": (graded.Advband, graded.Advspans)}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3, 20, 96])
@pytest.mark.parametrize("name", ["uniform K", "graded K", "graded Adv"])
def test_packed_equals_span_form_on_the_card(cuda, card_bands, name, B):
    band, spans = card_bands[name]
    T, R, _ = band.shape
    rng = np.random.default_rng(B)
    X = torch.as_tensor(rng.standard_normal((T * R, B)).astype(np.float32),
                        device=cuda)
    coef = torch.as_tensor(rng.random(B).astype(np.float32) + 0.5,
                           device=cuda)
    kern = tb.BandKernel(band, spans)
    span = tb._SpanBandKernel(band, spans)
    assert kern.packed is not None and kern.items is None
    assert span.packed is None and span.items is not None
    n0 = (tb.band_apply.launches, tb.band_apply.launches_packed)
    Y = kern(X, coef)
    Yn = kern(X)
    assert (tb.band_apply.launches, tb.band_apply.launches_packed) == (
        n0[0] + 2, n0[1] + 2)
    assert torch.equal(Y, span(X, coef))
    assert torch.equal(Yn, span(X))
    ref = tb.band_apply_plain(band, X, coef)
    err = float((Y - ref).abs().max() / ref.abs().max())
    assert err < 1e-5
    assert torch.equal(Y, tb.band_apply(band, X, coef, spans=spans))
