"""Kernel C's tile plan and its two forms (full output and ``out=``).

* The plan (``make_tiles``, built by ``make_scatter``): every sorted entry
  lies in exactly one chunk, each chunk lists exactly the entities of its
  entries, once each, in first-appearance order; rows without entries
  (padding rows, gaps of a boundary block) belong to no tile; random dof
  maps, empty blocks and chunks smaller than a tile.
* A numpy walk of the plan in the kernel's order of work (each chunk's
  entities once, products to slots, row sums over the slots in sorted
  order) equals the one-thread-per-output order (each row's sorted entries
  one after another) bit for bit, in both forms; the full form writes
  zeros (times coef) on rows without entries, ``out=`` leaves them alone.
* The plain ``out=`` form is ``out + element_apply_plain(...)`` bit for
  bit, and the operator and both V-cycles give the same bits with the
  Robin block added in place as with the separate apply and add (CPU,
  h = 0.15).
* Per-call checks of X, coef and out; the ctypes plan matches the C
  struct.
* On the card (marker ``cuda``; skipped without one): the kernel against
  the plain version for nd 2, 3, 6, f32 and f64, B in {1, 2, 3, 20, 96,
  200}, with and without coef and ``out=``, on random dofs and real
  h = 0.15 blocks (f64 1e-12, f32 2e-5 relative: summation order); two
  launches agree bit for bit; ``out=`` leaves untouched rows bit-equal;
  chunked and differently tiled plans give the same bits; bound blocks
  refuse what the kernel does not take.  The per-sample form (A of shape
  (B, N, nd, nd), no coef) likewise: against plain at the same tolerances
  for nd 2, 3, 6 and B in {1, 3, 9, 20, 96}, both forms, two launches and
  every plan bit for bit, equal to the shared form where every column
  carries the same matrices, and bound at one B it refuses another.

Imports nothing of JAX: on the card, ``python -m pytest
tests/test_torch_element_tiles.py -m cuda --noconftest``.
"""

import ctypes

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.ops import elemspmv as te

torch.set_num_threads(2)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_block(nd, dtype, seed=0, N=300, n=400, B=5, gaps=False):
    """Random entity matrices and dof map on n rows; with ``gaps`` the dofs
    avoid two runs of rows (as padding rows and a boundary block's
    untouched rows)."""
    rng = np.random.default_rng(seed + 10 * nd)
    pool = np.arange(n)
    if gaps:
        pool = np.setdiff1d(pool, np.r_[0:17, 150:260, n - 30:n])
    dofs = np.stack([rng.choice(pool, nd, replace=False) for _ in range(N)])
    A = rng.standard_normal((N, nd, nd)).astype(dtype)
    X = rng.standard_normal((n, B)).astype(dtype)
    coef = (rng.random(B) - 0.3).astype(dtype)     # some negative
    return A, dofs.astype(np.int32), X, coef


def _np_tiles(sc):
    tp = sc.tiles
    return [t.cpu().numpy().astype(np.int64) for t in tp[:6]] + [tp]


def _row_order(A, dofs, sc, X, coef=None, out=None):
    """The one-thread-per-output order: each row's sorted entries in turn,
    each a chain a[i,0] x0 + ... over j, then times coef."""
    perm = sc.perm.numpy().astype(np.int64)
    rowptr = sc.rowptr.numpy()
    nd = dofs.shape[1]
    Y = np.empty((sc.ndofs, X.shape[1]), X.dtype)
    for d in range(sc.ndofs):
        acc = np.zeros(X.shape[1], X.dtype)
        for k in range(rowptr[d], rowptr[d + 1]):
            e, i = divmod(int(perm[k]), nd)
            x = X[dofs[e]]
            s = A[e, i, 0] * x[0]
            for j in range(1, nd):
                s = s + A[e, i, j] * x[j]
            acc = acc + s
        Y[d] = acc if coef is None else acc * coef
    if out is None:
        return Y
    touched = rowptr[1:] > rowptr[:-1]
    res = out.copy()
    res[touched] = out[touched] + Y[touched]
    return res


def _tile_order(A, dofs, sc, X, coef=None, out=None):
    """The kernel's order of work on the plan, in numpy: per tile and
    chunk, each element record once (products to slots), then each
    output's row over the chunk's slots, partial sums carried between
    chunks."""
    rows, rptr, cptr, eptr, meta, gaps, tp = _np_tiles(sc)
    nd = dofs.shape[1]
    R, S = tp.rows_per_tile, tp.chunk_slots
    B = X.shape[1]
    Y = np.full((sc.ndofs, B), np.nan, X.dtype) if out is None else out.copy()
    for t in range(tp.n_tiles):
        q0 = t * R
        nr = min(R, len(rows) - q0)
        rp = rptr[q0:q0 + nr + 1]
        acc = np.zeros((nr, B), X.dtype)
        for c in range(cptr[t], cptr[t + 1]):
            clo = rp[0] + (c - cptr[t]) * S
            chi = min(clo + S, rp[-1])
            slots = np.full((chi - clo, B), np.nan, X.dtype)
            for rec in meta[eptr[c]:eptr[c + 1]]:
                e, de, sl = rec[0], rec[1:1 + nd], rec[1 + nd:1 + 2 * nd]
                np.testing.assert_array_equal(de, dofs[e])
                x = X[de]
                for i in range(nd):
                    if sl[i] < 0:
                        continue
                    s = A[e, i, 0] * x[0]
                    for j in range(1, nd):
                        s = s + A[e, i, j] * x[j]
                    assert np.isnan(slots[sl[i]]).all()
                    slots[sl[i]] = s
            for r in range(nr):
                for k in range(max(rp[r], clo), min(rp[r + 1], chi)):
                    acc[r] = acc[r] + slots[k - clo]
        for r in range(nr):
            d = rows[q0 + r]
            v = acc[r] if coef is None else acc[r] * coef
            Y[d] = v if out is None else Y[d] + v
    if out is None:
        Y[gaps] = 0 if coef is None else np.zeros(B, X.dtype) * coef
    return Y


# ---------------------------------------------------------------------------
# the plan (CPU)
# ---------------------------------------------------------------------------

def _tiles(sc, dofs, R, S):
    return sc._replace(tiles=te.make_tiles(dofs, sc.perm.numpy(),
                                           sc.rowptr.numpy(), "cpu", R, S))


@pytest.mark.parametrize("R,S", [(128, 512), (16, 512), (16, 7), (1, 3),
                                 (300, 40)])
@pytest.mark.parametrize("gaps", [False, True])
def test_tile_plan_partitions_entries(R, S, gaps):
    A, dofs, X, _ = _random_block(6, np.float64, N=300, n=400, gaps=gaps)
    n = X.shape[0] + 5                              # padding rows at the end
    sc = _tiles(te.make_scatter(dofs, n, "cpu"), dofs, R, S)
    rows, rptr, cptr, eptr, meta, gap_rows, tp = _np_tiles(sc)
    perm = sc.perm.numpy().astype(np.int64)
    rowptr = sc.rowptr.numpy()
    m = perm.size
    np.testing.assert_array_equal(rows, np.unique(dofs))
    np.testing.assert_array_equal(gap_rows,
                                  np.setdiff1d(np.arange(n), dofs))
    np.testing.assert_array_equal(rptr, np.append(rowptr[rows], m))
    assert tp.n_tiles == -(-len(rows) // R)
    assert tp.x_rows == dofs.max() + 1
    assert meta.shape[1] == te.meta_ints(6) == 16
    covered = np.zeros(m, int)
    max_chunk = max_elems = max_tile_chunks = 0
    for t in range(tp.n_tiles):
        k0 = rptr[t * R]
        k1 = rptr[min((t + 1) * R, len(rows))]
        max_tile_chunks = max(max_tile_chunks, cptr[t + 1] - cptr[t])
        for c in range(cptr[t], cptr[t + 1]):
            clo = k0 + (c - cptr[t]) * S
            chi = min(clo + S, k1)
            assert clo < chi
            covered[clo:chi] += 1
            max_chunk = max(max_chunk, chi - clo)
            recs = meta[eptr[c]:eptr[c + 1]]
            max_elems = max(max_elems, len(recs))
            # one record per entity of the chunk's entries, in the order
            # of its first entry, with every entry of the chunk in a slot
            ents = perm[clo:chi] // 6
            assert recs[:, 0].tolist() == list(dict.fromkeys(ents))
            seen = np.zeros(chi - clo, int)
            for rec in recs:
                e = rec[0]
                np.testing.assert_array_equal(rec[1:7], dofs[e])
                assert (rec[13:] == -1).all()
                for i, k in enumerate(rec[7:13]):
                    want = k >= 0
                    assert want == (clo <= np.flatnonzero(perm == e * 6 + i)[0]
                                    < chi)
                    if want:
                        assert perm[clo + k] == e * 6 + i
                        seen[k] += 1
            assert (seen == 1).all()
    assert (covered == 1).all()
    assert eptr[-1] == len(meta) and cptr[-1] == len(eptr) - 1
    assert (tp.max_chunk, tp.max_elems, tp.max_tile_chunks) == (
        max_chunk, max_elems, max_tile_chunks)


def test_tile_rows_follow_the_block_size():
    """A block with few rows takes smaller tiles, so that it still makes
    enough of them; a large one takes TILE_ROWS."""
    rng = np.random.default_rng(2)
    for n, want in ((400, te.MIN_TILE_ROWS), (9000, 16),
                    (te.TILE_ROWS * te.FILL_TILES + 7, te.TILE_ROWS)):
        dofs = rng.integers(0, n, size=(n, 3)).astype(np.int32)
        dofs[:, 0] = np.arange(n)                     # every row touched
        assert te.make_scatter(dofs, n, "cpu").tiles.rows_per_tile == want


def test_tile_plan_of_empty_block():
    sc = te.make_scatter(np.zeros((0, 3), np.int32), 50, "cpu")
    tp = sc.tiles
    assert tp.n_tiles == 0 and tp.rows.numel() == 0 and tp.max_chunk == 0
    assert tp.rptr.tolist() == [0] and tp.cptr.tolist() == [0]
    assert tp.eptr.tolist() == [0] and tp.x_rows == 0
    assert tp.meta.shape == (0, 8) and tp.max_elems == 0
    assert tp.gaps.tolist() == list(range(50))
    X = np.ones((50, 2))
    Y = _tile_order(np.zeros((0, 3, 3)), np.zeros((0, 3), np.int64), sc, X)
    assert (Y == 0).all()


def test_tile_plan_refuses_bad_sizes():
    dofs = np.array([[0, 1, 0], [1, 0, 1]])
    perm, rowptr = np.argsort(dofs.ravel(), kind="stable"), [0, 3, 6]
    te.make_tiles(dofs, perm, rowptr, "cpu", 512, 512)
    with pytest.raises(ValueError, match="rows_per_tile"):
        te.make_tiles(dofs, perm, rowptr, "cpu", rows_per_tile=0)
    with pytest.raises(ValueError, match="rows_per_tile"):
        te.make_tiles(dofs, perm, rowptr, "cpu", rows_per_tile=513)
    with pytest.raises(ValueError, match="chunk_slots"):
        te.make_tiles(dofs, perm, rowptr, "cpu", chunk_slots=513)
    with pytest.raises(ValueError, match="entries"):
        te.make_tiles(dofs, perm[:5], rowptr, "cpu")


@pytest.mark.parametrize("form", ["full", "out"])
@pytest.mark.parametrize("with_coef", [False, True])
@pytest.mark.parametrize("nd", [2, 3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tile_order_equals_row_order(dtype, nd, with_coef, form):
    """The kernel's order of work on the plan (small tiles and chunks, so
    rows straddle chunks) gives the one-thread-per-output order's bits."""
    A, dofs, X, coef = _random_block(nd, dtype, N=120, n=300, gaps=True)
    sc = _tiles(te.make_scatter(dofs, 300, "cpu"), dofs, 16, 5)
    c = coef if with_coef else None
    out = None
    if form == "out":
        out = np.random.default_rng(3).standard_normal(X.shape).astype(dtype)
    got = _tile_order(A, dofs, sc, X, c, out)
    want = _row_order(A, dofs, sc, X, c, out)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    untouched = np.setdiff1d(np.arange(300), dofs)
    assert untouched.size > 100
    if form == "out":
        np.testing.assert_array_equal(got[untouched], out[untouched])
    else:
        assert not got[untouched].any()


# ---------------------------------------------------------------------------
# the out= form on the CPU path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_coef", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_out_form_is_out_plus_plain(dtype, with_coef):
    A, dofs, X, coef = (torch.as_tensor(a)
                        for a in _random_block(6, dtype, gaps=True))
    sc = te.make_scatter(dofs, X.shape[0], "cpu")
    c = coef if with_coef else None
    out = torch.as_tensor(np.random.default_rng(5).standard_normal(
        X.shape).astype(dtype))
    want = out + te.element_apply_plain(A, dofs, sc, X, c)
    buf = out.clone()
    got = te.element_apply_plain(A, dofs, sc, X, c, out=buf)
    assert got is buf
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.fixture(scope="module")
def h015():
    """The port's advective sulcus system and its hierarchy at h = 0.15
    (CPU), with Robin blocks on every level."""
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
    D, mu = np.array([1.0, 0.3, 2.0]), np.array([0.5, 3.0, 40.0])
    ml = build_multilevel(sys, level_meshes_for(mesh), D, mu)
    return sys, ml, D, mu


@pytest.fixture()
def separate_add(monkeypatch):
    """Make ``_Block.apply_batched(..., out=Y)`` the separate apply and add
    that the call sites used before the out= form."""
    from fenics_eff_uptake_tpu_torch.parallel import sweep
    orig = sweep._Block.apply_batched

    def apply_then_add(self, X, coef=None, out=None):
        Y = orig(self, X, coef)
        return Y if out is None else out + Y

    def use():
        monkeypatch.setattr(sweep._Block, "apply_batched", apply_then_add)
    return use


def _bits(t):
    return t.contiguous().view(torch.uint8)


def test_operator_out_form_equals_separate_add(h015, separate_add):
    from fenics_eff_uptake_tpu_torch.parallel import sweep
    sys, _, D, mu = h015
    X = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (sys.ndofs, 3)))
    got = [sweep._apply_raw(sweep.operator_args(sys, D, mu, f32), x)
           for f32, x in ((False, X), (True, X.float()))]
    separate_add()
    want = [sweep._apply_raw(sweep.operator_args(sys, D, mu, f32), x)
            for f32, x in ((False, X), (True, X.float()))]
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("cycle", ["mult", "hybrid"])
def test_vcycle_out_form_equals_separate_add(h015, separate_add, cycle):
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import \
        make_ml_preconditioner
    sys, ml, _, _ = h015
    assert all(la.sys.R is not None for la in ml.levels)
    R = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (sys.ndofs, 3)).astype(np.float32))
    got = make_ml_preconditioner(ml, cycle)(R)
    separate_add()
    want = make_ml_preconditioner(ml, cycle)(R)
    assert torch.equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# per-call checks and the ctypes plan (CPU)
# ---------------------------------------------------------------------------

def test_call_checks_refuse_what_the_kernel_does_not_take():
    cpu = torch.device("cpu")
    X = torch.zeros((10, 3))
    args = (torch.float32, cpu, 10, 8)
    te._check_call(X, torch.ones(3), torch.zeros((10, 3)), *args)
    with pytest.raises(TypeError, match="f32 or f64"):
        te._check_call(X.double(), None, None, *args)
    with pytest.raises(ValueError, match="at least 8 rows"):
        te._check_call(X[:7], None, None, *args)
    with pytest.raises(ValueError, match="B >= 1"):
        te._check_call(torch.zeros((10, 0)), None, None, *args)
    with pytest.raises(ValueError, match="coef"):
        te._check_call(X, torch.ones(4), None, *args)
    with pytest.raises(ValueError, match="out must be"):
        te._check_call(X, None, torch.zeros((9, 3)), *args)
    with pytest.raises(ValueError, match="overlap"):
        te._check_call(X, None, X, *args)
    big = torch.zeros((20, 3))
    with pytest.raises(ValueError, match="overlap"):
        te._check_call(big[:10], None, big[5:15], *args)
    with pytest.raises(ValueError, match="contiguous"):
        te._check_call(torch.zeros((3, 10)).t(), None, None, *args)
    with pytest.raises(ValueError, match="CUDA device"):
        te._check_call(X, None, None, torch.float32, torch.device("meta"),
                       10, 8)
    # a per-sample block bound at B columns: exactly B, and no coef
    te._check_call(X, None, torch.zeros((10, 3)), *args, batch=3)
    with pytest.raises(ValueError, match="bound at B=4"):
        te._check_call(X, None, None, *args, batch=4)
    with pytest.raises(ValueError, match="no coef"):
        te._check_call(X, torch.ones(3), None, *args, batch=3)


def test_block_checks_at_binding():
    """Binding a block to the kernel checks its fixed tensors: CPU tensors
    and a plan of another block raise."""
    A, dofs, X, _ = (torch.as_tensor(a) for a in _random_block(3,
                                                               np.float32))
    sc = te.make_scatter(dofs, X.shape[0], "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        te.ElementKernel(A, dofs, sc)
    other = te.make_scatter(dofs, X.shape[0] + 3, "cpu")
    with pytest.raises(ValueError, match="not this block's"):
        te.ElementKernel(A, dofs, sc._replace(tiles=other.tiles))
    # per-sample matrices are a block like any other: the same checks
    with pytest.raises(ValueError, match="CUDA device"):
        te.ElementKernel(torch.stack([A, A]), dofs, sc)
    with pytest.raises(ValueError, match="nd, nd"):
        te.ElementKernel(A[None, None], dofs, sc)


@pytest.mark.parametrize("nd", [2, 3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_per_sample_form(dtype, nd):
    """The plain per-sample apply is, column for column, the shared apply
    of that column's matrices; ``out=`` is out plus it, bit for bit."""
    A, dofs, X, _ = _random_block(nd, dtype, gaps=True)
    rng = np.random.default_rng(nd)
    Ab = rng.standard_normal((X.shape[1],) + A.shape).astype(dtype)
    sc = te.make_scatter(dofs, X.shape[0], "cpu")
    dt, Xt = torch.as_tensor(dofs), torch.as_tensor(X)
    Y = te.element_apply_plain(torch.as_tensor(Ab), dt, sc, Xt)
    for b in range(X.shape[1]):
        col = te.element_apply_plain(torch.as_tensor(Ab[b]), dt, sc,
                                     Xt[:, b:b + 1].contiguous())
        assert torch.equal(Y[:, b:b + 1], col)
    out = torch.as_tensor(rng.standard_normal(X.shape).astype(dtype))
    got = te.element_apply_plain(torch.as_tensor(Ab), dt, sc, Xt,
                                 out=out.clone())
    assert torch.equal(got, out + Y)
    with pytest.raises(ValueError, match="no coef"):
        te.element_apply_plain(torch.as_tensor(Ab), dt, sc, Xt,
                               coef=torch.ones(X.shape[1]))
    with pytest.raises(ValueError, match="columns"):
        te.element_apply_plain(torch.as_tensor(Ab[:2]), dt, sc, Xt)


def test_plan_struct_matches_the_kernel():
    """Seven pointers, then twelve ints: the C ``Plan``."""
    S = te._PlanStruct
    assert S.is_f64.offset == 56 and S.n_gaps.offset == 56 + 10 * 4
    assert S.batch.offset == 56 + 11 * 4
    assert ctypes.sizeof(S) == 104


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

def _cuda_args(cuda, A, dofs, X, coef):
    sc = te.make_scatter(dofs, X.shape[0], cuda)
    return (torch.as_tensor(A, device=cuda),
            torch.as_tensor(dofs, device=cuda), sc,
            torch.as_tensor(X, device=cuda), torch.as_tensor(coef,
                                                             device=cuda))


def _check_forms(At, dt, sc, Xt, ct, tol):
    """Both forms, with and without coef, against plain; two launches bit
    for bit; out= leaves untouched rows as they were, and its part (the
    result less out) holds against plain's at tol of its own size."""
    k = te.ElementKernel(At, dt, sc)
    n0 = (te.ElementKernel.launches, te.ElementKernel.launches_out)
    untouched = torch.ones(sc.ndofs, dtype=torch.bool, device=Xt.device)
    untouched[dt.long().reshape(-1)] = False
    for c in (None, ct):
        Y = k(Xt, c)
        assert torch.isfinite(Y).all()
        assert _rel(Y, te.element_apply_plain(At, dt, sc, Xt, c)) < tol
        assert torch.equal(Y, k(Xt, c))
        out = torch.randn(Y.shape, dtype=Y.dtype, device=Y.device)
        got = k(Xt, c, out=out.clone())
        want = te.element_apply_plain(At, dt, sc, Xt, c, out=out.clone())
        assert _rel(got - out, want - out) < tol
        assert torch.equal(got[untouched], out[untouched])
        assert torch.equal(got, k(Xt, c, out=out.clone()))
    assert (te.ElementKernel.launches, te.ElementKernel.launches_out) == (
        n0[0] + 8, n0[1] + 4)


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3, 20, 96, 200])
@pytest.mark.parametrize("nd", [2, 3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_matches_plain_random_dofs(cuda, dtype, nd, B):
    A, dofs, X, coef = _random_block(nd, dtype, N=3000, n=4000, B=B,
                                     gaps=True)
    _check_forms(*_cuda_args(cuda, A, dofs, X, coef),
                 1e-12 if dtype == np.float64 else 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 20, 96])
def test_kernel_matches_plain_real_blocks(cuda, h015, B):
    """The h = 0.15 K, Adv and Robin blocks (nd 6) and the first P1
    level's K and Robin blocks (nd 3), bound on the card."""
    sys, ml, _, _ = h015
    rng = np.random.default_rng(B)
    blocks = [sys.K, sys.Adv, sys.R, ml.levels[1].sys.K, ml.levels[1].sys.R]
    for blk in blocks:
        blk = blk.to(cuda)
        for A, tol in ((blk.A64, 1e-12), (blk.A32, 2e-5)):
            X = torch.as_tensor(rng.standard_normal((blk.ndofs, B)),
                                dtype=A.dtype, device=cuda)
            c = torch.as_tensor(rng.random(B) + 0.5, dtype=A.dtype,
                                device=cuda)
            _check_forms(A, blk.dofs, blk.scatter, X, c, tol)
            # the block's own bound kernels give the same bits
            Y = blk.apply_batched(X, c)
            assert torch.equal(Y, te.ElementKernel(A, blk.dofs,
                                                   blk.scatter)(X, c))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 20, 96])
def test_plans_give_the_same_bits(cuda, B):
    """Tiles of 1 to 256 rows, and chunks of 5 entries and of one (rows
    straddling chunks), give the same bits: the per-row order is fixed."""
    A, dofs, X, coef = _random_block(6, np.float64, N=3000, n=4000, B=B,
                                     gaps=True)
    At, dt, sc, Xt, ct = _cuda_args(cuda, A, dofs, X, coef)
    k = te.ElementKernel(At, dt, sc)
    ref = k(Xt, ct)
    out = torch.randn(ref.shape, dtype=ref.dtype, device=cuda)
    ref_out = k(Xt, ct, out=out.clone())
    perm, rowptr = sc.perm.cpu().numpy(), sc.rowptr.cpu().numpy()
    for R, S in ((16, 512), (256, 512), (128, 5), (16, 5), (1, 1)):
        k2 = te.ElementKernel(At, dt, sc._replace(
            tiles=te.make_tiles(dofs, perm, rowptr, cuda, R, S)))
        assert torch.equal(k2(Xt, ct), ref)
        assert torch.equal(k2(Xt, ct, out=out.clone()), ref_out)


@pytest.mark.cuda
def test_bound_block_refuses_on_the_card(cuda):
    A, dofs, X, coef = _random_block(3, np.float32, N=500, n=600, B=4)
    At, dt, sc, Xt, ct = _cuda_args(cuda, A, dofs, X, coef)
    k = te.ElementKernel(At, dt, sc)
    n0 = te.ElementKernel.launches
    with pytest.raises(TypeError):
        k(Xt.double())
    with pytest.raises(ValueError, match="contiguous"):
        k(torch.zeros((4, 600), device=cuda).t())
    with pytest.raises(ValueError, match="CUDA device"):
        k(Xt.cpu())
    with pytest.raises(ValueError, match="overlap"):
        k(Xt, ct, out=Xt)
    with pytest.raises(ValueError, match="out must be"):
        k(Xt, ct, out=torch.zeros((600, 3), device=cuda))
    assert te.ElementKernel.launches == n0
    # a block made on the CPU has no kernels: a CUDA X raises
    from fenics_eff_uptake_tpu_torch.parallel.sweep import _Block
    blk = _Block.build(torch.as_tensor(A).double(), dofs, 600)
    assert blk.kernels is None
    with pytest.raises(ValueError, match="CUDA device"):
        blk.apply_batched(Xt)
    assert blk.to(cuda).kernels is not None


def _check_sample_forms(Ab, dt, sc, Xt, tol):
    """The per-sample kernel, both forms, against plain; two launches bit
    for bit; out= leaves untouched rows as they were."""
    k = te.ElementKernel(Ab, dt, sc)
    n0 = (te.ElementKernel.launches, te.ElementKernel.launches_out,
          te.ElementKernel.launches_sample)
    untouched = torch.ones(sc.ndofs, dtype=torch.bool, device=Xt.device)
    untouched[dt.long().reshape(-1)] = False
    Y = k(Xt)
    assert torch.isfinite(Y).all()
    assert _rel(Y, te.element_apply_plain(Ab, dt, sc, Xt)) < tol
    assert torch.equal(Y, k(Xt))
    assert not Y[untouched].any()
    out = torch.randn(Y.shape, dtype=Y.dtype, device=Y.device)
    got = k(Xt, out=out.clone())
    want = te.element_apply_plain(Ab, dt, sc, Xt, out=out.clone())
    assert _rel(got - out, want - out) < tol
    assert torch.equal(got[untouched], out[untouched])
    assert torch.equal(got, k(Xt, out=out.clone()))
    # product and add rounded apart: out= is the full form added to out
    assert torch.equal(got, out + Y)
    assert (te.ElementKernel.launches, te.ElementKernel.launches_out,
            te.ElementKernel.launches_sample) == (n0[0] + 4, n0[1] + 2,
                                                  n0[2] + 4)
    return k, Y


def _sample_args(cuda, nd, dtype, B, seed=0):
    A, dofs, X, _ = _random_block(nd, dtype, seed=seed, N=3000, n=4000, B=B,
                                  gaps=True)
    Ab = np.random.default_rng(seed + B).standard_normal(
        (B,) + A.shape).astype(dtype)
    At, dt, sc, Xt, _ = _cuda_args(cuda, A, dofs, X, np.ones(B, dtype))
    return torch.as_tensor(Ab, device=cuda), At, dofs, dt, sc, Xt


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 9, 20, 96])
@pytest.mark.parametrize("nd", [2, 3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_per_sample_kernel_matches_plain(cuda, dtype, nd, B):
    Ab, At, _, dt, sc, Xt = _sample_args(cuda, nd, dtype, B)
    _check_sample_forms(Ab, dt, sc, Xt,
                        1e-12 if dtype == np.float64 else 2e-5)
    # every column carrying the same matrices: the shared form's bits
    same = At[None].expand(B, -1, -1, -1).contiguous()
    assert torch.equal(te.ElementKernel(same, dt, sc)(Xt),
                       te.ElementKernel(At, dt, sc)(Xt))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 9])
def test_per_sample_kernel_on_real_blocks(cuda, h015, B):
    """The h = 0.15 Robin blocks (fine nd 6, first P1 level nd 3) with
    per-column matrices, through ``_Block.per_sample``."""
    sys, ml, _, _ = h015
    rng = np.random.default_rng(B)
    for blk in (sys.R, ml.levels[1].sys.R):
        blk = blk.to(cuda)
        ps = blk.per_sample(rng.standard_normal((B,) + tuple(blk.A64.shape)))
        assert ps.kernels is not None
        for A, tol in ((ps.A64, 1e-12), (ps.A32, 2e-5)):
            X = torch.as_tensor(rng.standard_normal((blk.ndofs, B)),
                                dtype=A.dtype, device=cuda)
            _, Y = _check_sample_forms(A, blk.dofs, blk.scatter, X, tol)
            assert torch.equal(Y, ps.apply_batched(X))
        with pytest.raises(ValueError, match="no coef"):
            ps.apply_batched(X, coef=torch.ones(B, dtype=X.dtype,
                                                device=cuda))


@pytest.mark.cuda
def test_per_sample_plans_give_the_same_bits(cuda):
    Ab, _, dofs, dt, sc, Xt = _sample_args(cuda, 6, np.float64, 9)
    ref = te.ElementKernel(Ab, dt, sc)(Xt)
    out = torch.randn(ref.shape, dtype=ref.dtype, device=cuda)
    ref_out = te.ElementKernel(Ab, dt, sc)(Xt, out=out.clone())
    perm, rowptr = sc.perm.cpu().numpy(), sc.rowptr.cpu().numpy()
    for R, S in ((16, 512), (256, 512), (128, 5), (16, 5), (1, 1)):
        k2 = te.ElementKernel(Ab, dt, sc._replace(
            tiles=te.make_tiles(dofs, perm, rowptr, cuda, R, S)))
        assert torch.equal(k2(Xt), ref)
        assert torch.equal(k2(Xt, out=out.clone()), ref_out)


@pytest.mark.cuda
def test_per_sample_block_refuses_another_batch(cuda):
    Ab, _, _, dt, sc, Xt = _sample_args(cuda, 3, np.float32, 9)
    k = te.ElementKernel(Ab, dt, sc)
    n0 = te.ElementKernel.launches
    with pytest.raises(ValueError, match="bound at B=9"):
        k(Xt[:, :4].contiguous())
    with pytest.raises(ValueError, match="no coef"):
        k(Xt, torch.ones(9, device=cuda))
    assert te.ElementKernel.launches == n0
    # the entry point itself refuses too, should a caller skip the wrapper
    from fenics_eff_uptake_tpu_torch.ops import _build
    X4 = Xt[:, :4].contiguous()
    Y4 = torch.empty_like(X4)
    err = _build.library().feu_element_apply(
        k._addr, X4.data_ptr(), None, Y4.data_ptr(), 0, 4,
        _build.raw_stream(cuda.index or 0))
    assert err != 0
