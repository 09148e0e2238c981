"""Host (numpy) plans of the banded operator forms.

Numpy copies of the plan builders in the JAX package's ``ops/banded.py``,
whose module imports jax.  Two TPU-only details are left out: the band halo
is the exact ``ceil(spread / R)`` (the JAX menu of halos only kept compile
keys stable), and transfer window starts are not 16-aligned and the column
pad is not rounded to 2048 rows (TPU DMA alignment and compile keys).  The
window-width menu ``_RECT_W_MENU`` is kept; where no tile size fits it
(the JAX package then falls back to its gather transfer), the windows
widen beyond it (``_RECT_W_STEP``).

Band layouts (see ops/banded.py):

    square:       band[t, r, w] = A[t*R + r, (t - halo)*R + w],  W = (2*halo+1)*R
    rectangular:  band[t, r, w] = A[t*R + r, offs[t] + w]
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["BandPlan", "RectBandPlan", "rcm_permutation",
           "best_bandwidth_permutation", "build_band_plan",
           "build_rect_band_plan", "aligned_transfer_plans"]


class BandPlan(NamedTuple):
    """Scatter plan: element entries -> square band slots."""
    perm: np.ndarray          # (N*nd*nd,) argsort of flat band ids
    ids_sorted: np.ndarray    # (N*nd*nd,) sorted flat ids (row*W + w)
    tiles: int                # T
    tile: int                 # R
    width: int                # W = (2*halo + 1) * R
    halo: int


class RectBandPlan(NamedTuple):
    """Plan of a sparse (n_rows x n_cols) matrix as a windowed band."""
    offs: np.ndarray          # (T,) int32 window start per row tile
    ids: np.ndarray           # (M,) int32 sorted flat slots (dump slot
                              #   T*R*W for zero entries)
    perm: np.ndarray          # (M,) int32 argsort applied to entries
    tiles: int
    tile: int
    width: int
    n_rows_pad: int           # T * R
    n_cols_pad: int           # X must be zero-padded to this length


_RECT_W_MENU = (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)
_RECT_TILES = (256, 128, 64, 32, 16, 8)   # tile sizes tried, largest first
_RECT_MAX_BYTES = 500 * 2**20             # the menu's band bytes at most
# Past the menu: on a mesh refined toward the sulcus, a coarse dof's fine
# contributors spread over up to ~3.5e4 columns of the fine ordering (one
# restriction row alone over ~2.3e4 at refinement factor 16), so the
# restriction needs windows that wide; kernel B streams only each row
# block's column span of them.  Widths round up to _RECT_W_STEP, and the
# tile size of the fewest band bytes is taken, up to _RECT_WIDE_MAX_BYTES.
_RECT_W_STEP = 1024
_RECT_WIDE_MAX_BYTES = 4 * 2**30


def rcm_permutation(entity_dofs, ndofs_true: int, ndofs_padded: int):
    """Reverse-Cuthill-McKee ordering of the dof graph; padding dofs keep
    their tail positions.  Returns (new2old, old2new) int32."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ed = np.asarray(entity_dofs)
    ed = ed[(ed < ndofs_true).all(axis=1)]
    nd = ed.shape[1]
    rows = np.repeat(ed, nd, axis=1).ravel()
    cols = np.tile(ed, (1, nd)).ravel()
    A = sps.coo_matrix(
        (np.ones(len(rows), dtype=np.int8), (rows, cols)),
        shape=(ndofs_true, ndofs_true)).tocsr()
    p = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                   dtype=np.int64)
    new2old = np.concatenate(
        [p, np.arange(ndofs_true, ndofs_padded, dtype=np.int64)])
    old2new = np.empty(ndofs_padded, dtype=np.int64)
    old2new[new2old] = np.arange(ndofs_padded)
    return new2old.astype(np.int32), old2new.astype(np.int32)


def _spread_of(entity_dofs, old2new):
    e = old2new.astype(np.int64)[np.asarray(entity_dofs)]
    return int((e.max(axis=1) - e.min(axis=1)).max())


def best_bandwidth_permutation(entity_dofs, dof_coords, ndofs_true: int,
                               ndofs_padded: int):
    """The smaller-spread ordering of RCM and a lexicographic (x, y) sweep
    (the sweep wins on the studies' elongated channel)."""
    cand = [rcm_permutation(entity_dofs, ndofs_true, ndofs_padded)]
    if dof_coords is not None and len(dof_coords) >= ndofs_true:
        xy = np.asarray(dof_coords)[:ndofs_true]
        order = np.lexsort((xy[:, 1], xy[:, 0]))
        n2o = np.concatenate(
            [order.astype(np.int64),
             np.arange(ndofs_true, ndofs_padded, dtype=np.int64)])
        o2n = np.empty(ndofs_padded, dtype=np.int64)
        o2n[n2o] = np.arange(ndofs_padded)
        cand.append((n2o.astype(np.int32), o2n.astype(np.int32)))
    ed = np.asarray(entity_dofs)
    ed = ed[(ed < ndofs_true).all(axis=1)]
    return min(cand, key=lambda c: _spread_of(ed, c[1]))


def build_band_plan(entity_dofs, ndofs: int, tile: int = 256) -> BandPlan:
    """Band scatter plan for (already permuted) entity dofs; ``ndofs``
    must be a multiple of ``tile``."""
    ed = np.asarray(entity_dofs, dtype=np.int64)
    if ndofs % tile:
        raise ValueError(f"ndofs {ndofs} not a multiple of tile {tile}")
    spread = int((ed.max(axis=1) - ed.min(axis=1)).max())
    halo = max(1, -(-spread // tile))
    W = (2 * halo + 1) * tile
    T = ndofs // tile
    rows = ed[:, :, None]
    cols = ed[:, None, :]
    t = rows // tile
    w = cols - (t - halo) * tile                 # in [0, W)
    flat = (rows * W + w).ravel()
    order = np.argsort(flat, kind="stable")
    return BandPlan(perm=order.astype(np.int32),
                    ids_sorted=flat[order].astype(np.int64),
                    tiles=T, tile=tile, width=W, halo=halo)


def _rect_windows(rows, cols, live, n_rows, t_r):
    """(T, the window starts, the widest window) of row tiles of t_r."""
    T = -(-n_rows // t_r)
    tidx = rows // t_r
    mn = np.full(T, np.iinfo(np.int64).max)
    mx = np.full(T, -1)
    np.minimum.at(mn, tidx[live], cols[live])
    np.maximum.at(mx, tidx[live], cols[live])
    empty = mx < 0
    mn[empty] = 0
    mx[empty] = 0
    return T, mn, int((mx - mn).max()) + 1


def build_rect_band_plan(rows, cols, vals, n_rows, n_cols):
    """Windowed band of sparse entries (rows, cols, vals), or None when the
    ordering has no locality.  Zero entries go to a dump slot.  Tiles
    shrink from 256 rows until each tile's window fits the W menu within
    _RECT_MAX_BYTES; where none does, the windows widen in steps of
    _RECT_W_STEP at the tile size of the fewest band bytes, up to
    _RECT_WIDE_MAX_BYTES (None past that)."""
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    live = vals != 0
    windows, pick = [], None
    for t_r in _RECT_TILES:
        T, offs, need = _rect_windows(rows, cols, live, n_rows, t_r)
        windows.append((t_r, T, offs, need))
        W = next((w for w in _RECT_W_MENU if w >= need), None)
        if W is not None and T * t_r * W * 4 <= _RECT_MAX_BYTES:
            pick = (t_r, T, offs, W)
            break
    if pick is None:
        wide = []
        for t_r, T, offs, need in windows:
            W = -(-need // _RECT_W_STEP) * _RECT_W_STEP
            wide.append((T * t_r * W * 4, -t_r, (t_r, T, offs, W)))
        nbytes, _, pick = min(wide, key=lambda x: x[:2])
        if nbytes > _RECT_WIDE_MAX_BYTES:
            return None
    t_r, T, offs, W = pick
    tidx = rows // t_r
    n_cols_pad = max(int((offs + W).max()), int(n_cols))
    w_idx = cols - offs[tidx]
    flat = (tidx * t_r + rows % t_r) * W + w_idx
    flat = np.where(live, flat, T * t_r * W)   # dump slot
    perm = np.argsort(flat, kind="stable")
    return RectBandPlan(offs=offs.astype(np.int32),
                        ids=flat[perm].astype(np.int64),
                        perm=perm.astype(np.int32),
                        tiles=T, tile=t_r, width=W,
                        n_rows_pad=T * t_r, n_cols_pad=n_cols_pad)


def aligned_transfer_plans(cols, weights, n_fine, n_coarse):
    """Windowed-band plans for both directions of one MG transfer, with
    the coarse side re-ordered by first fine contributor so the entry cloud
    is near-diagonal.  Returns (plan_p, plan_r, sig, inv_sig) or None;
    ``Xc_sigma = Xc[sig]`` and ``Y = Y_sigma[inv_sig]``."""
    cols = np.asarray(cols)
    w = np.asarray(weights)
    nf, nd = cols.shape
    rows = np.repeat(np.arange(nf), nd)
    cflat = cols.ravel().astype(np.int64)
    wflat = w.ravel()
    live = wflat != 0
    key = np.full(n_coarse, np.iinfo(np.int64).max)
    np.minimum.at(key, cflat[live], rows[live])
    sig = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty(n_coarse, np.int32)
    inv[sig] = np.arange(n_coarse, dtype=np.int32)
    c2 = inv[cflat]
    p_p = build_rect_band_plan(rows, c2, wflat, nf, n_coarse)
    p_r = build_rect_band_plan(c2, rows, wflat, n_coarse, nf)
    if p_p is None or p_r is None:
        return None
    return p_p, p_r, sig, inv
