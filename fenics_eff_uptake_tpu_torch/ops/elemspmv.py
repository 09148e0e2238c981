"""Element-block operator apply (counterpart of ``ops/elemspmv.py``) and
kernel C, the fused element apply.

An operator block is kept as per-entity dense matrices ``A_e (N, nd, nd)``
plus the entity -> dof map, and applied to a batch-minor ``(n, B)`` array:

    Y[d, b] = coef[b] * sum_{(e,i): dofs[e,i] = d} sum_j A_e[e,i,j] X[dofs[e,j], b]

:func:`element_apply` dispatches on the device of ``X``: a CPU tensor takes
the plain PyTorch version (gather, einsum, ``index_add_`` in sorted order);
a CUDA tensor launches the hand-written kernel of
``csrc/element_apply.cu`` or raises.  There is no fallback between the two.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["Scatter", "make_scatter", "element_apply",
           "element_apply_plain", "check_element_apply_args",
           "sorted_segment_sum"]

# entity sizes kernel C is compiled for: 6 (P2 cells, and P2 Robin facets,
# which carry their owner cell's dofs), 3 (P1), 2 (two-node edge blocks)
KERNEL_ND = (2, 3, 6)


class Scatter(NamedTuple):
    """Sorted-scatter plan for one entity -> dof map."""
    perm: torch.Tensor        # (N*nd,) int32: flat entries sorted by dof
    ids_sorted: torch.Tensor  # (N*nd,) int32: their dof ids, ascending
    rowptr: torch.Tensor      # (ndofs+1,) int32: CSR start of each dof
    ndofs: int


def make_scatter(entity_dofs, ndofs: int, device) -> Scatter:
    """Host-built plan; ``entity_dofs`` (N, nd) numpy or tensor."""
    ids = np.asarray(torch.as_tensor(entity_dofs).cpu()).ravel()
    perm = np.argsort(ids, kind="stable")
    ids_sorted = ids[perm]
    rowptr = np.searchsorted(ids_sorted, np.arange(ndofs + 1))

    def t(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    return Scatter(perm=t(perm), ids_sorted=t(ids_sorted), rowptr=t(rowptr),
                   ndofs=int(ndofs))


def sorted_segment_sum(vals, ids_sorted, num_segments: int):
    """out[s] = sum of vals[k] over ids_sorted[k] == s, added in k order.

    Deterministic on every device: pass r adds the r-th entry of each
    segment, so no two additions of one pass touch the same slot (CUDA's
    ``index_add_`` with repeated ids uses atomics in no fixed order)."""
    ids = ids_sorted.long()
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    m = ids.numel()
    if m == 0:
        return out
    pos = torch.arange(m, device=ids.device)
    start = torch.ones(m, dtype=torch.bool, device=ids.device)
    start[1:] = ids[1:] != ids[:-1]
    seg_start = torch.cummax(torch.where(start, pos, 0), dim=0).values
    rank = pos - seg_start
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        out.index_add_(0, ids[sel], vals[sel])
    return out


def element_apply_plain(A, dofs, scatter: Scatter, X, coef=None):
    """Plain PyTorch kernel C: gather, einsum, ``index_add_`` in sorted
    order.  Runs on any device; the CPU path and the tests use it."""
    N, nd = dofs.shape
    B = X.shape[1]
    Xe = X[dofs.long()]                                  # (N, nd, B)
    Ye = torch.einsum("nij,njb->nib", A.to(X.dtype), Xe)
    if coef is not None:
        Ye = Ye * coef.to(X.dtype)
    Y = torch.zeros((scatter.ndofs, B), dtype=X.dtype, device=X.device)
    Y.index_add_(0, scatter.ids_sorted.long(),
                 Ye.reshape(N * nd, B)[scatter.perm.long()])
    return Y


def check_element_apply_args(A, dofs, scatter: Scatter, X, coef=None):
    """Raise unless kernel C can take these arguments as they are."""
    if A.dim() == 4:
        raise NotImplementedError(
            "per-sample (B, N, nd, nd) element matrices are not supported "
            "by the CUDA element-apply kernel yet")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (N, nd, nd), got {tuple(A.shape)}")
    N, nd = A.shape[0], A.shape[1]
    if nd not in KERNEL_ND:
        raise ValueError(f"nd={nd} not in {KERNEL_ND}")
    if X.dtype not in (torch.float32, torch.float64) or A.dtype != X.dtype:
        raise TypeError(f"A and X must share f32 or f64, got {A.dtype}, "
                        f"{X.dtype}")
    if X.dim() != 2:
        raise ValueError(f"X must be (n, B), got {tuple(X.shape)}")
    if tuple(dofs.shape) != (N, nd) or dofs.dtype != torch.int32:
        raise ValueError("dofs must be (N, nd) int32")
    ts = [A, dofs, scatter.perm, scatter.rowptr, X]
    if coef is not None:
        if coef.dtype != X.dtype or tuple(coef.shape) != (X.shape[1],):
            raise ValueError("coef must be (B,) of X's dtype")
        ts.append(coef)
    if scatter.perm.numel() != N * nd or scatter.perm.dtype != torch.int32:
        raise ValueError("scatter.perm must be (N*nd,) int32")
    if (scatter.rowptr.numel() != scatter.ndofs + 1
            or scatter.rowptr.dtype != torch.int32):
        raise ValueError("scatter.rowptr must be (ndofs+1,) int32")
    for t in ts:
        if t.device.type != "cuda" or t.device != X.device:
            raise ValueError("kernel C needs every tensor on X's CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel C needs contiguous tensors")


def element_apply(A, dofs, scatter: Scatter, X, coef=None):
    """Kernel C: ``(n, B) -> (ndofs, B)`` through one element block."""
    if X.device.type == "cpu":
        return element_apply_plain(A, dofs, scatter, X, coef)
    check_element_apply_args(A, dofs, scatter, X, coef)
    B = X.shape[1]
    Y = torch.empty((scatter.ndofs, B), dtype=X.dtype, device=X.device)
    lib = _build.library()
    err = lib.feu_element_apply(
        int(X.dtype == torch.float64), A.shape[1], A.data_ptr(),
        dofs.data_ptr(), scatter.perm.data_ptr(), scatter.rowptr.data_ptr(),
        X.data_ptr(), None if coef is None else coef.data_ptr(),
        Y.data_ptr(), scatter.ndofs, B, _build.stream_of(X))
    _build.check(err, "element_apply")
    element_apply.launches += 1
    return Y


element_apply.launches = 0
