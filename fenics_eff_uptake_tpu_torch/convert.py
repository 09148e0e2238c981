"""State carried across from the JAX package.

Every function takes what the JAX package gives, as plain numpy arrays or
duck-typed fields (a ``MeshData``, a ``FunctionSpace``), and returns the
port's own structures, on ``device`` where they hold tensors.  Nothing of
the JAX package is imported.  The tests use them to hold each operator of
the port against JAX on identical arrays, independently of the port's own
assembly.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .fem.space import Function, FunctionSpace
from .meshing.generator import _mesh_from_arrays, _mesh_to_arrays
from .meshing.geometry import SulcusGeometry
from .meshing.mesh_data import MeshData
from .ops.banded import band_spans
from .ops.elemspmv import Scatter, make_tiles
from .parallel.sweep import TransportSystem, _Block
from .solvers.multilevel import (Level, MultilevelData, Transfer,
                                 TransferBands)

__all__ = ["mesh_from", "space_from", "transport_system_from_arrays",
           "robin_batch_from", "multilevel_from_arrays",
           "velocity_from_values"]


def mesh_from(md) -> MeshData:
    """The port's MeshData from a mesh with the JAX package's fields (its
    arrays copied as numpy); a port MeshData is returned as it is."""
    if isinstance(md, MeshData):
        return md
    g = md.geom
    geom = None if g is None else SulcusGeometry(
        width=g.width, height=g.height, sulcus_width=g.sulcus_width,
        sulcus_depth=g.sulcus_depth, mesh_size=g.mesh_size,
        refinement_factor=int(g.refinement_factor))
    arrays = {k: np.array(v) for k, v in _mesh_to_arrays(md).items()}
    return _mesh_from_arrays(arrays, geom, md.domain_type)


def space_from(sp, mesh=None) -> FunctionSpace:
    """The port's FunctionSpace of the same element and value size as
    ``sp`` (a JAX package FunctionSpace), on ``mesh`` (default:
    ``mesh_from(sp.mesh)``)."""
    return FunctionSpace(mesh_from(sp.mesh) if mesh is None else mesh,
                         sp.element, sp.vs)


def _i32(a, device):
    return torch.tensor(np.asarray(a).astype(np.int32), device=device)


def _block(d, name, device):
    if f"{name}_A64" not in d:
        return None
    A64 = torch.tensor(np.asarray(d[f"{name}_A64"]), dtype=torch.float64,
                       device=device)
    ids = np.asarray(d[f"{name}_ids"])
    perm = np.asarray(d[f"{name}_perm"])
    ndofs = int(d[f"{name}_ndofs"])
    rowptr = np.searchsorted(ids, np.arange(ndofs + 1))
    dofs = _i32(d[f"{name}_dofs"], device)
    return _Block.of(A64, A64.float(), dofs, Scatter(
        perm=_i32(perm, device), ids_sorted=_i32(ids, device),
        rowptr=_i32(rowptr, device), ndofs=ndofs,
        tiles=make_tiles(np.asarray(d[f"{name}_dofs"]), perm, rowptr,
                         device)))


def transport_system_from_arrays(d, mesh, element, device) -> TransportSystem:
    """The port's TransportSystem (advective or not) from the dict of numpy
    arrays that the JAX package's ``parallel.sweep._system_to_arrays``
    produces."""
    device = torch.device(device)

    def band(name):
        v = d.get(name)
        return None if v is None else torch.tensor(
            np.asarray(v), dtype=torch.float32, device=device)

    perm = d.get("perm")
    iperm = d.get("iperm")
    Kband, Advband = band("Kband"), band("Advband")
    return TransportSystem(
        K=_block(d, "K", device), R=_block(d, "R", device),
        Adv=_block(d, "Adv", device), Advband=Advband,
        Advspans=None if Advband is None else band_spans(Advband),
        free=torch.tensor(np.asarray(d["free"], dtype=bool),
                          device=device),
        bc_values=torch.tensor(np.asarray(d["bc_values"]),
                               dtype=torch.float64, device=device),
        ndofs=int(d["ndofs"]),
        space=FunctionSpace(mesh_from(mesh), element),
        Kband=Kband, Kspans=None if Kband is None else band_spans(Kband),
        perm=None if perm is None else np.asarray(perm),
        iperm=None if iperm is None else np.asarray(iperm))


def robin_batch_from(sys: TransportSystem, R_batch) -> _Block:
    """The per-sample Robin block of a carried system from a JAX
    (B, F, nd, nd) batch of Robin matrices on its facets (padded as the
    carried ``sys.R`` is; f32 values are carried exactly)."""
    return sys.R.per_sample(np.asarray(R_batch, dtype=np.float64))


def velocity_from_values(values, mesh) -> Function:
    """The port's velocity field (a Function on the P2 vector space with
    numpy values) from a JAX velocity Function's interleaved values."""
    return Function(FunctionSpace(mesh_from(mesh), "P2", vs=2),
                    np.asarray(values, dtype=np.float64))


def multilevel_from_arrays(levels: List[dict], Ainv, free_c, omega, D_vec,
                           mu_vec, device) -> MultilevelData:
    """The port's MultilevelData from the numpy leaves of a JAX one.

    ``levels`` holds one dict per smoothed level (fine first) with keys
    ``sys`` (a ``_system_to_arrays`` dict), ``mesh``, ``element``, ``dinv``,
    the transfer's ``t_cols``, ``t_w`` and ``n_coarse``, and its windowed
    bands ``tb_p``, ``tb_po``, ``pad_p``
    (prolongation band, window starts, input rows), ``tb_r``, ``tb_ro``,
    ``pad_r`` (restriction), ``tb_sig``, ``tb_isig``, and, in a step-mu
    hierarchy, ``R_batch``: the level's (B, F, nd, nd) per-sample Robin
    matrices (the JAX hierarchy's ``R_batches`` entry)."""
    device = torch.device(device)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    def idx(a):
        return torch.tensor(np.asarray(a).astype(np.int64), device=device)

    out = []
    for lv in levels:
        sys_l = transport_system_from_arrays(lv["sys"], lv["mesh"],
                                             lv["element"], device)
        tr = Transfer(cols=np.asarray(lv["t_cols"]),
                      weights=np.asarray(lv["t_w"]),
                      n_coarse=int(lv["n_coarse"]))
        p, r = f32(lv["tb_p"]), f32(lv["tb_r"])
        bands = TransferBands(p=p, po=_i32(lv["tb_po"], device),
                              r=r, ro=_i32(lv["tb_ro"], device),
                              sig=idx(lv["tb_sig"]), isig=idx(lv["tb_isig"]),
                              pad_p=int(lv["pad_p"]), pad_r=int(lv["pad_r"]),
                              ps=band_spans(p), rs=band_spans(r))
        rb = lv.get("R_batch")
        out.append(Level(sys=sys_l, dinv=f32(lv["dinv"]), free=sys_l.free,
                         transfer=tr, bands=bands,
                         R_batch=None if rb is None
                         else robin_batch_from(sys_l, rb)))
    return MultilevelData(
        levels=tuple(out), Ainv=f32(Ainv),
        free_c=torch.tensor(np.asarray(free_c, dtype=bool),
                            device=device),
        omega=float(omega),
        D_vec=torch.tensor(np.asarray(D_vec), dtype=torch.float64,
                           device=device),
        mu_vec=torch.tensor(np.asarray(mu_vec), dtype=torch.float64,
                            device=device))
