"""State carried across from the JAX package.

Both functions take plain numpy arrays, as the JAX package exports them,
and return the port's structures on ``device``.  The tests use them to hold
each operator of the port against JAX on identical arrays, independently of
the port's own assembly.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from fenics_eff_uptake_tpu.fem.space import Function, FunctionSpace

from .ops.elemspmv import Scatter
from .parallel.sweep import TransportSystem, _Block
from .solvers.multilevel import (Level, MultilevelData, Transfer,
                                 TransferBands)

__all__ = ["transport_system_from_arrays", "multilevel_from_arrays",
           "velocity_from_values"]


def _i32(a, device):
    return torch.tensor(np.asarray(a).astype(np.int32), device=device)


def _block(d, name, device):
    if f"{name}_A64" not in d:
        return None
    A64 = torch.tensor(np.asarray(d[f"{name}_A64"]), dtype=torch.float64,
                       device=device)
    ids = np.asarray(d[f"{name}_ids"])
    ndofs = int(d[f"{name}_ndofs"])
    rowptr = np.searchsorted(ids, np.arange(ndofs + 1))
    return _Block(A64=A64, A32=A64.float(),
                  dofs=_i32(d[f"{name}_dofs"], device),
                  scatter=Scatter(perm=_i32(d[f"{name}_perm"], device),
                                  ids_sorted=_i32(ids, device),
                                  rowptr=_i32(rowptr, device), ndofs=ndofs))


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
    return TransportSystem(
        K=_block(d, "K", device), R=_block(d, "R", device),
        Adv=_block(d, "Adv", device), Advband=band("Advband"),
        free=torch.tensor(np.asarray(d["free"], dtype=bool),
                          device=device),
        bc_values=torch.tensor(np.asarray(d["bc_values"]),
                               dtype=torch.float64, device=device),
        ndofs=int(d["ndofs"]), space=FunctionSpace(mesh, element),
        Kband=band("Kband"),
        perm=None if perm is None else np.asarray(perm),
        iperm=None if iperm is None else np.asarray(iperm))


def velocity_from_values(values, mesh) -> Function:
    """The port's velocity field (a Function on the P2 vector space with
    numpy values) from a JAX velocity Function's interleaved values."""
    return Function(FunctionSpace(mesh, "P2", vs=2),
                    np.asarray(values, dtype=np.float64))


def multilevel_from_arrays(levels: List[dict], Ainv, free_c, omega, D_vec,
                           mu_vec, device) -> MultilevelData:
    """The port's MultilevelData from the numpy leaves of a JAX one.

    ``levels`` holds one dict per smoothed level (fine first) with keys
    ``sys`` (a ``_system_to_arrays`` dict), ``mesh``, ``element``, ``dinv``,
    the transfer's ``t_cols``, ``t_w`` and ``n_coarse``, and its windowed
    bands ``tb_p``, ``tb_po``, ``pad_p``
    (prolongation band, window starts, input rows), ``tb_r``, ``tb_ro``,
    ``pad_r`` (restriction), ``tb_sig``, ``tb_isig``."""
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
        bands = TransferBands(p=f32(lv["tb_p"]), po=_i32(lv["tb_po"], device),
                              r=f32(lv["tb_r"]), ro=_i32(lv["tb_ro"], device),
                              sig=idx(lv["tb_sig"]), isig=idx(lv["tb_isig"]),
                              pad_p=int(lv["pad_p"]), pad_r=int(lv["pad_r"]))
        out.append(Level(sys=sys_l, dinv=f32(lv["dinv"]), free=sys_l.free,
                         transfer=tr, bands=bands))
    return MultilevelData(
        levels=tuple(out), Ainv=f32(Ainv),
        free_c=torch.tensor(np.asarray(free_c, dtype=bool),
                            device=device),
        omega=float(omega),
        D_vec=torch.tensor(np.asarray(D_vec), dtype=torch.float64,
                           device=device),
        mu_vec=torch.tensor(np.asarray(mu_vec), dtype=torch.float64,
                            device=device))
