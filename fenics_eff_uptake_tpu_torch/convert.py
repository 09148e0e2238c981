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
from .parallel.sweep import TransportSystem, _Block, system_from_arrays
from .solvers.multilevel import (Level, MultilevelData, Transfer,
                                 transfer_bands)

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


def transport_system_from_arrays(d, mesh, element, device) -> TransportSystem:
    """The port's TransportSystem (advective or not) from the dict of numpy
    arrays that the JAX package's ``parallel.sweep._system_to_arrays``
    produces (``parallel.sweep.system_from_arrays``, which also restores
    the port's own cache entries)."""
    return system_from_arrays(
        d, FunctionSpace(mesh_from(mesh), element), device)


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
                           mu_vec, device,
                           coarse_info=None) -> MultilevelData:
    """The port's MultilevelData from the numpy leaves of a JAX one.

    The JAX hierarchy holds f32 arrays whatever its cycle's dtype: the
    bf16 cycle and the bf16 transfer bands (its ``FEU_ML_BF16`` and
    ``FEU_ML_TB_BF16`` settings) cast them where the cycle's arguments are
    made.  So a hierarchy built under either setting carries over as it
    is, and the port's cycle makes its bf16 copies of the carried arrays
    when ``make_ml_preconditioner`` is given that dtype.  ``Ainv``
    is the JAX hierarchy's (B, nc, nc) f32 inverses however they were made
    (host LAPACK or its device Newton-Schulz); ``coarse_info`` is kept as
    the hierarchy's ``info["coarse_inverse"]``.  A level without the
    ``tb_*`` keys (the JAX CPU default's gather transfers) carries no
    bands: only the f64 cycle runs on it.

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
        bands = None
        if lv.get("tb_p") is not None:
            p, r = f32(lv["tb_p"]), f32(lv["tb_r"])
            bands = transfer_bands(
                p=p, po=_i32(lv["tb_po"], device),
                r=r, ro=_i32(lv["tb_ro"], device),
                sig=idx(lv["tb_sig"]), isig=idx(lv["tb_isig"]),
                pad_p=int(lv["pad_p"]), pad_r=int(lv["pad_r"]))
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
                            device=device),
        info={"coarse_inverse": coarse_info
              or {"method": "carried", "worst_residual": None}},
        lowp={})
