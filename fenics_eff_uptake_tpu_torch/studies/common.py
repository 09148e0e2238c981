"""Shared study-driver machinery (counterpart of ``studies/common.py``).

``no_adv_batch`` is the workhorse of the no-advection studies: one mesh,
one operator build, one multigrid hierarchy, ONE batched mixed-precision
solve over all mu values of the geometry, then the batched metrics.
``stokes_for_study`` and ``transport_batch`` are the advective studies'
pair: one Stokes field per mesh, then ONE batched BiCGStab solve over the
geometry's Pe (and mu) columns.

Each takes ``shard=``: None, or a started ``parallel.sharding.RankGroup``
(n ranks, tp cells ranks per sweep row), which routes its solve through
the sharded path of the JAX package's ``--shard`` (``FEU_SHARD``): the
batch padded to a multiple of dp with its last column and sliced back, the
hierarchy built at the padded batch, f64 CG or BiCGStab in chunks of 20 up
to 50,000 iterations (``parallel.sharded_solve``), and the Stokes field by
sharded f64 MINRES (rtol 1e-9, chunks of 40).  The sharded solves run in
the ranks; the mesh, the setup, the metrics and every file stay here.  A
sharded batch's system and hierarchy are built on the CPU (the ranks take
host copies of them, and the card of a rank holds only its chunk); the
metrics run on the study's device.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..analysis.batched_metrics import build_sweep_metrics, metrics_to_dicts
from ..device import setup
from ..fem.space import Function
from ..meshing.generator import MESH_TAG, generate_mesh
from ..models.stokes_flow import stokes_solve
from ..params import Parameters
from ..parallel.sweep import (build_transport_system,
                              robin_matrices_for_mu, solve_sweep)
from ..solvers.multilevel import build_multilevel_for
from ..utils.diskcache import Memo

__all__ = ["make_no_adv_params", "make_mesh", "sweep_mus", "no_adv_batch",
           "stokes_for_study", "transport_batch", "add_shard_arguments",
           "shard_group", "create_study_dirs",
           "plot_or_skip", "save_csv", "save_metadata"]


def make_no_adv_params(mu_factor=1.0, sulci_w_dim=None, sulci_h_dim=None,
                       mesh_size_dim=None, **overrides) -> Parameters:
    """No-advection Parameters with mu_dim = baseline * factor."""
    p = Parameters(mode="no-adv", **overrides)
    if sulci_w_dim is not None:
        p.sulci_w_dim = sulci_w_dim
    if sulci_h_dim is not None:
        p.sulci_h_dim = sulci_h_dim
    if mesh_size_dim is not None:
        p.mesh_size_dim = mesh_size_dim
    p.mu_dim = Parameters.MU_DIM_NO_ADV * float(mu_factor)
    p.validate()
    p.nondim()
    return p


_MESH_MEMO = Memo(MESH_TAG, cap=64)


def make_mesh(geom_params: Parameters, domain_type: str = "sulcus",
              coarsen: float = 1.0):
    """The study mesh of one geometry (the shared host mesher, as
    ``simulation.get_mesh`` builds it), memoised in this process by its
    generation arguments as ``get_mesh`` memoises it: a study that comes
    back to a geometry gets the same MeshData, and with it the memoised
    systems built on it.  ``coarsen`` > 1: the same geometry at h scaled
    by it, without refinement (the two-level preconditioner's coarse
    mesh)."""
    kw = dict(domain_type=domain_type,
              **geom_params.get_mesh_generator_params())
    if coarsen != 1.0:
        kw.update(mesh_size=kw["mesh_size"] * coarsen, refinement_factor=1)
    key = tuple(sorted(kw.items()))
    mesh = _MESH_MEMO.get(key)
    return mesh if mesh is not None else _MESH_MEMO.put(
        key, generate_mesh(**kw))


def sweep_mus(geom_params: Parameters, mu_factors: List[float]):
    """Nondimensional mu of each factor on one geometry."""
    scale = geom_params.H_dim / geom_params.D_dim
    return [Parameters.MU_DIM_NO_ADV * f * scale for f in mu_factors]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


# what a study passes on to build_multilevel(_for) and to solve_sweep
BUILD_OPTIONS = ("coarse_inverse",)
SOLVE_OPTIONS = ("precision", "cycle", "cheap_passes", "inner_rtol",
                 "ml_dtype", "transfer_dtype", "n_smooth")


def split_solver_options(options):
    """A study's ``solver_options`` dict -> (build_multilevel_for's keyword
    arguments, solve_sweep's): ``coarse_inverse`` goes to the hierarchy,
    the rest to the solve."""
    options = dict(options or {})
    unknown = set(options) - set(BUILD_OPTIONS) - set(SOLVE_OPTIONS)
    if unknown:
        raise ValueError(f"unknown solver options {sorted(unknown)}")
    return ({k: options[k] for k in BUILD_OPTIONS if k in options},
            {k: options[k] for k in SOLVE_OPTIONS if k in options})


# the JAX package's sharded study solves: chunk length and iteration cap
SHARD_CHUNK = 20
SHARD_MAXITER = 50000


def _padded(values, shard):
    """``values`` padded with its last entry to a multiple of the shard's
    sweep ranks."""
    values = list(values)
    Bp = -(-len(values) // shard.dp) * shard.dp
    return values + [values[-1]] * (Bp - len(values))


def _check_shard(shard, device, **options):
    """A shard runs on the study's device and in one configuration (f64,
    the V-cycle under the partition): refuse another device, and options
    it would not honour."""
    if shard is None:
        return
    if shard.device.type != device.type:
        raise ValueError(f"a rank group on {shard.device} for a study on "
                         f"{device}")
    given = sorted(k for k, v in options.items() if v)
    if given:
        raise ValueError(f"the sharded solves take no {given}")


def _sharded_batch_solve(shard, sys, mesh, D_batch, mu_batch, rtol, device,
                         u=None, steps=None):
    """One geometry's batch through ``solve_sweep_sharded`` on the ranks of
    ``shard``: padded to a multiple of dp, the hierarchy (and the
    per-sample Robin matrices of ``steps``) built at the padded batch on
    sys's device (the CPU), X (on ``device``) and info sliced back to the
    batch.  Returns (X, info, the hierarchy, its build seconds)."""
    from ..parallel.sharded_solve import solve_sweep_sharded
    t0 = time.time()
    B = len(D_batch)
    D_p = _padded(D_batch, shard)
    mu_p = None if mu_batch is None else _padded(mu_batch, shard)
    steps_p = None if steps is None else _padded(steps, shard)
    Rb = None if steps_p is None else torch.stack(
        [robin_matrices_for_mu(sys, s) for s in steps_p])
    ml = build_multilevel_for(sys, mesh, D_p, mu_p, u_fine=u,
                              mu_callables=steps_p, robin_matrices_fine=Rb)
    ml_s = _sync(sys.free.device) - t0
    X, info = solve_sweep_sharded(shard, sys, D_p, mu_p, multilevel=ml,
                                  robin_matrices=Rb, rtol=rtol,
                                  maxiter=SHARD_MAXITER,
                                  chunk_iters=SHARD_CHUNK, device=device)
    info = {k: (v[:B] if isinstance(v, np.ndarray) else v)
            for k, v in info.items()}
    return X[:B], info, ml, ml_s


def require_converged(info, what):
    """Raise unless every column of a ``solve_sweep`` report converged: a
    study writes no row of a solve that stalled or broke down into NaN (a
    BiCGStab solve under a cycle that rounds to bf16 can)."""
    bad = np.flatnonzero(~np.asarray(info["converged"]))
    if bad.size:
        raise RuntimeError(
            f"{what}: columns {bad.tolist()} did not converge (iterations "
            f"{np.asarray(info['iters'])[bad].tolist()}, true relative "
            f"residuals {np.asarray(info['true_rel_resnorm'])[bad].tolist()})")


def no_adv_batch(geom_params: Parameters, mu_factors: List[float],
                 domain_type: str, device, rtol=1e-12, verbose=True,
                 solver_options=None, shard=None):
    """The pure-diffusion problem for several mu values on one mesh.
    ``solver_options``: ``solve_sweep``'s configuration keywords and
    ``coarse_inverse`` (``split_solver_options``); None is the default
    configuration.  ``shard``: a started ``RankGroup`` on ``device``
    solves the batch sharded (module docstring).  Raises RuntimeError if
    a column did not converge.

    Returns (results, stats): one dict per mu factor with the keys of the
    JAX package's results (c, mass_metrics, flux_metrics, params,
    mu_eff_comparison for sulcus domains, solver), and a stats dict with
    the mesh size, per-stage seconds (each stage ends in a device sync),
    per-column iterations, passes and relative residuals."""
    device = setup(device)
    t0 = time.time()
    mesh = make_mesh(geom_params, domain_type)
    t_mesh = _sync(device)
    mus = sweep_mus(geom_params, mu_factors)
    D_batch = [geom_params.D] * len(mus)
    build_kw, solve_kw = split_solver_options(solver_options)
    _check_shard(shard, device, solver_options=solver_options)
    sys = build_transport_system(mesh, device if shard is None else "cpu",
                                 element="P2")
    t_asm = _sync(device)
    if shard is not None:
        X, info, ml, ml_s = _sharded_batch_solve(shard, sys, mesh, D_batch,
                                                 mus, rtol, device)
        t_ml = t_asm + ml_s
    else:
        ml = build_multilevel_for(sys, mesh, D_batch, mu_values=mus,
                                  **build_kw)
        t_ml = _sync(device)
        X, info = solve_sweep(sys, D_batch, mu_values=mus, rtol=rtol,
                              multilevel=ml, **solve_kw)
    t_solve = _sync(device)
    require_converged(info, f"no_adv_batch {domain_type}")
    if verbose:
        print(f"  [batch] {domain_type} w={geom_params.sulci_w_dim} "
              f"h={geom_params.sulci_h_dim}: {len(mus)} solves in "
              f"{t_solve - t0:.2f}s (iters={info['iters'].tolist()}, "
              f"passes={info.get('passes')})")
    params_list = [
        make_no_adv_params(
            f, sulci_w_dim=geom_params.sulci_w_dim,
            sulci_h_dim=geom_params.sulci_h_dim,
            mesh_size_dim=geom_params.mesh_size_dim,
            L_dim=geom_params.L_dim, H_dim=geom_params.H_dim,
            refinement_factor=geom_params.refinement_factor)
        for f in mu_factors]
    space = sys.space
    sm = build_sweep_metrics(space, mesh, geom_params.D, device)
    flux_list, mass_list, mueff_list = metrics_to_dicts(sm, mesh, X, mus,
                                                        params_list)
    t_end = _sync(device)

    Xh = X.cpu().numpy()
    mesh_results = {"mesh": mesh, "mesh_info": mesh.mesh_info()}
    out = []
    for i in range(len(mu_factors)):
        res = {
            "c": Function(space, Xh[i]), "u": None, "p": None,
            "mass_metrics": mass_list[i],
            "flux_metrics": flux_list[i],
            "vel_metrics": {},
            "params": params_list[i],
            "mesh_results": mesh_results,
            "domain_type": domain_type,
            "solver": {"iters": int(info["iters"][i]),
                       "resnorm": float(info["resnorm"][i])},
        }
        if domain_type == "sulcus":
            res["mu_eff_comparison"] = mueff_list[i]
        out.append(res)
    stats = {
        "device": str(device), "cells": int(mesh.num_cells),
        "ndofs": int(space.ndofs), "ndofs_padded": int(sys.ndofs),
        "mesh_s": t_mesh - t0, "assembly_s": t_asm - t_mesh,
        "ml_setup_s": t_ml - t_asm, "solve_s": t_solve - t_ml,
        "metrics_s": t_end - t_solve, "total_s": t_end - t0,
        "iters": info["iters"].tolist(), "passes": info.get("passes"),
        "rel_resnorm": info["true_rel_resnorm"].tolist(),
        "multilevel": ml is not None,
    }
    return out, stats


def stokes_for_study(mesh, H, device, shard=None, **cycle_options):
    """The study's Stokes field (u, p) on ``device``, solved as the JAX
    package's ``stokes_solve`` does (MINRES + MG, outer rtol 1e-9, the
    field kept in the setup cache); the solver report, with its setup and
    solve seconds, is ``u.solver_info``.  ``cycle_options``: the velocity
    hierarchy's (``stokes_setup``).  ``shard``: a started ``RankGroup``
    solves it by sharded f64 MINRES instead, as the JAX package's
    ``sharded_stokes_or_single`` does, the field kept in the setup cache
    under a key of its own (``stokes_solve_sharded``)."""
    device = setup(device)
    if shard is None:
        return stokes_solve(mesh, H, device, **cycle_options)
    from ..parallel.sharded_solve import stokes_solve_sharded
    _check_shard(shard, device, **cycle_options)
    return stokes_solve_sharded(shard, mesh, H, rtol=1e-9, chunk_iters=40)


def transport_batch(mesh, u, D_batch, mu_batch, device, rtol=1e-12,
                    steps=None, solver_options=None, shard=None):
    """One domain's batch of advective transport columns (the unsharded
    JAX ``transport_batch``): the system with advection by ``u``, the
    hierarchy carrying u to every level, and ONE batched BiCGStab solve.
    Either ``mu_batch`` (uniform mu per column) or ``steps`` (one mu_b(x)
    callable per column, ``mu_batch`` None: per-sample Robin matrices on
    the fine system and on every level) selects the Robin term.

    ``solver_options`` and ``shard``: as for ``no_adv_batch``.  Raises
    RuntimeError if a column did not converge, as ``no_adv_batch`` does.

    Returns (X (B, n) f64 on ``device``, info, system (on the CPU when
    sharded), stats) with stats
    the stage seconds (each ending in a device sync) assembly_s,
    ml_setup_s, solve_s."""
    device = setup(device)
    t0 = time.time()
    build_kw, solve_kw = split_solver_options(solver_options)
    _check_shard(shard, device, solver_options=solver_options)
    sys = build_transport_system(mesh, device if shard is None else "cpu",
                                 u_values=u.values, u_space=u.space)
    if shard is not None:
        t_asm = _sync(device)
        X, info, ml, ml_s = _sharded_batch_solve(
            shard, sys, mesh, D_batch, mu_batch, rtol, device, u=u,
            steps=steps)
        t_ml = t_asm + ml_s
        t_solve = _sync(device)
        require_converged(info, "transport_batch")
        return X, info, sys, {"assembly_s": t_asm - t0,
                              "ml_setup_s": t_ml - t_asm,
                              "solve_s": t_solve - t_ml,
                              "multilevel": ml is not None}
    robin_matrices = None if steps is None else torch.stack(
        [robin_matrices_for_mu(sys, s) for s in steps])
    t_asm = _sync(device)
    ml = build_multilevel_for(sys, mesh, D_batch, mu_batch, u_fine=u,
                              mu_callables=steps,
                              robin_matrices_fine=robin_matrices, **build_kw)
    t_ml = _sync(device)
    X, info = solve_sweep(sys, D_batch, mu_batch, rtol=rtol, multilevel=ml,
                          robin_matrices=robin_matrices, **solve_kw)
    t_solve = _sync(device)
    require_converged(info, "transport_batch")
    stats = {"assembly_s": t_asm - t0, "ml_setup_s": t_ml - t_asm,
             "solve_s": t_solve - t_ml, "multilevel": ml is not None}
    return X, info, sys, stats


def add_shard_arguments(ap):
    """The studies' ``--shard N --tp T --backend B`` (the JAX CLIs'
    ``--shard``/``--tp``; the backend of ``RankGroup``)."""
    ap.add_argument("--shard", type=int, default=0, metavar="N",
                    help="run the solves sharded over N ranks "
                         "(parallel/sharded_solve.py); on --device cuda "
                         "the ranks share the cards, or the run raises")
    ap.add_argument("--tp", type=int, default=2,
                    help="cells-partition degree: ranks per sweep row "
                         "(the sweep is split over N / tp rows)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process-group backend (default: gloo on the "
                         "CPU, nccl on CUDA, which takes one card per "
                         "rank)")


def shard_group(args):
    """The RankGroup of a study CLI's ``--shard`` arguments (started once
    for the run), or None without ``--shard``; use it as a context
    manager."""
    if not args.shard:
        return contextlib.nullcontext()
    from ..parallel.sharding import RankGroup
    return RankGroup(args.shard, args.tp, args.device, args.backend)


def create_study_dirs(study_name, base_dir):
    """<base>/<study> Analysis (where the study's CSV, metadata and
    figures go) and <base>/<study> Simulations, made; returns (study_dir,
    sim_dir) (ref plotting.py:241-247)."""
    study_dir = os.path.join(base_dir, f"{study_name} Analysis")
    sim_dir = os.path.join(base_dir, f"{study_name} Simulations")
    os.makedirs(study_dir, exist_ok=True)
    os.makedirs(sim_dir, exist_ok=True)
    return study_dir, sim_dir


def plot_or_skip(what, plot, *args):
    """``plot(*args)`` where matplotlib imports; where it does not, one
    line saying that ``what`` was skipped, and the study goes on.  Any
    error of the plotting itself propagates.  Returns whether it
    plotted."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"  plots skipped ({what}): matplotlib is not installed")
        return False
    plot(*args)
    return True


def _cell(v):
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    return v


def save_csv(rows: List[Dict], path, sort_by=None):
    """Rows -> CSV with the columns of all rows in the order they first
    appear (before any sorting), floats at full precision, None, NaN and a column a row lacks
    as an empty cell (the JAX package's pandas output); ``sort_by``: keys
    to sort the rows by first (stable).  Returns the rows as written."""
    fields = list(dict.fromkeys(k for r in rows for k in r))
    if sort_by:
        rows = sorted(rows, key=lambda r: tuple(r[k] for k in sort_by))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        for r in rows:
            w.writerow({k: _cell(v) for k, v in r.items()})
    print(f"  CSV saved: {path} ({len(rows)} rows)")
    return rows


def save_metadata(meta: dict, path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2, default=str)
