"""Shared study-driver machinery (counterpart of ``studies/common.py``).

``no_adv_batch`` is the workhorse of the no-advection studies: one mesh,
one operator build, one multigrid hierarchy, ONE batched mixed-precision
solve over all mu values of the geometry, then the batched metrics.
``stokes_for_study`` and ``transport_batch`` are the advective studies'
pair: one Stokes field per mesh, then ONE batched BiCGStab solve over the
geometry's Pe (and mu) columns.
"""

from __future__ import annotations

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
from ..meshing.generator import generate_mesh
from ..models.stokes_flow import stokes_solve_mg
from ..params import Parameters
from ..parallel.sweep import (build_transport_system,
                              robin_matrices_for_mu, solve_sweep)
from ..solvers.multilevel import build_multilevel_for

__all__ = ["make_no_adv_params", "make_mesh", "sweep_mus", "no_adv_batch",
           "stokes_for_study", "transport_batch",
           "create_study_dir", "save_csv", "save_metadata"]


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


def make_mesh(geom_params: Parameters, domain_type: str = "sulcus"):
    """The study mesh of one geometry (the shared host mesher, as
    ``simulation.get_mesh`` builds it)."""
    return generate_mesh(domain_type=domain_type,
                         **geom_params.get_mesh_generator_params())


def sweep_mus(geom_params: Parameters, mu_factors: List[float]):
    """Nondimensional mu of each factor on one geometry."""
    scale = geom_params.H_dim / geom_params.D_dim
    return [Parameters.MU_DIM_NO_ADV * f * scale for f in mu_factors]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def no_adv_batch(geom_params: Parameters, mu_factors: List[float],
                 domain_type: str, device, rtol=1e-12, verbose=True):
    """The pure-diffusion problem for several mu values on one mesh.

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
    sys = build_transport_system(mesh, device, element="P2")
    t_asm = _sync(device)
    ml = build_multilevel_for(sys, mesh, D_batch, mu_values=mus)
    t_ml = _sync(device)
    X, info = solve_sweep(sys, D_batch, mu_values=mus, rtol=rtol,
                          multilevel=ml)
    t_solve = _sync(device)
    if verbose:
        print(f"  [batch] {domain_type} w={geom_params.sulci_w_dim} "
              f"h={geom_params.sulci_h_dim}: {len(mus)} solves in "
              f"{t_solve - t0:.2f}s (iters={info['iters'].tolist()}, "
              f"passes={info['passes']})")
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
        "iters": info["iters"].tolist(), "passes": info["passes"],
        "rel_resnorm": info["rel_resnorm"].tolist(),
        "multilevel": ml is not None,
    }
    return out, stats


def stokes_for_study(mesh, H, device):
    """The study's Stokes field (u, p) on ``device``, solved as the JAX
    package's ``stokes_solve`` does (MINRES + MG, outer rtol 1e-9); the
    solver report, with its setup and solve seconds, is ``u.solver_info``."""
    return stokes_solve_mg(mesh, H, setup(device))


def transport_batch(mesh, u, D_batch, mu_batch, device, rtol=1e-12,
                    steps=None):
    """One domain's batch of advective transport columns (the unsharded
    JAX ``transport_batch``): the system with advection by ``u``, the
    hierarchy carrying u to every level, and ONE batched BiCGStab solve.
    Either ``mu_batch`` (uniform mu per column) or ``steps`` (one mu_b(x)
    callable per column, ``mu_batch`` None: per-sample Robin matrices on
    the fine system and on every level) selects the Robin term.

    Returns (X (B, n) f64 on ``device``, info, system, stats) with stats
    the stage seconds (each ending in a device sync) assembly_s,
    ml_setup_s, solve_s."""
    device = setup(device)
    t0 = time.time()
    sys = build_transport_system(mesh, device, u_values=u.values,
                                 u_space=u.space)
    robin_matrices = None if steps is None else torch.stack(
        [robin_matrices_for_mu(sys, s) for s in steps])
    t_asm = _sync(device)
    ml = build_multilevel_for(sys, mesh, D_batch, mu_batch, u_fine=u,
                              mu_callables=steps,
                              robin_matrices_fine=robin_matrices)
    t_ml = _sync(device)
    X, info = solve_sweep(sys, D_batch, mu_batch, rtol=rtol, multilevel=ml,
                          robin_matrices=robin_matrices)
    t_solve = _sync(device)
    stats = {"assembly_s": t_asm - t0, "ml_setup_s": t_ml - t_asm,
             "solve_s": t_solve - t_ml, "multilevel": ml is not None}
    return X, info, sys, stats


def create_study_dir(study_name, base_dir):
    """<base>/<study> Analysis, where the study's CSV and metadata go."""
    study_dir = os.path.join(base_dir, f"{study_name} Analysis")
    os.makedirs(study_dir, exist_ok=True)
    return study_dir


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
