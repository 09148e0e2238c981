"""One simulation end to end (counterpart of ``simulation.py``; the
reference's ``run_simulation``): mesh -> velocity -> concentration ->
metrics -> JSON, with the reference's output layout

  <results_root>/<Mode> Simulations/<study>/<config>/
      {Mesh Files, ParaView Files, Analysis Plots, Results Data}

and its results dict keys.  Each stage is timed (``timings``: mesh,
stokes, transport, metrics, mu_eff, plot, mesh_io, paraview; the device
stages end in a device sync).  The transport solve is the batched engine
at B = 1 (``models/diffusion.py``, ``models/advdiff.py``); the velocity is
the Stokes field of ``models/stokes_flow.stokes_solve`` (zero in the
no-adv mode).  Meshes come through the setup cache
(``studies.common.make_mesh``: memoised in this process, and on disk under
the ``port-mesh`` tag).

``plot=True`` writes the per-run figures (``plotting.single``) into
``Analysis Plots`` and needs matplotlib (without it the run raises the
ImportError, as the JAX package's does); ``save_paraview=True`` writes the
legacy-VTK fields and the mesh exports (``utils.vtk``,
``meshing.visualization``) into ``ParaView Files``.  The transport
models get ``get_coarse_mesh``'s mesh, as the JAX package's do: it
preconditions the solve (``solvers/twolevel.py``) only where no multigrid
hierarchy is built.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from .analysis.flux import compute_flux_metrics
from .analysis.mass import compute_mass_metrics
from .analysis.mu_eff import compute_mu_eff_metrics
from .analysis.profiles import compute_velocity_metrics
from .device import setup
from .meshing.msh_io import write_msh2
from .meshing.visualization import save_mesh_visualization
from .models.advdiff import advdiff_solve
from .models.diffusion import pure_diffusion_solve
from .models.stokes_flow import stokes_solve, stokes_zero_fields
from .params import Parameters
from .plotting.single import plot_single_simulation
from .studies.common import _MESH_MEMO, _sync, make_mesh
from .utils.timers import StageTimer
from .utils.vtk import (write_vtk_cell_scalar, write_vtk_point_scalar,
                        write_vtk_point_vector)

__all__ = ["run_simulation", "get_mesh", "get_coarse_mesh",
           "clear_mesh_cache", "MODE_NAME"]

MODE_NAME = {
    "adv-diff": "Adv-Diff",
    "no-adv": "No Advection",
    "no-uptake": "No Uptake",
}


def clear_mesh_cache():
    """Empty the in-process mesh memo (the disk entries stay)."""
    _MESH_MEMO.clear()


def get_mesh(params: Parameters, domain_type: str, coarsen: float = 1.0):
    """The mesh of ``params``' geometry and mesh size, through the setup
    cache; ``coarsen`` > 1 gives the same geometry at h scaled by it (the
    two-level preconditioner's coarse mesh)."""
    return make_mesh(params, domain_type, coarsen)


def get_coarse_mesh(params: Parameters, domain_type: str, threshold=0.08,
                    factor=4.0):
    """The coarse companion mesh of the two-level preconditioner, or None
    where the fine mesh is coarse enough (h >= ``threshold``) for Jacobi
    alone."""
    if params.mesh_size >= threshold:
        return None
    return get_mesh(params, domain_type, coarsen=factor)


def _save_paraview(mesh, u, p, c, paraview_dir):
    """The domain markers, velocity, pressure and concentration as
    legacy-VTK files (u and p may be None)."""
    os.makedirs(paraview_dir, exist_ok=True)
    write_vtk_cell_scalar(os.path.join(paraview_dir, "mesh_domains.vtk"),
                          mesh, mesh.cell_domain, name="domain")
    if u is not None:
        write_vtk_point_vector(os.path.join(paraview_dir, "velocity.vtk"), u)
    if p is not None:
        write_vtk_point_scalar(os.path.join(paraview_dir, "pressure.vtk"),
                               p, name="p")
    write_vtk_point_scalar(os.path.join(paraview_dir, "concentration.vtk"),
                           c, name="c")


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def _strip_private(d):
    if isinstance(d, dict):
        return {k: _strip_private(v) for k, v in d.items()
                if not k.startswith("_")}
    return d


def run_simulation(mode, study_type, config_name, domain_type,
                   params: Parameters, device="cuda", results_root="Results", save_outputs=True, plot=False,
                   save_paraview=False, verbose=True, solver_options=None,
                   stokes_options=None):
    """Run one simulation on ``device`` and return the results dict (c, u,
    p, mass_metrics, flux_metrics, vel_metrics, params, mesh_results,
    domain_type, timings, and mu_eff_comparison on a sulcus domain).

    ``solver_options``: the transport solve's configuration (as
    ``pure_diffusion_solve`` takes it); ``stokes_options``: keyword
    arguments of ``stokes_solve`` (rtol, method, precision, the velocity
    cycle's options).  None is the default configuration.  With
    ``save_outputs`` the mesh (``Mesh Files/*.msh`` and ``*.npz``) and
    ``Results Data/simulation_results.json`` are written, and with
    ``plot`` / ``save_paraview`` the figures and the ParaView files."""
    if mode not in MODE_NAME:
        raise ValueError(f"Invalid mode '{mode}'")
    if domain_type not in ("sulcus", "rectangular"):
        raise ValueError(f"Invalid domain type '{domain_type}'")
    device = setup(device)
    start = time.time()
    timer = StageTimer()

    base = os.path.join(results_root, f"{MODE_NAME[mode]} Simulations",
                        study_type, config_name)
    dirs = {name: os.path.join(base, name)
            for name in ("Mesh Files", "ParaView Files",
                         "Analysis Plots", "Results Data")}
    if save_outputs:
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)

    with timer.stage("mesh"):
        mesh = get_mesh(params, domain_type)
    mesh_results = {"mesh": mesh, "mesh_info": mesh.mesh_info(),
                    "bc_markers": mesh.bc_marker}
    if domain_type == "sulcus":
        mesh_results.update({
            "bottom_segment_markers": mesh.bottom_marker,
            "y0_markers": mesh.y0_marker,
            "domain_markers": mesh.cell_domain,
        })
    if verbose:
        mi = mesh.mesh_info()
        print(f"[{config_name}] mesh: {mi['num_vertices']} vertices, "
              f"{mi['num_cells']} cells, h in "
              f"[{mi['hmin']:.4g}, {mi['hmax']:.4g}]")

    with timer.stage("stokes"):
        if mode == "no-adv":
            u, p = stokes_zero_fields(mesh)
        else:
            u, p = stokes_solve(mesh, params.H, device,
                                **(stokes_options or {}))
    u_for_transport = None if mode == "no-adv" else u

    with timer.stage("transport"):
        coarse = get_coarse_mesh(params, domain_type)
        if mode == "no-adv":
            c = pure_diffusion_solve(mesh, device, D=params.D, mu=params.mu,
                                     solver_options=solver_options,
                                     coarse_mesh=coarse)
        else:
            c = advdiff_solve(mesh, u, device, D=params.D, mu=params.mu,
                              solver_options=solver_options,
                              coarse_mesh=coarse)
        _sync(device)
    if verbose:
        arr = c.as_numpy()
        print(f"[{config_name}] transport solve: {c.solver_info}; "
              f"c stats: min={arr.min():.6e} max={arr.max():.6e} "
              f"mean={arr.mean():.6e}")

    with timer.stage("metrics"):
        flux_metrics = compute_flux_metrics(
            c, u_for_transport, mesh, domain_type, params.D, params.mu,
            warn=verbose)
        mass_metrics = compute_mass_metrics(c, mesh, domain_type)
        vel_metrics = compute_velocity_metrics(u_for_transport, mesh, params)

    results = {
        "c": c, "u": u, "p": p,
        "mass_metrics": mass_metrics,
        "flux_metrics": flux_metrics,
        "vel_metrics": vel_metrics,
        "params": params,
        "mesh_results": mesh_results,
        "domain_type": domain_type,
        "timings": timer.summary(),
    }
    if domain_type == "sulcus":
        with timer.stage("mu_eff"):
            results["mu_eff_comparison"] = compute_mu_eff_metrics(
                c, mesh, params, flux_metrics)

    if plot and save_outputs:
        with timer.stage("plot"):
            plot_single_simulation(results, dirs["Analysis Plots"])

    if save_outputs:
        # the mesh as .msh and .npz (the reference writes .geo, .msh and
        # dolfin .xml)
        with timer.stage("mesh_io"):
            base_name = ("sulcus_mesh" if domain_type == "sulcus"
                         else "rect_mesh")
            write_msh2(os.path.join(dirs["Mesh Files"], base_name + ".msh"),
                       mesh.vertices, mesh.cells)
            np.savez_compressed(
                os.path.join(dirs["Mesh Files"], base_name + ".npz"),
                vertices=mesh.vertices, cells=mesh.cells,
                cell_domain=mesh.cell_domain, bc_marker=mesh.bc_marker,
                bottom_marker=mesh.bottom_marker, y0_marker=mesh.y0_marker)
    if save_paraview and save_outputs:
        with timer.stage("paraview"):
            _save_paraview(mesh, u, p, c, dirs["ParaView Files"])
            save_mesh_visualization(mesh, dirs["ParaView Files"])
    if save_outputs:
        serializable = {
            "params": params.to_dict(),
            "mass_metrics": mass_metrics,
            "flux_metrics": _strip_private(flux_metrics),
            "mesh_info": mesh.mesh_info(),
            "mu_eff_comparison": results.get("mu_eff_comparison", None),
            "timings": timer.summary(),
        }
        with open(os.path.join(dirs["Results Data"],
                               "simulation_results.json"), "w") as f:
            json.dump(serializable, f, indent=4, default=_json_default)

    results["timings"] = timer.summary()
    if verbose:
        print(f"[{config_name}] done in {time.time() - start:.2f}s "
              f"({results['timings']})")
    return results
