"""The system under test: the port's public layer entries, called in the
order the study drivers call them (``studies.common.no_adv_batch``, and
``transport_batch`` then the metrics for an advective sweep), with the
options the configuration file states.  The harness puts a span of its own
around each call through ``stage``; each ends in a device sync, as the
drivers' stage timers do.

A configuration names its ``mode`` and passes the studies' own option
dicts: ``rtol``, ``solver_options`` (split by the port's
``split_solver_options`` between ``build_multilevel_for`` and
``solve_sweep``, as the drivers split them) and, for an advective mode,
``stokes_options`` (``stokes_for_study``'s).  A mode or a key the drivers
would not honour raises.

This module is the only one of the benchmark that imports the package
under test.
"""

from __future__ import annotations

import torch

from fenics_eff_uptake_tpu_torch.analysis.batched_metrics import (
    build_sweep_metrics, metrics_to_dicts)
from fenics_eff_uptake_tpu_torch.device import setup
from fenics_eff_uptake_tpu_torch.params import Parameters
from fenics_eff_uptake_tpu_torch.parallel.sweep import (
    build_transport_system, solve_sweep)
from fenics_eff_uptake_tpu_torch.solvers.multilevel import \
    build_multilevel_for
from fenics_eff_uptake_tpu_torch.studies.common import (
    make_mesh, make_no_adv_params, require_converged, split_solver_options,
    stokes_for_study, sweep_mus)
from fenics_eff_uptake_tpu_torch.utils.diskcache import clear_memos

__all__ = ["Port", "MODES"]

MODES = ("no-adv", "adv-diff")


class Port:
    """One configuration of the port on one device.  ``control``: the
    port's own f32 solve (``solve_sweep(precision="f32")``) in place of the
    configuration's precision, its answers handed on as they come (the f32
    path's own convergence test, on the true f64 residual, is what the
    check is there to judge)."""

    def __init__(self, config, device, control=False):
        mode = config["mode"]
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: the benchmark drives {MODES}")
        if config["element"] != "P2":
            raise ValueError(f"element {config['element']!r}: the studies "
                             "solve transport in P2")
        if mode == "no-adv" and \
                config["mu_dim_base"] != Parameters.MU_DIM_NO_ADV:
            raise ValueError("the no-adv drivers take mu_dim = "
                             f"{Parameters.MU_DIM_NO_ADV} x factor")
        self.cfg = config
        self.device = setup(device)
        self.control = control
        self.advective = mode == "adv-diff"
        self.rtol = float(config["rtol"])
        self.build_options, self.solve_options = split_solver_options(
            config["solver_options"])
        if control:
            self.solve_options["precision"] = "f32"
        self.stokes_options = dict(config.get("stokes_options") or {})
        if self.stokes_options and not self.advective:
            raise ValueError("stokes_options for a mode without flow")
        self.flow = None          # (geometry, mesh, u, p) of the last flow
        # the calls a test may replace
        self.build_multilevel_for = build_multilevel_for
        self.solve_sweep = solve_sweep
        self.metrics_to_dicts = metrics_to_dicts

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- parameters of the studies --------------------------------------
    def no_adv_params(self, w, d, factor=1.0):
        c = self.cfg
        return make_no_adv_params(
            factor, sulci_w_dim=w, sulci_h_dim=d,
            mesh_size_dim=c["mesh_size_dim"], L_dim=c["L_dim"],
            H_dim=c["H_dim"], D_dim=c["D_dim"],
            refinement_factor=c["refinement_factor"])

    def adv_params(self, w, d, Pe, factor):
        """The adv-diff study's ``create_base_parameters``, at this
        configuration's geometry."""
        c = self.cfg
        p = Parameters(mode="adv-diff", U_ref_dim=Pe * c["D_dim"] / c["H_dim"],
                       D_dim=c["D_dim"], L_dim=c["L_dim"], H_dim=c["H_dim"],
                       sulci_w_dim=w, sulci_h_dim=d,
                       mesh_size_dim=c["mesh_size_dim"],
                       refinement_factor=c["refinement_factor"])
        p.mu_dim = c["mu_dim_base"] * float(factor)
        p.validate()
        p.nondim()
        return p

    def _flow_for(self, geometry, stage):
        """The mesh and Stokes field (MINRES + MG) of ``geometry``, as the
        adv-diff study makes them, remade whenever the geometry differs
        from the last one's (a memo of one entry: a mix on one geometry
        keeps the field its set-up solved)."""
        _, w, d = geometry
        if self.flow is None or self.flow[0] != (w, d):
            self.flow = None
            p0 = self.adv_params(w, d, 1.0, 1.0)
            with stage("meshing"):
                mesh = make_mesh(p0, "sulcus")
            with stage("stokes"):
                u, p = stokes_for_study(mesh, p0.H, self.device,
                                        **self.stokes_options)
            self.flow = ((w, d), mesh, u, p)
        return self.flow[1:]

    def setup(self, geometry, stage):
        """The set-up of the first request's geometry: the advective
        configuration's mesh and Stokes field."""
        if self.advective:
            self._flow_for(geometry, stage)

    def _converged(self, info, what):
        if not self.control:
            require_converged(info, what)

    # -- one request ----------------------------------------------------
    def request(self, req, stage):
        """One sweep, on the study's first visit to its geometry (the port's
        in-process memos emptied first): a dict of X (B, n) on the device,
        info, the metric dicts (flux, mass, mu_eff lists), the mesh, the
        system and hierarchy (for the cost of the solve), the columns' D
        and mu, the Krylov method, cycle and smoothing steps, and the
        values of the Stokes field (u, p) or None."""
        clear_memos()
        if self.advective:
            return self._transport(req, stage)
        return self._no_adv(req, stage)

    def _solve(self, sys, mesh, D, mu, stage, **ml_kw):
        with stage("ml_setup"):
            ml = self.build_multilevel_for(sys, mesh, D, mu, **ml_kw,
                                           **self.build_options)
        with stage("solve"):
            X, info = self.solve_sweep(sys, D, mu_values=mu, rtol=self.rtol,
                                       multilevel=ml, **self.solve_options)
        return ml, X, info

    def _no_adv(self, req, stage):
        _, w, d = req["geometry"]
        factors = req["mu_factor"]
        g = self.no_adv_params(w, d)
        with stage("meshing"):
            mesh = make_mesh(g, "sulcus")
        mus = sweep_mus(g, factors)
        D = [g.D] * len(mus)
        with stage("assembly"):
            sys = build_transport_system(mesh, self.device, element="P2")
        ml, X, info = self._solve(sys, mesh, D, mus, stage)
        self._converged(info, "no-adv sweep")
        with stage("metrics"):
            params = [self.no_adv_params(w, d, f) for f in factors]
            sm = build_sweep_metrics(sys.space, mesh, g.D, self.device)
            dicts = self.metrics_to_dicts(sm, mesh, X, mus, params)
        return dict(X=X, info=info, dicts=dicts, mesh=mesh, sys=sys, ml=ml,
                    D=D, mu=mus, krylov="cg",
                    cycle=self.solve_options.get("cycle", "hybrid"),
                    n_smooth=self.solve_options.get("n_smooth", 1),
                    stokes=None)

    def _transport(self, req, stage):
        _, w, d = req["geometry"]
        Pe, factors = req["Pe"], req["mu_factor"]
        D = [1.0 / x for x in Pe]
        mu = [float(f) * self.cfg["mu_dim_base"] * self.cfg["H_dim"]
              / self.cfg["D_dim"] for f in factors]
        mesh, u, p = self._flow_for(req["geometry"], stage)
        with stage("assembly"):
            sys = build_transport_system(mesh, self.device, element="P2",
                                         u_values=u.values, u_space=u.space)
        ml, X, info = self._solve(sys, mesh, D, mu, stage, u_fine=u)
        self._converged(info, "adv-diff sweep")
        with stage("metrics"):
            params = [self.adv_params(w, d, a, f)
                      for a, f in zip(Pe, factors)]
            sm = build_sweep_metrics(sys.space, mesh, 1.0, X.device, u=u)
            dicts = self.metrics_to_dicts(sm, mesh, X, mu, params,
                                          D_values=D)
        return dict(X=X, info=info, dicts=dicts, mesh=mesh, sys=sys, ml=ml,
                    D=D, mu=mu, krylov="bicgstab",
                    cycle=self.solve_options.get("cycle", "mult"),
                    n_smooth=self.solve_options.get("n_smooth", 1),
                    stokes=(u.values, p.values))

    def release(self):
        """Drop what the port holds, so that the check runs in the memory
        the window leaves."""
        self.flow = None
        clear_memos()

