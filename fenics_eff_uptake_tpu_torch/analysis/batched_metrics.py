"""Batched sweep metrics (counterpart of ``analysis/batched_metrics.py``).

Every boundary, interface and mass integral of the sweep studies is
evaluated for all B sweep columns at once, in float64 on the columns'
device, from quadrature tables built once per (mesh, space).
``metrics_to_dicts`` expands the (B,) results into the reference's metric
dict schema, key for key.

With a velocity ``u`` (shared by the batch: the nondimensional Stokes field
is Pe-independent) its normal traces u . n are baked into per-facet-set
(F, Q) tables, and the advective fluxes u.n c fill the ``adv_*`` entries
(zero without it, as in the JAX package); per-sample diffusivities
``D_values`` scale the diffusive fluxes of Pe sweeps.  Per-sample uptake
profiles ``mu_profiles`` (the step-mu studies) are baked in as (B, F, Q)
tables of mu_b(x) at the bottom wall's quadrature points; the uptake
integrals then take them in place of the runtime ``mu_vec``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fem.assembly import cell_geometry
from ..fem.elements import tabulate
from ..fem.quadrature import triangle_rule
from ..fem.space import FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from .flux import boundary_quad, mouth_quad
from .mu_eff import compute_mu_eff_arc, compute_mu_eff_enh
from ..utils.profiling import span

__all__ = ["SweepMetrics", "build_sweep_metrics", "metrics_to_dicts"]


# quadrature degree of every facet and cell integral (the JAX default)
DEGREE = 4


class SweepMetrics(NamedTuple):
    fn: "object"          # (X (B, n), mu_vec (B,), D_vec (B,)) -> dict
    space: FunctionSpace
    D: float              # diffusivity of every column unless D_vec given


class _FQ(NamedTuple):
    """Device copy of one facet set's tables."""
    phi: torch.Tensor         # (F, Q, nd)
    grad: torch.Tensor        # (F, Q, nd, 2)
    normal: torch.Tensor      # (F, 2)
    length: torch.Tensor      # (F,)
    cell_dofs: torch.Tensor   # (F, nd) int64


def _fq(fq, device):
    if fq is None:
        return None

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)
    return _FQ(phi=f(fq.phi), grad=f(fq.grad), normal=f(fq.normal),
               length=f(fq.length),
               cell_dofs=torch.as_tensor(np.asarray(fq.cell_dofs),
                                         dtype=torch.long, device=device))


def _eval(fq: _FQ, X):
    return torch.einsum("fqi,bfi->bfq", fq.phi, X[:, fq.cell_dofs])


def _grad_n(fq: _FQ, X):
    g = torch.einsum("fqia,bfi->bfqa", fq.grad, X[:, fq.cell_dofs])
    return torch.einsum("bfqa,fa->bfq", g, fq.normal)


def _integral(qw, fq: _FQ, density):
    return torch.einsum("q,bfq,f->b", qw, density, fq.length)


def build_sweep_metrics(space: FunctionSpace, mesh: MeshData, D,
                        device, u=None, mu_profiles=None) -> SweepMetrics:
    """The all-metrics function of a sweep with default diffusivity ``D``
    and, optionally, the velocity Function ``u`` (numpy values on a P2
    vector space of the same mesh) and the B columns' uptake profiles
    ``mu_profiles`` (vectorised callables mu_b(x)).  A ``metrics``
    span."""
    with span("metrics"):
        return _build_sweep_metrics(space, mesh, D, device, u, mu_profiles)


def _build_sweep_metrics(space, mesh, D, device, u, mu_profiles):
    device = torch.device(device)
    raw = {}
    for name in ("left", "right", "top", "bottom"):
        raw[name] = boundary_quad(space, mesh.bc_marker == MARKERS[name],
                                  DEGREE)
    is_sulcus = mesh.domain_type == "sulcus"
    if is_sulcus:
        for name in ("bottom_left", "sulcus", "bottom_right"):
            raw[name] = boundary_quad(
                space, mesh.bottom_marker == MARKERS[name], DEGREE)
        raw["y0_ext"] = boundary_quad(
            space, mesh.y0_marker == MARKERS["y0_line"], DEGREE)
        raw["mouth"] = mouth_quad(space, DEGREE)
    quads = {k: _fq(v, device) for k, v in raw.items()}
    un_tab = {}
    if u is not None:
        for name, fq in raw.items():
            if fq is not None:
                un = np.einsum("fqa,fa->fq", fq.eval_vector(u.values, u.space),
                               fq.normal)
                un_tab[name] = torch.as_tensor(un, device=device)
    # per-sample mu(x) at the uptake walls' quadrature points, (B, F, Q);
    # None where the wall has no facets (its uptake is zero)
    mu_tab = {}
    if mu_profiles is not None:
        for name in ["bottom"] + (["bottom_left", "sulcus", "bottom_right"]
                                  if is_sulcus else []):
            fq = raw.get(name)
            mu_tab[name] = None if fq is None else torch.as_tensor(
                np.stack([np.asarray(m(fq.x[:, :, 0]), dtype=np.float64)
                          for m in mu_profiles]), device=device)
    qw_f = next(torch.as_tensor(v.qw, dtype=torch.float64, device=device)
                for v in raw.values() if v is not None)

    qp, qw = triangle_rule(DEGREE)
    phi_c = torch.as_tensor(tabulate(space.element, qp),
                            dtype=torch.float64, device=device)
    qwj = torch.as_tensor(qw, dtype=torch.float64, device=device)
    detJ, _ = cell_geometry(
        torch.as_tensor(mesh.vertices, dtype=torch.float64, device=device),
        torch.as_tensor(mesh.cells, dtype=torch.long, device=device))
    cdofs = torch.as_tensor(np.asarray(space.cell_dofs), dtype=torch.long,
                            device=device)
    cav = (torch.as_tensor(mesh.cell_domain == 1, device=device)
           if is_sulcus else None)

    def fn(X, mu_vec, D_vec):
        B = X.shape[0]
        zeros = torch.zeros(B, dtype=torch.float64, device=X.device)
        Ds = D_vec[:, None, None]
        out = {}

        def flux(name):
            """(diffusive flux, advective flux, their densities)"""
            fq = quads.get(name)
            if fq is None:
                return zeros, zeros, None, None
            dd = -Ds * _grad_n(fq, X)
            un = un_tab.get(name)
            ad = None if un is None else un[None] * _eval(fq, X)
            return (_integral(qw_f, fq, dd),
                    zeros if ad is None else _integral(qw_f, fq, ad), dd, ad)

        def uptake(name):
            fq = quads.get(name)
            if fq is None:
                return zeros
            cq = _eval(fq, X)
            if name in mu_tab:
                mt = mu_tab[name]
                return zeros if mt is None else _integral(qw_f, fq, mt * cq)
            return mu_vec * _integral(qw_f, fq, cq)

        for name in ("left", "right", "top", "bottom"):
            out[f"flux_{name}"], out[f"adv_{name}"] = flux(name)[:2]
        out["uptake_bottom"] = uptake("bottom")
        if is_sulcus:
            for name in ("bottom_left", "sulcus", "bottom_right"):
                out[f"flux_{name}"], out[f"adv_{name}"] = flux(name)[:2]
                out[f"uptake_{name}"] = uptake(name)
            fy = quads.get("y0_ext")
            mq = quads.get("mouth")
            out["flux_y0_ext"], out["adv_y0_ext"] = flux("y0_ext")[:2]
            out["C_y0_ext"] = (_integral(qw_f, fy, _eval(fy, X))
                               if fy is not None else zeros)
            J_open, J_open_adv, dd, ad = flux("mouth")
            out["flux_mouth"], out["adv_mouth"] = J_open, J_open_adv
            if mq is not None:
                # exchange metrics use the total signed density
                q_open = dd if ad is None else dd + ad
                out["E_L1"] = _integral(qw_f, mq, q_open.abs())
                out["Q_in"] = _integral(qw_f, mq, q_open.clamp(min=0.0))
                out["Q_out"] = _integral(qw_f, mq, (-q_open).clamp(min=0.0))
                out["C_mouth"] = _integral(qw_f, mq, _eval(mq, X))
            else:
                out["E_L1"] = out["Q_in"] = out["Q_out"] = zeros
                out["C_mouth"] = zeros
        cq = torch.einsum("qi,bti->btq", phi_c, X[:, cdofs])
        per_cell = torch.einsum("q,btq,t->bt", qwj, cq, detJ)
        out["total_mass"] = per_cell.sum(dim=1)
        if cav is not None:
            out["sulcus_mass"] = torch.where(cav[None, :], per_cell,
                                             0.0).sum(dim=1)
        return out

    return SweepMetrics(fn=fn, space=space, D=float(D))


def metrics_to_dicts(sm: SweepMetrics, mesh: MeshData, X, mu_values,
                     params_list, D_values=None):
    """Run the batched metrics and expand them into the reference's dicts.
    ``D_values`` (B,): per-column diffusivities (Pe sweeps); default the
    build-time D in every column.

    Returns (flux_metrics_list, mass_metrics_list, mu_eff_list).  A
    ``metrics`` span."""
    with span("metrics"):
        return _metrics_to_dicts(sm, mesh, X, mu_values, params_list,
                                 D_values)


def _metrics_to_dicts(sm, mesh, X, mu_values, params_list, D_values):
    B = X.shape[0]
    mu_vec = torch.as_tensor(np.asarray(mu_values, dtype=np.float64),
                             device=X.device)
    D_vec = torch.as_tensor(
        np.full(B, sm.D) if D_values is None
        else np.asarray(D_values, dtype=np.float64), device=X.device)
    raw = {k: v.cpu().numpy() for k, v in sm.fn(X, mu_vec, D_vec).items()}

    areas = mesh.cell_areas()
    total_area = float(areas.sum())
    sulcus_area = float(areas[mesh.cell_domain == 1].sum())
    rect_area = total_area - sulcus_area
    is_sulcus = mesh.domain_type == "sulcus"
    if is_sulcus:
        iy = mesh.interior_y0
        v = mesh.vertices
        L_mouth = float(np.linalg.norm(
            v[iy.edges[:, 1]] - v[iy.edges[:, 0]], axis=1).sum()) \
            if iy is not None else 0.0
        e = mesh.boundary.edges[mesh.y0_marker == MARKERS["y0_line"]]
        L_y0_ext = float(np.linalg.norm(
            v[e[:, 1]] - v[e[:, 0]], axis=1).sum())

    flux_list, mass_list, mueff_list = [], [], []
    for b in range(B):
        def F(name):
            d = float(raw[f"flux_{name}"][b])
            a = float(raw[f"adv_{name}"][b])
            return {"diffusive": d, "advective": a, "total": d + a}

        fm = {"physical_flux": {n: F(n) for n in
                                ("left", "right", "top", "bottom")},
              "uptake_flux": float(raw["uptake_bottom"][b])}
        if is_sulcus:
            segs = {n: F(n) for n in
                    ("bottom_left", "sulcus", "bottom_right")}
            J_open = float(raw["flux_mouth"][b])
            J_open_adv = float(raw["adv_mouth"][b])
            segs["sulcus_opening"] = {"diffusive": J_open,
                                      "advective": J_open_adv,
                                      "total": J_open + J_open_adv}
            E_L1 = float(raw["E_L1"][b])
            segs["sulcus_opening_extra"] = {
                "E_L1": E_L1,
                "E_avg": E_L1 / L_mouth if L_mouth > 0 else 0.0,
                "Q_in": float(raw["Q_in"][b]),
                "Q_out": float(raw["Q_out"][b]),
                "net_check": float(raw["Q_in"][b] - raw["Q_out"][b]),
                "length": L_mouth,
            }
            d_y0 = float(raw["flux_y0_ext"][b]) + J_open
            a_y0 = float(raw["adv_y0_ext"][b]) + J_open_adv
            segs["y0_flux"] = {"diffusive": d_y0, "advective": a_y0,
                               "total": d_y0 + a_y0}
            segs["bottom_combined"] = {
                f: sum(segs[k][f] for k in
                       ("bottom_left", "sulcus", "bottom_right"))
                for f in ("diffusive", "advective", "total")}
            segs["y0_combined"] = {
                f: sum(segs[k][f] for k in
                       ("bottom_left", "bottom_right", "sulcus_opening"))
                for f in ("diffusive", "advective", "total")}
            segs["_y0_identity_gap"] = abs(
                segs["y0_flux"]["total"] - segs["y0_combined"]["total"])
            fm["sulcus_specific"] = {
                "physical_flux": segs,
                "uptake_flux": {
                    "bottom_left": float(raw["uptake_bottom_left"][b]),
                    "sulcus": float(raw["uptake_sulcus"][b]),
                    "bottom_right": float(raw["uptake_bottom_right"][b]),
                    "total": float(raw["uptake_bottom_left"][b]
                                   + raw["uptake_sulcus"][b]
                                   + raw["uptake_bottom_right"][b]),
                },
            }
        flux_list.append(fm)

        tm = float(raw["total_mass"][b])
        if is_sulcus:
            sm_ = float(raw["sulcus_mass"][b])
            rm = tm - sm_
            mass_list.append({
                "total_mass": tm, "sulcus_mass": sm_,
                "rectangle_mass": rm,
                "total_area": total_area, "sulcus_area": sulcus_area,
                "rectangle_area": rect_area,
                "average_concentration": {
                    "total": tm / total_area,
                    "sulcus_region": (sm_ / sulcus_area
                                      if sulcus_area > 0 else None),
                    "rectangle_region": (rm / rect_area
                                         if rect_area > 0 else None),
                },
            })
        else:
            mass_list.append({"total_mass": tm, "total_area": total_area,
                              "average_concentration": tm / total_area})

        if not is_sulcus:
            mueff_list.append(None)
            continue
        params = params_list[b]
        C_mouth = float(raw["C_mouth"][b])
        C_ext = float(raw["C_y0_ext"][b])
        C_tot = C_mouth + C_ext
        mu = float(params.mu)
        arc = compute_mu_eff_arc(params)
        enh = compute_mu_eff_enh(params)
        pf = fm["sulcus_specific"]["physical_flux"]
        J_y0 = pf["y0_flux"]["total"]
        sim = J_y0 / C_tot if C_tot > 0 else None
        open_ = (pf["sulcus_opening"]["total"] / C_mouth
                 if C_mouth > 0 else None)

        def _ratio(x):
            return float(x / mu) if x is not None and mu != 0 else None

        def _pct(a, t):
            return (float(abs(a - t) / abs(t) * 100.0)
                    if a is not None and t not in (None, 0.0) else None)

        mueff_list.append({
            "mu_eff_arc": arc, "mu_eff_enh": enh,
            "mu_eff_sim": sim, "mu_eff_open": open_,
            "ratios": {"arc": _ratio(arc), "enh": _ratio(enh),
                       "sim": _ratio(sim), "open": _ratio(open_)},
            "errors_vs_sim": {"arc": _pct(arc, sim), "enh": _pct(enh, sim),
                              "open": _pct(open_, sim)},
            "audit": {
                "concentrations": {"C_y0_ext": C_ext, "C_mouth": C_mouth,
                                   "C_y0_total": C_tot},
                "lengths": {"L_y0_ext": L_y0_ext, "L_mouth": L_mouth,
                            "L_y0_total": L_y0_ext + L_mouth},
                "means": {
                    "mean_y0_ext": (C_ext / L_y0_ext
                                    if L_y0_ext > 0 else np.nan),
                    "mean_mouth": (C_mouth / L_mouth
                                   if L_mouth > 0 else np.nan),
                    "mean_y0_total": (
                        C_tot / (L_y0_ext + L_mouth)
                        if (L_y0_ext + L_mouth) > 0 else np.nan),
                },
                "fluxes": {"J_y0_total": J_y0,
                           "J_sigma_mouth": pf["sulcus_opening"]["total"]},
            },
        })
    return flux_list, mass_list, mueff_list
