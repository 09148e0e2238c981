"""The benchmark's plain reference: the sulcus transport problem worked out
again from a geometry, to judge what the package under test returned.

It imports nothing of the package under test, nor JAX.  ``Geometry``
remakes the mesh (the frozen mesher beside this file), assembles the P2
operators itself (``fem``) and holds the program's outputs to them:

* ``mesh_gap``: the program's mesh against the remade one, entry for entry
  (0 when equal);
* ``transport_residual``: per column, the relative residual of the
  program's concentration X under the reference operator
  D K + Adv(u) + mu R with c = 1 on the inlet and c = 0 on the outlet;
* ``metrics`` / ``metrics_gap``: the flux, uptake, mouth-exchange, mass and
  mu_eff numbers of each column, computed from X and compared with the
  program's metric dicts;
* ``stokes_residual``: the relative residual of the program's Taylor-Hood
  field (u, p) under the reference Stokes operator (Poiseuille inflow, no
  slip on the top and bottom walls, do-nothing outflow).

Everything runs on the CPU in float64; ``dtype=torch.float32`` gives the
control's lower precision.
"""

from __future__ import annotations

import numpy as np
import torch

from .fem import P2Mesh, apply, dirichlet, facet_tables
from .mesher import generate_mesh

__all__ = ["Geometry", "METRIC_KEYS", "program_metrics", "metrics_gap"]

LEFT, RIGHT, TOP, BOTTOM, Y0 = 1, 2, 3, 4, 10

# (name, scale) of each compared metric; the scale says what the gap is
# measured against: "flux" the column's largest of |inflow|, |outflow| and
# |uptake|, "area" the domain's area (a mass as a mean concentration),
# "self" the reference value itself
METRIC_KEYS = (("uptake", "flux"), ("flux_left", "flux"),
               ("flux_right", "flux"), ("flux_mouth", "flux"),
               ("E_L1", "flux"), ("flux_y0", "flux"),
               ("mu_eff_sim", "self"), ("total_mass", "area"),
               ("sulcus_mass", "area"))


def program_metrics(flux_list, mass_list, mueff_list):
    """The compared numbers of the program's metric dicts, by key: (B,)
    arrays."""
    def col(fm, mm, me):
        pf = fm["sulcus_specific"]["physical_flux"]
        return {"uptake": fm["uptake_flux"],
                "flux_left": fm["physical_flux"]["left"]["total"],
                "flux_right": fm["physical_flux"]["right"]["total"],
                "flux_mouth": pf["sulcus_opening"]["total"],
                "E_L1": pf["sulcus_opening_extra"]["E_L1"],
                "flux_y0": pf["y0_flux"]["total"],
                "mu_eff_sim": me["mu_eff_sim"],
                "total_mass": mm["total_mass"],
                "sulcus_mass": mm["sulcus_mass"]}
    cols = [col(*t) for t in zip(flux_list, mass_list, mueff_list)]
    return {k: np.array([c[k] for c in cols], dtype=np.float64)
            for k, _ in METRIC_KEYS}


def metrics_gap(prog, ref, area):
    """The widest gap between the program's numbers and the reference's,
    each as a share of its scale (``METRIC_KEYS``)."""
    flux = np.maximum.reduce([np.abs(ref["flux_left"]),
                              np.abs(ref["flux_right"]),
                              np.abs(ref["uptake"])])
    worst = 0.0
    for k, scale in METRIC_KEYS:
        s = {"flux": flux, "area": area, "self": np.abs(ref[k])}[scale]
        gap = np.abs(np.asarray(prog[k]) - ref[k]) / s
        worst = max(worst, float(np.max(gap)))
    return worst


class Geometry:
    """The reference of one sulcus geometry (nondimensional lengths)."""

    def __init__(self, L, H, w, d, h, refinement_factor=1):
        self.H = float(H)
        self.mesh = generate_mesh(L, H, d, w, h, refinement_factor,
                                  "sulcus")
        m = self.mesh
        self.fe = fe = P2Mesh(m.vertices, m.cells)
        self.n = fe.ndofs
        self.K = fe.stiffness()
        fs = m.boundary
        self._fs = fs
        bot = np.flatnonzero(m.bc_marker == BOTTOM)
        tb = facet_tables(fe, fs.cell[bot], fs.local_edge[bot])
        self.R = np.einsum("q,fqi,fqj,f->fij", tb["w"], tb["phi"],
                           tb["phi"], tb["length"])
        self.R_dofs = tb["dofs"]
        self.dir_ids, self.dir_vals = dirichlet(
            fe, fs.cell, fs.local_edge, m.bc_marker, {LEFT: 1.0, RIGHT: 0.0})
        self.free = np.ones(self.n, dtype=bool)
        self.free[self.dir_ids] = False
        self.area = float(np.abs(fe.detJ).sum() / 2)

        def sel(mask):
            i = np.flatnonzero(mask)
            return facet_tables(fe, fs.cell[i], fs.local_edge[i])
        iy = m.interior_y0
        self.sets = {"left": sel(m.bc_marker == LEFT),
                     "right": sel(m.bc_marker == RIGHT),
                     "bottom": sel(m.bc_marker == BOTTOM),
                     "y0_ext": sel(m.y0_marker == Y0),
                     "mouth": facet_tables(fe, iy.cell_plus,
                                           iy.local_edge_plus)}
        self._adv = None

    # -- mesh ---------------------------------------------------------------
    def mesh_gap(self, prog, dtype=torch.float64):
        """0 when the program's mesh equals the remade one in every
        vertex, cell, marker and mouth facet; else the largest vertex
        offset (vertices read in ``dtype``), or inf where the topology
        differs."""
        m = self.mesh
        same = all(np.array_equal(np.asarray(getattr(prog, k)),
                                  getattr(m, k))
                   for k in ("cells", "cell_domain", "bc_marker",
                             "bottom_marker", "y0_marker"))
        same = same and all(
            np.array_equal(np.asarray(getattr(prog.interior_y0, k)),
                           getattr(m.interior_y0, k))
            for k in ("edges", "cell_plus", "local_edge_plus"))
        pv = np.asarray(prog.vertices)
        if not same or pv.shape != m.vertices.shape:
            return float("inf")
        pv = torch.as_tensor(pv).to(dtype).double().numpy()
        return float(np.max(np.abs(pv - m.vertices)))

    # -- transport ------------------------------------------------------------
    def set_velocity(self, u):
        """The advection element matrices of the P2 velocity u (n, 2)."""
        self._adv = None if u is None else self.fe.advection(
            np.asarray(u, dtype=np.float64).reshape(-1, 2))

    def _operator(self, X, D, mu, dtype):
        """(A X) (n, B) for columns X (n, B)."""
        cd = self.fe.cell_dofs
        Y = apply(self.K, cd, cd, X, self.n,
                  torch.as_tensor(D, dtype=dtype))
        if self._adv is not None:
            Y = Y + apply(self._adv, cd, cd, X, self.n)
        return Y + apply(self.R, self.R_dofs, self.R_dofs, X, self.n,
                         torch.as_tensor(mu, dtype=dtype))

    def transport_residual(self, X, D, mu, dtype=torch.float64):
        """(B,) relative residuals of X (B, n) under D_b K + Adv + mu_b R:
        the free rows' residual with the Dirichlet rows' gap (scaled by
        the operator's diagonal there), over the free rows of A g, g the
        inlet / outlet values."""
        Xt = torch.as_tensor(np.asarray(X)).to(dtype).t().contiguous()
        B = Xt.shape[1]
        g = torch.zeros((self.n, B), dtype=dtype)
        g[torch.as_tensor(self.dir_ids)] = torch.as_tensor(
            self.dir_vals, dtype=dtype)[:, None]
        free = torch.as_tensor(self.free)
        r = self._operator(Xt, D, mu, dtype)[free]
        b = self._operator(g, D, mu, dtype)[free]
        diag = self._operator(torch.ones_like(g), D, mu, dtype).abs()
        ids = torch.as_tensor(self.dir_ids)
        rd = (Xt[ids] - g[ids]) * diag[ids]
        num = torch.sqrt((r * r).sum(0) + (rd * rd).sum(0))
        return (num / torch.sqrt((b * b).sum(0))).double().numpy()

    # -- metrics ------------------------------------------------------------
    def metrics(self, X, D, mu, u=None, dtype=torch.float64):
        """The compared numbers (``METRIC_KEYS``) of X (B, n): (B,)
        arrays."""
        X = torch.as_tensor(np.asarray(X)).to(dtype)
        D = torch.as_tensor(np.asarray(D, dtype=np.float64)).to(dtype)
        mu = torch.as_tensor(np.asarray(mu, dtype=np.float64)).to(dtype)
        u = None if u is None else np.asarray(u, np.float64).reshape(-1, 2)

        def t(a):
            return torch.as_tensor(a).to(dtype)

        def parts(name):
            s = self.sets[name]
            Xf = X[:, torch.as_tensor(s["dofs"])]            # (B, F, 6)
            c = torch.einsum("fqi,bfi->bfq", t(s["phi"]), Xf)
            gn = torch.einsum("fqia,bfi,fa->bfq", t(s["grad"]), Xf,
                              t(s["normal"]))
            q = -D[:, None, None] * gn
            if u is not None:
                uq = np.einsum("fqi,fia->fqa", s["phi"], u[s["dofs"]])
                q = q + t(np.einsum("fqa,fa->fq", uq, s["normal"]))[None] * c
            return c, q, t(s["w"]), t(s["length"])

        def integral(dens, w, length):
            return torch.einsum("q,bfq,f->b", w, dens, length)

        out = {}
        for name in ("left", "right"):
            c, q, w, ln = parts(name)
            out[f"flux_{name}"] = integral(q, w, ln)
        c, q, w, ln = parts("bottom")
        out["uptake"] = mu * integral(c, w, ln)
        c, q, w, ln = parts("mouth")
        out["flux_mouth"] = integral(q, w, ln)
        out["E_L1"] = integral(q.abs(), w, ln)
        c_mouth = integral(c, w, ln)
        c, q, w, ln = parts("y0_ext")
        out["flux_y0"] = integral(q, w, ln) + out["flux_mouth"]
        out["mu_eff_sim"] = out["flux_y0"] / (integral(c, w, ln) + c_mouth)
        per_cell = self.fe.cell_integral(X)
        out["total_mass"] = per_cell.sum(1)
        cav = torch.as_tensor(self.mesh.cell_domain == 1)
        out["sulcus_mass"] = per_cell[:, cav].sum(1)
        return {k: v.double().numpy() for k, v in out.items()}

    # -- Stokes -------------------------------------------------------------
    def stokes_residual(self, u, p, dtype=torch.float64):
        """Relative residual of the Taylor-Hood field (u (n, 2) P2 values
        interleaved, p (V,) P1): the momentum rows off the walls and the
        continuity rows, with the walls' gap (scaled by the diagonal of
        K), over the residual of the inflow lift alone."""
        fe, fs, m = self.fe, self._fs, self.mesh
        H = self.H
        ids, gx = dirichlet(fe, fs.cell, fs.local_edge, m.bc_marker,
                            {LEFT: lambda xy: 4.0 * xy[1] * (H - xy[1]),
                             TOP: 0.0, BOTTOM: 0.0})
        U = torch.as_tensor(np.asarray(u, np.float64).reshape(-1, 2)).to(
            dtype)
        P = torch.as_tensor(np.asarray(p, np.float64)).to(dtype)[:, None]
        G = torch.zeros_like(U)
        G[torch.as_tensor(ids), 0] = torch.as_tensor(gx).to(dtype)
        cd = fe.cell_dofs
        vd = np.stack([2 * cd, 2 * cd + 1], 2).reshape(len(cd), 12)
        Be = fe.divergence()
        nv = len(m.vertices)
        free = np.ones(fe.ndofs, dtype=bool)
        free[ids] = False
        free = torch.as_tensor(free)
        diag = apply(self.K, cd, cd, torch.ones((fe.ndofs, 1),
                                                 dtype=dtype), fe.ndofs)
        it = torch.as_tensor(ids)

        def res(U, P):
            ru = (apply(self.K, cd, cd, U, fe.ndofs)
                  + apply(np.swapaxes(Be, 1, 2), vd, m.cells, P,
                          2 * fe.ndofs).reshape(-1, 2))
            rp = apply(Be, m.cells, vd, U.reshape(-1, 1), nv)
            return ru[free], rp

        ru, rp = res(U, P)
        rd = (U[it] - G[it]) * diag[it]
        bu, bp = res(G, torch.zeros_like(P))
        num = (ru * ru).sum() + (rp * rp).sum() + (rd * rd).sum()
        den = (bu * bu).sum() + (bp * bp).sum()
        return float(torch.sqrt(num / den))
