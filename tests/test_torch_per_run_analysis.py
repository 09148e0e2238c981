"""The port's per-run analysis (``analysis/flux.py``, ``mass.py``,
``integrals.py``, ``mu_eff.py``, ``boundary_export.py``) against the JAX
package's on the CPU; the per-run half of ``tests/test_analysis.py``.

The sulcus case is the JAX test's: the 5 x 1 channel with a 0.5 x 1.0
cavity at h = 0.08, pure diffusion, D = mu = 1, P2; its concentration is
solved once by the JAX package and carried into the port (the meshes are
the same bit for bit), so the two analyses see the same c.  Tolerances:

* every flux, uptake, mass and mu_eff number of the port equals JAX's on
  the same c within 1e-12 relative (1e-15 absolute for values that vanish:
  the advective fluxes of pure diffusion), with a velocity and a callable
  mu too; the boundary-flux CSV equals JAX's (pandas-written) CSV column
  for column within 1e-12 relative, and the polyline VTK line for line;
* on the same c the per-run metrics equal the port's batched metrics
  (``analysis/batched_metrics.py``) within 1e-12, as
  ``test_batched_metrics_match_per_run`` holds JAX's;
* the port's own solve of the case gives metrics within 1e-9 of JAX's
  (both certified to 1e-13 relative residual);
* the reference's identities: conservation across y = 0 (2%), Robin
  consistency (2%), E_L1 >= |net|, the closed-form arc and enh estimators
  (1e-10, 1e-12), exact boundary fluxes of a linear solution (1e-10) and
  exact mass on the rectangle (1e-12).
"""

import csv

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.analysis.boundary_export import \
    export_boundary_flux_comparison
from fenics_eff_uptake_tpu_torch.analysis.flux import (
    compute_flux_metrics, compute_uptake_flux_bottom)
from fenics_eff_uptake_tpu_torch.analysis.mass import compute_mass_metrics
from fenics_eff_uptake_tpu_torch.analysis.mu_eff import (
    compute_mu_eff_metrics, sample_mu_along_bottom, sulcus_arc_length)
from fenics_eff_uptake_tpu_torch.fem.space import Function, FunctionSpace
from fenics_eff_uptake_tpu_torch.meshing.generator import (
    generate_mesh, structured_rectangle)
from fenics_eff_uptake_tpu_torch.models.diffusion import pure_diffusion_solve

torch.set_num_threads(2)

SULCUS = dict(width=5.0, height=1.0, sulcus_depth=1.0, sulcus_width=0.5,
              mesh_size=0.08, refinement_factor=1, domain_type="sulcus")


class P:
    L, H = 5.0, 1.0
    L_dim, H_dim = 5.0, 1.0
    sulci_h, sulci_w = 1.0, 0.5
    mu = 1.0
    mode = "no-adv"


def _step_mu(x):
    return np.where(np.abs(np.asarray(x) - 2.5) < 0.25, 2.0, 0.5)


@pytest.fixture(scope="module")
def case():
    """(JAX mesh, JAX c, port mesh, port c on the same values)."""
    pytest.importorskip("jax")
    from fenics_eff_uptake_tpu.meshing.generator import generate_mesh as jgm
    from fenics_eff_uptake_tpu.models.diffusion import \
        pure_diffusion_solve as jsolve
    jmd = jgm(**SULCUS)
    jc = jsolve(jmd, D=1.0, mu=1.0, element="P2")
    md = generate_mesh(**SULCUS)
    assert np.array_equal(md.vertices, jmd.vertices)
    assert np.array_equal(md.cells, jmd.cells)
    c = Function(FunctionSpace(md, "P2"),
                 torch.tensor(np.asarray(jc.values)))
    return jmd, jc, md, c


def _velocity(space_cls, md, to):
    V = space_cls(md, "P2", vs=2)
    xy = V.dof_coords
    uv = np.zeros(V.ndofs)
    uv[0::2] = xy[:, 1] * (1.0 - xy[:, 1]) + 0.1
    uv[1::2] = 0.05 * np.sin(xy[:, 0])
    return V, to(uv)


def _walk(a, b, rel, floor=1e-15, path=""):
    """Same key tree; every number within rel (or floor absolute)."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _walk(a[k], b[k], rel, floor, f"{path}/{k}")
        return
    if a is None or b is None:
        assert a is None and b is None, path
        return
    a, b = float(a), float(b)
    if np.isnan(b):
        assert np.isnan(a), path
        return
    assert abs(a - b) <= max(rel * abs(b), floor), (path, a, b)


def test_linear_solution_boundary_fluxes():
    """c = 1 - x/2 (mu = 0): the boundary fluxes are exact."""
    md = structured_rectangle(2.0, 1.0, 16, 8)
    c = pure_diffusion_solve(md, "cpu", D=1.0, mu=0.0, element="P2")
    fm = compute_flux_metrics(c, None, md, "rectangular", D=1.0, mu=0.0)
    pf = fm["physical_flux"]
    assert abs(pf["left"]["total"] + 0.5) < 1e-10
    assert abs(pf["right"]["total"] - 0.5) < 1e-10
    assert abs(pf["top"]["total"]) < 1e-12
    assert abs(pf["bottom"]["total"]) < 1e-12
    assert abs(fm["uptake_flux"]) < 1e-14


def test_rectangle_mass_metrics():
    md = structured_rectangle(2.0, 1.0, 8, 4)
    c = pure_diffusion_solve(md, "cpu", D=1.0, mu=0.0, element="P1")
    mm = compute_mass_metrics(c, md, "rectangular")
    assert abs(mm["total_area"] - 2.0) < 1e-12
    assert abs(mm["total_mass"] - 1.0) < 1e-12
    assert abs(mm["average_concentration"] - 0.5) < 1e-12


def test_sulcus_flux_identities_hold(case):
    _, _, md, c = case
    vals = c.as_numpy()
    assert vals.min() > -1e-10 and vals.max() < 1.0 + 1e-10
    fm = compute_flux_metrics(c, None, md, "sulcus", D=1.0, mu=1.0,
                              warn=False)
    sf = fm["sulcus_specific"]["physical_flux"]
    y0 = sf["y0_flux"]["total"]
    bot4 = fm["physical_flux"]["bottom"]["total"]
    assert abs(y0 - bot4) < 0.02 * abs(bot4) + 1e-6, (y0, bot4)
    assert sf["_y0_identity_gap"] < 0.05 * abs(y0)
    uptake = fm["uptake_flux"]
    assert abs(bot4 - uptake) < 0.02 * abs(uptake) + 1e-6
    extra = sf["sulcus_opening_extra"]
    net = sf["sulcus_opening"]["total"]
    assert extra["E_L1"] >= abs(net) - 1e-12
    assert abs(extra["net_check"] - net) < 1e-9
    assert abs(extra["length"] - 0.5) < 1e-9
    assert sf["y0_flux"]["advective"] == 0.0


@pytest.mark.parametrize("with_u,mu", [(False, 1.0), (True, 1.0),
                                       (True, "step")])
def test_flux_and_mass_metrics_match_jax(case, with_u, mu):
    import jax.numpy as jnp
    from fenics_eff_uptake_tpu.analysis.flux import \
        compute_flux_metrics as jflux
    from fenics_eff_uptake_tpu.analysis.mass import \
        compute_mass_metrics as jmass
    from fenics_eff_uptake_tpu.fem.space import Function as JF
    from fenics_eff_uptake_tpu.fem.space import FunctionSpace as JFS
    jmd, jc, md, c = case
    mu = _step_mu if mu == "step" else mu
    u = ju = None
    if with_u:
        V, uv = _velocity(FunctionSpace, md, np.asarray)
        u = Function(V, uv)
        jV, juv = _velocity(JFS, jmd, jnp.asarray)
        ju = JF(jV, juv)
    got = compute_flux_metrics(c, u, md, "sulcus", 0.7, mu, warn=False)
    want = jflux(jc, ju, jmd, "sulcus", 0.7, mu, warn=False)
    _walk(got, want, 1e-12)
    _walk(compute_mass_metrics(c, md, "sulcus"),
          jmass(jc, jmd, "sulcus"), 1e-12)
    assert compute_uptake_flux_bottom(c, md, mu) == pytest.approx(
        want["uptake_flux"], rel=1e-12)


def test_mu_eff_engine_matches_jax(case):
    from fenics_eff_uptake_tpu.analysis.flux import \
        compute_flux_metrics as jflux
    from fenics_eff_uptake_tpu.analysis.mu_eff import \
        compute_mu_eff_metrics as jmueff
    jmd, jc, md, c = case
    fm = compute_flux_metrics(c, None, md, "sulcus", D=1.0, mu=1.0,
                              warn=False)
    me = compute_mu_eff_metrics(c, md, P, fm)
    jfm = jflux(jc, None, jmd, "sulcus", D=1.0, mu=1.0, warn=False)
    _walk(me, jmueff(jc, jmd, P, jfm), 1e-12)
    # the closed forms and the audit, as the JAX test checks them
    from scipy.integrate import quad
    w, h = 0.5, 1.0
    integral, _ = quad(lambda s: np.sqrt(1 + (np.pi * h / w
                                              * np.cos(np.pi * s)) ** 2),
                       0, 1, epsabs=1e-12, epsrel=1e-12, limit=200)
    assert abs(sulcus_arc_length(w, h) - w * integral) < 1e-10
    assert abs(me["mu_eff_arc"] - (1 + (w * integral - w) / 5.0)) < 1e-10
    assert abs(me["mu_eff_enh"] - ((5 - 0.5) / 5 + (0.5 / 5)
                                   / np.sqrt(1 + 10 * 1 * 1 / 0.5))) < 1e-12
    assert 0.1 < me["mu_eff_sim"] < 10 and me["mu_eff_open"] > 0
    assert me["ratios"]["sim"] == pytest.approx(me["mu_eff_sim"], rel=1e-12)
    assert me["audit"]["lengths"]["L_mouth"] == pytest.approx(0.5, abs=1e-9)


def test_per_run_metrics_equal_batched(case):
    """On the same c (and c / 2), the per-run metrics equal the port's
    batched metrics within 1e-12."""
    from fenics_eff_uptake_tpu_torch.analysis.batched_metrics import (
        build_sweep_metrics, metrics_to_dicts)
    _, _, md, c = case
    sm = build_sweep_metrics(c.space, md, 1.0, "cpu")
    X = torch.stack([c.values, c.values * 0.5])
    flux_l, mass_l, mueff_l = metrics_to_dicts(sm, md, X, [1.0, 2.0],
                                               [P, P])
    for b, (cv, mu) in enumerate(((c.values, 1.0), (c.values * 0.5, 2.0))):
        cb = Function(c.space, cv)
        fm = compute_flux_metrics(cb, None, md, "sulcus", 1.0, mu,
                                  warn=False)
        _walk(flux_l[b], fm, 1e-12)
        _walk(mass_l[b], compute_mass_metrics(cb, md, "sulcus"), 1e-12)
        if b == 0:
            _walk(mueff_l[b], compute_mu_eff_metrics(cb, md, P, fm), 1e-12)


def test_port_solve_matches_jax_metrics(case):
    """The port's own solve of the case (the batched engine at B = 1)
    against JAX's: every metric within 1e-9."""
    from fenics_eff_uptake_tpu.analysis.flux import \
        compute_flux_metrics as jflux
    from fenics_eff_uptake_tpu.analysis.mass import \
        compute_mass_metrics as jmass
    jmd, jc, md, _ = case
    c = pure_diffusion_solve(md, "cpu", D=1.0, mu=1.0)
    assert c.solver_info["converged"]
    assert c.solver_info["rel_resnorm"] <= 1e-13
    _walk(compute_flux_metrics(c, None, md, "sulcus", 1.0, 1.0, warn=False),
          jflux(jc, None, jmd, "sulcus", 1.0, 1.0, warn=False), 1e-9, 1e-12)
    _walk(compute_mass_metrics(c, md, "sulcus"), jmass(jc, jmd, "sulcus"),
          1e-9)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("mu", [1.0, "step"])
def test_boundary_flux_export_matches_jax(case, tmp_path, mu):
    from fenics_eff_uptake_tpu.analysis.boundary_export import \
        export_boundary_flux_comparison as jexport
    jmd, jc, md, c = case
    mu = _step_mu if mu == "step" else mu
    out = export_boundary_flux_comparison(c, mu, 1.0, md,
                                          str(tmp_path / "port"))
    jout = jexport(jc, mu, 1.0, jmd, str(tmp_path / "jax"))
    for k in ("x", "physical", "robin"):
        assert np.allclose(out[k], jout[k], rtol=1e-12, atol=0)
    rows = _read(tmp_path / "port" / "boundary_flux_comparison.csv")
    jrows = _read(tmp_path / "jax" / "boundary_flux_comparison.csv")
    assert len(rows) == len(jrows) > 0
    assert list(rows[0]) == list(jrows[0])
    got = np.array([[float(v) for v in r.values()] for r in rows])
    want = np.array([[float(v) for v in r.values()] for r in jrows])
    assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want))
    vtk = (tmp_path / "port" / "flux_bottom.vtk").read_text().splitlines()
    jvtk = (tmp_path / "jax" / "flux_bottom.vtk").read_text().splitlines()
    assert len(vtk) == len(jvtk)
    for a, b in zip(vtk, jvtk):
        if a == b:
            continue
        fa, fb = np.array(a.split(), float), np.array(b.split(), float)
        assert np.all(np.abs(fa - fb) <= 1e-12 * np.abs(fb)), (a, b)
    if mu == 1.0:
        rel = abs(out["physical"].sum() - out["robin"].sum()) / abs(
            out["robin"].sum())
        assert rel < 0.05


def test_sample_mu_along_bottom_matches_jax(case, tmp_path):
    from fenics_eff_uptake_tpu.analysis.mu_eff import \
        sample_mu_along_bottom as jsample
    jmd, _, md, _ = case

    class Q(P):
        mu = staticmethod(_step_mu)

    for params in (P, Q):
        got = sample_mu_along_bottom(params, md, 301,
                                     save_csv_path=str(tmp_path / "mu.csv"))
        want = jsample(params, jmd, 301,
                       save_csv_path=str(tmp_path / "jmu.csv"))
        assert np.array_equal(got["x"], want["x"])
        assert np.array_equal(got["mu"], want["mu"])
        for k in ("mu_mean", "mu_min", "mu_max"):
            assert got[k] == pytest.approx(want[k], rel=1e-14), k
        a = np.array([[float(v) for v in r.values()]
                      for r in _read(tmp_path / "mu.csv")])
        b = np.array([[float(v) for v in r.values()]
                      for r in _read(tmp_path / "jmu.csv")])
        assert np.array_equal(a, b)
