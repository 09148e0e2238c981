"""The port's per-run API (``simulation.run_simulation``,
``models/diffusion.py``, ``models/advdiff.py``) and its Stokes options
(Schur fallback, outlet pin, f64 MINRES): the checks of
``tests/test_simulation.py``, and the same runs through the JAX package on
the CPU.

Tolerances:

* ``run_simulation`` in each mode on the JAX test's coarse case (5 x 1
  channel, 0.5 x 0.5 sulcus, h = 0.15; Pe = 1 where there is flow) in both
  packages: the flux, mass, mu_eff and velocity metric dicts agree within
  1e-9 relative, or 1e-12 absolute for values below 1e-3; the
  ``simulation_results.json`` key trees are equal.  Both Stokes solves run
  at outer rtol 1e-12 there (the JAX package's is wrapped to take it), so
  that the two velocities agree far below the transport's tolerance.
* Poiseuille flow is exact in Taylor-Hood: u within 1e-9, p within 1e-8.
* The Schur fallback against MINRES + MG: u within 1e-8, p within 1e-6;
  the outlet pin moves p by < 1e-5 of max |p| and u by < 1e-5; f64 MINRES
  against mixed MINRES (both rtol 1e-11): u within 1e-8, p within 1e-6 of
  max |p|; each option against the JAX package's, the same bounds.
* GMRES (``solver="auto"`` at Pe = 40) against BiCGStab: 1e-8; against the
  JAX package's GMRES on the same velocity: iterations within 2, c within
  1e-8 (the system's condition leaves ~1e-8 between two solutions of
  relative residual 1e-13).
* Zero velocity: advection-diffusion equals diffusion within 1e-9.
* On the card (marker ``cuda``): ``run_simulation`` on the card against
  the CPU port, every metric within 1e-9 relative (1e-12 absolute below
  1e-3); the mixed Schur fallback against MINRES + MG (the bounds above).

The JAX side is imported inside fixtures, so the file also runs where jax
is absent: ``python -m pytest tests/test_torch_simulation.py -m cuda
--noconftest`` on the GPU machine.
"""

import functools
import json

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.meshing.generator import (
    generate_mesh, structured_rectangle)
from fenics_eff_uptake_tpu_torch.models.advdiff import advdiff_solve
from fenics_eff_uptake_tpu_torch.models.diffusion import pure_diffusion_solve
from fenics_eff_uptake_tpu_torch.models.stokes_flow import (
    stokes_solve, stokes_solve_mg, stokes_solve_schur, stokes_zero_fields)
from fenics_eff_uptake_tpu_torch.params import Parameters
from fenics_eff_uptake_tpu_torch.simulation import run_simulation

torch.set_num_threads(2)

STOKES_SULCUS = dict(width=5.0, height=1.0, sulcus_depth=0.3,
                     sulcus_width=0.3, mesh_size=0.15, refinement_factor=1,
                     domain_type="sulcus")
# the flow modes at Pe = 1, as the JAX test runs adv-diff
MODES = [("no-adv", "sulcus", {}),
         ("adv-diff", "sulcus", {"U_ref_dim": 0.0003}),
         ("no-uptake", "sulcus", {"U_ref_dim": 0.0003})]
TIGHT_STOKES = 1e-12


def _coarse_params(mode, cls=Parameters, **kw):
    p = cls(mode=mode, L_dim=5.0, H_dim=1.0, sulci_w_dim=0.5,
            sulci_h_dim=0.5, mesh_size_dim=0.15, **kw)
    p.validate()
    p.nondim()
    return p


def _walk(a, b, path=""):
    """Same key tree; numbers within 1e-9 relative, or 1e-12 absolute
    where the reference value is below 1e-3."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _walk(a[k], b[k], f"{path}/{k}")
        return
    if a is None or b is None:
        assert a is None and b is None, path
        return
    a, b = float(a), float(b)
    if np.isnan(b):
        assert np.isnan(a), path
        return
    tol = 1e-9 * abs(b) if abs(b) >= 1e-3 else 1e-12
    assert abs(a - b) <= tol, (path, a, b)


def _keys(d):
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_keys(v) for v in d]
    return None


@pytest.fixture(scope="module")
def sulcus_mesh():
    return generate_mesh(**STOKES_SULCUS)


# ---------------------------------------------------------------------------
# the checks of tests/test_simulation.py, on the port
# ---------------------------------------------------------------------------

def test_stokes_poiseuille_is_exact():
    md = structured_rectangle(2.0, 1.0, 10, 5)
    u, p = stokes_solve(md, 1.0, "cpu", rtol=1e-12)
    assert u.solver_info["converged"]
    coords = u.space.dof_coords
    ux, uy = u.as_numpy()[0::2], u.as_numpy()[1::2]
    assert np.abs(ux - 4 * coords[:, 1] * (1 - coords[:, 1])).max() < 1e-9
    assert np.abs(uy).max() < 1e-9
    p_exact = 8 * (2.0 - p.space.dof_coords[:, 0])
    assert np.abs(p.as_numpy() - p_exact).max() < 1e-8


def test_advdiff_with_zero_velocity_equals_diffusion():
    md = structured_rectangle(2.0, 1.0, 8, 4)
    u0, p0 = stokes_zero_fields(md)
    assert not np.any(u0.values) and not np.any(p0.values)
    c_ad = advdiff_solve(md, u0, "cpu", D=0.5, mu=1.0)
    c_d = pure_diffusion_solve(md, "cpu", D=0.5, mu=1.0)
    assert np.abs(c_ad.as_numpy() - c_d.as_numpy()).max() < 1e-9


def test_run_simulation_no_adv_sulcus_layout(tmp_path):
    res = run_simulation("no-adv", "Test", "sulcus_test", "sulcus",
                         _coarse_params("no-adv"), device="cpu",
                         results_root=str(tmp_path), verbose=False)
    me = res["mu_eff_comparison"]
    assert me["mu_eff_sim"] is not None
    assert 0 < res["mass_metrics"]["average_concentration"]["total"] < 1
    assert res["c"].solver_info["converged"]
    assert set(res["timings"]) == {"mesh", "stokes", "transport", "metrics",
                                   "mu_eff", "mesh_io"}
    base = tmp_path / "No Advection Simulations" / "Test" / "sulcus_test"
    data = json.loads((base / "Results Data"
                       / "simulation_results.json").read_text())
    assert "flux_metrics" in data and "mu_eff_comparison" in data
    assert "_y0_identity_gap" not in \
        data["flux_metrics"]["sulcus_specific"]["physical_flux"]
    for name in ("sulcus_mesh.msh", "sulcus_mesh.npz"):
        assert (base / "Mesh Files" / name).exists()
    for d in ("ParaView Files", "Analysis Plots"):
        assert (base / d).is_dir()


def test_run_simulation_advdiff_rect_conserves(tmp_path):
    params = _coarse_params("adv-diff", U_ref_dim=0.0003)
    assert params.Pe == pytest.approx(1.0)
    res = run_simulation("adv-diff", "Test", "rect_test", "rectangular",
                         params, device="cpu", results_root=str(tmp_path),
                         verbose=False)
    assert "mu_eff_comparison" not in res
    pf = res["flux_metrics"]["physical_flux"]
    assert pf["left"]["advective"] != 0.0
    assert abs(pf["right"]["advective"]) < 1e-12
    assert res["vel_metrics"].get("global_max_umag", 0) > 0
    total = sum(pf[k]["total"] for k in ("left", "right", "top", "bottom"))
    scale = max(abs(pf[k]["total"]) for k in ("left", "right", "bottom"))
    assert abs(total) < 0.05 * scale


def test_run_simulation_refuses_bad_mode_and_missing_card(tmp_path):
    p = _coarse_params("no-adv")
    with pytest.raises(ValueError, match="Invalid mode"):
        run_simulation("diffusion", "T", "c", "sulcus", p, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_simulation("no-adv", "T", "c", "sulcus", p,
                           results_root=str(tmp_path))


def test_stokes_schur_matches_mg(sulcus_mesh):
    u1, p1 = stokes_solve_mg(sulcus_mesh, 1.0, "cpu", rtol=1e-11)
    u0, p0 = stokes_solve_schur(sulcus_mesh, 1.0, "cpu", precision="f64")
    assert u0.solver_info["converged"] and u0.solver_info["method"] == \
        "schur"
    assert np.abs(u1.values - u0.values).max() < 1e-8
    assert np.abs(p1.values - p0.values).max() < 1e-6


def test_stokes_outlet_pin_is_inconsequential(sulcus_mesh):
    u1, p1 = stokes_solve_mg(sulcus_mesh, 1.0, "cpu", rtol=1e-11)
    u2, p2 = stokes_solve_mg(sulcus_mesh, 1.0, "cpu", rtol=1e-11,
                             pin_outlet_pressure=True)
    p_scale = np.abs(p1.values).max()
    assert np.abs(p1.values - p2.values).max() / p_scale < 1e-5
    assert np.abs(u1.values - u2.values).max() < 1e-5
    pc = p1.space.dof_coords
    corner = int(np.argmin((pc[:, 0] - pc[:, 0].max()) ** 2 + pc[:, 1] ** 2))
    assert abs(float(p1.values[corner])) / p_scale < 1e-5
    assert p2.values[corner] == 0.0


def test_stokes_f64_matches_mixed(sulcus_mesh):
    u1, p1 = stokes_solve_mg(sulcus_mesh, 1.0, "cpu", rtol=1e-11)
    u2, p2 = stokes_solve_mg(sulcus_mesh, 1.0, "cpu", rtol=1e-11,
                             precision="f64")
    assert u2.solver_info["converged"] and u2.solver_info["passes"] == 1
    assert np.abs(u1.values - u2.values).max() < 1e-8
    assert np.abs(p1.values - p2.values).max() < \
        1e-6 * np.abs(p1.values).max()


def test_stokes_solve_caches_each_method(sulcus_mesh, tmp_path,
                                         monkeypatch):
    """stokes_solve(method=...) keys the Schur method and its options apart
    from MINRES + MG; a hit returns the stored field."""
    from fenics_eff_uptake_tpu_torch.utils import diskcache
    monkeypatch.setenv("FEU_CACHE_DIR", str(tmp_path))
    diskcache.clear_memos()
    um, _ = stokes_solve(sulcus_mesh, 1.0, "cpu")
    us, _ = stokes_solve(sulcus_mesh, 1.0, "cpu", method="schur",
                         precision="f64")
    assert us.solver_info["method"] == "schur"
    assert len(list(tmp_path.glob("port-stokes-*.npz"))) == 2
    us2, _ = stokes_solve(sulcus_mesh, 1.0, "cpu", method="schur",
                          precision="f64")
    assert us2.solver_info["method"] == "schur+cache"
    assert np.array_equal(us2.values, us.values)
    with pytest.raises(TypeError, match="no cycle"):
        stokes_solve(sulcus_mesh, 1.0, "cpu", method="schur", n_smooth=2)
    with pytest.raises(ValueError, match="method"):
        stokes_solve(sulcus_mesh, 1.0, "cpu", method="uzawa")


def _poiseuille(md, cls_space, to):
    V = cls_space(md, "P2", vs=2)
    uv = np.zeros(V.ndofs)
    uv[0::2] = 4.0 * V.dof_coords[:, 1] * (1.0 - V.dof_coords[:, 1])
    return V, to(uv)


def test_gmres_matches_bicgstab_at_high_pe():
    md = structured_rectangle(2.0, 1.0, 16, 8)
    u, _ = stokes_solve(md, 1.0, "cpu")
    c_g = advdiff_solve(md, u, "cpu", D=1.0 / 40.0, mu=1.0, solver="auto")
    assert c_g.solver_info["method"] == "gmres"
    assert c_g.solver_info["converged"]
    c_b = advdiff_solve(md, u, "cpu", D=1.0 / 40.0, mu=1.0, solver=None)
    assert "method" not in c_b.solver_info
    assert np.abs(c_g.as_numpy() - c_b.as_numpy()).max() < 1e-8


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jsim():
    pytest.importorskip("jax")
    import fenics_eff_uptake_tpu.simulation as jsim
    return jsim


@pytest.mark.parametrize("mode,domain,kw", MODES,
                         ids=[m for m, _, _ in MODES])
def test_run_simulation_matches_jax(jsim, tmp_path, monkeypatch, mode,
                                    domain, kw):
    from fenics_eff_uptake_tpu.params import Parameters as JParameters
    monkeypatch.setattr(jsim, "stokes_solve", functools.partial(
        jsim.stokes_solve, outer_rtol=TIGHT_STOKES))
    want = jsim.run_simulation(mode, "T", "c", domain,
                               _coarse_params(mode, JParameters, **kw),
                               results_root=str(tmp_path / "jax"),
                               verbose=False)
    got = run_simulation(mode, "T", "c", domain, _coarse_params(mode, **kw),
                         device="cpu", results_root=str(tmp_path / "port"),
                         verbose=False,
                         stokes_options={"rtol": TIGHT_STOKES})
    assert got["c"].solver_info["converged"]
    for k in ("flux_metrics", "mass_metrics", "vel_metrics",
              "mu_eff_comparison"):
        _walk(got[k], want[k], k)
    if mode != "no-adv":
        assert np.abs(got["u"].values - np.asarray(want["u"].values)).max() \
            < 1e-10
    rel = "Results Data/simulation_results.json"
    name = jsim.MODE_NAME[mode] + " Simulations/T/c/"
    jj = json.loads((tmp_path / "jax" / (name + rel)).read_text())
    pj = json.loads((tmp_path / "port" / (name + rel)).read_text())
    assert _keys(pj) == _keys(jj)


def test_stokes_options_match_jax(sulcus_mesh):
    """f64 MINRES and the pinned solve against the JAX package's (its
    CPU default is the f64 branch)."""
    pytest.importorskip("jax")
    from fenics_eff_uptake_tpu.meshing.generator import generate_mesh as jgm
    from fenics_eff_uptake_tpu.models.stokes_flow import \
        stokes_solve_mg as jmg
    jmesh = jgm(**STOKES_SULCUS)
    for pin in (False, True):
        uj, pj = jmg(jmesh, H=1.0, rtol=1e-11, precision="f64",
                     pin_outlet_pressure=pin)
        ut, pt = stokes_solve_mg(sulcus_mesh, 1.0, "cpu", rtol=1e-11,
                                 precision="f64", pin_outlet_pressure=pin)
        assert np.abs(ut.values - np.asarray(uj.values)).max() < 1e-8, pin
        pjn = np.asarray(pj.values)
        assert np.abs(pt.values - pjn).max() < 1e-6 * np.abs(pjn).max(), pin


def test_gmres_matches_jax():
    """The port's GMRES and the JAX package's on the same velocity (the
    Poiseuille field) and rectangle: the same method, iterations within 2,
    c within 1e-8."""
    pytest.importorskip("jax")
    from fenics_eff_uptake_tpu.fem.space import Function as JF
    from fenics_eff_uptake_tpu.fem.space import FunctionSpace as JFS
    from fenics_eff_uptake_tpu.meshing.generator import \
        structured_rectangle as jrect
    from fenics_eff_uptake_tpu.models.advdiff import \
        advdiff_solve as jadvdiff
    from fenics_eff_uptake_tpu_torch.fem.space import Function, FunctionSpace
    jmd = jrect(2.0, 1.0, 16, 8)
    md = structured_rectangle(2.0, 1.0, 16, 8)
    import jax.numpy as jnp
    jV, juv = _poiseuille(jmd, JFS, jnp.asarray)
    V, uv = _poiseuille(md, FunctionSpace, np.asarray)
    for mu in (1.0, lambda x: 1.0 + 0.5 * np.sin(3.0 * np.asarray(x))):
        cj = jadvdiff(jmd, JF(jV, juv), D=1.0 / 40.0, mu=mu, solver="auto")
        ct = advdiff_solve(md, Function(V, uv), "cpu", D=1.0 / 40.0, mu=mu,
                           solver="auto")
        assert cj.solver_info["method"] == ct.solver_info["method"] == \
            "gmres"
        assert abs(ct.solver_info["iters"] - cj.solver_info["iters"]) <= 2
        assert np.abs(ct.as_numpy() - np.asarray(cj.values)).max() < 1e-8


@pytest.mark.slow
def test_stokes_schur_matches_jax(sulcus_mesh):
    """The Schur fallback in both precisions against the JAX package's
    (f64: its CPU default; mixed: its TPU one)."""
    pytest.importorskip("jax")
    from fenics_eff_uptake_tpu.meshing.generator import generate_mesh as jgm
    from fenics_eff_uptake_tpu.models.stokes_flow import \
        stokes_solve_schur as jschur
    jmesh = jgm(**STOKES_SULCUS)
    for precision in ("f64", "mixed"):
        uj, pj = jschur(jmesh, H=1.0, precision=precision)
        ut, pt = stokes_solve_schur(sulcus_mesh, 1.0, "cpu",
                                    precision=precision)
        assert ut.solver_info["converged"]
        assert ut.solver_info["outer_iters"] == uj.solver_info["outer_iters"]
        assert np.abs(ut.values - np.asarray(uj.values)).max() < 1e-8
        assert np.abs(pt.values - np.asarray(pj.values)).max() < 1e-6


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_stokes_schur_mixed_on_card_matches_mg(sulcus_mesh):
    """The Schur fallback in its default (mixed) precision on the card:
    f32 inner CG passes through kernel C (nd 6, two columns) in f64
    refinement, against MINRES + MG on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    u1, p1 = stokes_solve_mg(sulcus_mesh, 1.0, "cuda", rtol=1e-11)
    u0, p0 = stokes_solve_schur(sulcus_mesh, 1.0, "cuda")
    assert u0.solver_info["converged"]
    assert np.abs(u1.values - u0.values).max() < 1e-8
    assert np.abs(p1.values - p0.values).max() < 1e-6

@pytest.mark.cuda
@pytest.mark.parametrize("mode,domain,kw", MODES + [
    ("adv-diff", "rectangular", {"U_ref_dim": 0.0003})])
def test_run_simulation_on_card_matches_cpu(tmp_path, mode, domain, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = [run_simulation(mode, "T", dev, domain, _coarse_params(mode, **kw),
                           device=dev, results_root=str(tmp_path),
                           verbose=False,
                           stokes_options={"rtol": TIGHT_STOKES})
            for dev in ("cuda", "cpu")]
    assert isinstance(runs[0]["c"].values, torch.Tensor)
    assert runs[0]["c"].values.device.type == "cuda"
    assert runs[0]["c"].solver_info["converged"]
    for k in ("flux_metrics", "mass_metrics", "vel_metrics"):
        _walk(runs[0][k], runs[1][k], k)
    if domain == "sulcus":
        _walk(runs[0]["mu_eff_comparison"], runs[1]["mu_eff_comparison"])


def test_msh2_round_trip_matches_jax(tmp_path, sulcus_mesh):
    """The .msh files run_simulation writes: the port's writer gives the
    JAX package's bytes, and the port's reader (the mesh kernel's parser)
    reads back JAX's parse of them, with the markers rebuilt alike."""
    pytest.importorskip("jax")
    from fenics_eff_uptake_tpu.meshing import msh_io as jio
    from fenics_eff_uptake_tpu_torch.meshing import msh_io as tio
    md = sulcus_mesh
    tio.write_msh2(str(tmp_path / "t.msh"), md.vertices, md.cells)
    jio.write_msh2(str(tmp_path / "j.msh"), md.vertices, md.cells)
    assert (tmp_path / "t.msh").read_bytes() == \
        (tmp_path / "j.msh").read_bytes()
    got, want = tio.read_msh2(str(tmp_path / "t.msh")), \
        jio.read_msh2(str(tmp_path / "j.msh"))
    for k in ("vertices", "triangles", "triangle_tags", "lines",
              "line_tags"):
        assert np.array_equal(got[k], want[k]), k
    assert got["version"] == want["version"] == "2.2"
    assert np.abs(got["vertices"] - md.vertices).max() < 1e-15
    m2 = tio.mesh_from_msh2(str(tmp_path / "t.msh"), md.geom, "sulcus")
    j2 = jio.mesh_from_msh2(str(tmp_path / "j.msh"), md.geom, "sulcus")
    for k in ("bc_marker", "bottom_marker", "y0_marker", "cell_domain"):
        assert np.array_equal(getattr(m2, k), getattr(j2, k)), k
    (tmp_path / "bad.msh").write_text("$MeshFormat\n4.1 0 8\n"
                                      "$EndMeshFormat\n")
    with pytest.raises(ValueError, match="MSH 2"):
        tio.read_msh2(str(tmp_path / "bad.msh"))
