"""The port's ParaView export (``utils/vtk.py``,
``meshing/visualization.py``, ``run_simulation(save_paraview=True)``)
against the JAX package's, on the CPU.

* Each writer, given the same mesh and the same values (the JAX
  ``Function``'s carried into a port ``Function``), writes the JAX file
  byte for byte; so does ``save_mesh_visualization``, ``normals/``
  included.
* ``run_simulation(..., save_paraview=True)`` in the no-adv and no-uptake
  modes on the coarse case of ``tests/test_torch_simulation.py`` writes
  the JAX file list; the mesh files are byte-equal, and every field value
  is within 1e-9 of the field's max |value| of JAX's (the relative bound
  that file holds the per-run metrics to; both Stokes solves at outer rtol
  1e-12, as there).
"""

import functools
import os

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu.fem.space import FunctionSpace as JSpace
from fenics_eff_uptake_tpu.meshing.generator import generate_mesh as jgm
from fenics_eff_uptake_tpu.meshing.visualization import \
    save_mesh_visualization as j_save_mesh
from fenics_eff_uptake_tpu.models.diffusion import \
    pure_diffusion_solve as j_diffusion
from fenics_eff_uptake_tpu.utils import vtk as jvtk
from fenics_eff_uptake_tpu_torch.convert import mesh_from
from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace, Function
from fenics_eff_uptake_tpu_torch.meshing.visualization import \
    save_mesh_visualization
from fenics_eff_uptake_tpu_torch.params import Parameters
from fenics_eff_uptake_tpu_torch.simulation import run_simulation
from fenics_eff_uptake_tpu_torch.utils import vtk as tvtk

torch.set_num_threads(2)

KW = dict(width=5.0, height=1.0, sulcus_depth=0.5, sulcus_width=0.5,
          mesh_size=0.2, refinement_factor=1)
TIGHT_STOKES = 1e-12


@pytest.fixture(scope="module")
def meshes():
    return {d: jgm(domain_type=d, **KW) for d in ("sulcus", "rectangular")}


@pytest.fixture(scope="module")
def jc(meshes):
    return j_diffusion(meshes["sulcus"], D=1.0, mu=1.0)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _writers(jm, pm, jc):
    """(name, JAX call, port call) per writer: the concentration as
    computed by JAX, a P1 scalar and a P2 vector of seeded values."""
    rng = np.random.default_rng(0)
    c = Function(FunctionSpace(pm, "P2"), np.asarray(jc.values))
    s1 = rng.standard_normal(JSpace(jm, "P1").ndofs)
    v2 = rng.standard_normal(JSpace(jm, "P2", vs=2).ndofs)
    jf = {"p1": JSpace(jm, "P1").new_function(s1),
          "v2": JSpace(jm, "P2", vs=2).new_function(v2)}
    tf = {"p1": Function(FunctionSpace(pm, "P1"), torch.as_tensor(s1)),
          "v2": Function(FunctionSpace(pm, "P2", vs=2), v2)}
    return {
        "mesh": (lambda p: jvtk.write_vtk_mesh(p, jm, {
                     "domain": jm.cell_domain}, title="t"),
                 lambda p: tvtk.write_vtk_mesh(p, pm, {
                     "domain": pm.cell_domain}, title="t")),
        "cell_scalar": (lambda p: jvtk.write_vtk_cell_scalar(
                            p, jm, jm.cell_domain * 0.5, name="d"),
                        lambda p: tvtk.write_vtk_cell_scalar(
                            p, pm, pm.cell_domain * 0.5, name="d")),
        "point_scalar_p2": (lambda p: jvtk.write_vtk_point_scalar(p, jc),
                            lambda p: tvtk.write_vtk_point_scalar(p, c)),
        "point_scalar_p1": (
            lambda p: jvtk.write_vtk_point_scalar(p, jf["p1"], name="s"),
            lambda p: tvtk.write_vtk_point_scalar(p, tf["p1"], name="s")),
        "point_vector": (
            lambda p: jvtk.write_vtk_point_vector(p, jf["v2"]),
            lambda p: tvtk.write_vtk_point_vector(p, tf["v2"])),
    }


@pytest.mark.parametrize("writer", ["mesh", "cell_scalar", "point_scalar_p2",
                                    "point_scalar_p1", "point_vector"])
def test_writer_matches_jax_bytes(meshes, jc, tmp_path, writer):
    jm = meshes["sulcus"]
    jw, tw = _writers(jm, mesh_from(jm), jc)[writer]
    jw(str(tmp_path / "j" / "f.vtk"))
    tw(str(tmp_path / "t" / "f.vtk"))
    assert _same_bytes(tmp_path / "j" / "f.vtk", tmp_path / "t" / "f.vtk")


@pytest.mark.parametrize("domain", ["sulcus", "rectangular"])
def test_mesh_visualization_matches_jax_bytes(meshes, tmp_path, domain):
    jm = meshes[domain]
    j_save_mesh(jm, str(tmp_path / "j"))
    save_mesh_visualization(mesh_from(jm), str(tmp_path / "t"))
    files = _files(tmp_path / "j")
    assert files == _files(tmp_path / "t")
    assert any(f.startswith("normals" + os.sep) for f in files)
    for f in files:
        assert _same_bytes(tmp_path / "j" / f, tmp_path / "t" / f), f


def _coarse_params(mode, cls, **kw):
    p = cls(mode=mode, L_dim=5.0, H_dim=1.0, sulci_w_dim=0.5,
            sulci_h_dim=0.5, mesh_size_dim=0.15, **kw)
    p.validate()
    p.nondim()
    return p


def _vtk_values(path):
    """The POINT_DATA or CELL_DATA values of a legacy-VTK file, and the
    text before them."""
    text = open(path).read()
    i = max(text.find("POINT_DATA"), text.find("CELL_DATA"))
    head, data = text[:i], text[i:].splitlines()
    start = next(k for k, line in enumerate(data)
                 if line.startswith(("LOOKUP_TABLE", "VECTORS"))) + 1
    return head, np.array([[float(x) for x in line.split()]
                           for line in data[start:]])


@pytest.mark.parametrize("mode,kw", [("no-adv", {}),
                                     ("no-uptake", {"U_ref_dim": 0.0003})],
                         ids=["no-adv", "no-uptake"])
def test_run_simulation_paraview_matches_jax(tmp_path, monkeypatch, mode,
                                             kw):
    from fenics_eff_uptake_tpu import simulation as jsim
    from fenics_eff_uptake_tpu.params import Parameters as JParameters
    monkeypatch.setattr(jsim, "stokes_solve", functools.partial(
        jsim.stokes_solve, outer_rtol=TIGHT_STOKES))
    jsim.run_simulation(mode, "T", "c", "sulcus",
                        _coarse_params(mode, JParameters, **kw),
                        results_root=str(tmp_path / "jax"),
                        save_paraview=True, verbose=False)
    res = run_simulation(mode, "T", "c", "sulcus",
                         _coarse_params(mode, Parameters, **kw),
                         device="cpu", results_root=str(tmp_path / "port"),
                         save_paraview=True, verbose=False,
                         stokes_options={"rtol": TIGHT_STOKES})
    assert "paraview" in res["timings"]
    sub = f"{jsim.MODE_NAME[mode]} Simulations/T/c/ParaView Files"
    jd, td = tmp_path / "jax" / sub, tmp_path / "port" / sub
    files = _files(jd)
    assert files == _files(td)
    fields = {"velocity.vtk", "pressure.vtk", "concentration.vtk"}
    assert fields <= set(files)
    for f in files:
        if f not in fields:
            assert _same_bytes(jd / f, td / f), f
            continue
        jh, jv = _vtk_values(jd / f)
        th, tv = _vtk_values(td / f)
        assert jh == th, f
        assert jv.shape == tv.shape, f
        scale = max(np.abs(jv).max(), 1e-300)
        assert np.abs(tv - jv).max() <= 1e-9 * scale, f
