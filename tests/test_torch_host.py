"""The port's own host layers against the JAX package's.

The port carries copies of ``params``, ``meshing`` (with its own binding
to the C++ mesher, built from ``native/meshkernel.cpp`` into ``build/``),
``fem.elements``, ``fem.quadrature``, ``fem.dofmap`` and ``fem.space``.
They must give the same results: the mesher the same vertices, cells and
markers bit for bit (h = 0.15 sulcus and rectangle, disk caches off), the
Parameters the same defaults and nondimensional values, the quadrature
rules and element tabulations the same numbers; ``convert.mesh_from``
carries a JAX mesh into the port unchanged.
"""

import numpy as np
import pytest

from fenics_eff_uptake_tpu import params as jparams
from fenics_eff_uptake_tpu.fem import dofmap as jdofmap
from fenics_eff_uptake_tpu.fem import elements as jel
from fenics_eff_uptake_tpu.fem import quadrature as jq
from fenics_eff_uptake_tpu.fem.space import FunctionSpace as JSpace
from fenics_eff_uptake_tpu.meshing.generator import generate_mesh as jgen
from fenics_eff_uptake_tpu_torch import convert
from fenics_eff_uptake_tpu_torch import params as tparams
from fenics_eff_uptake_tpu_torch.fem import dofmap as tdofmap
from fenics_eff_uptake_tpu_torch.fem import elements as tel
from fenics_eff_uptake_tpu_torch.fem import quadrature as tq
from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace as TSpace
from fenics_eff_uptake_tpu_torch.meshing import native as tnative
from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh as tgen

KW = dict(width=10.0, height=1.0, sulcus_depth=1.0, sulcus_width=0.5,
          mesh_size=0.15, refinement_factor=1)


def _mesh_fields(m):
    out = {"vertices": m.vertices, "cells": m.cells,
           "cell_domain": m.cell_domain, "bc_marker": m.bc_marker,
           "bottom_marker": m.bottom_marker, "y0_marker": m.y0_marker,
           "b_edges": m.boundary.edges, "b_cell": m.boundary.cell,
           "b_local": m.boundary.local_edge}
    iy = m.interior_y0
    if iy is not None:
        out.update(iy_edges=iy.edges, iy_cp=iy.cell_plus,
                   iy_lp=iy.local_edge_plus, iy_cm=iy.cell_minus,
                   iy_lm=iy.local_edge_minus)
    return out


def _assert_same_mesh(a, b):
    fa, fb = _mesh_fields(a), _mesh_fields(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
    assert a.domain_type == b.domain_type
    for f in ("width", "height", "sulcus_width", "sulcus_depth",
              "mesh_size", "refinement_factor"):
        assert getattr(a.geom, f) == getattr(b.geom, f), f


@pytest.mark.parametrize("domain_type", ["sulcus", "rectangular"])
def test_port_mesher_equals_jax_mesher(monkeypatch, domain_type):
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    jm = jgen(domain_type=domain_type, **KW)
    tm = tgen(domain_type=domain_type, **KW)
    assert tm.num_cells > 500
    _assert_same_mesh(tm, jm)
    # the port ran its own build of the C++ kernel, not the JAX package's
    assert tnative.library()._name == str(tnative.library_path())
    assert tnative.library_path().parent.name == "mesher"
    assert tnative.library_path().exists()


def test_port_mesher_build_failure_raises(monkeypatch, tmp_path):
    """The port has no second mesher: a kernel that does not build raises
    with the compiler's command, it is never replaced by another
    triangulation."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    with pytest.raises(RuntimeError, match="meshkernel build failed"):
        tnative.library()
    with pytest.raises(RuntimeError, match="meshkernel build failed"):
        tgen(domain_type="rectangular", **dict(KW, mesh_size=0.5))
    assert not list(tmp_path.iterdir())


def test_port_mesh_cache_round_trips(monkeypatch, tmp_path):
    monkeypatch.setenv("FEU_CACHE_DIR", str(tmp_path))
    first = tgen(domain_type="sulcus", **KW)
    assert len(list(tmp_path.glob("port-mesh-*.npz"))) == 1
    second = tgen(domain_type="sulcus", **KW)      # from the cache
    _assert_same_mesh(second, first)


def test_convert_carries_a_jax_mesh_unchanged(monkeypatch):
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    jm = jgen(domain_type="sulcus", **KW)
    tm = convert.mesh_from(jm)
    assert type(tm).__module__.startswith("fenics_eff_uptake_tpu_torch")
    _assert_same_mesh(tm, jm)
    assert convert.mesh_from(tm) is tm
    for element, vs in (("P1", 1), ("P2", 1), ("P2", 2)):
        js = JSpace(jm, element, vs=vs)
        ts = convert.space_from(js, tm)
        assert isinstance(ts, TSpace) and ts.mesh is tm
        np.testing.assert_array_equal(ts.cell_dofs, js.cell_dofs)
        np.testing.assert_array_equal(ts.dof_coords, js.dof_coords)
        assert ts.ndofs == js.ndofs
        mask = jm.bc_marker > 0
        np.testing.assert_array_equal(ts.boundary_scalar_dofs(mask),
                                      js.boundary_scalar_dofs(mask))
    assert TSpace(tm, "P2").new_function().values.shape == (
        JSpace(jm, "P2").ndofs,)


def test_parameters_equal_jax():
    for mode in ("adv-diff", "no-adv", "no-uptake"):
        jp, tp = jparams.Parameters(mode=mode), tparams.Parameters(mode=mode)
        assert tp.to_dict() == jp.to_dict()
        jp.validate()
        tp.validate()
        jp.nondim()
        tp.nondim()
        assert vars(tp) == vars(jp)
        assert tp.get_mesh_generator_params() == \
            jp.get_mesh_generator_params()
    for small in (False, True):
        jv = jparams.create_geometry_variations(jparams.Parameters(),
                                                include_small=small)
        tv = tparams.create_geometry_variations(tparams.Parameters(),
                                                include_small=small)
        assert len(tv) > 20 and tv == jv


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_quadrature_and_elements_equal_jax(degree):
    for rule in ("triangle_rule", "interval_rule"):
        for a, b in zip(getattr(tq, rule)(degree), getattr(jq, rule)(degree)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tq.gauss_legendre_01(degree)[0],
                                  jq.gauss_legendre_01(degree)[0])
    pts, _ = tq.triangle_rule(degree)
    tpts, _ = tq.interval_rule(degree)
    for element in ("P1", "P2"):
        np.testing.assert_array_equal(tel.tabulate(element, pts),
                                      jel.tabulate(element, pts))
        np.testing.assert_array_equal(tel.tabulate_grad(element, pts),
                                      jel.tabulate_grad(element, pts))
        for edge in range(3):
            for a, b in zip(tel.facet_tabulate(element, edge, tpts),
                            jel.facet_tabulate(element, edge, tpts)):
                np.testing.assert_array_equal(a, b)
    assert tel._EDGE_VERTS == jel._EDGE_VERTS
    np.testing.assert_array_equal(tel._REF_VERTS, jel._REF_VERTS)


def test_dofmaps_equal_jax(monkeypatch):
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    m = tgen(domain_type="sulcus", **KW)
    for a, b in zip(tdofmap.build_edges(m.cells),
                    jdofmap.build_edges(m.cells)):
        np.testing.assert_array_equal(a, b)
    for fn in ("p1_dofmap", "p2_dofmap"):
        a = getattr(tdofmap, fn)(m.vertices, m.cells)
        b = getattr(jdofmap, fn)(m.vertices, m.cells)
        np.testing.assert_array_equal(a.cell_dofs, b.cell_dofs)
        np.testing.assert_array_equal(a.dof_coords, b.dof_coords)
        assert (a.ndofs, a.element) == (b.ndofs, b.element)
