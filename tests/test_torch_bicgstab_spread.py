"""f32 BiCGStab iteration counts move with the order of the f32 sums, and
with nothing else.

The port's CPU counts at h = 0.035 were once read as 158 and later as 166
and 226 on the Pe = 10 column and taken for a drift between code versions.
Every version gives every one of those counts: they depend on the number
of CPU threads, which sets how PyTorch's einsum and reductions split their
f32 sums (``scripts/bicgstab_count_spread.py``: 151, 162, 166, 158 on the
sulcus and 172, 168, 226, 154 on the rectangle with 1, 2, 4, 8 threads).  What
the tests hold:

* at a fixed thread count the solve is deterministic: two runs give the
  same counts and the same bits;
* across thread counts the passes are equal, the true f64 residuals stay
  below rtol, the solutions agree to 1e-8, and a column's count stays
  within a factor 1.5 (the bound ``chip_smoke.py`` derives its BiCGStab
  gates from);
* (slow, h = 0.035) the JAX package shows the same kind of spread between
  its banded and element forms of one solve, which also differ only in
  the order of their f32 sums (150 against 138 on the Pe = 10 column, where
  the port reads 144 and 148), and the port's counts lie within a factor
  1.5 of JAX's.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw
from fenics_eff_uptake_tpu_torch.solvers import multilevel as tml

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
PES = np.array([0.1, 1.0, 10.0])
RTOL = 1e-12
SPREAD = 1.5


def _velocity(V):
    xy = np.asarray(V.dof_coords)
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1])
    u[1::2] = 0.3 * np.sin(xy[:, 0]) * np.clip(-xy[:, 1], 0.0, None)
    return u


def _port_problem(h, mids):
    from fenics_eff_uptake_tpu_torch.fem.space import Function
    mesh = generate_mesh(mesh_size=h, **KW)
    levels = [mesh] + [generate_mesh(mesh_size=m, **KW) for m in mids]
    V = FunctionSpace(mesh, "P2", vs=2)
    u = Function(V, _velocity(V))
    D = 1.0 / PES
    sys_ = tsw.build_transport_system(mesh, "cpu", u_values=u.values,
                                      u_space=u.space)
    ml = tml.build_multilevel(sys_, levels, D, np.zeros(3),
                              u_levels=tml.level_velocities(u, levels))
    return SimpleNamespace(sys=sys_, ml=ml, D=D, levels=levels, u=u)


def _solve(p, threads):
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return tsw.solve_sweep(p.sys, p.D, np.zeros(3), rtol=RTOL,
                               multilevel=p.ml)
    finally:
        torch.set_num_threads(before)


def _check_across_orders(runs):
    X0, i0 = runs[0]
    for X, info in runs:
        assert (info["rel_resnorm"] <= RTOL).all()
        assert info["passes"] == i0["passes"]
        assert float((X - X0).abs().max()) < 1e-8
    its = np.array([info["iters"] for _, info in runs])
    assert (its.max(0) <= SPREAD * its.min(0)).all(), its
    return its


@pytest.fixture(scope="module")
def small():
    return _port_problem(0.12, (0.3, 0.45))


def test_counts_are_deterministic_at_a_fixed_thread_count(small):
    Xa, ia = _solve(small, 2)
    Xb, ib = _solve(small, 2)
    assert torch.equal(Xa, Xb)
    np.testing.assert_array_equal(ia["iters"], ib["iters"])
    assert ia["passes"] == ib["passes"]


def test_counts_across_thread_counts_stay_within_the_spread(small):
    _check_across_orders([_solve(small, n) for n in (1, 2, 4)])


@pytest.mark.slow
def test_spread_at_h0035_matches_jax_band_vs_element(monkeypatch):
    """h = 0.035 (the size of the CPU runs the bounds once came from): the
    port under 1, 2 and 4 threads, and the JAX package's banded and element
    forms of the same solve."""
    import jax.numpy as jnp

    from fenics_eff_uptake_tpu.fem.space import FunctionSpace as JSpace
    from fenics_eff_uptake_tpu.meshing.generator import \
        generate_mesh as j_generate_mesh
    from fenics_eff_uptake_tpu.parallel import sweep as jsw
    from fenics_eff_uptake_tpu.solvers import multilevel as jml
    from fenics_eff_uptake_tpu.analysis.profiles import eval_function
    from fenics_eff_uptake_tpu.fem.space import Function as JFunction

    p = _port_problem(0.035, (0.105, 0.315))
    its = _check_across_orders([_solve(p, n) for n in (1, 2, 4)])
    print("port counts by thread count (1, 2, 4):", its.tolist())

    mesh = j_generate_mesh(mesh_size=0.035, **KW)
    levels = [mesh] + [j_generate_mesh(mesh_size=m, **KW)
                       for m in (0.105, 0.315)]
    V = JSpace(mesh, "P2", vs=2)
    u = _velocity(V)
    u_levels = []
    for m in levels:
        if m is mesh:
            u_levels.append((jnp.asarray(u), V))
            continue
        Vl = JSpace(m, "P2", vs=2)
        vals, ok = eval_function(JFunction(V, jnp.asarray(u)), Vl.dof_coords)
        vals = np.where(ok[:, None], vals, 0.0)
        inter = np.zeros(Vl.ndofs)
        inter[0::2], inter[1::2] = vals[:, 0], vals[:, 1]
        u_levels.append((jnp.asarray(inter), Vl))
    monkeypatch.setenv("FEU_ML_TBAND", "1")
    monkeypatch.setenv("FEU_ML_BAND", "1")
    monkeypatch.delenv("FEU_ML_CYCLE", raising=False)
    jits = []
    for band in (True, False):
        jsys = jsw.build_transport_system(mesh, u_values=jnp.asarray(u),
                                          u_space=V, pad_shapes=True,
                                          band=band)
        jm = jml.build_multilevel(jsys, levels, p.D, mu_values=np.zeros(3),
                                  u_levels=u_levels)
        _, ij = jsw.solve_sweep(jsys, p.D, mu_values=np.zeros(3), rtol=RTOL,
                                precision="mixed", multilevel=jm)
        jits.append(np.asarray(ij["iters"]))
    jits = np.array(jits)
    print("JAX counts (banded, element):", jits.tolist())
    both = np.concatenate([its, jits])
    assert (both.max(0) <= SPREAD * both.min(0)).all(), both
