"""The heavy cases of the port's two-level preconditioner against the JAX
package (marker ``slow``; the fast ones are in ``test_torch_twolevel.py``).

* An advective sweep with the velocity on the coarse mesh too
  (``u_coarse``): mixed-precision f32 BiCGStab in f64 defect correction,
  on the 10 x 1 sulcus at h = 0.15 (coarse h = 0.45), Pe 0.1, 1, 10 with
  seeded mu.  Both run the JAX package's TPU configuration of the fine
  system (padded, banded); X within 1e-10 on true dofs, passes equal, and
  each column's iterations within the spread JAX shows between its own
  banded and element forms of the same fine operator, of either form (f32
  BiCGStab counts move with the summation order alone; ``ROADMAP.md``
  queue 3: at Pe = 10 JAX reads 209 banded and 198 element, the port 194,
  with its preconditioner's sums in yet another order).
* The models' ``coarse_mesh`` where no hierarchy is built (h >= 0.08):
  ``pure_diffusion_solve`` and ``advdiff_solve`` against JAX's on the
  same meshes, the concentration within 1e-9, and the port's run taking
  the two-level path.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
PES = np.array([0.1, 1.0, 10.0])
RTOL = 1e-12
TPU_ENV = {"FEU_ML_TBAND": "1", "FEU_ML_BAND": "1"}


def _u(xy):
    u = np.zeros(2 * len(xy))
    u[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1])
    u[1::2] = 0.3 * np.sin(xy[:, 0]) * np.clip(-xy[:, 1], 0.0, None)
    return u


@pytest.mark.slow
def test_advective_twolevel_matches_jax():
    import jax.numpy as jnp
    from fenics_eff_uptake_tpu.fem.space import FunctionSpace as JSpace
    from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
    from fenics_eff_uptake_tpu.parallel import sweep as jsw
    from fenics_eff_uptake_tpu_torch.convert import (mesh_from,
                                                     velocity_from_values)
    from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw

    mesh = generate_mesh(mesh_size=0.15, **KW)
    coarse = generate_mesh(mesh_size=0.45, **KW)
    V, Vc = JSpace(mesh, "P2", vs=2), JSpace(coarse, "P2", vs=2)
    u, uc = _u(V.dof_coords), _u(Vc.dof_coords)
    D = 1.0 / PES
    mus = np.random.default_rng(11).uniform(0.1, 10.0, 3)
    runs = {}
    for band in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            for k, v in TPU_ENV.items():
                mp.setenv(k, v)
            jsys = jsw.build_transport_system(
                mesh, u_values=jnp.asarray(u), u_space=V, pad_shapes=True,
                band=band)
            X, info = jsw.solve_sweep(
                jsys, D, mu_values=mus, rtol=RTOL, precision="mixed",
                coarse_mesh=coarse, u_coarse=(jnp.asarray(uc), Vc))
        runs[band] = (np.asarray(X), info)
    (Xj, ij), (_, ij_elem) = runs[True], runs[False]
    tmesh, tcoarse = mesh_from(mesh), mesh_from(coarse)
    uf = velocity_from_values(u, tmesh)
    ucf = velocity_from_values(uc, tcoarse)
    psys = tsw.build_transport_system(tmesh, "cpu", u_values=uf.values,
                                      u_space=uf.space)
    Xp, ip = tsw.solve_sweep(psys, D, mus, rtol=RTOL, coarse_mesh=tcoarse,
                             u_coarse=(ucf.values, ucf.space))
    assert float(np.abs(Xp.numpy() - Xj).max()) < 1e-10
    assert ip["passes"] == ij["passes"] == ij_elem["passes"]
    it_j, it_e = np.asarray(ij["iters"]), np.asarray(ij_elem["iters"])
    spread = int(np.abs(it_e - it_j).max())
    near = np.minimum(np.abs(ip["iters"] - it_j), np.abs(ip["iters"] - it_e))
    assert (near <= spread).all(), (ip["iters"], it_j, it_e, spread)
    assert ip["converged"].all()


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["no-adv", "adv-diff"])
def test_models_take_the_coarse_mesh(mode):
    """At h = 0.1 no hierarchy is built: the coarse mesh (h = 0.4, as
    ``get_coarse_mesh`` makes it at factor 4) preconditions the solve."""
    from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
    from fenics_eff_uptake_tpu.models import advdiff as jad
    from fenics_eff_uptake_tpu.models import diffusion as jdiff
    from fenics_eff_uptake_tpu.fem.space import FunctionSpace as JSpace
    from fenics_eff_uptake_tpu.fem.space import Function as JFunction
    from fenics_eff_uptake_tpu_torch.convert import (mesh_from,
                                                     velocity_from_values)
    from fenics_eff_uptake_tpu_torch.models.advdiff import advdiff_solve
    from fenics_eff_uptake_tpu_torch.models.diffusion import \
        pure_diffusion_solve

    mesh = generate_mesh(mesh_size=0.1, **KW)
    coarse = generate_mesh(mesh_size=0.4, **KW)
    tmesh, tcoarse = mesh_from(mesh), mesh_from(coarse)
    if mode == "no-adv":
        cj = jdiff.pure_diffusion_solve(mesh, D=1.0, mu=2.0,
                                        coarse_mesh=coarse)
        ct = pure_diffusion_solve(tmesh, "cpu", D=1.0, mu=2.0,
                                  coarse_mesh=tcoarse)
    else:
        V = JSpace(mesh, "P2", vs=2)
        u = _u(V.dof_coords)
        cj = jad.advdiff_solve(mesh, JFunction(V, u), D=1.0, mu=2.0,
                               coarse_mesh=coarse, solver=None)
        ct = advdiff_solve(tmesh, velocity_from_values(u, tmesh), "cpu",
                           D=1.0, mu=2.0, coarse_mesh=tcoarse, solver=None)
    assert ct.solver_info["twolevel"] and not ct.solver_info["multilevel"]
    assert ct.solver_info["converged"]
    assert float(np.abs(ct.as_numpy() - np.asarray(cj.values)).max()) < 1e-9
