"""The whole no-advection mu-sweep slice, port against JAX, on the CPU.

Both packages run the configuration the JAX package runs on a TPU: P2 with
the banded fine operator, a 4-level hierarchy (P2 -> P1 on the same mesh ->
P1 at 0.3 -> P1 at 0.45, passed explicitly: ``build_multilevel_for`` gives
no hierarchy above h = 0.08), windowed-band transfers, banded level applies
inside M, the hybrid cycle, and the fused mixed-precision solve with one
cheap pass.  JAX is forced into it with the environment
``tests/test_banded.py`` uses.

Tolerances: solutions to 1e-8 on true dofs (what test_banded.py holds two
JAX configurations to); passes equal; per-column inner iterations within 1,
since f32 summation order can move one column across its inner tolerance
one iteration earlier or later; true f64 relative residuals <= rtol;
metrics to 1e-10 given the same X (same formulas, f64) and 1e-7 end to end.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu.parallel import sweep as jsw
from fenics_eff_uptake_tpu.solvers import multilevel as jml
from fenics_eff_uptake_tpu.studies.common import \
    make_no_adv_params as j_make_params
from fenics_eff_uptake_tpu_torch.convert import multilevel_from_arrays
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw
from fenics_eff_uptake_tpu_torch.solvers import multilevel as tml

torch.set_num_threads(2)

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
TPU_ENV = {"FEU_ML_TBAND": "1", "FEU_ML_BAND": "1",
           "FEU_ML_CYCLE": "hybrid", "FEU_CHEAP_PASSES": "1",
           "FEU_FUSED_SOLVE": "1"}
RTOL = 1e-12


def _run_both(h, mids, mus):
    mesh = generate_mesh(mesh_size=h, **KW)
    levels = [mesh] + [generate_mesh(mesh_size=m, **KW) for m in mids]
    D = np.ones(len(mus))
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TPU_ENV.items():
            mp.setenv(k, v)
        jsys = jsw.build_transport_system(mesh, element="P2",
                                          pad_shapes=True, band=True)
        jm = jml.build_multilevel(jsys, levels, D, mu_values=mus)
        assert all(lv.bands is not None for lv in jm.levels)
        Xj, ij = jsw.solve_sweep(jsys, D, mu_values=mus, rtol=RTOL,
                                 precision="mixed", multilevel=jm)
        M_fn, m_args = jml.make_ml_preconditioner(jm, f32=True)
    psys = tsw.build_transport_system(mesh, "cpu")
    pml = tml.build_multilevel(psys, levels, D, mus)
    Xp, ip = tsw.solve_sweep(psys, D, mus, rtol=RTOL, multilevel=pml)
    return SimpleNamespace(mesh=mesh, levels=levels, D=D, mus=mus,
                           jsys=jsys, jml=jm, Xj=np.asarray(Xj), ij=ij,
                           M=(M_fn, m_args), psys=psys, pml=pml,
                           Xp=Xp.numpy(), ip=ip)


@pytest.fixture(scope="module")
def run():
    return _run_both(0.15, [0.3, 0.45], np.array([0.1, 1.0, 10.0]))


def _check_solve(r):
    assert r.Xp.shape == r.Xj.shape
    assert float(np.abs(r.Xp - r.Xj).max()) < 1e-8
    assert r.ip["passes"] == r.ij["passes"]
    diff = np.abs(np.asarray(r.ip["iters"]) - np.asarray(r.ij["iters"]))
    assert diff.max() <= 1, (r.ip["iters"], r.ij["iters"])
    assert (r.ip["rel_resnorm"] <= RTOL).all()
    assert (np.asarray(r.ij["rel_resnorm"]) <= RTOL).all()


def test_slice_solution_matches_jax(run):
    _check_solve(run)


def test_hierarchy_matches_jax(run):
    """Same levels, same orderings and inverse diagonals on true dofs
    (f32, 1e-6); the coarsest free masks agree on true dofs."""
    assert len(run.pml.levels) == len(run.jml.levels) == 3
    for pl, jl in zip(run.pml.levels, run.jml.levels):
        n_true = pl.sys.space.ndofs
        np.testing.assert_array_equal(pl.sys.perm[:n_true],
                                      np.asarray(jl.sys.perm)[:n_true])
        d_p = pl.dinv.numpy()[:n_true]
        d_j = np.asarray(jl.dinv)[:n_true]
        assert float(np.abs(d_p - d_j).max() / np.abs(d_j).max()) < 1e-6
        assert pl.transfer.n_coarse <= jl.transfer.n_coarse
    nc = run.pml.free_c.shape[0]
    n_true_c = tsw.build_transport_system(run.levels[-1], "cpu",
                                          element="P1").space.ndofs
    assert nc >= n_true_c
    np.testing.assert_array_equal(run.pml.free_c.numpy()[:n_true_c],
                                  np.asarray(run.jml.free_c)[:n_true_c])


def test_preconditioner_on_carried_state_matches_jax(run):
    """One hybrid cycle of the port on the JAX hierarchy's own arrays
    equals JAX's cycle (f32 chains of band, transfer and element applies
    in another summation order: 1e-5 relative)."""
    jm = run.jml
    meshes = [run.mesh] + run.levels[1:]
    lv = []
    for i, level in enumerate(jm.levels):
        b = level.bands
        lv.append({
            "sys": jsw._system_to_arrays(level.sys), "mesh": meshes[i],
            "element": "P2" if i == 0 else "P1",
            "dinv": np.asarray(level.dinv),
            "t_cols": np.asarray(level.transfer.cols),
            "t_w": np.asarray(level.transfer.weights),
            "n_coarse": level.transfer.n_coarse,
            "tb_p": np.asarray(b[0].band), "tb_po": np.asarray(b[0].offs),
            "pad_p": b[1].n_cols_pad,
            "tb_r": np.asarray(b[2].band), "tb_ro": np.asarray(b[2].offs),
            "pad_r": b[3].n_cols_pad,
            "tb_sig": np.asarray(b[4]), "tb_isig": np.asarray(b[5])})
    carried = multilevel_from_arrays(lv, np.asarray(jm.Ainv),
                                     np.asarray(jm.free_c), jm.omega,
                                     np.asarray(jm.D_vec),
                                     np.asarray(jm.mu_vec), "cpu")
    n = jm.levels[0].sys.ndofs
    R = np.random.default_rng(5).standard_normal(
        (n, len(run.mus))).astype(np.float32)
    M_fn, m_args = run.M
    ref = np.asarray(M_fn(m_args, jnp.asarray(R)))
    got = tml.make_ml_preconditioner(carried)(torch.as_tensor(R)).numpy()
    assert got.dtype == np.float32
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) < 1e-5


def _leaves(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(d, (float, int, np.floating)):
        yield prefix, float(d)


def _metrics_close(got, ref, rtol, atol):
    g, r = dict(_leaves(got)), dict(_leaves(ref))
    assert g.keys() == r.keys()
    for k in r:
        if np.isnan(r[k]):
            assert np.isnan(g[k]), k
            continue
        assert abs(g[k] - r[k]) <= atol + rtol * abs(r[k]), (k, g[k], r[k])


def _metrics(run, X, port):
    params = [j_make_params(m) for m in (0.1, 1.0, 10.0)]
    if port:
        from fenics_eff_uptake_tpu_torch.analysis import batched_metrics as bm
        sm = bm.build_sweep_metrics(run.psys.space, run.mesh, 1.0, "cpu")
        return bm.metrics_to_dicts(sm, run.mesh, torch.tensor(X),
                                   run.mus, params)
    from fenics_eff_uptake_tpu.analysis import batched_metrics as bm
    sm = bm.build_sweep_metrics(run.jsys.space, run.mesh, D=1.0)
    return bm.metrics_to_dicts(sm, run.mesh, jnp.asarray(X), run.mus, 1.0,
                               params)


def test_metrics_match_jax_given_same_x(run):
    got = _metrics(run, run.Xj, port=True)
    ref = _metrics(run, run.Xj, port=False)
    for g_list, r_list in zip(got, ref):
        for g, r in zip(g_list, r_list):
            _metrics_close(g, r, rtol=1e-10, atol=1e-13)


def test_metrics_end_to_end_match_jax(run):
    got = _metrics(run, run.Xp, port=True)
    ref = _metrics(run, run.Xj, port=False)
    for g_list, r_list in zip(got, ref):
        for g, r in zip(g_list, r_list):
            _metrics_close(g, r, rtol=1e-7, atol=1e-10)


@pytest.mark.slow
def test_slice_matches_jax_at_h008():
    """The test_banded.py configuration: h = 0.08, mids 0.24 and 0.45."""
    _check_solve(_run_both(0.08, [0.24, 0.45], np.array([0.1, 1.0, 10.0])))
