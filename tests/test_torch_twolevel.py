"""The port's two-level preconditioner (``solvers/twolevel.py``) against the
JAX package's, on the CPU.

The setting is the JAX package's own test (``tests/test_solvers.py``
``test_twolevel_fallback_preconditioner``): the 5 x 1 sulcus at h = 0.15,
its coarse mesh at h = 0.45, D = 1 and mu {0.1, 1, 10}.  The JAX fine
system is its CPU default (no padding, no band), carried into the port
(``convert.transport_system_from_arrays``) so that both number the dofs
alike; the port's own system (padded, reordered) is held too.

* host arrays (the dense coarse inverses, ``cols``, the weights): bit for
  bit; the Woodbury form's (A0inv, Z, W, Cinv) bit for bit on JAX's coarse
  element arrays (on the port's own, equal to 3e-17, the Robin factor's
  eigenvectors may flip sign: A0inv bit for bit, W W^T to 1e-6);
* ``make_preconditioner`` on one seeded random (n, B) block: 1e-6
  relative (f32 products in another order);
* ``solve_sweep(coarse_mesh=, precision="f64")``: X within 1e-10 of JAX's,
  iterations equal (JAX's solve in one-iteration chunks, since in longer
  ones it counts whole chunks); on the port's own system within one;
* the Woodbury form against the per-sample form: X within 1e-8;
* the fallback (the JAX test, port only): fewer iterations than Jacobi,
  and X within 1e-8 of Jacobi's;
* ``maxiter`` caps an f64 solve; ``simulation.get_coarse_mesh`` gives
  JAX's mesh.

The advective case with ``u_coarse`` (mixed BiCGStab) and the models'
``coarse_mesh`` are in ``test_torch_twolevel_slow.py``.  On the card
(marker ``cuda``): the CUDA build and apply against the CPU's.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw
from fenics_eff_uptake_tpu_torch.solvers import twolevel as ttl

torch.set_num_threads(2)

KW = dict(width=5.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
MUS = np.array([0.1, 1.0, 10.0])
D = np.ones(3)
RTOL = 1e-12


@pytest.fixture(scope="module")
def run():
    import jax.numpy as jnp
    from fenics_eff_uptake_tpu.meshing.generator import \
        generate_mesh as j_generate_mesh
    from fenics_eff_uptake_tpu.parallel import sweep as jsw
    from fenics_eff_uptake_tpu.solvers import twolevel as jtl
    from fenics_eff_uptake_tpu_torch.convert import (
        mesh_from, transport_system_from_arrays)

    mesh = j_generate_mesh(mesh_size=0.15, **KW)
    coarse = j_generate_mesh(mesh_size=0.45, **KW)
    jsys = jsw.build_transport_system(mesh, element="P2", pad_shapes=False)
    carried = transport_system_from_arrays(jsw._system_to_arrays(jsys), mesh,
                                           "P2", "cpu")
    tcoarse = mesh_from(coarse)
    jtlev = jtl.build_twolevel(jsys, coarse, D, mu_values=MUS)
    ptlev = ttl.build_twolevel(carried, tcoarse, D, mu_values=MUS)
    Xj, ij = jsw.solve_sweep(jsys, D, mu_values=MUS, rtol=RTOL,
                             precision="f64", coarse_mesh=coarse,
                             chunk_iters=1, maxiter=4000)
    dinv = jsw._operator_program(jsw.sys_struct_key(jsys))[3](
        jsw.operator_args(jsys, jnp.asarray(D), jnp.asarray(MUS), None,
                          f32=False))
    return SimpleNamespace(jnp=jnp, jsw=jsw, jtl=jtl, mesh=mesh,
                           coarse=coarse, jsys=jsys, carried=carried,
                           tcoarse=tcoarse, own=tsw.build_transport_system(
                               mesh_from(mesh), "cpu"),
                           jtlev=jtlev, ptlev=ptlev, Xj=np.asarray(Xj),
                           ij=ij, dinv=dinv)


def _jax_woodbury(run):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEU_WOODBURY", "1")
        return run.jtl.build_twolevel(run.jsys, run.coarse, D,
                                      mu_values=MUS)


def test_host_arrays_bit_equal_to_jax(run):
    j, p = run.jtlev, run.ptlev
    assert p.n_coarse == j.n_coarse == len(run.coarse.vertices)
    np.testing.assert_array_equal(p.Ainv.numpy(), np.asarray(j.Ainv))
    np.testing.assert_array_equal(p.cols.numpy(), np.asarray(j.cols))
    np.testing.assert_array_equal(p.weights.numpy(), np.asarray(j.weights))
    # the host build on JAX's own coarse element arrays
    csys = run.jsw.build_transport_system(run.coarse, element="P1",
                                          pad_shapes=False)
    inv = ttl.coarse_inverses(
        (np.asarray(csys.K.A64), np.asarray(csys.K.dofs)),
        np.asarray(csys.free), D, MUS,
        R=(np.asarray(csys.R.A64), np.asarray(csys.R.dofs)))
    np.testing.assert_array_equal(inv["Ainv"], np.asarray(j.Ainv))
    # P^T's plan: every live entry once, by coarse id, in entry order
    # within one id
    w = p.weights.numpy().ravel()
    perm = p.perm.numpy()
    assert sorted(perm.tolist()) == np.flatnonzero(w != 0).tolist()
    ids = np.repeat(np.arange(p.n_coarse), p.lengths.numpy())
    np.testing.assert_array_equal(ids, p.cols.numpy().ravel()[perm])
    assert all((np.diff(perm[ids == c]) > 0).all()
               for c in range(p.n_coarse))


def test_woodbury_host_arrays_bit_equal_to_jax(run):
    """On JAX's coarse element arrays, bit for bit.  On the port's own
    (equal to 3e-17) the Robin factor's eigenvectors may change sign: W W^T
    is held instead, and A0inv bit for bit."""
    j = _jax_woodbury(run)
    csys = run.jsw.build_transport_system(run.coarse, element="P1",
                                          pad_shapes=False)
    inv = ttl.coarse_inverses(
        (np.asarray(csys.K.A64), np.asarray(csys.K.dofs)),
        np.asarray(csys.free), D, MUS,
        R=(np.asarray(csys.R.A64), np.asarray(csys.R.dofs)), woodbury=True)
    assert j.Ainv is None and "Ainv" not in inv
    for k in ("A0inv", "Z", "W", "Cinv"):
        np.testing.assert_array_equal(inv[k], np.asarray(getattr(j, k)),
                                      err_msg=k)
    p = ttl.build_twolevel(run.carried, run.tcoarse, D, mu_values=MUS,
                           woodbury=True)
    assert p.Ainv is None
    np.testing.assert_array_equal(p.A0inv.numpy(), np.asarray(j.A0inv))
    Wp, Wj = p.W.double().numpy(), np.asarray(j.W, dtype=np.float64)
    assert Wp.shape == Wj.shape
    assert np.abs(Wp @ Wp.T - Wj @ Wj.T).max() < 1e-6 * np.abs(
        Wj @ Wj.T).max()
    # per-sample Robin matrices (or several D) keep the per-sample path
    assert ttl.build_twolevel(run.carried, run.tcoarse, [1.0, 0.5, 1.0],
                              MUS, woodbury=True).Ainv is not None


@pytest.mark.parametrize("form", ["per_sample", "woodbury"])
def test_preconditioner_apply_matches_jax(run, form):
    if form == "woodbury":
        j = _jax_woodbury(run)
        p = ttl.build_twolevel(run.carried, run.tcoarse, D, MUS,
                               woodbury=True)
    else:
        j, p = run.jtlev, run.ptlev
    R = np.random.default_rng(7).standard_normal(
        (run.jsys.ndofs, 3)).astype(np.float32)
    fn, args = run.jtl.make_preconditioner(j, run.dinv, f32=True)
    ref = np.asarray(fn(args, run.jnp.asarray(R)))
    M = ttl.make_preconditioner(p, tsw.fine_dinv(run.carried, D, MUS,
                                                 dtype=torch.float64))
    got = M(torch.as_tensor(R))
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - ref).max() / np.abs(ref).max()) < 1e-6
    # an f64 residual is rounded to f32 and the result returned in f64
    got64 = M(torch.as_tensor(R, dtype=torch.float64))
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(got64.numpy(), got.double().numpy())


def test_f64_solve_matches_jax(run):
    X, info = tsw.solve_sweep(run.carried, D, MUS, rtol=RTOL,
                              precision="f64", coarse_mesh=run.tcoarse)
    assert float(np.abs(X.numpy() - run.Xj).max()) < 1e-10
    np.testing.assert_array_equal(info["iters"], np.asarray(run.ij["iters"]))
    assert info["converged"].all()
    # the data built beforehand, passed as twolevel=
    X2, info2 = tsw.solve_sweep(run.carried, D, MUS, rtol=RTOL,
                                precision="f64", twolevel=run.ptlev)
    np.testing.assert_array_equal(X2.numpy(), X.numpy())
    np.testing.assert_array_equal(info2["iters"], info["iters"])


def test_own_system_matches_jax(run):
    """The port's padded, reordered system: its padding rows take no
    coarse correction."""
    tl = ttl.build_twolevel(run.own, run.tcoarse, D, MUS)
    n_true = run.own.space.ndofs
    assert run.own.ndofs > n_true
    assert not tl.weights.numpy()[n_true:].any()
    X, info = tsw.solve_sweep(run.own, D, MUS, rtol=RTOL, precision="f64",
                              twolevel=tl)
    assert float(np.abs(X.numpy() - run.Xj).max()) < 1e-10
    assert np.abs(info["iters"] - np.asarray(run.ij["iters"])).max() <= 1
    assert (info["true_rel_resnorm"] <= RTOL).all()


def test_woodbury_matches_per_sample(run):
    tl = ttl.build_twolevel(run.own, run.tcoarse, D, MUS, woodbury=True)
    Xw, iw = tsw.solve_sweep(run.own, D, MUS, rtol=RTOL, precision="f64",
                             twolevel=tl)
    X, info = tsw.solve_sweep(run.own, D, MUS, rtol=RTOL, precision="f64",
                              coarse_mesh=run.tcoarse)
    assert float(np.abs(Xw.numpy() - X.numpy()).max()) < 1e-8
    assert (iw["true_rel_resnorm"] <= RTOL).all()


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_twolevel_fallback_preconditioner(run, precision):
    """The JAX test, on the port: the two-level preconditioner converges
    to the Jacobi answer with fewer iterations, in f64 and mixed."""
    X_tl, info_tl = tsw.solve_sweep(run.own, D, MUS, rtol=RTOL,
                                    precision=precision,
                                    coarse_mesh=run.tcoarse, maxiter=4000)
    X_j, info_j = tsw.solve_sweep(run.own, D, MUS, rtol=RTOL,
                                  precision=precision)
    assert float(np.abs(X_tl.numpy() - X_j.numpy()).max()) < 1e-8
    assert info_tl["iters"].max() < info_j["iters"].max()
    assert info_tl["converged"].all()


def test_maxiter_caps_the_solve(run):
    X, info = tsw.solve_sweep(run.own, D, MUS, rtol=RTOL, precision="f64",
                              coarse_mesh=run.tcoarse, maxiter=5)
    np.testing.assert_array_equal(info["iters"], [5, 5, 5])
    assert not info["converged"].any()
    _, im = tsw.solve_sweep(run.own, D, MUS, rtol=RTOL,
                            coarse_mesh=run.tcoarse, maxiter=5)
    # mixed: at most 5 inner iterations per pass
    assert (im["iters"] <= 5 * im["passes"]).all()


def test_get_coarse_mesh_matches_jax():
    from fenics_eff_uptake_tpu import simulation as jsim
    from fenics_eff_uptake_tpu.params import Parameters as JParameters
    from fenics_eff_uptake_tpu_torch import simulation as tsim
    from fenics_eff_uptake_tpu_torch.params import Parameters

    for h, want in ((0.05, True), (0.1, False)):
        jp = JParameters(mode="no-adv", mesh_size_dim=h)
        tp = Parameters(mode="no-adv", mesh_size_dim=h)
        for p in (jp, tp):
            p.validate()
            p.nondim()
        jm = jsim.get_coarse_mesh(jp, "sulcus")
        tm = tsim.get_coarse_mesh(tp, "sulcus")
        assert (tm is not None) == (jm is not None) == want
        if want:
            np.testing.assert_array_equal(tm.vertices, jm.vertices)
            np.testing.assert_array_equal(tm.cells, jm.cells)
            assert tsim.get_coarse_mesh(tp, "sulcus") is tm    # memoised
            assert tsim.get_mesh(tp, "sulcus", coarsen=4.0) is tm


@pytest.mark.cuda
def test_twolevel_on_the_card_matches_cpu():
    """The build on a CUDA system (arrays on the card) and its apply and
    f64 solve against the CPU's: the same host arrays, the apply within
    1e-6, X within 1e-10 and the same iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = generate_mesh(mesh_size=0.15, **KW)
    coarse = generate_mesh(mesh_size=0.45, **KW)
    out = {}
    for dev in ("cpu", "cuda"):
        sys_t = tsw.build_transport_system(mesh, dev)
        tl = ttl.build_twolevel(sys_t, coarse, D, MUS)
        assert tl.Ainv.device.type == dev
        R = torch.as_tensor(np.random.default_rng(3).standard_normal(
            (sys_t.ndofs, 3)).astype(np.float32), device=dev)
        M = ttl.make_preconditioner(tl, tsw.fine_dinv(
            sys_t, D, MUS, dtype=torch.float64))
        X, info = tsw.solve_sweep(sys_t, D, MUS, rtol=RTOL,
                                  precision="f64", twolevel=tl)
        out[dev] = (tl, M(R).cpu().numpy(), X.cpu().numpy(), info)
    (tc, yc, xc, ic), (tg, yg, xg, ig) = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(tg.Ainv.cpu().numpy(), tc.Ainv.numpy())
    np.testing.assert_array_equal(tg.weights.cpu().numpy(),
                                  tc.weights.numpy())
    assert float(np.abs(yg - yc).max() / np.abs(yc).max()) < 1e-6
    assert float(np.abs(xg - xc).max()) < 1e-10
    np.testing.assert_array_equal(ig["iters"], ic["iters"])
