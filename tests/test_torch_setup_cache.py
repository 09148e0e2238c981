"""The port's setup cache: the disk cache of ``utils/diskcache.py`` and the
content memos above it.

* The disk cache's round trip (hit, miss, ``FEU_DISK_CACHE=0``, a corrupt
  file read as a miss and rebuilt, ``port-`` tags only), and a JAX-written
  ``tsys`` entry in the same ``FEU_CACHE_DIR`` never read by the port.
* Cold (empty directory, memos cleared), disk-warm (memos cleared) and
  memo-warm builds of a transport system and its hierarchy at h = 0.12
  give ``torch.equal`` tensors (blocks, plans, bands, spans, transfers and
  their bands, coarsest inverses), and solves with them equal X,
  iterations and passes; the tensors the memos share are unchanged by the
  solves that used them.  Each keyed input, changed alone, misses.
* The Stokes field: a disk hit gives the miss's values bit for bit, marked
  ``+cache``; a changed key input misses; a field that did not converge is
  never stored.

Runs on the CPU; ``test_memo_is_keyed_by_device`` needs the card (marker
``cuda``; it imports nothing of JAX, so ``--noconftest`` runs it there).
"""

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu_torch.models import stokes_flow as tsf
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw
from fenics_eff_uptake_tpu_torch.solvers import multilevel as tml
from fenics_eff_uptake_tpu_torch.utils import diskcache as dc

torch.set_num_threads(2)

KW = dict(width=10.0, height=1.0, sulcus_depth=1.0, sulcus_width=0.5,
          mesh_size=0.12, refinement_factor=1, domain_type="sulcus")
D = np.array([1.0, 0.5, 2.0])
MU = np.array([0.3, 3.0, 30.0])


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    """An empty cache directory, the disk on, every memo and count empty."""
    monkeypatch.setenv("FEU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("FEU_DISK_CACHE", raising=False)
    dc.clear_memos()
    dc.reset_stats()
    yield tmp_path
    dc.clear_memos()


def _hits(tag):
    return dc.CACHE_STATS.get(tag, {"memo": 0, "disk": 0, "miss": 0})


# ---------------------------------------------------------------------------
# the disk cache
# ---------------------------------------------------------------------------

def test_diskcache_round_trip(cache, monkeypatch):
    key = dc.cache_key_of(np.arange(5), "tag", None, 3.5)
    calls = []

    def build():
        calls.append(1)
        return {"a": np.eye(3), "n": 7, "s": "lapack"}

    out1, hit1 = dc.cached_arrays("port-t", key, build)
    out2, hit2 = dc.cached_arrays("port-t", key, build)
    assert not hit1 and hit2 and len(calls) == 1
    np.testing.assert_array_equal(out2["a"], np.eye(3))
    assert out2["n"] == 7 and out2["s"] == "lapack"
    assert _hits("port-t") == {"memo": 0, "disk": 1, "miss": 1}
    assert [p.name for p in cache.iterdir()] == [f"port-t-{key}.npz"]
    # the disk off: always a miss, nothing read or written
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    _, hit3 = dc.cached_arrays("port-t", key, build)
    assert not hit3 and len(calls) == 2
    assert dc.load_arrays("port-t", key) is None


def test_corrupt_entry_is_a_miss_and_rebuilt(cache):
    key = dc.cache_key_of("corrupt")
    dc.store_arrays("port-t", key, {"a": np.arange(4.0)})
    path = cache / f"port-t-{key}.npz"
    path.write_bytes(path.read_bytes()[:40])         # a partial write
    assert dc.load_arrays("port-t", key) is None
    assert not path.exists()
    out, hit = dc.cached_arrays("port-t", key,
                                lambda: {"a": np.arange(4.0)})
    assert not hit and path.exists()
    np.testing.assert_array_equal(dc.load_arrays("port-t", key)["a"],
                                  np.arange(4.0))
    assert not list(cache.glob("*.tmp"))


def test_keys_and_tags_are_the_ports_own():
    with pytest.raises(ValueError, match="port-"):
        dc.store_arrays("tsys", dc.cache_key_of(1), {"a": np.zeros(1)})
    with pytest.raises(ValueError, match="port-"):
        dc.load_arrays("mltransfer", dc.cache_key_of(1))
    from fenics_eff_uptake_tpu.utils import diskcache as jdc
    a = np.arange(12.0).reshape(3, 4)
    assert dc.cache_key_of(a, "x") != jdc.cache_key_of(a, "x")
    # tuples are hashed element by element: an array's repr elides its
    # middle, the key must not
    big = np.zeros(5000)
    big2 = big.copy()
    big2[2500] = 1.0
    assert dc.cache_key_of((big, 1)) != dc.cache_key_of((big2, 1))


def test_memo_is_bounded_least_recently_used_out():
    m = dc.Memo("port-unit", cap=2)
    m.put("a", 1)
    m.put("b", 2)
    assert m.get("a") == 1          # a is now the most recent
    m.put("c", 3)
    assert m.get("b") is None and m.get("a") == 1 and m.get("c") == 3
    assert len(m) == 2
    dc.clear_memos()
    assert len(m) == 0


def test_jax_written_entry_is_never_read(cache):
    """The JAX package's tsys entry in the same directory: the port misses,
    writes its own ``port-tsys`` entry, and leaves the JAX file alone."""
    from fenics_eff_uptake_tpu.meshing.generator import generate_mesh as jgen
    from fenics_eff_uptake_tpu.parallel import sweep as jsw
    jgen_kw = {k: v for k, v in KW.items() if k != "domain_type"}
    jm = jgen(domain_type="sulcus", **jgen_kw)
    jsw.build_transport_system(jm, disk_cache=True)
    jax_files = sorted(p.name for p in cache.glob("tsys-*.npz"))
    assert len(jax_files) == 1
    sys = tsw.build_transport_system(generate_mesh(**KW), "cpu")
    assert _hits(tsw.TSYS_TAG) == {"memo": 0, "disk": 0, "miss": 1}
    assert len(list(cache.glob("port-tsys-*.npz"))) == 1
    assert sorted(p.name for p in cache.glob("tsys-*.npz")) == jax_files
    assert sys.Kband is not None and sys.Kspans is not None


# ---------------------------------------------------------------------------
# cold, disk-warm and memo-warm builds
# ---------------------------------------------------------------------------

def _same(a, b, path="x"):
    """Tensors torch.equal (and of one dtype and device), arrays equal,
    everything else equal, through NamedTuples, tuples and dicts."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), path
        assert a.dtype == b.dtype and a.device == b.device, path
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, FunctionSpace):
        assert (a.element, a.vs, a.ndofs) == (b.element, b.vs, b.ndofs)
    elif hasattr(a, "_fields"):
        for f in a._fields:
            if f == "kernels":       # bound on a CUDA device only
                assert (a.kernels is None) == (b.kernels is None), path
                continue
            _same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k}]")
    else:
        assert a == b, (path, a, b)


def _run():
    mesh = generate_mesh(**KW)
    sys = tsw.build_transport_system(mesh, "cpu")
    ml = tml.build_multilevel(sys, tml.level_meshes_for(mesh), D, MU)
    X, info = tsw.solve_sweep(sys, D, MU, rtol=1e-10, multilevel=ml)
    stats = {k: dict(v) for k, v in dc.CACHE_STATS.items()}
    dc.reset_stats()
    return sys, ml, X, info, stats


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEU_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))
        mp.delenv("FEU_DISK_CACHE", raising=False)
        dc.clear_memos()
        dc.reset_stats()
        cold = _run()
        dc.clear_memos()
        disk = _run()
        memo = _run()
        dc.clear_memos()
    return cold, disk, memo


def test_cold_disk_and_memo_runs_count_as_they_should(three):
    cold, disk, memo = (r[4] for r in three)
    tags = (tsw.TSYS_TAG, tml.TRANSFER_TAG, tml.TBANDPLAN_TAG)
    for tag in tags:
        n = cold[tag]["miss"]
        assert n >= 3 and cold[tag]["disk"] == cold[tag]["memo"] == 0, tag
        assert disk[tag] == {"memo": 0, "disk": n, "miss": 0}, tag
        assert memo[tag] == {"memo": n, "disk": 0, "miss": 0}, tag
    # the coarsest inverses live in the memo alone
    assert cold[tml.AINV_TAG]["miss"] == disk[tml.AINV_TAG]["miss"] == 1
    assert memo[tml.AINV_TAG] == {"memo": 1, "disk": 0, "miss": 0}
    # the level meshes come from the memo on the memo-warm run
    assert memo["port-mesh"]["memo"] == len(tml.LEVEL_FACTORS)


def test_systems_and_hierarchies_are_equal(three):
    (s0, m0, *_), (s1, m1, *_), (s2, m2, *_) = three
    for s, m in ((s1, m1), (s2, m2)):
        _same(s, s0, "sys")
        _same(m._replace(lowp={}), m0._replace(lowp={}), "ml")
    # the memo-warm run shares the disk-warm run's tensors (on a mesh
    # object of its own, its system is the memo's with its own space)
    assert s2.K is s1.K and s2.Kband is s1.Kband and m2.Ainv is m1.Ainv
    assert m2.levels[0].transfer is m1.levels[0].transfer


def test_solves_are_equal(three):
    (_, _, X0, i0, _), (_, _, X1, i1, _), (_, _, X2, i2, _) = three
    assert torch.equal(X1, X0) and torch.equal(X2, X0)
    for i in (i1, i2):
        np.testing.assert_array_equal(i["iters"], i0["iters"])
        assert i["passes"] == i0["passes"]
        np.testing.assert_array_equal(i["resnorm"], i0["resnorm"])
    assert (i0["true_rel_resnorm"] <= 1e-10).all()


def test_a_hierarchy_keeps_its_own_low_precision_copies(three, cache):
    """The memos share components, never a MultilevelData: a bf16 cycle
    on one hierarchy leaves another built on the same memo hits without
    bf16 copies."""
    mesh = generate_mesh(**KW)
    sys = tsw.build_transport_system(mesh, "cpu")
    ml_a = tml.build_multilevel(sys, tml.level_meshes_for(mesh), D, MU)
    tml.make_ml_preconditioner(ml_a, "hybrid", dtype=torch.bfloat16)
    assert ml_a.lowp
    ml_b = tml.build_multilevel(sys, tml.level_meshes_for(mesh), D, MU)
    assert ml_b.lowp == {} and ml_b.Ainv is ml_a.Ainv


def _counts_after(fn):
    dc.reset_stats()
    out = fn()
    return out, {k: dict(v) for k, v in dc.CACHE_STATS.items()}


@pytest.mark.parametrize("change", ["mesh", "element", "velocity",
                                    "dirichlet", "robin"])
def test_a_changed_system_input_misses(cache, change):
    def velocity(mesh):
        V = FunctionSpace(mesh, "P2", vs=2)
        u = np.zeros(V.ndofs)
        u[0::2] = V.dof_coords[:, 1]
        return {"mesh": mesh, "u_values": u, "u_space": V}

    base = dict(velocity(generate_mesh(**KW)), element="P2",
                dirichlet=None, with_robin=True)
    s0 = tsw.build_transport_system(device="cpu", **base)
    u2 = base["u_values"].copy()
    u2[7] += 1e-9
    kw = dict(base, **{
        "mesh": velocity(generate_mesh(**dict(KW, mesh_size=0.13))),
        "element": {"element": "P1", "u_values": None, "u_space": None},
        "velocity": {"u_values": u2},
        "dirichlet": {"dirichlet": [(1, 1.0), (2, 0.5)]},
        "robin": {"with_robin": False}}[change])
    s1, n = _counts_after(lambda: tsw.build_transport_system(device="cpu",
                                                             **kw))
    assert n[tsw.TSYS_TAG] == {"memo": 0, "disk": 0, "miss": 1}
    assert s1 is not s0
    # and the unchanged inputs still hit
    _, n = _counts_after(lambda: tsw.build_transport_system(device="cpu",
                                                            **base))
    assert n[tsw.TSYS_TAG] == {"memo": 1, "disk": 0, "miss": 0}


@pytest.mark.parametrize("change", ["D", "mu", "method", "robin_batch"])
def test_a_changed_coarse_input_misses(cache, change):
    mesh = generate_mesh(**KW)
    sys = tsw.build_transport_system(mesh, "cpu")
    meshes = tml.level_meshes_for(mesh)
    rb = None
    if change == "robin_batch":
        rb = tml.level_robin_matrices(meshes, [lambda x: 1.0 + 0.1 * x]
                                      * len(D))
    m0 = tml.build_multilevel(sys, meshes, D, MU)
    kw = {"D": dict(D_values=D * 1.5), "mu": dict(mu_values=MU + 1.0),
          "method": dict(coarse_inverse="newton_schulz"),
          "robin_batch": dict(robin_matrices_levels=rb)}[change]
    args = {"D_values": D, "mu_values": MU, **kw}
    m1, n = _counts_after(lambda: tml.build_multilevel(sys, meshes, **args))
    assert n[tml.AINV_TAG] == {"memo": 0, "disk": 0, "miss": 1}
    assert n[tml.TRANSFER_TAG]["miss"] == 0
    assert m1.Ainv is not m0.Ainv
    assert not torch.equal(m1.Ainv, m0.Ainv)


def test_a_changed_transfer_input_misses(cache):
    """The Stokes velocity hierarchy's walls differ from the transport
    system's: other ``free`` rows, other transfers."""
    mesh = generate_mesh(**KW)
    meshes = tml.level_meshes_for(mesh)
    sys = tsw.build_transport_system(mesh, "cpu")
    tml.build_multilevel(sys, meshes, D, MU)
    sysv = tsw.build_transport_system(mesh, "cpu",
                                      dirichlet=tsf.VELOCITY_DIRICHLET,
                                      with_robin=False)
    _, n = _counts_after(lambda: tml.build_multilevel(
        sysv, meshes, np.ones(2), np.zeros(2),
        dirichlet=tsf.VELOCITY_DIRICHLET, with_robin=False))
    assert n[tml.TRANSFER_TAG]["miss"] == len(meshes)
    assert n[tml.TRANSFER_TAG]["memo"] == 0


def test_study_meshes_are_memoised():
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params)
    p = make_no_adv_params(1.0, mesh_size_dim=0.15)
    assert make_mesh(p, "sulcus") is make_mesh(p, "sulcus")
    m = make_mesh(p, "sulcus")
    a, b = tml.level_meshes_for(m), tml.level_meshes_for(m)
    assert all(x is y for x, y in zip(a, b)) and a[0] is m
    # a content-equal mesh of another object gets a system on itself
    other = generate_mesh(**dict(KW, mesh_size=0.15))
    s1 = tsw.build_transport_system(m, "cpu")
    s2 = tsw.build_transport_system(other, "cpu")
    assert s1.space.mesh is m and s2.space.mesh is other
    assert s2.K is s1.K


# ---------------------------------------------------------------------------
# the Stokes field
# ---------------------------------------------------------------------------

SKW = dict(KW, mesh_size=0.15)


def test_stokes_field_round_trip(cache):
    mesh = generate_mesh(**SKW)
    u0, p0 = tsf.stokes_solve(mesh, 1.0, "cpu")
    assert u0.solver_info["converged"]
    assert u0.solver_info["method"] == "minres+mg"
    assert len(list(cache.glob("port-stokes-*.npz"))) == 1
    u1, p1 = tsf.stokes_solve(generate_mesh(**SKW), 1.0, "cpu")
    assert _hits(tsf.STOKES_TAG) == {"memo": 0, "disk": 1, "miss": 1}
    assert np.array_equal(u1.values, u0.values)
    assert np.array_equal(p1.values, p0.values)
    i0, i1 = u0.solver_info, u1.solver_info
    assert i1["method"] == "minres+mg+cache" and i1["solve_s"] == 0.0
    for k in ("outer_iters", "passes", "resnorm", "rel_resnorm",
              "converged"):
        assert i1[k] == i0[k], k
    # each keyed input, changed alone, misses
    for kw in (dict(H=1.1), dict(rtol=1e-8), dict(n_smooth=2),
               dict(coarse_inverse="newton_schulz")):
        args = {"H": 1.0, **kw}
        _, n = _counts_after(lambda: tsf.stokes_solve(mesh, device="cpu",
                                                      **args))
        assert n[tsf.STOKES_TAG] == {"memo": 0, "disk": 0, "miss": 1}, kw
    with pytest.raises(TypeError, match="unknown Stokes cycle options"):
        tsf.stokes_solve(mesh, 1.0, "cpu", cycle="add")


def test_stokes_field_not_converged_is_not_stored(cache, monkeypatch):
    mesh = generate_mesh(**SKW)
    solve = tsf.stokes_solve_mg

    def stalled(*a, **k):
        u, p = solve(*a, **k)
        u.solver_info["converged"] = False
        return u, p

    monkeypatch.setattr(tsf, "stokes_solve_mg", stalled)
    tsf.stokes_solve(mesh, 1.0, "cpu")
    assert not list(cache.glob("port-stokes-*.npz"))
    tsf.stokes_solve(mesh, 1.0, "cpu")
    assert _hits(tsf.STOKES_TAG) == {"memo": 0, "disk": 0, "miss": 2}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_memo_is_keyed_by_device(tmp_path, monkeypatch):
    """A system built on the CPU is not handed out for the card: the card's
    build binds its blocks' kernels and holds its tensors there; a disk
    hit on the card equals the card's miss bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("FEU_CACHE_DIR", str(tmp_path))
    dc.clear_memos()
    mesh = generate_mesh(**KW)
    s_cpu = tsw.build_transport_system(mesh, "cpu")
    s_gpu = tsw.build_transport_system(mesh, "cuda")
    assert s_gpu is not s_cpu
    assert s_gpu.Kband.device.type == "cuda" and s_gpu.K.kernels
    assert tsw.build_transport_system(mesh, "cuda") is s_gpu
    dc.clear_memos()
    s_disk = tsw.build_transport_system(generate_mesh(**KW), "cuda")
    assert s_disk.K.kernels and s_disk is not s_gpu
    _same(s_disk, s_gpu, "sys")
    dc.clear_memos()
