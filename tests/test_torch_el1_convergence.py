"""The port's E_L1 refinement ladder (``studies/el1_convergence.py``)
against the JAX script ``scripts/el1_convergence.py``, on the CPU.

* (a) The port's mesher at h = 0.07, refinement factors 1, 2 and 4, on the
  w0.4/d2.0 family is the JAX package's bit for bit (vertices, cells,
  markers).
* (b) Rungs 1 and 2 at h = 0.07, Pe 0.1 and 1: the port's ``run_factor``
  against the JAX script's (loaded with importlib, its golden read falling
  back to {} without the reference CSV), the disk cache off, each package
  in its CPU configuration as tests/test_torch_no_uptake.py runs them:
  cells and hmin exactly, E_L1, Q_in and Q_out to 1e-8 relative,
  J_open_total (a net flux: both Stokes solves stop at a relative residual
  of 1e-9) to 1e-9 absolute.  The port's rows carry exactly the JAX rows'
  keys.
* (c) ``richardson`` and ``el1_row_agrees`` give the JAX script's and
  ``scripts/compare_goldens.py``'s results on every committed ladder
  series, and ``summarise`` of every committed ladder's rungs gives its
  committed summaries (the older schema's too).
* (d) ``--extend`` keeps the rungs already written and solves only the
  missing (factor, Pe) pairs; ``--check`` without a family runs exactly the
  committed pairs.
* (e) Factors 1 and 2 share no mesh or system memo; a ladder leaves no
  memo behind (``release``), and a rung run again after the release gives
  the same bits.
* (f) ``EL1_CERTIFICATES_H100.json`` re-derives: E*, the rate and the
  verdict recomputed from its rungs are its summaries and its table's.
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.studies import el1_convergence as el

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
H = 0.07
PE = [0.1, 1.0]
CERTS = ROOT / "EL1_CERTIFICATES_H100.json"


def _load_script(name, monkeypatch=None):
    """A script of ``scripts/`` as a module (the JAX ladder script's
    ``setup`` call made a no-op: tests/conftest.py has set x64 and the
    CPU, and the compile-cache directory stays as it is)."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        from fenics_eff_uptake_tpu.utils import jaxconfig
        mp.setattr(jaxconfig, "setup", lambda *a, **k: None)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jel():
    return _load_script("el1_convergence")


@pytest.fixture(scope="module")
def ladders(tmp_path_factory):
    """The port's rungs 1 and 2 (one ladder, memos released between and
    after), the JAX script's, and the port's rung 1 again."""
    jel = _load_script("el1_convergence")
    out = tmp_path_factory.mktemp("el1")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEU_DISK_CACHE", "0")
        _, port, _, stats = el.run_family(0.4, 2.0, PE, [1, 2], H, str(out),
                                          device="cpu", verbose=False)
        memos_after = _memo_sizes()
        again = el.run_factor(PE, 0.4, 2.0, H, 1, "cpu")
        el.release("cpu")
        jax_rows = [r for f in (1, 2)
                    for r in jel.run_factor(PE, 0.4, 2.0, H, f)]
    return port, stats, memos_after, again, jax_rows


def _memo_sizes():
    from fenics_eff_uptake_tpu_torch.utils import diskcache
    return [len(m) for m in diskcache._MEMOS]


def _mesh_args(factor):
    p = el._make_params(PE[0], 0.4, 2.0, H)
    p.refinement_factor = factor
    return dict(domain_type="sulcus", **p.get_mesh_generator_params())


@pytest.mark.parametrize("factor,cells", [(1, 4523), (2, 5059), (4, 5670)])
def test_refined_mesh_is_the_jax_mesh(factor, cells):
    from fenics_eff_uptake_tpu.meshing.generator import generate_mesh as jgen
    from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
    kw = _mesh_args(factor)
    assert kw["refinement_factor"] == factor
    a, b = generate_mesh(**kw), jgen(**kw)
    assert a.num_cells == b.num_cells == cells
    for name in ("vertices", "cells", "bc_marker", "cell_domain"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), name)
    assert a.mesh_info() == b.mesh_info()


def test_rungs_match_the_jax_script(ladders):
    port, stats, _, _, ref = ladders
    assert [s["factor"] for s in stats] == [1, 2]
    assert [s["cells"] for s in stats] == [4523, 5059]
    assert len(port) == len(ref) == 4
    for g, r in zip(port, ref):
        assert tuple(g) == el.ROW_KEYS == tuple(r)
        for k in ("factor", "pe", "w", "d", "mesh_size_dim", "cells",
                  "hmin"):
            assert g[k] == r[k], k
        for k in ("E_L1", "Q_in", "Q_out"):
            assert abs(g[k] - r[k]) <= 1e-8 * abs(r[k]), (g["factor"],
                                                           g["pe"], k)
        assert abs(g["J_open_total"] - r["J_open_total"]) <= 1e-9
        assert g["max_rel_resnorm"] <= 1e-12
    for s in stats:
        assert s["stokes_rel_resnorm"] <= 1e-9
        assert max(s["rel_resnorm"]) <= 1e-12
        assert s["peak_mem_gb"] is None
        assert set(s["bands"]) == {"K", "Adv"}
        for shape, fill in s["bands"].values():
            assert len(shape) == 3 and 0 < fill <= 1


def test_factors_share_no_memo():
    from fenics_eff_uptake_tpu_torch.parallel.sweep import _system_key
    from fenics_eff_uptake_tpu_torch.simulation import get_mesh
    from fenics_eff_uptake_tpu_torch.studies.common import _MESH_MEMO
    el.release("cpu")
    meshes = []
    for f in (1, 2):
        p = el._make_params(PE[0], 0.4, 2.0, H)
        p.refinement_factor = f
        meshes.append(get_mesh(p, "sulcus"))
    assert len(_MESH_MEMO) == 2
    m1, m2 = meshes
    assert m1 is not m2 and m1.num_cells != m2.num_cells
    keys = {_system_key(m, "P2", None, None, None, True) for m in meshes}
    assert len(keys) == 2
    el.release("cpu")
    assert len(_MESH_MEMO) == 0


def test_release_leaves_no_memo_and_the_same_bits(ladders):
    port, _, memos_after, again, _ = ladders
    assert memos_after and not any(memos_after)
    first = [r for r in port if r["factor"] == 1]
    assert len(again) == len(first) == 2
    for a, b in zip(again, first):
        assert {k: v for k, v in a.items() if k != "wall_s"} == \
            {k: v for k, v in b.items() if k != "wall_s"}


def _committed_series():
    """(file, Pe, series) of every committed ladder: each summary's
    ladder, and each Pe's rungs of each file."""
    out = []
    for path in sorted(el.LADDER_DIR.glob("ladder_*.jsonl")):
        _, _, rows, summaries = el.read_ladder(path)
        for s in summaries:
            out.append((path.name, s["pe"], [tuple(x) for x in s["ladder"]]))
        for pe in sorted({r["pe"] for r in rows}):
            out.append((path.name, pe, sorted(
                (r["factor"], r["E_L1"]) for r in rows if r["pe"] == pe)))
    return out


def test_richardson_and_rule_match_the_jax_scripts(jel):
    cg = _load_script("compare_goldens")
    series = _committed_series()
    assert len({name for name, _, _ in series}) == 15
    n_rich = 0
    for name, pe, s in series:
        got, want = el.richardson(s), jel.richardson(s)
        assert got == want, (name, pe)
        n_rich += got is not None
        for tol in (1e-3, 5e-2):
            assert el.richardson(s, tol) == jel.richardson(s, tol)
    assert n_rich >= 40
    rng = np.random.default_rng(3)
    for g, o1, e, ge, oe in rng.random((200, 5)) * [1, 1, 1, 0.4, 0.4]:
        assert el.el1_row_agrees(g, o1, e, ge, oe) == \
            cg.el1_row_agrees(g, o1, e, ge, oe)


def test_summaries_of_committed_rungs_are_the_committed_summaries():
    cg = _load_script("compare_goldens")
    fams = el.committed_families()
    assert len(fams) == 13
    assert sum(len(f["files"]) for f in fams.values()) == 15
    verdicts = []
    for path in sorted(el.LADDER_DIR.glob("ladder_*.jsonl")):
        w, d, rows, summaries = el.read_ladder(path)
        goldens = el.goldens_for(w, d, "/nonexistent.csv")[0]
        for want in summaries:
            factors = {f for f, _ in want["ladder"]}
            sub = [r for r in rows
                   if r["pe"] == want["pe"] and r["factor"] in factors]
            got = el.summarise(sub, w, d, {want["pe"]: want["golden"]}
                               if "golden" in want else {})[0]
            for k in ("ladder", "extrapolated_E_L1", "observed_rate_p",
                      "converged_tail", "tail_rel_step", "golden",
                      "golden_err_vs_star", "ours_f1_err_vs_star"):
                assert got.get(k) == want.get(k), (path.name, k)
            v = el.verdict(got)
            if v in ("agree", "CHECK"):
                assert (v == "agree") == cg.el1_row_agrees(
                    want["golden"], want["ladder"][0][1],
                    want["extrapolated_E_L1"], want["golden_err_vs_star"],
                    want["ours_f1_err_vs_star"])
                assert abs(goldens[want["pe"]] - want["golden"]) <= \
                    1e-7 * want["golden"]
            verdicts.append(((path.name, want["pe"]), v))
    table = dict(verdicts)
    assert table[("ladder_w0.4_d2.jsonl", 0.1)] == "CHECK"
    assert sum(v == "agree" for v in table.values()) == 37
    assert sum(v is None for v in table.values()) == 2


def test_old_schema_is_read_into_the_current_one():
    w, d, rows, summ = el.read_ladder(
        el.LADDER_DIR / "ladder_pe0.1_w0.10_d2.0.jsonl")
    assert (w, d) == (0.1, 2.0)
    assert [(r["factor"], r["pe"], r["w"], r["d"]) for r in rows] == [
        (f, 0.1, 0.1, 2.0) for f in (1, 2, 4, 8)]
    assert len(summ) == 1 and summ[0]["pe"] == 0.1
    assert summ[0]["extrapolated_E_L1"] == pytest.approx(0.04080865654171352,
                                                         rel=0)
    assert el.verdict(summ[0]) == "agree"
    _, _, rows, summ = el.read_ladder(
        el.LADDER_DIR / "ladder_pe0.1_w0.05_d1.0.jsonl")
    assert len(rows) == 4 and summ == []


def _fake_rung(calls):
    def run_rung(pe_list, w, d, h, factor, device="cuda", verbose=True):
        calls.append((factor, tuple(pe_list)))
        rows = [{"factor": factor, "pe": pe, "w": w, "d": d,
                 "mesh_size_dim": h, "cells": 100 * factor, "hmin": 1.0,
                 "E_L1": 0.2 - 0.1 / factor / pe, "Q_in": 0.1, "Q_out": 0.1,
                 "J_open_total": 0.0, "max_rel_resnorm": 0.0, "wall_s": 0.0}
                for pe in pe_list]
        return rows, {"factor": factor}
    return run_rung


def test_extend_solves_only_missing_pairs(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(el, "run_rung", _fake_rung(calls))
    out = str(tmp_path)
    el.run_family(0.4, 2.0, [0.1, 1.0, 10.0], [1, 2], 0.02, out,
                  device="cpu")
    assert calls == [(1, (0.1, 1.0, 10.0)), (2, (0.1, 1.0, 10.0))]
    first = el.read_ladder(el.ladder_path(out, 0.4, 2.0))[2]
    calls.clear()
    _, rows, summ, _ = el.run_family(0.4, 2.0, [0.1, 1.0], [1, 2, 4, 8],
                                     0.02, out, extend=True, device="cpu")
    assert calls == [(4, (0.1, 1.0)), (8, (0.1, 1.0))]
    assert all(r in rows for r in first)
    assert len(rows) == 6 + 4
    assert [s["pe"] for s in summ] == [0.1, 1.0, 10.0]
    assert [f for f, _ in summ[0]["ladder"]] == [1, 2, 4, 8]
    assert [f for f, _ in summ[2]["ladder"]] == [1, 2]
    # without --extend the file is written anew
    calls.clear()
    _, rows, _, _ = el.run_family(0.4, 2.0, [0.1], [1], 0.02, out,
                                  device="cpu")
    assert calls == [(1, (0.1,))] and len(rows) == 1
    # --check alone: every committed family at exactly its pairs
    calls.clear()
    monkeypatch.setattr(el, "check_family",
                        lambda rows, w, d, *a, **k: {"w": w, "d": d})
    el.main(["--check", "--device", "cpu", "--out", str(tmp_path / "c")])
    fams = el.committed_families()
    want = [(f, tuple(pes)) for fam in fams.values()
            for f, pes in el.family_pairs(fam["rows"]).items()]
    assert calls == want
    assert len(list((tmp_path / "c").glob("check_*.json"))) == 13


def test_check_holds_rungs_and_summaries(monkeypatch):
    fam = el.committed_families()[(0.4, 2.0)]
    rows = [dict(r) for r in fam["rows"]]
    rec = el.check_family(rows, 0.4, 2.0, fam)
    assert rec["ok"] and rec["rungs_compared"] == 9
    assert rec["no_uptake_rows_compared"] == 3
    assert rec["summaries_compared"] == 3
    assert rec["worst"]["E_L1"]["err"] == 0.0
    # a rung off by 2e-6 fails, and so does a summary whose verdict moves
    bad = [dict(r) for r in rows]
    bad[0]["E_L1"] *= 1 + 2e-6
    with pytest.raises(AssertionError, match="factor 1 Pe 0.1"):
        el.check_family(bad, 0.4, 2.0, fam)
    bad = [dict(r) for r in rows]
    bad[2]["cells"] += 1
    with pytest.raises(AssertionError, match="cells"):
        el.check_family(bad, 0.4, 2.0, fam)


def test_certificates_file_rederives():
    doc = json.loads(CERTS.read_text())
    assert doc["card"] and "H100" in doc["card"]
    fams = {(f["w"], f["d"]): f for f in doc["families"]}
    assert set(fams) == {(0.4, 2.0), (0.8, 0.6)}
    assert {r["factor"] for r in fams[(0.4, 2.0)]["rows"]} >= {8, 16}
    assert {r["factor"] for r in fams[(0.8, 0.6)]["rows"]} == {1, 2, 4}
    for (w, d), f in fams.items():
        for r in f["rows"]:
            assert tuple(r) == el.ROW_KEYS
            assert r["max_rel_resnorm"] <= 1e-11
        goldens = {s["pe"]: s["golden"] for s in f["summaries"]
                   if "golden" in s}
        got = el.summarise(f["rows"], w, d, goldens)
        assert len(got) == len(f["summaries"])
        for g, s in zip(got, f["summaries"]):
            assert g == s
            assert el.verdict(g) == el.verdict(s)
    assert all(s.get("golden") is None
               for s in fams[(0.8, 0.6)]["summaries"])
    table = {(c["w"], c["d"], c["pe"]): c for c in doc["certificates"]}
    for (w, d), f in fams.items():
        for s in f["summaries"]:
            if "extrapolated_E_L1" not in s:
                continue
            c = table[(w, d, s["pe"])]
            assert c["E_star"] == s["extrapolated_E_L1"]
            assert c["verdict"] == el.verdict(s)
    for c in doc["certificates"]:
        assert (c["golden"] is None) == (c["verdict"] == "no golden")
        if c["golden"] is not None:
            ge = abs(c["golden"] - c["E_star"]) / abs(c["E_star"])
            oe = abs(c["ours_f1"] - c["E_star"]) / abs(c["E_star"])
            assert math.isclose(ge, c["golden_err_vs_star"], rel_tol=1e-12)
            assert c["verdict"] == ("agree" if el.el1_row_agrees(
                c["golden"], c["ours_f1"], c["E_star"], ge, oe)
                else "CHECK")
            assert c["golden_source"]
    assert all(c["verdict"] == "no golden" for k, c in table.items()
               if k[:2] == (0.8, 0.6))
    checks = {(c["w"], c["d"]): c for c in doc["checks"]}
    assert len(checks) >= 13
    assert all(c["ok"] for c in checks.values())
