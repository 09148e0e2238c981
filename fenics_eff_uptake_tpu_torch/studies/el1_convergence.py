"""E_L1 mouth-flux refinement ladders (counterpart of the repository's
``scripts/el1_convergence.py``).

Mouth E_L1 integrates |J.n| across the sulcus mouth, whose integrand has
corner singularities at the mouth lips, so at h = 0.02 no discretisation
has converged it.  A ladder refines the mesh locally around the sulcus
boundary (``Parameters.refinement_factor``: lc_fine = lc / factor) and
Richardson-extrapolates E_L1 over the last three rungs; the certificate
rule then asks whether the FEniCS golden converges onto that limit.

One rung is one Stokes solve feeding ONE batched transport solve over every
requested Pe (D* = 1/Pe, mu = 0), then the batched metrics: the no-uptake
study's path, on a mouth-refined mesh.  A rung whose Stokes or transport
solve did not converge raises and writes no row.  Between rungs every
in-process memo is emptied (and the card's cache released), so a ladder
never holds more than one rung's bands.

    python -m fenics_eff_uptake_tpu_torch.studies.el1_convergence \\
        (--w W --d D | --families w:d ...) [--pe 0.1 1 10] \\
        [--factors 1 2 4 8] [--mesh 0.02] [--out build/el1_convergence] \\
        [--extend] [--device cuda] [--check] [--golden-csv PATH]
    python -m fenics_eff_uptake_tpu_torch.studies.el1_convergence --check
    python -m fenics_eff_uptake_tpu_torch.studies.el1_convergence \\
        --certificates FILE [--families w:d ...] [--out DIR]

Each family writes ``<out>/ladder_w{w}_d{d}.jsonl``: one row per (factor,
Pe) with the keys of the JAX script's rows, then one summary per Pe of the
merged rows (``--extend`` keeps the rows already there and solves only the
missing (factor, Pe) pairs).  ``--check`` holds every rung against the
committed JAX rung of the same (w, d, factor, Pe) under
``examples/el1_convergence/`` (and a factor-1 rung at h = 0.02 against the
no-uptake artifact's row, where it has one), and every summary that a
committed ladder also has against it (``CHECK_TOL``), writing
``<out>/check_w{w}_d{d}.json``; without a family it runs every committed
ladder at exactly its committed (factor, Pe) pairs.  ``--certificates``
runs nothing: it writes the card line, each check record, the rows and
summaries of the named families and the certificate table (with each
golden's source) of every ladder under ``--out`` to FILE.

Goldens (the FEniCS E_L1 of a (w, d, Pe)) come from ``--golden-csv``
(default: the reference's ``geometry_comparison_results.csv`` under
``reference/`` in the repository, ``GOLDEN_CSV``) where that file exists
and has the row, else from the committed summary of the same (w, d, Pe),
else there is none ("no golden").  No pandas: the CSV is read with
``csv``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import time
from pathlib import Path

import torch

from ..analysis.batched_metrics import build_sweep_metrics, metrics_to_dicts
from ..device import card_line, setup
from ..models.stokes_flow import OUTER_RTOL
from ..ops.banded import span_elements
from ..simulation import get_mesh
from ..utils.diskcache import clear_memos
from .artifacts import EXAMPLES, Q_FLOOR, TOL, nu_key, read_rows
from .common import _sync, stokes_for_study, transport_batch
from .no_uptake import _make_params

__all__ = ["run_factor", "run_rung", "richardson", "el1_row_agrees",
           "verdict", "summarise", "run_family", "read_ladder",
           "committed_families", "family_pairs", "goldens_for",
           "check_family", "certificate_table", "write_certificates",
           "release", "ROW_KEYS", "CHECK_TOL", "GOLDEN_CSV", "LADDER_DIR",
           "OUT_DIR"]

# the FEniCS reference's no-uptake table, where a checkout of the reference
# is placed at reference/ in the repository (the JAX script reads the same
# file of a checkout beside it)
GOLDEN_CSV = (EXAMPLES.parent / "reference" / "No Uptake Simulations"
              / "Geometry Comparison Analysis"
              / "geometry_comparison_results.csv")
LADDER_DIR = EXAMPLES / "el1_convergence"
NU_CSV = (EXAMPLES / "no_uptake_tpu_h0.02" / "Geometry Comparison Analysis"
          / "geometry_comparison_results.csv")
OUT_DIR = "build/el1_convergence"
ROW_KEYS = ("factor", "pe", "w", "d", "mesh_size_dim", "cells", "hmin",
            "E_L1", "Q_in", "Q_out", "J_open_total", "max_rel_resnorm",
            "wall_s")
# rung against the committed rung: the study artifacts' 1e-6 relative, the
# net flux over max(|Q_in|, Q_FLOOR) as studies/artifacts.py scales it;
# summary against summary: E* moves by up to r/(1-r) times the rungs'
# change (r/(1-r) ~ 14 at w0.4/d2.0, Pe 0.1), the rate by its log ratio
CHECK_TOL = {"hmin": 1e-12, "rel": TOL, "net": TOL, "E_star": 1e-3,
             "rate": 0.02}
# the no-uptake artifact's columns of a factor-1 rung at h = 0.02
NU_COLUMNS = {"E_L1": "Mouth E_L1", "Q_in": "Mouth Q_in",
              "Q_out": "Mouth Q_out", "J_open_total": "Mouth_Flux_Total"}
_NAME = re.compile(r"ladder_(?:pe([0-9.]+)_)?w([0-9.]+)_d([0-9.]+)\.jsonl$")


def release(device):
    """Empty every in-process memo (meshes, systems, transfers, coarsest
    inverses) and hand the card's cached blocks back: what a rung built
    is freed before the next one is."""
    clear_memos()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_rung(pe_list, w, d, mesh_size_dim, factor, device="cuda",
             verbose=True):
    """One refinement rung on ``device``: Stokes, then one batched
    transport solve over ``pe_list``, then the batched metrics.  Raises if
    the Stokes solve or a transport column did not converge.

    Returns (rows, stats): the rows with ``ROW_KEYS``, and the rung's
    cells, bands (T, R, W) and span fills, iterations and passes, stage
    seconds (each ending in a device sync) and peak card memory (None on
    the CPU)."""
    device = setup(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    p = _make_params(pe_list[0], w, d, mesh_size_dim)
    p.refinement_factor = int(factor)
    mesh = get_mesh(p, "sulcus")
    mi = mesh.mesh_info()
    t_mesh = time.time()
    u, _ = stokes_for_study(mesh, p.H, device)
    si = u.solver_info
    if not (si["converged"] and si["rel_resnorm"] <= OUTER_RTOL):
        raise RuntimeError(
            f"rung w={w} d={d} factor={factor}: Stokes did not converge "
            f"({si['outer_iters']} MINRES iterations in {si.get('passes')} "
            f"passes, relative residual {si['rel_resnorm']:.3e})")
    t_stokes = _sync(device)
    D_batch = [1.0 / pe for pe in pe_list]
    mu0 = [0.0] * len(pe_list)
    X, info, sys_, ts = transport_batch(mesh, u, D_batch, mu0, device)
    t_solve = _sync(device)
    sm = build_sweep_metrics(sys_.space, mesh, 1.0, X.device, u=u)
    params_list = [_make_params(pe, w, d, mesh_size_dim) for pe in pe_list]
    flux_list, _, _ = metrics_to_dicts(sm, mesh, X, mu0, params_list,
                                       D_values=D_batch)
    t_end = _sync(device)
    wall = t_end - t0
    rows = []
    for pe, fm in zip(pe_list, flux_list):
        pf = fm.get("sulcus_specific", {}).get("physical_flux", {})
        extra = pf.get("sulcus_opening_extra", {})
        rows.append({
            "factor": factor, "pe": pe, "w": w, "d": d,
            "mesh_size_dim": mesh_size_dim,
            "cells": mi["num_cells"], "hmin": mi["hmin"],
            "E_L1": extra.get("E_L1"), "Q_in": extra.get("Q_in"),
            "Q_out": extra.get("Q_out"),
            "J_open_total": pf.get("sulcus_opening", {}).get("total"),
            "max_rel_resnorm": float(max(info["rel_resnorm"])),
            "wall_s": wall})
    bands = {name: (tuple(band.shape), span_elements(band, spans)
                    / band.numel())
             for name, band, spans in (("K", sys_.Kband, sys_.Kspans),
                                       ("Adv", sys_.Advband, sys_.Advspans))
             if band is not None}
    stats = {
        "factor": factor, "w": w, "d": d, "pe": list(pe_list),
        "cells": mi["num_cells"], "hmin": mi["hmin"],
        "ndofs": int(sys_.space.ndofs), "bands": bands,
        "minres_iters": si["outer_iters"], "minres_passes": si.get("passes"),
        "stokes_rel_resnorm": si["rel_resnorm"],
        "iters": info["iters"].tolist(), "passes": info.get("passes"),
        "rel_resnorm": info["true_rel_resnorm"].tolist(),
        "mesh_s": t_mesh - t0, "stokes_s": t_stokes - t_mesh,
        "assembly_s": ts["assembly_s"], "ml_setup_s": ts["ml_setup_s"],
        "solve_s": ts["solve_s"], "metrics_s": t_end - t_solve,
        "total_s": wall,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if cuda else None)}
    if verbose:
        print(rung_line(stats), flush=True)
    return rows, stats


def rung_line(s):
    """One printed line of a rung's stats."""
    bands = " ".join(f"{k} {v[0]} fill {v[1]:.3f}"
                     for k, v in s["bands"].items())
    mem = ("not measured" if s["peak_mem_gb"] is None
           else f"{s['peak_mem_gb']:.2f} GB")
    return (f"  [rung w={s['w']:g} d={s['d']:g} factor={s['factor']}] "
            f"{s['cells']} cells, hmin {s['hmin']:.6g}, {s['ndofs']} P2 "
            f"dofs; bands {bands}; MINRES {s['minres_iters']} iters / "
            f"{s['minres_passes']} passes (rel {s['stokes_rel_resnorm']:.2e})"
            f", BiCGStab iters {s['iters']} in {s['passes']} passes (max rel "
            f"{max(s['rel_resnorm']):.2e}); mesh {s['mesh_s']:.3f}s stokes "
            f"{s['stokes_s']:.3f}s assembly {s['assembly_s']:.3f}s ml_setup "
            f"{s['ml_setup_s']:.3f}s solve {s['solve_s']:.3f}s metrics "
            f"{s['metrics_s']:.3f}s total {s['total_s']:.3f}s; peak card "
            f"memory {mem}")


def run_factor(pe_list, w, d, mesh_size_dim, factor, device="cuda"):
    """One refinement rung's rows (``run_rung`` without its stats)."""
    return run_rung(pe_list, w, d, mesh_size_dim, factor, device)[0]


def richardson(series, conv_tol=5e-3):
    """E* from the last 3 rungs of E(factor); assumes E = E* + C h^p.

    Falls back to a converged-tail certificate when the geometric-ratio
    extrapolation is unavailable but the last increment is already at
    noise level (|E(4f) - E(2f)| <= conv_tol * |E(4f)|): the ladder has
    flattened, so the last rung is the limit to within tail_rel_step."""
    if len(series) < 3:
        return None
    (f1, e1), (f2, e2), (f3, e3) = series[-3:]
    d1, d2 = e2 - e1, e3 - e2
    if d1 != 0 and 0 < d2 / d1 < 1:
        rate = d2 / d1
        return {"extrapolated_E_L1": e3 + d2 * rate / (1 - rate),
                "observed_rate_p": -math.log(rate) / math.log(f3 / f2)}
    if e3 != 0 and abs(d2) <= conv_tol * abs(e3):
        return {"extrapolated_E_L1": e3, "observed_rate_p": None,
                "converged_tail": True,
                "tail_rel_step": abs(d2) / abs(e3)}
    return None


def el1_row_agrees(g, ours1, e_star, ge, oe):
    """The certificate rule: the golden converges onto our Richardson
    limit E* when its distance to E* (ge) is at most our own h = 0.02
    rung's (oe) with 25% and 1% absolute slack, and at most 0.25."""
    return ge <= 1.25 * oe + 0.01 and ge <= 0.25


def verdict(summary):
    """"agree", "CHECK" or "no golden" of a summary with an E*; None for
    a summary without one."""
    if "extrapolated_E_L1" not in summary:
        return None
    g, ge = summary.get("golden"), summary.get("golden_err_vs_star")
    if g is None or ge is None:
        return "no golden"
    return ("agree" if el1_row_agrees(g, summary["ladder"][0][1],
                                      summary["extrapolated_E_L1"], ge,
                                      summary["ours_f1_err_vs_star"])
            else "CHECK")


def _key(x):
    return round(float(x), 9)


def read_ladder(path):
    """(w, d, rung rows, summaries) of a ladder file.  The older schema
    (``ladder_pe{pe}_w{w}_d{d}.jsonl``: rows without pe, w and d; the
    summary as lines without "summary") is read into the current one: the
    Pe and family from the file name, the summary lines merged into one
    summary over the file's rungs."""
    m = _NAME.search(os.path.basename(str(path)))
    if m is None:
        raise ValueError(f"not a ladder file name: {path}")
    w, d = float(m.group(2)), float(m.group(3))
    old_pe = None if m.group(1) is None else float(m.group(1))
    rows, summaries, fragments = [], [], {}
    with open(path) as fh:
        for line in fh:
            r = json.loads(line)
            if r.get("summary"):
                summaries.append(r)
            elif "factor" in r:
                if old_pe is not None:
                    r = {"factor": r["factor"], "pe": old_pe, "w": w,
                         "d": d, **r}
                rows.append(r)
            else:
                fragments.update(r)
    if fragments:
        series = sorted((r["factor"], r["E_L1"]) for r in rows)
        summaries.append({"summary": True, "pe": old_pe, "w": w, "d": d,
                          "ladder": [list(s) for s in series],
                          **fragments})
    return w, d, rows, summaries


def committed_families(ladder_dir=LADDER_DIR):
    """{(w, d): {"files", "rows", "summaries"}} of every committed ladder
    file, the files of one family together (in file-name order)."""
    fams = {}
    for path in sorted(Path(ladder_dir).glob("ladder_*.jsonl")):
        w, d, rows, summaries = read_ladder(path)
        f = fams.setdefault((w, d), {"files": [], "rows": [],
                                     "summaries": []})
        f["files"].append(path.name)
        f["rows"] += rows
        f["summaries"] += [dict(s, file=path.name) for s in summaries]
    return fams


def family_pairs(rows):
    """{factor: [Pe, ...]} of the (factor, Pe) pairs of ``rows``, each
    once, both sorted."""
    pairs = {}
    for r in rows:
        pes = pairs.setdefault(r["factor"], [])
        if r["pe"] not in pes:
            pes.append(r["pe"])
    return {f: sorted(pairs[f]) for f in sorted(pairs)}


def _golden_csv_rows(path, w, d):
    """{Pe: E_L1} of the (w, d) sulcus rows of a golden CSV; {} when the
    file does not exist or does not read."""
    try:
        rows = read_rows(path)
        return {float(r["Peclet"]): float(r["Mouth E_L1"]) for r in rows
                if r["Domain"] == "sulcus"
                and abs(float(r["Sulcus Width (mm)"]) - w) < 1e-9
                and abs(float(r["Sulcus Depth (mm)"]) - d) < 1e-9}
    except (OSError, KeyError, ValueError):
        return {}


def goldens_for(w, d, golden_csv=GOLDEN_CSV, ladder_dir=LADDER_DIR):
    """({Pe: golden E_L1}, {Pe: its source}): the golden CSV's row where
    that file exists and has it, else the committed summary of the same
    (w, d, Pe) that carries one (of the current schema where there are
    two)."""
    goldens, source = {}, {}
    for pe, g in _golden_csv_rows(golden_csv, w, d).items():
        goldens[pe], source[pe] = g, str(golden_csv)
    fam = committed_families(ladder_dir).get((w, d))
    # the current schema's summaries first: the older files' goldens are
    # rounded
    for s in sorted((fam or {}).get("summaries", []),
                    key=lambda s: s["file"].startswith("ladder_pe")):
        pe = s["pe"]
        if pe not in goldens and s.get("golden") is not None:
            goldens[pe] = s["golden"]
            source[pe] = f"examples/el1_convergence/{s['file']} summary"
    return goldens, source


def summarise(rows, w, d, goldens):
    """One summary per Pe of ``rows`` (sorted), as the JAX script writes
    them: the ladder of (factor, E_L1), Richardson's E* and rate, and the
    golden's and our factor-1 rung's distance to E* where a golden is
    known."""
    out = []
    for pe in sorted({r["pe"] for r in rows}):
        series = sorted((r["factor"], r["E_L1"]) for r in rows
                        if r["pe"] == pe)
        summ = {"summary": True, "pe": pe, "w": w, "d": d,
                "ladder": [list(s) for s in series]}
        rich = richardson(series)
        if rich:
            summ.update(rich)
            e_star = rich["extrapolated_E_L1"]
            g = goldens.get(pe)
            if g is not None and e_star:
                summ["golden"] = g
                summ["golden_err_vs_star"] = abs(g - e_star) / abs(e_star)
                summ["ours_f1_err_vs_star"] = (abs(series[0][1] - e_star)
                                               / abs(e_star))
        out.append(summ)
    return out


def ladder_path(out_dir, w, d):
    return os.path.join(out_dir, f"ladder_w{w:g}_d{d:g}.jsonl")


def run_family(w, d, pe_list, factors, mesh_size_dim, out_dir,
               extend=False, device="cuda", golden_csv=GOLDEN_CSV,
               pairs=None, verbose=True):
    """One family's ladder: the (factor, Pe) pairs of ``factors`` x
    ``pe_list`` (or ``pairs``, {factor: [Pe, ...]}) that the output file
    does not hold yet (with ``extend``; without it the file is written
    anew), one rung per factor, memos released after each.  Writes the
    rows and a summary for every Pe of the merged rows.  Returns (path,
    rows, summaries, the stats of the rungs run)."""
    os.makedirs(out_dir, exist_ok=True)
    path = ladder_path(out_dir, w, d)
    all_rows = []
    if extend and os.path.exists(path):
        all_rows = read_ladder(path)[2]
    done = {(r["factor"], _key(r["pe"])) for r in all_rows}
    if pairs is None:
        pairs = {f: list(pe_list) for f in factors}
    stats = []
    for f in sorted(pairs):
        missing = [pe for pe in pairs[f] if (f, _key(pe)) not in done]
        if not missing:
            continue
        rows, st = run_rung(missing, w, d, mesh_size_dim, f, device,
                            verbose)
        release(device)
        stats.append(st)
        for r in rows:
            all_rows.append(r)
            print(json.dumps(r), flush=True)
    all_rows.sort(key=lambda r: (r["factor"], r["pe"]))
    summaries = summarise(all_rows, w, d, goldens_for(w, d, golden_csv)[0])
    with open(path, "w") as fh:
        for r in all_rows:
            fh.write(json.dumps(r) + "\n")
        for s in summaries:
            print(json.dumps(s), flush=True)
            fh.write(json.dumps(s) + "\n")
    return path, all_rows, summaries, stats


def _rung_errors(got, want):
    """{column: error} of a port rung against a reference rung: cells
    (difference) and hmin (absolute) where the reference has them, E_L1,
    Q_in, Q_out (relative) and J_open_total (absolute over max(|Q_in|,
    Q_FLOOR))."""
    errs = {}
    if "cells" in want:
        errs.update(cells=abs(int(got["cells"]) - int(want["cells"])),
                    hmin=abs(got["hmin"] - want["hmin"]))
    for k in ("E_L1", "Q_in", "Q_out"):
        errs[k] = abs(got[k] - want[k]) / abs(want[k])
    errs["J_open_total"] = (abs(got["J_open_total"] - want["J_open_total"])
                            / max(abs(want["Q_in"]), Q_FLOOR))
    return errs


def _rung_ok(errs):
    return (errs.get("cells", 0) == 0
            and errs.get("hmin", 0.0) <= CHECK_TOL["hmin"]
            and all(errs[k] <= CHECK_TOL["rel"]
                    for k in ("E_L1", "Q_in", "Q_out"))
            and errs["J_open_total"] <= CHECK_TOL["net"])


def _nu_artifact_rows(w, d):
    """{Pe: the no-uptake artifact's row of the (w, d) sulcus, in rung
    keys}."""
    out = {}
    for r in read_rows(NU_CSV):
        k = nu_key(r)
        if k[0] == "sulcus" and k[1] == _key(w) and k[2] == _key(d):
            out[k[3]] = {rk: float(r[col]) for rk, col in NU_COLUMNS.items()}
    return out


def _summary_errors(got, want):
    """(E* relative error, rate difference (0 where both are null, inf
    where one is), whether the verdicts are equal) of two summaries with
    an E*; None when either has none (then both must lack one)."""
    if "extrapolated_E_L1" not in want or "extrapolated_E_L1" not in got:
        return None
    e = (abs(got["extrapolated_E_L1"] - want["extrapolated_E_L1"])
         / abs(want["extrapolated_E_L1"]))
    pg, pw = got.get("observed_rate_p"), want.get("observed_rate_p")
    if pg is None and pw is None:
        dp = 0.0 if (got.get("converged_tail")
                     and want.get("converged_tail")) else math.inf
    elif pg is None or pw is None:
        dp = math.inf
    else:
        dp = abs(pg - pw)
    return e, dp, verdict(got) == verdict(want)


def check_family(rows, w, d, committed=None, golden_csv=GOLDEN_CSV,
                 mesh_size_dim=0.02):
    """Hold a family's port rungs to the committed JAX rungs of the same
    (factor, Pe) (every committed file that has one), its factor-1 rungs
    at h = 0.02 to the no-uptake artifact's rows, and, for every committed
    summary, the summary of the port rungs at the same factors to it.
    Returns the record (worst error per column with where, the counts,
    the failures); raises AssertionError listing every failure."""
    committed = committed or {"files": [], "rows": [], "summaries": []}
    ref = {}
    for r in committed["rows"]:
        ref.setdefault((r["factor"], _key(r["pe"])), []).append(r)
    nu = (_nu_artifact_rows(w, d) if _key(mesh_size_dim) == 0.02 else {})
    worst, failures, n_rungs, n_nu = {}, [], 0, 0

    def note(errs, where):
        for k, v in errs.items():
            if v > worst.get(k, (-1.0, None))[0]:
                worst[k] = (v, where)

    for r in rows:
        where = f"factor {r['factor']} Pe {r['pe']:g}"
        for want in ref.get((r["factor"], _key(r["pe"])), []):
            errs = _rung_errors(r, want)
            n_rungs += 1
            note(errs, where)
            if not _rung_ok(errs):
                failures.append(f"{where}: {errs}")
        if r["factor"] == 1 and _key(r["pe"]) in nu:
            errs = _rung_errors(r, nu[_key(r["pe"])])
            n_nu += 1
            note({f"no-uptake artifact {k}": v for k, v in errs.items()},
                 where)
            if not _rung_ok(errs):
                failures.append(f"{where} vs the no-uptake artifact: {errs}")
    summ = {}
    goldens = goldens_for(w, d, golden_csv)[0]
    for want in committed["summaries"]:
        factors = {f for f, _ in want["ladder"]}
        sub = [r for r in rows if _key(r["pe"]) == _key(want["pe"])
               and r["factor"] in factors]
        where = f"{want['file']} Pe {want['pe']:g}"
        if sorted(r["factor"] for r in sub) != sorted(factors):
            failures.append(f"{where}: the port ran factors "
                            f"{sorted(r['factor'] for r in sub)}, the "
                            f"summary is over {sorted(factors)}")
            continue
        got = summarise(sub, w, d, goldens)[0]
        errs = _summary_errors(got, want)
        if errs is None:
            if ("extrapolated_E_L1" in got) != ("extrapolated_E_L1" in want):
                failures.append(f"{where}: E* on one side only")
            summ[where] = {"E_star": None, "verdict": None}
            continue
        e, dp, same = errs
        summ[where] = {"E_star": got["extrapolated_E_L1"],
                       "E_star_jax": want["extrapolated_E_L1"],
                       "E_star_rel_err": e,
                       "rate": got.get("observed_rate_p"),
                       "rate_jax": want.get("observed_rate_p"),
                       "rate_abs_err": dp, "verdict": verdict(got),
                       "verdict_jax": verdict(want)}
        note({"E_star": e, "rate": dp}, where)
        if not (e <= CHECK_TOL["E_star"] and dp <= CHECK_TOL["rate"]
                and same):
            failures.append(f"{where}: {summ[where]}")
    record = {"w": w, "d": d, "files": committed["files"],
              "rungs_compared": n_rungs, "no_uptake_rows_compared": n_nu,
              "summaries_compared": len(summ),
              "worst": {k: {"err": v, "where": where}
                        for k, (v, where) in worst.items()},
              "summaries": summ, "failures": failures,
              "ok": not failures}
    for k, (v, where) in sorted(worst.items()):
        print(f"  [check w={w:g} d={d:g}] {k}: worst {v:.3e} ({where})",
              flush=True)
    if failures:
        raise AssertionError(f"w={w} d={d}: " + "; ".join(failures))
    return record


def check_path(out_dir, w, d):
    return os.path.join(out_dir, f"check_w{w:g}_d{d:g}.json")


def certificate_table(summaries, sources):
    """The certificate rows of the summaries that carry an E*: golden,
    ours at factor 1, E*, both distances to E*, rate, verdict and the
    golden's source ({(w, d, Pe): source}), in (w, d, Pe) order."""
    table = []
    for s in sorted(summaries, key=lambda s: (s["w"], s["d"], s["pe"])):
        if "extrapolated_E_L1" not in s:
            continue
        table.append({
            "w": s["w"], "d": s["d"], "pe": s["pe"],
            "factors": [f for f, _ in s["ladder"]],
            "golden": s.get("golden"), "ours_f1": s["ladder"][0][1],
            "E_star": s["extrapolated_E_L1"],
            "golden_err_vs_star": s.get("golden_err_vs_star"),
            "ours_f1_err_vs_star": s.get("ours_f1_err_vs_star"),
            "rate_p": s.get("observed_rate_p"),
            "converged_tail": bool(s.get("converged_tail")),
            "verdict": verdict(s),
            "golden_source": sources.get((s["w"], s["d"], s["pe"]))})
    return table


def write_certificates(path, out_dir, families, golden_csv=GOLDEN_CSV,
                       device="cuda"):
    """The certificate file of the ladders under ``out_dir``: the card
    line (None on the CPU), every check record there, the rows and
    summaries of ``families`` ((w, d) pairs), and the certificate table
    of every ladder there."""
    ladders = {}
    for p in sorted(Path(out_dir).glob("ladder_w*_d*.jsonl")):
        w, d, rows, summaries = read_ladder(p)
        ladders[(w, d)] = (rows, summaries)
    checks = [json.loads(p.read_text())
              for p in sorted(Path(out_dir).glob("check_w*_d*.json"))]
    sources, summaries = {}, []
    for (w, d), (_, summ) in ladders.items():
        src = goldens_for(w, d, golden_csv)[1]
        sources.update({(w, d, pe): s for pe, s in src.items()})
        summaries += summ
    fams = []
    for w, d in families:
        if (w, d) not in ladders:
            raise FileNotFoundError(f"no ladder of w={w} d={d} in {out_dir}")
        rows, summ = ladders[(w, d)]
        fams.append({"w": w, "d": d, "rows": rows, "summaries": summ})
    doc = {"card": card_line(device),
           "tolerances": CHECK_TOL,
           "checks": checks, "families": fams,
           "certificates": certificate_table(summaries, sources)}
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    for c in doc["certificates"]:
        print(f"  [certificate] w={c['w']:g} d={c['d']:g} Pe={c['pe']:g} "
              f"factors {c['factors']}: E* {c['E_star']:.6g} rate "
              f"{c['rate_p']} golden {c['golden']} -> {c['verdict']} "
              f"({c['golden_source']})", flush=True)
    return doc


def run_check(families, pe_list, factors, mesh_size_dim, out_dir, extend,
              device, golden_csv):
    """``--check``: each family's ladder (every committed family at its
    committed pairs when ``families`` is empty), then its check against
    the committed ladders, written beside it.  A family whose rung raised
    or whose check failed is recorded as failed and the next one runs;
    the run then exits non-zero."""
    committed = committed_families()
    todo = ([(w, d, family_pairs(f["rows"])) for (w, d), f in
             committed.items()] if not families
            else [(w, d, None) for w, d in families])
    failed = []
    for w, d, pairs in todo:
        print(f"### family w={w} d={d}", flush=True)
        try:
            _, rows, _, _ = run_family(w, d, pe_list, factors,
                                       mesh_size_dim, out_dir, extend,
                                       device, golden_csv, pairs)
            rec = check_family(rows, w, d, committed.get((w, d)),
                               golden_csv, mesh_size_dim)
        except (AssertionError, RuntimeError, ValueError) as e:
            # a rung that raised, or a check that failed: recorded, and the
            # other families still run
            failed.append(f"w={w} d={d}: {type(e).__name__}: {e}")
            print(f"  [check w={w:g} d={d:g}] FAILED: {failed[-1]}",
                  flush=True)
            release(device)
            rec = {"w": w, "d": d, "ok": False, "failures": [failed[-1]]}
        with open(check_path(out_dir, w, d), "w") as fh:
            json.dump(rec, fh, indent=1)
    if failed:
        raise SystemExit("el1 check failed: " + " | ".join(failed))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="E_L1 mouth-flux refinement ladders on PyTorch")
    ap.add_argument("--pe", type=float, nargs="+", default=[0.1, 1.0, 10.0])
    ap.add_argument("--w", type=float, default=None)
    ap.add_argument("--d", type=float, default=None)
    ap.add_argument("--families", nargs="+", default=None,
                    help="w:d pairs, e.g. 0.15:1.8 0.3:1.0")
    ap.add_argument("--mesh", type=float, default=0.02)
    ap.add_argument("--factors", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--extend", action="store_true",
                    help="keep prior rungs in the output; only run the "
                         "(factor, Pe) pairs it does not hold")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    ap.add_argument("--check", action="store_true",
                    help="hold every rung and summary to the committed "
                         "ladders; without a family, run every committed "
                         "ladder at its committed pairs")
    ap.add_argument("--golden-csv", default=GOLDEN_CSV)
    ap.add_argument("--certificates", default=None, metavar="FILE",
                    help="run nothing; write the certificate file of the "
                         "ladders and checks under --out")
    args = ap.parse_args(argv)

    fams = []
    if args.families:
        fams = [tuple(float(x) for x in s.split(":")) for s in args.families]
    elif args.w is not None and args.d is not None:
        fams = [(args.w, args.d)]
    if args.certificates:
        write_certificates(args.certificates, args.out, fams,
                           args.golden_csv, args.device)
        return
    if args.check:
        run_check(fams, args.pe, args.factors, args.mesh, args.out,
                  args.extend, args.device, args.golden_csv)
        return
    if not fams:
        ap.error("give --w/--d or --families (or --check alone)")
    for w, d in fams:
        print(f"### family w={w} d={d}", flush=True)
        run_family(w, d, args.pe, args.factors, args.mesh, args.out,
                   extend=args.extend, device=args.device,
                   golden_csv=args.golden_csv)


if __name__ == "__main__":
    main()
