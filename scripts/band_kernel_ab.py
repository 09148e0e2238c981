#!/usr/bin/env python3
"""Time kernels A, B and C of one tree of the port on the card, at the
shapes both paths give them (h = 0.02), for comparing two trees in one
call.

    python3 scripts/band_kernel_ab.py [--tree DIR] [--calls N] [--tag TAG]
        [--save FILE] [--against FILE] [--rows-variant]

``--tree`` is the root of a checkout of this repository (default: the
one holding this script); its ``fenics_eff_uptake_tpu_torch`` is imported
and its kernels are built in its own ``build/``.  The script uses only
entry points that every tree of the port has, and passes the bands'
column spans where the tree's wrappers take them.  Kernel C runs through
``_Block.apply_batched`` in the full form and in the Robin blocks' add
form: ``apply_batched(X, coef, out=Y)`` where the tree has it, else the
separate ``Y + apply_batched(X, coef)`` (kernel and add both timed).

Each case prints the device time per call (torch.profiler's CUDA records
over ``--calls`` calls, summed, over the calls) and the per-call time
(median CUDA event interval around the Python call).  With
``--rows-variant``, each C case is also timed through the
one-thread-per-output variant of ``scripts/element_rows_variant.cu``
(launched over the touched rows in the add form), built here with nvcc,
and its outputs must equal the tree's bit for bit.  ``--save`` writes every
case's output on fixed inputs (a seeded generator for A and B, numpy seeds
for C) to FILE; ``--against`` compares this tree's outputs with such a file
bit for bit, case by case where both have the case, and prints the largest
difference.  A tree whose kernels take bf16 operands also runs the bf16
cases, after the f32 ones and on inputs of their own, so that the f32
cases see the same inputs in every tree: A on the fine and mid K bands
(B = 20), the fine advection band and the transport hierarchy's mid K band
(B = 3), B in both forms on the fine transfers (B = 20) and on the
transport hierarchy's (B = 3), C on the fine Robin block in the out= form
(B = 20); f32 against bf16 of one tree can then be read from one run.  The
bf16 forms of A and B sum in another order from one tree to another (the
tensor cores' against ascending FMA chains), so ``--against`` holds their
outputs to the kernels' bf16 criterion, not bit for bit: a bf16 Y equal in
at least 99% of the entries and each within one bf16 ulp or 1e-5 of its
sum of |terms| (which ``--save`` stores beside the outputs), an f32 Y
within 1e-5 of it.  ``--repeats N`` times every case over N runs of
``--calls`` calls in one profiler trace and reports each run's time
(``ms_all``) and their median.  The last line is one
JSON object with every case.  Run trees in turns (parent, change, change,
parent) within one call, on one card.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

B_SWEEP = 20
PECLET = [0.1, 1.0, 10.0]
VARIANT_SRC = Path(__file__).resolve().parent / "element_rows_variant.cu"


def device_ms(fn, calls, repeats=1, warmup=3):
    """Device ms per call of fn in each of ``repeats`` runs of ``calls``
    calls, from one torch.profiler trace: its CUDA records in launch order,
    cut into ``repeats`` equal runs (every call of fn puts the same records
    on the card), each run's durations summed over the calls.  A trace
    without CUDA records is taken again, at most twice; then None."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls * repeats):
                fn()
            torch.cuda.synchronize()
        recs = sorted((e.time_range.start, e.time_range.elapsed_us())
                      for e in prof.events()
                      if str(e.device_type).endswith("CUDA"))
        if recs and len(recs) % repeats == 0:
            n = len(recs) // repeats
            return [sum(us for _, us in recs[k * n:(k + 1) * n]) / calls
                    / 1e3 for k in range(repeats)]
        print(f"[ab] profiler trace with {len(recs)} CUDA records, taken "
              "again", flush=True)
    return None


def call_ms(fn, reps, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bf16_ulps(a, b):
    """Distance of two bf16 tensors in bf16 steps, elementwise."""
    import torch

    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def bf16_criterion(got, ref, S):
    """The bf16 kernels' criterion of ``got`` against ``ref``, S each
    output's sum of |terms|: a bf16 output equal in >= 99% of the entries,
    each within one bf16 ulp or 1e-5 S; an f32 output within 1e-5 S."""
    import torch
    diff = (got.float() - ref.float()).abs()
    near = diff <= 1e-5 * S
    out = {"max_diff_over_terms": float((diff / S.clamp_min(1e-30)).max())}
    if got.dtype == torch.bfloat16:
        d = bf16_ulps(got, ref)
        share = float((d == 0).float().mean())
        out.update(max_ulps=int(d.max()), equal_share=share,
                   criterion=bool(((d <= 1) | near).all()) and share >= 0.99)
    else:
        out.update(max_ulps=None, equal_share=float((diff == 0).float()
                                                    .mean()),
                   criterion=bool(near.all()))
    return out


def build_variant(tree):
    """The ctypes entry of scripts/element_rows_variant.cu, compiled with
    the tree's nvcc flags into the tree's build/ab_variant/."""
    import ctypes
    from fenics_eff_uptake_tpu_torch.ops import _build
    out = tree / "build" / "ab_variant" / "librows_variant.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(out), str(VARIANT_SRC)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {VARIANT_SRC}:\n{res.stdout}")
    fn = ctypes.CDLL(str(out)).feu_rows_variant
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, P, P, P, P, P, P, P, P, I, I, I, P]
    fn.restype = I
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--tag", default="")
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--repeats", type=int, default=1,
                    help="runs of --calls calls per case (median reported)")
    ap.add_argument("--rows-variant", action="store_true",
                    help="also time kernel C's one-thread-per-output "
                         "variant (scripts/element_rows_variant.cu)")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    os.environ.setdefault("FEU_CACHE_DIR", str(tree / "build" / "cache"))
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("band_kernel_ab: needs a CUDA device")
    from fenics_eff_uptake_tpu_torch.device import setup
    from fenics_eff_uptake_tpu_torch.models.stokes_flow import (
        VELOCITY_DIRICHLET)
    from fenics_eff_uptake_tpu_torch.ops import banded
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        _Block, build_transport_system)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel, build_multilevel_for, level_meshes_for)
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params, stokes_for_study)
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = setup("cuda")
    spans_ok = "spans" in inspect.signature(banded.band_apply).parameters
    out_ok = "out" in inspect.signature(_Block.apply_batched).parameters
    variant = build_variant(tree) if args.rows_variant else None
    t0 = time.time()
    geom = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                              mesh_size_dim=0.02)
    mesh = make_mesh(geom)
    sys_ = build_transport_system(mesh, dev)
    ml = build_multilevel_for(sys_, mesh, [geom.D] * B_SWEEP,
                              np.linspace(0.1, 150.0, B_SWEEP))
    p = _make_params(PECLET[0], 0.5, 1.0, 0.02)
    fmesh = make_mesh(p, "sulcus")
    u, _ = stokes_for_study(fmesh, p.H, dev)
    adv = build_transport_system(fmesh, dev, u_values=u.values,
                                 u_space=u.space)
    aml = build_multilevel_for(adv, fmesh, [1.0 / pe for pe in PECLET],
                               [0.0] * 3, u_fine=u)
    vel = build_transport_system(fmesh, dev, dirichlet=VELOCITY_DIRICHLET,
                                 with_robin=False)
    vml = build_multilevel(vel, level_meshes_for(fmesh), np.ones(2),
                           np.zeros(2), dirichlet=VELOCITY_DIRICHLET,
                           with_robin=False)
    setup_s = time.time() - t0
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(n, B):
        return torch.rand((n, B), generator=g, device=dev) * 2 - 1

    def sp(obj, name):
        return getattr(obj, name) if spans_ok else None

    cases = []
    outputs = {}
    terms = {}          # the bf16 cases' sums of |terms|, per output

    def timed(label, fn):
        ms = device_ms(fn, args.calls, args.repeats)
        cases.append({"case": label,
                      "ms": None if ms is None else float(np.median(ms)),
                      "ms_all": ms, "call_ms": call_ms(fn, args.calls)})

    def run_a(label, band, spans, B, coef):
        X = rnd(band.shape[0] * band.shape[1], B)
        kw = {"spans": spans} if spans_ok else {}
        outputs[label] = banded.band_apply(band, X, coef, **kw).cpu()
        timed(label, lambda: banded.band_apply(band, X, coef, **kw))

    def run_b(label, band, offs, spans, rows, B):
        Xq = rnd(rows, B)
        extra = (spans,) if spans_ok else ()
        outputs[label] = banded.rect_band_apply(band, offs, Xq,
                                                *extra).cpu()
        timed(label, lambda: banded.rect_band_apply(band, offs, Xq, *extra))

    coef20 = torch.rand(B_SWEEP, generator=g, device=dev) + 0.5
    run_a(f"A fine K {tuple(sys_.Kband.shape)} B=20", sys_.Kband,
          sp(sys_, "Kspans"), B_SWEEP, coef20)
    mid = ml.levels[1].sys
    run_a(f"A mid K {tuple(mid.Kband.shape)} B=20", mid.Kband,
          sp(mid, "Kspans"), B_SWEEP, coef20)
    run_a(f"A Adv band {tuple(adv.Advband.shape)} B=3", adv.Advband,
          sp(adv, "Advspans"), 3, None)
    run_a(f"A velocity band {tuple(vel.Kband.shape)} B=2", vel.Kband,
          sp(vel, "Kspans"), 2, torch.ones(2, device=dev))
    run_a(f"A velocity band {tuple(vel.Kband.shape)} B=96", vel.Kband,
          sp(vel, "Kspans"), 96, torch.rand(96, generator=g, device=dev)
          + 0.5)
    for label, tb, B in (("fine", ml.levels[0].bands, B_SWEEP),
                         ("transport", aml.levels[0].bands, 3),
                         ("velocity", vml.levels[0].bands, 2),
                         ("velocity", vml.levels[0].bands, 96)):
        run_b(f"B {label} restrict {tuple(tb.r.shape)} B={B}", tb.r, tb.ro,
              sp(tb, "rs"), tb.pad_r, B)
        run_b(f"B {label} prolong {tuple(tb.p.shape)} B={B}", tb.p, tb.po,
              sp(tb, "ps"), tb.pad_p, B)

    # kernel C on fixed numpy inputs, so that two trees see the same X

    def np_inputs(seed, n, B, dtype, with_coef):
        rng = np.random.default_rng(seed)
        X = torch.as_tensor(rng.random((n, B)) * 2 - 1, dtype=dtype,
                            device=dev)
        Y0 = torch.as_tensor(rng.random((n, B)), dtype=dtype, device=dev)
        c = (torch.as_tensor(rng.random(B) + 0.5, dtype=dtype, device=dev)
             if with_coef else None)
        return X, Y0, c

    def run_c(seed, name, blk, B, dtype, form, with_coef=True):
        X, Y0, c = np_inputs(seed, blk.ndofs, B, dtype, with_coef)
        A = blk.A64 if dtype == torch.float64 else blk.A32
        label = f"C {name} A{tuple(A.shape)} B={B} {form}"
        if form == "full":
            def fn():
                return blk.apply_batched(X, c)
            outputs[label] = fn().cpu()
        elif out_ok:
            Y = Y0.clone()
            outputs[label] = blk.apply_batched(X, c, out=Y0.clone()).cpu()

            def fn():
                return blk.apply_batched(X, c, out=Y)
        else:
            outputs[label] = (Y0 + blk.apply_batched(X, c)).cpu()

            def fn():
                return Y0 + blk.apply_batched(X, c)
        timed(label, fn)
        if variant is None:
            return
        sc = blk.scatter
        rows = None if form == "full" else sc.tiles.rows
        n_rows = blk.ndofs if rows is None else rows.numel()
        stream = torch.cuda.current_stream().cuda_stream

        def fv(Y):
            err = variant(int(dtype == torch.float64), A.shape[1],
                          A.data_ptr(), blk.dofs.data_ptr(),
                          sc.perm.data_ptr(), sc.rowptr.data_ptr(),
                          None if rows is None else rows.data_ptr(),
                          X.data_ptr(), None if c is None else c.data_ptr(),
                          Y.data_ptr(), n_rows, B, int(rows is not None),
                          stream)
            if err:
                raise RuntimeError(f"{label}: rows variant, CUDA error {err}")
            return Y
        got = fv(torch.empty_like(X) if rows is None else Y0.clone())
        if not torch.equal(got.cpu(), outputs[label]):
            raise AssertionError(f"{label}: the rows variant differs")
        Yv = torch.empty_like(X) if rows is None else Y0.clone()
        timed(f"{label} rows-variant", lambda: fv(Yv))

    f64, f32 = torch.float64, torch.float32
    run_c(1, "f64 K", sys_.K, B_SWEEP, f64, "full")
    run_c(2, "f64 R", sys_.R, B_SWEEP, f64, "full")
    run_c(3, "f32 R", sys_.R, B_SWEEP, f32, "full")
    run_c(4, "f32 mid R", ml.levels[1].sys.R, B_SWEEP, f32, "full")
    run_c(5, "f64 Adv", adv.Adv, 3, f64, "full", with_coef=False)
    run_c(6, "f64 R", sys_.R, B_SWEEP, f64, "out")
    run_c(7, "f32 R", sys_.R, B_SWEEP, f32, "out")
    run_c(8, "f32 mid R", ml.levels[1].sys.R, B_SWEEP, f32, "out")
    run_c(9, "f32 R", adv.R, 3, f32, "out")
    run_c(10, "f32 mid R", aml.levels[1].sys.R, 3, f32, "out")

    # the bf16 operand forms, where the tree has them
    if hasattr(banded, "BAND_APPLY_DTYPES"):
        bf16 = torch.bfloat16
        g16 = torch.Generator(device=dev).manual_seed(16)

        def rnd16(n, B, dtype):
            return (torch.rand((n, B), generator=g16, device=dev) * 2
                    - 1).to(dtype)

        amid = aml.levels[1].sys
        coef3 = (torch.rand(3, generator=g16, device=dev) + 0.5).to(bf16)
        for label, band, spans, B, coef in (
                (f"A bf16 mid K {tuple(mid.Kband.shape)} B=20", mid.Kband,
                 mid.Kspans, B_SWEEP, coef20.to(bf16)),
                (f"A bf16 Adv band {tuple(adv.Advband.shape)} B=3",
                 adv.Advband, adv.Advspans, 3, None),
                (f"A bf16 fine K {tuple(sys_.Kband.shape)} B=20",
                 sys_.Kband, sys_.Kspans, B_SWEEP, coef20.to(bf16)),
                (f"A bf16 mid K {tuple(amid.Kband.shape)} B=3", amid.Kband,
                 amid.Kspans, 3, coef3)):
            b16 = band.to(bf16)
            X = rnd16(band.shape[0] * band.shape[1], B, bf16)
            outputs[label] = banded.band_apply(b16, X, coef,
                                               spans=spans).cpu()
            terms[label] = banded.band_apply_plain(
                b16.float().abs(), X.float().abs(),
                None if coef is None else coef.float()).cpu()
            timed(label, lambda: banded.band_apply(b16, X, coef,
                                                   spans=spans))
        for name, tb, B in (("fine", ml.levels[0].bands, B_SWEEP),
                            ("transport", aml.levels[0].bands, 3)):
            for way, band, offs, spans, rows in (
                    ("restrict", tb.r, tb.ro, tb.rs, tb.pad_r),
                    ("prolong", tb.p, tb.po, tb.ps, tb.pad_p)):
                b16 = band.to(bf16)
                for xd, form in ((torch.float32, "bf16 band, f32 X"),
                                 (bf16, "all bf16")):
                    Xq = rnd16(rows, B, xd)
                    label = (f"B {form} {name} {way} {tuple(band.shape)} "
                             f"B={B}")
                    outputs[label] = banded.rect_band_apply(b16, offs, Xq,
                                                            spans).cpu()
                    terms[label] = banded.rect_band_apply_plain(
                        b16.float().abs(), offs,
                        Xq.to(bf16).float().abs()).cpu()
                    timed(label, lambda: banded.rect_band_apply(
                        b16, offs, Xq, spans))
        R16 = sys_.R.with_bf16()
        X, Y0, c = np_inputs(11, R16.ndofs, B_SWEEP, bf16, True)
        label = f"C bf16 R A{tuple(R16.A16.shape)} B={B_SWEEP} out"
        outputs[label] = R16.apply_batched(X, c, out=Y0.clone()).cpu()
        Y = Y0.clone()
        timed(label, lambda: R16.apply_batched(X, c, out=Y))

    same = None
    if args.against:
        ref = torch.load(args.against)
        ref_terms = ref.get("terms", {})
        ref = ref.get("outputs", ref)
        same = {}
        for label, Y in outputs.items():
            if label not in ref:
                continue
            d = float((Y.double() - ref[label].double()).abs().max())
            same[label] = {"bitwise": bool(torch.equal(
                Y.view(torch.uint8), ref[label].view(torch.uint8))),
                "max_abs_diff": d}
            S = terms.get(label, ref_terms.get(label))
            if S is not None:
                same[label].update(bf16_criterion(Y, ref[label], S))
            print(f"[ab {args.tag}] {label}: against {args.against} "
                  f"bitwise {same[label]['bitwise']} max |diff| {d:.3e}"
                  + ("" if S is None else
                     f"; bf16 criterion {same[label]['criterion']} (max "
                     f"{same[label]['max_ulps']} ulp, "
                     f"{100 * same[label]['equal_share']:.3f}% equal, max "
                     "|diff| / |terms| "
                     f"{same[label]['max_diff_over_terms']:.2e})"),
                  flush=True)
    if args.save:
        Path(args.save).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"outputs": outputs, "terms": terms}, args.save)
    for c in cases:
        dev_ms = ("not measured" if c["ms"] is None else
                  f"{c['ms']:.4f} ms (runs "
                  + ", ".join(f"{v:.4f}" for v in c["ms_all"]) + ")")
        print(f"[ab {args.tag}] {c['case']}: device {dev_ms}, per call "
              f"{c['call_ms']:.4f} ms", flush=True)
    print(json.dumps({"tag": args.tag, "tree": str(tree), "card": card,
                      "spans": spans_ok, "out_form": out_ok,
                      "setup_s": setup_s, "cases": cases,
                      "against": same}))


if __name__ == "__main__":
    main()
