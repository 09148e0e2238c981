#!/usr/bin/env python3
"""Time variants of the tensor-core (bf16) forms of kernels A and B on the
card, at the shapes the paths give them (h = 0.02).

    python3 scripts/band_tc_variants.py [--calls 50] [--repeats 3]
        [--variants base,nopf,...]

A variant is ``ops/csrc/band_apply.cu`` with pieces of its text replaced
(``VARIANTS``: the copy ring's depth, the L2 prefetch size of the 16-byte
copies), compiled by nvcc with the package's flags into
``build/tc_variants/<name>.so`` (all variants at once) and called through
ctypes; the source in the package is left as it is.  Each variant runs the
bf16 cases (A on the fine and mid K bands at B = 20 and on the advection
band at B = 3; B in both forms on the fine restriction and prolongation at
B = 20 and on the transport restriction at B = 3), and its output must
equal the package's kernel's bit for bit: the variants change how the
operands travel, not the arithmetic.  Device ms per call are
torch.profiler's CUDA records over ``--repeats`` runs of ``--calls``
calls, one trace per case and variant, the variants one after another
within each case.  The last line is one JSON object with every time.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "fenics_eff_uptake_tpu_torch" / "ops" / "csrc" / "band_apply.cu"
OUT = ROOT / "build" / "tc_variants"
B_SWEEP = 20
PECLET = [0.1, 1.0, 10.0]
_STAGES = "constexpr int kTcStages = 4;"
_PF = "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;"
VARIANTS = {
    "base": [],
    "nopf": [(_PF, "cp.async.cg.shared.global [%0], [%1], 16, %2;")],
    "pf256": [(_PF, "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, "
                    "%2;")],
    "stages3": [(_STAGES, "constexpr int kTcStages = 3;")],
    "stages6": [(_STAGES, "constexpr int kTcStages = 6;")],
}


def build(names):
    """Compile the variants in parallel; {name: (band, rect) entries}."""
    sys.path.insert(0, str(ROOT))
    from fenics_eff_uptake_tpu_torch.ops import _build
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name]:
            if old not in src:
                raise ValueError(f"variant {name}: {old!r} not in {SRC}")
            src = src.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(OUT / f"{name}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, p in procs.items():
        log = p.communicate(timeout=900)[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        a, b = lib.feu_band_apply_bf16, lib.feu_rect_band_apply_bf16
        a.argtypes = [P, P, P, P, P, I, I, I, I, P]
        b.argtypes = [P, P, P, P, P, I, I, I, L, I, I, P]
        a.restype = b.restype = I
        fns[name] = (a, b)
    return fns


def device_ms(fn, calls, repeats, warmup=3):
    """Per-call device ms of each of ``repeats`` runs, from one trace."""
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
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    os.environ.setdefault("FEU_CACHE_DIR", str(ROOT / "build" / "cache"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("band_tc_variants: needs a CUDA device")
    from fenics_eff_uptake_tpu_torch.device import setup
    from fenics_eff_uptake_tpu_torch.ops import _build, banded
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel_for)
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params, stokes_for_study)
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    names = args.variants.split(",")
    fns = build(names)
    dev = setup("cuda")
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
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(n, B, dtype):
        return (torch.rand((n, B), generator=g, device=dev) * 2
                - 1).to(dtype)

    cases = []
    coef20 = (torch.rand(B_SWEEP, generator=g, device=dev) + 0.5).to(bf16)
    for label, s, band, spans, B, coef in (
            ("A fine K", sys_, sys_.Kband, sys_.Kspans, B_SWEEP, coef20),
            ("A mid K", ml.levels[1].sys, ml.levels[1].sys.Kband,
             ml.levels[1].sys.Kspans, B_SWEEP, coef20),
            ("A Adv", adv, adv.Advband, adv.Advspans, 3, None)):
        cases.append((f"{label} {tuple(band.shape)} B={B}", "A",
                      band.to(bf16), spans, None,
                      rnd(band.shape[0] * band.shape[1], B, bf16), coef))
    for name, tb, B, ways in (("fine", ml.levels[0].bands, B_SWEEP,
                               ("restrict", "prolong")),
                              ("transport", aml.levels[0].bands, 3,
                               ("restrict",))):
        for way in ways:
            band, offs, spans, rows = (
                (tb.r, tb.ro, tb.rs, tb.pad_r) if way == "restrict"
                else (tb.p, tb.po, tb.ps, tb.pad_p))
            for xd, form in ((torch.float32, "f32 X"), (bf16, "all bf16")):
                cases.append((f"B {form} {name} {way} {tuple(band.shape)} "
                              f"B={B}", "B", band.to(bf16), spans, offs,
                              rnd(rows, B, xd), None))

    stream = _build.raw_stream(dev.index or 0)
    results = []
    for label, kind, band, spans, offs, X, coef in cases:
        T, R, W = band.shape
        if kind == "A":
            want = banded.band_apply(band, X, coef, spans=spans)
        else:
            want = banded.rect_band_apply(band, offs, X, spans)
        row = {"case": label}
        calls = {}
        for name in names:
            fa, fb = fns[name]
            Y = torch.empty_like(want)
            if kind == "A":
                def call(fa=fa, Y=Y):
                    err = fa(band.data_ptr(), spans.data_ptr(), X.data_ptr(),
                             None if coef is None else coef.data_ptr(),
                             Y.data_ptr(), T, R, W, X.shape[1], stream)
                    if err:
                        raise RuntimeError(f"{label}: CUDA error {err}")
            else:
                def call(fb=fb, Y=Y):
                    err = fb(band.data_ptr(), spans.data_ptr(),
                             offs.data_ptr(), X.data_ptr(), Y.data_ptr(), T,
                             R, W, X.shape[0], X.shape[1],
                             int(X.dtype == bf16), stream)
                    if err:
                        raise RuntimeError(f"{label}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if not torch.equal(Y.view(torch.uint8), want.view(torch.uint8)):
                raise AssertionError(f"{label}: variant {name} differs from "
                                     "the package's kernel")
            calls[name] = call
        for name in names:
            ms = device_ms(calls[name], args.calls, args.repeats)
            row[name] = ms
            print(f"[tc] {label} {name}: "
                  + ("not measured" if ms is None else
                     ", ".join(f"{v:.4f}" for v in ms) + " ms"), flush=True)
        results.append(row)
    print(json.dumps({"card": card, "variants": {n: VARIANTS[n]
                                                 for n in names},
                      "cases": results}))


if __name__ == "__main__":
    main()
