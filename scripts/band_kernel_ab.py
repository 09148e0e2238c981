#!/usr/bin/env python3
"""Time kernels A and B of one tree of the port on the card, at the shapes
both paths give them (h = 0.02), for comparing two trees in one call.

    python3 scripts/band_kernel_ab.py [--tree DIR] [--reps N] [--tag TAG]

``--tree`` is the root of a checkout of this repository (default: the
one holding this script); its ``fenics_eff_uptake_tpu_torch`` is imported
and its kernels are built in its own ``build/``.  The script uses only
entry points that every tree of the port has, and passes the bands'
column spans where the tree's wrappers take them.  Each case prints the
kernel's median time over ``--reps`` launches (CUDA events); the last line
is one JSON object with every case.  Run trees in turns (parent, change,
change, parent) within one call, on one card.  (``chip_smoke.py`` times
each case's library call beside the plain version.)
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


def median_ms(fn, reps, warmup=5):
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tag", default="")
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
        build_transport_system)
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

    def run_a(label, band, spans, B, coef):
        X = rnd(band.shape[0] * band.shape[1], B)
        kw = {"spans": spans} if spans_ok else {}
        ms = median_ms(lambda: banded.band_apply(band, X, coef, **kw),
                       args.reps)
        cases.append({"case": label, "ms": ms})

    def run_b(label, band, offs, spans, rows, B):
        Xq = rnd(rows, B)
        extra = (spans,) if spans_ok else ()
        ms = median_ms(lambda: banded.rect_band_apply(band, offs, Xq,
                                                      *extra), args.reps)
        cases.append({"case": label, "ms": ms})

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
    for c in cases:
        print(f"[ab {args.tag}] {c['case']}: kernel {c['ms']:.4f} ms",
              flush=True)
    print(json.dumps({"tag": args.tag, "tree": str(tree), "card": card,
                      "spans": spans_ok, "setup_s": setup_s,
                      "cases": cases}))


if __name__ == "__main__":
    main()
