#!/usr/bin/env python3
"""Where the mixed BiCGStab solve breaks down under a cycle that rounds to
bf16: a traced copy of ``parallel.sweep._bicgstab_solve``.

    python3 scripts/bicgstab_bf16_breakdown.py [--mesh-size 0.06]
        [--device cpu] [--every 20]

Builds the no-uptake transport system of the reference geometry (Stokes
velocity, Pe = 0.1, 1, 10; the mult cycle) and runs the f32 BiCGStab
passes inside f64 defect correction under the f32 cycle, under
``transfer_dtype=bf16`` and under ``ml_dtype=bf16``, with the solver's own
guards, recording in every iteration each column's residual norm and the
scalars the guards protect (rho, the alpha denominator (rhat, v), (t, t),
alpha, omega, beta).  Prints each pass's trajectory every ``--every``
iterations and, per column, the first iteration of the first pass in which
a scalar, the residual or the correction is not finite, with the values of
the iterations before it, and which guard (if any) was the one that passed
it.  It stops at the first such pass.  Last it runs ``solve_sweep`` itself
under each configuration and prints its iterations beside the traced
copy's (equal up to the pass at which the trace stopped; a last pass at the
rounding floor may differ by a few iterations).
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw          # noqa: E402
from fenics_eff_uptake_tpu_torch.solvers import multilevel as tml      # noqa: E402
from fenics_eff_uptake_tpu_torch.studies.common import (               # noqa: E402
    make_mesh, stokes_for_study)
from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params  # noqa: E402

PECLET = [0.1, 1.0, 10.0]
SCALARS = ("rho", "denom", "tt", "alpha", "omega", "beta")


def traced_pass(a32, M, R64, tol, every):
    """One inner pass of ``_bicgstab_solve`` on the opening residual R64,
    term for term, with a record per iteration.  Returns (iterations per
    column, the records, the correction Dx)."""
    B = R64.shape[1]
    rn0 = tsw._colnorm(R64)
    R = R64.float()
    tol_in = torch.maximum(tsw.INNER_RTOL * rn0, 0.1 * tol).float()
    Rhat = R
    rho = alpha = omega = torch.ones(B, dtype=R.dtype, device=R.device)
    Dx = torch.zeros_like(R)
    P = torch.zeros_like(R)
    V = torch.zeros_like(R)
    cit = torch.zeros(B, dtype=torch.int64, device=R.device)
    log = []
    for it in range(tsw.N_INNER):
        rn = tsw._colnorm(R)
        active = rn > tol_in
        if not bool(active.any()):
            break
        rho_new = torch.sum(Rhat * R, dim=0)
        beta = torch.where(
            active,
            (rho_new / torch.where(rho != 0, rho, 1.0))
            * (alpha / torch.where(omega != 0, omega, 1.0)), 0.0)
        P = torch.where(active, R + beta * (P - omega * V), P)
        Phat = M(P)
        V = tsw.apply_operator(a32, Phat)
        denom = torch.sum(Rhat * V, dim=0)
        alpha = torch.where(active & (denom != 0),
                            rho_new / torch.where(denom != 0, denom, 1.0),
                            0.0)
        S = R - alpha * V
        Shat = M(S)
        T = tsw.apply_operator(a32, Shat)
        tt = torch.sum(T * T, dim=0)
        omega = torch.where(active & (tt != 0),
                            torch.sum(T * S, dim=0)
                            / torch.where(tt != 0, tt, 1.0), 0.0)
        Dx = Dx + alpha * Phat + omega * Shat
        R = torch.where(active, S - omega * T, R)
        rho = rho_new
        cit = cit + active
        log.append({"it": it, "active": active.tolist(),
                    "rn": (rn / rn0).tolist(), "rho": rho_new.tolist(),
                    "denom": denom.tolist(), "tt": tt.tolist(),
                    "alpha": alpha.tolist(), "omega": omega.tolist(),
                    "beta": beta.tolist(),
                    "rn_after": (tsw._colnorm(R) / rn0).tolist(),
                    "dx": Dx.abs().amax(dim=0).tolist()})
        if it % every == 0:
            print(f"    it {it:3d} |r|/|r0| "
                  + " ".join(f"{v:10.3e}" for v in log[-1]["rn"])
                  + "  alpha " + " ".join(f"{v:10.3e}" for v in alpha.tolist())
                  + "  omega " + " ".join(f"{v:10.3e}" for v in omega.tolist()),
                  flush=True)
    return cit.tolist(), log, Dx


def first_nonfinite(log, b):
    """(record index, names) of column b's first record holding a value
    that is not finite; (None, ()) if there is none."""
    for i, rec in enumerate(log):
        bad = [k for k in (*SCALARS, "rn_after", "dx")
               if not np.isfinite(rec[k][b])]
        if bad:
            return i, bad
    return None, ()


def report(log):
    """Per column, whether the pass's values stayed finite.  Returns True
    if some did not."""
    found = False
    for b, pe in enumerate(PECLET):
        i, bad = first_nonfinite(log, b)
        peak = max((r["rn_after"][b] for r in log
                    if np.isfinite(r["rn_after"][b])), default=float("nan"))
        if i is None:
            print(f"    Pe={pe}: every value finite; largest |r|/|r0| "
                  f"{peak:.3e}, last {log[-1]['rn_after'][b]:.3e}")
            continue
        found = True
        rec = log[i]
        print(f"    Pe={pe}: first value that is not finite in iteration "
              f"{rec['it']}: {bad}; largest finite |r|/|r0| before it "
              f"{peak:.3e}")
        for r in log[max(i - 2, 0):i + 1]:
            print("      it {it}: |r|/|r0| {0:.3e} -> {1:.3e} ".format(
                r["rn"][b], r["rn_after"][b], it=r["it"])
                + " ".join(f"{k} {r[k][b]:.3e}" for k in SCALARS)
                + f" max|dx| {r['dx'][b]:.3e}")
        # the guards test their denominators against zero only: one lets a
        # value through when its denominator is not zero (it may be
        # infinite) and the quotient is not finite all the same
        passed = [f"{k}: its guard {den} != 0 passed {den} = {rec[den][b]}"
                  for k, den in (("alpha", "denom"), ("omega", "tt"))
                  if k in bad and rec[den][b] != 0
                  and not np.isnan(rec[den][b])]
        print("      guard that passed it: "
              + ("; ".join(passed) if passed else
                 "none: the operands were not finite before any guarded "
                 "quotient"))
    return found


def traced_solve(name, a64, a32, M, RHS, X0, tol, every):
    """The pass loop of ``_bicgstab_solve`` around ``traced_pass``; stops
    after the first pass that held a value that is not finite.  Returns
    the iterations per column."""
    X = X0
    R64 = torch.where(a64.free[:, None], RHS, 0.0)
    bn = tsw._colnorm(RHS)
    tot = np.zeros(RHS.shape[1], dtype=np.int64)
    for k in range(1, tsw.MAX_PASSES_BICGSTAB + 1):
        print(f"  {name}, pass {k}: opening true |r|/|b| "
              f"{[f'{v:.3e}' for v in (tsw._colnorm(R64) / bn).tolist()]}",
              flush=True)
        cit, log, Dx = traced_pass(a32, M, R64, tol, every)
        tot += np.asarray(cit)
        print(f"  {name}, pass {k}: iterations {cit}", flush=True)
        if log and report(log):
            break
        X = X + Dx.double()
        R64 = RHS - tsw.apply_operator(a64, X)
        if not bool((tsw._colnorm(R64) > tol).any()):
            break
    return tot.tolist()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh-size", type=float, default=0.06)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--every", type=int, default=20)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    p0 = _make_params(PECLET[0], 0.5, 1.0, args.mesh_size)
    mesh = make_mesh(p0, "sulcus")
    u, _ = stokes_for_study(mesh, p0.H, dev)
    D = [1.0 / pe for pe in PECLET]
    mu0 = [0.0] * len(D)
    sys_ = tsw.build_transport_system(mesh, dev, u_values=u.values,
                                      u_space=u.space)
    ml = tml.build_multilevel_for(sys_, mesh, D, mu0, u_fine=u)
    print(f"h = {args.mesh_size}: {mesh.num_cells} cells, {sys_.ndofs} "
          f"padded dofs, {len(ml.levels)} smoothed levels, device {dev}, "
          f"{torch.get_num_threads()} threads", flush=True)
    a64 = tsw.operator_args(sys_, D, mu0, f32=False)
    a32 = tsw.operator_args(sys_, D, mu0, f32=True)
    G = sys_.bc_values[:, None].expand(-1, len(D)).contiguous()
    RHS = tsw.operator_rhs(a64, G)
    R64 = torch.where(a64.free[:, None], RHS, 0.0)   # the opening residual
    tol = 1e-12 * tsw._colnorm(RHS)
    bf16 = torch.bfloat16
    for name, kw in (("f32 cycle", {}),
                     ("transfer_dtype=bf16", {"transfer_dtype": bf16}),
                     ("ml_dtype=bf16", {"dtype": bf16})):
        M = tml.make_ml_preconditioner(ml, cycle="mult", **kw)
        # how far one application is from the f32 cycle's, and from linear
        M32 = tml.make_ml_preconditioner(ml, cycle="mult")
        r = R64.float()
        d = ((M(r) - M32(r)).abs().amax(0) / M32(r).abs().amax(0)).tolist()
        lin = ((M(2 * r) - 2 * M(r)).abs().amax(0)
               / M(r).abs().amax(0)).tolist()
        print(f"{name}: max |M r - M_f32 r| / max |M_f32 r| per column "
              f"{[f'{v:.2e}' for v in d]}; |M(2r) - 2 M(r)| / |M r| "
              f"{[f'{v:.2e}' for v in lin]}", flush=True)
        tot = traced_solve(name, a64, a32, M, RHS, G, tol, args.every)
        print(f"  {name}: traced iterations {tot}", flush=True)
        skw = {("ml_dtype" if k == "dtype" else k): v for k, v in kw.items()}
        _, info = tsw.solve_sweep(sys_, D, mu0, multilevel=ml, **skw)
        print(f"  solve_sweep: iterations {info['iters'].tolist()} in "
              f"{info['passes']} passes, true relative residuals "
              f"{[f'{v:.3e}' for v in info['true_rel_resnorm']]}, converged "
              f"{info['converged'].tolist()}", flush=True)


if __name__ == "__main__":
    main()
