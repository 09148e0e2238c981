"""``minres_iters_per_stokes``: the MINRES iterations of the Stokes saddle
solves (all passes) per solve, the program's own counters
(``utils.profiling.minres_steps`` over ``stokes_solves``), over every
solve the process ran before the window closed: the set-up's and the
window's (the harness keeps no per-request counter deltas, so the set-up
solve cannot be left out).  The counters are read where the program left
them (this reader imports nothing of it); nothing where the program has
none or ran no Stokes solve."""

import sys

PROGRAM = "fenics_eff_uptake_tpu_torch.utils.profiling"


def read(run):
    counters = sys.modules.get(PROGRAM)
    solves = getattr(counters, "stokes_solves", 0)
    if not solves:
        return None
    return counters.minres_steps / solves
