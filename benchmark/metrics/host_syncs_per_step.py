"""``host_syncs_per_step``: the blocking device-to-host reads of the
transport solves per executed Krylov iteration, the program's own
counters (``utils.profiling.host_syncs`` over ``krylov_steps``), over
every solve the process ran before the window closed: the warm-up
request's and the window's (no set-up of a cell runs a transport solve;
the harness keeps no per-request counter deltas, so the warm-up request
cannot be left out).  The counters are read where the program left them
(this reader imports nothing of it); nothing where the program has none
or ran no step."""

import sys

PROGRAM = "fenics_eff_uptake_tpu_torch.utils.profiling"


def read(run):
    counters = sys.modules.get(PROGRAM)
    steps = getattr(counters, "krylov_steps", 0)
    if not steps:
        return None
    return counters.host_syncs / steps
