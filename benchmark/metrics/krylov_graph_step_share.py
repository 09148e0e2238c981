"""``krylov_graph_step_share``: the share of the transport solves'
executed Krylov iterations that ran as a replay of a captured CUDA graph
of the step, the program's own counters (``utils.profiling.
krylov_graph_steps`` over ``krylov_steps``), over every solve the process
ran before the window closed (the warm-up request's and the window's, as
``host_syncs_per_step``).  The counters are read where the program left
them (this reader imports nothing of it); nothing where the program has
no such counter or ran no step."""

import sys

PROGRAM = "fenics_eff_uptake_tpu_torch.utils.profiling"


def read(run):
    counters = sys.modules.get(PROGRAM)
    steps = getattr(counters, "krylov_steps", 0)
    if not steps or not hasattr(counters, "krylov_graph_steps"):
        return None
    return counters.krylov_graph_steps / steps
