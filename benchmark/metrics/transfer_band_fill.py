"""``transfer_band_fill``: the share of the multigrid transfers' band slots
that hold a live entry, the program's own counters
(``utils.profiling.rect_band_entries`` over ``rect_band_slots``, counted
by ``ops.band_plans.build_rect_band_plan``), over every transfer plan the
process built before the window closed: the set-up's Stokes hierarchy,
the warm-up request's and the window's (the memos are emptied before each
request, so each request builds its own).  Windows widened past the width
menu on a graded mesh hold more empty slots.  The counters are read where
the program left them (this reader imports nothing of it); nothing where
the program has none or built no plan."""

import sys

PROGRAM = "fenics_eff_uptake_tpu_torch.utils.profiling"


def read(run):
    counters = sys.modules.get(PROGRAM)
    slots = getattr(counters, "rect_band_slots", 0)
    if not slots:
        return None
    return counters.rect_band_entries / slots
