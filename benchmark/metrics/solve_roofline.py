"""``solve_roofline``: the share (%) of the solve spans' device time that
the least time of their work takes, over the whole profiled requests.

Numerator: ``cost.solve_cost`` (the frozen cost arithmetic, by nonzero
entries, each input read once and each output written once) at the
iterations and passes each solve reports, over the published peaks.
Denominator: the durations of the device records inside the solve spans.
Nothing where no whole profiled request has its solve stage attributed
(``tracer``)."""


def read(run):
    bound = sum(w["solve_bound_s"] for w in run.windows
                if "solve" in w["stages"])
    device = sum(w["stages"]["solve"]["device"] for w in run.windows
                 if "solve" in w["stages"])
    if device <= 0:
        return None
    return 100.0 * bound / device
