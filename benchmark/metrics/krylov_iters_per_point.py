"""``krylov_iters_per_point``: the f32 Krylov iterations the solve reports
(``info["iters"]``, summed over the columns and the defect passes) per
sweep point, over every completed request."""


def read(run):
    points = sum(q["points"] for q in run.requests)
    if not points:
        return None
    return sum(sum(q["iters"]) for q in run.requests) / points
