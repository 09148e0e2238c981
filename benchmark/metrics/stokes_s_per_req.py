"""``stokes_s_per_req``: host seconds of the harness's ``stokes`` span
per request (it ends in a device sync), over the requests that were not
profiled; nothing where no request has the span (a mix on one geometry
solves its Stokes field in set-up only)."""


def read(run):
    s = [q["stages"]["stokes"] for q in run.untraced()
         if "stokes" in q["stages"]]
    return sum(s) / len(s) if s else None
