"""``solve_s_per_req``: host seconds of the harness's ``solve`` span
per request (it ends in a device sync), over the requests that were not
profiled; nothing where no request has the span."""


def read(run):
    s = [q["stages"]["solve"] for q in run.untraced()
         if "solve" in q["stages"]]
    return sum(s) / len(s) if s else None
