"""``ml_setup_s_per_req``: host seconds of the harness's ``ml_setup`` span
per request (it ends in a device sync), over the requests that were not
profiled; nothing where no request has the span."""


def read(run):
    s = [q["stages"]["ml_setup"] for q in run.untraced()
         if "ml_setup" in q["stages"]]
    return sum(s) / len(s) if s else None
