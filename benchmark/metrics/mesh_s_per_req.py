"""``mesh_s_per_req``: host seconds of the harness's ``meshing`` span
per request (it ends in a device sync), over the requests that were not
profiled; nothing where no request has the span."""


def read(run):
    s = [q["stages"]["meshing"] for q in run.untraced()
         if "meshing" in q["stages"]]
    return sum(s) / len(s) if s else None
