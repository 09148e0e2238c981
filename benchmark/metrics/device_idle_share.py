"""``device_idle_share``: 1 - (the union of the device records) / (the
stages' wall time), over the whole profiled requests; nothing where none
is whole."""


def read(run):
    wall = sum(w["wall"] for w in run.windows)
    if wall <= 0:
        return None
    return 1.0 - sum(w["busy"] for w in run.windows) / wall
