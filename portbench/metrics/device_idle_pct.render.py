"""Share of the traced stretch of frames in which no kernel ran, in %:
100 minus the union of the kernels' intervals over the stretch."""


def read(r):
    t = r.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
