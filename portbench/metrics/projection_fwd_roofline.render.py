"""P1's share of its roofline, in %: the bound of one launch over the
scene's points (`work/unit.py` projection_work: 299 bytes and 420
operations a point) over projection_forward_kernel's time a frame in the
trace."""


def read(r):
    t, w = r.get("trace"), r.get("work")
    if not t or not w or t["families"]["projection_forward"] <= 0:
        return None
    return (100.0 * w["projection_forward_bound_ms"]
            / t["families"]["projection_forward"])
