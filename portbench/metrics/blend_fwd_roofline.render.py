"""K1's share of its roofline, in %: the bound of the frame's forward blend
by the frozen work counts (`work/blend.py`) over the forward-blend
family's kernel time a frame in the trace (build_work_kernel,
chunk_transmittance_kernel, blend_forward_kernel)."""


def read(r):
    t, w = r.get("trace"), r.get("work")
    if not t or not w or t["families"]["blend_forward"] <= 0:
        return None
    return 100.0 * w["blend_forward_bound_ms"] / t["families"]["blend_forward"]
