"""K3's share of its roofline, in %: the bound of a step's backward blend
by the frozen work counts (`work/blend.py`) over the backward-blend
family's kernel time a step in the trace (build_work_kernel,
backward_chunk_kernel, blend_backward_kernel)."""


def read(r):
    t, w = r.get("trace"), r.get("work")
    if not t or not w or t["families"]["blend_backward"] <= 0:
        return None
    return (100.0 * w["blend_backward_bound_ms"]
            / t["families"]["blend_backward"])
