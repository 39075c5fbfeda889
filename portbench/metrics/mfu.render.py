"""The whole frame's share of the float32 peak, in %: the frame's
operations by the work model (`work/unit.py` frame_work: P1 per point, K1
per pair) over the frame time of the untraced stretch (CUDA events)."""

from portbench.work.unit import mfu_pct


def read(r):
    if "work" not in r or "unit_ms" not in r:
        return None
    return mfu_pct(r["work"]["flops"], r["unit_ms"])
