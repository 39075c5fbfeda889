"""The whole training step's share of the float32 peak, in %: the step's
operations by the work model (`work/unit.py` step_work: P1, K2, the loss,
K3, routing, P2, Adam and statistics) over the step time of the untraced
stretch (CUDA events)."""

from portbench.work.unit import mfu_pct


def read(r):
    if "work" not in r or "unit_ms" not in r:
        return None
    return mfu_pct(r["work"]["flops"], r["unit_ms"])
