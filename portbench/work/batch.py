"""The work of one batch step of B views (`parallel/sharding.py`), from
`work/unit.py`'s counts of a single-view step.

Per view: P1, K2, the loss, K3, routing and P2 as the single-view step has
them, and in the `accumulate` stage the controller's statistics (20 a
slot), the feature gradients' group scale and band mask (2 a feature, 112
a slot) and the two running sums (59 a slot). Once a step: the optimizer
on the sums, `unit.OPTIMIZER_OPS_PER_SLOT` less the statistics and the
scale and mask, which the update of a batch does not take (1,074 a slot).
"""

from __future__ import annotations

from .unit import OPTIMIZER_OPS_PER_SLOT

STATS_OPS_PER_SLOT = 20
SCALE_MASK_OPS_PER_SLOT = 2 * 56
SUM_OPS_PER_SLOT = 3 + 56
BATCH_OPTIMIZER_OPS_PER_SLOT = (OPTIMIZER_OPS_PER_SLOT - STATS_OPS_PER_SLOT
                                - SCALE_MASK_OPS_PER_SLOT)


def batch_step_work(view_flops: float, view_k3_bound_ms: float, views: int,
                    slots: int) -> dict:
    """{flops, blend_backward_bound_ms} of a batch step of `views` views
    over `slots` slots, from the mean single-view step's operations
    (`unit.step_work` flops, its optimizer and statistics included) and
    K3 bound over those views."""
    per_view = (view_flops - OPTIMIZER_OPS_PER_SLOT * slots
                + (STATS_OPS_PER_SLOT + SCALE_MASK_OPS_PER_SLOT
                   + SUM_OPS_PER_SLOT) * slots)
    return {"flops": views * per_view + BATCH_OPTIMIZER_OPS_PER_SLOT * slots,
            "blend_backward_bound_ms": views * view_k3_bound_ms}
