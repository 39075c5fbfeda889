"""Device time by CUDA events."""

from __future__ import annotations

import torch


class Marks:
    """A `mark(stage)` hook for the program's stage boundaries: records a
    CUDA event at each call. `stage_ms()` gives the device ms between each
    mark and the one before, summed per stage name (the arithmetic of
    `chip_smoke.py` staged_step_ms)."""

    def __init__(self):
        self.events = []

    def __call__(self, stage: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((stage, ev))

    def stage_ms(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for (_, a), (stage, b) in zip(self.events, self.events[1:]):
            out[stage] = out.get(stage, 0.0) + a.elapsed_time(b)
        return out


def timed_units(fn, units: int, mark_stages: bool = False):
    """Run `fn(i, mark)` for i < units between two CUDA events; returns
    (device ms per unit, mean ms per stage per unit)."""
    marks = Marks()
    marks("start")
    for i in range(units):
        fn(i, marks if mark_stages else _no_mark)
    marks("end")
    stages = marks.stage_ms()
    total = sum(stages.values())
    per_stage = {k: v / units for k, v in stages.items() if k != "end"}
    return total / units, per_stage


def _no_mark(stage: str):
    pass
