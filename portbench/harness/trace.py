"""A stretch of work under torch.profiler, and what its trace shows.

The arithmetic is copied from the port's `utils/profiling.py`
(`kernel_base_name`, `_union_us`, the kernel families of `csrc/` and the
rule that the work-list kernel joins the family of the kernel after it):
the device is busy over the union of its kernels' intervals, and the
window runs from the stretch's start to the end of its host range or of
its last kernel, whichever is later.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

import torch

RANGE = "portbench stretch"
WORK_LIST_KERNEL = "build_work_kernel"
# kernel families by base name; the work-list kernel joins the next one's
FAMILIES = {
    "blend_forward": ("chunk_transmittance_kernel", "blend_forward_kernel"),
    "blend_backward": ("backward_chunk_kernel", "blend_backward_kernel"),
    "projection_forward": ("projection_forward_kernel",),
    "projection_backward": ("projection_backward_kernel",),
}
TOP = 10


def kernel_base_name(name: str) -> str:
    """`void ns::foo<true, 1>(float const*, int)` -> `foo`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1]


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _complete(events, cat):
    return sorted((e for e in events
                   if e.get("ph") == "X" and e.get("cat") == cat),
                  key=lambda e: (e["ts"], -e["dur"]))


def run_traced(fn, units: int) -> list:
    """Run `fn(i)` for i < units under torch.profiler (CPU and CUDA) in one
    range, synchronized at its end; returns the trace's events."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(RANGE):
            for i in range(units):
                fn(i)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def summarize(events, units: int) -> dict:
    """{window_s, busy_s, families: {name: ms per unit}, device_ops, idle_gaps}
    of a `run_traced` trace over `units` units of work. device_ops: the
    kernels with the most device time, [[base name, seconds]]; idle_gaps:
    the longest stretches with no kernel running, [[the host op running
    when the gap began, seconds]]."""
    ranges = [e for e in _complete(events, "user_annotation")
              if e["name"] == RANGE]
    if not ranges:
        raise ValueError(f"the trace has no range {RANGE!r}")
    t0 = ranges[0]["ts"]
    t_host = ranges[0]["ts"] + ranges[0]["dur"]
    kernels = [k for k in _complete(events, "kernel")
               if t0 <= k["ts"] <= t_host]
    t1 = max([t_host] + [k["ts"] + k["dur"] for k in kernels])
    busy = _merged((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    busy_us = sum(b - a for a, b in busy)

    families = {name: 0.0 for name in FAMILIES}
    by_base = {base: fam for fam, bases in FAMILIES.items()
               for base in bases}
    pending = []
    totals = {}
    for k in kernels:
        base = kernel_base_name(k["name"])
        totals[base] = totals.get(base, 0.0) + k["dur"]
        if base == WORK_LIST_KERNEL:
            pending.append(k)
            continue
        fam = by_base.get(base)
        if fam is not None:
            families[fam] += sum(m["dur"] for m in pending + [k])
        pending = []
    device_ops = sorted(([name, us * 1e-6] for name, us in totals.items()),
                        key=lambda x: -x[1])[:TOP]

    gaps = []
    edge = t0
    for a, b in busy + [[t1, t1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    host = _host_ops(events, t0, t1)
    starts = [op["ts"] for op in host]
    idle = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        i = bisect.bisect_right(starts, a) - 1
        name = ("[host, outside any op]" if i < 0
                or a > host[i]["ts"] + host[i]["dur"] else host[i]["name"])
        idle.append([name, (b - a) * 1e-6])
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy_us * 1e-6,
            "families": {k: v / 1000.0 / units for k, v in families.items()},
            "kernels_per_unit": len(kernels) / units,
            "device_ops": device_ops, "idle_gaps": idle}


def _host_ops(events, t0, t1):
    """The outermost CPU ops of the thread that ran the stretch, in order."""
    ranges = [e for e in _complete(events, "user_annotation")
              if e["name"] == RANGE]
    tid = ranges[0].get("tid")
    out = []
    for op in _complete(events, "cpu_op"):
        if op.get("tid") != tid or op["ts"] > t1 or op["ts"] < t0:
            continue
        if out and op["ts"] < out[-1]["ts"] + out[-1]["dur"]:
            continue
        out.append(op)
    return out
