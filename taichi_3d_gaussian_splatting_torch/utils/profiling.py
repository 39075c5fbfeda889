"""The trainer's device trace, and a summary of a trace file.

`TraceWindow` runs `torch.profiler` over a window of training iterations
(`TrainConfig.enable_profiler`, `profiler_start_iteration`,
`profiler_num_steps`): CPU activity, plus the card's kernels when the
trainer runs on one, with each traced iteration in a range named
`iteration {i}`. When the window ends, or the run ends inside it, the card
is synchronized and `torch.profiler.tensorboard_trace_handler` writes the
trace to `<summary_writer_log_dir>/profile/`, one Chrome-trace JSON file
per rank (`rank{r}.<time>.pt.trace.json`), which TensorBoard's profiler
plugin and Perfetto read.

`summarize_trace` reads such a file, or any Chrome trace whose ranges
share a name prefix: over the ranges, the card's busy share, the kernel
launches and device time per range, the kernels with the most device time,
the host ops whose kernels take the most device time, and the time of the
blend kernels (`csrc/`) by family and of the projection kernels.

    python -m taichi_3d_gaussian_splatting_torch.utils.profiling TRACE.json \\
        [--prefix "iteration "] [--top 10]
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re

import torch

# the kernels of csrc/ by launch: the work-list kernel starts every
# launch, so it joins the family of the kernel that follows it
WORK_LIST_KERNEL = "build_work_kernel"
FORWARD_KERNELS = ("chunk_transmittance_kernel", "blend_forward_kernel")
BACKWARD_KERNELS = ("backward_chunk_kernel", "blend_backward_kernel")
# the projection kernels of csrc/ (one launch each per frame / step)
PROJECTION_KERNELS = {"forward": "projection_forward_kernel",
                      "backward": "projection_backward_kernel"}


class TraceWindow:
    """`torch.profiler` over iterations [start, start + num_steps) of a
    loop that calls `begin(i)` at the top of each iteration and `close()`
    when it ends (also on an exception)."""

    def __init__(self, log_dir: str, start: int, num_steps: int, device,
                 rank: int = 0):
        self.trace_dir = os.path.join(log_dir, "profile")
        self.start = start
        self.stop = start + num_steps
        self.device = torch.device(device)
        self.rank = rank
        self._profiler = None
        self._range = None

    def begin(self, iteration: int):
        """End the previous iteration's range; stop the profiler at the
        window's end, start it at its start; open this iteration's range
        while it runs."""
        self._end_range()
        if iteration == self.stop:
            self.close()
        if iteration == self.start and self.stop > self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.trace_dir, worker_name=f"rank{self.rank}"))
            self._profiler.start()
        if self._profiler is not None:
            self._range = torch.profiler.record_function(
                f"iteration {iteration}")
            self._range.__enter__()

    def _end_range(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def close(self):
        """End the open range and, while the profiler runs, wait for the
        card and stop it, which writes the trace."""
        self._end_range()
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler, self._profiler = self._profiler, None
        profiler.stop()


def trace_files(log_dir: str) -> list:
    """The trace files the trainer wrote under `<log_dir>/profile/`."""
    trace_dir = os.path.join(log_dir, "profile")
    if not os.path.isdir(trace_dir):
        return []
    return sorted(os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
                  if f.endswith(".pt.trace.json"))


def load_events(path: str) -> list:
    """The events of a Chrome-trace JSON file."""
    with open(path) as f:
        return json.load(f)["traceEvents"]


def kernel_base_name(name: str) -> str:
    """`void ns::foo<true, 1>(float const*, int)` -> `foo`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1]


def _complete(events, cat):
    """The complete events of category `cat`, an enclosing event before
    the events it encloses."""
    return sorted((e for e in events
                   if e.get("ph") == "X" and e.get("cat") == cat),
                  key=lambda e: (e["ts"], -e["dur"]))


def _launching_ops(events, kernels) -> list:
    """For each kernel, the outermost CPU op (on the host thread) around
    the runtime call that launched it, matched by correlation id; a launch
    outside any op, such as a blend kernel's from its ctypes wrapper, is
    named `[kernel base name]`."""
    calls = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                    "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                calls[corr] = e
    outermost = {}   # (pid, tid) -> (starts, ops) of the top-level ops
    for op in _complete(events, "cpu_op"):
        starts, ops = outermost.setdefault((op.get("pid"), op.get("tid")),
                                           ([], []))
        if ops and op["ts"] < ops[-1]["ts"] + ops[-1]["dur"]:
            continue
        starts.append(op["ts"])
        ops.append(op)
    names = []
    for k in kernels:
        name = f"[{kernel_base_name(k['name'])}]"
        call = calls.get(k.get("args", {}).get("correlation"))
        if call is not None:
            starts, ops = outermost.get((call.get("pid"), call.get("tid")),
                                        ([], []))
            i = bisect.bisect_right(starts, call["ts"]) - 1
            if i >= 0 and call["ts"] <= ops[i]["ts"] + ops[i]["dur"]:
                name = ops[i]["name"]
        names.append(name)
    return names


def _ranked(names, kernels, n, top):
    """[{name, ms_per_range, launches_per_range, mean_us}] of the `top`
    names by the summed duration of their kernels."""
    totals = {}
    for name, k in zip(names, kernels):
        ms, count = totals.get(name, (0.0, 0))
        totals[name] = (ms + k["dur"] / 1000.0, count + 1)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])
    return [{"name": name, "ms_per_range": ms / n,
             "launches_per_range": count / n, "mean_us": 1000.0 * ms / count}
            for name, (ms, count) in ranked[:top]]


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def summarize_trace(events, prefix: str = "iteration ", top: int = 10):
    """Summary of the kernels a Chrome trace (`load_events`) shows over
    its CPU ranges named `prefix...` (record_function ranges).

    The window runs from the first range's start to the end of the last
    range or of the last kernel that started in it, whichever is later
    (the card runs behind the host). Returns a dict:
      ranges, window_ms, busy_share (the union of the kernels' intervals
      over the window's length), kernels (launches in the window),
      launches_per_range, kernel_ms_per_range (summed durations);
      top: the `top` kernels by device time, each {name, ms_per_range,
      launches_per_range, mean_us}; top_ops: the same for the host ops
      that launched them (`_launching_ops`);
      blend: {"forward": ..., "backward": ...}, each {ms_per_range,
      launches_per_range, kernels: {base name: ms_per_range}}, the
      launches counted by blend_forward_kernel / blend_backward_kernel;
      projection: {"forward": ..., "backward": ...}, each {ms_per_range,
      launches_per_range} of projection_forward_kernel /
      projection_backward_kernel.
    Raises ValueError when the trace has no such range."""
    ranges = [e for e in _complete(events, "user_annotation")
              if e["name"].startswith(prefix)]
    if not ranges:
        raise ValueError(f"the trace has no range named {prefix!r}...")
    n = len(ranges)
    t0 = ranges[0]["ts"]
    t_host = max(r["ts"] + r["dur"] for r in ranges)
    kernels = [k for k in _complete(events, "kernel")
               if t0 <= k["ts"] <= t_host]
    t1 = max([t_host] + [k["ts"] + k["dur"] for k in kernels])
    window_us = max(t1 - t0, 1e-9)

    blend = {fam: {"ms_per_range": 0.0, "launches_per_range": 0.0,
                   "kernels": {}} for fam in ("forward", "backward")}
    projection = {fam: {"ms_per_range": 0.0, "launches_per_range": 0.0}
                  for fam in PROJECTION_KERNELS}
    by_name = {name: fam for fam, name in PROJECTION_KERNELS.items()}
    pending = []
    for k in kernels:
        base = kernel_base_name(k["name"])
        if base in by_name:
            entry = projection[by_name[base]]
            entry["ms_per_range"] += k["dur"] / 1000.0 / n
            entry["launches_per_range"] += 1.0 / n
            continue
        if base == WORK_LIST_KERNEL:
            pending.append(k)
            continue
        fam = ("forward" if base in FORWARD_KERNELS else
               "backward" if base in BACKWARD_KERNELS else None)
        if fam is None:
            continue
        for member in pending + [k]:
            name = kernel_base_name(member["name"])
            entry = blend[fam]
            entry["ms_per_range"] += member["dur"] / 1000.0 / n
            entry["kernels"][name] = (entry["kernels"].get(name, 0.0)
                                      + member["dur"] / 1000.0 / n)
        pending = []
        if base in ("blend_forward_kernel", "blend_backward_kernel"):
            blend[fam]["launches_per_range"] += 1.0 / n

    return {
        "ranges": n, "window_ms": window_us / 1000.0,
        "busy_share": _union_us((k["ts"], k["ts"] + k["dur"])
                                for k in kernels) / window_us,
        "kernels": len(kernels), "launches_per_range": len(kernels) / n,
        "kernel_ms_per_range": sum(k["dur"] for k in kernels) / 1000.0 / n,
        "top": _ranked([k["name"] for k in kernels], kernels, n, top),
        "top_ops": _ranked(_launching_ops(events, kernels), kernels, n, top),
        "blend": blend, "projection": projection}


def format_summary(summary: dict, unit: str = "step") -> str:
    """The summary as lines of text."""
    s = summary
    lines = [f"{s['ranges']} {unit}s over {s['window_ms']:.4f} ms: device "
             f"busy {100.0 * s['busy_share']:.2f}%, "
             f"{s['launches_per_range']:.1f} kernel launches and "
             f"{s['kernel_ms_per_range']:.4f} ms of kernels per {unit}"]
    for fam, entry in s["blend"].items():
        parts = ", ".join(f"{k} {v:.4f}" for k, v in entry["kernels"].items())
        lines.append(f"  blend {fam}: {entry['ms_per_range']:.4f} ms and "
                     f"{entry['launches_per_range']:.2f} launches per {unit}"
                     + (f" ({parts})" if parts else ""))
    for fam, entry in s["projection"].items():
        lines.append(f"  projection {fam}: {entry['ms_per_range']:.4f} ms "
                     f"and {entry['launches_per_range']:.2f} launches per "
                     f"{unit}")
    for key, what in (("top", "kernels"),
                      ("top_ops", "host ops by their kernels' time")):
        lines.append(f"  top {len(s[key])} {what} per {unit}:")
        for row in s[key]:
            lines.append(f"    {row['ms_per_range']:9.4f} ms "
                         f"{row['launches_per_range']:7.1f} launches "
                         f"{row['mean_us']:9.2f} us each  "
                         f"{row['name'][:100]}")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("trace", type=str)
    parser.add_argument("--prefix", type=str, default="iteration ")
    parser.add_argument("--top", type=int, default=10)
    args = parser.parse_args(argv)
    unit = args.prefix.strip() or "range"
    print(format_summary(summarize_trace(load_events(args.trace), args.prefix,
                                         args.top), unit))


if __name__ == "__main__":
    main()
