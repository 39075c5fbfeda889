"""Stage spans, the trainer's device trace, and a summary of a trace file.

`span(name, mark)` brackets one stage of a frame or a step. Inside
`tracing()` it is a `torch.profiler.record_function` range named
`t3dgs/<name>`, on the calling thread and on the profiler's clock, nested
in the span around it; outside it costs one flag read. Either way it calls
`mark(name)` when the stage ends, the timing hook of `rasterize_with_vjp`
and `GaussianPointCloudTrainer.step`.

`TraceWindow` runs `torch.profiler` over a window of training iterations
(`TrainConfig.enable_profiler`, `profiler_start_iteration`,
`profiler_num_steps`): CPU activity, plus the card's kernels when the
trainer runs on one, with each traced iteration in a range named
`iteration {i}` and the stage spans on. When the window ends, or the run
ends inside it, the card is synchronized and
`torch.profiler.tensorboard_trace_handler` writes the trace to
`<summary_writer_log_dir>/profile/`, one Chrome-trace JSON file per rank
(`rank{r}.<time>.pt.trace.json`), which TensorBoard's profiler plugin and
Perfetto read.

`summarize_trace` reads such a file, or any Chrome trace whose ranges
share a name prefix: over the ranges, the card's busy share, the kernel
launches and device time per range, the kernels with the most device time,
the host ops whose kernels take the most device time, and the time of the
blend kernels (`csrc/`) by family and of the projection kernels, and,
where the trace holds stage spans, the host's own time and the card's idle
time by span.

    python -m taichi_3d_gaussian_splatting_torch.utils.profiling TRACE.json \\
        [--prefix "iteration "] [--top 10]
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
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
# the optimizer kernel of csrc/ (one launch per step)
OPTIMIZER_KERNEL = "optimizer_update_kernel"
# the name of every stage span's range starts with this
SPAN_PREFIX = "t3dgs/"

_spans_on = False


def _no_mark(stage: str):
    pass


@contextlib.contextmanager
def tracing():
    """Stage spans on inside the block (`span`)."""
    global _spans_on
    was, _spans_on = _spans_on, True
    try:
        yield
    finally:
        _spans_on = was


class _Span:
    """A stage: its range while spans are on, `mark(name)` when it ends
    without an exception."""
    __slots__ = ("name", "mark", "range")

    def __init__(self, name, mark):
        self.name, self.mark, self.range = name, mark, None

    def __enter__(self):
        if _spans_on:
            self.range = torch.profiler.record_function(SPAN_PREFIX
                                                        + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        if exc_type is None:
            self.mark(self.name)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, mark=_no_mark):
    """A context manager around one stage, `name` as in the trace
    (`binning/sort`: a sub-stage of `binning`). Outside `tracing()` and
    with no `mark` it is one shared null context: no range, no event, no
    allocation."""
    if not _spans_on and mark is _no_mark:
        return _OFF
    return _Span(name, mark)


class TraceWindow:
    """`torch.profiler`, with the stage spans on (`tracing`), over
    iterations [start, start + num_steps) of a loop that calls `begin(i)`
    at the top of each iteration and `close()` when it ends (also on an
    exception)."""

    def __init__(self, log_dir: str, start: int, num_steps: int, device,
                 rank: int = 0):
        self.trace_dir = os.path.join(log_dir, "profile")
        self.start = start
        self.stop = start + num_steps
        self.device = torch.device(device)
        self.rank = rank
        self._profiler = None
        self._spans = None
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
            self._spans = tracing()
            self._spans.__enter__()
        if self._profiler is not None:
            self._range = torch.profiler.record_function(
                f"iteration {iteration}")
            self._range.__enter__()

    def _end_range(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def close(self):
        """End the open range and the spans and, while the profiler runs,
        wait for the card and stop it, which writes the trace."""
        self._end_range()
        if self._spans is not None:
            self._spans.__exit__(None, None, None)
            self._spans = None
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


def _idle_gaps(kernels, t0, t1) -> list:
    """The stretches [a, b) of [t0, t1) in which no kernel runs."""
    gaps, edge = [], t0
    for a, b in sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels) + [
            (t1, t1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    return gaps


def span_table(events, tid, t0, t1, gaps, n: int) -> dict:
    """The stage spans (`span`) of thread `tid` that start in [t0, t1],
    over `n` ranges. Returns {spans, idle_ms_per_range,
    outside_idle_ms_per_range, named_idle_share}: spans maps each span
    name (without `SPAN_PREFIX`), in the order it first appears, to
    {parent (the name of the span around it, or None), calls_per_range,
    host_ms_per_range (its duration less its child spans'),
    idle_ms_per_range (the `gaps` that begin while it is the innermost
    span)}; the idle time of every gap a range, the part that begins
    outside any span, and the share that some span names."""
    spans = [e for e in _complete(events, "user_annotation")
             if e["name"].startswith(SPAN_PREFIX) and e.get("tid") == tid
             and t0 <= e["ts"] <= t1]
    parent, stack = [], []
    children_us = [0.0] * len(spans)
    for i, e in enumerate(spans):
        while stack and e["ts"] >= (spans[stack[-1]]["ts"]
                                    + spans[stack[-1]]["dur"]):
            stack.pop()
        parent.append(stack[-1] if stack else None)
        if stack:
            children_us[stack[-1]] += e["dur"]
        stack.append(i)
    rows = {}
    for i, e in enumerate(spans):
        row = rows.setdefault(e["name"][len(SPAN_PREFIX):], {
            "parent": (None if parent[i] is None else
                       spans[parent[i]]["name"][len(SPAN_PREFIX):]),
            "calls_per_range": 0.0, "host_ms_per_range": 0.0,
            "idle_ms_per_range": 0.0})
        row["calls_per_range"] += 1.0 / n
        row["host_ms_per_range"] += (e["dur"] - children_us[i]) / 1000.0 / n
    starts = [e["ts"] for e in spans]
    idle_us = outside_us = 0.0
    for a, b in gaps:
        idle_us += b - a
        i = bisect.bisect_right(starts, a) - 1
        while i is not None and i >= 0 and a >= (spans[i]["ts"]
                                                 + spans[i]["dur"]):
            i = parent[i]
        if i is None or i < 0:
            outside_us += b - a
        else:
            name = spans[i]["name"][len(SPAN_PREFIX):]
            rows[name]["idle_ms_per_range"] += (b - a) / 1000.0 / n
    return {"spans": rows, "idle_ms_per_range": idle_us / 1000.0 / n,
            "outside_idle_ms_per_range": outside_us / 1000.0 / n,
            "named_idle_share": (1.0 - outside_us / idle_us if idle_us
                                 else 0.0)}


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
      projection_backward_kernel;
      optimizer: {ms_per_range, launches_per_range} of
      optimizer_update_kernel;
      stages: `span_table` of the ranges' thread over the window (its
      spans empty when the trace holds no stage span).
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
    optimizer = {"ms_per_range": 0.0, "launches_per_range": 0.0}
    by_name = {name: fam for fam, name in PROJECTION_KERNELS.items()}
    pending = []
    for k in kernels:
        base = kernel_base_name(k["name"])
        if base == OPTIMIZER_KERNEL:
            optimizer["ms_per_range"] += k["dur"] / 1000.0 / n
            optimizer["launches_per_range"] += 1.0 / n
            continue
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
        "blend": blend, "projection": projection, "optimizer": optimizer,
        "stages": span_table(events, ranges[0].get("tid"), t0, t1,
                             _idle_gaps(kernels, t0, t1), n)}


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
    entry = s["optimizer"]
    lines.append(f"  optimizer: {entry['ms_per_range']:.4f} ms and "
                 f"{entry['launches_per_range']:.2f} launches per {unit}")
    for key, what in (("top", "kernels"),
                      ("top_ops", "host ops by their kernels' time")):
        lines.append(f"  top {len(s[key])} {what} per {unit}:")
        for row in s[key]:
            lines.append(f"    {row['ms_per_range']:9.4f} ms "
                         f"{row['launches_per_range']:7.1f} launches "
                         f"{row['mean_us']:9.2f} us each  "
                         f"{row['name'][:100]}")
    stages = s["stages"]
    if stages["spans"]:
        lines.append(f"  stage spans per {unit}: device idle "
                     f"{stages['idle_ms_per_range']:.4f} ms, "
                     f"{100.0 * stages['named_idle_share']:.2f}% of it "
                     f"begun inside a span "
                     f"({stages['outside_idle_ms_per_range']:.4f} ms "
                     f"outside any); host self ms, idle ms, calls:")
        for name, row in stages["spans"].items():
            depth, up = 0, row["parent"]
            while up is not None:
                depth, up = depth + 1, stages["spans"][up]["parent"]
            lines.append(f"    {row['host_ms_per_range']:9.4f} ms "
                         f"{row['idle_ms_per_range']:9.4f} ms "
                         f"{row['calls_per_range']:7.2f}  "
                         f"{'  ' * depth}{name}")
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
