"""The port's stage spans (`utils/profiling.py` `span`, `tracing`).

On the CPU at 32x32: inside `tracing()`, under torch.profiler, a frame of
`rasterize` (both paths), one `trainer.step` and one `batch_step` emit
exactly their named spans, each inside its parent; outside `tracing()`,
also while a profiler runs, no `record_function` is entered; the `mark`
hook sees the same names in the same order either way; images, gradients
and the training state are bitwise equal with spans on and off; a
profiled training run's trace holds the stage spans under `iteration i`.
The span table of the trace summary is held on hand-made events whose
answer is known.
"""

import json

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_torch import config as tconfig
from taichi_3d_gaussian_splatting_torch.camera import CameraInfo as TCamera
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene)
from taichi_3d_gaussian_splatting_torch.ops import rasterizer as TR
from taichi_3d_gaussian_splatting_torch.training import trainer as TT
from taichi_3d_gaussian_splatting_torch.utils import profiling as P

from torch_port_fixtures import CFG, camera_intrinsics, identity_pose, \
    random_scene
from torch_train_fixtures import batch_views, config_dict, write_dataset

torch.set_num_threads(1)

# the test's own ranges, whatever a test patches
_record_function = torch.profiler.record_function

BINNING = {"binning": None, "binning/emission": "binning",
           "binning/key count read": "binning/emission",
           "binning/sort": "binning", "binning/gather": "binning"}


def _under(unit, parents):
    """{span: parent} with the top-level stages put under `unit`."""
    out = {unit: None}
    out.update({k: v or unit for k, v in parents.items()})
    return out


FORWARD = {"projection": None, **BINNING, "forward blend": None,
           "forward blend/layout": "forward blend"}
FRAME = _under("frame", FORWARD)
STEP = _under("step", {**FORWARD, "loss": None, "backward blend": None,
                       "routing": None, "projection backward": None,
                       "adam": None})
STEP_MARKS = ["projection", "binning", "forward blend", "loss",
              "backward blend", "routing", "projection backward", "adam"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("span_data"))
    write_dataset(root)
    return root


def _trainer(dataset, **over):
    return TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, config_dict(dataset, **over)),
        device="cpu")


def _view(trainer, i=0):
    item = trainer.train_dataset[i]
    return (torch.as_tensor(item.image),
            torch.as_tensor(item.q_pointcloud_camera),
            torch.as_tensor(item.t_pointcloud_camera), 1, item.camera_info)


def _scene():
    return TScene.from_numpy(*random_scene(40, seed=3), np.zeros(40),
                             np.zeros(40), device="cpu")


def _frame(rgb_only, mark=P._no_mark):
    q, t = (torch.as_tensor(x) for x in identity_pose())
    scene = _scene()
    with torch.no_grad():
        return TR.rasterize(*scene, q, t, TCamera(camera_intrinsics(), 32, 32),
                            TR.RasterizerConfig(rgb_only=rgb_only, **CFG),
                            mark=mark)


def _traced(fn, spans_on=True):
    """Run `fn` under torch.profiler (CPU) in a range `unit`, the spans
    on or off; returns (fn's result, the trace's events)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with _record_function("unit 0"):
            if spans_on:
                with P.tracing():
                    out = fn()
            else:
                out = fn()
    return out, prof.events()


def _span_events(events):
    """The stage spans of a profiler's event list, as trace events."""
    return [{"ph": "X", "cat": "user_annotation", "name": e.name,
             "ts": e.time_range.start, "dur": e.time_range.elapsed_us(),
             "tid": 1} for e in events
            if e.name.startswith(P.SPAN_PREFIX)]


def _parents(spans):
    """{name: parent name} of the spans, checked inside their parents;
    each name must appear `calls` times, as many as returned."""
    table = P.span_table(spans, 1, -float("inf"), float("inf"), [], 1)
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"][len(P.SPAN_PREFIX):], []).append(e)
    for name, row in table["spans"].items():
        if row["parent"] is None:
            continue
        for child in by_name[name]:
            assert any(p["ts"] <= child["ts"] and child["ts"] + child["dur"]
                       <= p["ts"] + p["dur"] for p in by_name[row["parent"]])
    return ({k: r["parent"] for k, r in table["spans"].items()},
            {k: r["calls_per_range"] for k, r in table["spans"].items()})


# ---------------------------------------------------------------------------
# the named spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rgb_only", [True, False])
def test_frame_emits_its_named_spans(rgb_only):
    _, events = _traced(lambda: _frame(rgb_only))
    parents, calls = _parents(_span_events(events))
    assert parents == FRAME
    assert set(calls.values()) == {1.0}


def test_step_emits_its_named_spans(dataset):
    trainer = _trainer(dataset)
    _, events = _traced(lambda: trainer.step(*_view(trainer)))
    parents, calls = _parents(_span_events(events))
    assert parents == STEP
    assert set(calls.values()) == {1.0}


def test_batch_step_emits_its_named_spans(dataset):
    """Two views in one step: the forward stages and `accumulate` once a
    view, `allreduce` and `adam` once."""
    trainer = _trainer(dataset, batch_size=2)
    images, qs, ts, intrs, cam = batch_views(trainer, [0, 1])
    _, events = _traced(lambda: trainer.batch_step(images, qs, ts, intrs, 1,
                                                   cam))
    parents, calls = _parents(_span_events(events))
    per_view = {k: v for k, v in STEP.items() if k not in ("step", "adam")}
    assert parents == {**per_view, "accumulate": "step", "allreduce": "step",
                       "adam": "step", "step": None}
    assert calls == {**{k: 2.0 for k in per_view}, "accumulate": 2.0,
                     "allreduce": 1.0, "adam": 1.0, "step": 1.0}


def test_spans_off_enter_no_record_function(dataset, monkeypatch):
    """With a profiler running but outside `tracing()`, neither a frame
    nor a step enters `record_function`, and `span` without a mark is one
    shared object; inside `tracing()` every span enters one."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    trainer = _trainer(dataset)

    def work():
        _frame(True)
        trainer.step(*_view(trainer))

    _traced(work, spans_on=False)
    assert entered == []
    assert P.span("frame") is P.span("binning/sort")
    _traced(work)
    assert sorted(set(entered)) == sorted(P.SPAN_PREFIX + k
                                          for k in {**FRAME, **STEP})


# ---------------------------------------------------------------------------
# the mark hook and the results, spans on and off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spans_on", [False, True])
def test_marks_keep_their_names_and_order(dataset, spans_on):
    frame_marks, step_marks = [], []
    trainer = _trainer(dataset)
    _traced(lambda: (_frame(True, frame_marks.append),
                     trainer.step(*_view(trainer), mark=step_marks.append)),
            spans_on)
    assert frame_marks == ["projection", "binning", "forward blend"]
    assert step_marks == STEP_MARKS


def test_the_adam_mark_sees_the_updated_state(dataset):
    """At the `adam` mark of a single-view step the trainer already holds
    the state after the update, as a caller that reads it there expects;
    at every earlier mark it still holds the state before."""
    trainer = _trainer(dataset)

    def state():
        return (trainer.scene, trainer.opt_features, trainer.opt_positions,
                trainer.ctrl_state)

    before, seen = state(), {}
    trainer.step(*_view(trainer), mark=lambda stage: seen.update(
        {stage: state()}))
    after = state()
    assert list(seen) == STEP_MARKS
    for stage in STEP_MARKS[:-1]:
        assert all(a is b for a, b in zip(seen[stage], before)), stage
    assert all(a is b for a, b in zip(seen["adam"], after))
    assert int(after[1].count) == int(before[1].count) + 1


def _results(dataset):
    """Both frames' images, a VJP's gradients and two steps' state."""
    out = [_frame(True).image, _frame(False).image]
    q, t = (torch.as_tensor(x) for x in identity_pose())
    scene = _scene()
    _, vjp_fn = TR.rasterize_with_vjp(
        *scene, q, t, TCamera(camera_intrinsics(), 32, 32),
        TR.RasterizerConfig(**CFG))
    grad_pc, grad_feats, stats = vjp_fn(torch.ones(32, 32, 3))
    out += [grad_pc, grad_feats, *stats]
    trainer = _trainer(dataset)
    for i in range(2):
        trainer.step(*_view(trainer, i))
    return out + list(trainer.state_arrays().values())


def test_results_bitwise_equal_with_spans_on_and_off(dataset):
    torch.manual_seed(0)
    plain = _results(dataset)
    torch.manual_seed(0)
    traced, _ = _traced(lambda: _results(dataset))
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_trace_window_holds_the_spans_under_its_iterations(dataset,
                                                           tmp_path):
    """Iterations 4 and 5 traced, densify at 5: every stage span lies in
    an `iteration i` range, each range holds one `step`, the 5th also
    `densify` and the round's stages; outside the window the spans are off
    again."""
    trainer = _trainer(dataset, summary_writer_log_dir=str(tmp_path),
                       num_iterations=7, val_interval=10 ** 6,
                       enable_profiler=True, profiler_start_iteration=4,
                       profiler_num_steps=2)
    trainer.train()
    trainer.logger.close()
    assert not P._spans_on
    files = P.trace_files(str(tmp_path))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"]: e for e in events if e.get("ph") == "X"
              and e["name"].startswith("iteration ")}
    assert sorted(ranges) == ["iteration 4", "iteration 5"]
    spans = [e for e in events if e.get("ph") == "X"
             and e["name"].startswith(P.SPAN_PREFIX)]
    held = {name: [] for name in ranges}
    for s in spans:
        inside = [name for name, r in ranges.items()
                  if r["ts"] <= s["ts"] and s["ts"] + s["dur"]
                  <= r["ts"] + r["dur"]]
        assert len(inside) == 1, s["name"]
        held[inside[0]].append(s["name"][len(P.SPAN_PREFIX):])
    assert sorted(set(held["iteration 4"])) == sorted(STEP)
    assert sorted(set(held["iteration 5"])) == sorted(
        list(STEP) + ["densify", "densify/masks", "densify/assign",
                      "densify/fill", "densify/log"])
    assert held["iteration 4"].count("step") == 1
    s = P.summarize_trace(events)["stages"]
    assert s["spans"]["step"]["calls_per_range"] == 1.0
    assert s["spans"]["densify"]["calls_per_range"] == 0.5
    assert s["spans"]["binning/key count read"]["parent"] == \
        "binning/emission"


# ---------------------------------------------------------------------------
# the span table of a trace
# ---------------------------------------------------------------------------

def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _known_events():
    """Two ranges over [0, 200) us on thread 1, kernels busy [0, 10),
    [30, 40), [60, 70), [120, 130), [150, 160), [195, 230); so idle gaps
    [10, 30), [40, 60), [70, 120), [130, 150), [160, 195). Range 1 holds
    `frame` [5, 90) around `binning` [20, 80), around `binning/sort`
    [50, 75); range 2 holds `frame` [140, 180) around `projection`
    [140, 150); [100, 140) and [180, 200) lie outside any span. A span on
    another thread and a `cpu_op` are not read."""
    return [
        _x("user_annotation", "iteration 0", 0, 100),
        _x("user_annotation", "iteration 1", 100, 100),
        _x("user_annotation", "t3dgs/frame", 5, 85),
        _x("user_annotation", "t3dgs/binning", 20, 60),
        _x("user_annotation", "t3dgs/binning/sort", 50, 25),
        _x("user_annotation", "t3dgs/frame", 140, 40),
        _x("user_annotation", "t3dgs/projection", 140, 10),
        _x("user_annotation", "t3dgs/adam", 0, 200, tid=2),
        _x("cpu_op", "aten::sort", 50, 25),
        _x("kernel", "a", 0, 10, tid=7), _x("kernel", "b", 30, 10, tid=7),
        _x("kernel", "c", 60, 10, tid=7), _x("kernel", "d", 120, 10, tid=7),
        _x("kernel", "e", 150, 10, tid=7), _x("kernel", "f", 195, 35, tid=7),
    ]


def test_span_table_on_known_events():
    """Gap [10, 30) begins in `frame` (self), [40, 60) in `binning`, [70,
    120) in `binning/sort` though it ends outside, [130, 150) outside any
    span, [160, 195) in `frame` (self, range 2). Host self time: frame 85
    - 60 + 40 - 10, binning 60 - 25, sort 25, projection 10."""
    s = P.summarize_trace(_known_events())
    t = s["stages"]
    assert list(t["spans"]) == ["frame", "binning", "binning/sort",
                                "projection"]
    rows = t["spans"]
    assert rows["frame"]["parent"] is None
    assert rows["binning"]["parent"] == "frame"
    assert rows["binning/sort"]["parent"] == "binning"
    assert rows["projection"]["parent"] == "frame"
    assert rows["frame"]["calls_per_range"] == 1.0
    assert rows["binning"]["calls_per_range"] == 0.5
    for name, host_us, idle_us in (("frame", 55, 55), ("binning", 35, 20),
                                   ("binning/sort", 25, 50),
                                   ("projection", 10, 0)):
        assert rows[name]["host_ms_per_range"] == pytest.approx(
            host_us / 1000.0 / 2), name
        assert rows[name]["idle_ms_per_range"] == pytest.approx(
            idle_us / 1000.0 / 2), name
    assert t["idle_ms_per_range"] == pytest.approx(0.145 / 2)
    assert t["outside_idle_ms_per_range"] == pytest.approx(0.020 / 2)
    assert t["named_idle_share"] == pytest.approx(125.0 / 145.0)
    # the spans change nothing else the summary reports
    plain = P.summarize_trace([e for e in _known_events()
                               if not e["name"].startswith(P.SPAN_PREFIX)])
    assert plain["stages"]["spans"] == {}
    assert plain["stages"]["named_idle_share"] == 0.0
    assert {k: v for k, v in s.items() if k != "stages"} == \
        {k: v for k, v in plain.items() if k != "stages"}
    assert s["busy_share"] == pytest.approx(85.0 / 230.0)


def test_format_summary_prints_the_span_table():
    text = P.format_summary(P.summarize_trace(_known_events()), "frame")
    assert "stage spans per frame: device idle 0.0725 ms, 86.21% of it " \
           "begun inside a span (0.0100 ms outside any)" in text
    assert "    0.0175 ms    0.0100 ms    0.50    binning\n" in text
    assert "    0.0125 ms    0.0250 ms    0.50      binning/sort\n" in text
    plain = P.format_summary(P.summarize_trace(_known_events()[:2]))
    assert "stage spans" not in plain
