"""The port's trainer trace (`enable_profiler`) and the last small pieces
of the JAX package it carries: `CameraView` / `CameraDatabase` and
`config.to_yaml`; the entry points' default device.

On the 32x32 dataset of tests/torch_train_fixtures.py, on the CPU (the
trace holds CPU activity only there): a profiled run writes one trace
file under `<logdir>/profile/` with one `iteration i` range per traced
step, also when the run ends inside the window; it ends bitwise equal to
an unprofiled run; with the profiler off no `profile/` directory appears.
`summarize_trace` is held on a hand-made event list whose answer is known.
"""

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch
import yaml

from taichi_3d_gaussian_splatting_tpu import camera as jcamera
from taichi_3d_gaussian_splatting_tpu import config as jconfig
from taichi_3d_gaussian_splatting_tpu.training import trainer as JT
from taichi_3d_gaussian_splatting_torch import camera as tcamera
from taichi_3d_gaussian_splatting_torch import config as tconfig
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene)
from taichi_3d_gaussian_splatting_torch.parallel import dryrun
from taichi_3d_gaussian_splatting_torch.training import adam as TA
from taichi_3d_gaussian_splatting_torch.training import controller as TC
from taichi_3d_gaussian_splatting_torch.training import trainer as TT
from taichi_3d_gaussian_splatting_torch.utils import profiling as P

from torch_train_fixtures import config_dict, write_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trace_data"))
    write_dataset(root)
    return root


def _run(dataset, logdir, **over):
    """A port-only run on the CPU; returns the trainer after train()."""
    d = config_dict(dataset, summary_writer_log_dir=str(logdir),
                    val_interval=10 ** 6, **over)
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, d), device="cpu")
    trainer.train()
    trainer.logger.close()
    return trainer


def _ranges(path, prefix="iteration "):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(e["name"] for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(prefix))


# ---------------------------------------------------------------------------
# the trace window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [1, 2])
def test_profiled_run_writes_one_trace_of_its_window(dataset, tmp_path,
                                                     batch_size):
    _run(dataset, tmp_path / "logs", num_iterations=6, batch_size=batch_size,
         enable_profiler=True, profiler_start_iteration=2,
         profiler_num_steps=2)
    files = P.trace_files(str(tmp_path / "logs"))
    assert len(files) == 1, files
    assert os.path.basename(files[0]).startswith("rank0.")
    assert os.listdir(tmp_path / "logs" / "profile") == [
        os.path.basename(files[0])]
    assert _ranges(files[0]) == ["iteration 2", "iteration 3"]
    summary = P.summarize_trace(P.load_events(files[0]))
    assert summary["ranges"] == 2
    assert summary["kernels"] == 0      # the CPU has no kernel events


def test_profiled_run_ends_bitwise_equal(dataset, tmp_path):
    """Six steps with densify at 5: scene, Adam moments, controller state
    and generators equal to the last bit with and without the trace."""
    plain = _run(dataset, tmp_path / "plain", num_iterations=6)
    traced = _run(dataset, tmp_path / "traced", num_iterations=6,
                  enable_profiler=True, profiler_start_iteration=1,
                  profiler_num_steps=4)
    assert len(P.trace_files(str(tmp_path / "traced"))) == 1
    want, got = plain.state_arrays(), traced.state_arrays()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_run_ending_inside_the_window_writes_its_trace(dataset, tmp_path):
    _run(dataset, tmp_path / "logs", num_iterations=4, enable_profiler=True,
         profiler_start_iteration=2, profiler_num_steps=5)
    files = P.trace_files(str(tmp_path / "logs"))
    assert len(files) == 1
    assert _ranges(files[0]) == ["iteration 2", "iteration 3"]


def test_run_failing_inside_the_window_writes_its_trace(dataset, tmp_path,
                                                        monkeypatch):
    d = config_dict(dataset, summary_writer_log_dir=str(tmp_path / "logs"),
                    num_iterations=8, enable_profiler=True,
                    profiler_start_iteration=2, profiler_num_steps=4)
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, d), device="cpu")
    step = trainer.step
    calls = []

    def failing_step(*args, **kwargs):
        calls.append(1)
        if len(calls) == 4:     # iteration 3
            raise RuntimeError("step failed")
        return step(*args, **kwargs)

    monkeypatch.setattr(trainer, "step", failing_step)
    with pytest.raises(RuntimeError, match="step failed"):
        trainer.train()
    trainer.logger.close()
    files = P.trace_files(str(tmp_path / "logs"))
    assert len(files) == 1
    assert _ranges(files[0]) == ["iteration 2", "iteration 3"]


def test_profiler_off_writes_no_profile_dir(dataset, tmp_path):
    _run(dataset, tmp_path / "logs", num_iterations=3,
         profiler_start_iteration=0, profiler_num_steps=2)
    assert (tmp_path / "logs" / "metrics.jsonl").exists()
    assert not (tmp_path / "logs" / "profile").exists()
    assert P.trace_files(str(tmp_path / "logs")) == []


# ---------------------------------------------------------------------------
# the trace summary
# ---------------------------------------------------------------------------

def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_kernel_base_name():
    assert P.kernel_base_name(
        "void blend_forward_kernel<false, false>(float const*, int)") == \
        "blend_forward_kernel"
    assert P.kernel_base_name(
        "(anonymous namespace)::build_work_kernel(int const*, int)") == \
        "build_work_kernel"
    assert P.kernel_base_name(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float> >(int)") == \
        "vectorized_elementwise_kernel"


def test_summarize_trace_on_known_events():
    """Two ranges over [0, 100) us; kernels busy [10, 30) u [20, 40) u
    [60, 70) u [95, 120): the window ends at 120 (the last kernel), busy
    65 of 120 us. The work-list kernel before each blend kernel joins its
    family; a kernel before the first range is outside."""
    fwd = "void blend_forward_kernel<false, false>(float const*)"
    bwd = "void blend_backward_kernel(float const*)"
    work = "build_work_kernel(int const*)"
    events = [
        _x("user_annotation", "iteration 4", 0, 50),
        _x("user_annotation", "iteration 5", 50, 50),
        _x("user_annotation", "other", 0, 100),
        _x("kernel", "early", -20, 10),
        _x("kernel", work, 10, 20),
        _x("kernel", fwd, 20, 20),
        _x("kernel", work, 60, 4),
        _x("kernel", bwd, 64, 6),
        _x("kernel", fwd, 95, 25),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 30},
    ]
    s = P.summarize_trace(events)
    assert s["ranges"] == 2 and s["kernels"] == 5
    assert s["window_ms"] == pytest.approx(0.120)
    assert s["busy_share"] == pytest.approx(65.0 / 120.0)
    assert s["launches_per_range"] == pytest.approx(2.5)
    assert s["kernel_ms_per_range"] == pytest.approx(0.075 / 2)
    fam = s["blend"]
    assert fam["forward"]["ms_per_range"] == pytest.approx(0.065 / 2)
    assert fam["forward"]["launches_per_range"] == pytest.approx(1.0)
    assert fam["forward"]["kernels"]["build_work_kernel"] == pytest.approx(
        0.01)
    assert fam["backward"]["ms_per_range"] == pytest.approx(0.010 / 2)
    assert fam["backward"]["launches_per_range"] == pytest.approx(0.5)
    assert [r["name"] for r in s["top"]] == [fwd, work, bwd]
    assert s["top"][0]["launches_per_range"] == pytest.approx(1.0)
    assert s["top"][0]["mean_us"] == pytest.approx(22.5)
    assert [r["name"] for r in s["top_ops"]] == [
        "[blend_forward_kernel]", "[build_work_kernel]",
        "[blend_backward_kernel]"]
    text = P.format_summary(s)
    assert "busy 54.17%" in text and "blend forward" in text
    assert "host ops" in text
    with pytest.raises(ValueError, match="frame"):
        P.summarize_trace(events, prefix="frame ")


def test_summarize_trace_reports_the_projection_kernels():
    """The projection kernels are counted per range on their own, beside
    the blend families, whatever their template arguments."""
    events = [
        _x("user_annotation", "iteration 1", 0, 50),
        _x("user_annotation", "iteration 2", 50, 50),
        _x("kernel", "void t3dgs_proj::(anonymous namespace)::"
           "projection_forward_kernel(float const*)", 5, 4),
        _x("kernel", "void t3dgs_proj::(anonymous namespace)::"
           "projection_backward_kernel(float const*)", 20, 8),
        _x("kernel", "projection_forward_kernel(float const*)", 55, 6),
    ]
    s = P.summarize_trace(events)
    proj = s["projection"]
    assert proj["forward"]["launches_per_range"] == pytest.approx(1.0)
    assert proj["forward"]["ms_per_range"] == pytest.approx(0.005)
    assert proj["backward"]["launches_per_range"] == pytest.approx(0.5)
    assert proj["backward"]["ms_per_range"] == pytest.approx(0.004)
    assert s["blend"]["forward"]["launches_per_range"] == 0.0
    assert "projection backward: 0.0040 ms" in P.format_summary(s)


def test_summarize_trace_reports_the_optimizer_kernel():
    """The optimizer kernel is counted per range on its own."""
    events = [
        _x("user_annotation", "iteration 1", 0, 50),
        _x("user_annotation", "iteration 2", 50, 50),
        _x("kernel", "t3dgs_opt::(anonymous namespace)::"
           "optimizer_update_kernel(int, float4 const*)", 30, 12),
        _x("kernel", "t3dgs_opt::(anonymous namespace)::"
           "optimizer_update_kernel(int, float4 const*)", 80, 10),
    ]
    s = P.summarize_trace(events)
    assert s["optimizer"]["launches_per_range"] == pytest.approx(1.0)
    assert s["optimizer"]["ms_per_range"] == pytest.approx(0.011)
    assert s["projection"]["forward"]["launches_per_range"] == 0.0
    assert "optimizer: 0.0110 ms and 1.00 launches" in P.format_summary(s)


def test_launching_ops_take_the_outermost_op_of_the_call():
    """A kernel is charged to the outermost CPU op around the runtime call
    of the same correlation id, on that call's thread (an op and its child
    may start together); a launch outside any op keeps its kernel's
    name."""
    def call(corr, tid, ts):
        return dict(_x("cuda_runtime", "cudaLaunchKernel", ts, 1), tid=tid,
                    pid=1, args={"correlation": corr})

    def op(name, tid, ts, dur):
        return dict(_x("cpu_op", name, ts, dur), tid=tid, pid=1)

    def kernel(name, corr, ts):
        return dict(_x("kernel", name, ts, 5), tid=7, pid=0,
                    args={"correlation": corr})

    kernels = [kernel("fill", 1, 20), kernel("mul", 2, 30),
               kernel("void ns::blend_backward_kernel(int)", 3, 40),
               kernel("add", 4, 50), kernel("void orphan<1>(int)", 9, 60)]
    events = kernels + [
        op("aten::zero_", 1, 10, 4), op("aten::zeros", 1, 10, 8),
        call(1, 1, 12),
        op("autograd::engine::evaluate_function: MulBackward0", 2, 20, 10),
        op("aten::mul", 2, 21, 5), call(2, 2, 22),
        call(3, 1, 25),
        op("aten::add_", 1, 30, 5), call(4, 1, 31),
    ]
    assert P._launching_ops(events, kernels) == [
        "aten::zeros", "autograd::engine::evaluate_function: MulBackward0",
        "[blend_backward_kernel]", "aten::add_", "[orphan]"]


# ---------------------------------------------------------------------------
# CameraView / CameraDatabase, to_yaml, the default device
# ---------------------------------------------------------------------------

def test_camera_database_matches_jax():
    intr = np.array([[25.0, 0, 16], [0, 25.0, 16], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.1, -0.2, 0.3)
    dbs = []
    for mod in (jcamera, tcamera):
        db = mod.CameraDatabase()
        for cam_id in (0, 3):
            db.add_camera_info(mod.CameraInfo(intr * (cam_id + 1), 32, 48,
                                              camera_id=cam_id))
        db.add_camera_view(mod.CameraView(7, pose, 3, 11))
        db.add_camera_view(mod.CameraView(8, pose * 2, 0, 12,
                                          timestamp=1000))
        dbs.append(db)
    jdb, tdb = dbs
    for view_id in (7, 8):
        (jv, ji), (tv, ti) = (db.get_camera_view_and_info(view_id)
                              for db in dbs)
        assert dataclasses.asdict(tv).keys() == dataclasses.asdict(jv).keys()
        for k, v in dataclasses.asdict(jv).items():
            np.testing.assert_array_equal(getattr(tv, k), v, err_msg=k)
        np.testing.assert_array_equal(ti.camera_intrinsics,
                                      ji.camera_intrinsics)
        assert (ti.camera_height, ti.camera_width, ti.camera_id) == (
            ji.camera_height, ji.camera_width, ji.camera_id)
    assert tdb.get_camera_info(3).camera_id == jdb.get_camera_info(3).camera_id
    with pytest.raises(KeyError):
        tdb.get_camera_view_and_info(9)


def test_to_yaml_matches_jax():
    """yaml.safe_load of both packages' to_yaml(TrainConfig()) agree on
    every shared key, nested configs included; the port's reads back."""
    t = yaml.safe_load(tconfig.to_yaml(TT.TrainConfig()))
    j = yaml.safe_load(jconfig.to_yaml(JT.TrainConfig()))

    def same(a, b, where):
        shared = set(a) & set(b)
        assert shared, where
        for k in shared:
            if isinstance(b[k], dict):
                same(a[k], b[k], f"{where}.{k}")
            else:
                assert a[k] == b[k], (f"{where}.{k}", a[k], b[k])
    same(t, j, "TrainConfig")
    assert tconfig.to_yaml(tconfig.from_dict(TT.TrainConfig, t)) == \
        tconfig.to_yaml(TT.TrainConfig())


DEFAULT_CUDA = [
    (TScene.from_numpy, "device"), (TScene.from_arrays, "device"),
    (TScene.from_parquet, "device"), (TScene.from_ply, "device"),
    (TC.ControllerState.zeros, "device"),
    (TC.ControllerState.from_numpy, "device"),
    (TA.adam_state_from_optax, "device"),
    (dryrun.dryrun_multichip, "device"), (dryrun.spawn_ranks, "device"),
    (TT.GaussianPointCloudTrainer.__init__, "device"),
]


@pytest.mark.parametrize("fn,arg", DEFAULT_CUDA,
                         ids=[f.__qualname__ for f, _ in DEFAULT_CUDA])
def test_entry_points_default_to_the_card(fn, arg):
    """Nothing runs on the CPU unless the caller asks for it."""
    assert inspect.signature(fn).parameters[arg].default == "cuda"
