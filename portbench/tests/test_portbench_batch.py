"""The `train_batch` kind at a tiny size on the CPU (its own benchmark
fixture, `data/benchmark-batch.json`): the cell's pieces resolve by name,
a sound run is correct, the reference's batches are the trainer's, the
reader and the work model read what the driver gives, and these come out
not correct: the control (the reference in bfloat16), a step that leaves
one of its four views out, a step that averages the views where the port
sums them, and a step with the betas unscaled."""

import contextlib
import io
import json
import shutil
import tempfile
import time
import types

import pytest
import torch

from conftest import DATA
from portbench.harness import spec
from portbench.reference import compare

BENCHMARK = DATA + "/benchmark-batch.json"
CELL = "tiny-train-batch4"
TRAIN_METRICS = {"device_idle_pct.train", "mfu.train",
                 "blend_bwd_roofline.train", "binning_ms.train",
                 "loss_ms.train", "adam_ms.train"}


def _run(seed=2147483999, seconds=0.5):
    from portbench.harness.main import main
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", "0"], time.time(),
                  require_card=False, benchmark_path=BENCHMARK, pieces=DATA)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def _fails(readings, limits):
    return any(not readings[k] <= v for k, v in limits.items())


def test_the_cells_pieces_resolve():
    c = spec.load_cell("truck2m-train-batch4")
    assert c.chips == 1 and c.config["points"] == 2080000
    assert c.config["train"]["slots_ratio"] == 2.0
    train = c.config["train"]
    assert (train["batch_size"], train["scale_lr_with_batch"],
            train["scale_schedules_with_batch"],
            train["scale_betas_with_batch"]) == (4, "sqrt", True, True)
    late = spec.load_cell("truck2m-train-late")
    assert {k: v for k, v in train.items() if not k.startswith(
        ("batch", "scale_"))} == late.config["train"]
    assert {k: v for k, v in c.traffic.items() if k not in (
        "kind", "loop", "stands_for", "checked_steps", "work_views",
        "events_steps", "trace_steps")} == {
        k: v for k, v in late.traffic.items() if k not in (
            "kind", "loop", "stands_for", "checked_steps", "work_views",
            "events_steps", "trace_steps")}
    drv = spec.driver(c.traffic["kind"])
    for name in ("run", "make_inputs", "write_dataset", "open_trainer",
                 "program_side", "reference_side"):
        assert callable(getattr(drv, name)), name
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "step_ms"}
    assert {m["name"] for m in c.per_layer} == TRAIN_METRICS | {
        "accumulate_ms.train"}
    tiny = spec.load_cell(CELL, BENCHMARK, DATA)
    assert tiny.limits == c.limits


def test_the_readers_read_what_the_driver_gives():
    r = {"stages_ms": {"accumulate": 3.5, "adam": 2.5, "loss": 0.25,
                       "binning": 8.0}}
    assert spec.reader("accumulate_ms.train")(r) == 3.5
    assert spec.reader("adam_ms.train")(r) == 2.5
    assert spec.reader("accumulate_ms.train")({"unit_ms": 3.0}) is None


def test_batch_work_counts_four_views_and_one_update():
    from portbench.work.batch import batch_step_work
    from portbench.work.unit import OPTIMIZER_OPS_PER_SLOT
    slots, view_flops, k3 = 1000, 5e6, 0.25
    w = batch_step_work(view_flops, k3, 4, slots)
    rest = view_flops - OPTIMIZER_OPS_PER_SLOT * slots
    assert w["flops"] == 4 * rest + (4 * (20 + 112 + 59) + 1074) * slots
    assert w["blend_backward_bound_ms"] == 4 * k3
    one = batch_step_work(view_flops, k3, 1, slots)
    assert one["flops"] == view_flops + 59 * slots


@pytest.mark.parametrize("views,size,steps", [(6, 4, 4), (8, 4, 3),
                                              (5, 2, 6)])
def test_the_reference_takes_the_trainers_batches(views, size, steps):
    """`batches_in_order` against the trainer's own `_next_views` on a
    cache of `views` views, the same generator seed."""
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer as T)
    drv = spec.driver("train_batch")
    seed = 2147483999
    images = torch.arange(views, dtype=torch.uint8).reshape(views, 1, 1, 1)
    cache = (None, images, torch.zeros(views, 1, 4),
             torch.zeros(views, 1, 3), torch.zeros(views, 3, 3).numpy())
    fake = types.SimpleNamespace(_pos=views, _perm=None,
                                 data_generator=torch.Generator()
                                 .manual_seed(seed))
    got = []
    for _ in range(steps):
        imgs = T._next_views(fake, cache, None, 1, size)[0]
        got.append([int(round(float(v) * 255.0)) for v in imgs.flatten()])
    assert got == drv.batches_in_order(seed, views, size, steps)


def test_a_sound_run_is_correct():
    rc, line, err = _run()
    assert rc == 0 and line["correct"] is True, err[-2000:]
    assert set(line["metrics"]) == {"setup_s", "step_ms"}
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                   "stats_gap"}
    assert line["attempted"] > 0


def test_control_and_a_dropped_view_fail():
    cell = spec.load_cell(CELL, BENCHMARK, DATA)
    drv = spec.driver("train_batch")
    device = torch.device("cpu")
    seed = 5
    x = drv.make_inputs(cell, seed, device)
    root = tempfile.mkdtemp()
    try:
        paths = drv.write_dataset(x, root)
        trainer, _, one_step = drv.open_trainer(cell, seed, paths, root,
                                                device)
        prog = drv.program_side(cell, trainer, one_step)
        trainer.logger.close()
    finally:
        shutil.rmtree(root)
    ref = drv.reference_side(cell, x, seed, device)
    ctl = drv.reference_side(cell, x, seed, device, dtype=torch.bfloat16)
    dropped = drv.reference_side(cell, x, seed, device, drop_view=True)
    assert not _fails(compare.train_readings(prog, ref), cell.limits)
    assert _fails(compare.train_readings(ctl, ref), cell.limits)
    assert _fails(compare.train_readings(dropped, ref), cell.limits)


def test_a_step_leaving_a_view_out_is_not_correct(monkeypatch):
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer as T)
    batch_step = T.batch_step

    def three(self, images, qs, ts, intrs, *a, **k):
        return batch_step(self, images[:-1], qs[:-1], ts[:-1], intrs[:-1],
                          *a, **k)

    monkeypatch.setattr(T, "batch_step", three)
    rc, line, _ = _run()
    assert rc == 0 and line["correct"] is False


def test_a_step_averaging_the_views_is_not_correct(monkeypatch):
    from taichi_3d_gaussian_splatting_torch.training.step import TrainStep
    update = TrainStep.update

    def averaged(self, scene, opt_f, opt_p, ctrl, grad_feats, grad_pc, *a,
                 **k):
        return update(self, scene, opt_f, opt_p, ctrl, grad_feats / 4.0,
                      grad_pc / 4.0, *a, **k)

    monkeypatch.setattr(TrainStep, "update", averaged)
    rc, line, _ = _run()
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["grad_gap"]["value"] > 0.5


def test_a_step_with_unscaled_betas_is_not_correct(monkeypatch):
    from taichi_3d_gaussian_splatting_torch.training import trainer as T
    group = T.AdamGroup

    def unscaled(lr, b1=0.9, b2=0.999, eps=1e-8):
        return group(lr, 0.9, 0.999, eps)

    monkeypatch.setattr(T, "AdamGroup", unscaled)
    rc, line, _ = _run()
    assert rc == 0 and line["correct"] is False
