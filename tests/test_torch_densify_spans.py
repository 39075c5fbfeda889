"""The density controller's spans and counters, on the CPU at 32x32.

Inside `tracing()`, under torch.profiler, an iteration of
`train_iteration` with a densify round and an alpha reset emits the
step's spans, `densify` around `densify/masks`, `densify/assign`,
`densify/fill` and `densify/log`, and `reset alpha`; the `mark` hook sees
them in that order; with spans on, or a mark given, the round is bitwise
the round with neither; and `round_counts` adds up to the counts the
trainer logged, round by round."""

import json
import os

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_torch import config as tconfig
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene)
from taichi_3d_gaussian_splatting_torch.ops.rasterizer import BackwardStats
from taichi_3d_gaussian_splatting_torch.training import controller as TC
from taichi_3d_gaussian_splatting_torch.training import trainer as TT
from taichi_3d_gaussian_splatting_torch.utils import profiling as P

from torch_train_fixtures import config_dict, write_dataset

torch.set_num_threads(1)

STEP_MARKS = ["projection", "binning", "forward blend", "loss",
              "backward blend", "routing", "projection backward", "adam"]
ROUND = ["densify/masks", "densify/assign", "densify/fill", "densify/log"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("densify_span_data"))
    write_dataset(root)
    return root


def _trainer(dataset, logdir, **over):
    ctrl = dict(num_iterations_warm_up=5, num_iterations_densify=5,
                num_iterations_reset_alpha=10,
                transparent_alpha_threshold=-3.0,
                densification_view_space_position_gradients_threshold=1e-4)
    trainer = TT.GaussianPointCloudTrainer(tconfig.from_dict(
        TT.TrainConfig, config_dict(
            dataset, summary_writer_log_dir=logdir, output_model_dir=logdir,
            adaptive_controller_config=ctrl, **over)), device="cpu")
    trainer.logger.tb = None
    return trainer


def _iterate(trainer, iterations, mark=None):
    cache = trainer._device_cache(trainer.train_dataset, 1)
    trainer._pos = len(trainer.train_dataset)
    kwargs = {} if mark is None else {"mark": mark}
    for it in iterations:
        trainer.train_iteration(it, *trainer._next_views(cache, None, 1, 1),
                                **kwargs)


def _spans(events):
    """(name, start, end) of each stage span of a profiler's events."""
    return [(e.name[len(P.SPAN_PREFIX):], e.time_range.start,
             e.time_range.end) for e in events
            if e.name.startswith(P.SPAN_PREFIX)]


def test_round_spans_nest_under_densify_and_marks_keep_order(dataset,
                                                             tmp_path):
    trainer = _trainer(dataset, str(tmp_path))
    _iterate(trainer, range(0, 9))
    cache = trainer._device_cache(trainer.train_dataset, 1)
    views = trainer._next_views(cache, None, 1, 1)
    marks = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.tracing():
            trainer.train_iteration(10, *views, mark=marks.append)
    trainer.logger.close()
    assert marks == STEP_MARKS + ROUND + ["densify", "reset alpha"]
    spans = _spans(prof.events())
    names = [s[0] for s in spans]
    assert sorted(set(names)) == sorted(
        ["step"] + STEP_MARKS + ["binning/emission", "binning/key count read",
                                 "binning/sort", "binning/gather",
                                 "forward blend/layout"]
        + ROUND + ["densify", "reset alpha"])
    (_, d0, d1), = [s for s in spans if s[0] == "densify"]
    for name in ROUND:
        (_, a, b), = [s for s in spans if s[0] == name]
        assert d0 <= a <= b <= d1, name
    (_, r0, _), = [s for s in spans if s[0] == "reset alpha"]
    (_, _, s1), = [s for s in spans if s[0] == "step"]
    assert s1 <= d0 and d1 <= r0


def _round_inputs(seed=11, n=64):
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(n, 3)).astype(np.float32)
    feats = (rng.normal(size=(n, 56)) * 0.3).astype(np.float32)
    q = rng.normal(size=(n, 4))
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-3, -1, (n, 3))
    feats[:, 7] = rng.uniform(-1, 3, n)
    scene = TScene.from_numpy(pc, feats, (rng.random(n) < 0.3),
                              np.zeros(n), device="cpu")
    acc = TC.ControllerState.from_numpy(
        [rng.integers(0, 3000, n), rng.integers(0, 5, n),
         rng.random(n) * 1e-4, rng.random(n) * 1e-7,
         rng.normal(size=(n, 3)) * 1e-3, rng.random(n) * 1e-3], "cpu")
    stats = BackwardStats(torch.zeros(n, 2),
                          torch.tensor(rng.random(n) * 2e-5,
                                       dtype=torch.float32),
                          torch.tensor(rng.integers(0, 2000, n),
                                       dtype=torch.int32),
                          torch.zeros(4, 4, 2))
    return (scene, acc, stats, torch.tensor(rng.random(n) < 0.8),
            torch.tensor(rng.uniform(1, 20, n), dtype=torch.float32),
            torch.tensor(pc + 1e-3))


@pytest.mark.parametrize("how", ["spans on", "a mark"])
def test_spans_and_marks_leave_the_round_bitwise_unchanged(how):
    cfg = TC.AdaptiveControllerConfig(
        densification_view_space_position_gradients_threshold=3e-6,
        under_reconstructed_num_pixels_threshold=1500,
        transparent_alpha_threshold=-0.5)
    args = _round_inputs()
    plain = TC.densify_step(*args, 100, torch.Generator().manual_seed(1),
                            cfg)
    marks = []
    if how == "spans on":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with P.tracing():
                other = TC.densify_step(*args, 100, torch.Generator(
                    ).manual_seed(1), cfg)
    else:
        other = TC.densify_step(*args, 100, torch.Generator().manual_seed(1),
                                cfg, marks.append)
        assert marks == ROUND[:3]
    assert int(plain[2].num_fillable) > 0
    for a, b in zip(plain[0] + plain[1] + plain[2][:6],
                    other[0] + other[1] + other[2][:6]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_round_counts_add_up_to_the_logged_rounds(dataset, tmp_path):
    trainer = _trainer(dataset, str(tmp_path), num_iterations=31)
    TC.reset_round_counts()
    trainer.train()
    trainer.logger.close()
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        rounds = [r for r in map(json.loads, f)
                  if "densify/num_fillable" in r]
    assert [r["iteration"] for r in rounds] == [5, 10, 15, 20, 25, 30]

    def total(key):
        return sum(int(r[key]) for r in rounds)

    added = total("densify/num_fillable")
    splits = total("densify/num_over_reconstructed")
    assert added > 0
    assert {k: int(v) for k, v in TC.round_counts.items()} == {
        "rounds": 6, "points_added": added,
        "points_pruned": (total("densify/num_transparent")
                          + total("densify/num_floaters")),
        "splits": splits, "clones": added - splits}
    TC.reset_round_counts()
    assert set(TC.round_counts.values()) == {0}
