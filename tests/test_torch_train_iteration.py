"""`GaussianPointCloudTrainer.train_iteration` holds the schedule that
`train()` ran inline: a run through it is bitwise the run of the loop as
it stood before, replayed here. On the CPU at 32x32, 21 iterations with
densify rounds (every 5 from 5) and alpha resets (every 10), one view a
step and two: the scene, both Adam states, the controller's accumulators,
both generators' states and every logged record (less the wall clock's)
agree; and a run resumed from a checkpoint at 12 through
`train_iteration` alone, as the benchmark drives it, is bitwise the same
run's second half."""

import collections
import dataclasses
import json
import os

import pytest
import torch

from taichi_3d_gaussian_splatting_torch import config as tconfig
from taichi_3d_gaussian_splatting_torch.training import controller as TC
from taichi_3d_gaussian_splatting_torch.training import trainer as TT
from taichi_3d_gaussian_splatting_torch.utils.profiling import span

from torch_train_fixtures import config_dict, write_dataset

torch.set_num_threads(1)

WALL_CLOCK = ("train/iter_wall_seconds", "val/inference_time")


def _old_densify(self, iteration, out, pos_before, cam):
    """`_densify` as it stood before `train_iteration`."""
    ctrl_cfg = self.config.adaptive_controller_config
    stats, in_frustum, point_depth, point_uv = out.densify_inputs
    self._log_histograms(iteration, stats)
    self.scene, self.ctrl_state, counts = TC.densify_step(
        self.scene, self.ctrl_state, stats, in_frustum, point_depth,
        pos_before, iteration, self.generator, ctrl_cfg)
    self.logger.scalars(iteration, {
        "densify/num_transparent": counts.num_transparent,
        "densify/num_floaters": counts.num_floaters,
        "densify/num_candidates": counts.num_candidates,
        "densify/num_fillable": counts.num_fillable,
        "densify/num_over_reconstructed": counts.num_over_reconstructed,
        "value/num_valid_points": counts.num_valid_after,
    })


def _old_train(self):
    """`train()`'s loop as it stood before `train_iteration`, without the
    profiler window, the progress bar and the image panels."""
    config = self.config
    ctrl_cfg = config.adaptive_controller_config
    cache, cache_factor = None, -1
    downsample_factor = config.initial_downsample_factor
    recent_losses = collections.deque(maxlen=100)
    pending = []
    self._previous_problematic_iteration = -1000
    self._last_containment_warn = -1000
    for iteration in range(self.start_iteration, config.num_iterations):
        if (iteration % config.half_downsample_factor_interval == 0
                and iteration > 0 and downsample_factor > 1):
            downsample_factor //= 2
        sh_band = iteration // config.increase_color_max_sh_band_interval
        if cache_factor != downsample_factor:
            cache = self._device_cache(self.train_dataset, downsample_factor)
            cache_factor = downsample_factor
            self._pos = len(self.train_dataset)
        densify_due = (iteration >= ctrl_cfg.num_iterations_warm_up
                       and iteration % ctrl_cfg.num_iterations_densify == 0)
        pos_before = (self.scene.point_cloud.clone() if densify_due
                      else None)
        images, qs, ts, intrs, cam = self._next_views(
            cache, None, downsample_factor, config.batch_size)
        if config.batch_size == 1:
            out = self.step(images[0], qs[0], ts[0], sh_band,
                            dataclasses.replace(
                                cam, camera_intrinsics=intrs[0]))
        else:
            out = self.batch_step(images, qs, ts, intrs, sh_band, cam)
        if densify_due:
            with span("densify"):
                _old_densify(self, iteration, out, pos_before, cam)
        if (iteration >= ctrl_cfg.num_iterations_warm_up
                and iteration % ctrl_cfg.num_iterations_reset_alpha == 0):
            self.scene = TC.reset_alpha(self.scene, ctrl_cfg)
        pending.append((iteration, out.metrics, 0.0))
        validation_due = (iteration % config.val_interval == 0
                          and iteration != 0)
        if (iteration % config.log_loss_interval == 0 or validation_due
                or iteration == config.num_iterations - 1):
            self._flush_metrics(pending, recent_losses)
            pending = []
        if validation_due:
            self.validation(iteration)
    self.validation(config.num_iterations, completed=config.num_iterations)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("iteration_data"))
    write_dataset(root, n_views=4)
    return root


def _config(dataset, logdir, **over):
    ctrl = dict(num_iterations_warm_up=5, num_iterations_densify=5,
                num_iterations_reset_alpha=10,
                transparent_alpha_threshold=-3.0,
                densification_view_space_position_gradients_threshold=1e-4)
    return tconfig.from_dict(TT.TrainConfig, config_dict(
        dataset, summary_writer_log_dir=logdir, output_model_dir=logdir,
        adaptive_controller_config=ctrl, **over))


def _trainer(config):
    trainer = TT.GaussianPointCloudTrainer(config, device="cpu")
    trainer.logger.tb = None
    return trainer


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in WALL_CLOCK} for line in f]


def _assert_same_state(a, b):
    sa, sb = a.state_arrays(), b.state_arrays()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("batch_size", [1, 2])
def test_train_is_bitwise_the_old_loop(dataset, tmp_path, batch_size):
    runs = {}
    for name, loop in (("old", _old_train),
                       ("new", TT.GaussianPointCloudTrainer.train)):
        logdir = str(tmp_path / name)
        trainer = _trainer(_config(dataset, logdir, batch_size=batch_size))
        TC.reset_round_counts()
        loop(trainer)
        trainer.logger.close()
        runs[name] = (trainer, _records(logdir), dict(TC.round_counts))
    (old, old_rec, _), (new, new_rec, counted) = runs["old"], runs["new"]
    _assert_same_state(old, new)
    assert old_rec == new_rec
    rounds = [r for r in new_rec if "densify/num_fillable" in r]
    assert len(rounds) >= 2 and counted["rounds"] == len(rounds)
    assert any(r["densify/num_fillable"] > 0 for r in rounds)


def test_resumed_iterations_are_the_run_s_second_half(dataset, tmp_path):
    """The benchmark's way: resume from the checkpoint a shorter run wrote
    at its end (12, where a new permutation of the 4 views starts) and
    call `train_iteration` on the device cache's views, as `train()`
    feeds them."""
    whole = _trainer(_config(dataset, str(tmp_path / "whole")))
    whole.train()
    whole.logger.close()
    half = _trainer(_config(dataset, str(tmp_path / "half"),
                            num_iterations=12))
    half.train()
    half.logger.close()
    resumed = _trainer(dataclasses.replace(
        _config(dataset, str(tmp_path / "resumed")),
        resume_from_checkpoint=str(tmp_path / "half" / "train_state.npz")))
    assert resumed.start_iteration == 12
    cache = resumed._device_cache(resumed.train_dataset, 1)
    for iteration in range(12, 21):
        resumed.train_iteration(
            iteration, *resumed._next_views(cache, None, 1, 1))
    resumed.logger.close()
    _assert_same_state(whole, resumed)


def test_load_state_repeats_the_same_iterations(dataset, tmp_path):
    """The state `state_arrays` gives, copied and put back by `load_state`
    (the benchmark's way between segments), runs the same iterations
    bitwise again; an iteration with a round returns its counts."""
    trainer = _trainer(_config(dataset, str(tmp_path)))
    cache = trainer._device_cache(trainer.train_dataset, 1)
    trainer._pos = len(trainer.train_dataset)
    start = {k: v.clone() for k, v in trainer.state_arrays().items()}
    ends = []
    for _ in range(2):
        trainer.load_state(start)
        outs = [trainer.train_iteration(
            it, *trainer._next_views(cache, None, 1, 1))
            for it in range(1, 11)]
        ends.append({k: v.clone() for k, v in trainer.state_arrays().items()})
        assert [o.densify_counts is not None for o in outs] == [
            it in (5, 10) for it in range(1, 11)]
        assert int(outs[4].densify_counts.num_valid_after) > 0
    trainer.logger.close()
    assert ends[0].keys() == ends[1].keys() == start.keys()
    for k in start:
        assert torch.equal(ends[0][k], ends[1][k]), k
