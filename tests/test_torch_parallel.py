"""Port parity for multi-view data parallelism (parallel/sharding.py and
the trainer's batch_size > 1):

(a) the port's batch step (one process, B = 2, 32x32, CPU) against the JAX
    package's `make_data_parallel_train_step` on a 2-device CPU mesh, from
    the JAX trainer's state carried across, for two steps;
(b) two gloo ranks against one process: the ranks' states are bitwise
    equal and within rtol 1e-5 of the one-process state;
(c) the batch scaling of schedules, learning rates and Adam betas against
    the JAX trainer;
(d) batch_size 2 end to end (densify, validation, resume) and on the
    streaming path;
(e) `dryrun_multichip(2, "cpu")`;
(f) a batch that does not split over the ranks, and a mesh size that is
    not the group's, raise.

Tolerances are stated at each comparison."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import optax

from taichi_3d_gaussian_splatting_tpu import config as jconfig
from taichi_3d_gaussian_splatting_tpu.parallel import sharding as JP
from taichi_3d_gaussian_splatting_tpu.training import controller as JC
from taichi_3d_gaussian_splatting_tpu.training import trainer as JT
from taichi_3d_gaussian_splatting_torch import config as tconfig
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene)
from taichi_3d_gaussian_splatting_torch.parallel import sharding as TP
from taichi_3d_gaussian_splatting_torch.parallel.dryrun import (
    dryrun_multichip, spawn_ranks)
from taichi_3d_gaussian_splatting_torch.training import controller as TC
from taichi_3d_gaussian_splatting_torch.training import trainer as TT
from taichi_3d_gaussian_splatting_torch.training.adam import (
    adam_init, adam_state_from_optax)

import torch_train_fixtures as F

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# (a) the batch step against the JAX data-parallel step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parity_run(tmp_path_factory):
    """Two batch steps of both packages from one carried state (anisotropic
    scales, init depths on a bucket ladder), SH band 1 with the group
    scaling on; the JAX step is built once."""
    root = str(tmp_path_factory.mktemp("parity"))
    F.write_dataset(root)
    d = F.config_dict(root, batch_size=2)
    jt = JT.GaussianPointCloudTrainer(jconfig.from_dict(JT.TrainConfig, d))
    tt = TT.GaussianPointCloudTrainer(tconfig.from_dict(TT.TrainConfig, d),
                                      device="cpu")
    feats = np.array(jt.scene.point_cloud_features)
    rng = np.random.default_rng(5)
    feats[:, 4:7] += rng.uniform(-0.5, 0.5, (feats.shape[0], 3))
    jt.scene = jt.scene._replace(point_cloud_features=jnp.asarray(feats))
    tt.scene = TScene.from_numpy(*(np.asarray(x) for x in jt.scene),
                                 device="cpu")
    tt.opt_features = adam_state_from_optax(jt.opt_state_features, "cpu")
    tt.opt_positions = adam_state_from_optax(jt.opt_state_positions, "cpu")
    tt.ctrl_state = TC.ControllerState.from_numpy(jt.ctrl_state, "cpu")

    cam = jt.train_dataset[0].camera_info
    jstep = JP.make_data_parallel_train_step(
        JP.make_mesh(2), cam, jt.config.rasterisation_config, jt.loss_fn,
        jt.feature_optimizer, jt.position_optimizer)
    jstate = (jt.scene, jt.opt_state_features, jt.opt_state_positions,
              jt.ctrl_state)
    steps = []
    for idxs in F.BATCHES:
        images, qs, ts, intrs, tcam = F.batch_views(tt, idxs)
        jout = jstep(*jstate, *(jnp.asarray(x.numpy()) for x in
                                (images, qs, ts)),
                     jnp.asarray(intrs), jnp.int32(F.SH_BAND))
        jstate = jout[:4]
        tout = tt.batch_step(images, qs, ts, intrs, F.SH_BAND, tcam)
        steps.append((jout, tout, (tt.scene, tt.opt_features,
                                   tt.opt_positions, tt.ctrl_state)))
    return steps


def _assert_field(t, j, name):
    """rtol 1e-4 and an atol of 1e-5 times the field's largest magnitude
    (the blends and the routing sum in other orders)."""
    j = np.asarray(j, np.float64)
    scale = max(np.abs(j).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(t, np.float64), j, rtol=1e-4,
                               atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("k", range(len(F.BATCHES)))
def test_batch_step_state_matches_jax(parity_run, k):
    """Parameters, Adam moments and every controller field after step k;
    the Adam step counts exactly."""
    jout, _, (scene, opt_f, opt_p, ctrl) = parity_run[k]
    jscene, jopt_f, jopt_p, jctrl = jout[:4]
    pairs = {"positions": (scene.point_cloud, jscene.point_cloud),
             "features": (scene.point_cloud_features,
                          jscene.point_cloud_features),
             "feature mu": (opt_f.mu, jopt_f[0].mu),
             "feature nu": (opt_f.nu, jopt_f[0].nu),
             "position mu": (opt_p.mu, jopt_p[0].mu),
             "position nu": (opt_p.nu, jopt_p[0].nu)}
    for f in JC.ControllerState._fields:
        pairs[f] = (getattr(ctrl, f), getattr(jctrl, f))
    for name, (t, j) in pairs.items():
        _assert_field(t.numpy(), j, f"step {k} {name}")
    assert int(opt_p.count) == int(jopt_p[0].count) == k + 1
    assert int(opt_f.count) == int(jopt_f[0].count) == k + 1


@pytest.mark.parametrize("k", range(len(F.BATCHES)))
def test_batch_step_outputs_match_jax(parity_run, k):
    """The mean loss to 1e-5 relative, the other means at rtol 1e-4, the
    key count exactly; the last view's densify inputs and image maps."""
    jout, tout, _ = parity_run[k]
    jmetrics, (jstats, jfr, jdepth, juv), jmaps = jout[4:7]
    jloss = float(jmetrics["loss"])
    assert abs(float(tout.metrics["loss"]) - jloss) < 1e-5 * abs(jloss)
    for key in ("l1", "ssim_loss", "psnr", "ssim"):
        np.testing.assert_allclose(float(tout.metrics[key]),
                                   float(jmetrics[key]), rtol=1e-4,
                                   err_msg=key)
    for key in ("total_keys", "nonfinite_points", "nonfinite_grad_rows",
                "skipped_nonfinite_step", "key_overflow"):
        assert int(tout.metrics[key]) == int(jmetrics[key]), key
    assert int(tout.metrics["total_keys"]) > 0
    stats, fr, depth, uv = tout.densify_inputs
    np.testing.assert_array_equal(fr.numpy(), np.asarray(jfr))
    np.testing.assert_array_equal(stats.num_affected_pixels.numpy(),
                                  np.asarray(jstats.num_affected_pixels))
    for name, t, j in (("grad_viewspace", stats.grad_viewspace,
                        jstats.grad_viewspace),
                       ("magnitude", stats.magnitude_grad_viewspace,
                        jstats.magnitude_grad_viewspace),
                       ("depth", depth, jdepth), ("uv", uv, juv)):
        _assert_field(t.numpy(), j, f"step {k} {name}")
    for name, t, j in zip(("pred", "depth map", "count map"), tout.maps,
                          jmaps):
        _assert_field(t.numpy(), j, f"step {k} {name}")


# ---------------------------------------------------------------------------
# (b) two gloo ranks against one process
# ---------------------------------------------------------------------------

def test_two_ranks_match_one_process(tmp_path):
    """Each rank renders one view of each batch: both ranks end bitwise
    equal, and within rtol 1e-5 (atol 1e-7 times the field's largest
    magnitude: the controller's sums are taken in another order) of one
    process rendering both views."""
    F.write_dataset(str(tmp_path))
    ranks = spawn_ranks(F.batch_step_state, 2, "cpu", (str(tmp_path),))
    single = F.batch_step_state(torch.device("cpu"), str(tmp_path))
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], single["losses"],
                               rtol=1e-5)
    for k, v in single["state"].items():
        np.testing.assert_array_equal(ranks[0]["state"][k],
                                      ranks[1]["state"][k], err_msg=k)
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(ranks[0]["state"][k], v, rtol=1e-5,
                                   atol=1e-7 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# (c) schedules, learning rates and betas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    REPO, "config", "*.yaml"))), ids=os.path.basename)
@pytest.mark.parametrize("batch_size", [2, 4])
@pytest.mark.parametrize("lr_mode", ["none", "sqrt", "linear"])
def test_scale_schedules_for_batch_matches_jax(path, batch_size, lr_mode):
    """Every field after the batch scaling, with the schedule scaling on
    and off, as the JAX package computes it; the caller's config is not
    modified."""
    for schedules in (True, False):
        over = dict(batch_size=batch_size, scale_lr_with_batch=lr_mode,
                    scale_schedules_with_batch=schedules)
        t_in = dataclasses.replace(TT.TrainConfig.from_yaml_file(path),
                                   **over)
        j_in = dataclasses.replace(JT.TrainConfig.from_yaml_file(path),
                                   **over)
        before = tconfig.to_dict(t_in)
        t = tconfig.to_dict(TT._scale_schedules_for_batch(t_in))
        j = jconfig.to_dict(JT._scale_schedules_for_batch(j_in))
        assert tconfig.to_dict(t_in) == before
        for key, value in j.items():
            if isinstance(value, dict):
                for sub, v in value.items():
                    assert t[key][sub] == v or list(t[key][sub]) == list(v), (
                        key, sub)
            else:
                assert t[key] == value, key


@pytest.mark.parametrize("batch_size", [1, 2, 4])
@pytest.mark.parametrize("scale_betas", [False, True])
def test_adam_betas_match_jax(tmp_path, batch_size, scale_betas):
    """Two updates of the port's Adam with the trainer's betas against the
    JAX trainer's feature optimizer (rtol 1e-6)."""
    F.write_dataset(str(tmp_path))
    d = F.config_dict(str(tmp_path), batch_size=batch_size,
                      scale_betas_with_batch=scale_betas)
    jt = JT.GaussianPointCloudTrainer(jconfig.from_dict(JT.TrainConfig, d))
    tt = TT.GaussianPointCloudTrainer(tconfig.from_dict(TT.TrainConfig, d),
                                      device="cpu")
    expected = (0.9 ** batch_size, 0.999 ** batch_size) if scale_betas \
        else (0.9, 0.999)
    assert tt.betas == pytest.approx(expected)
    rng = np.random.default_rng(0)
    p = rng.normal(size=(16, 56)).astype(np.float32)
    jp, tp = jnp.asarray(p), torch.as_tensor(p)
    jstate = jt.feature_optimizer.init(jp)
    tstate = adam_init(tp)
    for _ in range(2):
        g = rng.normal(size=p.shape).astype(np.float32)
        updates, jstate = jt.feature_optimizer.update(jnp.asarray(g), jstate,
                                                      jp)
        jp = optax.apply_updates(jp, updates)
        tp, tstate = tt.train_step.features(tp, torch.as_tensor(g),
                                             tstate)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tstate.nu.numpy(), np.asarray(jstate[0].nu),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# (d) batch_size 2 end to end
# ---------------------------------------------------------------------------

def test_batch_train_end_to_end_and_resume(tmp_path):
    """An 11-iteration run with batch_size 2 at 32x32 (densify every 2
    after the schedules are halved, validations at 5 and 10): the loss
    falls, densify ran, the parquets load back, and the checkpoint restores
    the whole state exactly."""
    F.write_dataset(str(tmp_path))
    d = F.config_dict(str(tmp_path), batch_size=2, num_iterations=11,
                      val_interval=5)
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, d), device="cpu")
    assert trainer.config.adaptive_controller_config.num_iterations_densify \
        == 2
    trainer.train()
    logdir = tmp_path / "logs"
    records = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 11 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert sum("densify/num_fillable" in r for r in records) == 5
    for name in ("scene_5.parquet", "scene_10.parquet", "best_scene.parquet"):
        scene = TScene.from_parquet(str(logdir / name), device="cpu")
        assert scene.num_valid_points() > 0
        assert np.isfinite(scene.point_cloud_features.numpy()).all()
    saved = trainer.state_arrays()
    resumed = TT.GaussianPointCloudTrainer(dataclasses.replace(
        tconfig.from_dict(TT.TrainConfig, d),
        resume_from_checkpoint=str(logdir / "train_state.npz")),
        device="cpu")
    assert resumed.start_iteration == 11
    got = resumed.state_arrays()
    assert got.keys() == saved.keys()
    for k in saved:
        assert torch.equal(got[k], saved[k]), k


def test_batch_views_wrap_within_the_epoch(tmp_path):
    """On the device cache a batch of 4 from 3 views takes the epoch's
    permutation and wraps within it; the next batch draws a new one."""
    F.write_dataset(str(tmp_path))
    trainer = TT.GaussianPointCloudTrainer(tconfig.from_dict(
        TT.TrainConfig, F.config_dict(str(tmp_path), batch_size=4)),
        device="cpu")
    cache = trainer._device_cache(trainer.train_dataset, 1)
    trainer._pos = 3
    images, _, ts, intrs, _ = trainer._next_views(cache, None, 1, 4)
    perm = trainer._perm.tolist()
    assert sorted(perm) == [0, 1, 2] and trainer._pos == 4
    np.testing.assert_array_equal(ts.numpy(),
                                  cache[3].numpy()[perm + perm[:1]])
    assert images.shape == (4, 32, 32, 3) and intrs.shape == (4, 3, 3)
    trainer._next_views(cache, None, 1, 4)
    assert trainer._pos == 4
    trainer.logger.close()


def test_batch_streaming_and_mixed_shapes(tmp_path):
    """Without the device cache a batch of 2 comes from the loader; images
    of two shapes in one batch raise ValueError."""
    F.write_dataset(str(tmp_path))
    d = F.config_dict(str(tmp_path), batch_size=2, num_iterations=3,
                      val_interval=10 ** 6, cache_dataset_on_device=False)
    TT.GaussianPointCloudTrainer(tconfig.from_dict(TT.TrainConfig, d),
                                 device="cpu").train()
    records = [json.loads(line)
               for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert len([r for r in records if "train/loss" in r]) == 3

    big = tmp_path / "big"
    F.write_dataset(str(big), size=64)
    with open(tmp_path / "train.json") as f:
        small_rec = json.load(f)[:1]
    with open(big / "train.json") as f:
        big_rec = json.load(f)[:1]
    mixed = tmp_path / "mixed.json"
    mixed.write_text(json.dumps(small_rec + big_rec))
    d = F.config_dict(str(tmp_path), batch_size=2, num_iterations=2,
                      train_dataset_json_path=str(mixed),
                      summary_writer_log_dir=str(tmp_path / "logs2"))
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, d), device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        trainer.train()


# ---------------------------------------------------------------------------
# (e) the dry run, (f) what raises
# ---------------------------------------------------------------------------

def test_dryrun_multichip_two_ranks():
    out = dryrun_multichip(2, "cpu")
    assert np.isfinite(out["loss"]) and out["max_param_delta"] > 0


def test_batch_not_a_multiple_of_ranks_raises(tmp_path):
    F.write_dataset(str(tmp_path))
    trainer = TT.GaussianPointCloudTrainer(tconfig.from_dict(
        TT.TrainConfig, F.config_dict(str(tmp_path), batch_size=2)),
        device="cpu")
    assert trainer.mesh == TP.Mesh(0, 1, False)
    step = TP.make_data_parallel_train_step(
        TP.Mesh(0, 2, False), trainer.train_dataset[0].camera_info,
        trainer.train_step)
    images, qs, ts, intrs, _ = F.batch_views(trainer, [0, 1, 2])
    with pytest.raises(ValueError, match="does not split"):
        step(trainer.scene, trainer.opt_features, trainer.opt_positions,
             trainer.ctrl_state, images, qs, ts, intrs, 0)
    with pytest.raises(ValueError, match="mesh_devices=2"):
        TP.make_mesh(2)
    with pytest.raises(ValueError, match="mesh_devices=4"):
        TT.GaussianPointCloudTrainer(tconfig.from_dict(
            TT.TrainConfig, F.config_dict(str(tmp_path), batch_size=4,
                                          mesh_devices=4)), device="cpu")
    trainer.logger.close()
