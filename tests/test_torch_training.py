"""Port parity for the training slice: SSIM / PSNR / the loss (values and
gradients), the density controller (update_stats, densify_step's masks,
counts and rank-matched fills, reset_alpha), the sampling helper in
distribution, one trainer step against the JAX trainer's step from one
state carried across (Adam at its first and second update, the position
learning-rate schedule), the port's YAML loading, and a short port-only
`train()` at 32x32 with its checkpoint round trip.

Tolerances are stated at each comparison."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu import config as jconfig
from taichi_3d_gaussian_splatting_tpu.models.scene import (
    GaussianPointCloudScene as JScene)
from taichi_3d_gaussian_splatting_tpu.ops import gaussian as JG
from taichi_3d_gaussian_splatting_tpu.ops.rasterizer import (
    BackwardStats as JStats)
from taichi_3d_gaussian_splatting_tpu.training import controller as JC
from taichi_3d_gaussian_splatting_tpu.training import loss as JL
from taichi_3d_gaussian_splatting_tpu.training import ssim as JS
from taichi_3d_gaussian_splatting_tpu.training import trainer as JT
from taichi_3d_gaussian_splatting_torch import config as tconfig
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene)
from taichi_3d_gaussian_splatting_torch.ops import _build
from taichi_3d_gaussian_splatting_torch.ops import gaussian as TG
from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
    BackwardStats as TStats)
from taichi_3d_gaussian_splatting_torch.training import controller as TC
from taichi_3d_gaussian_splatting_torch.training import loss as TL
from taichi_3d_gaussian_splatting_torch.training import ssim as TS
from taichi_3d_gaussian_splatting_torch.training import trainer as TT
from taichi_3d_gaussian_splatting_torch.training import adam_cuda as TA
from taichi_3d_gaussian_splatting_torch.training import step as TSTEP
from taichi_3d_gaussian_splatting_torch.training.adam import (
    adam_state_from_optax, adam_update)
from taichi_3d_gaussian_splatting_torch.training.adam_cuda import (
    combine_feature_gradients)

from torch_train_fixtures import (OPTIMIZER_CASES, RAW_QUATERNION_CASES,
                                  SH_BAND, accumulate_inputs,
                                  assert_bitwise_equal, batch_step_state,
                                  batch_views, config_dict, optimizer_inputs,
                                  parent_normalize, raw_quaternion_inputs,
                                  write_dataset)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# loss and SSIM
# ---------------------------------------------------------------------------

def _images(seed, shape=(40, 48, 3)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


def test_ssim_psnr_match_jax():
    """Values to 1e-6, the SSIM gradient at rtol 1e-4 / atol 1e-7."""
    a, b = _images(0)
    ta = torch.tensor(a, requires_grad=True)
    t_ssim = TS.ssim(ta, torch.tensor(b))
    t_ssim.backward()
    j_ssim, j_grad = jax.value_and_grad(JS.ssim)(jnp.asarray(a),
                                                 jnp.asarray(b))
    assert abs(t_ssim.item() - float(j_ssim)) < 1e-6
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-4, atol=1e-7)
    assert abs(float(TS.psnr(torch.tensor(a), torch.tensor(b)))
               - float(JS.psnr(jnp.asarray(a), jnp.asarray(b)))) < 1e-4
    same = torch.tensor(a)
    assert float(TS.ssim(same, same)) > 0.9999


def test_ssim_turns_tf32_off_only_inside():
    """The blur forces full f32 convolutions itself and restores the
    caller's cuDNN setting."""
    before = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with TS._ieee_f32_convs():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("regularize", [False, True])
def test_loss_function_matches_jax(regularize):
    """(L, L1, 1 - SSIM) to 1e-6 and the gradients with respect to the
    image and the features at rtol 1e-4 / atol 1e-7."""
    a, b = _images(1, (32, 32, 3))
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(20, 56)).astype(np.float32)
    invalid = (rng.random(20) < 0.3).astype(np.int8)
    invalid_t = torch.tensor(invalid)
    cfg = dict(lambda_value=0.2, enable_regularization=regularize,
               regularization_weight=2.0)
    tfn = TL.LossFunction(TL.LossFunctionConfig(**cfg))
    jfn = JL.LossFunction(JL.LossFunctionConfig(**cfg))
    ta = torch.tensor(a, requires_grad=True)
    tf = torch.tensor(feats, requires_grad=True)
    tout = tfn(ta, torch.tensor(b), invalid_t, tf)
    tout[0].backward()

    def jloss(img, f):
        out = jfn(img, jnp.asarray(b), jnp.asarray(invalid), f)
        return out[0], out
    (_, jout), (jga, jgf) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(a), jnp.asarray(feats))
    for t, j in zip(tout, jout):
        assert abs(t.item() - float(j)) < 1e-6
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jga), rtol=1e-4,
                               atol=1e-7)
    tgf = (tf.grad.numpy() if tf.grad is not None
           else np.zeros_like(feats))
    np.testing.assert_allclose(tgf, np.asarray(jgf), rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

N_CTRL = 32


def _ctrl_inputs(seed):
    """numpy scene + statistics with every kind of candidate: transparent,
    NaN, floaters, over- and under-reconstructed, more candidates than free
    slots."""
    rng = np.random.default_rng(seed)
    n = N_CTRL
    pc = rng.normal(size=(n, 3)).astype(np.float32)
    feats = (rng.normal(size=(n, 56)) * 0.3).astype(np.float32)
    q = rng.normal(size=(n, 4))
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-3, -1, (n, 3))
    feats[:, 7] = rng.uniform(-1, 3, n)
    feats[3, 9] = np.nan
    invalid = (rng.random(n) < 0.25).astype(np.int8)
    obj = rng.integers(0, 3, n).astype(np.int32)
    in_frustum = rng.random(n) < 0.8
    depth = rng.uniform(1, 20, n).astype(np.float32)
    npix = rng.integers(0, 2000, n).astype(np.int32)
    mag = (rng.random(n) * 2e-5).astype(np.float32)
    grad_pc = (rng.normal(size=(n, 3)) * 1e-3).astype(np.float32)
    acc = [rng.integers(0, 3000, n).astype(np.int32),
           rng.integers(0, 5, n).astype(np.int32),
           (rng.random(n) * 1e-4).astype(np.float32),
           (rng.random(n) * 1e-7).astype(np.float32),
           (rng.normal(size=(n, 3)) * 1e-3).astype(np.float32),
           (rng.random(n) * 1e-3).astype(np.float32)]
    return (pc, feats, invalid, obj), in_frustum, depth, npix, mag, grad_pc, acc


def _stats_pair(npix, mag):
    zeros_img = np.zeros((4, 4, 2), np.float32)
    zeros_uv = np.zeros((npix.shape[0], 2), np.float32)
    j = JStats(jnp.asarray(zeros_uv), jnp.asarray(mag), jnp.asarray(npix),
               jnp.asarray(zeros_img))
    t = TStats(torch.tensor(zeros_uv), torch.tensor(mag), torch.tensor(npix),
               torch.tensor(zeros_img))
    return j, t


CTRL_CASES = {
    "split_clone": dict(
        densification_view_space_position_gradients_threshold=3e-6,
        densification_multi_frame_view_space_position_gradients_threshold=4e-5,
        under_reconstructed_num_pixels_threshold=1500,
        floater_near_camrea_num_pixels_threshold=1800,
        floater_depth_threshold=10.0, iteration_start_remove_floater=50,
        transparent_alpha_threshold=-0.5),
    "clone_only_ellipsoid": dict(
        densification_view_space_position_gradients_threshold=5e-6,
        under_reconstructed_num_pixels_threshold=10 ** 6,
        iteration_start_remove_floater=10 ** 6,
        transparent_alpha_threshold=0.0, enable_ellipsoid_offset=True),
    "no_sampling": dict(
        densification_multi_frame_position_gradients_threshold=1e-4,
        under_reconstructed_num_pixels_threshold=100,
        enable_sample_from_point=False, enable_ellipsoid_offset=True),
}


@pytest.mark.parametrize("case", list(CTRL_CASES))
def test_controller_matches_jax(case):
    """update_stats to rtol 1e-6; densify_step's masks, counts, invalid
    mask, object ids and which source fills which slot exactly; features
    to 1e-6; positions to 1e-6 except where the JAX package draws a split
    sample (those are held in distribution, below); reset_alpha exactly."""
    arrays, in_frustum, depth, npix, mag, grad_pc, acc = _ctrl_inputs(7)
    cfg = CTRL_CASES[case]
    jcfg = JC.AdaptiveControllerConfig(**cfg)
    tcfg = TC.AdaptiveControllerConfig(**cfg)
    jscene = JScene(*(jnp.asarray(x) for x in arrays))
    tscene = TScene.from_numpy(*arrays, device="cpu")
    jstats, tstats = _stats_pair(npix, mag)
    jstate = JC.ControllerState(*(jnp.asarray(x) for x in acc))
    tstate = TC.ControllerState.from_numpy(acc, "cpu")

    jstate = JC.update_stats(jstate, jstats, jnp.asarray(grad_pc),
                             jnp.asarray(in_frustum))
    tstate = TC.update_stats(tstate, tstats, torch.tensor(grad_pc),
                             torch.tensor(in_frustum))
    for f in JC.ControllerState._fields:
        np.testing.assert_allclose(getattr(tstate, f).numpy(),
                                   np.asarray(getattr(jstate, f)),
                                   rtol=1e-6, err_msg=f)

    pos_before = arrays[0] + 0.01
    jnew, jzero, jcounts = JC.densify_step(
        jscene, jstate, jstats, jnp.asarray(in_frustum), jnp.asarray(depth),
        jnp.asarray(pos_before), jnp.int32(100), jax.random.PRNGKey(0),
        jcfg)
    tnew, tzero, tcounts = TC.densify_step(
        tscene, tstate, tstats, torch.tensor(in_frustum),
        torch.tensor(depth), torch.tensor(pos_before), 100,
        torch.Generator().manual_seed(0), tcfg)
    for f in JC.DensifyCounts._fields:
        np.testing.assert_array_equal(getattr(tcounts, f).numpy(),
                                      np.asarray(getattr(jcounts, f)),
                                      err_msg=f)
    assert int(tcounts.num_fillable) > 0
    if case == "split_clone":
        assert int(tcounts.num_transparent) > 0
        assert int(tcounts.num_floaters) > 0
        assert int(tcounts.num_candidates) > int(tcounts.num_fillable)
        assert 0 < int(tcounts.num_over_reconstructed) < int(
            tcounts.num_fillable)
    np.testing.assert_array_equal(tnew.point_invalid_mask.numpy(),
                                  np.asarray(jnew.point_invalid_mask))
    np.testing.assert_array_equal(tnew.point_object_id.numpy(),
                                  np.asarray(jnew.point_object_id))
    np.testing.assert_allclose(tnew.point_cloud_features.numpy(),
                               np.asarray(jnew.point_cloud_features),
                               rtol=1e-6, atol=1e-6)
    # split samples are random in both packages; everything else is exact
    sampled = np.zeros(N_CTRL, bool)
    if cfg.get("enable_sample_from_point", True):
        reduced = np.asarray(jnew.point_cloud_features)[:, 4:7] < (
            arrays[1][:, 4:7] - 1e-3)
        sampled = reduced.any(axis=1)
    np.testing.assert_allclose(tnew.point_cloud.numpy()[~sampled],
                               np.asarray(jnew.point_cloud)[~sampled],
                               rtol=1e-6, atol=1e-6)
    assert np.isfinite(tnew.point_cloud.numpy()).all()
    assert not any(x.any() for x in tzero)

    jr = JC.reset_alpha(jnew, jcfg)
    tr = TC.reset_alpha(tnew, tcfg)
    np.testing.assert_array_equal(tr.point_cloud_features.numpy()[:, 7],
                                  np.asarray(jr.point_cloud_features)[:, 7])


def test_sample_from_gaussian_in_distribution():
    """Draws of the port and of the JAX package from one anisotropic
    gaussian agree with its mean and covariance R diag(s^2) R^T to a few
    standard errors (20000 draws each)."""
    m = 20000
    q = np.array([0.2, -0.3, 0.4, 0.8], np.float32)
    q /= np.linalg.norm(q)
    log_s = np.log(np.array([0.5, 1.0, 2.0], np.float32))
    mean = np.array([1.0, -2.0, 3.0], np.float32)
    tq = torch.tensor(np.tile(q, (m, 1)))
    ts = torch.tensor(np.tile(log_s, (m, 1)))
    tx = TG.sample_from_gaussian(torch.tensor(np.tile(mean, (m, 1))), tq, ts,
                                 torch.Generator().manual_seed(1)).numpy()
    jx = np.asarray(JG.sample_from_gaussian(
        jax.random.PRNGKey(1), jnp.tile(jnp.asarray(mean), (m, 1)),
        jnp.asarray(tq.numpy()), jnp.asarray(ts.numpy())))
    R = TG.rotation_matrix_from_quaternion(torch.tensor(q)).numpy()
    cov = R @ np.diag(np.exp(2 * log_s)) @ R.T
    for x in (tx, jx):
        assert np.abs(x.mean(0) - mean).max() < 5 * 2.0 / np.sqrt(m)
        np.testing.assert_allclose(np.cov(x.T), cov, atol=0.1)
    foci_t = TG.ellipsoid_foci_vector(tq[:2], ts[:2]).numpy()
    foci_j = np.asarray(JG.ellipsoid_foci_vector(jnp.asarray(tq[:2].numpy()),
                                                 jnp.asarray(ts[:2].numpy())))
    np.testing.assert_allclose(foci_t, foci_j, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def test_trainer_step_matches_jax(tmp_path):
    """Two steps of the port's trainer against two of the JAX trainer's
    raw step, from the JAX trainer's initial state carried across (with
    anisotropic scales, so that no gradient is pure rounding noise), on a
    scene without depth ties (tied keys may blend in another order). After
    each step: the loss to 1e-5 relative; parameters, Adam moments and the
    controller statistics at rtol 1e-4 and an atol of 1e-5 times the
    field's largest magnitude (the blends and the routing sum in other
    orders); the step counts exactly. The second step runs the position
    update at base * 0.5 (decay 0.5 at count 1)."""
    write_dataset(str(tmp_path))
    d = config_dict(str(tmp_path))
    jt = JT.GaussianPointCloudTrainer(jconfig.from_dict(JT.TrainConfig, d))
    tt = TT.GaussianPointCloudTrainer(tconfig.from_dict(TT.TrainConfig, d),
                                      device="cpu")
    rng = np.random.default_rng(5)
    feats = np.array(jt.scene.point_cloud_features)
    feats[:, 4:7] += rng.uniform(-0.5, 0.5, (feats.shape[0], 3))
    jt.scene = jt.scene._replace(point_cloud_features=jnp.asarray(feats))
    tt.scene = TScene.from_numpy(*(np.asarray(x) for x in jt.scene),
                                 device="cpu")
    tt.opt_features = adam_state_from_optax(jt.opt_state_features, "cpu")
    tt.opt_positions = adam_state_from_optax(jt.opt_state_positions, "cpu")
    tt.ctrl_state = TC.ControllerState.from_numpy(jt.ctrl_state, "cpu")

    jstate = (jt.scene, jt.opt_state_features, jt.opt_state_positions,
              jt.ctrl_state)
    for k in range(2):
        item = jt.train_dataset[k]
        titem = tt.train_dataset[k]
        np.testing.assert_allclose(titem.q_pointcloud_camera,
                                   item.q_pointcloud_camera, atol=1e-7)
        jstep = jt._make_raw_step(item.camera_info)
        jout = jstep(*jstate, jnp.asarray(item.image),
                     jnp.asarray(item.q_pointcloud_camera),
                     jnp.asarray(item.t_pointcloud_camera), jnp.int32(0),
                     jnp.asarray(item.camera_info.camera_intrinsics))
        jstate = jout[:4]
        tout = tt.step(torch.as_tensor(titem.image),
                       torch.as_tensor(titem.q_pointcloud_camera),
                       torch.as_tensor(titem.t_pointcloud_camera), 0,
                       titem.camera_info)
        jloss = float(jout[4]["loss"])
        assert abs(float(tout.metrics["loss"]) - jloss) < 1e-5 * abs(jloss)
        pairs = {
            "positions": (tt.scene.point_cloud,
                          jstate[0].point_cloud),
            "features": (tt.scene.point_cloud_features,
                         jstate[0].point_cloud_features),
            "feature mu": (tt.opt_features.mu, jstate[1][0].mu),
            "feature nu": (tt.opt_features.nu, jstate[1][0].nu),
            "position mu": (tt.opt_positions.mu, jstate[2][0].mu),
            "position nu": (tt.opt_positions.nu, jstate[2][0].nu),
        }
        for f in JC.ControllerState._fields:
            pairs[f] = (getattr(tt.ctrl_state, f), getattr(jstate[3], f))
        for name, (t, j) in pairs.items():
            j = np.asarray(j, np.float64)
            scale = max(np.abs(j).max(), 1e-30)
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-4,
                                       atol=1e-5 * scale,
                                       err_msg=f"step {k} {name}")
        assert int(tt.opt_positions.count) == int(jstate[2][0].count) == k + 1
        assert int(tt.opt_features.count) == int(jstate[1][0].count) == k + 1


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    REPO, "config", "*.yaml"))), ids=os.path.basename)
def test_yaml_configs_load_as_in_jax(path):
    """Every config of the repo loads into the port's TrainConfig with the
    values the JAX package reads from it."""
    t = tconfig.to_dict(TT.TrainConfig.from_yaml_file(path))
    j = jconfig.to_dict(JT.TrainConfig.from_yaml_file(path))

    def same(a, b, where):
        if isinstance(b, dict):
            for k, v in b.items():
                assert k in a, f"{where}.{k}"
                same(a[k], v, f"{where}.{k}")
        else:
            assert a == b or (isinstance(b, (list, tuple))
                              and list(a) == list(b)), (where, a, b)
    same(t, j, os.path.basename(path))


def test_train_end_to_end_and_resume(tmp_path):
    """A 21-iteration port-only run at 32x32 with densify and two
    validations: the loss falls, the parquets load back, and the checkpoint
    restores the whole state exactly."""
    write_dataset(str(tmp_path))
    d = config_dict(str(tmp_path))
    cfg = tconfig.from_dict(TT.TrainConfig, d)
    trainer = TT.GaussianPointCloudTrainer(cfg, device="cpu")
    trainer.train()
    logdir = tmp_path / "logs"
    records = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 21 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert any("densify/num_fillable" in r for r in records)
    for name in ("scene_10.parquet", "scene_20.parquet", "best_scene.parquet"):
        scene = TScene.from_parquet(str(logdir / name), device="cpu")
        assert scene.num_valid_points() > 0
        assert np.isfinite(scene.point_cloud_features.numpy()).all()

    saved = trainer.state_arrays()
    resumed = TT.GaussianPointCloudTrainer(dataclasses.replace(
        tconfig.from_dict(TT.TrainConfig, d),
        resume_from_checkpoint=str(logdir / "train_state.npz")),
        device="cpu")
    assert resumed.start_iteration == 21
    assert resumed.best_psnr_score == trainer.best_psnr_score
    got = resumed.state_arrays()
    assert got.keys() == saved.keys()
    for k in saved:
        assert got[k].dtype == saved[k].dtype, k
        assert torch.equal(got[k], saved[k]), k


def test_train_streams_without_device_cache(tmp_path):
    """With the device cache off the views come from the prefetching
    loader, downsampled by the coarse-to-fine schedule (64x64 images at
    factor 2, then 1)."""
    write_dataset(str(tmp_path), size=64)
    d = config_dict(str(tmp_path), num_iterations=4, val_interval=10 ** 6,
                    cache_dataset_on_device=False,
                    initial_downsample_factor=2,
                    half_downsample_factor_interval=2)
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, d), device="cpu")
    trainer.train()
    records = [json.loads(line)
               for line in open(tmp_path / "logs" / "metrics.jsonl")]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert os.path.isfile(tmp_path / "logs" / "scene_4.parquet")


# ---------------------------------------------------------------------------
# the optimizer step (training/adam_cuda.py)
# ---------------------------------------------------------------------------

def _parent_chain(feats, grad_feats, pc, grad_pc, opt_f, opt_p, features,
                  positions, loss_ok, grad_scale=None, band_mask=None,
                  grad_feats_direct=None):
    """The optimizer step as the single-view and batch steps ran it before
    one call held it (copied): the features' combination line,
    contain_gradients, adam_update for both groups, keep_if_ok and the
    torch.where over both parameters."""
    if grad_scale is not None:
        if grad_feats_direct is None:
            grad_feats_direct = torch.zeros_like(feats)
        grad_feats = grad_feats * grad_scale * band_mask + grad_feats_direct
    feat_row_ok = torch.isfinite(grad_feats).all(dim=1, keepdim=True)
    pc_row_ok = torch.isfinite(grad_pc).all(dim=1, keepdim=True)
    nonfinite_grad_rows = (~feat_row_ok[:, 0] | ~pc_row_ok[:, 0]).sum(
        dtype=torch.int32)
    grad_pc = torch.where(pc_row_ok, grad_pc, torch.zeros_like(grad_pc))
    grad_feats = torch.where(feat_row_ok, grad_feats,
                             torch.zeros_like(grad_feats))
    new_feats, new_f = adam_update(feats, grad_feats, opt_f, features.lr,
                                   features.b1, features.b2)
    new_pc, new_p = adam_update(pc, grad_pc, opt_p, positions.lr(opt_p.count),
                                positions.b1, positions.b2)

    def keep(new, old):
        return type(old)(*(torch.where(loss_ok, a, b)
                           for a, b in zip(new, old)))

    return TA.OptimizerUpdate(
        torch.where(loss_ok, new_feats, feats),
        torch.where(loss_ok, new_pc, pc), keep(new_f, opt_f),
        keep(new_p, opt_p), grad_pc, nonfinite_grad_rows)


def _normalizing_chain(feats, grad_feats, *args, grad_scale=None,
                       band_mask=None, grad_feats_direct=None):
    """_parent_chain on the stored features, as the steps hand them now:
    the features' combination line, then each quaternion divided by its
    norm and its gradient columns multiplied by it (the squares summed q0
    to q3, the root correctly rounded, the norm floored at 1e-12), then the
    chain in its batch form."""
    if grad_scale is not None:
        grad_feats = combine_feature_gradients(grad_feats, grad_scale,
                                               band_mask, grad_feats_direct)
    q = feats[:, 0:4]
    norm = torch.clamp(torch.sqrt((
        q[:, 0:1] * q[:, 0:1] + q[:, 1:2] * q[:, 1:2]
        + q[:, 2:3] * q[:, 2:3] + q[:, 3:4] * q[:, 3:4]).double()).float(),
        min=1e-12)
    return _parent_chain(
        torch.cat([q / norm, feats[:, 4:]], dim=1),
        torch.cat([grad_feats[:, 0:4] * norm, grad_feats[:, 4:]], dim=1),
        *args)


@pytest.mark.parametrize("case", list(OPTIMIZER_CASES))
def test_optimizer_update_matches_the_parent_chain(case):
    """optimizer_update on the CPU (its plain version) bit for bit equal to
    the chain it replaced with the quaternions' normalization moved in
    (_normalizing_chain), case by case: non-finite feature and position
    rows, a non-finite loss, the learning-rate decay past its interval, the
    batch-scaled betas, SH bands 0 and 3, a direct gradient, the batch form
    without scale or mask. The CPU launches no kernel."""
    args, kwargs = optimizer_inputs(case, 257, "cpu", seed=3)
    want = _normalizing_chain(*args, **kwargs)
    before = dict(_build.launch_counts)
    for fn in (TA.optimizer_update, TA.optimizer_update_torch):
        assert_bitwise_equal(tuple(fn(*args, **kwargs)), tuple(want), case)
    assert _build.launch_counts == before
    c = OPTIMIZER_CASES[case]
    zeroed = int(want[5])
    assert (zeroed > 0) == bool(c.get("bad_feats") or c.get("bad_pc"))
    counts = int(want[2].count), int(want[3].count)
    start = c.get("count", 0)
    assert counts == ((start, start) if c.get("loss_ok") is False
                      else (start + 1, start + 1))


@pytest.mark.parametrize("case", list(RAW_QUATERNION_CASES))
def test_optimizer_update_on_stored_quaternions_matches_the_parent(case):
    """optimizer_update_torch on the stored features, quaternions at norms
    from 1e-3 to 1e3 and their gradients divided by the norm as the
    projection's backward now gives them, against the parent's chain on the
    normalized copy (parent_normalize) with the gradients with respect to
    it: the features and their moments within a few float32 spacings, at
    rtol 1e-6 and an atol of 1e-6 times the field's largest magnitude (a
    moment's sum that cancels keeps its terms' absolute error); all-zero
    pool rows stay 0; a non-finite loss leaves the normalized quaternion in
    the stored row; the positions, the zeroed rows and the counts equal."""
    (args, kwargs), (p_args, p_kwargs) = raw_quaternion_inputs(
        case, 257, "cpu", seed=11)
    got = TA.optimizer_update_torch(*args, **kwargs)
    want = _parent_chain(*p_args, **p_kwargs)
    for name, g, w in (("features", got.feats, want.feats),
                       ("feature mu", got.opt_features.mu,
                        want.opt_features.mu),
                       ("feature nu", got.opt_features.nu,
                        want.opt_features.nu)):
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=1e-6,
            atol=1e-6 * float(w.abs().max()), err_msg=f"{case} {name}")
    assert_bitwise_equal((got.pc, got.opt_positions, got.grad_pc,
                          got.nonfinite_grad_rows, got.opt_features.count),
                         (want.pc, want.opt_positions, want.grad_pc,
                          want.nonfinite_grad_rows, want.opt_features.count),
                         case)
    c = RAW_QUATERNION_CASES[case]
    stored_q, new_q = args[0][:, 0:4], got.feats[:, 0:4]
    if c.get("empty"):
        half = args[0].shape[0] // 2
        assert not bool(stored_q[half:].any())
        for t in (got.feats, *got.opt_features[:2]):
            assert not bool(t[half:].any()), case
    if c.get("loss_ok") is False:
        assert_bitwise_equal(got.opt_features, tuple(args[4]), case)
        np.testing.assert_allclose(new_q.numpy(), p_args[0][:, 0:4].numpy(),
                                   rtol=1e-6, atol=0)
        assert not torch.allclose(new_q, stored_q)
        assert_bitwise_equal(got.feats[:, 4:], args[0][:, 4:], case)


def _single_steps(root, steps=2):
    """The training state after `steps` single-view steps of the port's
    trainer on the CPU (anisotropic scales, as one_step_state)."""
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, config_dict(root)), device="cpu")
    feats = trainer.scene.point_cloud_features.numpy().copy()
    rng = np.random.default_rng(5)
    feats[:, 4:7] += rng.uniform(-0.5, 0.5, (feats.shape[0], 3))
    trainer.scene = trainer.scene._replace(
        point_cloud_features=torch.as_tensor(feats))
    for k in range(steps):
        item = trainer.train_dataset[k]
        trainer.step(torch.as_tensor(item.image),
                     torch.as_tensor(item.q_pointcloud_camera),
                     torch.as_tensor(item.t_pointcloud_camera), 1,
                     item.camera_info)
    trainer.logger.close()
    return {k: v for k, v in trainer.state_arrays().items()
            if not k.endswith("generator")}


def test_steps_match_the_parent_chain(tmp_path, monkeypatch):
    """Two trainer steps and two batch steps on the CPU leave the same
    state, bit for bit, as with the chain optimizer_update replaced
    (_normalizing_chain), patched in once, where both steps take it: once a
    step in each."""
    write_dataset(str(tmp_path))
    root = str(tmp_path)
    single = _single_steps(root)
    batch = batch_step_state(torch.device("cpu"), root)
    calls = []

    def chain(*args, **kwargs):
        calls.append(len(calls))
        return _normalizing_chain(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(TSTEP, "optimizer_update", chain)
        parent_single = _single_steps(root)
        assert len(calls) == 2
        parent_batch = batch_step_state(torch.device("cpu"), root)
        assert len(calls) == 2 + 2
    assert batch["losses"] == parent_batch["losses"]
    for got, want in ((single, parent_single),
                      (batch["state"], parent_batch["state"])):
        assert got.keys() == want.keys()
        for k in want:
            assert_bitwise_equal(torch.as_tensor(got[k]),
                                 torch.as_tensor(want[k]), k)


def _parent_sums(views, grad_scale, band_mask):
    """The batch step's running sums as it took them before one call held
    a view's part (copied): zeros_like, then for each view the combination
    line and the two sums."""
    grad_pc = torch.zeros_like(views[0][1])
    grad_feats = torch.zeros_like(views[0][0])
    out = []
    for raster, g_pc, direct in views:
        combined = raster * grad_scale * band_mask + (
            0.0 if direct is None else direct)
        grad_pc = grad_pc + g_pc
        grad_feats = grad_feats + combined
        out.append((grad_feats, grad_pc))
    return out


@pytest.mark.parametrize("band", [0, 3])
@pytest.mark.parametrize("direct", [False, True],
                         ids=["no_direct", "direct"])
def test_accumulate_view_gradients_matches_the_parent_chain(direct, band):
    """accumulate_view_gradients on the CPU (its plain version) over 1 to 4
    views leaves the sums of the parent's chain (_parent_sums) bit for bit
    after each view, from sums that start as NaN (the first view does not
    read them): negative zeros, NaN and infinite rows, with and without a
    direct gradient, SH bands 0 and 3. The sums are updated in place and
    the CPU launches no kernel."""
    views, scale, mask = accumulate_inputs(4097, "cpu", seed=band + 2,
                                           band=band, direct=direct)
    want = _parent_sums(views, scale, mask)
    before = dict(_build.launch_counts)
    for fn in (TA.accumulate_view_gradients,
               TA.accumulate_view_gradients_torch):
        sums = (torch.full((4097, 56), float("nan")),
                torch.full((4097, 3), float("nan")))
        for k, (raster, g_pc, d) in enumerate(views):
            got = fn(*sums, raster, g_pc, scale, mask, d, first=k == 0)
            assert got[0] is sums[0] and got[1] is sums[1]
            assert_bitwise_equal(got, want[k], f"{fn.__name__}, view {k}")
    assert _build.launch_counts == before
    feats, pc = want[-1]
    assert not bool(torch.isfinite(feats).all())
    assert not bool(torch.isfinite(pc).all())
    zeros = want[0][0][1::7]    # the -0.0 rows, where no value is bad
    zeros = zeros[torch.isfinite(zeros)]
    assert zeros.numel() > 0 and bool((zeros == 0).all())
    assert not bool(torch.signbit(zeros).any())


def _trainer(root, form, scale_quaternions=False):
    """The port's trainer on the CPU for a single-view or a batch step,
    anisotropic scales as in one_step_state; with `scale_quaternions`,
    each stored quaternion multiplied by a norm drawn log-uniform from 1e-3
    to 1e3."""
    over = {"batch_size": 2} if form == "batch" else {}
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, config_dict(root, **over)),
        device="cpu")
    feats = trainer.scene.point_cloud_features.numpy().copy()
    rng = np.random.default_rng(5)
    feats[:, 4:7] += rng.uniform(-0.5, 0.5, (feats.shape[0], 3))
    if scale_quaternions:
        feats[:, 0:4] *= 10.0 ** rng.uniform(-3, 3, (feats.shape[0], 1))
    trainer.scene = trainer.scene._replace(
        point_cloud_features=torch.as_tensor(feats.astype(np.float32)))
    return trainer


def _take_step(trainer, form, k=0):
    """One single-view step on view k, or one batch step on views k and
    k + 1."""
    if form == "batch":
        images, qs, ts, intrs, cam = batch_views(trainer, [k, (k + 1) % 3])
        return trainer.batch_step(images, qs, ts, intrs, SH_BAND, cam)
    item = trainer.train_dataset[k]
    return trainer.step(torch.as_tensor(item.image),
                        torch.as_tensor(item.q_pointcloud_camera),
                        torch.as_tensor(item.t_pointcloud_camera), SH_BAND,
                        item.camera_info)


@pytest.mark.parametrize("form", ["single", "batch"])
def test_steps_read_the_stored_features(tmp_path, monkeypatch, form):
    """Neither the single-view step nor the batch step copies the features:
    the tensor that reaches rasterize_with_vjp (once a view) and
    optimizer_update (once a step) is the scene's stored
    point_cloud_features itself, step after step."""
    write_dataset(str(tmp_path))
    trainer = _trainer(str(tmp_path), form)
    seen = []
    raster, update = TSTEP.rasterize_with_vjp, TSTEP.optimizer_update

    def seen_raster(pc, feats, *args, **kwargs):
        seen.append(("raster", feats.data_ptr()))
        return raster(pc, feats, *args, **kwargs)

    def seen_update(feats, *args, **kwargs):
        seen.append(("update", feats.data_ptr()))
        return update(feats, *args, **kwargs)

    monkeypatch.setattr(TSTEP, "rasterize_with_vjp", seen_raster)
    monkeypatch.setattr(TSTEP, "optimizer_update", seen_update)
    views = 2 if form == "batch" else 1
    for k in range(2):
        stored = trainer.scene.point_cloud_features.data_ptr()
        seen.clear()
        _take_step(trainer, form, k)
        assert seen == [("raster", stored)] * views + [("update", stored)]
        assert trainer.scene.point_cloud_features.data_ptr() != stored
    trainer.logger.close()


@pytest.mark.parametrize("form", ["single", "batch"])
def test_steps_on_unnormalized_quaternions(tmp_path, form):
    """Two steps from a scene whose stored quaternions have norms from 1e-3
    to 1e3 leave the state of two steps from the same scene with its
    quaternions normalized: the projection normalizes where it reads, the
    update where it writes. The losses to 1e-5 relative; every state array
    at rtol 1e-4 and an atol of 1e-5 times its largest magnitude, as
    test_trainer_step_matches_jax holds the port to JAX."""
    write_dataset(str(tmp_path))
    raw = _trainer(str(tmp_path), form, scale_quaternions=True)
    unit = _trainer(str(tmp_path), form, scale_quaternions=True)
    unit.scene = unit.scene._replace(point_cloud_features=parent_normalize(
        unit.scene.point_cloud_features))
    q = raw.scene.point_cloud_features[:, 0:4].norm(dim=1)
    assert float(q.min()) < 1e-2 and float(q.max()) > 1e2
    for k in range(2):
        losses = [float(_take_step(t, form, k).metrics["loss"])
                  for t in (raw, unit)]
        assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    got, want = (dict(t.state_arrays()) for t in (raw, unit))
    for t in (raw, unit):
        t.logger.close()
    for k, w in want.items():
        if k.endswith("generator"):
            continue
        w = np.asarray(w, np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(np.asarray(got[k], np.float64), w,
                                   rtol=1e-4, atol=1e-5 * scale, err_msg=k)
