"""The port's batch step against the benchmark's plain batch reference
(`portbench/reference/batch.py`) on the CPU: `trainer.batch_step` with
B = 4 views on one process and the three batch rules on (learning rates
times sqrt(4), the decay interval divided by 4, Adam's betas to the 4th),
on the tiny seeded scene of tests/test_torch_parallel.py
(`torch_train_fixtures`, 32x32, the regularizer on, SH band 1), over two
steps: each step's loss, the first step's summed gradients (from Adam's
first moments), and after each step the positions, the features, both
Adam moments and the controller's six accumulators.

Cases: a finite scene; the same with one point's position NaN, whose
gradient row is non-finite in every view, so that the accumulators take
it raw (NaN) and the sums are zeroed there before the update. Also the
batch reference at B = 1 against `portbench/reference/train.py::step`
(bit for bit), and the reference's batch rules against the trainer's.

Tolerances are stated at each comparison."""

import numpy as np
import pytest
import torch

from portbench.reference import batch as RB
from portbench.reference import projection as RP
from portbench.reference import train as RT
from taichi_3d_gaussian_splatting_torch import config as tconfig
from taichi_3d_gaussian_splatting_torch.training import trainer as TT

import torch_train_fixtures as F

B = 4
BATCHES = ([0, 1, 2, 3], [2, 3, 0, 1])
NAN_ROW = 3
RULES = dict(batch_size=B, scale_lr_with_batch="sqrt",
             scale_schedules_with_batch=True, scale_betas_with_batch=True)


def _hyper(config):
    rc, lc = config.rasterisation_config, config.loss_function_config
    # the trainer's config before the batch rules: the reference scales it
    return RT.Hyper(
        near=rc.near_plane, far=rc.far_plane,
        depth_scale=rc.depth_to_sort_key_scale,
        feature_lr=config.feature_learning_rate,
        position_lr=config.position_learning_rate,
        position_lr_decay=config.position_learning_rate_decay_rate,
        position_lr_interval=config.position_learning_rate_decay_interval,
        lambda_value=lc.lambda_value, regularization=lc.enable_regularization,
        regularization_weight=lc.regularization_weight,
        grad_scale=(rc.grad_q_factor, rc.grad_s_factor, rc.grad_alpha_factor,
                    rc.grad_color_factor, rc.grad_high_order_color_factor),
        sh_band=F.SH_BAND)


def _camera(cam):
    k = np.asarray(cam.camera_intrinsics, np.float32)
    return RP.Camera(float(k[0, 0]), float(k[1, 1]), float(k[0, 2]),
                     float(k[1, 2]), cam.camera_width, cam.camera_height)


def _state_of(trainer):
    s = trainer.scene
    return tuple(x.clone() for x in (
        s.point_cloud, s.point_cloud_features, *trainer.opt_positions[:2],
        *trainer.opt_features[:2], *trainer.ctrl_state))


def _ref_state_of(st: RT.State):
    return (st.pc, st.feats, st.adam_pc.mu, st.adam_pc.nu, st.adam_feats.mu,
            st.adam_feats.nu, *st.stats)


FIELDS = ("positions", "features", "position mu", "position nu",
          "feature mu", "feature nu", "num_pixels", "num_in_camera",
          "view_space_grad", "view_space_grad_avg", "position_grad",
          "position_grad_norm")


def _both(tmp_path, nan_position):
    """(port, reference) per step: the loss, the state after it; and the
    first step's gradients (positions, features) of each."""
    root = str(tmp_path)
    F.write_dataset(root, n_views=B)
    torch.set_num_threads(1)
    config = tconfig.from_dict(TT.TrainConfig, F.config_dict(root, **RULES))
    trainer = TT.GaussianPointCloudTrainer(config, device="cpu")
    pc = trainer.scene.point_cloud.numpy().copy()
    feats = trainer.scene.point_cloud_features.numpy().copy()
    rng = np.random.default_rng(5)
    feats[:, 4:7] += rng.uniform(-0.5, 0.5, (feats.shape[0], 3))
    if nan_position:
        assert trainer.scene.point_invalid_mask[NAN_ROW] == 0
        pc[NAN_ROW, 0] = np.nan
    trainer.scene = trainer.scene._replace(
        point_cloud=torch.tensor(pc), point_cloud_features=torch.tensor(feats))
    ref = RT.initial_state(torch.tensor(pc), torch.tensor(feats),
                           trainer.scene.point_invalid_mask.clone())
    hp = _hyper(config)
    rules = RB.Rules(B, "sqrt", True, True)
    port_steps, ref_steps, grads = [], [], {}
    for idxs in BATCHES:
        images, qs, ts, intrs, cam = F.batch_views(trainer, idxs)
        out = trainer.batch_step(images, qs, ts, intrs, F.SH_BAND, cam)
        port_steps.append((float(out.metrics["loss"]), _state_of(trainer)))
        views = [(images[i], qs[i], ts[i]) for i in range(B)]
        r = RB.batch_step(ref, views, _camera(cam), hp, rules)
        ref = r.state
        ref_steps.append((r.loss, _ref_state_of(ref)))
        if not grads:
            b1 = trainer.betas[0]
            grads["port"] = (trainer.opt_positions.mu / (1.0 - b1),
                             trainer.opt_features.mu / (1.0 - b1))
            grads["ref"] = (r.grad_pc, r.grad_feats)
    trainer.logger.close()
    return port_steps, ref_steps, grads


@pytest.fixture(scope="module", params=[False, True],
                ids=["finite", "nan_position"])
def both(request, tmp_path_factory):
    return request.param, _both(tmp_path_factory.mktemp("batch"),
                                request.param)


def _assert_field(got, want, name):
    """rtol 1e-4 and an atol of 1e-5 times the field's largest finite
    magnitude: the blends, the routing and the projection's VJP sum in
    other orders on the two sides; NaN must stand where the other side
    has it."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    finite = np.isfinite(want)
    scale = max(np.abs(want[finite]).max() if finite.any() else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               equal_nan=True, err_msg=name)


@pytest.mark.parametrize("k", range(len(BATCHES)))
def test_losses_match(both, k):
    """The step's mean loss to 1e-5 relative: the port sums the views'
    float32 losses on the device, the reference averages them in float64."""
    _, (port, ref, _) = both
    assert abs(port[k][0] - ref[k][0]) <= 1e-5 * abs(ref[k][0])


def test_first_gradients_match(both):
    """The summed gradients as the update takes them (rows with a
    non-finite value zeroed: the NaN position's row is 0 on both sides),
    the port's read from Adam's first moments over 1 - 0.9 ** 4."""
    nan_position, (_, _, grads) = both
    for name, got, want in zip(("positions", "features"), grads["port"],
                               grads["ref"]):
        assert bool(torch.isfinite(want).all())
        assert float(torch.linalg.norm(want)) > 0
        _assert_field(got.numpy(), want.numpy(), name)
        zeroed = bool((got[NAN_ROW] == 0).all() and (want[NAN_ROW] == 0)
                      .all())
        assert zeroed == nan_position


@pytest.mark.parametrize("k", range(len(BATCHES)))
def test_state_matches(both, k):
    """Positions, features, both Adam moments and the six accumulators
    after step k."""
    nan_position, (port, ref, _) = both
    for name, got, want in zip(FIELDS, port[k][1], ref[k][1]):
        _assert_field(got.numpy(), want.numpy(), f"step {k} {name}")
    pos_grad = dict(zip(FIELDS, port[k][1]))["position_grad"]
    assert bool(torch.isnan(pos_grad[NAN_ROW]).all()) == nan_position
    assert bool(torch.isfinite(torch.cat([pos_grad[:NAN_ROW],
                                          pos_grad[NAN_ROW + 1:]])).all())


def _finite_views(tmp_path):
    root = str(tmp_path)
    F.write_dataset(root, n_views=2)
    config = tconfig.from_dict(TT.TrainConfig, F.config_dict(root))
    trainer = TT.GaussianPointCloudTrainer(config, device="cpu")
    images, qs, ts, _, cam = F.batch_views(trainer, [0, 1])
    s = trainer.scene
    feats = s.point_cloud_features.numpy().copy()
    feats[:, 4:7] += np.random.default_rng(5).uniform(
        -0.5, 0.5, (feats.shape[0], 3))
    state = RT.initial_state(s.point_cloud.clone(), torch.tensor(feats),
                             s.point_invalid_mask.clone())
    trainer.logger.close()
    return state, images, qs, ts, _camera(cam), _hyper(config)


def test_a_batch_of_one_is_the_single_view_step(tmp_path):
    """Two steps of one view each: the batch reference at B = 1 and
    `reference/train.py::step` give the same losses, gradients and states,
    bit for bit (the same operations; a sum of one view adds it to
    zeros)."""
    state, images, qs, ts, cam, hp = _finite_views(tmp_path)
    one, single = state, state
    for i in range(2):
        a = RB.batch_step(one, [(images[i], qs[i], ts[i])], cam, hp,
                          RB.Rules(1))
        b = RT.step(single, images[i], qs[i], ts[i], cam, hp)
        assert a.loss == b.loss
        for x, y in zip((a.grad_pc, a.grad_feats, *_ref_state_of(a.state)),
                        (b.grad_pc, b.grad_feats, *_ref_state_of(b.state))):
            assert torch.equal(x, y)
        one, single = a.state, b.state
    assert int(one.adam_pc.count) == 2


@pytest.mark.parametrize("batch_size,lr,schedules,betas", [
    (4, "sqrt", True, True), (4, "linear", False, False),
    (8, "none", True, False), (3, "sqrt", True, True)])
def test_the_batch_rules_are_the_trainers(tmp_path, batch_size, lr,
                                          schedules, betas):
    """The reference's rates, decay interval and betas against the
    trainer's (`_scale_schedules_for_batch` and its Adam groups)."""
    root = str(tmp_path)
    F.write_dataset(root, n_views=1)
    config = tconfig.from_dict(TT.TrainConfig, F.config_dict(
        root, batch_size=batch_size, scale_lr_with_batch=lr,
        scale_schedules_with_batch=schedules,
        scale_betas_with_batch=betas,
        position_learning_rate_decay_interval=50))
    hp, (b1, b2) = RB.scaled(_hyper(config),
                             RB.Rules(batch_size, lr, schedules, betas))
    trainer = TT.GaussianPointCloudTrainer(config, device="cpu")
    trainer.logger.close()
    c = trainer.config
    assert hp.feature_lr == c.feature_learning_rate
    assert hp.position_lr == c.position_learning_rate
    assert hp.position_lr_interval == c.position_learning_rate_decay_interval
    assert (b1, b2) == trainer.betas
    group = trainer.train_step.features
    assert (group.b1, group.b2) == (b1, b2)
