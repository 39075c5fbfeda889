"""A small training set for the port's trainer, written with the port's
own render (torch only, no JAX), and the config the trainer tests run it
with. Used by tests/test_torch_training.py, tests/test_torch_cuda.py and
chip_smoke.py."""

import functools
import json
import os

import numpy as np
import torch

from taichi_3d_gaussian_splatting_torch.camera import CameraInfo as TCamera
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene)
from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
    RasterizerConfig as TRasterizerConfig, rasterize as trasterize)


H = W = 32
FOCAL = 24.0


def write_dataset(root, n_views=3, n_points=30, seed=0, size=W):
    """A size x size (32x32) dataset rendered by the port: PNGs, train/val
    JSONs and a jittered init parquet with r, g, b columns."""
    import pandas as pd
    import PIL.Image
    rng = np.random.default_rng(seed)
    pc = np.concatenate([rng.uniform(-0.7, 0.7, (n_points, 2)),
                         rng.uniform(1.5, 3.0, (n_points, 1))],
                        axis=1).astype(np.float32)
    feats = np.zeros((n_points, 56), np.float32)
    q = rng.normal(size=(n_points, 4))
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-2.5, -1.5, (n_points, 3))
    feats[:, 7] = 2.0
    feats[:, 8] = rng.normal(size=n_points) + 1
    feats[:, 24] = rng.normal(size=n_points)
    feats[:, 40] = rng.normal(size=n_points) - 0.5
    focal = FOCAL * size / W
    intr = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]],
                    np.float32)
    scene = TScene.from_numpy(pc, feats, np.zeros(n_points),
                              np.zeros(n_points), "cpu")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    records = []
    for v in range(n_views):
        t = np.array([0.05 * (v - 1), 0.02 * v, -0.1 * v], np.float32)
        with torch.no_grad():
            img = trasterize(*scene, torch.tensor([[0.0, 0.0, 0.0, 1.0]]),
                             torch.tensor(t[None]), TCamera(intr, size, size),
                             TRasterizerConfig(near_plane=0.1,
                                               rgb_only=True)).image
        path = os.path.join(root, "images", f"view_{v}.png")
        PIL.Image.fromarray((img.clamp(0, 1).numpy() * 255).astype(
            np.uint8)).save(path)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = t
        records.append(dict(image_path=path, T_pointcloud_camera=pose.tolist(),
                            camera_intrinsics=intr.tolist(),
                            camera_height=size, camera_width=size,
                            camera_id=0))
    with open(os.path.join(root, "train.json"), "w") as f:
        json.dump(records, f)
    with open(os.path.join(root, "val.json"), "w") as f:
        json.dump(records[:1], f)
    init = pc + rng.normal(scale=0.05, size=pc.shape).astype(np.float32)
    # init depths on a ladder 5 sort buckets apart, mid-bucket in every
    # view: no two keys tie, so both packages blend in one order
    init[:, 2] = 1.505 + 0.05 * rng.permutation(n_points)
    df = pd.DataFrame(init, columns=["x", "y", "z"])
    df[["r", "g", "b"]] = rng.integers(1, 255, (n_points, 3))
    df.to_parquet(os.path.join(root, "pc.parquet"))


def config_dict(root, **over):
    d = dict(
        train_dataset_json_path=os.path.join(root, "train.json"),
        val_dataset_json_path=os.path.join(root, "val.json"),
        pointcloud_parquet_path=os.path.join(root, "pc.parquet"),
        num_iterations=21, val_interval=10, feature_learning_rate=5e-3,
        position_learning_rate=1e-3,
        position_learning_rate_decay_rate=0.5,
        position_learning_rate_decay_interval=100,
        initial_downsample_factor=1, log_loss_interval=1,
        log_image_interval=10 ** 9,
        summary_writer_log_dir=os.path.join(root, "logs"),
        rasterisation_config=dict(
            near_plane=0.1, max_keys=2048, max_tiles_per_point=16,
            mid_point_divisor=1, big_point_divisor=1),
        adaptive_controller_config=dict(
            num_iterations_warm_up=5, num_iterations_densify=5,
            transparent_alpha_threshold=-3.0,
            densification_view_space_position_gradients_threshold=1e-4),
        gaussian_point_cloud_scene_config=dict(max_num_points_ratio=2.0,
                                               initial_alpha=1.0))
    d.update(over)
    return d


def one_step_state(root, device, **over):
    """Build the port's trainer on `device` from the dataset under `root`
    (see write_dataset / config_dict), make its scales anisotropic (seeded,
    so that no gradient is pure rounding noise), take one step on view 0
    and return (loss, the training state as numpy arrays by name); `over`
    changes the config (config_dict)."""
    from taichi_3d_gaussian_splatting_torch import config as tconfig
    from taichi_3d_gaussian_splatting_torch.training import trainer as TT
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, config_dict(root, **over)),
        device=device)
    feats = trainer.scene.point_cloud_features.cpu().numpy()
    rng = np.random.default_rng(5)
    feats[:, 4:7] += rng.uniform(-0.5, 0.5, (feats.shape[0], 3))
    trainer.scene = trainer.scene._replace(
        point_cloud_features=torch.as_tensor(feats, device=trainer.device))
    item = trainer.train_dataset[0]
    out = trainer.step(
        torch.as_tensor(item.image, device=trainer.device),
        torch.as_tensor(item.q_pointcloud_camera, device=trainer.device),
        torch.as_tensor(item.t_pointcloud_camera, device=trainer.device), 0,
        item.camera_info)
    arrays = {k: v.cpu().numpy() for k, v in trainer.state_arrays().items()
              if not k.endswith("generator")}
    trainer.logger.close()
    return float(out.metrics["loss"]), arrays


# the views of each batch step of batch_step_state
BATCHES = ([0, 1], [2, 0])
SH_BAND = 1


def batch_views(trainer, idxs):
    """(images (B, H, W, 3), qs, ts, intrinsics (B, 3, 3), camera) of the
    training views `idxs`, on the trainer's device."""
    items = [trainer.train_dataset[i] for i in idxs]

    def stack(name):
        return torch.as_tensor(np.stack([getattr(it, name) for it in items]),
                               device=trainer.device)

    return (stack("image"), stack("q_pointcloud_camera"),
            stack("t_pointcloud_camera"),
            np.stack([it.camera_info.camera_intrinsics for it in items]),
            items[-1].camera_info)


def batch_step_state(device, root, **over):
    """The port's trainer with batch_size 2 on `device` (under the process
    group, if one is initialized) from the dataset under `root`, anisotropic
    scales as in one_step_state, two batch steps on the views of BATCHES;
    returns {"losses": [...], "state": the training state as numpy
    arrays}; `over` changes the config (config_dict)."""
    from taichi_3d_gaussian_splatting_torch import config as tconfig
    from taichi_3d_gaussian_splatting_torch.training import trainer as TT
    torch.set_num_threads(1)
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig,
                          config_dict(root, batch_size=2, **over)),
        device=device)
    feats = trainer.scene.point_cloud_features.cpu().numpy()
    rng = np.random.default_rng(5)
    feats[:, 4:7] += rng.uniform(-0.5, 0.5, (feats.shape[0], 3))
    trainer.scene = trainer.scene._replace(
        point_cloud_features=torch.as_tensor(feats, device=trainer.device))
    losses = []
    for idxs in BATCHES:
        images, qs, ts, intrs, cam = batch_views(trainer, idxs)
        out = trainer.batch_step(images, qs, ts, intrs, SH_BAND, cam)
        losses.append(float(out.metrics["loss"]))
    trainer.logger.close()
    return {"losses": losses,
            "state": {k: v.cpu().numpy()
                      for k, v in trainer.state_arrays().items()
                      if not k.endswith("generator")}}


# The cases of training/adam_cuda.py::optimizer_update's tests: what each
# changes from the default inputs (count 0, SH band 1, the trainer's betas,
# a finite loss, finite gradients, no direct gradient, a single-view step's
# raw gradient with its group scale and band mask).
OPTIMIZER_CASES = {
    "finite": {},
    "nan_feature_rows": {"bad_feats": True},
    "inf_position_rows": {"bad_pc": True},
    "both_rows": {"bad_feats": True, "bad_pc": True},
    "loss_not_finite": {"loss_ok": False, "bad_feats": True},
    "count_past_decay": {"count": 150},
    "batch_betas": {"betas": (0.9 ** 4, 0.999 ** 4), "count": 3},
    "band_0": {"band": 0},
    "band_3_direct": {"band": 3, "direct": True},
    "batch_form": {"batch": True, "bad_pc": True},
    "empty_slots": {"empty": True, "count": 7},
}


def optimizer_inputs(case, n, device, seed=0):
    """(args, kwargs) of optimizer_update for OPTIMIZER_CASES[case] (or
    `case` itself, a dict of the same keys) at `n` slots, drawn on `device`
    from `seed`: moments from an earlier update, gradients with exact and
    negative zeros, and, where the case asks, NaN and inf in feature rows
    (one in an inactive SH column, where the band mask's 0 turns it into
    NaN) and position rows, the first and last slots among them; with
    `empty`, the second half of the slots all zero (parameters, gradients,
    the direct gradient and moments), as the pool's free slots are, the
    last quarter -0.0."""
    from taichi_3d_gaussian_splatting_torch.ops.sh import feature_sh_band_mask
    from taichi_3d_gaussian_splatting_torch.training.adam import (
        AdamGroup, AdamState, exponential_decay_lr)
    c = dict(OPTIMIZER_CASES[case] if isinstance(case, str) else case)
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    count = torch.tensor(c.get("count", 0), dtype=torch.int32, device=device)
    feats, pc = normal(n, 56), normal(n, 3)
    grad_feats, grad_pc = normal(n, 56, scale=1e-2), normal(n, 3, scale=1e-3)
    for g in (grad_feats, grad_pc):
        g[torch.rand(g.shape, generator=gen, device=device) < 0.05] = 0.0
        g[torch.rand(g.shape, generator=gen, device=device) < 0.05] = -0.0
    opt_f = AdamState(normal(n, 56, scale=1e-3),
                      normal(n, 56, scale=1e-3) ** 2, count.clone())
    opt_p = AdamState(normal(n, 3, scale=1e-4), normal(n, 3, scale=1e-4) ** 2,
                      count.clone())
    bad = torch.unique(torch.cat([
        torch.tensor([0, n - 1], device=device),
        torch.randint(0, n, (max(n // 100, 1),), generator=gen,
                      device=device)]))
    if c.get("bad_feats"):
        grad_feats[bad[::2], 5] = float("nan")
        grad_feats[bad[1::2], 55] = float("inf")
    if c.get("bad_pc"):
        grad_pc[bad[1::3], 1] = float("-inf")
        grad_pc[bad[::3], 2] = float("nan")
    if c.get("empty"):
        for t in (feats, pc, grad_feats, grad_pc, *opt_f[:2], *opt_p[:2]):
            t[n // 2:] = 0.0
            t[3 * n // 4:] = -0.0
    b1, b2 = c.get("betas", (0.9, 0.999))
    position_lr = functools.partial(exponential_decay_lr, 1e-3, 0.5, 100)
    groups = (AdamGroup(5e-3, b1, b2), AdamGroup(position_lr, b1, b2))
    kwargs = {}
    if not c.get("batch"):
        scale = torch.full((56,), 0.75, device=device)
        scale[0:4], scale[4:7], scale[7] = 1.0, 0.5, 20.0
        scale[[8, 24, 40]] = 5.0
        kwargs = {"grad_scale": scale,
                  "band_mask": feature_sh_band_mask(c.get("band", 1),
                                                    device=device)}
        if c.get("direct"):
            kwargs["grad_feats_direct"] = direct = normal(n, 56, scale=1e-4)
            if c.get("empty"):
                direct[n // 2:] = 0.0
                direct[3 * n // 4:] = -0.0
    loss_ok = torch.tensor(c.get("loss_ok", True), device=device)
    return ([feats, grad_feats, pc, grad_pc, opt_f, opt_p, *groups,
             loss_ok], kwargs)


def accumulate_inputs(n, device, seed=0, band=1, direct=False, views=4):
    """(views, grad_scale, band_mask) of a batch step's running sums
    (accumulate_view_gradients) at `n` slots, drawn on `device` from
    `seed`: `views` tuples (grad_feats_raster (n, 56), grad_pc (n, 3),
    grad_feats_direct (n, 56) or None) with exact and negative zeros, rows
    of -0.0 in every array (a first view's sum of them is +0.0), and NaN,
    +inf and -inf in the first, the last and a few other slots of each view
    (one +inf in an inactive SH column of band 0, where the band mask's 0
    turns it into NaN); the group scale of optimizer_inputs and the band
    mask of SH band `band`."""
    from taichi_3d_gaussian_splatting_torch.ops.sh import feature_sh_band_mask
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)

    def normal(*shape, scale):
        g = torch.randn(shape, generator=gen, device=device) * scale
        g[torch.rand(shape, generator=gen, device=device) < 0.05] = 0.0
        g[torch.rand(shape, generator=gen, device=device) < 0.05] = -0.0
        return g

    out = []
    for _ in range(views):
        raster, grad_pc = normal(n, 56, scale=1e-2), normal(n, 3, scale=1e-3)
        d = normal(n, 56, scale=1e-4) if direct else None
        for t in (raster, grad_pc, d):
            if t is not None:
                t[1::7] = -0.0
        bad = torch.unique(torch.cat([
            torch.tensor([0, n - 1], device=device),
            torch.randint(0, n, (max(n // 100, 1),), generator=gen,
                          device=device)]))
        raster[bad[::2], 5] = float("nan")
        raster[bad[1::2], 55] = float("inf")
        raster[bad[::3], 10] = float("-inf")
        grad_pc[bad[1::3], 1] = float("-inf")
        grad_pc[bad[::3], 2] = float("nan")
        if d is not None:
            d[bad[::4], 30] = float("inf")
        out.append((raster, grad_pc, d))
    scale = torch.full((56,), 0.75, device=device)
    scale[0:4], scale[4:7], scale[7] = 1.0, 0.5, 20.0
    scale[[8, 24, 40]] = 5.0
    return out, scale, feature_sh_band_mask(band, device=device)


# The cases of optimizer_update on the stored, unnormalized quaternions:
# the step's form (single view with a direct gradient, or batch), each
# slot's quaternion norm (None: log-uniform from 1e-3 to 1e3 across the
# slots) and what else changes, as in OPTIMIZER_CASES.
RAW_QUATERNION_CASES = {
    f"{form}_{name}": dict(over, batch=form == "batch",
                           direct=form == "single")
    for form in ("single", "batch")
    for name, over in (("norm_1e-3", {"norm": 1e-3}),
                       ("norm_1", {"norm": 1.0}),
                       ("norm_1e3", {"norm": 1e3}),
                       ("norms_spread", {"norm": None}),
                       ("zero_rows", {"norm": None, "empty": True,
                                      "count": 7}),
                       ("loss_not_finite", {"norm": None, "loss_ok": False,
                                            "bad_feats": True}))}


def parent_normalize(feats):
    """The features with each quaternion normalized as the steps did before
    the update took the stored features (copied): the norm floored so that
    an all-zero slot stays 0."""
    q = feats[:, 0:4] / torch.clamp(torch.linalg.norm(
        feats[:, 0:4], dim=1, keepdim=True), min=1e-12)
    return torch.cat([q, feats[:, 4:]], dim=1)


def raw_quaternion_inputs(case, n, device, seed=0):
    """((args, kwargs) on the stored features, (args, kwargs) as the parent
    handed them) of optimizer_update for RAW_QUATERNION_CASES[case] at `n`
    slots. Both hold one set of quaternions, some with exact zeros among
    their components: stored at the case's norms, and
    normalized by `parent_normalize` for the parent, with the gradients of
    optimizer_inputs taken as the ones with respect to the normalized value.
    The stored form's quaternion gradient columns (and the direct
    gradient's) are those divided by the norm, as the projection's backward
    gives them: times the inverse square root of the squared norm floored at
    1e-24."""
    c = dict(RAW_QUATERNION_CASES[case])
    norm = c.pop("norm")
    args, kwargs = optimizer_inputs(c, n, device, seed)
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed + 1)
    norms = (10.0 ** (torch.rand((n, 1), generator=gen, device=device) * 6.0
                      - 3.0) if norm is None
             else torch.full((n, 1), norm, device=device))
    feats = args[0]
    stored = torch.cat([parent_normalize(feats)[:, 0:4] * norms,
                        feats[:, 4:]], dim=1)
    # exact zeros inside nonzero quaternions, as an initial (0, 0, 0, 1) has
    stored[3::7, 0:3] = 0.0
    stored[5::11, 1] = -0.0
    q = stored[:, 0:4]
    inv = torch.rsqrt(torch.clamp((q * q).sum(dim=1, keepdim=True),
                                  min=1e-24))

    def wrt_stored(g):
        return torch.cat([g[:, 0:4] * inv, g[:, 4:]], dim=1)

    raw_kwargs = dict(kwargs)
    if "grad_feats_direct" in kwargs:
        raw_kwargs["grad_feats_direct"] = wrt_stored(
            kwargs["grad_feats_direct"])
    return (([stored, wrt_stored(args[1]), *args[2:]], raw_kwargs),
            ([parent_normalize(stored), *args[1:]], kwargs))


def assert_bitwise_equal(got, want, what=""):
    """Every tensor of two (nested) tuples equal bit for bit: signed zeros
    and NaN payloads included."""
    if isinstance(want, tuple):
        assert len(got) == len(want), what
        for k, (a, b) in enumerate(zip(got, want)):
            assert_bitwise_equal(a, b, f"{what}[{k}]")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, what
    a, b = got.detach().cpu(), want.detach().cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    diff = int((a != b).sum())
    assert diff == 0, f"{what}: {diff} values differ"


def loss_images(h, w, seed, device="cpu"):
    """(render, ground truth), float32 (h, w, 3), for the image loss: a
    ground truth of smooth shading and fine texture in 8-bit levels, and a
    render near it with 8% of its values pushed outside [0, 1], 5% equal to
    the ground truth and 2% exactly 0 or 1 (half of those on a ground truth
    equal to them)."""
    rng = np.random.default_rng(seed)
    r = np.linspace(0.0, 1.0, h)[:, None, None]
    c = np.linspace(0.0, 1.0, w)[None, :, None]
    phase = rng.uniform(0.0, 2 * np.pi, (1, 1, 3))
    gt = (0.5 + 0.35 * np.sin(7.0 * r + phase) * np.cos(5.0 * c - phase)
          + 0.08 * rng.normal(size=(h, w, 3)))
    gt = np.round(np.clip(gt, 0.0, 1.0) * 255.0) / 255.0
    render = gt + 0.05 * rng.normal(size=(h, w, 3))
    u = rng.random((h, w, 3))
    render = np.where(u < 0.04, -rng.uniform(0.0, 0.3, (h, w, 3)), render)
    render = np.where((u >= 0.04) & (u < 0.08),
                      1.0 + rng.uniform(0.0, 0.3, (h, w, 3)), render)
    render = np.where((u >= 0.08) & (u < 0.13), gt, render)
    ends = (u >= 0.13) & (u < 0.15)
    end = np.where(rng.random((h, w, 3)) < 0.5, 0.0, 1.0)
    render = np.where(ends, end, render)
    gt = np.where(ends & (rng.random((h, w, 3)) < 0.5), end, gt)
    return (torch.as_tensor(render.astype(np.float32), device=device),
            torch.as_tensor(gt.astype(np.float32), device=device))
