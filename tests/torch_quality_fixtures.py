"""The synthetic quality recipe of tests/test_quality_synthetic.py in numpy
and torch (that file imports jax): its ground-truth scene of random
gaussians in a cube, the orbit poses, the held-out split (every 8th view
is validation only) and the half-subsampled, jittered init, written as a
dataset that either package's trainer reads, and the recipe's TrainConfig
as a dict that either package's `config.from_dict` loads.

The GT images come from a `render(pose, intrinsics, height, width)`
callable, so that each package renders its own; `port_renderer` is the
port's. The same generator, scaled, makes the 976x544 scene of
chip_smoke.py phase 11 (`BIG`).

Used by tests/test_torch_quality.py, tests/test_torch_quality_long.py and
chip_smoke.py."""

import json
import os

import numpy as np
import torch

# tests/test_quality_synthetic.py: 64x64, focal 60, 32 views on an orbit of
# radius 2.5, 200 GT points in [-0.6, 0.6]^3, every 8th view held out
SIZE, FOCAL = 64, 60.0
N_VIEWS, N_POINTS, HOLD_OUT_EVERY = 32, 200, 8
RADIUS, EXTENT, INIT_JITTER = 2.5, 0.6, 0.03
NEAR, FAR = 0.3, 50.0
# The JAX test's rasterizer sorts depth in buckets of 1 / 100 (the default
# depth_to_sort_key_scale): its 200 points fall into about 90 buckets per
# view, and the two packages blend the keys of one bucket in different
# orders (neither order is defined; ROADMAP.md queue 3). The parity tests
# on the CPU sort in buckets of 1e-5 instead, where no two keys tie.
TIE_FREE_KEY_SCALE = 1e5
# the DC colour sigmoid(SH_C0 * f) of an SH coefficient f
SH_C0 = 0.28209479177387814

# chip_smoke.py phase 11 (b): the same generator at 976x544, fx 581.7, with
# 100,000 GT points in a cube of half-size 3 seen from an orbit of radius 10
# (the cube's diagonal then spans ~85% of the frame's width and its faces
# ~90% of its height) and 24 views; every scale is multiplied by the cube's
# growth (5x) and divided by the cube root of the growth in points (500x),
# so that a splat covers about as many pixels as in the 64x64 recipe
BIG = dict(height=544, width=976, focal=581.7, n_views=24, n_points=100000,
           radius=10.0, extent=3.0,
           log_scale_shift=float(np.log(5.0) - np.log(500.0) / 3.0),
           colours=True)


def orbit_pose(angle, radius=RADIUS):
    """Camera-to-world 4x4 of a camera on a circle in the xz plane looking
    at the origin (x right, y down, z forward)."""
    eye = np.array([radius * np.sin(angle), 0.0, -radius * np.cos(angle)])
    forward = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, forward, eye
    return T


def gt_scene(rng, n_points=N_POINTS, extent=EXTENT, log_scale_shift=0.0):
    """(positions (n, 3), features (n, 56)) drawn from `rng` as the JAX
    test draws them: uniform positions, random rotations, log-scales in
    [-3.2, -2.2] (+ `log_scale_shift`), alpha logits in [1, 4], a DC colour
    and band-1 view dependence per channel."""
    pc = rng.uniform(-extent, extent, (n_points, 3)).astype(np.float32)
    feats = np.zeros((n_points, 56), np.float32)
    q = rng.normal(size=(n_points, 4))
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-3.2, -2.2, (n_points, 3)) + log_scale_shift
    feats[:, 7] = rng.uniform(1.0, 4.0, n_points)
    feats[:, 8] = rng.normal(size=n_points) * 1.5
    feats[:, 24] = rng.normal(size=n_points) * 1.5
    feats[:, 40] = rng.normal(size=n_points) * 1.5
    for ch in (9, 25, 41):
        feats[:, ch:ch + 3] = rng.normal(size=(n_points, 3)) * 0.4
    return pc, feats


def intrinsics(focal, height, width):
    return np.array([[focal, 0, width / 2], [0, focal, height / 2],
                     [0, 0, 1]], np.float32)


def write_dataset(root, render_factory, size=SIZE, focal=None, height=None,
                  width=None, n_views=N_VIEWS, n_points=N_POINTS, seed=0,
                  radius=RADIUS, extent=EXTENT, log_scale_shift=0.0,
                  jitter=INIT_JITTER, colours=False):
    """Write the recipe's dataset under `root`: images/v{i}.png, train.json
    (the views not held out), val.json (every HOLD_OUT_EVERY-th view) and
    point_cloud.parquet (a half subsample of the GT points with N(0,
    `jitter`) noise, plus each point's DC colour in r, g, b with
    `colours`). `render_factory(pc, feats)` returns the renderer of the GT
    scene. The defaults are the JAX test's at `size` x `size` (the focal
    scaled with the size). Returns (pc, feats) of the GT scene."""
    import pandas as pd
    import PIL.Image
    height = height or size
    width = width or size
    focal = focal if focal is not None else FOCAL * width / SIZE
    rng = np.random.default_rng(seed)
    pc, feats = gt_scene(rng, n_points, extent, log_scale_shift)
    intr = intrinsics(focal, height, width)
    render = render_factory(pc, feats)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    records = []
    for vi in range(n_views):
        pose = orbit_pose(2 * np.pi * vi / n_views, radius)
        img = np.clip(render(pose, intr, height, width), 0, 1)
        path = os.path.join(root, "images", f"v{vi}.png")
        PIL.Image.fromarray((img * 255).astype(np.uint8)).save(path)
        records.append(dict(image_path=path, T_pointcloud_camera=pose.tolist(),
                            camera_intrinsics=intr.tolist(),
                            camera_height=height, camera_width=width,
                            camera_id=0))
    held_out = records[::HOLD_OUT_EVERY]
    train = [r for i, r in enumerate(records) if i % HOLD_OUT_EVERY != 0]
    for name, recs in (("train.json", train), ("val.json", held_out)):
        with open(os.path.join(root, name), "w") as f:
            json.dump(recs, f)
    keep = rng.random(n_points) < 0.5
    init = pc[keep] + rng.normal(scale=jitter, size=(int(keep.sum()), 3))
    df = pd.DataFrame(init.astype(np.float32), columns=["x", "y", "z"])
    if colours:
        dc = 1.0 / (1.0 + np.exp(-SH_C0 * feats[keep][:, [8, 24, 40]]))
        df[["r", "g", "b"]] = np.clip(np.round(dc * 255), 1, 254).astype(
            np.int64)
    df.to_parquet(os.path.join(root, "point_cloud.parquet"))
    return pc, feats


def port_renderer(device="cpu", near=NEAR, far=FAR, depth_key_scale=100.0):
    """A `render_factory` for write_dataset through the port's full render
    (wide16 slab, as the JAX test's default RasterizerConfig) with depth
    sort buckets of 1 / `depth_key_scale`."""
    from taichi_3d_gaussian_splatting_torch.camera import CameraInfo
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        RasterizerConfig, rasterize)
    from taichi_3d_gaussian_splatting_torch.ops.transforms import (
        SE3_to_quaternion_and_translation)

    def factory(pc, feats):
        n = pc.shape[0]
        scene = GaussianPointCloudScene.from_numpy(
            pc, feats, np.zeros(n), np.zeros(n), device)
        cfg = RasterizerConfig(near_plane=near, far_plane=far,
                               depth_to_sort_key_scale=depth_key_scale)

        def render(pose, intr, height, width):
            q, t = SE3_to_quaternion_and_translation(
                torch.as_tensor(pose, device=device)[None])
            with torch.no_grad():
                return rasterize(*scene, q, t,
                                 CameraInfo(intr, height, width),
                                 cfg).image.cpu().numpy()
        return render
    return factory


def quality_config(root, num_iterations=601, **over):
    """test_quality_synthetic.py's TrainConfig as a dict for either
    package's `config.from_dict`, reading the dataset under `root` and
    logging to `root`/logs; `over` replaces top-level keys, and
    `controller` / `scene` / `raster` dicts update those sections."""
    controller = dict(
        num_iterations_warm_up=40, num_iterations_densify=40,
        num_iterations_reset_alpha=10 ** 6,
        densification_view_space_position_gradients_threshold=1e-5,
        under_reconstructed_num_pixels_threshold=2000,
        transparent_alpha_threshold=-3.0,
        iteration_start_remove_floater=10 ** 9)
    controller.update(over.pop("controller", {}))
    scene = dict(max_num_points_ratio=4.0, initial_alpha=0.5,
                 max_initial_covariance=0.3)
    scene.update(over.pop("scene", {}))
    raster = dict(near_plane=NEAR, far_plane=FAR, max_tiles_per_point=16,
                  big_point_divisor=4)
    raster.update(over.pop("raster", {}))
    d = dict(
        train_dataset_json_path=os.path.join(root, "train.json"),
        val_dataset_json_path=os.path.join(root, "val.json"),
        pointcloud_parquet_path=os.path.join(root, "point_cloud.parquet"),
        num_iterations=num_iterations, val_interval=300,
        feature_learning_rate=0.02, position_learning_rate=2e-4,
        position_learning_rate_decay_rate=0.995,
        increase_color_max_sh_band_interval=100,
        initial_downsample_factor=1, log_loss_interval=50,
        log_metrics_interval=100, log_image_interval=10 ** 9,
        save_full_checkpoint=False,
        summary_writer_log_dir=os.path.join(root, "logs"),
        rasterisation_config=raster,
        adaptive_controller_config=controller,
        gaussian_point_cloud_scene_config=scene,
        loss_function_config=dict(enable_regularization=False))
    d.update(over)
    return d


def read_metrics(logdir):
    """The records of `logdir`/metrics.jsonl, in order."""
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def series(records, key):
    """{iteration: value} of every record holding `key`."""
    return {r["iteration"]: r[key] for r in records if key in r}


def held_out_psnr(scene, dataset, raster_config):
    """Mean PSNR of the port's render of `scene` over the views of
    `dataset` (an ImagePoseDataset), clipped as the trainer's validation
    clips it."""
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import rasterize
    from taichi_3d_gaussian_splatting_torch.training.ssim import psnr
    device = scene.point_cloud.device
    values = []
    for i in range(len(dataset)):
        item = dataset[i]
        with torch.no_grad():
            image = rasterize(
                *scene, torch.as_tensor(item.q_pointcloud_camera,
                                        device=device),
                torch.as_tensor(item.t_pointcloud_camera, device=device),
                item.camera_info, raster_config).image
        values.append(float(psnr(torch.clamp(image, 0.0, 1.0),
                                 torch.as_tensor(item.image, device=device))))
    return float(np.mean(values))
