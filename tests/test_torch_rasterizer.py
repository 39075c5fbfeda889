"""Port parity for the whole render slice: the JAX package's `rasterize`
against taichi_3d_gaussian_splatting_torch's `rasterize` on the three
fixtures of tests/ab_runner.py, on one scene carried over with
GaussianPointCloudScene.from_numpy. Cases: rgb_only with the default slab
(packed8), rgb_only with wide16, and the full render (depth, count) with
every aux field. Tolerances are those of tests/test_tpu_exactness.py."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.camera import CameraInfo as JCamera
from taichi_3d_gaussian_splatting_tpu.models.scene import (
    GaussianPointCloudScene as JScene)
from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as JR
from taichi_3d_gaussian_splatting_torch import render as trender
from taichi_3d_gaussian_splatting_torch.camera import CameraInfo as TCamera
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene)
from taichi_3d_gaussian_splatting_torch.ops import rasterizer as TR

from torch_port_fixtures import (AB_CASES, ATOL, COVERED_ALPHA, RTOL,
                                 assert_counts_close, camera_intrinsics,
                                 identity_pose, random_scene)

torch.set_num_threads(1)
MODES = {"rgb_auto": dict(rgb_only=True),
         "rgb_wide16": dict(rgb_only=True, slab_format="wide16"),
         "full": dict(rgb_only=False)}


def _render_both(seed, alpha, cfg, mode):
    pc, feats = random_scene(60, seed=seed, alpha=alpha)
    n = pc.shape[0]
    jscene = JScene(jnp.asarray(pc), jnp.asarray(feats),
                    jnp.zeros(n, jnp.int8), jnp.zeros(n, jnp.int32))
    tscene = TScene.from_numpy(*(np.asarray(x) for x in jscene),
                               device="cpu")
    q, t = identity_pose()
    K = camera_intrinsics()
    jres = JR.rasterize(*jscene, jnp.asarray(q), jnp.asarray(t),
                        JCamera(K, 32, 32),
                        JR.RasterizerConfig(**cfg, **MODES[mode]))
    tres = TR.rasterize(*tscene, torch.as_tensor(q), torch.as_tensor(t),
                        TCamera(K, 32, 32),
                        TR.RasterizerConfig(**cfg, **MODES[mode]))
    return jres, tres


@pytest.mark.parametrize("seed, alpha, label, cfg", AB_CASES,
                         ids=[c[2] for c in AB_CASES])
@pytest.mark.parametrize("mode", list(MODES))
def test_rasterize_matches_jax(seed, alpha, label, cfg, mode):
    jres, tres = _render_both(seed, alpha, cfg, mode)
    image = tres.image.numpy()
    assert image.shape == (32, 32, 3) and np.isfinite(image).all()
    np.testing.assert_allclose(image, np.asarray(jres.image), rtol=RTOL,
                               atol=ATOL, err_msg="image")
    alpha_j = np.asarray(jres.aux.pixel_accumulated_alpha)
    np.testing.assert_allclose(tres.aux.pixel_accumulated_alpha.numpy(),
                               alpha_j, rtol=RTOL, atol=ATOL,
                               err_msg="accumulated alpha")
    assert (alpha_j > COVERED_ALPHA).mean() > 0.5
    if mode == "full":
        covered = alpha_j > COVERED_ALPHA
        np.testing.assert_allclose(tres.depth.numpy()[covered],
                                   np.asarray(jres.depth)[covered],
                                   rtol=RTOL, atol=ATOL, err_msg="depth")
        assert tres.pixel_valid_point_count.dtype == torch.int32
        assert_counts_close(np.asarray(jres.pixel_valid_point_count),
                            tres.pixel_valid_point_count.numpy(), "count")
        assert int(tres.pixel_valid_point_count.max()) > 0
    else:
        assert not tres.depth.any() and not tres.pixel_valid_point_count.any()

    aux_j, aux_t = jres.aux, tres.aux
    for field in ("in_frustum", "num_overlap_tiles", "total_keys",
                  "key_overflow", "big_point_overflow", "tile_cap_overflow",
                  "nonfinite_points"):
        np.testing.assert_array_equal(getattr(aux_t, field).numpy(),
                                      np.asarray(getattr(aux_j, field)),
                                      err_msg=field)
    for field in ("point_uv", "point_depth"):
        np.testing.assert_allclose(getattr(aux_t, field).numpy(),
                                   np.asarray(getattr(aux_j, field)),
                                   rtol=1e-5, atol=1e-6, err_msg=field)
    assert int(aux_t.key_overflow) == 0


def test_rasterize_gradients_flow():
    """The full render is differentiable: a loss on the image gives finite,
    non-zero gradients to positions and features; the rgb_only render is
    inference only and its image carries no gradient."""
    pc, feats = random_scene(8)
    scene = TScene.from_numpy(pc, feats, np.zeros(8), np.zeros(8), "cpu")
    q, t = (torch.as_tensor(x) for x in identity_pose())
    pc_g = scene.point_cloud.clone().requires_grad_(True)
    feats_g = scene.point_cloud_features.clone().requires_grad_(True)
    cam = TCamera(camera_intrinsics(), 32, 32)
    res = TR.rasterize(pc_g, feats_g, *scene[2:], q, t, cam,
                       TR.RasterizerConfig(rgb_only=False, near_plane=0.1))
    res.image.square().sum().backward()
    for grad in (pc_g.grad, feats_g.grad):
        assert grad is not None and bool(torch.isfinite(grad).all())
        assert grad.abs().max() > 0
    rgb = TR.rasterize(pc_g, feats_g, *scene[2:], q, t, cam,
                       TR.RasterizerConfig(rgb_only=True, near_plane=0.1))
    assert not rgb.image.requires_grad


def test_tile_layout_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    tiles = rng.normal(size=(6, 5, 256)).astype(np.float32)
    jgrid = JR.TileGrid(32, 48, 3, 2)
    tgrid = TR.TileGrid(32, 48, 3, 2)
    img = TR._tiles_to_image(torch.as_tensor(tiles), tgrid)
    np.testing.assert_array_equal(
        img.numpy(), np.asarray(JR._tiles_to_image(jnp.asarray(tiles), jgrid)))
    assert torch.equal(TR._image_to_tiles(img, tgrid), torch.as_tensor(tiles))
    assert TR.TileGrid.from_camera(TCamera(camera_intrinsics(), 32, 48)) \
        == tuple(JR.TileGrid.from_camera(JCamera(camera_intrinsics(), 32, 48)))


def test_render_cli_matches_jax_rasterize(tmp_path):
    """The port's render CLI on a parquet and a .npy trajectory writes the
    frames the JAX rasterize renders (to one 8-bit level)."""
    pc, feats = random_scene(60, seed=1, alpha=2.0)
    n = pc.shape[0]
    jscene = JScene(jnp.asarray(pc), jnp.asarray(feats),
                    jnp.zeros(n, jnp.int8), jnp.zeros(n, jnp.int32))
    jscene.to_parquet(str(tmp_path / "scene.parquet"))
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[1, 0, 3] = 0.1
    np.save(tmp_path / "traj.npy", poses)
    trender.main(["--parquet_path", str(tmp_path / "scene.parquet"),
                  "--trajectory_path", str(tmp_path / "traj.npy"),
                  "--output_prefix", str(tmp_path / "out" / "frame"),
                  "--width", "32", "--height", "32", "--fx", "25",
                  "--fy", "25", "--device", "cpu"])
    import PIL.Image
    from taichi_3d_gaussian_splatting_tpu.ops.transforms import (
        SE3_to_quaternion_and_translation)
    cam = JCamera(camera_intrinsics(), 32, 32)
    # the CLI's config (rgb_only, default planes) with JAX budgets that
    # drop nothing
    jcfg = JR.RasterizerConfig(rgb_only=True, max_keys=2048,
                               max_tiles_per_point=16, mid_point_divisor=1,
                               big_point_divisor=1)
    for i, pose in enumerate(poses):
        q, t = SE3_to_quaternion_and_translation(jnp.asarray(pose)[None])
        jres = JR.rasterize(*jscene, q, t, cam, jcfg)
        assert int(jres.aux.big_point_overflow) == 0
        assert int(jres.aux.key_overflow) == 0
        want = np.asarray(jnp.clip(jres.image, 0.0, 1.0))
        path = tmp_path / "out" / f"frame_{i:05d}.png"
        assert os.path.isfile(path)
        got = np.asarray(PIL.Image.open(path), np.int32)
        diff = np.abs(got - (want * 255).astype(np.int32))
        assert diff.max() <= 1, diff.max()
