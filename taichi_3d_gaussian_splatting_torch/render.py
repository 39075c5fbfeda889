"""Offline renderer CLI.

Loads one or more scene parquets (merged, one object id per file), renders
every camera pose from either a dataset JSON or a saved tensor of 4x4
camera-to-world poses (.pt or .npy), and writes PNG frames:

    python -m taichi_3d_gaussian_splatting_torch.render --device cuda \
        --parquet_path scene.parquet --dataset_json_path val.json \
        --output_prefix out/frame
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from .camera import CameraInfo
from .models.scene import GaussianPointCloudScene
from .ops.rasterizer import RasterizerConfig, rasterize
from .ops.transforms import SE3_to_quaternion_and_translation


@dataclasses.dataclass
class RenderConfig:
    parquet_path_list: list
    trajectory_path: str = ""
    dataset_json_path: str = ""
    output_prefix: str = "render"
    image_width: int = 976
    image_height: int = 544
    fx: float = 581.743
    fy: float = 581.743


def load_poses(config: RenderConfig):
    """4x4 T_pointcloud_camera poses from a .pt/.npy tensor or a dataset
    JSON; returns (poses (V, 4, 4), per-view intrinsics (V, 3, 3) or None)."""
    if config.trajectory_path:
        if config.trajectory_path.endswith(".pt"):
            poses = torch.load(config.trajectory_path, map_location="cpu",
                               weights_only=False)
            poses = np.asarray(poses, np.float32)
        else:
            poses = np.load(config.trajectory_path).astype(np.float32)
        return poses.reshape(-1, 4, 4), None
    if not config.dataset_json_path:
        raise ValueError("need --trajectory_path or --dataset_json_path")
    import pandas as pd
    df = pd.read_json(config.dataset_json_path, orient="records")
    poses = np.stack([np.array(p, np.float32).reshape(4, 4)
                      for p in df["T_pointcloud_camera"]])
    intrinsics = np.stack([np.array(k, np.float32).reshape(3, 3)
                           for k in df["camera_intrinsics"]])
    return poses, intrinsics


def merge_scenes(parquet_paths, device) -> tuple:
    """Concatenate the valid points of each scene, with point_object_id =
    the index of its file; returns (scene, number of objects)."""
    pcs, feats, objs = [], [], []
    for i, path in enumerate(parquet_paths):
        scene = GaussianPointCloudScene.from_parquet(
            path, device="cpu").spatially_sorted()
        pc, f = scene._valid_arrays()
        pcs.append(pc)
        feats.append(f)
        objs.append(np.full((pc.shape[0],), i, np.int32))
    pc = np.concatenate(pcs)
    f = np.concatenate(feats)
    o = np.concatenate(objs)
    invalid = np.zeros((pc.shape[0],), np.int8)
    if pc.shape[0] == 0:
        # all-pruned scenes render black
        pc, f = np.zeros((1, 3)), np.zeros((1, 56))
        o, invalid = np.zeros((1,)), np.ones((1,))
    scene = GaussianPointCloudScene.from_numpy(pc, f, invalid, o, device)
    return scene, len(parquet_paths)


def render_poses(scene, num_objects, poses, per_view_intrinsics, camera,
                 config: RasterizerConfig):
    """Yield one clipped (H, W, 3) image per 4x4 camera-to-world pose."""
    device = scene.device
    for i, pose in enumerate(poses):
        q, t = SE3_to_quaternion_and_translation(
            torch.as_tensor(pose, dtype=torch.float32, device=device)[None])
        cam_i = camera
        if per_view_intrinsics is not None:
            cam_i = dataclasses.replace(
                camera, camera_intrinsics=per_view_intrinsics[i])
        with torch.no_grad():
            result = rasterize(*scene, q.expand(num_objects, 4),
                               t.expand(num_objects, 3), cam_i, config)
        yield torch.clamp(result.image, 0.0, 1.0)


def main(argv=None):
    import PIL.Image

    parser = argparse.ArgumentParser()
    parser.add_argument("--parquet_path", type=str, nargs="+", required=True)
    parser.add_argument("--trajectory_path", type=str, default="")
    parser.add_argument("--dataset_json_path", type=str, default="")
    parser.add_argument("--output_prefix", type=str, default="render")
    parser.add_argument("--width", type=int, default=976)
    parser.add_argument("--height", type=int, default=544)
    parser.add_argument("--fx", type=float, default=581.743)
    parser.add_argument("--fy", type=float, default=581.743)
    parser.add_argument("--portrait_mode", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    if args.portrait_mode:
        # swap to 544x976 with doubled focal length
        args.width, args.height = args.height, args.width
        args.fx *= 2.0
        args.fy *= 2.0
    config = RenderConfig(parquet_path_list=args.parquet_path,
                          trajectory_path=args.trajectory_path,
                          dataset_json_path=args.dataset_json_path,
                          output_prefix=args.output_prefix,
                          image_width=args.width, image_height=args.height,
                          fx=args.fx, fy=args.fy)
    poses, per_view_intrinsics = load_poses(config)
    scene, num_objects = merge_scenes(config.parquet_path_list,
                                      torch.device(args.device))

    w = config.image_width - config.image_width % 16
    h = config.image_height - config.image_height % 16
    base_intr = np.array([[config.fx, 0, w / 2], [0, config.fy, h / 2],
                          [0, 0, 1]], np.float32)
    camera = CameraInfo(camera_intrinsics=base_intr, camera_height=h,
                        camera_width=w)
    os.makedirs(os.path.dirname(config.output_prefix) or ".", exist_ok=True)
    images = render_poses(scene, num_objects, poses, per_view_intrinsics,
                          camera, RasterizerConfig(rgb_only=True))
    for i, img in enumerate(images):
        out_path = f"{config.output_prefix}_{i:05d}.png"
        PIL.Image.fromarray(
            (img.cpu().numpy() * 255).astype(np.uint8)).save(out_path)
        print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
