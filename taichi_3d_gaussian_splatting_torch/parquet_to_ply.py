"""Convert a scene parquet to the official implementation's PLY layout:

    python -m taichi_3d_gaussian_splatting_torch.parquet_to_ply \\
        --parquet_path scene.parquet --ply_path scene.ply [--device cpu]
"""

from __future__ import annotations

import argparse

from .models.scene import GaussianPointCloudScene


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--parquet_path", type=str, required=True)
    parser.add_argument("--ply_path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    GaussianPointCloudScene.from_parquet(
        args.parquet_path, device=args.device).to_ply(args.ply_path)


if __name__ == "__main__":
    main()
