"""Train CLI:

    python -m taichi_3d_gaussian_splatting_torch.train \\
        --train_config config/tat_truck.yaml --device cuda

reads the same YAML files as the JAX package's gaussian_point_train.py.
`--gen_template_only` writes the default config to --train_config (or
config_template.yaml) and exits.

With `batch_size: B` in the config, each step takes B views. Started by
`torchrun --nproc_per_node=N` (WORLD_SIZE > 1 in the environment), each
process joins the process group from the environment (NCCL, one card per
LOCAL_RANK, on `cuda`; gloo on `cpu`) and renders B / N of the views.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from .training.trainer import GaussianPointCloudTrainer, TrainConfig


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_config", type=str, required=False)
    parser.add_argument("--gen_template_only", action="store_true",
                        help="write the default config and exit")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.gen_template_only:
        TrainConfig().to_yaml_file(args.train_config or "config_template.yaml")
        return
    if not args.train_config:
        parser.error("--train_config is required")
    config = TrainConfig.from_yaml_file(args.train_config)
    device = args.device
    distributed = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if distributed:
        if device == "cuda":
            local_rank = int(os.environ["LOCAL_RANK"])
            torch.cuda.set_device(local_rank)
            device = f"cuda:{local_rank}"
        dist.init_process_group("nccl" if device.startswith("cuda")
                                else "gloo")
    try:
        GaussianPointCloudTrainer(config, device=device).train()
    finally:
        if distributed:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
