"""Train CLI:

    python -m taichi_3d_gaussian_splatting_torch.train \
        --train_config config/tat_truck.yaml --device cuda

reads the same YAML files as the JAX package's gaussian_point_train.py.
`--gen_template_only` writes the default config to --train_config (or
config_template.yaml) and exits.
"""

from __future__ import annotations

import argparse

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
    GaussianPointCloudTrainer(config, device=args.device).train()


if __name__ == "__main__":
    main()
