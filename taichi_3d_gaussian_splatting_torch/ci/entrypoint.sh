#!/bin/bash
# Container entrypoint for the CI experiment gate on a CUDA card: the
# counterpart of ci/entrypoint.sh, with the same variables and defaults.
# It runs this package's gate, which trains through this package's train
# CLI on the card (--device cuda; there is no CPU fallback).
#
#   TRAIN_CONFIG=<yaml> [TARGET_PSNR=24.0] [TARGET_SSIM=0.8] \
#       [OUTPUT_SUMMARY=/data/summary.md] \
#       bash taichi_3d_gaussian_splatting_torch/ci/entrypoint.sh
#
# Outside the container, put the repository on PYTHONPATH.
set -euo pipefail

if [ -z "${TRAIN_CONFIG:-}" ]; then
    echo "TRAIN_CONFIG is not set" >&2
    exit 1
fi

# dataset volume convention: the config's dataset paths are relative to
# /data (mounted by the workflow); link it into the working directory
if [ -d /data ] && [ ! -e data ]; then
    ln -s /data data
fi

exec python -m taichi_3d_gaussian_splatting_torch.ci.run_experiment \
    --train_config "${TRAIN_CONFIG}" \
    --target_psnr "${TARGET_PSNR:-24.0}" \
    --target_ssim "${TARGET_SSIM:-0.8}" \
    --output "${OUTPUT_SUMMARY:-/data/summary.md}" \
    --device cuda
