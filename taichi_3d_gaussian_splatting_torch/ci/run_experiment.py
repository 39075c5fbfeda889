"""Experiment gate: train, summarise the run's metrics as markdown, and
hold the last validation PSNR and SSIM to targets.

    python -m taichi_3d_gaussian_splatting_torch.ci.run_experiment \\
        --train_config config/example.yaml --target_psnr 25.0 \\
        --target_ssim 0.86 --output summary.md [--device cuda]

The counterpart of the JAX package's ``ci/run_experiment.py``, with the same
flags, markdown, gate lines and exit codes. It trains by running this
package's train CLI (``python -m taichi_3d_gaussian_splatting_torch.train
--device DEVICE``, on the card by default) and reads
``<summary_writer_log_dir>/metrics.jsonl``, where the trainer writes
``val/psnr`` and ``val/ssim`` at each validation. On a failed training it
prints ``training failed`` and exits with the training's return code; on a
missed target it prints ``QUALITY GATE FAILED`` with each miss and exits 1;
otherwise it prints ``quality gate passed``. ``--skip_training`` only
summarises an existing metrics file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from ..training.trainer import TrainConfig


def read_metrics(metrics_path: str):
    """Last value per metric key + full val_psnr history."""
    final = {}
    history = []
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            it = rec.pop("iteration")
            for k, v in rec.items():
                final[k] = (it, v)
            if "val/psnr" in rec:
                history.append((it, rec["val/psnr"]))
    return final, history


def render_markdown(final: dict, history: list) -> str:
    lines = ["# Experiment results", "", "| metric | iteration | value |",
             "|---|---|---|"]
    for key in sorted(final):
        it, v = final[key]
        lines.append(f"| {key} | {it} | {v:.6g} |")
    if history:
        lines += ["", "## val/psnr progression", "",
                  "| iteration | psnr |", "|---|---|"]
        for it, v in history:
            lines.append(f"| {it} | {v:.4f} |")
    return "\n".join(lines) + "\n"


def train(train_config: str, device: str) -> int:
    """Run the train CLI on `train_config` and `device` in a process of its
    own (as the JAX gate runs its trainer); its return code."""
    return subprocess.run(
        [sys.executable, "-m", "taichi_3d_gaussian_splatting_torch.train",
         "--train_config", train_config, "--device", device]).returncode


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_config", type=str, required=True)
    parser.add_argument("--log_dir", type=str, default=None,
                        help="defaults to the config's summary dir")
    parser.add_argument("--target_psnr", type=float, default=None)
    parser.add_argument("--target_ssim", type=float, default=None)
    parser.add_argument("--output", type=str, default="experiment_summary.md")
    parser.add_argument("--skip_training", action="store_true",
                        help="only summarize an existing metrics.jsonl")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device the train CLI trains on")
    args = parser.parse_args(argv)

    config = TrainConfig.from_yaml_file(args.train_config)
    log_dir = args.log_dir or config.summary_writer_log_dir

    if not args.skip_training:
        returncode = train(args.train_config, args.device)
        if returncode != 0:
            print("training failed")
            sys.exit(returncode)

    metrics_path = os.path.join(log_dir, "metrics.jsonl")
    final, history = read_metrics(metrics_path)
    summary = render_markdown(final, history)
    with open(args.output, "w") as f:
        f.write(summary)
    print(summary)

    failed = []
    if args.target_psnr is not None:
        psnr = final.get("val/psnr", (None, float("-inf")))[1]
        if psnr < args.target_psnr:
            failed.append(f"val/psnr {psnr:.3f} < target {args.target_psnr}")
    if args.target_ssim is not None:
        ssim = final.get("val/ssim", (None, float("-inf")))[1]
        if ssim < args.target_ssim:
            failed.append(f"val/ssim {ssim:.4f} < target {args.target_ssim}")
    if failed:
        print("QUALITY GATE FAILED:\n  " + "\n  ".join(failed))
        sys.exit(1)
    print("quality gate passed")


if __name__ == "__main__":
    main()
