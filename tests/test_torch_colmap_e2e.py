"""The COLMAP chain through the port, on the CPU: a COLMAP binary model
(tests/torch_capture_fixtures.py, the capture of tests/test_colmap_e2e.py:
PINHOLE and SIMPLE_RADIAL cameras, 10 orbit views of a 40-point scene
rendered by the port's `rasterize`, 2D-point tracks the reader must skip)
-> tools/prepare_colmap.py -> the port's train CLI (`--device cpu`) -> the
port's render CLI on the held-out poses.

Tolerances: the converter's focal lengths exactly (to 3 decimals, as the
JAX test); the loss falls (the mean of the last 5 steps below the mean of
the first 5) and the last validation PSNR lies above the first; the render
CLI's frames are not blank (standard deviation above 1 grey level) and
their PSNR against the held-out images lies within 0.5 dB of the trainer's
best validation PSNR (the CLI renders best_scene.parquet through the
packed8 slab, bf16 colours, and truncates to 8 bits).
"""

import json
import os
import subprocess
import sys

import numpy as np
import PIL.Image
import yaml

from taichi_3d_gaussian_splatting_torch import render as render_cli
from taichi_3d_gaussian_splatting_torch import train as train_cli

from torch_capture_fixtures import (COLMAP_H, COLMAP_W, colmap_train_config,
                                    write_colmap_capture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERATIONS = 60


def prepare_colmap(sparse, images, out_dir):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "prepare_colmap.py"),
         "--base_path", sparse, "--image_path", images,
         "--output_dir", out_dir, "--val_every", "5"],
        capture_output=True, text=True)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


def test_colmap_binary_to_render_through_the_port(tmp_path):
    images, sparse = write_colmap_capture(str(tmp_path))
    dataset = str(tmp_path / "dataset")
    r = prepare_colmap(sparse, images, dataset)
    assert r.returncode == 0, r.stderr
    train_recs = json.load(open(os.path.join(dataset, "train.json")))
    val_recs = json.load(open(os.path.join(dataset, "val.json")))
    assert len(train_recs) == 8 and len(val_recs) == 2
    fxfy = {(round(rec["camera_intrinsics"][0][0], 3),
             round(rec["camera_intrinsics"][1][1], 3))
            for rec in train_recs + val_recs}
    assert fxfy == {(50.0, 52.0), (55.0, 55.0)}, fxfy

    config = str(tmp_path / "train.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(colmap_train_config(str(tmp_path), dataset,
                                           ITERATIONS), f)
    train_cli.main(["--train_config", config, "--device", "cpu"])
    logs = tmp_path / "logs"
    records = [json.loads(line) for line in open(logs / "metrics.jsonl")]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == ITERATIONS and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    val_psnr = [r["val/psnr"] for r in records if "val/psnr" in r]
    assert len(val_psnr) >= 2 and val_psnr[-1] > val_psnr[0], val_psnr

    prefix = str(tmp_path / "frames" / "frame")
    render_cli.main(["--parquet_path", str(logs / "best_scene.parquet"),
                     "--dataset_json_path",
                     os.path.join(dataset, "val.json"),
                     "--output_prefix", prefix, "--width", str(COLMAP_W),
                     "--height", str(COLMAP_H), "--fx", "50.0", "--fy",
                     "52.0", "--device", "cpu"])
    frames = sorted((tmp_path / "frames").glob("frame_*.png"))
    assert len(frames) == 2, frames
    scores = []
    for frame, rec in zip(frames, val_recs):
        got = np.asarray(PIL.Image.open(frame))
        want = np.asarray(PIL.Image.open(rec["image_path"]))[:, :, :3]
        assert got.shape == want.shape == (COLMAP_H, COLMAP_W, 3)
        assert got.std() > 1.0, f"{frame} is blank"
        scores.append(psnr(got, want))
    assert abs(np.mean(scores) - max(val_psnr)) < 0.5, (scores, val_psnr)
