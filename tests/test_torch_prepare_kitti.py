"""The port's KITTI converter (taichi_3d_gaussian_splatting_torch/tools/
prepare_kitti.py) against the JAX package's tools/prepare_kitti.py on one
hand-written Agisoft capture (tests/torch_capture_fixtures.py: two
sensors, 13 cameras in shuffled order, one without a <transform>, a binary
little-endian PLY of 3,000 float vertices): both write byte-equal JSON
records and equal parquet frames (the sampling is seeded in both). Then the
port's dataset loads the converted views and trains 3 steps on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from taichi_3d_gaussian_splatting_torch import config as tconfig
from taichi_3d_gaussian_splatting_torch.data.dataset import ImagePoseDataset
from taichi_3d_gaussian_splatting_torch.tools import prepare_kitti
from taichi_3d_gaussian_splatting_torch.training import trainer as TT

from torch_capture_fixtures import (KITTI_CAMERAS, KITTI_SIZE,
                                    write_kitti_capture)
from torch_train_fixtures import config_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSONS = ("kitti_train.json", "kitti_val.json", "kitti_val_downsample.json")
PARQUET = "point_cloud_downsample.parquet"


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(capture root, the JAX tool's output dir, the port's output dir)."""
    root = tmp_path_factory.mktemp("kitti")
    xml, ply, images = write_kitti_capture(str(root))
    args = ["--camera_xml", xml, "--point_cloud_ply", ply,
            "--image_dir", images]
    jax_out, port_out = str(root / "jax"), str(root / "port")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "prepare_kitti.py"),
         *args, "--output_dir", jax_out], capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    prepare_kitti.main(args + ["--output_dir", port_out])
    return root, jax_out, port_out


@pytest.mark.parametrize("name", JSONS)
def test_records_match_the_jax_tool(converted, name):
    _, jax_out, port_out = converted
    with open(os.path.join(port_out, name), "rb") as f:
        got = f.read()
    with open(os.path.join(jax_out, name), "rb") as f:
        assert got == f.read()
    records = json.loads(got)
    # 12 views with a transform, every third for training, and a 10%
    # sample of the other 8
    assert len(records) == {"kitti_train.json": 4, "kitti_val.json": 8,
                            "kitti_val_downsample.json": 1}[name]
    for rec in records:
        assert rec["camera_height"] == rec["camera_width"] == KITTI_SIZE
        assert rec["camera_intrinsics"][0][0] in (28.0, 32.5)
        assert os.path.isfile(rec["image_path"])


def test_point_cloud_matches_the_jax_tool(converted):
    _, jax_out, port_out = converted
    got = pd.read_parquet(os.path.join(port_out, PARQUET))
    want = pd.read_parquet(os.path.join(jax_out, PARQUET))
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert list(got.columns) == ["x", "y", "z"]
    assert len(got) == 30 + 1000       # 1% of 3,000 vertices + the shell


def test_converted_views_train_on_cpu(converted):
    root, _, port_out = converted
    train = ImagePoseDataset(os.path.join(port_out, "kitti_train.json"))
    val = ImagePoseDataset(os.path.join(port_out, "kitti_val.json"))
    assert len(train) + len(val) == KITTI_CAMERAS - 1
    item = train[1]
    assert item.image.shape == (KITTI_SIZE, KITTI_SIZE, 3)
    np.testing.assert_allclose(item.t_pointcloud_camera[0, 0], -0.3,
                               atol=1e-6)   # camera 3, x = 0.1 * 3 - 0.6
    d = config_dict(
        str(root / "run"),
        train_dataset_json_path=os.path.join(port_out, "kitti_train.json"),
        val_dataset_json_path=os.path.join(port_out,
                                           "kitti_val_downsample.json"),
        pointcloud_parquet_path=os.path.join(port_out, PARQUET),
        num_iterations=3, val_interval=10 ** 6)
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, d), device="cpu")
    trainer.train()
    trainer.logger.close()
    with open(os.path.join(d["summary_writer_log_dir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all(), losses
