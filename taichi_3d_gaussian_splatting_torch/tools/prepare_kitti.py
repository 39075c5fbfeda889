"""Agisoft-XML (KITTI-style) dataset converter.

    python -m taichi_3d_gaussian_splatting_torch.tools.prepare_kitti \\
        --camera_xml camera.xml --point_cloud_ply cloud.ply \\
        --image_dir images --output_dir out

Camera extrinsics and single-focal intrinsics from an Agisoft camera.xml
(cameras without a <transform> are left out), the point cloud from a PLY
with float vertex properties (``models/scene.py::_read_ply_vertices``), a
1% sample of it plus a 1000-point gaussian shell around its bounding box,
and every third view for training. The counterpart of the JAX package's
``tools/prepare_kitti.py``: the same flags and the same seeded sampling
(``random_state=1``, ``default_rng(1)``), so it writes the same
``kitti_train.json``, ``kitti_val.json``, ``kitti_val_downsample.json`` and
``point_cloud_downsample.parquet``. It runs on the host alone: nothing
here touches a device.
"""

from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET

import numpy as np

from ..models.scene import _read_ply_vertices


def extrinsics_from_xml(xml_file: str, image_dir: str):
    root = ET.parse(xml_file).getroot()
    views = []
    for e in root.findall("chunk/cameras")[0].findall("camera"):
        label = e.get("label")
        sensor_id = e.get("sensor_id")
        transform = e.find("transform")
        if transform is None:
            continue
        values = [float(x) for x in transform.text.replace("\n", "").split()
                  if x]
        T_pointcloud_camera = np.array(values, np.float32).reshape(4, 4)
        views.append({
            "label": label,
            "sensor_id": sensor_id,
            "T_pointcloud_camera": T_pointcloud_camera,
            "image_path": os.path.abspath(
                os.path.join(image_dir, f"{label}.png")),
        })
    views.sort(key=lambda v: v["label"])
    return views


def intrinsics_from_xml(xml_file: str):
    root = ET.parse(xml_file).getroot()
    out = {}
    for sensor in root.findall("chunk/sensors/sensor"):
        sensor_id = sensor.get("id")
        calibration = sensor.find("calibration")
        resolution = calibration.find("resolution")
        width = float(resolution.get("width"))
        height = float(resolution.get("height"))
        f = float(calibration.find("f").text)
        K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                     np.float32)
        out[sensor_id] = (K, int(height), int(width))
    return out


def main(argv=None):
    import pandas as pd

    parser = argparse.ArgumentParser()
    parser.add_argument("--camera_xml", type=str, required=True)
    parser.add_argument("--point_cloud_ply", type=str, required=True)
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--downsample_frac", type=float, default=0.01)
    parser.add_argument("--num_shell_points", type=int, default=1000)
    args = parser.parse_args(argv)

    views = extrinsics_from_xml(args.camera_xml, args.image_dir)
    intr = intrinsics_from_xml(args.camera_xml)

    names, data = _read_ply_vertices(args.point_cloud_ply)
    col = {n: i for i, n in enumerate(names)}
    pc = data[:, [col["x"], col["y"], col["z"]]]
    df = pd.DataFrame(pc, columns=["x", "y", "z"])
    lo, hi = df.min(), df.max()
    center = (lo + hi) / 2
    radius = float((hi - lo).max() / 2)
    df = df.sample(frac=args.downsample_frac, replace=False, random_state=1)
    rng = np.random.default_rng(1)
    shell = center.to_numpy() + radius * rng.standard_normal(
        (args.num_shell_points, 3))
    df = pd.concat([df, pd.DataFrame(shell, columns=["x", "y", "z"])])
    os.makedirs(args.output_dir, exist_ok=True)
    df.to_parquet(os.path.join(args.output_dir,
                               "point_cloud_downsample.parquet"))

    records = []
    for v in views:
        K, h, w = intr[v["sensor_id"]]
        records.append({
            "image_path": v["image_path"],
            "T_pointcloud_camera": v["T_pointcloud_camera"].tolist(),
            "camera_intrinsics": K.tolist(),
            "camera_height": h,
            "camera_width": w,
            "camera_id": int(v["sensor_id"]),
        })
    full = pd.DataFrame(records)
    is_train = full.index % 3 == 0
    full[is_train].to_json(os.path.join(args.output_dir, "kitti_train.json"),
                           orient="records")
    full[~is_train].to_json(os.path.join(args.output_dir, "kitti_val.json"),
                            orient="records")
    full[~is_train].sample(frac=0.1, replace=False, random_state=1).to_json(
        os.path.join(args.output_dir, "kitti_val_downsample.json"),
        orient="records")
    print(f"wrote {is_train.sum()} train / {(~is_train).sum()} val views, "
          f"{len(df)} points")


if __name__ == "__main__":
    main()
