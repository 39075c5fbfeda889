"""Small captures for the data-preparation chains, written with numpy and
the port alone (no JAX), so that the CPU tests and chip_smoke.py phase 9
share them:

- `write_colmap_capture`: a COLMAP *binary* model (cameras.bin, images.bin,
  points3D.bin in COLMAP's reconstruction.cc layout, 2D-point tracks
  included) over a PINHOLE and a SIMPLE_RADIAL camera, 10 orbit views of a
  40-point scene rendered by the port's `rasterize`, and a noisy sparse
  cloud; the capture of tests/test_colmap_e2e.py.
- `write_kitti_capture`: an Agisoft camera.xml (two sensors, 13 cameras in
  shuffled order, one without a <transform>), a binary little-endian PLY
  of float vertices and one seeded 32x32 PNG per camera.

`colmap_train_config` is the train config the chain trains the capture
with.
"""

import os
import struct

import numpy as np
import torch

from taichi_3d_gaussian_splatting_torch.camera import CameraInfo
from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
    RasterizerConfig, rasterize)
from taichi_3d_gaussian_splatting_torch.ops.transforms import (
    SE3_to_quaternion_and_translation)

from torch_train_fixtures import config_dict

# the COLMAP capture
COLMAP_W, COLMAP_H = 64, 48
COLMAP_VIEWS = 10
COLMAP_POINTS = 40
COLMAP_INTRINSICS = {
    1: np.array([[50.0, 0, COLMAP_W / 2], [0, 52.0, COLMAP_H / 2], [0, 0, 1]],
                np.float32),
    # SIMPLE_RADIAL: one focal; the converter ignores the distortion
    2: np.array([[55.0, 0, COLMAP_W / 2], [0, 55.0, COLMAP_H / 2], [0, 0, 1]],
                np.float32),
}
COLMAP_RASTER = dict(near_plane=0.1, far_plane=100.0, max_tiles_per_point=16)

# the KITTI capture
KITTI_SIZE = 32
KITTI_CAMERAS = 13
KITTI_NO_TRANSFORM = 7      # the camera written without a <transform>
KITTI_VERTICES = 3000


def rotation_to_colmap_qvec(R):
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion."""
    from scipy.spatial.transform import Rotation
    x, y, z, w = Rotation.from_matrix(R).as_quat()
    return np.array([w, x, y, z])


def orbit_T_pointcloud_camera(angle, radius=2.2, elev=0.25):
    """Camera-to-world pose on an orbit around the origin, looking at it."""
    eye = np.array([radius * np.cos(elev) * np.sin(angle),
                    radius * np.sin(elev),
                    -radius * np.cos(elev) * np.cos(angle)])
    forward = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, forward, eye
    return T


def write_colmap_binary_model(base, images_meta, points_xyz, points_rgb):
    """COLMAP reconstruction.cc binary layout. images_meta: list of
    (image_id, name, qvec wxyz, tvec, camera_id)."""
    os.makedirs(base, exist_ok=True)
    w, h = COLMAP_W, COLMAP_H
    # cameras.bin: PINHOLE (fx fy cx cy) + SIMPLE_RADIAL (f cx cy k)
    with open(os.path.join(base, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))
        f.write(struct.pack("<dddd", 50.0, 52.0, w / 2, h / 2))
        f.write(struct.pack("<iiQQ", 2, 2, w, h))
        f.write(struct.pack("<dddd", 55.0, w / 2, h / 2, 1e-4))
    with open(os.path.join(base, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images_meta)))
        for image_id, name, qvec, tvec, camera_id in images_meta:
            f.write(struct.pack("<idddddddi", image_id, *qvec, *tvec,
                                camera_id))
            f.write(name.encode() + b"\x00")
            # two 2D observations (x, y, point3D_id) the reader must skip
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddQ", 1.0, 2.0, 1))
            f.write(struct.pack("<ddQ", 3.0, 4.0, 2 ** 64 - 1))
    with open(os.path.join(base, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points_xyz)))
        for i, (xyz, rgb) in enumerate(zip(points_xyz, points_rgb)):
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz, *rgb, 0.5))
            f.write(struct.pack("<Q", 1))           # track of length 1
            f.write(struct.pack("<ii", 1, 0))       # (image_id, point2D_idx)


def colmap_scene(seed=3):
    """(positions (40, 3), features (40, 56), rng) of the COLMAP capture."""
    rng = np.random.default_rng(seed)
    n = COLMAP_POINTS
    pc = np.concatenate([rng.uniform(-0.6, 0.6, (n, 2)),
                         rng.uniform(-0.4, 0.4, (n, 1))],
                        axis=1).astype(np.float32)
    feats = np.zeros((n, 56), np.float32)
    q = rng.normal(size=(n, 4))
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-2.3, -1.6, (n, 3))
    feats[:, 7] = 2.5
    feats[:, 8] = rng.normal(size=n) + 1.0
    feats[:, 24] = rng.normal(size=n) + 0.5
    feats[:, 40] = rng.normal(size=n)
    return pc, feats, rng


def write_colmap_capture(root, device="cpu"):
    """The COLMAP capture under `root`: images/img_<i>.png rendered by the
    port on `device` (camera 1 + i % 2) and the binary model in sparse/.
    Returns (image dir, model dir)."""
    import PIL.Image
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    pc, feats, rng = colmap_scene()
    n = pc.shape[0]
    scene = GaussianPointCloudScene.from_numpy(pc, feats, np.zeros(n),
                                               np.zeros(n), device)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images_meta = []
    for vi in range(COLMAP_VIEWS):
        cam_id = 1 + vi % 2
        T_pc_cam = orbit_T_pointcloud_camera(2 * np.pi * vi / COLMAP_VIEWS)
        q, t = SE3_to_quaternion_and_translation(torch.as_tensor(
            T_pc_cam, dtype=torch.float32, device=device)[None])
        cam = CameraInfo(camera_intrinsics=COLMAP_INTRINSICS[cam_id],
                         camera_height=COLMAP_H, camera_width=COLMAP_W)
        with torch.no_grad():
            img = rasterize(*scene, q, t, cam,
                            RasterizerConfig(**COLMAP_RASTER)).image
        name = f"img_{vi}.png"
        PIL.Image.fromarray((img.clamp(0, 1).cpu().numpy() * 255).astype(
            np.uint8)).save(os.path.join(img_dir, name))
        # COLMAP stores world->camera [R|t]
        T_cam_pc = np.linalg.inv(T_pc_cam)
        images_meta.append((vi + 1, name,
                            rotation_to_colmap_qvec(T_cam_pc[:3, :3]),
                            T_cam_pc[:3, 3], cam_id))
    noisy = pc + rng.normal(scale=0.05, size=pc.shape)
    rgbs = rng.integers(0, 256, size=(n, 3))
    sparse = os.path.join(root, "sparse")
    write_colmap_binary_model(sparse, images_meta, noisy, rgbs)
    return img_dir, sparse


def colmap_train_config(root, dataset, iterations):
    """The config dict (YAML-ready) that trains the converted COLMAP
    capture under `dataset` for `iterations`, logging to root/logs: the
    rates and controller of tests/test_colmap_e2e.py (densify every quarter
    of the run after as long a warm-up), validations at half the run and at
    its end."""
    return config_dict(
        root, train_dataset_json_path=os.path.join(dataset, "train.json"),
        val_dataset_json_path=os.path.join(dataset, "val.json"),
        pointcloud_parquet_path=os.path.join(dataset, "point_cloud.parquet"),
        num_iterations=iterations, val_interval=iterations // 2,
        feature_learning_rate=5e-3, position_learning_rate=1e-4,
        position_learning_rate_decay_rate=0.97,
        save_full_checkpoint=False, log_validation_image=False,
        rasterisation_config=COLMAP_RASTER,
        adaptive_controller_config=dict(
            num_iterations_warm_up=iterations // 4,
            num_iterations_densify=iterations // 4,
            num_iterations_reset_alpha=10 ** 6,
            transparent_alpha_threshold=-3.0),
        gaussian_point_cloud_scene_config=dict(max_num_points_ratio=2.0,
                                               initial_alpha=1.0),
        loss_function_config=dict(enable_regularization=False))


def _sensor_xml(sensor_id, f):
    s = KITTI_SIZE
    return (f'      <sensor id="{sensor_id}" label="cam{sensor_id}" '
            f'type="frame">\n'
            f'        <resolution width="{s}" height="{s}"/>\n'
            f'        <calibration type="frame" class="adjusted">\n'
            f'          <resolution width="{s}" height="{s}"/>\n'
            f'          <f>{f}</f>\n'
            f'        </calibration>\n'
            f'      </sensor>\n')


def write_kitti_capture(root, seed=0):
    """The KITTI capture under `root`: camera.xml, cloud.ply and
    images/<label>.png. Cameras look down +z from x = -0.6 .. 0.6 at a
    cloud in [-1, 1]^2 x [2, 5]. Returns (xml, ply, image dir)."""
    import PIL.Image
    rng = np.random.default_rng(seed)
    cameras = []
    for i in rng.permutation(KITTI_CAMERAS):
        label = f"{i:06d}"
        if i == KITTI_NO_TRANSFORM:
            cameras.append(f'      <camera id="{i}" label="{label}" '
                           f'sensor_id="{i % 2}" enabled="true"/>\n')
            continue
        T = np.eye(4)
        T[0, 3] = 0.1 * i - 0.6
        T[1, 3] = 0.05 * rng.normal()
        T[2, 3] = -0.02 * i
        cameras.append(f'      <camera id="{i}" label="{label}" '
                       f'sensor_id="{i % 2}" enabled="true">\n'
                       f'        <transform>'
                       + " ".join(repr(float(x)) for x in T.ravel())
                       + '</transform>\n      </camera>\n')
    xml = os.path.join(root, "camera.xml")
    with open(xml, "w") as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>\n'
                '<document version="1.4.0">\n  <chunk label="Chunk 1">\n'
                '    <sensors>\n' + _sensor_xml(0, 28.0)
                + _sensor_xml(1, 32.5) + '    </sensors>\n'
                '    <cameras>\n' + "".join(cameras) + '    </cameras>\n'
                '  </chunk>\n</document>\n')

    n = KITTI_VERTICES
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 5, n)], axis=1)
    normals = rng.normal(size=(n, 3))
    vertices = np.concatenate([xyz, normals], axis=1).astype("<f4")
    ply = os.path.join(root, "cloud.ply")
    with open(ply, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {n}\n"
                 + "".join(f"property float {p}\n"
                           for p in ("x", "y", "z", "nx", "ny", "nz"))
                 + "end_header\n").encode("ascii"))
        f.write(vertices.tobytes())

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    s = KITTI_SIZE
    yy, xx = np.mgrid[0:s, 0:s] / s
    for i in range(KITTI_CAMERAS):
        phase = rng.uniform(0, 2 * np.pi, 3)
        img = 0.5 + 0.4 * np.sin(2 * np.pi * (xx[..., None] + yy[..., None])
                                 + phase)
        PIL.Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(img_dir, f"{i:06d}.png"))
    return xml, ply, img_dir
