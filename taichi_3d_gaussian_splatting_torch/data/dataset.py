"""Image + pose dataset and a host-side prefetching loader.

A dataset is a JSON list of records with the columns `image_path,
T_pointcloud_camera, camera_intrinsics, camera_height, camera_width,
camera_id`. Per item it loads the image, rescales the intrinsics to the
image's real size, crops height and width down to tile multiples, turns
the 4x4 pose into (q, t), and scales down anything over 1600 px. The same
files load in the JAX package. Items are numpy; the trainer moves them to
its device. pandas and PIL are imported only where a file is read.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..camera import CameraInfo, TILE_WIDTH, TILE_HEIGHT
from ..ops.transforms import SE3_to_quaternion_and_translation

MAX_RESOLUTION_TRAIN = 1600
_AUTOSCALE_SHORT_SIDE = 1024


class DatasetItem(NamedTuple):
    image: np.ndarray                # (H, W, 3) float32 in [0, 1]
    q_pointcloud_camera: np.ndarray  # (1, 4)
    t_pointcloud_camera: np.ndarray  # (1, 3)
    camera_info: CameraInfo


def _se3_to_qt(T_pointcloud_camera: np.ndarray):
    q, t = SE3_to_quaternion_and_translation(
        torch.as_tensor(T_pointcloud_camera, dtype=torch.float32)[None])
    return q.numpy(), t.numpy()


def autoscale_image_and_camera_info(image: np.ndarray,
                                    camera_info: CameraInfo):
    """Scale an image over 1600 px down to short side 1024 (long side at
    most 1600), rescale the intrinsics and crop to tile multiples."""
    import PIL.Image
    h, w = camera_info.camera_height, camera_info.camera_width
    if h <= MAX_RESOLUTION_TRAIN and w <= MAX_RESOLUTION_TRAIN:
        return image, camera_info
    short, long = min(h, w), max(h, w)
    scale = _AUTOSCALE_SHORT_SIDE / short
    if long * scale > MAX_RESOLUTION_TRAIN:
        scale = MAX_RESOLUTION_TRAIN / long
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    pil = PIL.Image.fromarray((image * 255.0).astype(np.uint8))
    image = np.asarray(pil.resize((new_w, new_h), PIL.Image.BILINEAR),
                       np.float32) / 255.0
    crop_h = new_h - new_h % TILE_HEIGHT
    crop_w = new_w - new_w % TILE_WIDTH
    image = np.ascontiguousarray(image[:crop_h, :crop_w, :3])
    intr = np.array(camera_info.camera_intrinsics, np.float32).copy()
    intr[0, :] *= new_w / w
    intr[1, :] *= new_h / h
    return image, CameraInfo(camera_intrinsics=intr, camera_height=crop_h,
                             camera_width=crop_w,
                             camera_id=camera_info.camera_id)


class ImagePoseDataset:
    def __init__(self, dataset_json_path: str):
        import pandas as pd
        required = ["image_path", "T_pointcloud_camera", "camera_intrinsics",
                    "camera_height", "camera_width", "camera_id"]
        self.df = pd.read_json(dataset_json_path, orient="records")
        for column in required:
            if column not in self.df.columns:
                raise ValueError(f"column {column} is not in the dataset "
                                 f"{dataset_json_path}")

    def __len__(self):
        return len(self.df)

    def __getitem__(self, idx) -> DatasetItem:
        import PIL.Image
        row = self.df.iloc[idx]
        T_pc_cam = np.array(row["T_pointcloud_camera"],
                            np.float32).reshape(4, 4)
        q, t = _se3_to_qt(T_pc_cam)
        intr = np.array(row["camera_intrinsics"], np.float32).reshape(3, 3)
        base_h = float(row["camera_height"])
        base_w = float(row["camera_width"])
        with PIL.Image.open(row["image_path"]) as image:
            arr = np.asarray(image, np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        h, w = arr.shape[0], arr.shape[1]
        # intrinsics for the real image size, then a tile-multiple crop
        intr = intr.copy()
        intr[0, :] *= w / base_w
        intr[1, :] *= h / base_h
        crop_h = h - h % TILE_HEIGHT
        crop_w = w - w % TILE_WIDTH
        arr = np.ascontiguousarray(arr[:crop_h, :crop_w, :3])
        camera_info = CameraInfo(camera_intrinsics=intr,
                                 camera_height=crop_h, camera_width=crop_w,
                                 camera_id=int(row["camera_id"]))
        arr, camera_info = autoscale_image_and_camera_info(arr, camera_info)
        return DatasetItem(arr, q, t, camera_info)


class PrefetchLoader:
    """Thread-pool prefetcher: keeps `prefetch` decoded items in flight
    (PIL releases the interpreter lock while it decodes)."""

    def __init__(self, dataset: ImagePoseDataset, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 8,
                 seed: int = 0, loop: bool = True):
        self.dataset = dataset
        self.shuffle = shuffle
        self.loop = loop
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.pool = concurrent.futures.ThreadPoolExecutor(num_workers)
        self._lock = threading.Lock()
        self._order = []
        self._pos = 0

    def _next_index(self) -> Optional[int]:
        with self._lock:
            if self._pos >= len(self._order):
                if self._order and not self.loop:
                    return None
                order = np.arange(len(self.dataset))
                if self.shuffle:
                    self.rng.shuffle(order)
                self._order = order.tolist()
                self._pos = 0
            idx = self._order[self._pos]
            self._pos += 1
            return idx

    def __iter__(self):
        queue = []
        for _ in range(self.prefetch):
            idx = self._next_index()
            if idx is None:
                break
            queue.append(self.pool.submit(self.dataset.__getitem__, idx))
        while queue:
            item = queue.pop(0).result()
            idx = self._next_index()
            if idx is not None:
                queue.append(self.pool.submit(self.dataset.__getitem__, idx))
            yield item

    def close(self):
        self.pool.shutdown(wait=False, cancel_futures=True)
