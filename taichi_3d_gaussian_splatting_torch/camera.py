"""Camera metadata: intrinsics, image size and the 16x16 tile grid, and a
registry of cameras and posed views.

Copied from ``taichi_3d_gaussian_splatting_tpu/camera.py`` (that package's
``__init__`` imports jax, so it cannot be imported from here). The
intrinsics stay a numpy (3, 3) array; the rasterizer moves them to the
device of the point cloud.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

TILE_WIDTH = 16
TILE_HEIGHT = 16
# Points up to 3 tiles (48 px) outside the image still rasterize into boundary
# tiles.
BOUNDARY_TILES = 3


@dataclasses.dataclass
class CameraInfo:
    camera_intrinsics: Any  # (3, 3) array-like
    camera_height: int
    camera_width: int
    camera_id: int = 0

    def __post_init__(self):
        self.camera_height = int(self.camera_height)
        self.camera_width = int(self.camera_width)

    @property
    def tiles_per_row(self) -> int:
        return self.camera_width // TILE_WIDTH

    @property
    def tiles_per_col(self) -> int:
        return self.camera_height // TILE_HEIGHT

    @property
    def num_tiles(self) -> int:
        return self.tiles_per_row * self.tiles_per_col

    def validate(self):
        if self.camera_width % TILE_WIDTH:
            raise ValueError(f"camera_width must be a multiple of {TILE_WIDTH}")
        if self.camera_height % TILE_HEIGHT:
            raise ValueError(
                f"camera_height must be a multiple of {TILE_HEIGHT}")
        # a sub-tile camera yields an empty tile grid, which would surface
        # deep inside the blend as an opaque shape error
        if self.num_tiles < 1:
            raise ValueError(
                f"camera {self.camera_width}x{self.camera_height} is smaller "
                f"than one {TILE_WIDTH}x{TILE_HEIGHT} tile")

    def rescaled(self, scale_x: float, scale_y: float) -> np.ndarray:
        intr = np.array(self.camera_intrinsics, dtype=np.float32).copy()
        intr[0, :] *= scale_x
        intr[1, :] *= scale_y
        return intr

    def downsample(self, factor: int) -> "CameraInfo":
        """Downsampled camera with intrinsics rescaled and size cropped to a
        tile multiple."""
        camera_height = self.camera_height // factor
        camera_width = self.camera_width // factor
        camera_height -= camera_height % TILE_HEIGHT
        camera_width -= camera_width % TILE_WIDTH
        intr = np.array(self.camera_intrinsics, dtype=np.float32).copy()
        intr[0, 0] /= factor
        intr[1, 1] /= factor
        intr[0, 2] /= factor
        intr[1, 2] /= factor
        return CameraInfo(
            camera_intrinsics=intr,
            camera_height=camera_height,
            camera_width=camera_width,
            camera_id=self.camera_id,
        )


@dataclasses.dataclass
class CameraView:
    """A posed view: the camera-to-world transform of one image."""
    camera_view_id: int
    T_pointcloud_camera: Any  # (4, 4) camera-to-world
    camera_id: int
    image_id: int
    timestamp: int | None = None  # microseconds


class CameraDatabase:
    """Registry of cameras and views."""

    def __init__(self):
        self.camera_info_dict = {}
        self.camera_view_dict = {}

    def add_camera_info(self, camera_info: CameraInfo):
        self.camera_info_dict[camera_info.camera_id] = camera_info

    def get_camera_info(self, camera_id: int) -> CameraInfo:
        return self.camera_info_dict[camera_id]

    def add_camera_view(self, camera_view: CameraView):
        self.camera_view_dict[camera_view.camera_view_id] = camera_view

    def get_camera_view_and_info(self, camera_view_id: int):
        view = self.camera_view_dict[camera_view_id]
        return view, self.camera_info_dict[view.camera_id]
