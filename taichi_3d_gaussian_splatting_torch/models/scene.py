"""Scene state: a fixed-capacity pool of 3D Gaussians as torch tensors.

The four arrays (positions, features, invalid mask, object id) share one
capacity N and live on one explicit device. Invalid slots stay in the pool,
masked, as in the JAX package, so scenes move between the two packages
array for array (`from_numpy`).

File formats, interchangeable with the JAX package's:
- parquet: the 59-column schema x,y,z,cov_q{0-3},cov_s{0-2},alpha0,
  r_sh{0-15},g_sh{0-15},b_sh{0-15} (pandas, imported only here);
- PLY: the official-implementation layout (f_dc/f_rest/opacity/scale/rot
  wxyz), binary little endian, read and written with numpy alone.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.gaussian import NUM_FEATURES

FEATURE_COLUMNS = ([f"cov_q{i}" for i in range(4)]
                   + [f"cov_s{i}" for i in range(3)]
                   + ["alpha0"]
                   + [f"r_sh{i}" for i in range(16)]
                   + [f"g_sh{i}" for i in range(16)]
                   + [f"b_sh{i}" for i in range(16)])

SH_C0 = 0.28209479177387814


@dataclasses.dataclass
class SceneConfig:
    num_of_features: int = 56
    max_num_points_ratio: Optional[float] = None
    add_sphere: bool = False
    sphere_radius_factor: float = 4.0
    num_points_sphere: int = 10000
    max_initial_covariance: Optional[float] = None
    initial_alpha: float = -2.0
    initial_covariance_ratio: float = 1.0


class GaussianPointCloudScene(NamedTuple):
    """All tensors share the capacity N and one device."""
    point_cloud: torch.Tensor           # (N, 3) float32
    point_cloud_features: torch.Tensor  # (N, 56) float32
    point_invalid_mask: torch.Tensor    # (N,) int8; 1 = invalid
    point_object_id: torch.Tensor       # (N,) int32

    @property
    def capacity(self) -> int:
        return self.point_cloud.shape[0]

    @property
    def device(self) -> torch.device:
        return self.point_cloud.device

    def num_valid_points(self) -> int:
        return int(self.capacity - int(self.point_invalid_mask.sum()))

    def spatially_sorted(self) -> "GaussianPointCloudScene":
        """Reorder valid points along a Morton (Z-order) curve of their
        positions; invalid slots stay at the end.

        Rendering does not depend on the order (keys sort by tile and
        depth), but a tile's points then occupy a narrow id range, which
        makes the blend-slab gather more local. Host-side, once per scene."""
        pc = self.point_cloud.cpu().numpy()
        invalid = self.point_invalid_mask.cpu().numpy()
        valid = invalid == 0
        v = pc[valid]
        if v.shape[0] == 0:
            return self
        lo = v.min(axis=0)
        span = np.maximum(v.max(axis=0) - lo, 1e-12)
        q = np.clip(((v - lo) / span) * ((1 << 21) - 1), 0,
                    (1 << 21) - 1).astype(np.uint64)

        def _spread(x):
            # interleave 21 bits with two zero bits (standard Morton spread)
            x &= np.uint64(0x1FFFFF)
            x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
            x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
            x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
            x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
            x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
            return x

        code = (_spread(q[:, 0]) | (_spread(q[:, 1]) << np.uint64(1))
                | (_spread(q[:, 2]) << np.uint64(2)))
        perm_valid = np.argsort(code, kind="stable")
        idx = np.arange(pc.shape[0])
        perm = torch.as_tensor(
            np.concatenate([idx[valid][perm_valid], idx[~valid]]),
            device=self.device)
        return GaussianPointCloudScene(*(x[perm] for x in self))

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @staticmethod
    def from_numpy(point_cloud, point_cloud_features, point_invalid_mask,
                   point_object_id, device="cuda") -> "GaussianPointCloudScene":
        """The scene from four array-likes (e.g. `np.asarray` of each field
        of a JAX-package scene), copied to `device`."""
        def put(x, dtype):
            return torch.tensor(np.asarray(x, dtype), device=device)
        return GaussianPointCloudScene(
            point_cloud=put(point_cloud, np.float32),
            point_cloud_features=put(point_cloud_features, np.float32),
            point_invalid_mask=put(point_invalid_mask, np.int8),
            point_object_id=put(point_object_id, np.int32),
        )

    @staticmethod
    def from_arrays(point_cloud: np.ndarray,
                    config: SceneConfig,
                    point_cloud_features: Optional[np.ndarray] = None,
                    point_cloud_rgb: Optional[np.ndarray] = None,
                    point_object_id: Optional[np.ndarray] = None,
                    rng: Optional[np.random.Generator] = None,
                    device="cuda") -> "GaussianPointCloudScene":
        """Build a scene, padding to fixed capacity and initializing features
        when none are given (`rng` draws the initial quaternions; default
        `np.random.default_rng(0)`)."""
        point_cloud = np.asarray(point_cloud, np.float32)
        if point_cloud.ndim != 2 or point_cloud.shape[1] != 3:
            raise ValueError(f"point_cloud must be (N, 3), got "
                             f"{point_cloud.shape}")
        num_points = point_cloud.shape[0]
        if num_points == 0:
            # an all-pruned checkpoint reloads as one invalid placeholder
            return GaussianPointCloudScene.from_numpy(
                np.zeros((1, 3)), np.zeros((1, config.num_of_features)),
                np.ones((1,)), np.zeros((1,)), device)

        if point_cloud_features is None:
            point_cloud_features = _initialize_features(
                point_cloud, config, point_cloud_rgb,
                rng if rng is not None else np.random.default_rng(0))
        point_cloud_features = np.asarray(point_cloud_features, np.float32)

        if point_object_id is None:
            point_object_id = np.zeros((num_points,), np.int32)
        invalid = np.zeros((num_points,), np.int8)

        if config.max_num_points_ratio is not None:
            capacity = int(num_points * config.max_num_points_ratio)
            if capacity <= num_points:
                raise ValueError(
                    "max_num_points_ratio should be greater than 1.0")
            pad = capacity - num_points
            point_cloud = np.concatenate(
                [point_cloud, np.zeros((pad, 3), np.float32)])
            # padding slots carry an identity quaternion, not all-zeros
            pad_feats = np.zeros((pad, config.num_of_features), np.float32)
            pad_feats[:, 3] = 1.0  # quat xyzw -> identity
            point_cloud_features = np.concatenate(
                [point_cloud_features, pad_feats])
            invalid = np.concatenate([invalid, np.ones((pad,), np.int8)])
            point_object_id = np.concatenate(
                [point_object_id, np.zeros((pad,), np.int32)])

        return GaussianPointCloudScene.from_numpy(
            point_cloud, point_cloud_features, invalid, point_object_id,
            device)

    @staticmethod
    def from_parquet(path: str, config: Optional[SceneConfig] = None,
                     rng: Optional[np.random.Generator] = None,
                     device="cuda") -> "GaussianPointCloudScene":
        """Load the 59-column parquet schema, or initialize features from
        x,y,z (and r,g,b when present)."""
        import pandas as pd
        config = config or SceneConfig()
        rng = rng if rng is not None else np.random.default_rng(0)
        scene_df = pd.read_parquet(path)
        if config.add_sphere:
            scene_df = _add_sphere(scene_df, config.sphere_radius_factor,
                                   config.num_points_sphere, rng)
        point_cloud = scene_df[["x", "y", "z"]].to_numpy(np.float32)
        columns = set(scene_df.columns)
        if set(FEATURE_COLUMNS).issubset(columns):
            features = scene_df[FEATURE_COLUMNS].to_numpy(np.float32)
            return GaussianPointCloudScene.from_arrays(
                point_cloud, config, point_cloud_features=features,
                device=device)
        rgb = (scene_df[["r", "g", "b"]].to_numpy(np.float32)
               if {"r", "g", "b"}.issubset(columns) else None)
        return GaussianPointCloudScene.from_arrays(
            point_cloud, config, point_cloud_rgb=rgb, rng=rng, device=device)

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------

    def _valid_arrays(self):
        keep = self.point_invalid_mask.cpu().numpy() == 0
        pc = self.point_cloud.detach().cpu().numpy()[keep]
        feats = self.point_cloud_features.detach().cpu().numpy()[keep]
        return pc, feats

    def to_parquet(self, path: str):
        """Write the valid points in the 59-column schema."""
        import pandas as pd
        pc, feats = self._valid_arrays()
        df = pd.concat([
            pd.DataFrame(pc, columns=["x", "y", "z"]),
            pd.DataFrame(feats, columns=FEATURE_COLUMNS),
        ], axis=1)
        df.to_parquet(path)

    def to_ply(self, path: str):
        """Write the valid points in the official-implementation PLY
        layout."""
        pc, feats = self._valid_arrays()
        n = pc.shape[0]
        normals = np.zeros_like(pc)
        f_sh = feats[:, 8:].reshape(-1, 3, 16)
        f_dc = f_sh[..., 0]
        f_rest = f_sh[..., 1:].reshape(-1, 45)
        opacities = feats[:, 7:8]
        scale = feats[:, 4:7]
        rotation = feats[:, [3, 0, 1, 2]]  # xyzw -> wxyz

        props = (["x", "y", "z", "nx", "ny", "nz"]
                 + [f"f_dc_{i}" for i in range(3)]
                 + [f"f_rest_{i}" for i in range(45)]
                 + ["opacity"]
                 + [f"scale_{i}" for i in range(3)]
                 + [f"rot_{i}" for i in range(4)])
        data = np.concatenate(
            [pc, normals, f_dc, f_rest, opacities, scale, rotation],
            axis=1).astype("<f4")
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {p}" for p in props]
        header += ["end_header"]
        with open(path, "wb") as f:
            f.write(("\n".join(header) + "\n").encode("ascii"))
            f.write(data.tobytes())

    @staticmethod
    def from_ply(path: str, config: Optional[SceneConfig] = None,
                 device="cuda") -> "GaussianPointCloudScene":
        """Load an official-implementation PLY checkpoint (rotation wxyz ->
        xyzw, f_dc/f_rest interleaved per channel)."""
        config = config or SceneConfig()
        names, data = _read_ply_vertices(path)
        col = {name: i for i, name in enumerate(names)}
        n = data.shape[0]
        pc = data[:, [col["x"], col["y"], col["z"]]]
        feats = np.zeros((n, NUM_FEATURES), np.float32)
        feats[:, 0] = data[:, col["rot_1"]]  # x
        feats[:, 1] = data[:, col["rot_2"]]  # y
        feats[:, 2] = data[:, col["rot_3"]]  # z
        feats[:, 3] = data[:, col["rot_0"]]  # w
        for i in range(3):
            feats[:, 4 + i] = data[:, col[f"scale_{i}"]]
        feats[:, 7] = data[:, col["opacity"]]
        for ch in range(3):
            feats[:, 8 + 16 * ch] = data[:, col[f"f_dc_{ch}"]]
            for j in range(15):
                feats[:, 8 + 16 * ch + 1 + j] = data[
                    :, col[f"f_rest_{ch * 15 + j}"]]
        return GaussianPointCloudScene.from_arrays(
            pc, config, point_cloud_features=feats, device=device)


def _initialize_features(point_cloud: np.ndarray, config: SceneConfig,
                         point_cloud_rgb: Optional[np.ndarray],
                         rng: np.random.Generator) -> np.ndarray:
    """Isotropic covariance from the mean 3-NN distance, random unit
    quaternions from `rng`, the configured alpha, SH DC from rgb or 1.0."""
    from scipy.spatial import cKDTree
    n = point_cloud.shape[0]
    feats = np.zeros((n, config.num_of_features), np.float32)

    tree = cKDTree(point_cloud)
    dist, _ = tree.query(point_cloud, k=4)
    initial_cov = dist[:, 1:].mean(axis=1) * config.initial_covariance_ratio
    initial_cov = np.clip(initial_cov, 1e-6, config.max_initial_covariance)
    feats[:, 4:7] = np.log(initial_cov)[:, None]

    q = rng.random((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 0:4] = q

    feats[:, 7] = config.initial_alpha
    feats[:, 8] = 1.0
    feats[:, 24] = 1.0
    feats[:, 40] = 1.0
    if point_cloud_rgb is not None:
        rgb = np.clip(np.asarray(point_cloud_rgb, np.float32) / 255.0,
                      0.0, 0.99)
        logit = np.log(rgb / (1.0 - rgb))
        feats[:, 8] = logit[:, 0] / SH_C0
        feats[:, 24] = logit[:, 1] / SH_C0
        feats[:, 40] = logit[:, 2] / SH_C0
    return feats


def _add_sphere(scene_df, radius_factor: float, num_points: int,
                rng: np.random.Generator):
    """Append a background sphere of `num_points` points around the scene."""
    import pandas as pd
    has_color = {"r", "g", "b"}.issubset(set(scene_df.columns))
    half_extent = max(
        scene_df["x"].max() - scene_df["x"].min(),
        scene_df["y"].max() - scene_df["y"].min(),
        scene_df["z"].max() - scene_df["z"].min()) / 2.0
    radius = half_extent * radius_factor
    phi = 2.0 * np.pi * rng.random(num_points)
    theta = np.arccos(2.0 * rng.random(num_points) - 1.0)
    pts = np.stack([
        radius * np.sin(theta) * np.cos(phi),
        radius * np.sin(theta) * np.sin(phi),
        radius * np.cos(theta),
    ], axis=1)
    columns = ["x", "y", "z"]
    if has_color:
        pts = np.concatenate(
            [pts, np.full((num_points, 3), 255 // 2, dtype=np.float64)],
            axis=1)
        columns += ["r", "g", "b"]
    return pd.concat(
        [scene_df, pd.DataFrame(pts, columns=columns)], ignore_index=True)


def _read_ply_vertices(path: str):
    """Minimal PLY reader: float32 vertex properties, ascii or binary LE."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"malformed PLY (no end_header): {path}")
    header = raw[:end].decode("ascii").splitlines()
    body = raw[end + len(b"end_header\n"):]
    fmt = None
    count = 0
    names = []
    in_vertex = False
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] not in ("float", "float32"):
                raise ValueError(f"unsupported PLY property type {parts[1]}")
            names.append(parts[2])
    k = len(names)
    if fmt == "ascii":
        data = np.array(body.decode("ascii").split(), np.float32)
        data = data[:count * k].reshape(count, k)
    elif fmt == "binary_little_endian":
        data = np.frombuffer(body, dtype="<f4",
                             count=count * k).reshape(count, k).copy()
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return names, data
