"""A run's inputs from its seed: poses, samples and scenes.

Host draws (the order of the poses, which frames to check) come from
numpy generators seeded with (seed, stream); the scene comes from a
torch.Generator on the device seeded with the seed. The same seed gives
the same inputs."""

from __future__ import annotations

import numpy as np
import torch

from . import spec

# numpy streams of one seed
POSES, SAMPLE, WORK = 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def _axis_quaternion(axis: int, angle):
    q = np.zeros(angle.shape + (4,))
    q[..., axis] = np.sin(angle / 2)
    q[..., 3] = np.cos(angle / 2)
    return q


def _multiply(a, b):
    x1, y1, z1, w1 = np.moveaxis(a, -1, 0)
    x2, y2, z2, w2 = np.moveaxis(b, -1, 0)
    return np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def poses(traffic: dict, count: int, seed: int):
    """`count` camera-to-world poses around the bench camera (at the
    origin, looking down +z): translation uniform within
    +-`translation_xy` in x and y, yaw and pitch uniform within
    +-`yaw_deg` and +-`pitch_deg`. The set is the mix's own, drawn from its
    `pose_set_seed`, so that every seed does the same work; the run's seed
    only rotates the order. (q (count, 1, 4) xyzw, t (count, 1, 3))
    float32 CPU tensors."""
    r = rng(int(traffic["pose_set_seed"]), POSES)
    yaw = np.radians(r.uniform(-traffic["yaw_deg"], traffic["yaw_deg"],
                               count))
    pitch = np.radians(r.uniform(-traffic["pitch_deg"],
                                 traffic["pitch_deg"], count))
    q = _multiply(_axis_quaternion(1, yaw), _axis_quaternion(0, pitch))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.zeros((count, 3))
    t[:, :2] = r.uniform(-traffic["translation_xy"],
                         traffic["translation_xy"], (count, 2))
    shift = int(rng(seed, POSES).integers(count))
    q, t = np.roll(q, shift, axis=0), np.roll(t, shift, axis=0)
    return (torch.tensor(q[:, None], dtype=torch.float32),
            torch.tensor(t[:, None], dtype=torch.float32))


def sample(seed: int, stream: int, population: int, k: int) -> list:
    """`k` distinct integers below `population`, sorted, drawn from the
    seed."""
    k = min(k, population)
    return sorted(int(i) for i in rng(seed, stream).choice(
        population, size=k, replace=False))


def scene(config: dict, n: int, generator: torch.Generator):
    """(positions (n, 3), features (n, 56)) of the configuration's scene
    recipe, from `generator`."""
    params = config["scene"]
    return spec.recipe(params["recipe"]).make(n, params, generator)


def camera(config: dict):
    """The configuration's camera as (fx, fy, cx, cy, width, height)."""
    c = config["camera"]
    return (float(c["fx"]), float(c["fy"]), float(c["cx"]), float(c["cy"]),
            int(c["width"]), int(c["height"]))


def rotation(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) xyzw -> (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)
