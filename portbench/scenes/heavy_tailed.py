"""Heavy-tailed synthetic checkpoint with the statistics of trained ones:
a copy of `benchmark/synthetic_checkpoint.py`'s recipe, drawn on the
device.

- 88% surface splats clustered around 256 centres whose radii are
  log-normal and whose weights are Pareto (some hold far more points),
  with world scales tracking their cluster's size;
- 8% haze filling the scene's box at mid scales;
- 2% background shell, few, huge and translucent;
- one axis of each splat shrunk (disc-like), log-scales clipped to
  [-8, 3], bimodal alpha (55% opaque), SH energy decaying by band.

The 256 clusters (centres, radii, weights) are the configuration's
checkpoint: drawn from its `layout_seed` with numpy as the original does,
the same in every run. Every per-point draw comes from the run's seed."""

from __future__ import annotations

import math

import numpy as np
import torch

SCENE_DEPTH_RANGE = (2.0, 60.0)
SCENE_XY_HALF = (30.0, 20.0)
CLUSTERS = 256


def _layout(seed: int):
    rng = np.random.default_rng(seed)
    k = CLUSTERS
    centers = np.stack([
        rng.uniform(-SCENE_XY_HALF[0] * 0.8, SCENE_XY_HALF[0] * 0.8, k),
        rng.uniform(-SCENE_XY_HALF[1] * 0.8, SCENE_XY_HALF[1] * 0.8, k),
        rng.uniform(*SCENE_DEPTH_RANGE, k)], 1)
    cluster_r = np.exp(rng.normal(-0.3, 0.9, k))
    wts = rng.pareto(1.3, k) + 0.05
    return centers, cluster_r, wts / wts.sum()


def make(n: int, params: dict, generator: torch.Generator):
    device = generator.device
    g = dict(generator=generator, device=device)

    def uniform(lo, hi, size):
        return lo + (hi - lo) * torch.rand(size, **g)

    def normal(mean, std, size):
        return mean + std * torch.randn(size, **g)

    n_bg = max(int(n * 0.02), 1)
    n_haze = max(int(n * 0.08), 1)
    n_surf = n - n_bg - n_haze
    centers, cluster_r, wts = (torch.tensor(x, dtype=torch.float32,
                                            device=device)
                               for x in _layout(params["layout_seed"]))
    assign = torch.multinomial(wts, n_surf, replacement=True,
                               generator=generator)
    r = cluster_r[assign]
    surf = centers[assign] + normal(0.0, 1.0, (n_surf, 3)) * r[:, None]
    surf_log_s = torch.log(r * 0.02)[:, None] + normal(0.0, 0.7, (n_surf, 3))

    haze = torch.stack([uniform(-SCENE_XY_HALF[0], SCENE_XY_HALF[0], n_haze),
                        uniform(-SCENE_XY_HALF[1], SCENE_XY_HALF[1], n_haze),
                        uniform(*SCENE_DEPTH_RANGE, n_haze)], 1)
    haze_log_s = normal(-1.8, 0.6, (n_haze, 3))

    phi = uniform(0.0, 2 * math.pi, n_bg)
    cos_t = uniform(-0.3, 0.9, n_bg)
    sin_t = torch.sqrt(1.0 - cos_t ** 2)
    r_bg = uniform(50.0, 90.0, n_bg)
    bg = torch.stack([r_bg * sin_t * torch.cos(phi),
                      r_bg * sin_t * torch.sin(phi) * 0.6,
                      r_bg * cos_t + 30.0], 1)
    bg_log_s = normal(0.8, 0.5, (n_bg, 3))

    pc = torch.cat([surf, haze, bg])
    log_s = torch.cat([surf_log_s, haze_log_s, bg_log_s])
    flat = torch.randint(0, 3, (n,), **g)
    log_s[torch.arange(n, device=device), flat] -= torch.abs(
        normal(0.8, 0.4, n))

    feats = torch.zeros((n, 56), device=device)
    q = torch.randn((n, 4), **g)
    feats[:, 0:4] = q / torch.linalg.norm(q, dim=1, keepdim=True)
    feats[:, 4:7] = torch.clamp(log_s, -8.0, 3.0)
    opaque = torch.rand(n, **g) < 0.55
    feats[:, 7] = torch.where(opaque, normal(2.5, 1.0, n),
                              normal(-2.0, 1.0, n))
    for base in (8, 24, 40):
        feats[:, base] = normal(0.0, 1.0, n)
        feats[:, base + 1:base + 4] = normal(0.0, 0.25, (n, 3))
        feats[:, base + 4:base + 9] = normal(0.0, 0.1, (n, 5))
        feats[:, base + 9:base + 16] = normal(0.0, 0.04, (n, 7))
    return pc, feats
