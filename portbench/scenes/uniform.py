"""Uniform synthetic scene: the port's bench recipe
(`taichi_3d_gaussian_splatting_torch/bench.py` load_scene), drawn on the
device. Positions uniform in [-30, 30] x [-20, 20] x [2, 60] in front of
the camera at the origin looking down +z; unit quaternions; log-scales
uniform in [-3.5, -2.0]; alpha logit N(0, 1); the three DC colour
coefficients N(0, 1). Unlike the bench, whose other SH coefficients are
0, bands 1-3 are N(0, 0.25), N(0, 0.1) and N(0, 0.04) as in
`heavy_tailed`, so that a comparison of the render covers the
projection's evaluation of every band."""

from __future__ import annotations

import torch


def make(n: int, params: dict, generator: torch.Generator):
    device = generator.device
    g = dict(generator=generator, device=device)
    lo = torch.tensor([-30.0, -20.0, 2.0], device=device)
    hi = torch.tensor([30.0, 20.0, 60.0], device=device)
    pc = lo + (hi - lo) * torch.rand((n, 3), **g)
    feats = torch.zeros((n, 56), device=device)
    q = torch.randn((n, 4), **g)
    feats[:, 0:4] = q / torch.linalg.norm(q, dim=1, keepdim=True)
    feats[:, 4:7] = -3.5 + 1.5 * torch.rand((n, 3), **g)
    feats[:, [7, 8, 24, 40]] = torch.randn((n, 4), **g)
    for base in (8, 24, 40):
        feats[:, base + 1:base + 4] = 0.25 * torch.randn((n, 3), **g)
        feats[:, base + 4:base + 9] = 0.1 * torch.randn((n, 5), **g)
        feats[:, base + 9:base + 16] = 0.04 * torch.randn((n, 7), **g)
    return pc, feats
