"""The CUDA blend kernel against its plain PyTorch version on the card.

Marked `cuda`: skips without a card. Run on a machine with an H100 as

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`tests/conftest.py` imports JAX, which such a machine need not have.)
"""

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_torch.camera import CameraInfo
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene)
from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
    RasterizerConfig, _project_and_bin, rasterize)
from taichi_3d_gaussian_splatting_torch.ops.tiling import blend_slab

from torch_port_fixtures import (AB_CASES, ATOL, RTOL, assert_counts_close,
                                 camera_intrinsics, identity_pose,
                                 random_scene)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, alpha, cfg, device):
    pc, feats = random_scene(60, seed=seed, alpha=alpha)
    scene = GaussianPointCloudScene.from_numpy(pc, feats, np.zeros(60),
                                               np.zeros(60), device)
    q, t = (torch.as_tensor(x, device=device) for x in identity_pose())
    cam = CameraInfo(camera_intrinsics(), 32, 32)
    _, cols, depth, b = _project_and_bin(*scene, q, t, cam,
                                         RasterizerConfig(**cfg), None)
    slabs = {"wide16": b.point_data,
             "packed8": blend_slab(cols + (depth,), b.sorted_point_idx,
                                   "packed8")}
    return cam, b, slabs, (scene, q, t)


@pytest.mark.parametrize("seed, alpha, label, cfg", AB_CASES,
                         ids=[c[2] for c in AB_CASES])
@pytest.mark.parametrize("fmt, rgb_only", [("packed8", True),
                                           ("wide16", True),
                                           ("wide16", False)])
def test_kernel_matches_plain(cuda, seed, alpha, label, cfg, fmt, rgb_only):
    cam, b, slabs, _ = _inputs(seed, alpha, cfg, cuda)
    args = (slabs[fmt], b.tile_starts, b.tile_ends)
    kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row,
              rgb_only=rgb_only)
    before = dict(BC.launch_counts)
    got = BC.blend_forward(*args, **kw)
    torch.cuda.synchronize()
    name = "blend_forward_rgb" if rgb_only else "blend_forward"
    assert BC.launch_counts[name] == before[name] + 1
    ref = BC.blend_forward_torch(*args, **kw).cpu().numpy()
    got = got.cpu().numpy()
    for row in (BC.OUT_R, BC.OUT_G, BC.OUT_B, BC.OUT_ACC_ALPHA, BC.OUT_NORM):
        np.testing.assert_allclose(got[:, row], ref[:, row], rtol=RTOL,
                                   atol=ATOL)
    if not rgb_only:
        for row in (BC.OUT_COUNT, BC.OUT_LAST_EFF):
            assert_counts_close(ref[:, row], got[:, row])


def test_rasterize_on_card_matches_cpu(cuda):
    seed, alpha, _, cfg = AB_CASES[1]
    _, _, _, (scene, q, t) = _inputs(seed, alpha, cfg, cuda)
    cam = CameraInfo(camera_intrinsics(), 32, 32)
    config = RasterizerConfig(**cfg, rgb_only=True)
    gpu = rasterize(*scene, q, t, cam, config).image.cpu()
    cpu = rasterize(*(x.cpu() for x in scene), q.cpu(), t.cpu(), cam,
                    config).image
    np.testing.assert_allclose(gpu.numpy(), cpu.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_no_keys_on_card(cuda):
    ranges = torch.zeros(6, dtype=torch.int32, device=cuda)
    out = BC.blend_forward(torch.zeros((8, 0), dtype=torch.int32,
                                       device=cuda), ranges, ranges,
                           num_tiles=6, tiles_per_row=3, rgb_only=True)
    torch.cuda.synchronize()
    assert not out.any()
