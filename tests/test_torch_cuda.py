"""The CUDA blend kernels (forward and backward) against their plain
PyTorch versions on the card, and one training step on the card against
the same step on the CPU.

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

from torch_chunk_fixtures import (NUM_TILES, TILES_PER_ROW,
                                  long_segment_slab)
from torch_port_fixtures import (AB_CASES, ATOL, RTOL, assert_counts_close,
                                 camera_intrinsics, identity_pose,
                                 random_scene)
from torch_train_fixtures import one_step_state, write_dataset

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


@pytest.mark.parametrize("seed, alpha, label, cfg", AB_CASES,
                         ids=[c[2] for c in AB_CASES])
def test_backward_kernel_matches_plain(cuda, seed, alpha, label, cfg):
    """Every GROW_* row and the magnitude image at rtol 2e-3 / atol 1e-4,
    the pixel count statistically; the image cotangent is seeded and the
    colour is the forward kernel's own."""
    cam, b, slabs, _ = _inputs(seed, alpha, cfg, cuda)
    kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row)
    fwd = BC.blend_forward(slabs["wide16"], b.tile_starts, b.tile_ends,
                           rgb_only=False, **kw)
    rng = np.random.default_rng(seed)
    pixel_in = torch.zeros((cam.num_tiles, 8, 256), device=cuda)
    pixel_in[:, 0:3] = torch.as_tensor(
        rng.normal(size=(cam.num_tiles, 3, 256)).astype(np.float32),
        device=cuda)
    pixel_in[:, 3:6] = fwd[:, 0:3]
    pixel_in[:, BC.PIXEL_IN_LAST] = fwd[:, BC.OUT_LAST_EFF]
    args = (slabs["wide16"], b.tile_starts, b.tile_ends, pixel_in)
    before = BC.launch_counts["blend_backward"]
    got = [x.cpu().numpy() for x in BC.blend_backward(*args, **kw)]
    torch.cuda.synchronize()
    assert BC.launch_counts["blend_backward"] == before + 1
    ref = [x.cpu().numpy() for x in BC.blend_backward_torch(*args, **kw)]
    float_rows = [r for r in BC.GRAD_ROWS if r != BC.GROW_NUM_PIXELS]
    np.testing.assert_allclose(got[0][float_rows], ref[0][float_rows],
                               rtol=RTOL, atol=ATOL)
    assert_counts_close(ref[0][BC.GROW_NUM_PIXELS], got[0][BC.GROW_NUM_PIXELS])
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fmt, rgb_only", [("packed8", True),
                                           ("wide16", True),
                                           ("wide16", False)])
def test_split_tiles_match_plain(cuda, fmt, rgb_only):
    """Tiles of several chunks (tests/torch_chunk_fixtures.py, at the
    kernels' chunk length): the chunked forward and backward kernels
    against the sequential plain versions."""
    slabs, starts, ends = long_segment_slab(BC.CHUNK_KEYS)
    kw = dict(num_tiles=NUM_TILES, tiles_per_row=TILES_PER_ROW)
    args = (slabs[fmt].to(cuda), starts.to(cuda), ends.to(cuda))
    got = BC.blend_forward(*args, rgb_only=rgb_only, **kw).cpu().numpy()
    ref = BC.blend_forward_torch(*args, rgb_only=rgb_only, **kw)
    refn = ref.cpu().numpy()
    for row in (BC.OUT_R, BC.OUT_G, BC.OUT_B, BC.OUT_ACC_ALPHA, BC.OUT_NORM):
        np.testing.assert_allclose(got[:, row], refn[:, row], rtol=RTOL,
                                   atol=ATOL)
    if rgb_only:
        return
    for row in (BC.OUT_COUNT, BC.OUT_LAST_EFF):
        assert_counts_close(refn[:, row], got[:, row])
    rng = np.random.default_rng(3)
    pixel_in = torch.zeros((NUM_TILES, 8, 256), device=cuda)
    pixel_in[:, 0:3] = torch.as_tensor(
        rng.normal(size=(NUM_TILES, 3, 256)).astype(np.float32), device=cuda)
    pixel_in[:, 3:6] = ref[:, 0:3]
    pixel_in[:, BC.PIXEL_IN_LAST] = ref[:, BC.OUT_LAST_EFF]
    bargs = args + (pixel_in,)
    got = [x.cpu().numpy() for x in BC.blend_backward(*bargs, **kw)]
    want = [x.cpu().numpy() for x in BC.blend_backward_torch(*bargs, **kw)]
    float_rows = [r for r in BC.GRAD_ROWS if r != BC.GROW_NUM_PIXELS]
    np.testing.assert_allclose(got[0][float_rows], want[0][float_rows],
                               rtol=RTOL, atol=ATOL)
    assert_counts_close(want[0][BC.GROW_NUM_PIXELS],
                        got[0][BC.GROW_NUM_PIXELS])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)


def test_work_list_kernel_matches_plain(cuda):
    """The work-list kernel against its plain version (integers, exactly):
    lengths 0, 1, C, C + 1, 3C + 7 and more, malformed ranges, and a grid
    of more tiles than the builder has threads."""
    c = BC.CHUNK_KEYS
    lengths = [0, 1, c, c + 1, 3 * c + 7, 0, c - 1, 2 * c]
    ends = np.cumsum(lengths)
    cases = [(ends - np.array(lengths), ends, int(ends[-1]) + 5),
             (np.array([-5, 3, 9]), np.array([2, 4000, 4]), 1000)]
    rng = np.random.default_rng(0)
    big = rng.integers(0, 3 * c, 5000)
    cases.append((np.cumsum(big) - big, np.cumsum(big), int(big.sum())))
    for starts, ends, mk in cases:
        s = torch.as_tensor(starts.astype(np.int32))
        e = torch.as_tensor(ends.astype(np.int32))
        got = BC.build_work_list(s.to(cuda), e.to(cuda), mk)
        want = BC.chunk_work_list(s, e, mk)
        assert got[1:] == want[1:]
        assert torch.equal(got.items.cpu(), want.items)


def test_training_step_on_card_matches_cpu(cuda, tmp_path):
    """One trainer step from one state on the card and on the CPU: the
    loss to 1e-4 relative, every state array at rtol 2e-3 / atol 1e-4."""
    write_dataset(str(tmp_path))
    loss_gpu, gpu = one_step_state(str(tmp_path), "cuda")
    loss_cpu, cpu = one_step_state(str(tmp_path), "cpu")
    assert abs(loss_gpu - loss_cpu) < 1e-4 * abs(loss_cpu)
    assert gpu.keys() == cpu.keys()
    for k in cpu:
        np.testing.assert_allclose(gpu[k], cpu[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
