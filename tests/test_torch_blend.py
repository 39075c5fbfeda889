"""Port parity: the blend's plain PyTorch version (ops/blend_cuda.py
blend_forward_torch) against the JAX package's Pallas forward kernel, run in
interpret mode on the CPU, on the same numpy slab and tile ranges taken from
the JAX binning. Covers blend_forward_rgb on the wide16 and packed8 slabs and
the full blend_forward, on the plain fixture, the saturating fixture (alpha
7.0) and a fixture with empty tiles.

Tolerances are those of tests/test_tpu_exactness.py (see
tests/torch_port_fixtures.py): the two blends round the exponent and the
transmittance product in a different order."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.camera import CameraInfo as JCamera
from taichi_3d_gaussian_splatting_tpu.ops import blend_pallas as BP
from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as JR
from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC

from torch_port_fixtures import (ATOL, CFG, COVERED_ALPHA, RTOL,
                                 assert_counts_close, camera_intrinsics,
                                 identity_pose, random_scene)

torch.set_num_threads(1)

FIXTURES = {
    "plain": dict(seed=1, alpha=2.0, w=32),
    "saturating": dict(seed=2, alpha=7.0, w=32),
    "empty_tiles": dict(seed=4, alpha=2.0, w=64),
}
VARIANTS = [("rgb", "wide16"), ("rgb", "packed8"), ("full", "wide16")]


def _jax_slab(fixture, slab_format):
    """(slab, tile_starts, tile_ends, camera) as numpy, from the JAX
    projection + binning of one fixture."""
    spec = FIXTURES[fixture]
    pc, feats = random_scene(60, seed=spec["seed"], alpha=spec["alpha"])
    if fixture == "empty_tiles":
        # squeeze the scene into the left half of a 64x32 image
        pc[:, 0] = -0.3 - 0.4 * (pc[:, 0] + 0.8) / 1.6
    n = pc.shape[0]
    cam = JCamera(camera_intrinsics(w=spec["w"]), 32, spec["w"])
    q, t = identity_pose()
    _, _, _, b = JR._project_and_bin(
        jnp.asarray(pc), jnp.asarray(feats), jnp.zeros(n, jnp.int8),
        jnp.zeros(n, jnp.int32), jnp.asarray(q), jnp.asarray(t), cam,
        JR.RasterizerConfig(**CFG), None, slab_format=slab_format)
    assert int(b.key_overflow) == 0 and int(b.big_point_overflow) == 0
    return (np.array(b.point_data), np.array(b.tile_starts),
            np.array(b.tile_ends), cam)


def _compare(ref, got, rgb_only):
    for row in (BC.OUT_R, BC.OUT_G, BC.OUT_B, BC.OUT_ACC_ALPHA, BC.OUT_NORM):
        np.testing.assert_allclose(got[:, row], ref[:, row], rtol=RTOL,
                                   atol=ATOL, err_msg=f"row {row}")
    if rgb_only:
        for row in (BC.OUT_DEPTH, BC.OUT_LAST_EFF, BC.OUT_COUNT):
            assert not got[:, row].any(), f"rgb_only row {row} not zero"
        return
    covered = ref[:, BC.OUT_ACC_ALPHA] > COVERED_ALPHA
    assert covered.any()
    np.testing.assert_allclose(got[:, BC.OUT_DEPTH][covered],
                               ref[:, BC.OUT_DEPTH][covered], rtol=RTOL,
                               atol=ATOL, err_msg="depth")
    for row in (BC.OUT_LAST_EFF, BC.OUT_COUNT):
        assert_counts_close(ref[:, row], got[:, row], f"row {row}")


@pytest.mark.parametrize("fixture", list(FIXTURES))
@pytest.mark.parametrize("mode, slab_format", VARIANTS,
                         ids=[f"{m}-{f}" for m, f in VARIANTS])
def test_plain_blend_matches_pallas(fixture, mode, slab_format):
    slab, starts, ends, cam = _jax_slab(fixture, slab_format)
    kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row)
    jfn = BP.blend_forward_rgb if mode == "rgb" else BP.blend_forward
    ref = np.asarray(jfn(jnp.asarray(slab), jnp.asarray(starts),
                         jnp.asarray(ends), **kw))
    got = BC.blend_forward_torch(torch.as_tensor(slab),
                                 torch.as_tensor(starts),
                                 torch.as_tensor(ends), rgb_only=mode == "rgb",
                                 **kw).numpy()
    assert got.shape == ref.shape == (cam.num_tiles, 8, 256)
    _compare(ref, got, mode == "rgb")
    if fixture == "saturating":
        # saturation really triggers: some pixel stopped with T < 1e-2
        assert (ref[:, BC.OUT_ACC_ALPHA] > 0.99).any()
    if fixture == "empty_tiles":
        empty = starts == ends
        assert empty.any() and (~empty).any()
        assert not got[empty].any(), "an empty tile must output zeros"


def test_wrapper_on_cpu_is_the_plain_version():
    slab, starts, ends, cam = _jax_slab("plain", "packed8")
    args = (torch.as_tensor(slab), torch.as_tensor(starts),
            torch.as_tensor(ends))
    kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row,
              rgb_only=True)
    assert torch.equal(BC.blend_forward(*args, **kw),
                       BC.blend_forward_torch(*args, **kw))


@pytest.mark.parametrize("rows, dtype, rgb_only", [
    (16, torch.float32, True), (16, torch.float32, False),
    (8, torch.int32, True)])
def test_no_keys_renders_zeros(rows, dtype, rgb_only):
    """A view where nothing is visible: a (rows, 0) slab and empty ranges
    give all-zero outputs (1 - T = 0)."""
    ranges = torch.zeros(6, dtype=torch.int32)
    out = BC.blend_forward(torch.zeros((rows, 0), dtype=dtype), ranges,
                           ranges, num_tiles=6, tiles_per_row=3,
                           rgb_only=rgb_only)
    assert out.shape == (6, 8, 256) and not out.any()


@pytest.mark.parametrize("bad", ["rows", "dtype", "packed_full", "ranges",
                                 "range_dtype"])
def test_wrapper_rejects_malformed_inputs(bad):
    slab = torch.zeros((16, 4))
    starts = torch.zeros(2, dtype=torch.int32)
    ends = torch.zeros(2, dtype=torch.int32)
    rgb_only = True
    if bad == "rows":
        slab = torch.zeros((12, 4))
    elif bad == "dtype":
        slab = torch.zeros((8, 4))            # packed8 must be int32
    elif bad == "packed_full":
        slab = torch.zeros((8, 4), dtype=torch.int32)
        rgb_only = False
    elif bad == "ranges":
        ends = torch.zeros(3, dtype=torch.int32)
    else:
        starts = torch.zeros(2, dtype=torch.int64)
    with pytest.raises((ValueError, TypeError)):
        BC.blend_forward(slab, starts, ends, num_tiles=2, tiles_per_row=2,
                         rgb_only=rgb_only)
