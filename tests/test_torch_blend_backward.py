"""Port parity for the blend's backward: the plain PyTorch version
(ops/blend_cuda.py blend_backward_torch) against the JAX package's Pallas
backward kernel (blend_pallas.blend_backward), run in interpret mode on the
CPU, on the same numpy inputs: the port's wide16 slab of each ab fixture,
padded with zero columns to a multiple of the Pallas chunk (128), its tile
ranges, and per pixel a seeded normal image cotangent beside the colour of
the Pallas forward; the port's pixel_in also carries the Pallas forward's
`last` row in row 6 (the JAX kernel ignores rows 6-7 and re-tests
saturation; the port blends the keys below `last`), or the port is given
that `last` as int32 beside it.

Per-key gradient rows and the magnitude image at rtol 2e-3 / atol 1e-4
(the exactness tolerances: the two replays round the exponent and the
transmittance product differently); the per-key pixel count
statistically (a key at the 1/255 gate may flip)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.ops import blend_pallas as BP
from taichi_3d_gaussian_splatting_torch.camera import CameraInfo
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene)
from taichi_3d_gaussian_splatting_torch.ops import _build
from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
    RasterizerConfig, _project_and_bin)

from torch_port_fixtures import (AB_CASES, ATOL, RTOL, assert_counts_close,
                                 camera_intrinsics, identity_pose,
                                 random_scene)

torch.set_num_threads(1)
CHUNK = 128
FLOAT_ROWS = {"du": BC.GROW_DU, "dv": BC.GROW_DV, "da": BC.GROW_DA,
              "db": BC.GROW_DB, "dc": BC.GROW_DC, "dlogw": BC.GROW_DLOGW,
              "dr": BC.GROW_DR, "dg": BC.GROW_DG, "db_col": BC.GROW_DB_COL,
              "mag_uv": BC.GROW_MAG_UV}


def _inputs(seed, alpha, cfg):
    """(slab padded to a multiple of 128, starts, ends, pixel_in of the
    JAX kernel, tile kwargs, Pallas forward output, pixel_in of the port),
    numpy."""
    pc, feats = random_scene(60, seed=seed, alpha=alpha)
    scene = GaussianPointCloudScene.from_numpy(pc, feats, np.zeros(60),
                                               np.zeros(60), "cpu")
    q, t = (torch.as_tensor(x) for x in identity_pose())
    cam = CameraInfo(camera_intrinsics(), 32, 32)
    with torch.no_grad():
        _, _, _, b = _project_and_bin(*scene, q, t, cam,
                                      RasterizerConfig(**cfg), None)
    slab = b.point_data.numpy()
    mk = -(-slab.shape[1] // CHUNK) * CHUNK
    slab = np.pad(slab, ((0, 0), (0, mk - slab.shape[1])))
    starts, ends = b.tile_starts.numpy(), b.tile_ends.numpy()
    kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row)
    fwd = np.asarray(BP.blend_forward(jnp.asarray(slab), jnp.asarray(starts),
                                      jnp.asarray(ends), **kw))
    rng = np.random.default_rng(seed + 100)
    pixel_in = np.zeros((cam.num_tiles, 8, 256), np.float32)
    pixel_in[:, 0:3] = rng.normal(size=(cam.num_tiles, 3, 256))
    pixel_in[:, 3:6] = fwd[:, 0:3]
    port_pixel_in = pixel_in.copy()
    port_pixel_in[:, BC.PIXEL_IN_LAST] = fwd[:, BC.OUT_LAST_EFF]
    return slab, starts, ends, pixel_in, kw, fwd, port_pixel_in


@pytest.mark.parametrize("seed, alpha, label, cfg", AB_CASES,
                         ids=[c[2] for c in AB_CASES])
def test_plain_backward_matches_pallas(seed, alpha, label, cfg):
    slab, starts, ends, pixel_in, kw, fwd, port_pixel_in = _inputs(
        seed, alpha, cfg)
    ref_grad, ref_mag = (np.asarray(x) for x in BP.blend_backward(
        jnp.asarray(slab), jnp.asarray(starts), jnp.asarray(ends),
        jnp.asarray(pixel_in), **kw))
    got_grad, got_mag = (x.numpy() for x in BC.blend_backward_torch(
        torch.as_tensor(slab), torch.as_tensor(starts),
        torch.as_tensor(ends), torch.as_tensor(port_pixel_in), **kw))
    assert got_grad.shape == ref_grad.shape == slab.shape
    assert got_mag.shape == ref_mag.shape == (kw["num_tiles"], 8, 256)
    for name, row in FLOAT_ROWS.items():
        np.testing.assert_allclose(got_grad[row], ref_grad[row], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        assert np.abs(got_grad[row]).max() > 0, name
    assert_counts_close(ref_grad[BC.GROW_NUM_PIXELS],
                        got_grad[BC.GROW_NUM_PIXELS], "num_pixels")
    unused = [r for r in range(16) if r not in BC.GRAD_ROWS]
    assert not got_grad[unused].any()
    np.testing.assert_allclose(got_mag, ref_mag, rtol=RTOL, atol=ATOL,
                               err_msg="magnitude image")
    assert not got_mag[:, 2:].any()
    # the padding columns belong to no tile: zero gradient
    assert not got_grad[:, int(ends.max()):].any()
    if label == "b":
        # the saturating fixture really saturates: some pixel stopped
        assert (fwd[:, BC.OUT_ACC_ALPHA] > 0.99).any()


def test_wrapper_on_cpu_is_the_plain_version():
    slab, starts, ends, _, kw, _, pixel_in = _inputs(*AB_CASES[0][:2],
                                                     AB_CASES[0][3])
    args = tuple(torch.as_tensor(x) for x in (slab, starts, ends, pixel_in))
    _build.reset_launch_counts()
    got = BC.blend_backward(*args, **kw)
    want = BC.blend_backward_torch(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(_build.launch_counts.values()) == 0


def test_no_keys_gives_empty_gradients():
    ranges = torch.zeros(6, dtype=torch.int32)
    grad, mag = BC.blend_backward(torch.zeros((16, 0)), ranges, ranges,
                                  torch.ones((6, 8, 256)), num_tiles=6,
                                  tiles_per_row=3)
    assert grad.shape == (16, 0) and mag.shape == (6, 8, 256)
    assert not mag.any()


@pytest.mark.parametrize("bad", ["packed8", "pixel_shape", "pixel_dtype",
                                 "ranges"])
def test_backward_rejects_malformed_inputs(bad):
    slab = torch.zeros((16, 4))
    starts = torch.zeros(2, dtype=torch.int32)
    ends = torch.zeros(2, dtype=torch.int32)
    pixel_in = torch.zeros((2, 8, 256))
    if bad == "packed8":
        slab = torch.zeros((8, 4), dtype=torch.int32)
    elif bad == "pixel_shape":
        pixel_in = torch.zeros((2, 6, 256))
    elif bad == "pixel_dtype":
        pixel_in = torch.zeros((2, 8, 256), dtype=torch.float64)
    else:
        ends = torch.zeros(3, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        BC.blend_backward(slab, starts, ends, pixel_in, num_tiles=2,
                          tiles_per_row=2)


@pytest.mark.parametrize("seed, alpha, label, cfg", AB_CASES,
                         ids=[c[2] for c in AB_CASES])
def test_int_last_matches_the_float_row(seed, alpha, label, cfg):
    """The plain versions with the int32 `last`: the forward's output is
    bitwise the float-row version's and its `last` is the float row
    exactly; the backward given that `last` is bitwise the float-row
    backward, and both still match the Pallas kernels (interpret mode) at
    rtol 2e-3 / atol 1e-4."""
    slab, starts, ends, pixel_in, kw, fwd, port_pixel_in = _inputs(
        seed, alpha, cfg)
    args = tuple(torch.as_tensor(x) for x in (slab, starts, ends))
    out, last = BC.blend_forward_with_last_torch(*args, **kw)
    assert last.dtype == torch.int32 and tuple(last.shape) == (
        kw["num_tiles"], 256)
    assert torch.equal(out, BC.blend_forward_torch(*args, rgb_only=False,
                                                   **kw))
    assert torch.equal(out[:, BC.OUT_LAST_EFF], last.to(torch.float32))
    assert torch.equal(last.long(), out[:, BC.OUT_LAST_EFF].long())
    assert int(last.max()) > 0
    for row in (BC.OUT_R, BC.OUT_G, BC.OUT_B, BC.OUT_ACC_ALPHA):
        np.testing.assert_allclose(out[:, row].numpy(), fwd[:, row],
                                   rtol=RTOL, atol=ATOL)
    assert_counts_close(fwd[:, BC.OUT_LAST_EFF],
                        out[:, BC.OUT_LAST_EFF].numpy(), "last")

    pin = torch.as_tensor(port_pixel_in)
    pin[:, BC.PIXEL_IN_LAST] = out[:, BC.OUT_LAST_EFF]
    by_row = BC.blend_backward_torch(*args, pin, **kw)
    by_int = BC.blend_backward_torch(*args, pin, **kw, last=last)
    assert all(torch.equal(a, b) for a, b in zip(by_row, by_int))
    # the wrapper takes the same path on the CPU, with or without `last`
    got = BC.blend_backward(*args, pin, **kw, last=last)
    assert all(torch.equal(a, b) for a, b in zip(got, by_int))
    ref_grad, ref_mag = (np.asarray(x) for x in BP.blend_backward(
        jnp.asarray(slab), jnp.asarray(starts), jnp.asarray(ends),
        jnp.asarray(pixel_in), **kw))
    for name, row in FLOAT_ROWS.items():
        np.testing.assert_allclose(by_int[0][row].numpy(), ref_grad[row],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(by_int[1].numpy(), ref_mag, rtol=RTOL,
                               atol=ATOL, err_msg="magnitude image")


@pytest.mark.parametrize("value", [2 ** 24, 2 ** 24 + 1, 2 ** 30 + 5])
def test_rasterizer_hands_the_int_last_to_the_backward(value, monkeypatch):
    """The rasterizer carries the forward's int32 `last` to the backward
    unchanged, both through the autograd node of `rasterize` and through
    `rasterize_with_vjp`; as a float32 row 2**24 + 1 would round to 2**24.
    (The forward's `last` is replaced by `value`: a slab that wide takes
    gigabytes, so the CPU tests do not build one; chip_smoke.py phase 3b
    and tests/test_torch_cuda.py run one on the card.)"""
    from taichi_3d_gaussian_splatting_torch.ops import rasterizer as R
    real_forward, real_backward = BC.blend_forward_with_last, BC.blend_backward
    seen = []

    def forward(*args, **kw):
        out, last = real_forward(*args, **kw)
        return out, torch.full_like(last, value)

    def backward(*args, last=None, **kw):
        seen.append(last)
        return real_backward(*args, last=last, **kw)

    monkeypatch.setattr(BC, "blend_forward_with_last", forward)
    monkeypatch.setattr(BC, "blend_backward", backward)
    pc, feats = random_scene(60, seed=0)
    scene = GaussianPointCloudScene.from_numpy(pc, feats, np.zeros(60),
                                               np.zeros(60), "cpu")
    q, t = (torch.as_tensor(x) for x in identity_pose())
    cam = CameraInfo(camera_intrinsics(), 32, 32)
    pcl = scene.point_cloud.clone().requires_grad_(True)
    res = R.rasterize(pcl, *scene[1:], q, t, cam, RasterizerConfig())
    res.image.sum().backward()
    _, vjp_fn = R.rasterize_with_vjp(*scene, q, t, cam, RasterizerConfig())
    grad_pc, _, _ = vjp_fn(torch.ones((32, 32, 3)))
    assert len(seen) == 2
    for last in seen:
        assert last.dtype == torch.int32
        assert tuple(last.shape) == (cam.num_tiles, 256)
        assert (last.long() == value).all()
    assert bool(torch.isfinite(pcl.grad).all())
    assert bool(torch.isfinite(grad_pc).all())
    if value == 2 ** 24 + 1:
        assert int(torch.tensor(float(value), dtype=torch.float32)) != value


@pytest.mark.parametrize("columns", [2 ** 31, 2 ** 31 + 5])
def test_blend_refuses_more_than_int32_columns(columns):
    """The tile ranges and the work list are int32: the wrappers refuse a
    slab of more than 2**31 - 1 columns (a view of one column, so nothing
    large is allocated)."""
    slab = torch.zeros((16, 1)).expand(16, columns)
    ranges = torch.zeros(2, dtype=torch.int32)
    last = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"2\*\*31 - 1"):
        BC.blend_backward(slab, ranges, ranges, torch.zeros((2, 8, 256)),
                          num_tiles=2, tiles_per_row=2, last=last)
    with pytest.raises(ValueError, match=r"2\*\*31 - 1"):
        BC.blend_forward_with_last(slab, ranges, ranges, num_tiles=2,
                                   tiles_per_row=2)


def test_backward_without_int_last_refuses_wide_slabs():
    """Past 2**24 columns the float `last` row can round, so the backward
    then asks for the int32 `last` rather than read it; the int `last` of
    the wrong type or shape is refused too."""
    slab = torch.zeros((16, 1)).expand(16, 2 ** 24 + 1)
    ranges = torch.zeros(2, dtype=torch.int32)
    pixel_in = torch.zeros((2, 8, 256))
    with pytest.raises(ValueError, match="int32 `last`"):
        BC.blend_backward(slab, ranges, ranges, pixel_in, num_tiles=2,
                          tiles_per_row=2)
    for bad in (torch.zeros((2, 256)), torch.zeros((3, 256), dtype=torch.int32),
                torch.zeros((2, 256), dtype=torch.int64)):
        with pytest.raises(ValueError, match="last must be"):
            BC.blend_backward(torch.zeros((16, 4)), ranges, ranges, pixel_in,
                              num_tiles=2, tiles_per_row=2, last=bad)
