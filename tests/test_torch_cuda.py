"""The CUDA blend kernels (forward and backward), projection kernels
(P1, P2), optimizer kernel, batch accumulation kernel and image loss
kernel against their plain PyTorch versions on the card; one training step, two batch steps and the viewer's frames on the
card against the same on the CPU.

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
from taichi_3d_gaussian_splatting_torch.ops import _build
from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
from taichi_3d_gaussian_splatting_torch.ops import projection as P
from taichi_3d_gaussian_splatting_torch.ops import projection_cuda as PC
from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
    RasterizerConfig, _project_and_bin, rasterize, rasterize_with_vjp)
from taichi_3d_gaussian_splatting_torch.ops.sh import sh_band_mask
from taichi_3d_gaussian_splatting_torch.ops.tiling import blend_slab
from taichi_3d_gaussian_splatting_torch.ops.transforms import inverse_SE3_qt
from taichi_3d_gaussian_splatting_torch.training import adam_cuda as TA
from taichi_3d_gaussian_splatting_torch.training import loss_cuda as TLC

from torch_chunk_fixtures import (BOUNDARY_OFFSET, NUM_TILES, TILES_PER_ROW,
                                  long_segment_slab, shifted_slab)
from torch_port_fixtures import (AB_CASES, ATOL, RTOL, assert_counts_close,
                                 camera_intrinsics, identity_pose,
                                 random_scene)
from torch_train_fixtures import (OPTIMIZER_CASES, RAW_QUATERNION_CASES,
                                  accumulate_inputs, assert_bitwise_equal,
                                  batch_step_state, batch_views, config_dict,
                                  loss_images, one_step_state,
                                  optimizer_inputs, raw_quaternion_inputs,
                                  write_dataset)

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
    before = _build.launch_counts.copy()
    got = BC.blend_forward(*args, **kw)
    torch.cuda.synchronize()
    name = "blend_forward_rgb" if rgb_only else "blend_forward"
    assert _build.launch_counts[name] == before[name] + 1
    ref = BC.blend_forward_torch(*args, **kw).cpu().numpy()
    got = got.cpu().numpy()
    for row in (BC.OUT_R, BC.OUT_G, BC.OUT_B, BC.OUT_ACC_ALPHA, BC.OUT_NORM):
        np.testing.assert_allclose(got[:, row], ref[:, row], rtol=RTOL,
                                   atol=ATOL)
    if not rgb_only:
        for row in (BC.OUT_COUNT, BC.OUT_LAST_EFF):
            assert_counts_close(ref[:, row], got[:, row])


def _projection_case(edit, device):
    """Projection inputs of 60 points: one object at the identity pose, or
    two objects with an edit transform and the SH mask of band 1."""
    pc, feats = random_scene(60, seed=2)
    rng = np.random.default_rng(5)
    obj = np.zeros(60, np.int32)
    q, t = identity_pose()
    mask = object_edit = None
    if edit:
        obj = rng.integers(0, 2, 60).astype(np.int32)
        q = np.tile(np.array([[0.05, -0.02, 0.01, 1.0]], np.float32), (2, 1))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        t = (rng.normal(size=(2, 3)) * 0.1).astype(np.float32)
        qe = np.array([[0.1, 0.0, 0.2, 1.0], [0.0, 0.3, 0.0, 1.0]],
                      np.float32)
        object_edit = tuple(torch.as_tensor(x, device=device) for x in (
            qe / np.linalg.norm(qe, axis=1, keepdims=True),
            rng.uniform(0.7, 1.3, (2, 3)).astype(np.float32),
            (rng.normal(size=(2, 3)) * 0.1).astype(np.float32)))
        mask = sh_band_mask(1, device=device)
    pc, feats, obj, q, t = (torch.as_tensor(x, device=device)
                            for x in (pc, feats, obj, q, t))
    invalid = torch.zeros(60, dtype=torch.int8, device=device)
    invalid[:6] = 1
    q_cam, t_cam = inverse_SE3_qt(q, t)
    return (pc, feats, invalid, obj, q_cam, t_cam, t,
            CameraInfo(camera_intrinsics(), 32, 32), mask, object_edit)


@pytest.mark.parametrize("edit", [False, True], ids=["k1", "k2_edit_sh"])
def test_projection_kernels_match_plain(cuda, edit):
    """P1 against compute_point_attributes + blend_logw: the masks and the
    non-finite count identical, the columns at rtol 1e-5 / atol 1e-6 (the
    same float32 operations in the same order); P2 against
    project_points_backward_torch at rtol 1e-4 / atol 1e-5 of each
    gradient column's scale; one launch each."""
    pc, feats, invalid, obj, q_cam, t_cam, t, cam, mask, object_edit = \
        _projection_case(edit, cuda)
    inputs = PC.projection_inputs(q_cam, t_cam, t, cam, 0.1, 100.0, mask,
                                  object_edit)
    before = _build.launch_counts.copy()
    got, logw = PC.project_forward(pc, feats, invalid, obj, inputs)
    torch.cuda.synchronize()
    assert _build.launch_counts["project_forward"] == \
        before["project_forward"] + 1
    want = P.compute_point_attributes(pc, feats, invalid, obj, q_cam, t_cam,
                                      t, cam, 0.1, 100.0, mask,
                                      object_edit=object_edit)
    for field in ("in_frustum", "emit", "nonfinite_points"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert 0 < int(got.emit.sum()) < 60
    pairs = [(getattr(got, f), getattr(want, f)) for f in PC.FLOAT_ROWS[:-1]]
    pairs.append((logw, P.blend_logw(want.rescale,
                                     want.alpha_after_activation)))
    for a, b in pairs:
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    cot = torch.as_tensor(np.random.default_rng(6).normal(
        size=(9, 60)).astype(np.float32), device=cuda)
    got = PC.project_backward(pc, feats, obj, inputs, cot)
    torch.cuda.synchronize()
    assert _build.launch_counts["project_backward"] == \
        before["project_backward"] + 1
    want = P.project_points_backward_torch(pc, feats, obj, q_cam, t_cam, t,
                                           cam, 0.1, cot, mask,
                                           object_edit=object_edit)
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert np.isfinite(a).all() and np.isfinite(b).all()
        for col in range(b.shape[1]):
            np.testing.assert_allclose(
                a[:, col], b[:, col], rtol=1e-4,
                atol=1e-5 * float(np.abs(b[:, col]).max()))


def test_rasterize_with_vjp_launches_the_projection_kernels(cuda):
    """One training view on the card: P1 once in the forward, P2 once in
    vjp_fn, and the gradients of the CPU's plain path at rtol 2e-3 /
    atol 1e-4."""
    seed, alpha, _, cfg = AB_CASES[0]
    grads = []
    for device in (cuda, torch.device("cpu")):
        _, _, _, (scene, q, t) = _inputs(seed, alpha, cfg, device)
        _build.reset_launch_counts()
        _, vjp_fn = rasterize_with_vjp(*scene, q, t,
                                       CameraInfo(camera_intrinsics(), 32,
                                                  32),
                                       RasterizerConfig(**cfg))
        gp, gf, _ = vjp_fn(torch.ones((32, 32, 3), device=device))
        want = 1 if device.type == "cuda" else 0
        assert (_build.launch_counts["project_forward"],
                _build.launch_counts["project_backward"]) == (want, want)
        grads.append((gp.cpu().numpy(), gf.cpu().numpy()))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


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
    before = _build.launch_counts["blend_backward"]
    got = [x.cpu().numpy() for x in BC.blend_backward(*args, **kw)]
    torch.cuda.synchronize()
    assert _build.launch_counts["blend_backward"] == before + 1
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


def test_boundary_fixture_past_2_24_columns(cuda):
    """The long-segment fixture at column offset 2**24 - 3 of a slab of
    2**24 - 3 + 9,242 columns (its tiles straddle column 2**24): K2's int32
    `last` is the offset-0 run's plus the offset exactly, and its other
    rows are bitwise the offset-0 run's; K3's gradients at the shifted
    columns and its magnitude image are bitwise the offset-0 run's (the
    same keys, chunks and order), the other columns 0; and K3 matches its
    plain version there at rtol 2e-3 / atol 1e-4, counts statistically."""
    slabs, starts, ends = long_segment_slab(BC.CHUNK_KEYS)
    kw = dict(num_tiles=NUM_TILES, tiles_per_row=TILES_PER_ROW)
    base = (slabs["wide16"].to(cuda), starts.to(cuda), ends.to(cuda))
    wide = shifted_slab(*base, BOUNDARY_OFFSET)
    out0, last0 = BC.blend_forward_with_last(*base, **kw)
    out1, last1 = BC.blend_forward_with_last(*wide, **kw)
    assert torch.equal(last1, torch.where(last0 > 0, last0 + BOUNDARY_OFFSET,
                                          last0))
    assert bool((last1.long() > 2 ** 24 + 1).any())
    # a float32 row would have moved some of them
    assert bool((last1.float().long() != last1.long()).any())
    rows = [r for r in range(8) if r != BC.OUT_LAST_EFF]
    assert torch.equal(out1[:, rows], out0[:, rows])
    rng = np.random.default_rng(3)
    pixel_in = torch.zeros((NUM_TILES, 8, 256), device=cuda)
    pixel_in[:, 0:3] = torch.as_tensor(
        rng.normal(size=(NUM_TILES, 3, 256)).astype(np.float32), device=cuda)
    pixel_in[:, 3:6] = out0[:, 0:3]
    g0, m0 = BC.blend_backward(*base, pixel_in, **kw, last=last0)
    g1, m1 = BC.blend_backward(*wide, pixel_in, **kw, last=last1)
    assert torch.equal(g1[:, BOUNDARY_OFFSET:], g0)
    assert torch.equal(m1, m0)
    assert not bool(g1[:, :BOUNDARY_OFFSET].any())
    ref = BC.blend_backward_torch(*wide, pixel_in, **kw, last=last1)
    got = g1[:, BOUNDARY_OFFSET:].cpu().numpy()
    want = ref[0][:, BOUNDARY_OFFSET:].cpu().numpy()
    float_rows = [r for r in BC.GRAD_ROWS if r != BC.GROW_NUM_PIXELS]
    np.testing.assert_allclose(got[float_rows], want[float_rows], rtol=RTOL,
                               atol=ATOL)
    assert_counts_close(want[BC.GROW_NUM_PIXELS], got[BC.GROW_NUM_PIXELS])
    np.testing.assert_allclose(m1.cpu().numpy(), ref[1].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


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


def test_batch_steps_on_card_match_cpu(cuda, tmp_path):
    """Two batch steps of two views (the port's batch path, no process
    group) on the card and on the CPU: the losses to 1e-4 relative, every
    state array at rtol 2e-3 / atol 1e-4; K2 and K3 launch once per view."""
    write_dataset(str(tmp_path))
    before = _build.launch_counts.copy()
    gpu = batch_step_state(cuda, str(tmp_path))
    torch.cuda.synchronize()
    for name in ("blend_forward", "blend_backward"):
        assert _build.launch_counts[name] - before[name] == 4, name
    cpu = batch_step_state(torch.device("cpu"), str(tmp_path))
    np.testing.assert_allclose(gpu["losses"], cpu["losses"], rtol=1e-4)
    assert gpu["state"].keys() == cpu["state"].keys()
    for k in cpu["state"]:
        np.testing.assert_allclose(gpu["state"][k], cpu["state"][k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("n", [4_160_000, 1_000_003])
@pytest.mark.parametrize("case", list(OPTIMIZER_CASES))
def test_optimizer_kernel_matches_plain(cuda, case, n):
    """The optimizer kernel bit for bit equal to its plain version on the
    card, the count of zeroed slots included, at the 2.08M training cell's
    4,160,000 slots and at an odd count; one launch a call."""
    args, kwargs = optimizer_inputs(case, n, cuda, seed=n)
    before = _build.launch_counts["optimizer_update"]
    got = TA.optimizer_update(*args, **kwargs)
    torch.cuda.synchronize()
    assert _build.launch_counts["optimizer_update"] == before + 1
    want = TA.optimizer_update_torch(*args, **kwargs)
    assert_bitwise_equal(tuple(got), tuple(want), case)
    c = OPTIMIZER_CASES[case]
    assert (int(want.nonfinite_grad_rows) > 0) == bool(
        c.get("bad_feats") or c.get("bad_pc"))


@pytest.mark.parametrize("case", list(RAW_QUATERNION_CASES))
def test_optimizer_kernel_matches_plain_on_stored_quaternions(cuda, case):
    """The optimizer kernel bit for bit equal to its plain version on the
    card on stored quaternions at norms from 1e-3 to 1e3 (the cases of
    test_optimizer_update_on_stored_quaternions_matches_the_parent), and on
    a few stored quaternions that are not finite: the normalization in the
    kernel's registers rounds as the plain version's torch ops do, and a
    slot whose norm is not finite has its feature gradient row zeroed."""
    (args, kwargs), _ = raw_quaternion_inputs(case, 1_000_003, cuda,
                                              seed=17)
    feats = args[0]
    feats[10::100_000, 0] = float("nan")
    feats[20::100_000, 1] = float("inf")
    feats[30::100_000, 3] = float("-inf")
    got = TA.optimizer_update(*args, **kwargs)
    want = TA.optimizer_update_torch(*args, **kwargs)
    assert_bitwise_equal(tuple(got), tuple(want), case)
    assert int(want.nonfinite_grad_rows) >= 30


def test_optimizer_kernel_launches_once_a_step(cuda, tmp_path):
    """One optimizer kernel launch a step on the card: a single-view step
    and two batch steps."""
    write_dataset(str(tmp_path))
    before = _build.launch_counts["optimizer_update"]
    one_step_state(str(tmp_path), "cuda")
    assert _build.launch_counts["optimizer_update"] == before + 1
    batch_step_state(cuda, str(tmp_path))
    assert _build.launch_counts["optimizer_update"] == before + 3


@pytest.mark.parametrize("band", [0, 3])
@pytest.mark.parametrize("direct", [False, True],
                         ids=["no_direct", "direct"])
@pytest.mark.parametrize("n", [1, 13, 4097, 1_000_003])
def test_accumulate_view_kernel_matches_plain(cuda, n, direct, band):
    """The accumulation kernel's running sums bit for bit the plain
    version's on the card after each of 4 views (the first view and later
    ones, B = 1 to 4), from sums that start as NaN: slot counts whose
    vectors end inside the kernel's last block and its unrolled stride,
    negative zeros, NaN and infinite rows, with and without a direct
    gradient, SH bands 0 and 3; one launch a view."""
    views, scale, mask = accumulate_inputs(n, cuda, seed=n + band,
                                           band=band, direct=direct)
    got = (torch.full((n, 56), float("nan"), device=cuda),
           torch.full((n, 3), float("nan"), device=cuda))
    want = tuple(torch.full_like(t, float("nan")) for t in got)
    for k, (raster, g_pc, d) in enumerate(views):
        before = _build.launch_counts["accumulate_view"]
        TA.accumulate_view_gradients(*got, raster, g_pc, scale, mask, d,
                                     first=k == 0)
        torch.cuda.synchronize()
        assert _build.launch_counts["accumulate_view"] == before + 1
        TA.accumulate_view_gradients_torch(*want, raster, g_pc, scale, mask,
                                           d, first=k == 0)
        assert_bitwise_equal(got, want, f"view {k}")


def test_accumulate_view_launches_once_a_view(cuda, tmp_path):
    """One accumulation kernel launch a view of a batch step (one batch
    step of 4 views: 4), none in a single-view step."""
    from taichi_3d_gaussian_splatting_torch import config as tconfig
    from taichi_3d_gaussian_splatting_torch.training import trainer as TT
    write_dataset(str(tmp_path))
    before = _build.launch_counts.copy()
    one_step_state(str(tmp_path), "cuda")
    torch.cuda.synchronize()
    assert _build.launch_counts["accumulate_view"] == before[
        "accumulate_view"]
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig,
                          config_dict(str(tmp_path), batch_size=4)),
        device="cuda")
    images, qs, ts, intrs, cam = batch_views(trainer, [0, 1, 2, 0])
    before = _build.launch_counts.copy()
    trainer.batch_step(images, qs, ts, intrs, 1, cam)
    torch.cuda.synchronize()
    trainer.logger.close()
    assert _build.launch_counts["accumulate_view"] - before[
        "accumulate_view"] == 4
    assert _build.launch_counts["blend_backward"] - before[
        "blend_backward"] == 4


@pytest.mark.parametrize("h, w", [(544, 976), (45, 77)])
def test_image_loss_kernel_matches_plain(cuda, h, w):
    """The image loss kernel against its plain version on the card, at the
    training cells' 976x544 and at a size that is no multiple of its
    32-pixel tile, on renders with values outside [0, 1], ties and exact
    0 and 1: the loss, L1 and 1 - SSIM at rtol 2e-3 / atol 1e-4, the
    gradient of the pixels' sum (3 H W dL/dx; dL/dx itself is ~1e-6) at
    the same tolerances, the clamped render exactly; one launch a call,
    and a second call bit for bit the first."""
    render, gt = loss_images(h, w, seed=h + w, device=cuda)
    before = _build.launch_counts["image_loss"]
    got = TLC.image_loss(render, gt, 0.2)
    torch.cuda.synchronize()
    assert _build.launch_counts["image_loss"] == before + 1
    want = TLC.image_loss_torch(render, gt, 0.2)
    for name in ("loss", "l1", "ssim_loss"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    n = render.numel()
    np.testing.assert_allclose((got.grad.double() * n).cpu().numpy(),
                               (want.grad.double() * n).cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got.image, want.image)
    assert_bitwise_equal(tuple(TLC.image_loss(render, gt, 0.2)), tuple(got))


def test_image_loss_launches_once_a_step_without_sync(cuda, tmp_path):
    """One image loss launch a training step on the card, and the step's
    loss stage (from the forward blend's mark to the loss's, the
    regularizer off as in the benchmark's cells) runs under
    torch.cuda.set_sync_debug_mode("error"): no host sync is left in it."""
    from taichi_3d_gaussian_splatting_torch import config as tconfig
    from taichi_3d_gaussian_splatting_torch.training import trainer as TT
    write_dataset(str(tmp_path))
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, config_dict(
            str(tmp_path),
            loss_function_config={"enable_regularization": False})),
        device="cuda")
    item = trainer.train_dataset[0]
    args = [torch.as_tensor(a, device=cuda) for a in (
        item.image, item.q_pointcloud_camera, item.t_pointcloud_camera)]
    marks = []

    def mark(name):
        marks.append(name)
        if name == "forward blend":
            torch.cuda.set_sync_debug_mode("error")
        elif name == "loss":
            torch.cuda.set_sync_debug_mode(0)

    trainer.step(*args, 0, item.camera_info)
    torch.cuda.synchronize()
    before = _build.launch_counts["image_loss"]
    try:
        trainer.step(*args, 0, item.camera_info, mark=mark)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    trainer.step(*args, 0, item.camera_info)
    torch.cuda.synchronize()
    trainer.logger.close()
    assert _build.launch_counts["image_loss"] == before + 2
    assert marks.index("forward blend") + 1 == marks.index("loss")


def test_viewer_on_card_matches_cpu(cuda, tmp_path):
    """The viewer's frames on the card against the CPU after a camera key,
    an object key and a hide; each frame launches K1 once."""
    from taichi_3d_gaussian_splatting_torch.visualizer import VisualizerState
    paths = []
    for seed in (0, 1):
        pc, feats = random_scene(30, seed=seed)
        path = str(tmp_path / f"scene_{seed}.parquet")
        GaussianPointCloudScene.from_numpy(
            pc, feats, np.zeros(30), np.zeros(30)).to_parquet(path)
        paths.append(path)
    states = [VisualizerState(paths, 32, 32, 25.0, device=d)
              for d in (cuda, "cpu")]
    for key in ("", "w", "1", "d", "h"):
        for state in states:
            if key:
                state.handle_key(key)
        before = _build.launch_counts["blend_forward_rgb"]
        gpu = states[0].frame().cpu().numpy()
        assert _build.launch_counts["blend_forward_rgb"] == before + 1
        np.testing.assert_allclose(gpu, states[1].frame().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_loaders_default_to_the_card(cuda, tmp_path):
    """A scene loaded with no device lands on cuda:0, as do the controller
    state and the dry run's default."""
    from taichi_3d_gaussian_splatting_torch.training.controller import (
        ControllerState)
    pc, feats = random_scene(30)
    path = str(tmp_path / "scene.parquet")
    GaussianPointCloudScene.from_numpy(pc, feats, np.zeros(30), np.zeros(30),
                                       "cpu").to_parquet(path)
    scene = GaussianPointCloudScene.from_parquet(path)
    assert scene.point_cloud.device == torch.device("cuda", 0)
    assert ControllerState.zeros(4).accumulated_num_pixels.is_cuda


def test_trainer_trace_shows_the_kernels(cuda, tmp_path):
    """A profiled 32x32 run on the card: the trace file under
    <logs>/profile/ holds the two ranges and the forward and backward
    blend and projection kernels once per step, the image loss kernel once
    a step and no cuDNN convolution."""
    from taichi_3d_gaussian_splatting_torch import config as tconfig
    from taichi_3d_gaussian_splatting_torch.training import trainer as TT
    from taichi_3d_gaussian_splatting_torch.utils import profiling as P
    from torch_train_fixtures import config_dict
    write_dataset(str(tmp_path))
    d = config_dict(str(tmp_path), num_iterations=5, val_interval=10 ** 6,
                    enable_profiler=True, profiler_start_iteration=2,
                    profiler_num_steps=2)
    trainer = TT.GaussianPointCloudTrainer(
        tconfig.from_dict(TT.TrainConfig, d), device=cuda)
    trainer.train()
    trainer.logger.close()
    files = P.trace_files(d["summary_writer_log_dir"])
    assert len(files) == 1
    summary = P.summarize_trace(P.load_events(files[0]))
    assert summary["ranges"] == 2 and summary["kernels"] > 0
    for fam in ("forward", "backward"):
        assert summary["blend"][fam]["launches_per_range"] == 1.0, fam
        assert summary["projection"][fam]["launches_per_range"] == 1.0, fam
    assert summary["optimizer"]["launches_per_range"] == 1.0
    names = [P.kernel_base_name(e["name"]) for e in P.load_events(files[0])
             if e.get("ph") == "X" and e.get("cat") == "kernel"]
    assert names.count("image_loss_kernel") == 2
    assert names.count("image_loss_finish_kernel") == 2
    assert not [n for n in names if "conv" in n.lower() or "dgrad" in n]
