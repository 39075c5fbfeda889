"""The projection's VJP on the CPU: ops/projection.py::
project_points_backward_torch (the plain version of the backward kernel
P2) against jax.vjp of the JAX package's compute_point_attributes followed
by its _blend_inputs_from_attrs, and against torch autograd of the port's
plain forward (compute_point_attributes + blend_logw); and the autograd
node ops/projection_cuda.py::ProjectPoints on CPU tensors.

Tolerances, per gradient column (a position axis or a feature index), with
scale = the largest |reference| in that column:
- against JAX: rtol 1e-4, atol 1e-5 * scale. Both sides are float32
  chains of a few hundred roundings over different operation orders (XLA
  fuses and reassociates); 1e-4 is tests/test_torch_vjp.py's projection
  tolerance.
- against autograd: rtol 1e-5, atol 1e-6 * scale: the same float32
  formulas, summed in another order.

A clamp whose input lies exactly at its floor passes the gradient in the
port (torch.clamp's rule); JAX's jnp.maximum splits a tie evenly. Rows with
such a tie (zc at the near plane, the filtered determinant at
COV_LOW_PASS^2) are held against autograd only, and the fixtures that make
them say so."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.camera import CameraInfo as JCamera
from taichi_3d_gaussian_splatting_tpu.ops import projection as jproj
from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as JR
from taichi_3d_gaussian_splatting_tpu.ops.transforms import (
    inverse_SE3_qt as j_inverse)
from taichi_3d_gaussian_splatting_torch.camera import CameraInfo as TCamera
from taichi_3d_gaussian_splatting_torch.ops import _build
from taichi_3d_gaussian_splatting_torch.ops import projection as tproj
from taichi_3d_gaussian_splatting_torch.ops import projection_cuda as PC
from taichi_3d_gaussian_splatting_torch.ops.gaussian import COV_LOW_PASS
from taichi_3d_gaussian_splatting_torch.ops.sh import sh_band_mask
from taichi_3d_gaussian_splatting_torch.ops.transforms import (
    inverse_SE3_qt as t_inverse)
from taichi_3d_gaussian_splatting_torch.training.adam_cuda import (
    contain_gradients)

from torch_port_fixtures import (AB_CASES, FAR, NEAR, camera_intrinsics,
                                 identity_pose, random_scene)

torch.set_num_threads(1)
JAX_TOL = (1e-4, 1e-5)
AUTOGRAD_TOL = (1e-5, 1e-6)
N = 60


def _pose(rng, k, spread):
    q = rng.normal(size=(k, 4)).astype(np.float32) * spread
    q[:, 3] = 1.0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, (rng.normal(size=(k, 3)) * spread).astype(np.float32)


def _case(kind):
    """numpy inputs of one case: (pc, feats, invalid, obj, q, t), kwargs of
    compute_point_attributes (color_sh_mask, object_edit), and the (9, N)
    cotangents."""
    rng = np.random.default_rng(11)
    seed, alpha = 3, 2.0
    if kind.startswith("ab-"):
        seed, alpha = next((s, a) for s, a, label, _ in AB_CASES
                           if label == kind[3:])
    pc, feats = random_scene(N, seed=seed, alpha=alpha)
    invalid = np.zeros(N, np.int8)
    obj = np.zeros(N, np.int32)
    q, t = identity_pose()
    kwargs = {}
    cot = rng.normal(size=(9, N)).astype(np.float32)
    if kind == "k3":
        obj = rng.integers(0, 3, N).astype(np.int32)
        q, t = _pose(rng, 3, 0.1)
    elif kind == "object_edit_k2":
        obj = rng.integers(0, 2, N).astype(np.int32)
        q, t = _pose(rng, 2, 0.1)
        qe, te = _pose(rng, 2, 0.2)
        se = rng.uniform(0.7, 1.3, (2, 3)).astype(np.float32)
        kwargs["object_edit"] = (qe, se, te)
    elif kind.startswith("sh_band"):
        kwargs["color_sh_mask"] = sh_band_mask(int(kind[-1])).numpy()
        q, t = _pose(rng, 1, 0.1)
    elif kind == "near_plane":
        # behind the camera, at it, inside the near plane, exactly on it
        # (ties: identity pose, so zc is the point's z) and just past it
        pc[:8, 2] = [-1.0, 0.0, 0.05, NEAR, NEAR, 0.099, NEAR + 1e-3, 0.5]
    elif kind == "det_floor":
        # tiny splats: the filtered determinant rounds to the floor (ties);
        # long thin splats: fa fc - b^2 cancels below it
        feats[:8, 4:7] = -20.0
        feats[8:14, 4:7] = [12.0, -12.0, -12.0]
        q, t = _pose(rng, 1, 0.1)
    elif kind == "padded":
        # zero-quaternion pool slots at the origin, invalid, with no
        # cotangent (they emit no key), and a few with one
        feats[:10] = 0.0
        pc[:10] = 0.0
        invalid[:10] = 1
        cot[:, :6] = 0.0
        q, t = _pose(rng, 1, 0.1)
    elif kind == "invalid20":
        invalid[rng.permutation(N)[: N // 5]] = 1
        q, t = _pose(rng, 1, 0.1)
    return (pc, feats, invalid, obj, q, t), kwargs, cot


CASES = ["ab-a", "ab-b", "ab-c", "k3", "object_edit_k2", "sh_band0",
         "sh_band1", "sh_band2", "sh_band3", "near_plane", "det_floor",
         "padded", "invalid20"]
# the cases whose fixtures put clamp inputs exactly at their floor
TIES = {"near_plane", "det_floor"}


def _torch_args(arrays, kwargs):
    pc, feats, invalid, obj, q, t = (torch.as_tensor(x) for x in arrays)
    q_cam, t_cam = t_inverse(q, t)
    tkw = {k: (tuple(torch.as_tensor(x) for x in v) if isinstance(v, tuple)
               else torch.as_tensor(v)) for k, v in kwargs.items()}
    return pc, feats, invalid, obj, q_cam, t_cam, t, tkw


def _plain_backward(arrays, kwargs, cot):
    pc, feats, _, obj, q_cam, t_cam, t, tkw = _torch_args(arrays, kwargs)
    gp, gf = tproj.project_points_backward_torch(
        pc, feats, obj, q_cam, t_cam, t, TCamera(camera_intrinsics(), 32, 32),
        NEAR, torch.as_tensor(cot), **tkw)
    return gp.numpy(), gf.numpy()


def _autograd(arrays, kwargs, cot):
    pc, feats, invalid, obj, q_cam, t_cam, t, tkw = _torch_args(arrays,
                                                                kwargs)
    pc.requires_grad_(True)
    feats.requires_grad_(True)
    a = tproj.compute_point_attributes(
        pc, feats, invalid, obj, q_cam, t_cam, t,
        TCamera(camera_intrinsics(), 32, 32), NEAR, FAR, **tkw)
    cols = (a.u, a.v, a.conic_a, a.conic_b, a.conic_c,
            tproj.blend_logw(a.rescale, a.alpha_after_activation),
            a.color_r, a.color_g, a.color_b)
    gp, gf = torch.autograd.grad(cols, (pc, feats),
                                 tuple(torch.as_tensor(c) for c in cot))
    return gp.numpy(), gf.numpy()


def _jax_vjp(arrays, kwargs, cot):
    pc, feats, invalid, obj, q, t = (jnp.asarray(x) for x in arrays)
    jq, jt = j_inverse(q, t)
    jkw = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
               else jnp.asarray(v)) for k, v in kwargs.items()}

    def cols(p, f):
        attrs = jproj.compute_point_attributes(
            p, f, invalid, obj, jq, jt, t, JCamera(camera_intrinsics(), 32, 32),
            NEAR, FAR, **jkw)
        return JR._blend_inputs_from_attrs(attrs)[0]

    _, fn = jax.vjp(cols, pc, feats)
    gp, gf = fn(tuple(jnp.asarray(c) for c in cot))
    return np.asarray(gp), np.asarray(gf)


def _clamp_rows(arrays, kwargs):
    """(rows whose zc lies exactly at the near plane or whose filtered
    determinant lies exactly at its floor, rows strictly below either)."""
    pc, feats, invalid, obj, q_cam, t_cam, t, tkw = _torch_args(arrays,
                                                                kwargs)
    inputs = PC.projection_inputs(q_cam, t_cam, t,
                                  TCamera(camera_intrinsics(), 32, 32), NEAR,
                                  FAR, **tkw)
    f = tproj._forward_terms(pc, feats, invalid, obj, inputs.table,
                             inputs.edit, inputs.camera_info, NEAR, FAR,
                             inputs.color_sh_mask)
    floor = torch.tensor(COV_LOW_PASS * COV_LOW_PASS, dtype=torch.float32)
    near = torch.tensor(NEAR, dtype=torch.float32)
    return (((f.zc == near) | (f.det_raw == floor)).numpy(),
            ((f.zc < near) | (f.det_raw < floor)).numpy())


def _assert_columns_close(got, want, tol, what):
    rtol, atol = tol
    for col in range(want.shape[1]):
        scale = float(np.abs(want[:, col]).max(initial=0.0))
        np.testing.assert_allclose(got[:, col], want[:, col], rtol=rtol,
                                   atol=atol * scale,
                                   err_msg=f"{what} column {col}")


@pytest.mark.parametrize("kind", CASES)
def test_backward_matches_jax_vjp_and_autograd(kind):
    arrays, kwargs, cot = _case(kind)
    got = _plain_backward(arrays, kwargs, cot)
    auto = _autograd(arrays, kwargs, cot)
    jgrads = _jax_vjp(arrays, kwargs, cot)
    ties, below = _clamp_rows(arrays, kwargs)
    assert bool(ties.any()) == (kind in TIES), ties.nonzero()
    # both such fixtures also put rows strictly below a floor (no gradient)
    assert kind not in TIES or bool(below.any())
    for name, g, a, j in zip(("positions", "features"), got, auto, jgrads):
        assert np.isfinite(g).all(), name
        assert np.abs(g).max() > 0, name
        _assert_columns_close(g, a, AUTOGRAD_TOL, f"{kind} {name} autograd")
        _assert_columns_close(g[~ties], j[~ties], JAX_TOL,
                              f"{kind} {name} jax")
    if kind == "padded":
        # no cotangent: exactly no gradient
        assert not got[0][:6].any() and not got[1][:6].any()


def test_near_plane_ties_differ_from_jax_in_z_only():
    """At zc == near the port passes the whole gradient through the clamp
    and JAX half of it: with the identity pose only the z position column
    differs, by the zc chain's half."""
    arrays, kwargs, cot = _case("near_plane")
    gp, gf = _plain_backward(arrays, kwargs, cot)
    jp, jf = _jax_vjp(arrays, kwargs, cot)
    tie = np.zeros(N, bool)
    tie[[3, 4]] = True
    assert (_clamp_rows(arrays, kwargs)[0] == tie).all()
    _assert_columns_close(gf[tie], jf[tie], JAX_TOL, "tie features")
    _assert_columns_close(gp[tie][:, :2], jp[tie][:, :2], JAX_TOL, "tie x, y")
    assert not np.allclose(gp[tie][:, 2], jp[tie][:, 2], rtol=1e-3)


def test_nonfinite_features_match_autograd_row_by_row():
    """A poisoned scale (inf), a poisoned SH coefficient (NaN) and a point
    at the ray origin (its direction's rsqrt backward is 0 * inf): the
    same rows are non-finite as under autograd, and after the trainer's
    containment the gradients agree with autograd and with JAX."""
    arrays, kwargs, cot = _case("ab-a")
    arrays[1][10, 4] = np.inf
    arrays[1][11, 20] = np.nan
    arrays[0][12] = 0.0
    got = _plain_backward(arrays, kwargs, cot)
    auto = _autograd(arrays, kwargs, cot)
    jgrads = _jax_vjp(arrays, kwargs, cot)
    for g, a in zip(got, auto):
        np.testing.assert_array_equal(np.isfinite(g).all(1),
                                      np.isfinite(a).all(1))
    bad = ~(np.isfinite(got[0]).all(1) & np.isfinite(got[1]).all(1))
    assert sorted(np.nonzero(bad)[0]) == [10, 11, 12]
    contained = {}
    for name, (gp, gf) in (("port", got), ("autograd", auto),
                           ("jax", jgrads)):
        cp, cf, count = contain_gradients(torch.tensor(gp),
                                          torch.tensor(gf))
        assert int(count) == 3, name
        contained[name] = (cp.numpy(), cf.numpy())
    for ref, tol in (("autograd", AUTOGRAD_TOL), ("jax", JAX_TOL)):
        for g, w in zip(contained["port"], contained[ref]):
            _assert_columns_close(g, w, tol, f"contained vs {ref}")


def test_project_points_on_cpu_takes_the_plain_versions():
    """ProjectPoints on CPU tensors: its outputs are compute_point_
    attributes' and blend_logw's bitwise, its backward is
    project_points_backward_torch's bitwise, and no kernel launch is
    counted."""
    arrays, kwargs, cot = _case("object_edit_k2")
    _build.reset_launch_counts()
    pc, feats, invalid, obj, q_cam, t_cam, t, tkw = _torch_args(arrays,
                                                                kwargs)
    cam = TCamera(camera_intrinsics(), 32, 32)
    pc.requires_grad_(True)
    feats.requires_grad_(True)
    attrs, cols = PC.project_points(pc, feats, invalid, obj, q_cam, t_cam, t,
                                    cam, NEAR, FAR, **tkw)
    want = tproj.compute_point_attributes(pc.detach(), feats.detach(),
                                          invalid, obj, q_cam, t_cam, t, cam,
                                          NEAR, FAR, **tkw)
    for field in want._fields:
        assert torch.equal(getattr(attrs, field), getattr(want, field)), field
    assert torch.equal(cols[5], tproj.blend_logw(
        want.rescale, want.alpha_after_activation))
    assert [c.requires_grad for c in cols] == [True] * 9
    for field in ("depth", "rescale", "radii", "in_frustum", "emit",
                  "radius_x", "radius_y", "nonfinite_points"):
        assert not getattr(attrs, field).requires_grad, field
    gp, gf = torch.autograd.grad(cols, (pc, feats),
                                 tuple(torch.as_tensor(c) for c in cot))
    wp, wf = _plain_backward(arrays, kwargs, cot)
    np.testing.assert_array_equal(gp.numpy(), wp)
    np.testing.assert_array_equal(gf.numpy(), wf)
    assert sum(_build.launch_counts.values()) == 0


def test_cotangent_rows_view_the_routing_buffer():
    """Nine consecutive rows of one buffer (as the routing leaves them)
    reach the backward as a view; anything else is stacked, None as 0."""
    buf = torch.arange(11 * 5, dtype=torch.float32).reshape(11, 5)
    rows = PC._cotangent_rows(list(buf[:9]), buf[0])
    assert rows.data_ptr() == buf.data_ptr() and torch.equal(rows, buf[:9])
    mixed = [buf[i] for i in (0, 2, 1, 3, 4, 5, 6, 7, 8)]
    assert torch.equal(PC._cotangent_rows(mixed, buf[0]),
                       torch.stack(mixed))
    sparse = [None] + list(buf[1:9])
    stacked = PC._cotangent_rows(sparse, buf[0])
    assert not stacked[0].any() and torch.equal(stacked[1:], buf[1:9])


def test_pose_gradients_and_other_devices_are_refused():
    arrays, kwargs, _ = _case("ab-a")
    pc, feats, invalid, obj, q_cam, t_cam, t, _ = _torch_args(arrays, kwargs)
    cam = TCamera(camera_intrinsics(), 32, 32)
    with pytest.raises(ValueError, match="poses"):
        PC.project_points(pc, feats, invalid, obj,
                          q_cam.clone().requires_grad_(True), t_cam, t, cam,
                          NEAR, FAR)
    meta = torch.device("meta")
    inputs = PC.projection_inputs(q_cam.to(meta), t_cam.to(meta), t.to(meta),
                                  cam, NEAR, FAR)
    with pytest.raises(RuntimeError, match="cpu or cuda"):
        PC.project_forward(pc.to(meta), feats.to(meta), invalid.to(meta),
                           obj.to(meta), inputs)
    with pytest.raises(RuntimeError, match="cpu or cuda"):
        PC.project_backward(pc.to(meta), feats.to(meta), obj.to(meta),
                            inputs, torch.zeros((9, N), device=meta))
    assert sum(_build.launch_counts.values()) == 0
