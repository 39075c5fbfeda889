"""Port parity: ops/projection.py::compute_point_attributes against the JAX
package, every PointAttributes field, at rtol 1e-5 / atol 1e-6; the masks
(in_frustum, emit) and the non-finite count exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.camera import CameraInfo as JCamera
from taichi_3d_gaussian_splatting_tpu.ops import projection as jproj
from taichi_3d_gaussian_splatting_tpu.ops.transforms import (
    inverse_SE3_qt as j_inverse)
from taichi_3d_gaussian_splatting_torch.camera import CameraInfo as TCamera
from taichi_3d_gaussian_splatting_torch.ops import projection as tproj
from taichi_3d_gaussian_splatting_torch.ops.transforms import (
    inverse_SE3_qt as t_inverse)

from torch_port_fixtures import FAR, NEAR, camera_intrinsics, random_scene

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
EXACT = ("in_frustum", "emit", "nonfinite_points")


def _case(kind):
    """numpy inputs of compute_point_attributes for one case."""
    rng = np.random.default_rng(3)
    n = 80
    pc, feats = random_scene(n, seed=5)
    # a few points behind the camera and off-screen exercise the clamps
    pc[:4, 2] = [-1.0, 0.0, 0.05, 0.1]
    pc[4:8, 0] = [-6.0, 6.0, 3.0, -3.0]
    invalid = np.zeros(n, np.int8)
    obj = np.zeros(n, np.int32)
    k = 1
    if kind == "invalid20":
        invalid[rng.permutation(n)[: n // 5]] = 1
    if kind in ("k2", "object_edit_k2"):
        k = 2
        obj = rng.integers(0, 2, n).astype(np.int32)
    q = rng.normal(size=(k, 4)).astype(np.float32) * 0.1
    q[:, 3] = 1.0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = (rng.normal(size=(k, 3)) * 0.1).astype(np.float32)
    kwargs = {}
    if kind == "sh_mask":
        kwargs["color_sh_mask"] = np.array([1, 1, 1, 1] + [0] * 12,
                                           np.float32)
    if kind.startswith("object_edit"):
        qe = rng.normal(size=(k, 4)).astype(np.float32) * 0.2
        qe[:, 3] = 1.0
        se = rng.uniform(0.7, 1.3, (k, 3)).astype(np.float32)
        te = (rng.normal(size=(k, 3)) * 0.1).astype(np.float32)
        kwargs["object_edit"] = (qe, se, te)
    return (pc, feats, invalid, obj, q, t), kwargs


@pytest.mark.parametrize("kind", ["k1", "k2", "sh_mask", "object_edit_k1",
                                  "object_edit_k2", "invalid20"])
def test_point_attributes_match_jax(kind):
    (pc, feats, invalid, obj, q, t), kwargs = _case(kind)
    K = camera_intrinsics()

    jq, jt = j_inverse(jnp.asarray(q), jnp.asarray(t))
    jkw = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
               else jnp.asarray(v)) for k, v in kwargs.items()}
    ja = jproj.compute_point_attributes(
        jnp.asarray(pc), jnp.asarray(feats), jnp.asarray(invalid),
        jnp.asarray(obj), jq, jt, jnp.asarray(t), JCamera(K, 32, 32),
        NEAR, FAR, **jkw)

    tq, tt = t_inverse(torch.as_tensor(q), torch.as_tensor(t))
    tkw = {k: (tuple(torch.as_tensor(x) for x in v) if isinstance(v, tuple)
               else torch.as_tensor(v)) for k, v in kwargs.items()}
    ta = tproj.compute_point_attributes(
        torch.as_tensor(pc), torch.as_tensor(feats), torch.as_tensor(invalid),
        torch.as_tensor(obj), tq, tt, torch.as_tensor(t), TCamera(K, 32, 32),
        NEAR, FAR, **tkw)

    assert ta._fields == tuple(f for f in ja._fields)
    for field in ja._fields:
        j = np.asarray(getattr(ja, field))
        got = getattr(ta, field).numpy()
        assert got.shape == j.shape, field
        if field in EXACT:
            np.testing.assert_array_equal(got, j, err_msg=field)
        else:
            np.testing.assert_allclose(got, j, rtol=RTOL, atol=ATOL,
                                       err_msg=field)
    # the fixture exercises both sides of every mask
    assert 0 < int(ta.emit.sum()) < len(pc)
    if kind == "invalid20":
        assert not bool(ta.in_frustum[torch.as_tensor(invalid) == 1].any())


def test_nonfinite_points_are_culled_and_counted():
    (pc, feats, invalid, obj, q, t), _ = _case("k1")
    feats = feats.copy()
    feats[10, 4] = np.inf          # poisoned scale
    feats[11, 20] = np.nan         # poisoned SH coefficient
    K = camera_intrinsics()
    jq, jt = j_inverse(jnp.asarray(q), jnp.asarray(t))
    ja = jproj.compute_point_attributes(
        jnp.asarray(pc), jnp.asarray(feats), jnp.asarray(invalid),
        jnp.asarray(obj), jq, jt, jnp.asarray(t), JCamera(K, 32, 32),
        NEAR, FAR)
    tq, tt = t_inverse(torch.as_tensor(q), torch.as_tensor(t))
    ta = tproj.compute_point_attributes(
        torch.as_tensor(pc), torch.as_tensor(feats), torch.as_tensor(invalid),
        torch.as_tensor(obj), tq, tt, torch.as_tensor(t), TCamera(K, 32, 32),
        NEAR, FAR)
    assert int(ta.nonfinite_points) == int(ja.nonfinite_points) == 2
    np.testing.assert_array_equal(ta.emit.numpy(), np.asarray(ja.emit))
    assert not bool(ta.emit[10]) and not bool(ta.emit[11])


def test_straight_through_normalize_gradient():
    """Value q/|q|, jacobian diag(1/|q|): the gradient of sum(q_n) is 1/|q|
    per component, as with jax.lax.stop_gradient on the norm."""
    q = torch.tensor([[0.0, 0.0, 3.0, 4.0]], requires_grad=True)
    cols = tproj.normalize_straight_through_columns(*q.T)
    torch.stack(cols).sum().backward()
    np.testing.assert_allclose(q.grad.numpy(), np.full((1, 4), 0.2),
                               rtol=1e-6)
    np.testing.assert_allclose(torch.stack(cols).detach().numpy().ravel(),
                               [0.0, 0.0, 0.6, 0.8], rtol=1e-6)
