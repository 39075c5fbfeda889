"""Port parity for the per-point helpers of ops/gaussian.py (projection,
jacobian, 3D and projected covariance, conic, density, radii) and for
ops/geometry.py (ray/ellipsoid, point-to-line, ray generation): each
function of the port against its JAX counterpart on the same seeded
inputs, at rtol 1e-5 and an atol of 1e-6 times the output's largest
magnitude (float32 in other evaluation orders); boolean outputs exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from taichi_3d_gaussian_splatting_tpu.camera import CameraInfo as JCamera
from taichi_3d_gaussian_splatting_tpu.ops import gaussian as JG
from taichi_3d_gaussian_splatting_tpu.ops import geometry as JGeo
from taichi_3d_gaussian_splatting_torch.camera import CameraInfo as TCamera
from taichi_3d_gaussian_splatting_torch.ops import gaussian as TG
from taichi_3d_gaussian_splatting_torch.ops import geometry as TGeo

N = 64


def _inputs():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(N, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    log_s = rng.uniform(-2, 0.5, (N, 3)).astype(np.float32)
    xyz = np.stack([rng.uniform(-1, 1, N), rng.uniform(-1, 1, N),
                    rng.uniform(2, 8, N)], 1).astype(np.float32)
    K = np.array([[300.0, 0, 200.0], [0, 320.0, 150.0], [0, 0, 1]],
                 np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_euler("xyz", [0.3, -0.2, 0.1]).as_matrix()
    T[:3, 3] = [0.1, -0.2, 0.3]
    A = rng.normal(size=(N, 2, 2))
    cov = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(2)).astype(np.float32)
    cov[:4, 0, 1] = cov[:4, 1, 0] = 0.0
    xy = rng.uniform(-3, 3, (N, 2)).astype(np.float32)
    mean = rng.uniform(-2, 2, (N, 2)).astype(np.float32)
    return dict(q=q, log_s=log_s, xyz=xyz, K=K, T=T, cov=cov, xy=xy,
                mean=mean)


GAUSSIAN_CASES = {
    "project_points": lambda d: (d["xyz"], d["T"], d["K"]),
    "projective_transform_jacobian": lambda d: (d["K"], d["xyz"]),
    "covariance_3d": lambda d: (d["q"], d["log_s"]),
    "project_covariance": lambda d: (d["q"], d["log_s"], d["T"], d["K"],
                                     d["xyz"]),
    "conic_and_rescale": lambda d: (d["cov"],),
    "density_from_conic": lambda d: (
        d["xy"], d["mean"],
        np.array(JG.conic_and_rescale(jnp.asarray(d["cov"])))),
    "point_radii": lambda d: (d["cov"],),
}


def _assert_close(t, j, name):
    t = t.numpy()
    j = np.asarray(j)
    if j.dtype == bool:
        np.testing.assert_array_equal(t, j, err_msg=name)
        return
    scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=name)


def _compare(tout, jout, name):
    if isinstance(jout, tuple):
        assert len(tout) == len(jout)
        for i, (t, j) in enumerate(zip(tout, jout)):
            _assert_close(t, j, f"{name}[{i}]")
    else:
        _assert_close(tout, jout, name)


@pytest.mark.parametrize("name", list(GAUSSIAN_CASES))
def test_gaussian_helper_matches_jax(name):
    args = GAUSSIAN_CASES[name](_inputs())
    jout = getattr(JG, name)(*(jnp.asarray(a) for a in args))
    tout = getattr(TG, name)(*(torch.as_tensor(a) for a in args))
    _compare(tout, jout, name)


def test_conic_rescale_carries_no_gradient():
    cov = torch.tensor(_inputs()["cov"], requires_grad=True)
    TG.conic_and_rescale(cov)[..., 3].sum().backward()
    assert cov.grad is None or not cov.grad.any()


def test_ray_ellipsoid_matches_jax():
    """Random rays against random ellipsoids, with hits and misses."""
    rng = np.random.default_rng(0)
    n = 500
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    R = Rotation.random(n, rng).as_matrix().astype(np.float32)
    t = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    S = rng.uniform(0.2, 1.5, (n, 3)).astype(np.float32)
    args = (o, d, R, t, S)
    j_hit, j_p = JGeo.intersect_ray_with_ellipsoid(
        *(jnp.asarray(a) for a in args))
    t_hit, t_p = TGeo.intersect_ray_with_ellipsoid(
        *(torch.as_tensor(a) for a in args))
    j_hit = np.asarray(j_hit)
    assert 0 < j_hit.sum() < n
    # a discriminant at the eps edge may flip between the two; none here
    np.testing.assert_array_equal(t_hit.numpy(), j_hit)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(j_p), rtol=1e-5,
                               atol=1e-5)


def test_point_to_line_matches_jax():
    rng = np.random.default_rng(1)
    p, o, d = (rng.normal(size=(N, 3)).astype(np.float32) for _ in range(3))
    _compare(TGeo.get_point_to_line_vector(*map(torch.as_tensor, (p, o, d))),
             JGeo.get_point_to_line_vector(*map(jnp.asarray, (p, o, d))),
             "point_to_line")


def test_ray_generation_matches_jax():
    h, w = 32, 48
    intr = np.array([[40.0, 0, w / 2], [0, 42.0, h / 2], [0, 0, 1]],
                    np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_euler("xyz", [0.2, -0.1, 0.3]).as_matrix()
    T[:3, 3] = [0.5, -1.0, 2.0]
    _compare(TGeo.get_ray_origin_and_direction_from_camera(
        torch.as_tensor(T), TCamera(intr, h, w)),
        JGeo.get_ray_origin_and_direction_from_camera(
            jnp.asarray(T), JCamera(intr, h, w)), "rays from camera")
    T_inv = np.linalg.inv(T).astype(np.float32)
    u = np.array([0.0, 17.0, 47.0], np.float32)
    v = np.array([0.0, 5.0, 31.0], np.float32)
    _compare(TGeo.get_ray_origin_and_direction_by_uv(
        torch.as_tensor(u), torch.as_tensor(v), intr,
        torch.as_tensor(np.broadcast_to(T_inv, (3, 4, 4)).copy())),
        JGeo.get_ray_origin_and_direction_by_uv(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(intr),
            jnp.asarray(np.broadcast_to(T_inv, (3, 4, 4)).copy())),
        "ray by uv")
