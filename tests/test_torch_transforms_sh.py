"""Port parity: quaternion / SE(3) transforms and the SH basis and masks of
taichi_3d_gaussian_splatting_torch against the JAX package, on the same
numpy inputs, at rtol 1e-6."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.ops import sh as jsh
from taichi_3d_gaussian_splatting_tpu.ops import transforms as jtf
from taichi_3d_gaussian_splatting_torch.ops import sh as tsh
from taichi_3d_gaussian_splatting_torch.ops import transforms as ttf

torch.set_num_threads(1)
RTOL, ATOL = 1e-6, 1e-6


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _rotations(rng, n):
    # rotation matrices from random quaternions, plus the four Shepperd
    # branch cases (trace > 0, and each diagonal entry largest)
    R = np.asarray(jtf.rotation_matrix_from_quaternion(
        jnp.asarray(_quats(rng, n))))
    special = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]),
                        np.diag([-1.0, 1.0, -1.0]),
                        np.diag([-1.0, -1.0, 1.0])]).astype(np.float32)
    return np.concatenate([R, special])


def _se3(rng, n):
    T = np.zeros((n, 4, 4), np.float32)
    T[:, :3, :3] = _rotations(rng, n)[:n]
    T[:, :3, 3] = rng.normal(size=(n, 3))
    T[:, 3, 3] = 1.0
    return T


def _both(fn_name, *args, module=("tf",)):
    jmod, tmod = (jtf, ttf) if module == ("tf",) else (jsh, tsh)
    j = getattr(jmod, fn_name)(*(jnp.asarray(a) for a in args))
    t = getattr(tmod, fn_name)(*(torch.as_tensor(a) for a in args))
    return j, t


def _assert_close(j, t):
    if isinstance(j, tuple):
        for a, b in zip(j, t):
            _assert_close(a, b)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("fn_name, make_args", [
    ("quaternion_multiply", lambda r: (_quats(r, 64), _quats(r, 64))),
    ("quaternion_conjugate", lambda r: (_quats(r, 64),)),
    ("quaternion_rotate", lambda r: (_quats(r, 64),
                                     r.normal(size=(64, 3)).astype(
                                         np.float32))),
    ("quaternion_normalize", lambda r: (3 * _quats(r, 64),)),
    ("rotation_matrix_from_quaternion", lambda r: (_quats(r, 64),)),
    ("transform_matrix_from_quaternion_and_translation",
     lambda r: (_quats(r, 64), r.normal(size=(64, 3)).astype(np.float32))),
    ("inverse_SE3", lambda r: (_se3(r, 64),)),
    ("inverse_SE3_qt", lambda r: (_quats(r, 64),
                                  r.normal(size=(64, 3)).astype(np.float32))),
    ("rotation_matrix_to_quaternion", lambda r: (_rotations(r, 64),)),
    ("SE3_to_quaternion_and_translation", lambda r: (_se3(r, 64),)),
])
def test_transform_matches_jax(fn_name, make_args):
    args = make_args(np.random.default_rng(0))
    _assert_close(*_both(fn_name, *args))


def test_quaternion_normalize_eps_floor():
    q = np.zeros((3, 4), np.float32)
    q[0] = [0.0, 0.0, 0.0, 2.0]
    j = jtf.quaternion_normalize(jnp.asarray(q), eps=1e-6)
    t = ttf.quaternion_normalize(torch.as_tensor(q), eps=1e-6)
    _assert_close(j, t)


def test_sh_basis_and_evaluate_match_jax():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(128, 3)).astype(np.float32) * 3.0
    f = rng.normal(size=(128, 16)).astype(np.float32)
    _assert_close(*_both("sh_basis_from_direction", d, module=("sh",)))
    _assert_close(*_both("evaluate_sh", f, d, module=("sh",)))


@pytest.mark.parametrize("band", [0, 1, 2, 3])
def test_sh_masks_match_jax(band):
    np.testing.assert_array_equal(tsh.sh_band_mask(band).numpy(),
                                  np.asarray(jsh.sh_band_mask(band)))
    np.testing.assert_array_equal(
        tsh.feature_sh_band_mask(band).numpy(),
        np.asarray(jsh.feature_sh_band_mask(band)))
    # a 0-d tensor band works too, on its own device
    assert torch.equal(tsh.sh_band_mask(torch.tensor(band)),
                       tsh.sh_band_mask(band))
    assert tsh.SH_BAND_TO_NUM_COEFFS[band] == int(tsh.sh_band_mask(band).sum())
