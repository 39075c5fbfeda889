"""Port parity for the differentiable rasterizer: the port's
`rasterize_with_vjp` against the JAX package's on the three ab fixtures
(per-point position and feature gradients and every BackwardStats field),
the projection's gradients against `jax.vjp`, and `rasterize` + autograd
against the explicit `vjp_fn`.

Gradients at rtol 2e-3 / atol 2e-5, and 5e-3 / 5e-5 on the saturating
fixture "b" (the JAX package's own backward tolerances,
tests/test_blend_pallas.py); integer pixel counts statistically."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.camera import CameraInfo as JCamera
from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as JR
from taichi_3d_gaussian_splatting_torch.camera import CameraInfo as TCamera
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene)
from taichi_3d_gaussian_splatting_torch.ops import rasterizer as TR

from torch_port_fixtures import (AB_CASES, assert_counts_close,
                                 camera_intrinsics, identity_pose,
                                 random_scene)

torch.set_num_threads(1)
TOL = {"a": (2e-3, 2e-5), "b": (5e-3, 5e-5), "c": (2e-3, 2e-5)}


def _scene(seed, alpha):
    pc, feats = random_scene(60, seed=seed, alpha=alpha)
    return pc, feats, np.zeros(60, np.int8), np.zeros(60, np.int32)


def _g_image(seed):
    rng = np.random.default_rng(seed + 200)
    return rng.normal(size=(32, 32, 3)).astype(np.float32)


def _jax_vjp(arrays, cfg, g):
    q, t = identity_pose()
    res, vjp_fn = JR.rasterize_with_vjp(
        *(jnp.asarray(x) for x in arrays), jnp.asarray(q), jnp.asarray(t),
        JCamera(camera_intrinsics(), 32, 32), JR.RasterizerConfig(**cfg))
    gp, gf, stats = vjp_fn(jnp.asarray(g))
    return res, np.asarray(gp), np.asarray(gf), jax.tree.map(np.asarray,
                                                             stats)


def _torch_vjp(arrays, cfg, g):
    q, t = (torch.as_tensor(x) for x in identity_pose())
    res, vjp_fn = TR.rasterize_with_vjp(
        *TScene.from_numpy(*arrays, device="cpu"), q, t,
        TCamera(camera_intrinsics(), 32, 32), TR.RasterizerConfig(**cfg))
    gp, gf, stats = vjp_fn(torch.as_tensor(g))
    return res, gp.numpy(), gf.numpy(), stats


@pytest.mark.parametrize("seed, alpha, label, cfg", AB_CASES,
                         ids=[c[2] for c in AB_CASES])
def test_rasterize_with_vjp_matches_jax(seed, alpha, label, cfg):
    arrays = _scene(seed, alpha)
    g = _g_image(seed)
    jres, jgp, jgf, jstats = _jax_vjp(arrays, cfg, g)
    tres, tgp, tgf, tstats = _torch_vjp(arrays, cfg, g)
    rtol, atol = TOL[label]
    np.testing.assert_allclose(tres.image.numpy(), np.asarray(jres.image),
                               rtol=2e-3, atol=1e-4, err_msg="image")
    assert np.abs(jgp).max() > 0 and np.abs(jgf).max() > 0
    np.testing.assert_allclose(tgp, jgp, rtol=rtol, atol=atol,
                               err_msg="grad pointcloud")
    np.testing.assert_allclose(tgf, jgf, rtol=rtol, atol=atol,
                               err_msg="grad features")
    np.testing.assert_allclose(tstats.grad_viewspace.numpy(),
                               jstats.grad_viewspace, rtol=rtol, atol=atol,
                               err_msg="grad_viewspace")
    np.testing.assert_allclose(tstats.magnitude_grad_viewspace.numpy(),
                               jstats.magnitude_grad_viewspace, rtol=rtol,
                               atol=atol, err_msg="magnitude_grad_viewspace")
    np.testing.assert_allclose(
        tstats.magnitude_grad_viewspace_on_image.numpy(),
        jstats.magnitude_grad_viewspace_on_image, rtol=rtol, atol=atol,
        err_msg="magnitude image")
    assert tstats.num_affected_pixels.dtype == torch.int32
    assert_counts_close(jstats.num_affected_pixels,
                        tstats.num_affected_pixels.numpy(), "pixels")
    assert tstats.num_affected_pixels.max() > 0
    # rgb_only in the config is overridden: the full forward's outputs
    assert tres.pixel_valid_point_count.max() > 0


@pytest.mark.parametrize("seed, alpha, label, cfg", AB_CASES,
                         ids=[c[2] for c in AB_CASES])
def test_projection_gradients_match_jax_vjp(seed, alpha, label, cfg):
    """The blend's 9 input columns (u, v, conic a/b/c, logw, r, g, b) as
    functions of positions and features: their VJP by torch autograd
    against jax.vjp, for one seeded cotangent per column."""
    arrays = _scene(seed, alpha)
    q, t = identity_pose()
    rng = np.random.default_rng(seed + 300)
    cots = rng.normal(size=(9, 60)).astype(np.float32)
    jcam = JCamera(camera_intrinsics(), 32, 32)
    jcfg = JR.RasterizerConfig(**cfg)

    def jcols(pc, feats):
        _, cols, _, _ = JR._project_and_bin(
            pc, feats, jnp.asarray(arrays[2]), jnp.asarray(arrays[3]),
            jnp.asarray(q), jnp.asarray(t), jcam, jcfg, None)
        return cols

    _, jfn = jax.vjp(jcols, jnp.asarray(arrays[0]), jnp.asarray(arrays[1]))
    jgp, jgf = (np.asarray(x) for x in jfn(tuple(jnp.asarray(c)
                                                  for c in cots)))
    scene = TScene.from_numpy(*arrays, device="cpu")
    pc = scene.point_cloud.requires_grad_(True)
    feats = scene.point_cloud_features.requires_grad_(True)
    _, cols, _, _ = TR._project_and_bin(
        pc, feats, *scene[2:], torch.as_tensor(q), torch.as_tensor(t),
        TCamera(camera_intrinsics(), 32, 32), TR.RasterizerConfig(**cfg),
        None)
    tgp, tgf = torch.autograd.grad(cols, (pc, feats),
                                   tuple(torch.as_tensor(c) for c in cots))
    scale_p = np.abs(jgp).max()
    scale_f = np.abs(jgf).max()
    np.testing.assert_allclose(tgp.numpy(), jgp, rtol=1e-4,
                               atol=1e-5 * scale_p, err_msg="positions")
    np.testing.assert_allclose(tgf.numpy(), jgf, rtol=1e-4,
                               atol=1e-5 * scale_f, err_msg="features")


@pytest.mark.parametrize("seed, alpha, label, cfg", AB_CASES[:2],
                         ids=[c[2] for c in AB_CASES[:2]])
def test_rasterize_backward_equals_vjp_fn(seed, alpha, label, cfg):
    """`rasterize` + `.backward()` gives what `rasterize_with_vjp`'s
    vjp_fn gives (the same kernels and routing, one through autograd)."""
    arrays = _scene(seed, alpha)
    g = _g_image(seed)
    _, vgp, vgf, _ = _torch_vjp(arrays, cfg, g)
    scene = TScene.from_numpy(*arrays, device="cpu")
    pc = scene.point_cloud.requires_grad_(True)
    feats = scene.point_cloud_features.requires_grad_(True)
    q, t = (torch.as_tensor(x) for x in identity_pose())
    res = TR.rasterize(pc, feats, *scene[2:], q, t,
                       TCamera(camera_intrinsics(), 32, 32),
                       TR.RasterizerConfig(**cfg))
    assert not res.depth.requires_grad
    assert not res.aux.pixel_accumulated_alpha.requires_grad
    (res.image * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(pc.grad.numpy(), vgp, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(feats.grad.numpy(), vgf, rtol=1e-5,
                               atol=1e-7)
