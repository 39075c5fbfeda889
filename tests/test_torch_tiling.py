"""Port parity: ops/tiling.py against the JAX package's bin_points_to_tiles
on its overflow-free fixture configs, from the same numpy attributes.

Held exactly over the valid keys: the sorted keys and point ids (the
fixtures have no tied depth buckets), the tile ranges, the per-point key
counts and the key total; the wide16 slab exactly and the packed8 slab
bitwise."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.camera import CameraInfo as JCamera
from taichi_3d_gaussian_splatting_tpu.ops import tiling as jtl
from taichi_3d_gaussian_splatting_tpu.ops.projection import (
    compute_point_attributes as j_attrs)
from taichi_3d_gaussian_splatting_tpu.ops.rasterizer import (
    RasterizerConfig as JConfig)
from taichi_3d_gaussian_splatting_torch.camera import CameraInfo as TCamera
from taichi_3d_gaussian_splatting_torch.ops import tiling as ttl

from torch_port_fixtures import (AB_CASES, FAR, NEAR, camera_intrinsics,
                                 identity_pose, random_scene)

torch.set_num_threads(1)
K = camera_intrinsics()
# the JAX binning's budget arguments, taken from a RasterizerConfig
BUDGETS = ("max_tiles_per_point", "big_point_divisor", "max_keys", "chunk",
           "mid_point_divisor", "max_tiles_per_huge_point", "huge_pool_size",
           "pool_slots", "pool_caps", "slab_gather", "tier_a_cap",
           "pool_meta")


def _attrs(seed, alpha):
    """numpy per-point columns from the JAX projection of one fixture."""
    pc, feats = random_scene(60, seed=seed, alpha=alpha)
    n = pc.shape[0]
    q, t = identity_pose()
    a = j_attrs(jnp.asarray(pc), jnp.asarray(feats), jnp.zeros(n, jnp.int8),
                jnp.zeros(n, jnp.int32), jnp.asarray(q), jnp.asarray(t),
                jnp.asarray(t), JCamera(K, 32, 32), NEAR, FAR)
    logw = (np.log(np.maximum(np.asarray(a.rescale), 1e-30))
            + np.log(np.maximum(np.asarray(a.alpha_after_activation), 1e-30)))
    cols = [np.array(c) for c in (a.u, a.v, a.conic_a, a.conic_b,
                                  a.conic_c)]
    cols += [logw.astype(np.float32)]
    cols += [np.array(c) for c in (a.color_r, a.color_g, a.color_b,
                                   a.depth)]
    geom = [np.array(c) for c in (a.u, a.v, a.depth, a.radius_x,
                                  a.radius_y, a.emit)]
    return geom, cols


def _bin_both(seed, alpha, cfg, slab_format):
    geom, cols = _attrs(seed, alpha)
    jcfg = JConfig(**cfg)
    jb = jtl.bin_points_to_tiles(
        *(jnp.asarray(g) for g in geom), JCamera(K, 32, 32),
        depth_to_sort_key_scale=jcfg.depth_to_sort_key_scale,
        attr_cols=[jnp.asarray(c) for c in cols], slab_format=slab_format,
        **{k: getattr(jcfg, k) for k in BUDGETS})
    tb = ttl.bin_points_to_tiles(
        *(torch.as_tensor(g) for g in geom), TCamera(K, 32, 32),
        depth_to_sort_key_scale=jcfg.depth_to_sort_key_scale,
        attr_cols=[torch.as_tensor(c) for c in cols], slab_format=slab_format)
    assert int(jb.key_overflow) == 0 and int(jb.big_point_overflow) == 0
    assert int(jb.tile_cap_overflow) == 0
    return jb, tb


@pytest.mark.parametrize("seed, alpha, label, cfg", AB_CASES,
                         ids=[c[2] for c in AB_CASES])
@pytest.mark.parametrize("slab_format", ["wide16", "packed8"])
def test_binning_matches_jax(seed, alpha, label, cfg, slab_format):
    jb, tb = _bin_both(seed, alpha, cfg, slab_format)
    total = int(jb.total_keys)
    assert int(tb.total_keys) == total > 0
    assert tb.sorted_key.shape == (total,)
    np.testing.assert_array_equal(tb.sorted_key.numpy(),
                                  np.asarray(jb.sorted_key)[:total])
    np.testing.assert_array_equal(tb.sorted_point_idx.numpy(),
                                  np.asarray(jb.sorted_point_idx)[:total])
    np.testing.assert_array_equal(tb.sorted_valid.numpy(),
                                  np.asarray(jb.sorted_valid)[:total])
    np.testing.assert_array_equal(tb.tile_starts.numpy(),
                                  np.asarray(jb.tile_starts))
    np.testing.assert_array_equal(tb.tile_ends.numpy(),
                                  np.asarray(jb.tile_ends))
    np.testing.assert_array_equal(tb.point_kept_keys.numpy(),
                                  np.asarray(jb.point_kept_keys))
    for counter in ("key_overflow", "tile_cap_overflow",
                    "big_point_overflow"):
        assert int(getattr(tb, counter)) == 0
    # slabs: wide16 exact, packed8 bitwise (both are int32/f32 arrays here,
    # so array_equal compares bit patterns for packed8)
    got = tb.point_data.numpy()
    want = np.asarray(jb.point_data)[:, :total]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_tile_bbox_and_overlap_counts_match_jax():
    geom, _ = _attrs(1, 2.0)
    u, v, _, rx, ry, emit = geom
    # add extreme extents and off-grid centres to exercise every clamp
    u = np.concatenate([u, [-40.0, 80.0, 16.0, 16.0]]).astype(np.float32)
    v = np.concatenate([v, [-40.0, 80.0, 16.0, 16.0]]).astype(np.float32)
    rx = np.concatenate([rx, [0.2, 0.2, 1e6, 0.0]]).astype(np.float32)
    ry = np.concatenate([ry, [0.2, 0.2, 1e6, 0.0]]).astype(np.float32)
    emit = np.concatenate([emit, [True] * 4])
    jcam, tcam = JCamera(K, 32, 32), TCamera(K, 32, 32)
    for j, t in zip(jtl.tile_bbox(*(jnp.asarray(x) for x in (u, v, rx, ry)),
                                  jcam),
                    ttl.tile_bbox(*(torch.as_tensor(x)
                                    for x in (u, v, rx, ry)), tcam)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        ttl.num_overlap_tiles(*(torch.as_tensor(x)
                                for x in (u, v, rx, ry, emit)), tcam).numpy(),
        np.asarray(jtl.num_overlap_tiles(
            *(jnp.asarray(x) for x in (u, v, rx, ry, emit)), jcam)))


def test_pack_bf16_pair_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=257) * 100.0).astype(np.float32)
    b = rng.normal(size=257).astype(np.float32)
    # exact halfway cases exercise round-to-nearest-even
    a[:3] = np.array([0x3F808000, 0x3F818000, 0xBF808000],
                     np.uint32).view(np.float32)
    np.testing.assert_array_equal(
        ttl.pack_bf16_pair(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jtl.pack_bf16_pair(jnp.asarray(a), jnp.asarray(b))))


def test_empty_emission():
    """Nothing in the emission mask: zero keys, empty ranges, (rows, 0)
    slabs."""
    n = 5
    z = torch.ones(n)
    cam = TCamera(K, 32, 32)
    for fmt, rows in (("wide16", 16), ("packed8", 8)):
        b = ttl.bin_points_to_tiles(z, z, z, z, z, torch.zeros(n, dtype=bool),
                                    cam, attr_cols=[z] * 10, slab_format=fmt)
        assert int(b.total_keys) == 0 and b.sorted_key.shape == (0,)
        assert b.point_data.shape == (rows, 0)
        assert (b.tile_starts == 0).all() and (b.tile_ends == 0).all()


def test_every_jax_config_converts():
    """Any JAX RasterizerConfig (all budget knobs set) builds a port config
    through dataclasses.asdict."""
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        RasterizerConfig as TConfig)
    for _, _, _, cfg in AB_CASES:
        j = dataclasses.asdict(JConfig(**cfg, rgb_only=True))
        t = TConfig(**j)
        assert dataclasses.asdict(t) == j
    assert ({f.name for f in dataclasses.fields(TConfig)}
            == {f.name for f in dataclasses.fields(JConfig)})
