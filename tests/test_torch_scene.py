"""Port parity: models/scene.py file formats and scene construction against
the JAX package. Files written by one package are read by the other, array
for array, and spatially_sorted gives the same permutation in both."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.models import scene as jscene_mod
from taichi_3d_gaussian_splatting_torch.models import scene as tscene_mod

from torch_port_fixtures import random_scene

torch.set_num_threads(1)
JScene = jscene_mod.GaussianPointCloudScene
TScene = tscene_mod.GaussianPointCloudScene


def _jax_scene(n=50, invalid_every=0, seed=0):
    pc, feats = random_scene(n, seed=seed)
    invalid = np.zeros(n, np.int8)
    if invalid_every:
        invalid[::invalid_every] = 1
    obj = (np.arange(n) % 3).astype(np.int32)
    return JScene(jnp.asarray(pc), jnp.asarray(feats), jnp.asarray(invalid),
                  jnp.asarray(obj))


def _assert_same(jscene, tscene):
    for field in JScene._fields:
        j = np.asarray(getattr(jscene, field))
        t = getattr(tscene, field).cpu().numpy()
        assert t.dtype == j.dtype, field
        np.testing.assert_array_equal(t, j, err_msg=field)


@pytest.mark.parametrize("fmt", ["parquet", "ply"])
def test_files_cross_read(tmp_path, fmt):
    jscene = _jax_scene(invalid_every=7)
    # JAX writes -> port reads
    getattr(jscene, f"to_{fmt}")(str(tmp_path / f"j.{fmt}"))
    tscene = getattr(TScene, f"from_{fmt}")(str(tmp_path / f"j.{fmt}"),
                                            device="cpu")
    _assert_same(getattr(JScene, f"from_{fmt}")(str(tmp_path / f"j.{fmt}")),
                 tscene)
    assert tscene.num_valid_points() == jscene.num_valid_points()
    # port writes -> JAX reads, and the bytes are the same file
    getattr(tscene, f"to_{fmt}")(str(tmp_path / f"t.{fmt}"))
    _assert_same(getattr(JScene, f"from_{fmt}")(str(tmp_path / f"t.{fmt}")),
                 tscene)
    if fmt == "ply":
        assert ((tmp_path / "t.ply").read_bytes()
                == (tmp_path / "j.ply").read_bytes())


def test_spatially_sorted_same_permutation():
    jscene = _jax_scene(n=200, invalid_every=9, seed=3)
    tscene = TScene.from_numpy(*(np.asarray(x) for x in jscene),
                               device="cpu")
    _assert_same(jscene.spatially_sorted(), tscene.spatially_sorted())


def test_from_numpy_carries_a_jax_scene_over():
    jscene = _jax_scene(invalid_every=5)
    tscene = TScene.from_numpy(*(np.asarray(x) for x in jscene),
                               device="cpu")
    _assert_same(jscene, tscene)
    assert tscene.device == torch.device("cpu")
    assert tscene.capacity == jscene.capacity


@pytest.mark.parametrize("with_rgb", [False, True])
def test_from_arrays_initialization_matches_jax(with_rgb):
    """Feature initialization (cKDTree scales, quaternions drawn from the
    numpy generator, SH DC from rgb) and capacity padding."""
    rng = np.random.default_rng(7)
    pc = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (40, 3)).astype(np.float32) if with_rgb else None
    kw = dict(max_num_points_ratio=1.5, initial_alpha=0.5,
              max_initial_covariance=0.3)
    j = JScene.from_arrays(pc, jscene_mod.SceneConfig(**kw),
                           point_cloud_rgb=rgb, seed=11)
    t = TScene.from_arrays(pc, tscene_mod.SceneConfig(**kw),
                           point_cloud_rgb=rgb,
                           rng=np.random.default_rng(11), device="cpu")
    _assert_same(j, t)
    assert t.capacity == 60 and t.num_valid_points() == 40


def test_parquet_without_features_and_sphere(tmp_path):
    import pandas as pd
    rng = np.random.default_rng(2)
    df = pd.DataFrame(rng.uniform(-1, 1, (30, 3)), columns=["x", "y", "z"])
    df[["r", "g", "b"]] = rng.uniform(0, 255, (30, 3))
    df.to_parquet(tmp_path / "xyz.parquet")
    cfg = dict(add_sphere=True, num_points_sphere=16)
    t = TScene.from_parquet(str(tmp_path / "xyz.parquet"),
                            tscene_mod.SceneConfig(**cfg), device="cpu")
    assert t.capacity == 46 and t.num_valid_points() == 46
    feats = t.point_cloud_features.numpy()
    np.testing.assert_allclose(np.linalg.norm(feats[:, 0:4], axis=1), 1.0,
                               rtol=1e-6)
    assert np.isfinite(feats).all()
    # the sphere's points lie on one radius around the origin
    r = np.linalg.norm(t.point_cloud.numpy()[30:], axis=1)
    np.testing.assert_allclose(r, r[0], rtol=1e-5)


def test_empty_scene_is_one_invalid_slot():
    t = TScene.from_arrays(np.zeros((0, 3)), tscene_mod.SceneConfig(),
                           device="cpu")
    assert t.capacity == 1 and t.num_valid_points() == 0
