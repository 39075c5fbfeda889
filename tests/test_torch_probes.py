"""The K1 ablation probes of the port (taichi_3d_gaussian_splatting_torch/
probes/) against the TPU probes they replace, on the CPU at a small size:
each plain version against the TPU kernel in Pallas's interpret mode, mode
by mode, on inputs made with numpy from a seed.

- S4 (scratch/perf_rgb_ablate2.py) and S1 (scratch/perf_exp2_probe.py) run
  their own `make_kernel`, loaded from the file by path;
- S3 (scratch/perf_kernel_ablate.py) and S2 (scratch/perf_flip_proto.py)
  cannot be imported; tests/torch_probe_fixtures.py carries their bodies.

Tolerances are stated per test. The TPU probes form their products on the
matrix unit (`dot_general` at HIGHEST), the plain versions by torch.matmul
in float32 or elementwise: the same float32 operations up to the order of
a sum. S4's plain version takes K1's exponent (blend_cuda.py `_alpha_exp`,
as the kernel does) where the TPU probe takes a tile-centred monomial
product: the same value, rounded otherwise.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch_probe_fixtures as PF
from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
from taichi_3d_gaussian_splatting_torch.probes import _common as C
from taichi_3d_gaussian_splatting_torch.probes import perf_exp2_probe as S1
from taichi_3d_gaussian_splatting_torch.probes import perf_flip_proto as S2
from taichi_3d_gaussian_splatting_torch.probes import perf_kernel_ablate as S3
from taichi_3d_gaussian_splatting_torch.probes import perf_rgb_ablate2 as S4
from taichi_3d_gaussian_splatting_tpu.ops.blend_pallas import (
    blend_forward_rgb)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-3, 1e-4       # tests/test_tpu_exactness.py:44-64
# a plain version against its own TPU probe: the same operations, sums in
# another order (measured: at most 1.4e-5 relative, 6.1e-5 absolute on
# sums ~200)
TIGHT_RTOL, TIGHT_ATOL = 1e-4, 1e-5
# 4 tiles, 2 a row (a 32x32 image); 1,024 slab columns. Tile 0 starts
# inside a chunk and spans three, tile 1 is empty, tile 2 starts inside the
# chunk where tile 0 ends (columns 290-299 belong to no tile), tile 3 ends
# inside its last chunk (columns 1,000-1,023 are padding)
NUM_TILES, TILES_PER_ROW, MK = 4, 2, 1024
STARTS = np.array([5, 300, 300, 700], np.int32)
ENDS = np.array([290, 300, 650, 1000], np.int32)


def _load_scratch(name):
    """A scratch/ probe loaded by path (its __main__ part does not run)."""
    spec = importlib.util.spec_from_file_location(
        f"scratch_{name}", os.path.join(REPO, "scratch", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _wide16(seed=0, one_row=True):
    """A wide16 slab of splats over the 32x32 image: sigma ~3-7 px, opacity
    from 0.05 to 0.95 (logw) in tiles 0 and 2, so that most of their pixels
    saturate, at most 0.14 in tile 3, whose pixels do not; random colour
    rows."""
    rng = np.random.default_rng(seed)
    data = np.zeros((16, MK), np.float32)
    data[BC.ROW_U] = rng.uniform(-2, 34, MK)
    data[BC.ROW_V] = rng.uniform(-2, 34, MK)
    data[BC.ROW_A] = rng.uniform(0.01, 0.06, MK)
    data[BC.ROW_B] = rng.uniform(-0.005, 0.005, MK)
    data[BC.ROW_C] = rng.uniform(0.01, 0.06, MK)
    data[BC.ROW_LOGW] = rng.uniform(-3.0, -0.05, MK)
    data[BC.ROW_LOGW, 700:] = rng.uniform(-4.0, -2.0, MK - 700)
    data[8:16] = rng.uniform(0, 1, (8, MK))
    if one_row:
        data[BC.ROW_ONE] = 1.0
    return data


def _ranges():
    return torch.as_tensor(STARTS), torch.as_tensor(ENDS)


def _assert_close(got, ref, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


# ---- S4 -------------------------------------------------------------------

def _s4_tpu(mode, data):
    module = _load_scratch("perf_rgb_ablate2")
    grid_spec = pltpu.PrefetchScalarGridSpec(      # its run(), :98-109
        num_scalar_prefetch=2, grid=(NUM_TILES,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, 8, C.PIXELS), lambda t, s, e: (t, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, 16, C.CHUNK), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))])
    out = pl.pallas_call(
        module.make_kernel(mode, TILES_PER_ROW), grid_spec=grid_spec,
        out_shape=jax_shape((NUM_TILES, 8, C.PIXELS)),
        interpret=True)(jnp.asarray(STARTS), jnp.asarray(ENDS),
                        jnp.asarray(data))
    return np.asarray(out)


def jax_shape(shape):
    import jax
    return jax.ShapeDtypeStruct(shape, jnp.float32)


@pytest.mark.parametrize("mode", S4.MODES)
def test_s4_plain_matches_tpu_probe(mode):
    """Rows [r, g, b, 1 - T, sum w, 0, 0, 0] at rtol 1e-4 / atol 1e-5 (the
    exponent is K1's in the plain version, the tile-centred product in the
    TPU probe's)."""
    data = _wide16()
    ref = _s4_tpu(mode, data)
    got = S4.rgb_ablate2_torch(torch.as_tensor(data), *_ranges(), mode=mode,
                               num_tiles=NUM_TILES,
                               tiles_per_row=TILES_PER_ROW).numpy()
    _assert_close(got, ref, TIGHT_RTOL, TIGHT_ATOL, f"S4 {mode}")
    if mode == "full":       # pixels that saturate (T < 1e-3) and others
        assert 100 < (ref[:, 3] > 0.999).sum() < 3 * 256
    assert np.abs(ref[:, 0:3]).max() > 0.1


def test_s4_full_matches_k1_of_the_jax_package():
    """S4's `full` is K1: against the JAX package's blend_forward_rgb
    (interpret) on the same wide16 slab: r, g, b; 1 - T (S4 row 3, K1 row
    4); sum w (S4 row 4, K1 row 5); at rtol 2e-3 / atol 1e-4."""
    data = _wide16(seed=1)
    ref = np.asarray(blend_forward_rgb(
        jnp.asarray(data), jnp.asarray(STARTS), jnp.asarray(ENDS),
        num_tiles=NUM_TILES, tiles_per_row=TILES_PER_ROW))
    got = S4.rgb_ablate2_torch(torch.as_tensor(data), *_ranges(),
                               mode="full", num_tiles=NUM_TILES,
                               tiles_per_row=TILES_PER_ROW).numpy()
    for s4_row, k1_row in ((0, BC.OUT_R), (1, BC.OUT_G), (2, BC.OUT_B),
                           (3, BC.OUT_ACC_ALPHA), (4, BC.OUT_NORM)):
        _assert_close(got[:, s4_row], ref[:, k1_row], RTOL, ATOL,
                      f"S4 full row {s4_row} vs K1 row {k1_row}")


# ---- S1 -------------------------------------------------------------------

@pytest.mark.parametrize("variant", S1.VARIANTS)
def test_s1_plain_matches_tpu_probe(variant, monkeypatch):
    """16 steps of the TPU probe's sum on its own inputs (rng(0)), at rtol
    1e-5: the exponent's products are rounded alike, its 8-term sum in
    another order (~1e-7), and each step adds ~1."""
    module = _load_scratch("perf_exp2_probe")
    steps = 16
    monkeypatch.setattr(module, "N_CHUNKS", steps)
    coef, mono = S1.probe_inputs("cpu")
    ref = np.asarray(pl.pallas_call(
        module.make_kernel(variant),
        out_shape=jax_shape((C.CHUNK, C.PIXELS)), interpret=True)(
            jnp.asarray(coef.numpy()[None]), jnp.asarray(mono.numpy())))
    got = S1.exp2_probe_torch(coef, mono, variant=variant, n_chunks=steps)
    _assert_close(got.numpy(), ref, 1e-5, 0.0, f"S1 {variant}")
    assert ref.min() > 0.0


def test_s1_variants_agree_and_the_figure():
    """The probe's own figure: exp2mul and exp2pre within 1e-5 relative of
    exp over 16 steps (each f within a few ulp)."""
    coef, mono = S1.probe_inputs("cpu")
    outs = {v: S1.exp2_probe_torch(coef, mono, variant=v, n_chunks=16)
            for v in S1.VARIANTS}
    for v in ("exp2mul", "exp2pre"):
        assert 0.0 < S1.max_rel_diff(outs["exp"], outs[v]) < 1e-5


# ---- S3 -------------------------------------------------------------------

def _s3_slab(seed=2):
    """S3's rows: a, c negative (its exponent has no -1/2), b small."""
    data = _wide16(seed)
    data[BC.ROW_A] = -data[BC.ROW_A] / 2
    data[BC.ROW_C] = -data[BC.ROW_C] / 2
    return data


@pytest.mark.parametrize("mode", S3.MODES)
def test_s3_plain_matches_tpu_probe(mode):
    """(num_tiles, 256, 8) at rtol 1e-4 / atol 1e-5, against S3's body as
    written (tests/torch_probe_fixtures.py), helpers of acf080a^."""
    data = _s3_slab()
    ref = np.asarray(PF.s3_run(mode, jnp.asarray(data), jnp.asarray(STARTS),
                               jnp.asarray(ENDS), NUM_TILES, TILES_PER_ROW))
    got = S3.kernel_ablate_torch(torch.as_tensor(data), *_ranges(),
                                 mode=mode, num_tiles=NUM_TILES,
                                 tiles_per_row=TILES_PER_ROW).numpy()
    _assert_close(got, ref, TIGHT_RTOL, TIGHT_ATOL, f"S3 {mode}")
    if mode == "no_exp":      # the exponent is negative: nothing blends
        assert np.abs(ref).max() == 0.0
    else:
        assert np.abs(ref).max() > 0.1


def test_s3_full_against_k1_with_mapped_conics():
    """S3's exponent (a dx + b dy) dx + c dy^2 + logw is K1's
    -0.5 (A dx^2 + C dy^2) - B dx dy + logw with A = -2a, B = -b, C = -2c.
    The mapping holds in value, not bitwise: the two associate the
    products differently. So S3 `full`'s r, g, b and sum w (column 4, the
    row of ones) against the JAX package's blend_forward_rgb on the mapped
    slab, at rtol 2e-3 / atol 1e-4."""
    data = _s3_slab(seed=3)
    mapped = data.copy()
    mapped[BC.ROW_A] = -2 * data[BC.ROW_A]
    mapped[BC.ROW_B] = -data[BC.ROW_B]
    mapped[BC.ROW_C] = -2 * data[BC.ROW_C]
    ref = np.asarray(blend_forward_rgb(
        jnp.asarray(mapped), jnp.asarray(STARTS), jnp.asarray(ENDS),
        num_tiles=NUM_TILES, tiles_per_row=TILES_PER_ROW))
    got = S3.kernel_ablate_torch(torch.as_tensor(data), *_ranges(),
                                 mode="full", num_tiles=NUM_TILES,
                                 tiles_per_row=TILES_PER_ROW).numpy()
    for col, k1_row in ((0, BC.OUT_R), (1, BC.OUT_G), (2, BC.OUT_B),
                        (4, BC.OUT_NORM)):
        _assert_close(got[:, :, col], ref[:, k1_row], RTOL, ATOL,
                      f"S3 full column {col} vs K1 row {k1_row}")


# ---- S2 -------------------------------------------------------------------

def _s2_slab(seed=4):
    """S2's rows built as its :144-165 build them (numpy float32), from
    splats over the 32x32 image: absolute-coordinate coefficients."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-2, 34, MK).astype(np.float32)
    v = rng.uniform(-2, 34, MK).astype(np.float32)
    ca = rng.uniform(0.01, 0.06, MK).astype(np.float32)
    cb = rng.uniform(-0.005, 0.005, MK).astype(np.float32)
    cc = rng.uniform(0.01, 0.06, MK).astype(np.float32)
    logw = rng.uniform(-3.0, -0.05, MK).astype(np.float32)
    logw[700:] = rng.uniform(-4.0, -2.0, MK - 700)
    data = np.zeros((16, MK), np.float32)
    data[S2.C_XX] = -0.5 * ca
    data[S2.C_XY] = -cb
    data[S2.C_YY] = -0.5 * cc
    data[S2.C_X] = ca * u + cb * v
    data[S2.C_Y] = cc * v + cb * u
    data[S2.C_1] = logw - 0.5 * (ca * u * u + 2 * cb * u * v + cc * v * v)
    data[8:16] = rng.uniform(0, 1, (8, MK))
    return data


@pytest.mark.parametrize("mode", S2.MODES)
def test_s2_plain_matches_tpu_probe(mode):
    """(num_tiles, 8, 256) at rtol 1e-4 / atol 1e-5 against S2's body as
    written (tests/torch_probe_fixtures.py). At 32x32 the coefficients'
    terms stay below ~100, so float32's product is exact to ~1e-5 here; at
    976 px the terms reach ~5e4 (the card's phase counts what flips)."""
    data = _s2_slab()
    ref = np.asarray(PF.s2_run(mode, jnp.asarray(data), jnp.asarray(STARTS),
                               jnp.asarray(ENDS), NUM_TILES, TILES_PER_ROW))
    got = S2.flip_proto_torch(torch.as_tensor(data), *_ranges(), mode=mode,
                              num_tiles=NUM_TILES,
                              tiles_per_row=TILES_PER_ROW).numpy()
    _assert_close(got, ref, TIGHT_RTOL, TIGHT_ATOL, f"S2 {mode}")
    if mode == "full":
        assert 100 < (ref[:, 4] > 0.999).sum() < 3 * 256
    assert np.abs(ref[:, 0:4]).max() > 0.1


def test_s2_float64_exponent_and_decisions_at_small_coordinates():
    """The kernel's exponent (FP64 product, rounded once) and float32's
    agree at 32x32: outputs at rtol 2e-3 / atol 1e-4, and no skip or
    saturation decision flips."""
    slab = torch.as_tensor(_s2_slab(seed=5))
    kw = dict(num_tiles=NUM_TILES, tiles_per_row=TILES_PER_ROW)
    f32 = S2.flip_proto_torch(slab, *_ranges(), mode="full", **kw)
    f64 = S2.flip_proto_torch(slab, *_ranges(), mode="full",
                              exponent_dtype=torch.float64, **kw)
    _assert_close(f64.numpy(), f32.numpy(), RTOL, ATOL, "S2 f64 vs f32")
    flips = S2.decision_flips(slab, *_ranges(), **kw)
    assert flips["skip"] == 0 and flips["saturation"] == 0, flips
    # the pairs of the chunks walked, up to the tiles' exits
    assert 0 < flips["pairs"] <= 256 * int((ENDS - STARTS).sum())
    assert flips["pixels"] == NUM_TILES * 256


def test_s2_of_a_wide16_slab_is_k1():
    """from_wide16 rewrites K1's slab into S2's rows (coefficients formed
    in float64): S2 `full` of it against S4 `full` (K1) of the slab, r, g,
    b, depth-weighted row 3, 1 - T; rtol 2e-3 / atol 1e-4."""
    data = _wide16(seed=6)
    slab = torch.as_tensor(data)
    kw = dict(num_tiles=NUM_TILES, tiles_per_row=TILES_PER_ROW)
    s2 = S2.flip_proto_torch(S2.from_wide16(slab), *_ranges(), mode="full",
                             exponent_dtype=torch.float64, **kw).numpy()
    k1 = S4.rgb_ablate2_torch(slab, *_ranges(), mode="full", **kw).numpy()
    for s2_row, k1_row in ((0, 0), (1, 1), (2, 2), (4, 3)):
        _assert_close(s2[:, s2_row], k1[:, k1_row], RTOL, ATOL,
                      f"S2 row {s2_row} vs S4 row {k1_row}")


# ---- the wrappers on the CPU ---------------------------------------------

def test_wrappers_on_cpu_take_the_plain_versions():
    """A CPU tensor takes the plain version (bitwise) and counts no launch;
    a slab whose columns are not a multiple of 128 is refused."""
    kw = dict(num_tiles=NUM_TILES, tiles_per_row=TILES_PER_ROW)
    for module, fn, plain, mode in (
            (S4, S4.rgb_ablate2, S4.rgb_ablate2_torch, "no_scan"),
            (S3, S3.kernel_ablate, S3.kernel_ablate_torch, "no_sat"),
            (S2, S2.flip_proto, S2.flip_proto_torch, "full")):
        module.reset_launch_counts()
        slab = torch.as_tensor(_wide16(seed=7))
        assert torch.equal(fn(slab, *_ranges(), mode=mode, **kw),
                           plain(slab, *_ranges(), mode=mode, **kw))
        assert sum(module.launch_counts.values()) == 0
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(slab[:, :1000].contiguous(), *_ranges(), mode=mode, **kw)
    S1.reset_launch_counts()
    coef, mono = S1.probe_inputs("cpu")
    assert torch.equal(S1.exp2_probe(coef, mono, variant="exp", n_chunks=3),
                       S1.exp2_probe_torch(coef, mono, variant="exp",
                                           n_chunks=3))
    assert sum(S1.launch_counts.values()) == 0


def test_pad_columns_and_the_layouts():
    slab = torch.arange(2 * 300, dtype=torch.float32).reshape(2, 300)
    padded = C.pad_columns(slab)
    assert padded.shape == (2, 384)
    assert torch.equal(padded[:, :300], slab) and padded[:, 300:].eq(0).all()
    assert C.pad_columns(padded).shape == (2, 384)
    s3_slab, s3_starts, s3_ends = S3.layout("cpu")
    s2_slab, s2_starts, s2_ends = S2.layout("cpu")
    assert s3_slab.shape == (16, S3.SLAB_COLUMNS) == s2_slab.shape
    assert S3.SLAB_COLUMNS % C.CHUNK == 0
    assert torch.equal(s3_starts, s2_starts) and torch.equal(s3_ends, s2_ends)
    assert int(s3_ends[-1]) == S3.KEYS and s3_starts.shape == (S3.NUM_TILES,)
    # S2's u, v are S3's (one generator, the same draws); its c_1 ~ -6e4
    assert torch.equal(s2_slab[S2.C_X], (0.1 * s3_slab[BC.ROW_U]).float())
    assert float(s2_slab[S2.C_1].min()) < -5e4
