"""The bodies of two TPU probes that cannot be imported, run in Pallas's
interpret mode on the CPU, for tests/test_torch_probes.py.

- scratch/perf_kernel_ablate.py (S3) imports `_lane_cumprod_exclusive` and
  `_tile_pixel_coords`, which ops/blend_pallas.py no longer defines (removed
  in acf080a), and its `_saturation_masks` now holds keys on sublanes. Its
  kernel body (:19-104) is copied below as written, with the three helpers
  (and `_shift_right_lanes`, which one of them calls) as they stood at
  acf080a^ (ops/blend_pallas.py:90-167 there).
- scratch/perf_flip_proto.py (S2) times its 2,074 tiles when imported. Its
  kernel body (:40-130) and its `_sub_cumprod_exclusive` (:27-37) are
  copied below as written.

One change to each body: the tiles per row, a module constant there (61),
is a parameter, so that a test runs a few tiles. The pallas_calls are the
files' own grid specs (perf_kernel_ablate.py:107-119, perf_flip_proto.py:
132-142) with `interpret=True`.
"""

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from taichi_3d_gaussian_splatting_tpu.camera import TILE_HEIGHT, TILE_WIDTH
from taichi_3d_gaussian_splatting_tpu.ops.blend_pallas import (
    NUM_DATA_ROWS, PIXELS_PER_TILE, ROW_A, ROW_B, ROW_C, ROW_LOGW, ROW_U,
    ROW_V)

CHUNK = 128
# acf080a^ ops/blend_pallas.py
TRANSMITTANCE_SATURATION = 1e-4
# scratch/perf_flip_proto.py:15-22
PIX = 256
TILE_W = 16
ALPHA_SKIP = 1.0 / 255.0
ALPHA_CLAMP = 0.99
SAT = 1e-4


# ---- S3's helpers as of acf080a^ (ops/blend_pallas.py:90-167) ----------

def _shift_right_lanes(x, k, fill, interpret):
    """Shift columns right by k, filling `fill` (no wraparound). The fill
    mask is built (1, C) and broadcast into the select - a full-size iota per
    scan step costs ~3x the select itself on the VPU."""
    rolled = jnp.roll(x, k, 1) if interpret else pltpu.roll(x, k, 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, x.shape[1]), 1)
    return jnp.where(lane < k, jnp.full_like(x, fill), rolled)


def _saturation_masks(a_v, T_i, one_minus, T, sat):
    tnext = T_i * one_minus
    positive = (a_v > 0.0).astype(jnp.float32)
    hit = positive * (tnext < TRANSMITTANCE_SATURATION).astype(jnp.float32)
    contribute = (positive
                  * (tnext >= TRANSMITTANCE_SATURATION).astype(jnp.float32)
                  * (1.0 - sat))
    row_hit = jnp.max(hit, axis=1, keepdims=True)
    T_at_hit = jnp.max(T_i * hit, axis=1, keepdims=True)
    T_new = jnp.where(row_hit > 0.5, T_at_hit, tnext[:, -1:])
    T_new = jnp.where(sat > 0.5, T, T_new)
    sat_new = jnp.maximum(sat, row_hit)
    return contribute, T_new, sat_new


def _lane_cumprod_exclusive(x, interpret=False):
    c = x.shape[1]
    acc = _shift_right_lanes(x, 1, 1.0, interpret)
    k = 1
    while k < c:
        acc = acc * _shift_right_lanes(acc, k, 1.0, interpret)
        k *= 2
    return acc


def _tile_pixel_coords(tile_id, tiles_per_row):
    """Pixel-center coordinates of a tile's 256 pixels, shape (256, 1)."""
    tile_u = tile_id % tiles_per_row
    tile_v = tile_id // tiles_per_row
    idx = jax.lax.broadcasted_iota(jnp.int32, (PIXELS_PER_TILE, 1), 0)
    u_in = idx % TILE_WIDTH
    v_in = idx // TILE_WIDTH
    px = (tile_u * TILE_WIDTH + u_in).astype(jnp.float32) + 0.5
    py = (tile_v * TILE_HEIGHT + v_in).astype(jnp.float32) + 0.5
    return px, py


# ---- S3: scratch/perf_kernel_ablate.py:19-104 --------------------------

def s3_make_kernel(mode, TPR):
    def kern(starts_ref, ends_ref, data_hbm, out_ref, chunk_buf, dma_sem):
        t = pl.program_id(0)
        start = starts_ref[t]
        end = ends_ref[t]
        aligned_start = (start // CHUNK) * CHUNK
        num_chunks = jnp.where(end > start,
                               pl.cdiv(end - aligned_start, CHUNK), 0)
        px, py = _tile_pixel_coords(t, TPR)

        def get_dma(i):
            slot = jax.lax.rem(i, 2)
            return pltpu.make_async_copy(
                data_hbm.at[:, pl.ds(aligned_start + i * CHUNK, CHUNK)],
                chunk_buf.at[slot], dma_sem.at[slot])

        @pl.when(num_chunks > 0)
        def _():
            get_dma(0).start()

        def cond(state):
            i, T, sat, acc = state
            return (i < num_chunks) & jnp.logical_not(jnp.all(sat > 0.5))

        def body(state):
            i, T, sat, acc = state
            col0 = aligned_start + i * CHUNK

            @pl.when(i + 1 < num_chunks)
            def _():
                get_dma(i + 1).start()
            get_dma(i).wait()
            data = chunk_buf[jax.lax.rem(i, 2)]

            if mode == "dma_only":
                acc = acc + jnp.sum(data[0:1, :]) * jnp.ones_like(acc)
                return (i + 1, T, sat, acc)

            dx = px - data[ROW_U:ROW_U + 1, :]
            dy = py - data[ROW_V:ROW_V + 1, :]
            exponent = ((data[ROW_A:ROW_A + 1, :] * dx
                         + data[ROW_B:ROW_B + 1, :] * dy) * dx
                        + (data[ROW_C:ROW_C + 1, :] * dy * dy
                           + data[ROW_LOGW:ROW_LOGW + 1, :]))
            if mode == "no_exp":
                a_exp = exponent
            else:
                a_exp = jnp.exp(exponent)
            lane = jax.lax.broadcasted_iota(jnp.int32, (1, CHUNK), 1)
            gidx = col0 + lane
            in_segment = (gidx >= start) & (gidx < end)
            a_v = jnp.where(in_segment & (a_exp >= 1.0 / 255.0),
                            jnp.minimum(a_exp, 0.99), 0.0)
            one_minus = 1.0 - a_v
            if mode == "no_scan":
                T_i = T * one_minus
            else:
                T_i = T * _lane_cumprod_exclusive(one_minus, False)
            if mode == "no_sat":
                contribute = (a_v > 0).astype(jnp.float32)
                T = T_i[:, -1:]
            else:
                contribute, T, sat = _saturation_masks(
                    a_v, T_i, one_minus, T, sat)
            weight = contribute * a_v * T_i
            if mode == "no_mxu":
                acc = acc + jnp.sum(weight, axis=1, keepdims=True) * jnp.ones_like(acc)
            else:
                acc = acc + jax.lax.dot_general(
                    weight, data[8:16, :], (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
            return (i + 1, T, sat, acc)

        init = (jnp.zeros((), jnp.int32),
                jnp.ones((PIXELS_PER_TILE, 1), jnp.float32),
                jnp.zeros((PIXELS_PER_TILE, 1), jnp.float32),
                jnp.zeros((PIXELS_PER_TILE, 8), jnp.float32))
        i_final, T, _, acc = jax.lax.while_loop(cond, body, init)

        @pl.when((i_final < num_chunks) & (num_chunks > 0))
        def _():
            get_dma(i_final).wait()
        out_ref[0, :, :] = acc

    return kern


def s3_run(mode, data, starts, ends, num_tiles, tiles_per_row):
    """perf_kernel_ablate.py's build(mode) (:107-119) in interpret mode:
    (num_tiles, 256, 8) f32."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(num_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, PIXELS_PER_TILE, 8),
                               lambda t, s, e: (t, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, NUM_DATA_ROWS, CHUNK), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))])
    return pl.pallas_call(
        s3_make_kernel(mode, tiles_per_row), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((num_tiles, PIXELS_PER_TILE, 8),
                                       jnp.float32),
        interpret=True)(starts, ends, data)


# ---- S2: scratch/perf_flip_proto.py:27-37 and :40-130 -------------------

def _sub_cumprod_exclusive(x):
    """Exclusive prefix product along axis 0 (sublanes)."""
    n = x.shape[0]
    row = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)
    acc = jnp.where(row < 1, jnp.ones_like(x), pltpu.roll(x, 1, 0))
    k = 1
    while k < n:
        rolled = pltpu.roll(acc, k, 0)
        acc = acc * jnp.where(row < k, jnp.ones_like(acc), rolled)
        k *= 2
    return acc


def s2_make_kern(mode, TPR):
  def kern(starts_ref, ends_ref, data_hbm, out_ref, chunk_buf, dma_sem):
      t = pl.program_id(0)
      start = starts_ref[t]
      end = ends_ref[t]
      aligned_start = (start // CHUNK) * CHUNK
      num_chunks = jnp.where(end > start, pl.cdiv(end - aligned_start, CHUNK), 0)

      # mono(256, 8): [px^2, px*py, py^2, px, py, 1, 0, 0] per pixel
      tile_u = t % TPR
      tile_v = t // TPR
      idx = jax.lax.broadcasted_iota(jnp.int32, (PIX, 1), 0)
      px = (tile_u * TILE_W + idx % TILE_W).astype(jnp.float32) + 0.5
      py = (tile_v * TILE_W + idx // TILE_W).astype(jnp.float32) + 0.5
      mono = jnp.concatenate(
          [px * px, px * py, py * py, px, py, jnp.ones_like(px),
           jnp.zeros_like(px), jnp.zeros_like(px)], axis=1)      # (256, 8)

      def get_dma(i):
          slot = jax.lax.rem(i, 2)
          return pltpu.make_async_copy(
              data_hbm.at[:, pl.ds(aligned_start + i * CHUNK, CHUNK)],
              chunk_buf.at[slot], dma_sem.at[slot])

      @pl.when(num_chunks > 0)
      def _():
          get_dma(0).start()

      def cond(state):
          i, T, sat, acc = state
          return (i < num_chunks) & jnp.logical_not(jnp.all(sat > 0.5))

      def body(state):
          i, T, sat, acc = state
          col0 = aligned_start + i * CHUNK

          @pl.when(i + 1 < num_chunks)
          def _():
              get_dma(i + 1).start()
          get_dma(i).wait()
          data = chunk_buf[jax.lax.rem(i, 2)]       # (16, CHUNK)

          # E[k, p] = sum_j coef[j, k] * mono[p, j]  -> (CHUNK, 256)
          E = jax.lax.dot_general(
              data[0:8, :], mono, (((0,), (1,)), ((), ())),
              preferred_element_type=jnp.float32,
              precision=jax.lax.Precision.HIGHEST)
          a_exp = jnp.exp(E)
          row = jax.lax.broadcasted_iota(jnp.int32, (CHUNK, 1), 0)
          gidx = col0 + row
          in_segment = (gidx >= start) & (gidx < end)
          a_v = jnp.where(in_segment & (a_exp >= ALPHA_SKIP),
                          jnp.minimum(a_exp, ALPHA_CLAMP), 0.0)
          one_minus = 1.0 - a_v
          if mode == "no_scan":
              T_i = T * one_minus
          else:
              T_i = T * _sub_cumprod_exclusive(one_minus)      # (CHUNK, 256)

          tnext = T_i * one_minus
          positive = (a_v > 0.0).astype(jnp.float32)
          hit = positive * (tnext < SAT).astype(jnp.float32)
          contribute = positive * (tnext >= SAT).astype(jnp.float32) * (1.0 - sat)
          col_hit = jnp.max(hit, axis=0, keepdims=True)      # (1, 256)
          T_at_hit = jnp.max(T_i * hit, axis=0, keepdims=True)
          T_new = jnp.where(col_hit > 0.5, T_at_hit, tnext[-1:, :])
          T_new = jnp.where(sat > 0.5, T, T_new)
          sat = jnp.maximum(sat, col_hit)

          weight = contribute * a_v * T_i                    # (CHUNK, 256)
          acc = acc + jax.lax.dot_general(
              data[8:16, :], weight, (((1,), (0,)), ((), ())),
              preferred_element_type=jnp.float32,
              precision=jax.lax.Precision.HIGHEST)           # (8, 256)
          return (i + 1, T_new, sat, acc)

      init = (jnp.zeros((), jnp.int32),
              jnp.ones((1, PIX), jnp.float32),
              jnp.zeros((1, PIX), jnp.float32),
              jnp.zeros((8, PIX), jnp.float32))
      i_final, T, _, acc = jax.lax.while_loop(cond, body, init)

      @pl.when((i_final < num_chunks) & (num_chunks > 0))
      def _():
          get_dma(i_final).wait()

      out = jnp.concatenate([acc[0:4], 1.0 - T, acc[5:8]], axis=0)
      out_ref[0, :, :] = out


  return kern


def s2_run(mode, data, starts, ends, num_tiles, tiles_per_row):
    """perf_flip_proto.py's build(mode) (:132-142) in interpret mode:
    (num_tiles, 8, 256) f32."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(num_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, 8, PIX), lambda t, s, e: (t, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, 16, CHUNK), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))])
    return pl.pallas_call(
        s2_make_kern(mode, tiles_per_row), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((num_tiles, 8, PIX), jnp.float32),
        interpret=True)(starts, ends, data)
