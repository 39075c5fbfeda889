// Backward of the per-tile front-to-back alpha blend for NVIDIA Hopper
// (sm_90a).
//
// Replaces taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py::_backward_kernel
// (public blend_backward). Inputs: the wide16 slab the forward blended, the
// tile ranges (as the forward's chunk work list), and per pixel
// [g_r, g_g, g_b, C_r, C_g, C_b, last, 0] (the image cotangent, the
// forward's colour and its OUT_LAST_EFF row). Outputs: per key (slab
// column) the 16-row gradient slab (blend_cuda.py GROW_* rows), and per
// pixel [sum |gx|, sum |gy|, 0 ...].
//
// Which keys contribute: a key contributes to a pixel exactly when it is
// not skipped (alpha_exp >= 1/255, blend_common.cuh::blend_alpha) and its
// column is below the forward's `last`. For the sequential forward that is
// the set the forward blended (every key between the last contributing key
// and the saturating one is skipped), and so it is for the chunked forward,
// whose merge stops at the chunk in which the pixel saturated
// (blend_forward.cu). The backward therefore does not re-test saturation,
// and where a chunk's T rounds differently from the sequential T, it still
// gives no gradient to a key the forward did not blend. Each pixel replays the blend front
// to back over those keys. With S = sum_ch g C and the running prefix
// P_i = sum_ch g sum_{j<=i} w_j c_j, the suffix identity gives
// dL/dalpha_i = c_i.g T_i - (S - P_i) / (1 - alpha_i); the 0.99 clamp is
// passed straight through, G = dL/dalpha * exp(exponent).
//
// Bound at the main path's shapes (976x544, the 430k scene's 561,637 keys):
// 68 float operations (one expf, the per-key sums included) per
// contributing (pixel, key) pair and 14 (the exponent, the expf and the
// skip compare) per skipped pair below `last`, against 67 TFLOP/s; the
// slab, pixel_in and the outputs move ~88 MB in ~0.03 ms at 3.35 TB/s. So
// the operations bound it; tests/torch_chunk_fixtures.py work() counts the
// pairs of an input and its bound.
//
// What limited the first design (one block of 256 threads per tile, one
// pixel a thread, batches of 64 keys): per key and hit warp, 11 five-step
// shuffle reductions (55 shuffles, 55 adds), more issue slots than the
// gradient arithmetic; one block per tile, so the longest tile set the
// time (6.2 ms at 1.03M); a device-memory round trip per batch.
// What this design does:
//  - Reduction: a transposed butterfly (butterfly16 below). The warp
//    exchanges halves of a 16-slot vector (the 11 sums padded) over lane
//    distances 16, 8, 4, 2 and 1, so each lane ends up holding one full
//    sum: 16 shuffles per key and warp against 55. Chosen over summing
//    several pixels a thread in registers first, because that took more
//    registers and fewer threads to hide the expf latency, and measured no
//    faster (PERF.md).
//  - Batches of kKeyBatch keys staged by cp.async two batches ahead
//    (blend_common.cuh Stager), as vectors, the colour read only where the
//    key contributes.
//  - Chunks: the forward's work list (blend_cuda.py CHUNK_KEYS = 768, see
//    blend_forward.cu). For a split tile:
//      pass A (backward_chunk_kernel): per chunk but the last and per
//      pixel, T_chunk = prod (1 - alpha_i) and Q_chunk = sum alpha_i T_i
//      (c_i.g) over its contributing keys, from T = 1;
//      pass B (blend_backward_kernel): chunk j replays from
//      T_in = prod_{k<j} T_chunk(k) and P_in = sum_{k<j} T_in(k) Q_chunk(k),
//      exactly as a whole tile does from (1, 0);
//      merge (in pass B, by the tile's last chunk to finish): the per-pixel
//      sums of |gx|, |gy| of the chunks, added in chunk order.
//    Each slab column lies in exactly one chunk of one tile, so a block
//    writes only its own columns of the gradient slab: no atomics. Nothing
//    new passes from the forward but `last`: the chunks' (T_in, P_in) are
//    recomputed here, so blend_backward keeps its signature.
//  - A pixel's keys end at its `last`, so a block walks its range only up
//    to the largest `last` of its pixels; later columns keep the zeros the
//    wrapper allocated.
//
// No fast math (see blend_forward.cu): the skip compare must round as the
// forward's did.

#include "blend_common.cuh"

namespace {

using namespace t3dgs;

constexpr int kWarps = kPixels / 32;
// keys staged and reduced per batch (threads p < kKeyBatch stage them): the
// per-key warp sums of a batch take kSums * kWarps * kKeyBatch floats of
// shared memory, 22.5 KB
constexpr int kKeyBatch = 64;
constexpr int kSums = 11;    // per-key sums, in GROW_* row order below
constexpr int kSlots = 16;   // the sums padded for the butterfly
constexpr int kPixelRows = 8;
constexpr int kRowLast = 6;  // pixel_in row of the forward's `last`
using Rows = SlabRows<false, false>;

// grad slab row of per-key sum k: du dv da db dc dlogw -> 0..5,
// dr dg db -> 8..10, sum |(gx, gy)| -> 11, pixel count -> 12
__device__ __forceinline__ int grad_row(int k) { return k < 6 ? k : k + 2; }

// One step of the transposed butterfly: a lane keeps the half of its
// first 2 HALF slots selected by bit 2 HALF of its lane id, and adds the
// other half of the lane 2 HALF away.
template <int HALF>
__device__ __forceinline__ void butterfly_step(float (&v)[kSlots], int lane) {
  const bool upper = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    // select values, not addresses: v stays in registers
    const float lo = v[i];
    const float hi = v[i + HALF];
    const float send = upper ? lo : hi;
    const float keep = upper ? hi : lo;
    v[i] = keep + __shfl_xor_sync(kFullMask, send, 2 * HALF);
  }
}

// Transposed butterfly: on entry each lane holds 16 values; on exit lane l
// holds the sum over the warp's 32 lanes of value (l >> 1) & 15: 8 + 4 + 2
// + 1 shuffles, then one more at distance 1 to add the two lanes that hold
// the same slot.
__device__ __forceinline__ float butterfly16(float (&v)[kSlots], int lane) {
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFullMask, v[0], 1);
}

// One pixel's inputs, and the largest `last` of the block's pixels (every
// thread calls it: it holds two barriers).
struct PixelIn {
  float px, py, g_r, g_g, g_b, S;
  int last;
};

__device__ __forceinline__ int load_pixel(PixelIn& in, const float* pixel_in,
                                          int tile, int p, int tiles_per_row,
                                          int* s_last) {
  if (p == 0) *s_last = 0;
  __syncthreads();
  const float* pin =
      pixel_in + static_cast<size_t>(tile) * kPixelRows * kPixels + p;
  in.px = pixel_x(tile, p, tiles_per_row);
  in.py = pixel_y(tile, p, tiles_per_row);
  in.g_r = pin[0 * kPixels];
  in.g_g = pin[1 * kPixels];
  in.g_b = pin[2 * kPixels];
  in.S = in.g_r * pin[3 * kPixels] + in.g_g * pin[4 * kPixels] +
         in.g_b * pin[5 * kPixels];
  // the forward's last contributing column + 1, exact below 2^24 (the
  // wrapper refuses larger slabs)
  in.last = static_cast<int>(pin[kRowLast * kPixels]);
  atomicMax(s_last, in.last);
  __syncthreads();
  return *s_last;
}

// One pixel's magnitude rows [sum |gx|, sum |gy|, 0 ...].
__device__ __forceinline__ void write_magnitude(float* mag_out, int tile,
                                                int p, float mx, float my) {
  float* o = mag_out + static_cast<size_t>(tile) * kPixelRows * kPixels + p;
  o[0] = mx;
  o[kPixels] = my;
#pragma unroll
  for (int r = 2; r < kPixelRows; ++r) o[r * kPixels] = 0.0f;
}

// Pass A: (T_chunk, Q_chunk) of every chunk of a split tile but its last.
__global__ void __launch_bounds__(kPixels)
backward_chunk_kernel(const float* __restrict__ data,
                      const int* __restrict__ items, int stride,
                      const float* __restrict__ pixel_in,
                      float* __restrict__ tq, int mk, int tiles_per_row) {
  __shared__ __align__(16) uint32_t raw[2][Rows::kRows][kKeyBatch];
  __shared__ StagedKey keys[kKeyBatch];
  __shared__ int s_last;
  const int i = blockIdx.x;
  const WorkItem w = load_item(items, stride, i);
  if (w.tile < 0 || w.n <= 1 || w.j == w.n - 1) return;
  const int p = threadIdx.x;
  PixelIn in;
  const int block_last =
      load_pixel(in, pixel_in, w.tile, p, tiles_per_row, &s_last);
  float T = 1.0f, Q = 0.0f;
  Stager<Rows, kKeyBatch> st{raw, keys,
                             reinterpret_cast<const uint32_t*>(data),
                             static_cast<size_t>(mk), w.start,
                             min(w.end, block_last), p};
  const int nb = st.batches();
  st.issue(0);
  st.issue(1);
  for (int b = 0; b < nb; ++b) {
    st.wait();
    __syncthreads();
    st.unpack(b);
    __syncthreads();
    st.issue(b + 2);
    const int n = min(st.count(b), in.last - st.first(b));
    for (int jj = 0; jj < n; ++jj) {
      const BlendAlpha a =
          blend_alpha(in.px, in.py, keys[jj].geo, keys[jj].cw, T);
      if (a.kind == kSkip) continue;
      const float4 col = keys[jj].col;
      Q += a.alpha * T * (col.x * in.g_r + col.y * in.g_g + col.z * in.g_b);
      T = a.t_next;
    }
  }
  st.drain();
  tq[(static_cast<size_t>(i) * 2 + 0) * kPixels + p] = T;
  tq[(static_cast<size_t>(i) * 2 + 1) * kPixels + p] = Q;
}

// Pass B: replay one work item, write its columns of the gradient slab and
// its pixels' magnitude sums (the tile's rows of mag_out for a tile of one
// chunk; for a chunk of a split tile, the item's rows of mag_part, which
// the tile's last chunk to finish adds up in chunk order).
__global__ void __launch_bounds__(kPixels)
blend_backward_kernel(const float* __restrict__ data,
                      const int* __restrict__ items, int stride,
                      const float* __restrict__ pixel_in,
                      const float* __restrict__ tq, float* __restrict__ grad,
                      float* __restrict__ mag_part, int* __restrict__ counters,
                      float* __restrict__ mag_out, int num_split_items,
                      int mk, int tiles_per_row) {
  __shared__ __align__(16) uint32_t raw[2][Rows::kRows][kKeyBatch];
  __shared__ StagedKey keys[kKeyBatch];
  __shared__ float warp_sums[kSums][kWarps][kKeyBatch];
  __shared__ int s_last;
  const int i = blockIdx.x;
  const WorkItem w = load_item(items, stride, i);
  // (see blend_forward.cu: dropped only for malformed, overlapping ranges)
  if (w.tile < 0 || (w.n > 1 && i >= num_split_items)) return;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  PixelIn in;
  const int block_last =
      load_pixel(in, pixel_in, w.tile, p, tiles_per_row, &s_last);

  // (T_in, P_in) of chunk j from the earlier chunks' (T_chunk, Q_chunk);
  // prefix = sum_ch g * sum_{j <= i} w_j c_j
  float T = 1.0f, prefix = 0.0f;
  for (int c = 0; c < w.j; ++c) {
    const size_t row = static_cast<size_t>(i - w.j + c) * 2;
    prefix += T * tq[(row + 1) * kPixels + p];
    T *= tq[row * kPixels + p];
  }
  float mag_x = 0.0f, mag_y = 0.0f;
  const size_t smk = static_cast<size_t>(mk);

  Stager<Rows, kKeyBatch> st{raw, keys,
                             reinterpret_cast<const uint32_t*>(data), smk,
                             w.start, min(w.end, block_last), p};
  const int nb = st.batches();
  st.issue(0);
  st.issue(1);
  // Uniform across the block: every thread reaches every barrier and every
  // shuffle; a pixel past its `last` adds zeros.
  for (int b = 0; b < nb; ++b) {
    st.wait();
    // the staged keys and the warp sums of the batch before are free
    __syncthreads();
    st.unpack(b);
    __syncthreads();
    st.issue(b + 2);
    const int n = st.count(b);
    const int col0 = st.first(b);
    for (int jj = 0; jj < n; ++jj) {
      float val[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) val[s] = 0.0f;
      bool hit = false;
      if (col0 + jj < in.last) {
        const float4 geo = keys[jj].geo;
        const float2 cw = keys[jj].cw;
        const BlendAlpha a = blend_alpha(in.px, in.py, geo, cw, T);
        if (a.kind != kSkip) {
          hit = true;
          const float dx = in.px - geo.x;
          const float dy = in.py - geo.y;
          const float4 col = keys[jj].col;
          const float cg = col.x * in.g_r + col.y * in.g_g + col.z * in.g_b;
          const float wt = a.alpha * T;
          prefix += cg * wt;
          const float dlda = cg * T - (in.S - prefix) / (1.0f - a.alpha);
          const float G = dlda * a.alpha_exp;  // straight through the clamp
          const float gx = G * (geo.z * dx + geo.w * dy);
          const float gy = G * (cw.x * dy + geo.w * dx);
          val[0] = gx;
          val[1] = gy;
          val[2] = -0.5f * G * dx * dx;
          val[3] = -G * dx * dy;
          val[4] = -0.5f * G * dy * dy;
          val[5] = G;
          val[6] = in.g_r * wt;
          val[7] = in.g_g * wt;
          val[8] = in.g_b * wt;
          val[9] = sqrtf(gx * gx + gy * gy);
          val[10] = 1.0f;
          mag_x += fabsf(gx);
          mag_y += fabsf(gy);
          T = a.t_next;
        }
      }
      const float sum =
          __any_sync(kFullMask, hit) ? butterfly16(val, lane) : 0.0f;
      const int slot = lane >> 1;
      if ((lane & 1) == 0 && slot < kSums) warp_sums[slot][warp][jj] = sum;
    }
    __syncthreads();
    for (int idx = p; idx < kSums * n; idx += kPixels) {
      const int s = idx / n;
      const int jj = idx - s * n;
      float total = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) total += warp_sums[s][wp][jj];
      grad[grad_row(s) * smk + static_cast<size_t>(col0 + jj)] = total;
    }
  }
  st.drain();

  if (w.n <= 1) {
    write_magnitude(mag_out, w.tile, p, mag_x, mag_y);
    return;
  }
  float* o = mag_part + static_cast<size_t>(i) * 2 * kPixels + p;
  o[0] = mag_x;
  o[kPixels] = mag_y;
  __shared__ int s_last_chunk;
  if (!last_chunk_of_tile(counters, w.tile, w.n, &s_last_chunk)) return;
  float mx = 0.0f, my = 0.0f;
  for (int c = 0; c < w.n; ++c) {
    // written by other blocks: read past the L1 cache
    const float* src =
        mag_part + static_cast<size_t>(i - w.j + c) * 2 * kPixels + p;
    mx += __ldcg(src);
    my += __ldcg(src + kPixels);
  }
  write_magnitude(mag_out, w.tile, p, mx, my);
}

}  // namespace

// data: (16, mk) wide16 slab; tile_starts/ends, num_tiles, chunk, items,
// num_items, num_split_items, counters: as for t3dgs_blend_forward (the
// same work list); pixel_in: (num_tiles, 8, 256) f32 with the forward's
// `last` in row 6; tq and mag_part: (max(num_split_items, 1), 2, 256) f32
// scratch; grad: (16, mk) f32, ZEROED by the caller; mag: (num_tiles, 8,
// 256) f32, every element written. Launches the work list, pass A (if
// num_split_items > 0) and pass B on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 on success).
extern "C" int t3dgs_blend_backward(const void* data, const void* tile_starts,
                                    const void* tile_ends, int num_tiles,
                                    int chunk, void* items, int num_items,
                                    int num_split_items, void* counters,
                                    const void* pixel_in, void* tq,
                                    void* mag_part, void* grad, void* mag,
                                    int mk, int tiles_per_row, void* stream) {
  if (num_tiles <= 0 || chunk <= 0 || num_items <= 0 ||
      num_split_items < 0 || num_split_items > num_items ||
      tiles_per_row <= 0 || mk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* it = static_cast<int*>(items);
  int* cn = static_cast<int*>(counters);
  cudaError_t e = build_work(static_cast<const int*>(tile_starts),
                             static_cast<const int*>(tile_ends), num_tiles,
                             mk, chunk, cn, it, num_items, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* d = static_cast<const float*>(data);
  const float* pin = static_cast<const float*>(pixel_in);
  float* t = static_cast<float*>(tq);
  if (num_split_items > 0) {
    backward_chunk_kernel<<<num_split_items, kPixels, 0, st>>>(
        d, it, num_items, pin, t, mk, tiles_per_row);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  blend_backward_kernel<<<num_items, kPixels, 0, st>>>(
      d, it, num_items, pin, t, static_cast<float*>(grad),
      static_cast<float*>(mag_part), cn, static_cast<float*>(mag),
      num_split_items, mk, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}
