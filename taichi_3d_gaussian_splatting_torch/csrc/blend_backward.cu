// Backward of the per-tile front-to-back alpha blend for NVIDIA Hopper
// (sm_90a).
//
// Replaces taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py::_backward_kernel
// (public blend_backward). Inputs: the wide16 slab the forward blended, the
// tile ranges, and per pixel [g_r, g_g, g_b, C_r, C_g, C_b, 0, 0] (the image
// cotangent and the forward's colour). Outputs: per key (slab column) the
// 16-row gradient slab (blend_cuda.py GROW_* rows), and per pixel
// [sum |gx|, sum |gy|, 0 ...].
//
// Layout: one block of 256 threads per 16x16 tile, one thread per pixel, as
// in the forward. Each pixel replays the forward front to back through the
// same alpha step (blend_common.cuh::blend_alpha), so a key contributes here
// exactly where it contributed in the forward kernel. With S = sum_ch g C and
// the running prefix P_i = sum_ch g sum_{j<=i} w_j c_j, the suffix identity
// gives dL/dalpha_i = c_i.g T_i - (S - P_i) / (1 - alpha_i); the 0.99 clamp
// is passed straight through, G = dL/dalpha * exp(exponent), and skipped,
// saturating and later keys give 0.
//
// Per key, eleven sums over the tile's 256 pixels (du, dv, da, db, dc,
// dlogw, dr, dg, db, sum |(gx, gy)|, contributing pixels): each warp sums
// its 32 pixels with shuffles (skipped when no pixel of the warp was hit),
// lane 0 parks the warp's sums in shared memory, and after the batch the
// block adds the 8 warps' sums and writes the batch's columns. Every slab
// column belongs to exactly one tile (the binning emits each key once), so
// a block writes only its own [start, end) columns: no atomics. The TPU
// kernel's read-modify-write of a shared first chunk existed only for its
// 128-aligned chunks and has no counterpart here. Columns after the block
// leaves early keep the zeros the wrapper allocated.
//
// What bounds it: per (pixel, key) one expf and ~40 FMAs, plus per key and
// warp 55 shuffles when the warp was hit; device memory carries the staged
// slab columns (36 bytes per key) and 11 words written per key.
//
// No fast math (see blend_forward.cu): the replay's threshold compares must
// round as the forward's did.

#include "blend_common.cuh"

namespace {

using namespace t3dgs;

constexpr int kBatch = 64;   // keys staged and reduced per batch
constexpr int kWarps = kPixels / 32;
constexpr int kSums = 11;    // per-key sums, in GROW_* row order below
constexpr int kPixelRows = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// grad slab row of per-key sum k: du dv da db dc dlogw -> 0..5,
// dr dg db -> 8..10, sum |(gx, gy)| -> 11, pixel count -> 12
__device__ __forceinline__ int grad_row(int k) { return k < 6 ? k : k + 2; }

struct KeyBatch {
  float u[kBatch], v[kBatch], a[kBatch], b[kBatch], c[kBatch], logw[kBatch];
  float r[kBatch], g[kBatch], bl[kBatch];
};

__global__ void __launch_bounds__(kPixels)
blend_backward_kernel(const float* __restrict__ data,
                      const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_ends,
                      const float* __restrict__ pixel_in,
                      float* __restrict__ grad, float* __restrict__ mag_out,
                      int mk, int tiles_per_row) {
  __shared__ KeyBatch s;
  __shared__ float warp_sums[kSums][kWarps][kBatch];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = pixel_x(t, p, tiles_per_row);
  const float py = pixel_y(t, p, tiles_per_row);
  const int start = max(tile_starts[t], 0);
  const int end = min(tile_ends[t], mk);

  const float* pin = pixel_in + static_cast<size_t>(t) * kPixelRows * kPixels + p;
  const float g_r = pin[0 * kPixels];
  const float g_g = pin[1 * kPixels];
  const float g_b = pin[2 * kPixels];
  const float S = g_r * pin[3 * kPixels] + g_g * pin[4 * kPixels] +
                  g_b * pin[5 * kPixels];

  float T = 1.0f;
  float prefix = 0.0f;  // sum_ch g * sum_{j <= i} w_j c_j
  float mag_x = 0.0f, mag_y = 0.0f;
  bool done = false;
  const size_t smk = static_cast<size_t>(mk);

  // Uniform across the block: every thread reaches every barrier and every
  // shuffle; a done pixel adds zeros.
  for (int batch = start; batch < end; batch += kBatch) {
    // Barrier before overwriting the staged keys and the warp sums; the
    // whole block leaves once every pixel has saturated.
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kBatch, end - batch);
    if (p < n) {
      const size_t col = static_cast<size_t>(batch + p);
      s.u[p] = data[kRowU * smk + col];
      s.v[p] = data[kRowV * smk + col];
      s.a[p] = data[kRowA * smk + col];
      s.b[p] = data[kRowB * smk + col];
      s.c[p] = data[kRowC * smk + col];
      s.logw[p] = data[kRowLogw * smk + col];
      s.r[p] = data[kRowR * smk + col];
      s.g[p] = data[kRowG * smk + col];
      s.bl[p] = data[kRowBCol * smk + col];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float val[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) val[k] = 0.0f;
      bool hit = false;
      if (!done) {
        const BlendAlpha st = blend_alpha(px, py, s.u[j], s.v[j], s.a[j],
                                          s.b[j], s.c[j], s.logw[j], T);
        if (st.kind == kSaturate) {
          done = true;
        } else if (st.kind == kContribute) {
          hit = true;
          const float dx = px - s.u[j];
          const float dy = py - s.v[j];
          const float cg = s.r[j] * g_r + s.g[j] * g_g + s.bl[j] * g_b;
          const float w = st.alpha * T;
          prefix += cg * w;
          const float dlda = cg * T - (S - prefix) / (1.0f - st.alpha);
          const float G = dlda * st.alpha_exp;  // straight through the clamp
          const float gx = G * (s.a[j] * dx + s.b[j] * dy);
          const float gy = G * (s.c[j] * dy + s.b[j] * dx);
          val[0] = gx;
          val[1] = gy;
          val[2] = -0.5f * G * dx * dx;
          val[3] = -G * dx * dy;
          val[4] = -0.5f * G * dy * dy;
          val[5] = G;
          val[6] = g_r * w;
          val[7] = g_g * w;
          val[8] = g_b * w;
          val[9] = sqrtf(gx * gx + gy * gy);
          val[10] = 1.0f;
          mag_x += fabsf(gx);
          mag_y += fabsf(gy);
          T = st.t_next;
        }
      }
      if (__any_sync(kFullMask, hit)) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            val[k] += __shfl_down_sync(kFullMask, val[k], off);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) warp_sums[k][warp][j] = val[k];
      }
    }
    __syncthreads();
    for (int i = p; i < kSums * n; i += kPixels) {
      const int k = i / n;
      const int j = i - k * n;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += warp_sums[k][w][j];
      grad[grad_row(k) * smk + static_cast<size_t>(batch + j)] = sum;
    }
  }

  float* o = mag_out + static_cast<size_t>(t) * kPixelRows * kPixels + p;
  o[0] = mag_x;
  o[kPixels] = mag_y;
#pragma unroll
  for (int r = 2; r < kPixelRows; ++r) o[r * kPixels] = 0.0f;
}

}  // namespace

// data: (16, mk) wide16 slab; tile_starts/ends: (num_tiles,) int32;
// pixel_in: (num_tiles, 8, 256) f32; grad: (16, mk) f32, ZEROED by the
// caller; mag: (num_tiles, 8, 256) f32, every element written. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int t3dgs_blend_backward(const void* data, const void* tile_starts,
                                    const void* tile_ends, const void* pixel_in,
                                    void* grad, void* mag, int mk,
                                    int num_tiles, int tiles_per_row,
                                    void* stream) {
  if (num_tiles <= 0 || tiles_per_row <= 0 || mk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  blend_backward_kernel<<<dim3(static_cast<unsigned>(num_tiles)),
                          dim3(t3dgs::kPixels), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(tile_starts),
      static_cast<const int*>(tile_ends), static_cast<const float*>(pixel_in),
      static_cast<float*>(grad), static_cast<float*>(mag), mk, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}
