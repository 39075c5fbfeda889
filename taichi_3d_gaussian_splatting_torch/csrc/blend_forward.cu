// Per-tile front-to-back alpha blend for NVIDIA Hopper (sm_90a).
//
// Replaces taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py::_forward_kernel
// in both of its instances: blend_forward_rgb (RGB_ONLY, wide16 or packed8
// slab) and blend_forward (full outputs, wide16 slab). Its backward is
// blend_backward.cu, which replays this blend through the same alpha step
// (blend_common.cuh::blend_alpha).
//
// Layout: one block of 256 threads per 16x16 tile, one thread per pixel
// (p = v_in * 16 + u_in, centre + 0.5). The tile's depth-sorted keys
// [tile_starts[t], tile_ends[t]) are staged through shared memory in batches
// of 256: thread k loads column k of each slab row, which coalesces because
// the slab is row-major (rows, MK), and unpacks it to f32 (40 bytes per key,
// 10 KB per batch). Every thread then walks the batch in order.
//
// What bounds it: per (pixel, key) one expf and a handful of FMAs on values
// broadcast from shared memory, so expf throughput and shared-memory reads
// set the rate; device memory carries only the staged slab columns
// (32 or 64 bytes per key per tile) and the 8 KB output per tile. A pixel
// stops at saturation, and the block stops staging once all 256 are done.
//
// Deliberately not carried over from the TPU kernel: its tile-centred
// monomial matmul for the exponent and its log-doubling prefix product for
// the transmittance. A sequential per-pixel loop is the natural form here.
// It rounds differently, so the kernel is compared with its plain version
// (blend_cuda.py::blend_forward_torch) and with the TPU kernel under
// tolerances, not bitwise.
//
// No fast math: the 1/255 skip gate and the 1e-4 saturation stop are
// threshold compares, and an approximate exp would flip keys at the edge.

#include "blend_common.cuh"

namespace {

using namespace t3dgs;

constexpr int kBatch = kPixels;  // keys staged per batch
constexpr int kOutRows = 8;

struct KeyBatch {
  float u[kBatch], v[kBatch], a[kBatch], b[kBatch], c[kBatch], logw[kBatch];
  float r[kBatch], g[kBatch], bl[kBatch], depth[kBatch];
};

template <bool PACKED8, bool RGB_ONLY>
__device__ __forceinline__ void stage_key(KeyBatch& s, const void* data,
                                          size_t mk, size_t col, int slot) {
  if (PACKED8) {
    // rows 0-5: f32 bit patterns; row 6: bf16(r)|bf16(g); row 7:
    // bf16(b)|bf16(depth). A bf16's bits are the top half of its f32.
    const uint32_t* d = static_cast<const uint32_t*>(data);
    s.u[slot] = __uint_as_float(d[0 * mk + col]);
    s.v[slot] = __uint_as_float(d[1 * mk + col]);
    s.a[slot] = __uint_as_float(d[2 * mk + col]);
    s.b[slot] = __uint_as_float(d[3 * mk + col]);
    s.c[slot] = __uint_as_float(d[4 * mk + col]);
    s.logw[slot] = __uint_as_float(d[5 * mk + col]);
    const uint32_t rg = d[6 * mk + col];
    const uint32_t bd = d[7 * mk + col];
    s.r[slot] = __uint_as_float(rg & 0xFFFF0000u);
    s.g[slot] = __uint_as_float(rg << 16);
    s.bl[slot] = __uint_as_float(bd & 0xFFFF0000u);
    if (!RGB_ONLY) s.depth[slot] = __uint_as_float(bd << 16);
  } else {
    const float* d = static_cast<const float*>(data);
    s.u[slot] = d[kRowU * mk + col];
    s.v[slot] = d[kRowV * mk + col];
    s.a[slot] = d[kRowA * mk + col];
    s.b[slot] = d[kRowB * mk + col];
    s.c[slot] = d[kRowC * mk + col];
    s.logw[slot] = d[kRowLogw * mk + col];
    s.r[slot] = d[kRowR * mk + col];
    s.g[slot] = d[kRowG * mk + col];
    s.bl[slot] = d[kRowBCol * mk + col];
    if (!RGB_ONLY) s.depth[slot] = d[kRowDepth * mk + col];
  }
}

template <bool PACKED8, bool RGB_ONLY>
__global__ void __launch_bounds__(kPixels)
blend_forward_kernel(const void* __restrict__ data,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_ends,
                     float* __restrict__ out, int mk, int tiles_per_row) {
  __shared__ KeyBatch s;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = pixel_x(t, p, tiles_per_row);
  const float py = pixel_y(t, p, tiles_per_row);
  // clamped into [0, mk]: a malformed range reads no memory outside the
  // slab (the wrapper cannot check the values without a host sync)
  const int start = max(tile_starts[t], 0);
  const int end = min(tile_ends[t], mk);

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_w = 0.0f, acc_d = 0.0f;
  int last = 0;
  int count = 0;
  bool done = false;

  // The batch loop is uniform across the block: every thread, done or not,
  // reaches both barriers of every batch.
  for (int batch = start; batch < end; batch += kBatch) {
    // Barrier before overwriting the staged batch; the whole block leaves
    // once every pixel has saturated.
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kBatch, end - batch);
    if (p < n) {
      stage_key<PACKED8, RGB_ONLY>(s, data, static_cast<size_t>(mk),
                                   static_cast<size_t>(batch + p), p);
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      const BlendAlpha st = blend_alpha(px, py, s.u[j], s.v[j], s.a[j], s.b[j],
                                        s.c[j], s.logw[j], T);
      if (st.kind == kSkip) continue;
      if (st.kind == kSaturate) {  // the saturating key does not contribute
        done = true;
        break;
      }
      const float w = st.alpha * T;
      acc_r += w * s.r[j];
      acc_g += w * s.g[j];
      acc_b += w * s.bl[j];
      acc_w += w;
      if (!RGB_ONLY) {
        acc_d += w * s.depth[j];
        last = batch + j + 1;
        ++count;
      }
      T = st.t_next;
    }
  }

  // every output element is written, empty tiles included
  float* o = out + static_cast<size_t>(t) * kOutRows * kPixels + p;
  o[0 * kPixels] = acc_r;
  o[1 * kPixels] = acc_g;
  o[2 * kPixels] = acc_b;
  o[3 * kPixels] = RGB_ONLY ? 0.0f : acc_d / fmaxf(acc_w, 1e-6f);
  o[4 * kPixels] = 1.0f - T;
  o[5 * kPixels] = acc_w;
  o[6 * kPixels] = RGB_ONLY ? 0.0f : static_cast<float>(last);
  o[7 * kPixels] = RGB_ONLY ? 0.0f : static_cast<float>(count);
}

}  // namespace

// data: (8 or 16, mk) slab; tile_starts/ends: (num_tiles,) int32;
// out: (num_tiles, 8, 256) f32. Launches on `stream` and returns
// cudaGetLastError() (0 on success). packed8 requires rgb_only.
extern "C" int t3dgs_blend_forward(const void* data, const void* tile_starts,
                                   const void* tile_ends, void* out, int mk,
                                   int num_tiles, int tiles_per_row,
                                   int packed8, int rgb_only, void* stream) {
  if (num_tiles <= 0 || tiles_per_row <= 0 || mk < 0 ||
      (packed8 && !rgb_only)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(num_tiles));
  const dim3 block(t3dgs::kPixels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* starts = static_cast<const int*>(tile_starts);
  const int* ends = static_cast<const int*>(tile_ends);
  float* o = static_cast<float*>(out);
  if (packed8) {
    blend_forward_kernel<true, true>
        <<<grid, block, 0, st>>>(data, starts, ends, o, mk, tiles_per_row);
  } else if (rgb_only) {
    blend_forward_kernel<false, true>
        <<<grid, block, 0, st>>>(data, starts, ends, o, mk, tiles_per_row);
  } else {
    blend_forward_kernel<false, false>
        <<<grid, block, 0, st>>>(data, starts, ends, o, mk, tiles_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}
