// S3: one stage of the K1 skeleton removed at a time, on S3's synthetic
// layout, for NVIDIA Hopper (sm_90a).
//
// Replaces scratch/perf_kernel_ablate.py:116 (the pl.pallas_call built by
// build(mode), :107, of make_kernel(mode), :19). That file no longer runs
// (it imports helpers ops/blend_pallas.py removed in acf080a); its
// semantics are the kernel body as written against the helpers of
// acf080a^ (keys on lanes: _lane_cumprod_exclusive, the lanes version of
// _saturation_masks, _tile_pixel_coords). Its plain version and wrapper are
// probes/perf_kernel_ablate.py. Per 128-key chunk aligned down from the
// tile's first key (probe_common.cuh), with exponent
// (a dx + b dy) dx + c dy^2 + logw, dx = px - u, dy = py - v (rows
// 2, 3, 4 = a, b, c as they are: no -1/2), and modes (template parameter
// MODE, one instantiation each):
//   full      expf, the 1/255 skip, clamp 0.99, running transmittance,
//             the 1e-4 saturation stop and latch, the 8 colour rows
//             (8..15) accumulated (the TPU's matrix-unit product);
//   dma_only  the staging alone: every pixel and output column sums row 0
//             over every column of every chunk, unmasked (:53-55);
//   no_exp    the exponent itself is alpha (:63-64);
//   no_scan   every key of a chunk sees the chunk's starting T, with the
//             TPU masks' saturation (as S4's no_scan);
//   no_sat    every non-skipped key contributes alpha T (`contribute` is
//             a_v > 0), no latch and no exit, and a chunk hands on T before
//             its last key (:77-79);
//   no_mxu    the weights' sum replaces the colour product: every output
//             column gets sum w (:84-85).
// Output (num_tiles, 256, 8) f32, pixel-major as the TPU probe's.
//
// The K1 skeleton of perf_rgb_ablate2.cu (S4): one block of 256 threads per
// tile, one pixel a thread, every mode staging the same 14 rows (0-5,
// 8-15) by cp.async two batches of 256 ahead, so that a mode differs from
// `full` only by the stage it removes. Bound: operations (14 rows, 56
// bytes a key, move in ~0.01 ms at 3.35 TB/s; a contributing pair costs
// ~34 float operations, an evaluated one ~13). No fast math.

#include "probe_common.cuh"

namespace {

using namespace t3dgs;
using namespace t3dgs::probes;

enum Mode {
  kFull = 0, kDmaOnly = 1, kNoExp = 2, kNoScan = 3, kNoSat = 4, kNoMxu = 5,
  kModes = 6
};

struct Key14 {
  float4 geo;  // u, v, a, b
  float2 cw;   // c, logw
  float4 c0;   // rows 8-11
  float4 c1;   // rows 12-15
};

// wide16 rows 0-5 and 8-15
struct Rows14 {
  static constexpr int kRows = 14;
  using Key = Key14;
  __device__ static __forceinline__ int src_row(int r) {
    return r < 6 ? r : r + 2;
  }
  template <int BATCH>
  __device__ static __forceinline__ Key14 unpack(uint32_t (*raw)[BATCH],
                                                int k) {
    Key14 s;
    s.geo = make_float4(__uint_as_float(raw[0][k]), __uint_as_float(raw[1][k]),
                        __uint_as_float(raw[2][k]), __uint_as_float(raw[3][k]));
    s.cw = make_float2(__uint_as_float(raw[4][k]), __uint_as_float(raw[5][k]));
    s.c0 = make_float4(__uint_as_float(raw[6][k]), __uint_as_float(raw[7][k]),
                       __uint_as_float(raw[8][k]), __uint_as_float(raw[9][k]));
    s.c1 = make_float4(__uint_as_float(raw[10][k]),
                       __uint_as_float(raw[11][k]),
                       __uint_as_float(raw[12][k]),
                       __uint_as_float(raw[13][k]));
    return s;
  }
};

struct Acc8 {
  float v[8];
  __device__ __forceinline__ void add(float w, const Key14& k) {
    v[0] += w * k.c0.x;
    v[1] += w * k.c0.y;
    v[2] += w * k.c0.z;
    v[3] += w * k.c0.w;
    v[4] += w * k.c1.x;
    v[5] += w * k.c1.y;
    v[6] += w * k.c1.z;
    v[7] += w * k.c1.w;
  }
};

template <int MODE>
__global__ void __launch_bounds__(kPixels)
kernel_ablate_kernel(const uint32_t* __restrict__ data,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_ends,
                     float* __restrict__ out, int mk, int tiles_per_row) {
  constexpr bool kLatches = MODE == kFull || MODE == kNoExp ||
                            MODE == kNoScan || MODE == kNoMxu;
  __shared__ __align__(16) uint32_t raw[2][Rows14::kRows][kPixels];
  __shared__ Key14 keys[kPixels];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const ChunkRange cr = chunk_range(tile_starts, tile_ends, t, mk);
  const float px = pixel_x(t, p, tiles_per_row);
  const float py = pixel_y(t, p, tiles_per_row);
  float T = 1.0f;
  Acc8 acc = {};
  float acc_w = 0.0f;  // no_mxu's sum of weights, dma_only's sum of row 0
  bool sat = false;

  KeyStager<Rows14, kPixels> st{raw, keys, data, static_cast<size_t>(mk),
                                cr.aligned, cr.stop(), p};
  const int nb = st.batches();
  st.issue(0);
  st.issue(1);
  for (int b = 0; b < nb; ++b) {
    st.wait();
    if (kLatches) {
      if (__syncthreads_count(!sat) == 0) break;
    } else {
      __syncthreads();
    }
    st.unpack(b);
    __syncthreads();
    st.issue(b + 2);
    const int n = st.count(b);
    const int col0 = st.first(b);
    if (MODE == kDmaOnly) {
      for (int jj = 0; jj < n; ++jj) acc_w += keys[jj].geo.x;
      continue;
    }
    for (int c0 = 0; c0 < n && !sat; c0 += kChunk) {
      const int lo = max(c0, cr.start - col0);
      const int hi = min(c0 + kChunk, cr.end - col0);
      const int last = c0 + kChunk - 1;
      const float t0 = T;  // no_scan: the chunk's starting T
      bool hit = false;
      float t_hit = 0.0f, t_last = t0;
      for (int jj = lo; jj < hi; ++jj) {
        const Key14& key = keys[jj];
        const float dx = px - key.geo.x;
        const float dy = py - key.geo.y;
        const float e = (key.geo.z * dx + key.geo.w * dy) * dx +
                        (key.cw.x * dy * dy + key.cw.y);
        const float alpha_exp = MODE == kNoExp ? e : expf(e);
        if (!(alpha_exp >= kAlphaSkip)) continue;
        const float alpha = fminf(alpha_exp, kAlphaClamp);
        const float one_minus = 1.0f - alpha;
        if (MODE == kNoSat) {
          acc.add(alpha * T, key);
          if (jj != last) T = T * one_minus;
        } else if (MODE == kNoScan) {
          const float t_i = t0 * one_minus;
          const float t_next = t_i * one_minus;
          if (t_next < kSaturation) {
            hit = true;
            t_hit = fmaxf(t_hit, t_i);
          } else {
            acc.add(alpha * t_i, key);
          }
          if (jj == last) t_last = t_next;
        } else {  // full, no_exp, no_mxu
          const float t_next = T * one_minus;
          if (t_next < kSaturation) {
            sat = true;
            break;
          }
          const float w = alpha * T;
          if (MODE == kNoMxu) {
            acc_w += w;
          } else {
            acc.add(w, key);
          }
          T = t_next;
        }
      }
      if (MODE == kNoScan) {
        T = hit ? t_hit : t_last;
        sat = hit;
      }
    }
  }
  st.drain();
  float4* o = reinterpret_cast<float4*>(
      out + (static_cast<size_t>(t) * kPixels + p) * 8);
  if (MODE == kDmaOnly || MODE == kNoMxu) {
    o[0] = make_float4(acc_w, acc_w, acc_w, acc_w);
    o[1] = make_float4(acc_w, acc_w, acc_w, acc_w);
  } else {
    o[0] = make_float4(acc.v[0], acc.v[1], acc.v[2], acc.v[3]);
    o[1] = make_float4(acc.v[4], acc.v[5], acc.v[6], acc.v[7]);
  }
}

template <int MODE>
cudaError_t launch(const uint32_t* d, const int* s, const int* e, int tiles,
                   float* o, int mk, int tpr, cudaStream_t st) {
  kernel_ablate_kernel<MODE><<<tiles, kPixels, 0, st>>>(d, s, e, o, mk, tpr);
  return cudaGetLastError();
}

}  // namespace

// data: (16, mk) f32 slab, mk a multiple of 128; tile_starts/ends:
// (num_tiles,) int32; out: (num_tiles, 256, 8) f32, every element written.
// mode: 0 full, 1 dma_only, 2 no_exp, 3 no_scan, 4 no_sat, 5 no_mxu.
// Launches one block per tile on `stream`; returns cudaGetLastError().
extern "C" int t3dgs_probe_kernel_ablate(const void* data,
                                         const void* tile_starts,
                                         const void* tile_ends, int num_tiles,
                                         int mk, int tiles_per_row, int mode,
                                         void* out, void* stream) {
  if (num_tiles <= 0 || mk < 0 || mk % kChunk != 0 || tiles_per_row <= 0 ||
      mode < 0 || mode >= kModes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* d = static_cast<const uint32_t*>(data);
  const int* s = static_cast<const int*>(tile_starts);
  const int* e = static_cast<const int*>(tile_ends);
  float* o = static_cast<float*>(out);
  const int tpr = tiles_per_row;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kFull: err = launch<kFull>(d, s, e, num_tiles, o, mk, tpr, st); break;
    case kDmaOnly:
      err = launch<kDmaOnly>(d, s, e, num_tiles, o, mk, tpr, st);
      break;
    case kNoExp:
      err = launch<kNoExp>(d, s, e, num_tiles, o, mk, tpr, st);
      break;
    case kNoScan:
      err = launch<kNoScan>(d, s, e, num_tiles, o, mk, tpr, st);
      break;
    case kNoSat:
      err = launch<kNoSat>(d, s, e, num_tiles, o, mk, tpr, st);
      break;
    default: err = launch<kNoMxu>(d, s, e, num_tiles, o, mk, tpr, st); break;
  }
  return static_cast<int>(err);
}
