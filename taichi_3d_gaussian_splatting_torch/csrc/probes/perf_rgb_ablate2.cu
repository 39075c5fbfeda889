// S4: the port's K1 (blend_forward.cu, RGB_ONLY on the wide16 slab) with its
// stages stripped in turn, for NVIDIA Hopper (sm_90a).
//
// Replaces scratch/perf_rgb_ablate2.py:112 (the pl.pallas_call of
// make_kernel(mode, tiles_per_row), :22), a TPU probe that ranked the TPU
// K1's stages. Its plain version and wrapper are
// probes/perf_rgb_ablate2.py. Modes (template parameter MODE, one
// instantiation each, so that a stripped stage is absent from the code):
//   full      K1's blend: the exponent and expf (blend_common.cuh
//             blend_alpha), the 1/255 skip, the running transmittance, the
//             1e-4 saturation stop (the saturating key does not contribute),
//             the colour accumulation, and the tile's exit once every pixel
//             has latched; equal to K1's result;
//   no_sat    no saturation test and no exit: every non-skipped key adds
//             alpha^2 T times its colour (the probe's `contribute = a_v`),
//             and a chunk hands on T before its last key (:69-71);
//   no_scan   no running product: every key of a chunk sees the chunk's
//             starting T (T_i = T (1 - alpha)); saturation as the TPU
//             kernel's masks (:65-66, _saturation_masks): a key with
//             T_i (1 - alpha) < 1e-4 latches the pixel and does not
//             contribute, later keys of the chunk still do, and the pixel
//             hands on the largest such T_i (or T_i (1 - alpha) of the
//             chunk's last key when none latched);
//   dma_only  the staging alone: each pixel sums the colour rows (r, g, b,
//             one) of every column of every chunk, masks not applied
//             (:57-60).
// Output (num_tiles, 8, 256) f32 rows [r, g, b, 1 - T, sum w, 0, 0, 0]
// (sum w is the `one` row's sum).
//
// Kept from K1 so that the times rank K1's own stages: one block of 256
// threads per tile, one pixel a thread, keys staged by cp.async two
// batches of 256 ahead (blend_common.cuh Stager), the same alpha step, and
// the block's exit test once per batch. Not kept: K1's work list, which
// cuts a long tile into 768-key chunks blended in separate blocks from a
// transmittance that pass A computes ahead. That product is the carry of
// `full` and `no_sat` only: `no_scan`'s carry depends on which keys latch,
// which depends on T itself. So every mode walks a whole tile in one block,
// as the TPU probe's program did; at 430k no tile splits in K1 either.
//
// Bound: as K1 (PERF.md section 6): per evaluated (pixel, key) pair ~14
// float operations, per contributing one ~27, against 67 TFLOP/s; the slab
// (10 rows read, 40 bytes a key) moves in ~0.01 ms at 3.35 TB/s. No fast
// math: the 1/255 and 1e-4 compares flip on an approximate exp.

#include "probe_common.cuh"

namespace {

using namespace t3dgs;
using namespace t3dgs::probes;

enum Mode { kFull = 0, kNoSat = 1, kNoScan = 2, kDmaOnly = 3, kModes = 4 };

// The staged rows, as raw words: wide16 rows 0-5 (u, v, a, b, c, logw),
// 8-10 (r, g, b) and 12 (one); col = (r, g, b, one). Every mode stages
// them, so that only the stage a mode strips differs.
struct Rows10 {
  static constexpr int kRows = 10;
  __device__ static __forceinline__ int src_row(int r) {
    return r < 6 ? r : (r < 9 ? r + 2 : 12);
  }
  template <int BATCH>
  __device__ static __forceinline__ StagedKey unpack(uint32_t (*raw)[BATCH],
                                                    int k) {
    StagedKey s;
    s.geo = make_float4(__uint_as_float(raw[0][k]), __uint_as_float(raw[1][k]),
                        __uint_as_float(raw[2][k]), __uint_as_float(raw[3][k]));
    s.cw = make_float2(__uint_as_float(raw[4][k]), __uint_as_float(raw[5][k]));
    s.col = make_float4(__uint_as_float(raw[6][k]), __uint_as_float(raw[7][k]),
                        __uint_as_float(raw[8][k]), __uint_as_float(raw[9][k]));
    return s;
  }
};

template <int MODE>
__global__ void __launch_bounds__(kPixels)
rgb_ablate_kernel(const uint32_t* __restrict__ data,
                  const int* __restrict__ tile_starts,
                  const int* __restrict__ tile_ends, float* __restrict__ out,
                  int mk, int tiles_per_row) {
  // modes whose pixels latch, and so whose tile can leave early
  constexpr bool kLatches = MODE == kFull || MODE == kNoScan;
  __shared__ __align__(16) uint32_t raw[2][Rows10::kRows][kPixels];
  __shared__ StagedKey keys[kPixels];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const ChunkRange cr = chunk_range(tile_starts, tile_ends, t, mk);
  const float px = pixel_x(t, p, tiles_per_row);
  const float py = pixel_y(t, p, tiles_per_row);
  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_n = 0.0f;
  bool sat = false;

  Stager<Rows10, kPixels> st{raw, keys, data, static_cast<size_t>(mk),
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
    const int n = st.count(b);  // one or two whole chunks
    const int col0 = st.first(b);
    if (MODE == kDmaOnly) {
      for (int jj = 0; jj < n; ++jj) {
        const float4 c = keys[jj].col;
        acc_r += c.x;
        acc_g += c.y;
        acc_b += c.z;
        acc_n += c.w;
      }
      continue;
    }
    for (int c0 = 0; c0 < n && !sat; c0 += kChunk) {
      // the chunk's keys inside the tile's range (the others are masked)
      const int lo = max(c0, cr.start - col0);
      const int hi = min(c0 + kChunk, cr.end - col0);
      const int last = c0 + kChunk - 1;
      if (MODE == kFull) {
        for (int jj = lo; jj < hi; ++jj) {
          const BlendAlpha a =
              blend_alpha(px, py, keys[jj].geo, keys[jj].cw, T);
          if (a.kind == kSkip) continue;
          if (a.kind == kSaturate) {  // the saturating key does not contribute
            sat = true;
            break;
          }
          const float4 c = keys[jj].col;
          const float wt = a.alpha * T;
          acc_r += wt * c.x;
          acc_g += wt * c.y;
          acc_b += wt * c.z;
          acc_n += wt * c.w;
          T = a.t_next;
        }
      } else if (MODE == kNoSat) {
        for (int jj = lo; jj < hi; ++jj) {
          const BlendAlpha a =
              blend_alpha(px, py, keys[jj].geo, keys[jj].cw, T);
          if (a.kind == kSkip) continue;
          const float4 c = keys[jj].col;
          const float wt = a.alpha * a.alpha * T;
          acc_r += wt * c.x;
          acc_g += wt * c.y;
          acc_b += wt * c.z;
          acc_n += wt * c.w;
          if (jj != last) T = a.t_next;
        }
      } else {  // kNoScan
        const float t0 = T;
        bool hit = false;
        float t_hit = 0.0f;
        float t_last = t0;  // a masked or skipped last key leaves T
        for (int jj = lo; jj < hi; ++jj) {
          const BlendAlpha a =
              blend_alpha(px, py, keys[jj].geo, keys[jj].cw, t0);
          if (a.kind == kSkip) continue;
          const float t_i = a.t_next;  // t0 (1 - alpha)
          const float t_next = t_i * (1.0f - a.alpha);
          if (t_next < kSaturation) {
            hit = true;
            t_hit = fmaxf(t_hit, t_i);
          } else {
            const float4 c = keys[jj].col;
            const float wt = a.alpha * t_i;
            acc_r += wt * c.x;
            acc_g += wt * c.y;
            acc_b += wt * c.z;
            acc_n += wt * c.w;
          }
          if (jj == last) t_last = t_next;
        }
        T = hit ? t_hit : t_last;
        sat = hit;
      }
    }
  }
  st.drain();
  float* o = out + static_cast<size_t>(t) * 8 * kPixels + p;
  o[0 * kPixels] = acc_r;
  o[1 * kPixels] = acc_g;
  o[2 * kPixels] = acc_b;
  o[3 * kPixels] = 1.0f - T;
  o[4 * kPixels] = acc_n;
  o[5 * kPixels] = 0.0f;
  o[6 * kPixels] = 0.0f;
  o[7 * kPixels] = 0.0f;
}

template <int MODE>
cudaError_t launch(const uint32_t* d, const int* s, const int* e, int tiles,
                   float* o, int mk, int tpr, cudaStream_t st) {
  rgb_ablate_kernel<MODE><<<tiles, kPixels, 0, st>>>(d, s, e, o, mk, tpr);
  return cudaGetLastError();
}

}  // namespace

// data: (16, mk) f32 wide16 slab, mk a multiple of 128 (columns past the
// keys zero); tile_starts/ends: (num_tiles,) int32; out: (num_tiles, 8,
// 256) f32, every element written. mode: 0 full, 1 no_sat, 2 no_scan,
// 3 dma_only. Launches one block per tile on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int t3dgs_probe_rgb_ablate2(const void* data,
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
    case kNoSat:
      err = launch<kNoSat>(d, s, e, num_tiles, o, mk, tpr, st);
      break;
    case kNoScan:
      err = launch<kNoScan>(d, s, e, num_tiles, o, mk, tpr, st);
      break;
    default: err = launch<kDmaOnly>(d, s, e, num_tiles, o, mk, tpr, st); break;
  }
  return static_cast<int>(err);
}
