// S2: keys by pixels, the blend exponent as a tensor-core product, for
// NVIDIA Hopper (sm_90a).
//
// Replaces scratch/perf_flip_proto.py:140 (the pl.pallas_call built by
// build(mode), :139, of make_kern(mode), :40), a TPU prototype of K1 with
// keys on sublanes and pixels on lanes. Its plain version and wrapper are
// probes/perf_flip_proto.py. Slab rows 0-7 are per-key coefficients of a
// quadratic in ABSOLUTE pixel coordinates (c_xx, c_xy, c_yy, c_x, c_y, c_1,
// then two rows the zero monomials take), rows 8-15 the accumulated rows.
// Per 128-key chunk aligned down from the tile's first key
// (probe_common.cuh):
//   E (128 keys x 256 pixels) = coef^T . mono, mono(p) = [px^2, px py, py^2,
//   px, py, 1, 0, 0] (px up to 976);
// then each pixel walks its column of E over the chunk's keys in order:
// alpha = exp(E), K1's skip, clamp, saturation stop and latch, and the 8
// rows 8-15 accumulated with w = alpha T. Output (num_tiles, 8, 256) f32
// rows [acc0, acc1, acc2, acc3, 1 - T, acc5, acc6, acc7]. Modes (template
// parameter MODE): full; no_scan, where every key of a chunk sees the
// chunk's starting T (the TPU masks' saturation, as S4's no_scan).
//
// The product on the tensor cores, in FP64: mma.sync m8n8k4 .f64 (DMMA).
// The terms reach ~5e4 (0.05 x 976^2; c_1 ~ -6e4) and cancel to an
// exponent near -1, so a product that keeps ~3 decimal digits (TF32) moves
// the exponent by tens. A 3xTF32 split (big.big + big.small + small.big)
// represents a float32 coefficient only to ~2^-22 and drops small.small,
// ~2^-21 of each term: ~0.02 absolute at 5e4, more than float32's own
// ~3e-3; making it exact needs a three-way split of the coefficients and
// five products. FP64 holds every float32 coefficient and monomial
// exactly (px^2 of a half-integer pixel is exact in 22 bits), every
// product exactly, and the sum of 8 to ~1e-11, so E is the correctly
// rounded exponent: more accurate than the float32 product of the plain
// version, whose decisions at the 1/255 and 1e-4 gates the phase that runs
// this kernel counts. H100's FP64 tensor cores run at 67 TFLOP/s.
//
// Layout: one block of 256 threads per tile. Warp w computes the E columns
// of pixels 32w..32w+31 (four 8-pixel B fragments, fixed per tile, in
// registers) for all 16 key tiles of 8; E lives in shared memory with a
// row pitch of 264 floats (the fragments' float2 stores are then free of
// bank conflicts), 135 KB, with the chunk's 16 rows double-buffered by
// cp.async (16 KB): 151.5 KB of dynamic shared memory, one block per SM.
// The colour accumulation is FFMA: a pixel adds 8 rows only for the keys
// it blends (a few per pixel), too few for a product.
//
// Bound: the product, 128 x 256 x 8 FMAs a chunk, ~4 us a frame of S2's
// layout at 67 TFLOP/s; the walk, ~13 float operations and one exp per
// evaluated pair (~0.03 ms for S2's 1.66e8 pairs at 67 TFLOP/s); exp on
// the SFU, 16 a clock per SM. No fast math.

#include "probe_common.cuh"

namespace {

using namespace t3dgs;
using namespace t3dgs::probes;

enum Mode { kFull = 0, kNoScan = 1, kModes = 2 };

constexpr int kRows = 16;
constexpr int kEPitch = kPixels + 8;
constexpr size_t kSmemBytes =
    sizeof(float) * (kChunk * kEPitch + 2 * kRows * kChunk);

// D = A . B + C for one 8x8x4 FP64 tile (fragments: A[g][q], B[q][g],
// C/D[g][2q], [g][2q + 1], with g = lane / 4, q = lane % 4).
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b, double c0, double c1) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%4, %5};\n"
      : "=d"(d0), "=d"(d1)
      : "d"(a), "d"(b), "d"(c0), "d"(c1));
}

template <int MODE>
__global__ void __launch_bounds__(kPixels)
flip_proto_kernel(const float* __restrict__ data,
                  const int* __restrict__ tile_starts,
                  const int* __restrict__ tile_ends, float* __restrict__ out,
                  int mk, int tiles_per_row) {
  extern __shared__ __align__(16) float smem[];
  float* E = smem;                              // [kChunk][kEPitch]
  float* rows = smem + kChunk * kEPitch;        // [2][kRows][kChunk]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const ChunkRange cr = chunk_range(tile_starts, tile_ends, t, mk);

  // B fragments: mono_j of pixel 32 warp + 8 pt + g, j = q and 4 + q
  double b_lo[4], b_hi[4];
#pragma unroll
  for (int pt = 0; pt < 4; ++pt) {
    const int pix = warp * 32 + pt * 8 + g;
    const float x = pixel_x(t, pix, tiles_per_row);
    const float y = pixel_y(t, pix, tiles_per_row);
    const float mono[8] = {x * x, x * y, y * y, x, y, 1.0f, 0.0f, 0.0f};
    b_lo[pt] = static_cast<double>(mono[q]);
    b_hi[pt] = static_cast<double>(mono[4 + q]);
  }

  // chunk i's 16 rows into rows[i & 1]: two 16-byte copies a thread
  auto issue = [&](int i) {
    const size_t col0 = static_cast<size_t>(cr.aligned) + i * kChunk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = p + h * kPixels;  // 0..511: row idx / 32, float4 idx % 32
      const int r = idx >> 5;
      const int c4 = (idx & 31) * 4;
      __pipeline_memcpy_async(rows + ((i & 1) * kRows + r) * kChunk + c4,
                              data + r * static_cast<size_t>(mk) + col0 + c4,
                              16);
    }
    __pipeline_commit();
  };

  float T = 1.0f;
  float acc[8] = {};
  bool sat = false;
  if (cr.chunks > 0) issue(0);
  for (int i = 0; i < cr.chunks; ++i) {
    __pipeline_wait_prior(0);  // chunk i has landed (the only copy in flight)
    // every thread has left chunk i - 1's walk: E and rows[(i + 1) & 1] free
    if (__syncthreads_count(!sat) == 0) break;
    if (i + 1 < cr.chunks) issue(i + 1);
    const float* R = rows + (i & 1) * kRows * kChunk;

    // E = coef^T . mono on the tensor cores, in FP64
#pragma unroll 2
    for (int kt = 0; kt < kChunk / 8; ++kt) {
      const int key = kt * 8 + g;
      const double a_lo = static_cast<double>(R[q * kChunk + key]);
      const double a_hi = static_cast<double>(R[(4 + q) * kChunk + key]);
#pragma unroll
      for (int pt = 0; pt < 4; ++pt) {
        double d0, d1;
        dmma(d0, d1, a_lo, b_lo[pt], 0.0, 0.0);
        dmma(d0, d1, a_hi, b_hi[pt], d0, d1);
        *reinterpret_cast<float2*>(E + key * kEPitch + warp * 32 + pt * 8 +
                                   2 * q) =
            make_float2(static_cast<float>(d0), static_cast<float>(d1));
      }
    }
    __syncthreads();

    if (sat) continue;
    const int col0 = cr.aligned + i * kChunk;
    const int lo = max(0, cr.start - col0);
    const int hi = min(kChunk, cr.end - col0);
    const float t0 = T;  // no_scan: the chunk's starting T
    bool hit = false;
    float t_hit = 0.0f, t_last = t0;
    for (int k = lo; k < hi; ++k) {
      const float alpha_exp = expf(E[k * kEPitch + p]);
      if (!(alpha_exp >= kAlphaSkip)) continue;
      const float alpha = fminf(alpha_exp, kAlphaClamp);
      const float one_minus = 1.0f - alpha;
      float w;
      if (MODE == kFull) {
        const float t_next = T * one_minus;
        if (t_next < kSaturation) {  // the saturating key does not contribute
          sat = true;
          break;
        }
        w = alpha * T;
        T = t_next;
      } else {
        const float t_i = t0 * one_minus;
        const float t_next = t_i * one_minus;
        if (k == kChunk - 1) t_last = t_next;
        if (t_next < kSaturation) {
          hit = true;
          t_hit = fmaxf(t_hit, t_i);
          continue;
        }
        w = alpha * t_i;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] += w * R[(8 + r) * kChunk + k];
    }
    if (MODE == kNoScan) {
      T = hit ? t_hit : t_last;
      sat = hit;
    }
  }
  float* o = out + static_cast<size_t>(t) * 8 * kPixels + p;
#pragma unroll
  for (int r = 0; r < 8; ++r) o[r * kPixels] = r == 4 ? 1.0f - T : acc[r];
}

template <int MODE>
cudaError_t launch(const float* d, const int* s, const int* e, int tiles,
                   float* o, int mk, int tpr, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flip_proto_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  flip_proto_kernel<MODE><<<tiles, kPixels, kSmemBytes, st>>>(d, s, e, o, mk,
                                                              tpr);
  return cudaGetLastError();
}

}  // namespace

// data: (16, mk) f32 slab of S2's rows, mk a multiple of 128, 16-byte
// aligned; tile_starts/ends: (num_tiles,) int32; out: (num_tiles, 8, 256)
// f32, every element written. mode: 0 full, 1 no_scan. Launches one block
// per tile on `stream`; returns the first CUDA error (0 on success).
extern "C" int t3dgs_probe_flip_proto(const void* data,
                                      const void* tile_starts,
                                      const void* tile_ends, int num_tiles,
                                      int mk, int tiles_per_row, int mode,
                                      void* out, void* stream) {
  if (num_tiles <= 0 || mk < 0 || mk % kChunk != 0 || tiles_per_row <= 0 ||
      mode < 0 || mode >= kModes ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* d = static_cast<const float*>(data);
  const int* s = static_cast<const int*>(tile_starts);
  const int* e = static_cast<const int*>(tile_ends);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      mode == kFull
          ? launch<kFull>(d, s, e, num_tiles, o, mk, tiles_per_row, st)
          : launch<kNoScan>(d, s, e, num_tiles, o, mk, tiles_per_row, st);
  return static_cast<int>(err);
}
