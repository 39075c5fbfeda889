// One view's gradients added into a batch step's running sums, for NVIDIA
// Hopper (sm_90a), in one pass over the slots
// (training/adam_cuda.py::accumulate_view_gradients, whose plain version is
// accumulate_view_gradients_torch). Per value of the flat (N * 56) feature
// array and of the flat (N * 3) position array:
//   sum_f = sum_f + ((g * scale) * band_mask + direct)
//   sum_p = sum_p + g_pc
// with the running sums read as +0.0 on the batch's first view, and direct
// +0.0 without a regularizer's gradient: the chain the batch step ran in
// torch (zeros, combine_feature_gradients, the two sums), so a first view
// turns a -0.0 into +0.0 as adding to the zeros did.
//
// It replaces no Pallas kernel: the JAX package's batch step sums the views'
// gradients in one jitted function, which XLA fuses. Eager torch ran the
// chain as four dense (N, 56) passes a view besides the zeros.
//
// Bound: bytes. A slot reads the view's feature and position gradients and
// writes the sums (472 bytes) on the first view, and reads the sums too
// (708 bytes) on the others; a direct gradient adds 224. At the 2.08M
// cells' 4,160,000 slots that is 0.59 / 0.88 ms a view at 3.35 TB/s, with
// 3 operations a value. Design: a block of 448 threads (32 feature rows of
// 14 float4 vectors) owns a contiguous tile of 896 vectors of the flat
// feature array (64 rows, 14 KB an array), two 16-byte loads of the view's
// gradient a thread (streaming, evict-first: they are read once) and two of
// the sums, all in flight before the first store; a tile starts on a row,
// so each thread stays on one column group and holds its scale and mask in
// registers; the same block then adds a tile of 896 position values. One
// tile a block, as many blocks as tiles: on an H100 SXM at 700 W that came
// to 88-89% of the bound, where one wave of resident blocks walking the
// array by a grid stride (4 or 8 vectors a thread) came to 82-84%.
//
// Built with -fmad=false (ops/_build.py SOURCE_FLAGS), and every product and
// sum is an _rn intrinsic: each rounds on its own, in the plain version's
// order, so the two agree bit for bit, signed zeros and non-finite values
// included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace t3dgs_acc {
namespace {

constexpr int kVectors = 14;             // float4 vectors of a feature row
constexpr int kBlock = 32 * kVectors;    // 448 threads, 14 warps
constexpr int kUnroll = 2;               // vectors a thread keeps in flight
constexpr int kTile = kUnroll * kBlock;  // a block's values, 64 rows

// (g * s) * m + d, rounded step by step
__device__ __forceinline__ float term(float g, float s, float m, float d) {
  return __fadd_rn(__fmul_rn(__fmul_rn(g, s), m), d);
}

template <bool kFirst, bool kDirect>
__device__ __forceinline__ float4 accumulate(const float4& sum, float4 g,
                                             const float4& d, const float4& s,
                                             const float4& m) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 a = kFirst ? z : sum;
  const float4 e = kDirect ? d : z;
  return make_float4(__fadd_rn(a.x, term(g.x, s.x, m.x, e.x)),
                     __fadd_rn(a.y, term(g.y, s.y, m.y, e.y)),
                     __fadd_rn(a.z, term(g.z, s.z, m.z, e.z)),
                     __fadd_rn(a.w, term(g.w, s.w, m.w, e.w)));
}

template <bool kFirst, bool kDirect>
__global__ void __launch_bounds__(kBlock) accumulate_view_kernel(
    long long vectors, long long positions, const float4* __restrict__ grad,
    const float4* __restrict__ direct, const float4* __restrict__ scale,
    const float4* __restrict__ band_mask, const float* __restrict__ grad_pc,
    float4* __restrict__ sum_f, float* __restrict__ sum_p) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  const int lane = threadIdx.x % kVectors;  // the column group of every i
  const float4 s = scale[lane], m = band_mask[lane];
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 g[kUnroll], d[kUnroll], a[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = base + k * kBlock;
    g[k] = d[k] = a[k] = z;
    if (i < vectors) {
      g[k] = __ldcs(grad + i);
      if (kDirect) d[k] = __ldcs(direct + i);
      if (!kFirst) a[k] = sum_f[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = base + k * kBlock;
    if (i < vectors)
      sum_f[i] = accumulate<kFirst, kDirect>(a[k], g[k], d[k], s, m);
  }

  float gp[kUnroll], ap[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = base + k * kBlock;
    gp[k] = ap[k] = 0.f;
    if (i < positions) {
      gp[k] = __ldcs(grad_pc + i);
      if (!kFirst) ap[k] = sum_p[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = base + k * kBlock;
    if (i < positions) sum_p[i] = __fadd_rn(kFirst ? 0.f : ap[k], gp[k]);
  }
}

template <bool kFirst, bool kDirect>
cudaError_t run(int n, const void* grad, const void* direct,
                const void* scale, const void* band_mask, const void* grad_pc,
                void* sum_f, void* sum_p, cudaStream_t st) {
  // 14 n vectors and 3 n positions: the vectors' tiles cover both
  const long long vectors = static_cast<long long>(n) * kVectors;
  const long long positions = static_cast<long long>(n) * 3;
  const long long tiles = (vectors + kTile - 1) / kTile;
  accumulate_view_kernel<kFirst, kDirect>
      <<<static_cast<unsigned>(tiles), kBlock, 0, st>>>(
          vectors, positions, static_cast<const float4*>(grad),
          static_cast<const float4*>(direct),
          static_cast<const float4*>(scale),
          static_cast<const float4*>(band_mask),
          static_cast<const float*>(grad_pc), static_cast<float4*>(sum_f),
          static_cast<float*>(sum_p));
  return cudaGetLastError();
}

}  // namespace
}  // namespace t3dgs_acc

// Returns a cudaError_t (0 on success). `direct` may be null; the feature
// arrays (grad, direct, scale, band_mask, sum_f) must be 16-byte aligned.
// With `first` nonzero the sums are written without being read.
extern "C" int t3dgs_accumulate_view(int n, const void* grad,
                                     const void* direct, const void* scale,
                                     const void* band_mask,
                                     const void* grad_pc, int first,
                                     void* sum_f, void* sum_p, void* stream) {
  using namespace t3dgs_acc;
  const void* aligned[] = {grad, direct, scale, band_mask, sum_f};
  for (const void* a : aligned) {
    if (reinterpret_cast<uintptr_t>(a) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n < 0 || grad == nullptr || scale == nullptr || band_mask == nullptr ||
      grad_pc == nullptr || sum_f == nullptr || sum_p == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (first) {
    e = direct != nullptr
            ? run<true, true>(n, grad, direct, scale, band_mask, grad_pc,
                              sum_f, sum_p, st)
            : run<true, false>(n, grad, direct, scale, band_mask, grad_pc,
                               sum_f, sum_p, st);
  } else {
    e = direct != nullptr
            ? run<false, true>(n, grad, direct, scale, band_mask, grad_pc,
                               sum_f, sum_p, st)
            : run<false, false>(n, grad, direct, scale, band_mask, grad_pc,
                                sum_f, sum_p, st);
  }
  return static_cast<int>(e);
}
