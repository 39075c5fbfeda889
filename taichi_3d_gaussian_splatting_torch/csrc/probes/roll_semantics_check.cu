// S6: does the card's data movement match the semantics the plain versions
// assume? For NVIDIA Hopper (sm_90a).
//
// Replaces scratch/roll_semantics_check.py:34 (the pl.pallas_call of
// kernel(x_ref, o_ref, *, interpret), :21, run by run(interpret), :31), a
// TPU check that pltpu.roll on the chip moves rows as jnp.roll does in
// interpret mode, the assumption of the JAX package's sublane prefix scans
// (blend_pallas.py _sub_cumprod_exclusive / _sub_cumsum_exclusive). Its
// plain version and wrappers are probes/roll_semantics_check.py. Two
// kernels:
//
// roll_planes_kernel, on x (8, 128) f32, writes out (3, 8, 128):
//   out[0] = roll(x, 1, axis 0), wrapped;
//   out[1] = the exclusive doubling product along axis 0;
//   out[2] = the exclusive doubling sum along axis 0.
// Each column's 8 rows lie on an 8-lane segment of a warp (thread 8c + r
// holds row r of column c; one block of 1,024 threads). The roll is
// __shfl_sync from lane (r + 7) & 7 of the segment, which wraps; a doubling
// step is __shfl_up_sync(k, width 8) followed by the r < k select.
// shfl_up returns the lane's own value below k and the select discards it,
// as the TPU code discards the rows its roll wraps, so the planes are
// bitwise those of the plain version. The select follows the shuffle, so
// all 32 lanes stay converged for the full mask.
//
// work_list_scan_kernel runs the production scan block_exclusive_sum
// (../blend_common.cuh, included and not copied: the scan that places every
// work item of K1/K2/K3, build_work_kernel) on one int2 per thread of one
// block of exactly kBuildThreads = 1,024 threads, the block size its
// __shared__ array is sized by, and writes each thread's exclusive sums and
// the totals it returned: out (1024, 4) int32 [x, y, total x, total y].
//
// Bound: 16 KB in and out (a few ns at 3.35 TB/s); the launch (a few us)
// is what a call costs.

#include "../blend_common.cuh"

namespace {

constexpr int kRows = 8;
constexpr int kCols = 128;

__global__ void __launch_bounds__(kRows * kCols)
roll_planes_kernel(const float* __restrict__ x, float* __restrict__ out) {
  using t3dgs::kFullMask;
  const int c = threadIdx.x / kRows;
  const int r = threadIdx.x % kRows;  // the lane's place in its segment
  const float v = x[r * kCols + c];
  const float roll1 = __shfl_sync(kFullMask, v, (r + kRows - 1) & (kRows - 1),
                                  kRows);
  const float shifted = __shfl_up_sync(kFullMask, v, 1, kRows);
  float prod = r < 1 ? 1.0f : shifted;
  float sum = r < 1 ? 0.0f : shifted;
#pragma unroll
  for (int k = 1; k < kRows; k <<= 1) {
    const float p = __shfl_up_sync(kFullMask, prod, k, kRows);
    const float s = __shfl_up_sync(kFullMask, sum, k, kRows);
    prod = __fmul_rn(prod, r < k ? 1.0f : p);
    sum = __fadd_rn(sum, r < k ? 0.0f : s);
  }
  out[r * kCols + c] = roll1;
  out[(kRows + r) * kCols + c] = prod;
  out[(2 * kRows + r) * kCols + c] = sum;
}

__global__ void __launch_bounds__(t3dgs::kBuildThreads)
work_list_scan_kernel(const int2* __restrict__ in, int4* __restrict__ out) {
  int2 v = in[threadIdx.x];
  const int2 total = t3dgs::block_exclusive_sum(v);
  out[threadIdx.x] = make_int4(v.x, v.y, total.x, total.y);
}

}  // namespace

// x: (8, 128) f32; out: (3, 8, 128) f32, every element written. Launches
// one block on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int t3dgs_probe_roll_planes(const void* x, void* out,
                                       void* stream) {
  roll_planes_kernel<<<1, kRows * kCols, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// in: (1024, 2) int32, 8-byte aligned; out: (1024, 4) int32, 16-byte
// aligned, every element written. Launches one block of kBuildThreads
// threads on `stream`; returns the first CUDA error (0 on success).
extern "C" int t3dgs_probe_work_list_scan(const void* in, void* out,
                                          void* stream) {
  if (reinterpret_cast<uintptr_t>(in) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  work_list_scan_kernel<<<1, t3dgs::kBuildThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(in), static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
