// S5: the instruction mixes of K1's inner loop, each on its own, for NVIDIA
// Hopper (sm_90a).
//
// Replaces scratch/perf_roll_micro.py:65 (the pl.pallas_call built by
// build(mode, shape), :64, of make_kernel(mode), :13), a TPU micro-bench of
// a lane-roll scan against a sublane-roll scan against exp. Its plain
// version and wrapper are probes/perf_roll_micro.py. Each of `programs`
// programs owns one block of 32,768 floats, (256, 128) or, for sub and
// exp, (128, 256), and applies one step `reps` times in a chain (the TPU
// probe: 256 programs, 300 repetitions). The steps (template parameter
// MODE), with the TPU probe's constants rounded to float32 as JAX's weak
// types round them:
//   mul7   seven a = a * 0.9999 + 1e-6;
//   lane   an inclusive doubling product along axis 1 of (256, 128): for
//          k = 1, 2, ..., 64, a[c] *= (c < k ? 1 : a[c - k]);
//   sub    the same along axis 0 of (128, 256);
//   exp    a = expf(a * 0.999) * 0.5, at either shape (the shape a run-time
//          parameter: the elements are independent);
//   mxu    a = a * 1e-3 + (a[:, 0:8] . a[0:8, :]) * 1e-6;
//   mxu_t  the same product formed transposed, (a[0:8, :]^T . a[:, 0:8]^T)^T
//          (the TPU probe's transposed-LHS contraction).
// Every step performs the TPU probe's operations in its order, each product
// and sum rounded on its own (__fmul_rn / __fadd_rn, which the compiler
// never contracts into an FMA), so that mul7, lane and sub are bitwise
// equal to the plain version. The scans are Hillis-Steele: each step reads
// the previous step's values before it writes.
//
// Layout: one block of 1,024 threads per program (256 blocks: 1.94 waves
// on 132 SMs, one block an SM, so the time holds the second wave's tail);
// the block's 32,768 floats stay on chip, 32 a thread in registers, and
// nothing goes to device memory inside the repetitions.
//   mul7, exp  element j of thread t at j * 1024 + t of the block.
//   lane       warp w holds rows 8w..8w+7, lane l columns 4l..4l+3 of each
//              row: a whole 128-column row lies in one warp. Steps k = 1, 2
//              multiply inside the thread, the first k columns of a lane by
//              __shfl_up_sync(1) from the lane before; steps k = 4m move
//              all four columns by __shfl_up_sync(m). shfl_up returns a
//              lane's own value below m, which the c < k select discards,
//              as the TPU's select discards the wrapped lanes of its roll.
//   sub        thread t holds columns 4(t % 64)..+3 of rows 16i + t / 64
//              (i < 8) as float4s; each step is a store of the block to
//              shared memory (128 KB, one block an SM), a barrier, a load of
//              row (r - k) mod 128 (the roll, wrapped as the TPU's) and a
//              barrier. Shared memory's 128 bytes a clock bound it: 256 KB
//              a step, ~4.3 ms for the whole call.
//   mxu(_t)    the 512 8x8 output tiles, 16 a warp, each an FP64 tensor-
//              core product (mma.sync m8n8k4 .f64, two of them for the 8
//              terms): float32 values and their products are exact in
//              FP64, so the sum is rounded once to float32, as the TPU's
//              Precision.HIGHEST product comes within an ulp of it (TF32
//              would move it by ~1e-3 relative). Warp w owns tile column
//              w % 16 and every other tile row, so its B fragments are read
//              once a repetition. Each thread
//              holds its tiles' accumulator fragments; per repetition the
//              owners of a[:, 0:8] and a[0:8, :] write them to shared memory
//              as doubles, a barrier, every warp reads its fragments, a
//              barrier before the next repetition writes. mxu_t swaps the
//              operands (A read from a[0:8, :] transposed) and owns the
//              transposed fragment. The width is a constant: a run-time
//              width kept 16 tile addresses live and spilled 1.7 KB.
// The repetitions are a loop of `reps` trips at run time (#pragma unroll 1),
// which no compiler can fold. sub asks for one block an SM in its launch
// bounds: without it ptxas gave the barrier kernels 32 registers and
// spilled (measured: ~1.4 KB and 10x the time).
//
// Bound: 2 x 32 MiB of input and output at 3.35 TB/s (~0.02 ms) against
// the operations of 256 x 32,768 elements x 300 repetitions: mul7 14 float
// operations an element (0.53 ms at 67 TFLOP/s; without contraction each
// is an instruction, so the FP32 pipes' 33.5e12 instructions a second give
// 1.05 ms), lane and sub 7 multiplies, exp 2 multiplies and one expf on
// the SFU (16 a clock per SM: ~0.6 ms), mxu 16 FP64 tensor-core operations
// an element at 67 TFLOP/s (0.60 ms) beside 3 float operations. No fast
// math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode {
  kMul7 = 0,
  kLane = 1,
  kSub = 2,
  kExp = 3,
  kMxu = 4,
  kMxuT = 5,
  kModes = 6
};

constexpr int kThreads = 1024;
constexpr int kBlock = 32768;             // floats of one program
constexpr int kPer = kBlock / kThreads;   // a thread's share
constexpr int kScan = 128;                // the scanned axis of lane and sub
constexpr int kLaneRows = 8;              // rows of a warp in lane
constexpr int kSubCols = kBlock / kScan;  // columns of sub's block
constexpr int kTerms = 8;                 // the product's depth
constexpr int kCols = 128;                // the width of (256, 128)
constexpr unsigned kFull = 0xffffffffu;
// the TPU probe's Python constants as float32 rounds them
constexpr float kMulC = 0.9999f;
constexpr float kAddC = 1e-6f;
constexpr float kExpC = 0.999f;
constexpr float kHalf = 0.5f;
constexpr float kAccC = 1e-3f;
constexpr float kDotC = 1e-6f;
constexpr size_t kSubSmem = sizeof(float) * kBlock;

template <int MODE>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int reps) {
  const size_t base =
      static_cast<size_t>(blockIdx.x) * kBlock + threadIdx.x;
  float a[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) a[j] = x[base + j * kThreads];
#pragma unroll 1
  for (int i = 0; i < reps; ++i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      float v = a[j];
      if (MODE == kMul7) {
#pragma unroll
        for (int s = 0; s < 7; ++s) {
          v = __fadd_rn(__fmul_rn(v, kMulC), kAddC);
        }
      } else {
        v = __fmul_rn(expf(__fmul_rn(v, kExpC)), kHalf);
      }
      a[j] = v;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[base + j * kThreads] = a[j];
}

// Steps k = 1, 2 of lane on one row's four columns 4l..4l+3: column j >= K
// takes column j - K of the same lane (old value: j descends), column
// j < K column 4 - K + j of the lane before (shuffled before any update).
template <int K>
__device__ __forceinline__ void lane_step_in_thread(float (&a)[4], int lane) {
  float left[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    left[j] = __shfl_up_sync(kFull, a[4 - K + j], 1);
  }
#pragma unroll
  for (int j = 3; j >= K; --j) a[j] = __fmul_rn(a[j], a[j - K]);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    a[j] = __fmul_rn(a[j], lane < 1 ? 1.0f : left[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
lane_scan_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int reps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * kBlock +
                      static_cast<size_t>(warp * kLaneRows) * kScan + 4 * lane;
  float a[kLaneRows][4];
#pragma unroll
  for (int r = 0; r < kLaneRows; ++r) {
    const float4 v = *reinterpret_cast<const float4*>(x + base + r * kScan);
    a[r][0] = v.x;
    a[r][1] = v.y;
    a[r][2] = v.z;
    a[r][3] = v.w;
  }
#pragma unroll 1
  for (int i = 0; i < reps; ++i) {
#pragma unroll
    for (int r = 0; r < kLaneRows; ++r) {
      lane_step_in_thread<1>(a[r], lane);
      lane_step_in_thread<2>(a[r], lane);
#pragma unroll
      for (int m = 1; m < 32; m <<= 1) {  // k = 4m: column c - k, lane l - m
        float rolled[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          rolled[j] = __shfl_up_sync(kFull, a[r][j], m);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[r][j] = __fmul_rn(a[r][j], lane < m ? 1.0f : rolled[j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kLaneRows; ++r) {
    *reinterpret_cast<float4*>(out + base + r * kScan) =
        make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
sub_scan_kernel(const float* __restrict__ x, float* __restrict__ out,
                int reps) {
  extern __shared__ float4 block4[];  // [kScan][kSubCols / 4]
  constexpr int kQuads = kSubCols / 4;        // 64 column quads a row
  constexpr int kGroups = kThreads / kQuads;  // 16 row groups
  constexpr int kRowsT = kScan / kGroups;     // 8 rows a thread
  const int cq = threadIdx.x % kQuads;
  const int g = threadIdx.x / kQuads;
  const float4* x4 = reinterpret_cast<const float4*>(x) +
                     static_cast<size_t>(blockIdx.x) * (kBlock / 4);
  float4* o4 = reinterpret_cast<float4*>(out) +
               static_cast<size_t>(blockIdx.x) * (kBlock / 4);
  float4 a[kRowsT];
#pragma unroll
  for (int m = 0; m < kRowsT; ++m) {
    a[m] = x4[(kGroups * m + g) * kQuads + cq];
  }
#pragma unroll 1
  for (int i = 0; i < reps; ++i) {
#pragma unroll
    for (int k = 1; k < kScan; k <<= 1) {
#pragma unroll
      for (int m = 0; m < kRowsT; ++m) {
        block4[(kGroups * m + g) * kQuads + cq] = a[m];
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kRowsT; ++m) {
        const int r = kGroups * m + g;
        const float4 v = block4[((r - k) & (kScan - 1)) * kQuads + cq];
        const bool keep = r < k;
        a[m].x = __fmul_rn(a[m].x, keep ? 1.0f : v.x);
        a[m].y = __fmul_rn(a[m].y, keep ? 1.0f : v.y);
        a[m].z = __fmul_rn(a[m].z, keep ? 1.0f : v.z);
        a[m].w = __fmul_rn(a[m].w, keep ? 1.0f : v.w);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int m = 0; m < kRowsT; ++m) {
    o4[(kGroups * m + g) * kQuads + cq] = a[m];
  }
}

// D = A . B + C for one 8x8x4 FP64 tile (fragments: A[g][q], B[q][g],
// C/D[g][2q], [g][2q + 1], with g = lane / 4, q = lane % 4).
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// The (row, column) of element e of the fragment that the thread holds of
// output tile (tr, tc): mxu's D[g][2q + e], mxu_t's transposed.
template <int MODE>
__device__ __forceinline__ int2 fragment_at(int tr, int tc, int g, int q,
                                            int e) {
  return MODE == kMxu ? make_int2(8 * tr + g, 8 * tc + 2 * q + e)
                      : make_int2(8 * tr + 2 * q + e, 8 * tc + g);
}

// On (256, 128): warp w owns output tile column tc = w % 16 and tile rows
// w / 16 + 2i, i < 16.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
mxu_kernel(const float* __restrict__ x, float* __restrict__ out, int reps) {
  constexpr int kRowsB = kBlock / kCols;
  constexpr int kTpr = kCols / 8;
  constexpr int kStep = 32 / kTpr;
  constexpr int kTilesPerWarp = kBlock / 64 / (kThreads / 32);
  __shared__ double lhs[kRowsB * kTerms];
  __shared__ double rhs[kTerms * kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int tc = warp % kTpr;
  const int tr0 = warp / kTpr;
  const size_t base = static_cast<size_t>(blockIdx.x) * kBlock;
  float a[kTilesPerWarp][2];
#pragma unroll
  for (int i = 0; i < kTilesPerWarp; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int2 p = fragment_at<MODE>(tr0 + kStep * i, tc, g, q, e);
      a[i][e] = x[base + p.x * kCols + p.y];
    }
  }
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    if (tc == 0) {
#pragma unroll
      for (int i = 0; i < kTilesPerWarp; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int2 p = fragment_at<MODE>(tr0 + kStep * i, 0, g, q, e);
          lhs[p.x * kTerms + p.y] = a[i][e];
        }
      }
    }
    if (tr0 == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int2 p = fragment_at<MODE>(0, tc, g, q, e);
        rhs[p.x * kCols + p.y] = a[0][e];
      }
    }
    __syncthreads();
    const double fb0 = rhs[q * kCols + 8 * tc + g];        // B[q][g], k 0-3
    const double fb1 = rhs[(4 + q) * kCols + 8 * tc + g];  // k 4-7
#pragma unroll
    for (int i = 0; i < kTilesPerWarp; ++i) {
      const int tr = tr0 + kStep * i;
      const double fa0 = lhs[(8 * tr + g) * kTerms + q];
      const double fa1 = lhs[(8 * tr + g) * kTerms + 4 + q];
      double d0 = 0.0, d1 = 0.0;
      if (MODE == kMxu) {
        dmma(d0, d1, fa0, fb0);
        dmma(d0, d1, fa1, fb1);
      } else {
        dmma(d0, d1, fb0, fa0);
        dmma(d0, d1, fb1, fa1);
      }
      a[i][0] = __fadd_rn(__fmul_rn(a[i][0], kAccC),
                          __fmul_rn(__double2float_rn(d0), kDotC));
      a[i][1] = __fadd_rn(__fmul_rn(a[i][1], kAccC),
                          __fmul_rn(__double2float_rn(d1), kDotC));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTilesPerWarp; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int2 p = fragment_at<MODE>(tr0 + kStep * i, tc, g, q, e);
      out[base + p.x * kCols + p.y] = a[i][e];
    }
  }
}

cudaError_t launch(int mode, const float* x, int programs, int reps,
                   float* out, cudaStream_t st) {
  switch (mode) {
    case kMul7:
      elementwise_kernel<kMul7><<<programs, kThreads, 0, st>>>(x, out, reps);
      break;
    case kExp:
      elementwise_kernel<kExp><<<programs, kThreads, 0, st>>>(x, out, reps);
      break;
    case kLane:
      lane_scan_kernel<<<programs, kThreads, 0, st>>>(x, out, reps);
      break;
    case kSub: {
      static bool configured = false;
      if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            sub_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(kSubSmem));
        if (err != cudaSuccess) return err;
        configured = true;
      }
      sub_scan_kernel<<<programs, kThreads, kSubSmem, st>>>(x, out, reps);
      break;
    }
    case kMxu:
      mxu_kernel<kMxu><<<programs, kThreads, 0, st>>>(x, out, reps);
      break;
    default:
      mxu_kernel<kMxuT><<<programs, kThreads, 0, st>>>(x, out, reps);
      break;
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: (programs, rows, cols) f32, 16-byte aligned, (rows, cols) =
// (128, 256) for sub, (256, 128) for the others, exp also (128, 256).
// mode: 0 mul7, 1 lane, 2 sub, 3 exp, 4 mxu, 5 mxu_t. Every
// element of out is written. Launches one block per program on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int t3dgs_probe_roll_micro(const void* x, int programs, int rows,
                                      int cols, int reps, int mode, void* out,
                                      void* stream) {
  const bool wide = rows == 256 && cols == 128;
  const bool tall = rows == 128 && cols == 256;
  const bool shape_ok = mode == kSub ? tall : (wide || (mode == kExp && tall));
  if (programs < 1 || reps < 0 || mode < 0 || mode >= kModes || !shape_ok ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch(mode, static_cast<const float*>(x), programs,
                                 reps, static_cast<float*>(out),
                                 static_cast<cudaStream_t>(stream)));
}
