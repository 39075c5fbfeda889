// The image terms of the training loss and their gradient for NVIDIA
// Hopper (sm_90a), with no intermediate map in device memory
// (training/loss_cuda.py::image_loss, whose plain version image_loss_torch
// is the clamp, training/loss.py::image_terms and torch.autograd.grad).
// From a render x (H, W, 3), before the clamp, and the ground truth y:
//   x1 = clamp(x, 0, 1),  L1 = mean |x1 - y| over 3 H W,
//   SSIM = mean over 3 (H - 10)(W - 10) of the SSIM map of
//          training/ssim.py (11-tap gaussian, VALID, C1 = 1e-4, C2 = 9e-4),
//   L = (1 - lambda) L1 + lambda (1 - SSIM),
// and dL/dx = [0 <= x <= 1] ((1 - lambda) / (3 H W) sign(x1 - y)
//             - lambda / (3 (H - 10)(W - 10)) dS),
//   dS = B'(D_mu) + 2 x1 B'(D_11) + y B'(D_12),
// where B' is the transposed blur and D_mu, D_11, D_12 the SSIM map's
// derivatives with respect to mu1, sigma1^2 and sigma12 (sigma1^2 and
// sigma12 held; D_mu takes in their own dependence on mu1):
//   l = A1 / B1, cs = A2 / B2, S = l cs,
//   D_12 = 2 l / B2, D_11 = -S / B2,
//   D_mu = 2 cs (mu2 - l mu1) / B1 - mu2 D_12 - 2 mu1 D_11.
// sign(0) is 0 (torch.abs's backward) and the clamp passes its gradient at
// both ends, 0 and 1 (torch.clamp's backward).
//
// It replaces no Pallas kernel: the JAX package leaves the loss and its
// gradient to XLA. The port ran it as some 150 eager ops, ten cuDNN
// depthwise convolutions and torch.autograd.grad a step.
//
// Bound: operations. At 976x544 (1.59M values) it reads the render and the
// ground truth and writes the gradient and the clamped render: 16 bytes a
// value, 25.5 MB, 7.6 us at 3.35 TB/s; it does about 400 operations a value
// (the five blurs' two 11-tap passes, 220; the three transposed blurs',
// 132; the SSIM map, its derivatives, the L1 term, ~45), 0.64 GFLOP, 9.5 us
// at 67 TFLOP/s.
//
// Design: a block owns one channel of a 32x32 tile of pixels. It loads the
// channel's render (clamped) and ground truth over the tile and 10 pixels
// on each side (52x52) into shared memory, blurs the five maps vertically
// then horizontally (the plain version's order) over the SSIM map's
// positions that reach the tile (42x42), computes there the map and its
// three derivative maps (over the inputs, which are no longer read),
// applies the transposed blur, horizontal then vertical (the plain
// version's order), and writes the tile's gradient and clamped render
// once. In each pass a thread takes a run of neighbouring outputs and
// reads each input of the run's reach once (`taps_run`): 4x fewer loads
// from shared memory than one output a thread, whose loads bound the first
// form (on an H100 SXM at 700 W, 0.081 ms a call at 976x544; 0.053 ms with
// the runs and the global loads in flight together). Each SSIM position and each pixel is summed
// by the one block that owns it; the block's sums go to scratch in double,
// and a second launch of one block adds them up in a fixed order: the loss
// is the same on every run, with no float atomics. Full float32 with IEEE
// division:
// sigma = blur(x^2) - mu^2 cancels (training/ssim.py), so the squares and
// products are rounded on their own before the subtraction, as the plain
// version's ops round them.

#include <cuda_runtime.h>
#include <stddef.h>

namespace t3dgs_loss {
namespace {

constexpr int kWin = 11;
constexpr int kReach = kWin - 1;             // 10
constexpr int kTile = 32;                    // pixels a side of a block
constexpr int kIn = kTile + 2 * kReach;      // 52: the inputs a side
constexpr int kMap = kTile + kReach;         // 42: SSIM positions a side
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = (kIn * kIn + kThreads - 1) / kThreads;
// a thread's run of outputs in each pass, so that it reads each input of
// the run's reach once from shared memory: 7 SSIM rows (vertical) or
// columns (horizontal) of the 42, 8 columns of the tile's 32 in the
// transposed horizontal pass, 4 rows in the transposed vertical one
constexpr int kRun = 7;
constexpr int kRuns = kMap / kRun;
constexpr int kColRun = 8;
constexpr int kRowRun = 4;
// row strides of the derivative maps and the transposed pass: odd, so that
// threads on neighbouring rows read other banks
constexpr int kDStride = kMap + 1;
constexpr int kHStride = kTile + 1;
constexpr float kC1 = 0.0001f;               // (0.01 x range)^2
constexpr float kC2 = 0.0009f;               // (0.03 x range)^2
// shared memory, in floats: the inputs, then the derivative maps in their
// place; the vertical pass, then the transposed horizontal pass in its
constexpr int kInputs = 2 * kIn * kIn;
constexpr int kDMaps = 3 * kMap * kDStride;
constexpr int kFirst = kInputs > kDMaps ? kInputs : kDMaps;
constexpr int kVertical = 5 * kMap * kIn;
constexpr size_t kSharedBytes = sizeof(float) * (kFirst + kVertical);
static_assert(3 * kMap * kHStride <= kVertical, "the pass must fit");
static_assert(kMap % kRun == 0 && kTile % kColRun == 0 &&
                  kTile % kRowRun == 0 && kTile / kRowRun * kTile == kThreads,
              "runs must tile the maps");

// training/ssim.py::_gaussian_window's float32 taps (sigma 1.5, normalized
// in float64, then rounded), as tests/test_torch_loss_kernel.py checks
__constant__ float kTaps[kWin] = {
    0x1.0d956cp-10f, 0x1.f1fe02p-8f, 0x1.26eb18p-5f, 0x1.bff0fep-4f,
    0x1.b43c40p-3f,  0x1.106560p-2f, 0x1.b43c40p-3f, 0x1.bff0fep-4f,
    0x1.26eb18p-5f,  0x1.f1fe02p-8f, 0x1.0d956cp-10f};

// torch.clamp(x, 0, 1): a NaN stays NaN
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

// the block's two sums (SSIM map, |x1 - y|) in double, in a fixed order;
// thread 0 gets them
__device__ __forceinline__ void block_sums(double& s, double& l) {
  __shared__ double red[2][kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    l += __shfl_down_sync(0xffffffffu, l, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = s;
    red[1][threadIdx.x >> 5] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = 0.0;
    l = 0.0;
    for (int k = 0; k < kWarps; ++k) {
      s += red[0][k];
      l += red[1][k];
    }
  }
}

// One thread's run of `kOut` outputs of an 11-tap pass: out[r] = sum over
// t of kTaps[t] x[r + t] when `transposed` is false, kTaps[t] x[r + 10 - t]
// when it is true, from x[0 .. kOut + 9] at `x` with stride `stride`, each
// read once.
template <int kOut, bool transposed>
__device__ __forceinline__ void taps_run(const float* x, int stride,
                                         float (&out)[kOut]) {
#pragma unroll
  for (int u = 0; u < kOut + kReach; ++u) {
    const float v = x[u * stride];
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int t = transposed ? r + kReach - u : u - r;
      if (t >= 0 && t < kWin) out[r] = fmaf(kTaps[t], v, out[r]);
    }
  }
}

// three blocks an SM: their shared memory fits (3 x 65 KB of 227 KB)
__global__ void __launch_bounds__(kThreads, 3) image_loss_kernel(
    const float* __restrict__ render, const float* __restrict__ gt, int h,
    int w, float c_l1, float c_ssim, float* __restrict__ grad,
    float* __restrict__ clamped, double* __restrict__ partials) {
  extern __shared__ float smem[];
  float* sx = smem;                // [kIn][kIn] the clamped render
  float* sy = sx + kIn * kIn;      // [kIn][kIn] the ground truth
  float* dmap = smem;              // [3][kMap][kDStride] D_mu, D_11, D_12
  float* vert = smem + kFirst;     // [5][kMap][kIn] the vertical pass
  float* hmap = vert;              // [3][kMap][kHStride] the transposed one
  const int ch = blockIdx.z;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int qh = h - kReach, qw = w - kReach;  // the SSIM map's size
  const int tid = threadIdx.x;

  // the inputs over the tile and 10 pixels around it (0 off the image,
  // where no SSIM position reads them), every load of a thread in flight
  // before its first store
  float xs[kLoads], ys[kLoads];
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int k = tid + n * kThreads;
    const int gr = r0 - kReach + k / kIn, gc = c0 - kReach + k % kIn;
    xs[n] = 0.f;
    ys[n] = 0.f;
    if (k < kIn * kIn && gr >= 0 && gr < h && gc >= 0 && gc < w) {
      const size_t at = (static_cast<size_t>(gr) * w + gc) * 3 + ch;
      xs[n] = render[at];
      ys[n] = gt[at];
    }
  }
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int k = tid + n * kThreads;
    if (k < kIn * kIn) {
      sx[k] = clamp01(xs[n]);
      sy[k] = ys[n];
    }
  }
  __syncthreads();

  // the vertical pass of blur(x1), blur(y), blur(x1^2), blur(y^2),
  // blur(x1 y) at the SSIM rows r0 - 10 .. r0 + 31, a run of rows a thread
  for (int k = tid; k < kIn * kRuns; k += kThreads) {
    const int v = k % kIn, i0 = k / kIn * kRun;
    float m1[kRun] = {}, m2[kRun] = {}, e11[kRun] = {}, e22[kRun] = {},
          e12[kRun] = {};
#pragma unroll
    for (int u = 0; u < kRun + kReach; ++u) {
      const float x1 = sx[(i0 + u) * kIn + v], y = sy[(i0 + u) * kIn + v];
      const float x11 = __fmul_rn(x1, x1), y22 = __fmul_rn(y, y);
      const float x12 = __fmul_rn(x1, y);
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const int a = u - r;
        if (a < 0 || a >= kWin) continue;
        const float t = kTaps[a];
        m1[r] = fmaf(t, x1, m1[r]);
        m2[r] = fmaf(t, y, m2[r]);
        e11[r] = fmaf(t, x11, e11[r]);
        e22[r] = fmaf(t, y22, e22[r]);
        e12[r] = fmaf(t, x12, e12[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      float* out = vert + (i0 + r) * kIn + v;
      out[0] = m1[r];
      out[kMap * kIn] = m2[r];
      out[2 * kMap * kIn] = e11[r];
      out[3 * kMap * kIn] = e22[r];
      out[4 * kMap * kIn] = e12[r];
    }
  }
  __syncthreads();

  // the horizontal pass, the SSIM map and its derivative maps at the
  // positions r0 - 10 .. r0 + 31, c0 - 10 .. c0 + 31 (0 off the map), a
  // run of columns a thread; the block sums the map over the positions of
  // its own tile
  double ssim_sum = 0.0, l1_sum = 0.0;
  for (int k = tid; k < kMap * kRuns; k += kThreads) {
    const int i = k / kRuns, j0 = k % kRuns * kRun;
    const int qr = r0 - kReach + i;
    const bool row_on = qr >= 0 && qr < qh;
    float b[5][kRun] = {};
    if (row_on) {
#pragma unroll
      for (int m = 0; m < 5; ++m)
        taps_run<kRun, false>(vert + (m * kMap + i) * kIn + j0, 1, b[m]);
    }
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int j = j0 + r, qc = c0 - kReach + j;
      float d_mu = 0.f, d_11 = 0.f, d_12 = 0.f;
      if (row_on && qc >= 0 && qc < qw) {
        const float mu1 = b[0][r], mu2 = b[1][r];
        const float mu1_sq = __fmul_rn(mu1, mu1);
        const float mu2_sq = __fmul_rn(mu2, mu2);
        const float mu1_mu2 = __fmul_rn(mu1, mu2);
        const float sigma1_sq = b[2][r] - mu1_sq;
        const float sigma2_sq = b[3][r] - mu2_sq;
        const float sigma12 = b[4][r] - mu1_mu2;
        const float a1 = 2.f * mu1_mu2 + kC1;
        const float b1 = __fadd_rn(mu1_sq, mu2_sq) + kC1;
        const float a2 = 2.f * sigma12 + kC2;
        const float b2 = __fadd_rn(sigma1_sq, sigma2_sq) + kC2;
        const float l = a1 / b1, cs = a2 / b2, s = l * cs;
        d_12 = 2.f * l / b2;
        d_11 = -s / b2;
        d_mu = 2.f * cs * (mu2 - l * mu1) / b1 - mu2 * d_12 - 2.f * mu1 * d_11;
        if (i >= kReach && j >= kReach) ssim_sum += s;
      }
      float* d = dmap + i * kDStride + j;
      d[0] = d_mu;
      d[kMap * kDStride] = d_11;
      d[2 * kMap * kDStride] = d_12;
    }
  }
  __syncthreads();

  // the transposed blur, horizontal: SSIM rows r0 - 10 .. r0 + 31, the
  // tile's columns, a run of columns a thread
  for (int k = tid; k < kMap * (kTile / kColRun); k += kThreads) {
    const int i = k % kMap, cr = k / kMap * kColRun;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float acc[kColRun] = {};
      taps_run<kColRun, true>(dmap + (m * kMap + i) * kDStride + cr, 1, acc);
#pragma unroll
      for (int c = 0; c < kColRun; ++c)
        hmap[(m * kMap + i) * kHStride + cr + c] = acc[c];
    }
  }
  __syncthreads();

  // the transposed blur, vertical, and the gradient of the tile's pixels,
  // a run of rows a thread
  {
    const int c = tid % kTile, a0 = tid / kTile * kRowRun;
    const int gc = c0 + c;
    float x[kRowRun], y[kRowRun];
#pragma unroll
    for (int r = 0; r < kRowRun; ++r) {
      const int gr = r0 + a0 + r;
      if (gr >= h || gc >= w) continue;
      const size_t at = (static_cast<size_t>(gr) * w + gc) * 3 + ch;
      x[r] = render[at];
      y[r] = gt[at];
    }
    float g[3][kRowRun] = {};
#pragma unroll
    for (int m = 0; m < 3; ++m)
      taps_run<kRowRun, true>(hmap + (m * kMap + a0) * kHStride + c,
                              kHStride, g[m]);
#pragma unroll
    for (int r = 0; r < kRowRun; ++r) {
      const int gr = r0 + a0 + r;
      if (gr >= h || gc >= w) continue;
      const size_t at = (static_cast<size_t>(gr) * w + gc) * 3 + ch;
      const float x1 = clamp01(x[r]);
      const float d = x1 - y[r];
      const float sign = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
      const float ds = g[0][r] + 2.f * x1 * g[1][r] + y[r] * g[2][r];
      grad[at] = (x[r] >= 0.f && x[r] <= 1.f) ? c_l1 * sign + c_ssim * ds
                                               : 0.f;
      clamped[at] = x1;
      l1_sum += fabsf(d);
    }
  }

  block_sums(ssim_sum, l1_sum);
  if (tid == 0) {
    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x;
    partials[2 * blk] = ssim_sum;
    partials[2 * blk + 1] = l1_sum;
  }
}

// the blocks' sums added in a fixed order, then (loss, L1, 1 - SSIM)
__global__ void __launch_bounds__(kThreads) image_loss_finish_kernel(
    const double* __restrict__ partials, int blocks, int h, int w,
    float one_minus_lambda, float lambda, float* __restrict__ out) {
  double s = 0.0, l = 0.0;
  for (int k = threadIdx.x; k < blocks; k += kThreads) {
    s += partials[2 * k];
    l += partials[2 * k + 1];
  }
  block_sums(s, l);
  if (threadIdx.x == 0) {
    const float l1 = static_cast<float>(l / (3.0 * h * w));
    const float ssim =
        static_cast<float>(s / (3.0 * (h - kReach) * (double)(w - kReach)));
    const float ld = 1.f - ssim;
    out[0] = __fadd_rn(__fmul_rn(one_minus_lambda, l1), __fmul_rn(lambda, ld));
    out[1] = l1;
    out[2] = ld;
  }
}

}  // namespace
}  // namespace t3dgs_loss

// Returns a cudaError_t (0 on success). `render`, `gt`, `grad` and
// `clamped` are (h, w, 3) float32, contiguous; `partials` holds
// `scratch` doubles, at least 2 a block (3 ceil(h / 32) ceil(w / 32)
// blocks); `out` 3 floats: the loss, L1 and 1 - SSIM. `c_l1` is
// (1 - lambda) / (3 h w), `c_ssim` -lambda / (3 (h - 10)(w - 10)).
extern "C" int t3dgs_image_loss(const void* render, const void* gt, int h,
                                int w, float c_l1, float c_ssim,
                                float one_minus_lambda, float lambda,
                                void* grad, void* clamped, void* partials,
                                int scratch, void* out, void* stream) {
  using namespace t3dgs_loss;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, 3);
  const int blocks = static_cast<int>(grid.x * grid.y * grid.z);
  if (h < kWin || w < kWin || scratch < 2 * blocks || render == nullptr ||
      gt == nullptr || grad == nullptr || clamped == nullptr ||
      partials == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB of shared memory only after this, once a device
  static bool ready[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    e = cudaFuncSetAttribute(image_loss_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSharedBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[device] = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  image_loss_kernel<<<grid, kThreads, kSharedBytes, st>>>(
      static_cast<const float*>(render), static_cast<const float*>(gt), h, w,
      c_l1, c_ssim, static_cast<float*>(grad), static_cast<float*>(clamped),
      static_cast<double*>(partials));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  image_loss_finish_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const double*>(partials), blocks, h, w, one_minus_lambda,
      lambda, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
