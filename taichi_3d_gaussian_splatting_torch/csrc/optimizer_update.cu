// The optimizer step of training for NVIDIA Hopper (sm_90a), in one pass
// over the slots (training/adam_cuda.py::optimizer_update, whose plain
// version is optimizer_update_torch). Per slot:
// - the feature gradient (raw * group scale) * band mask + direct, when the
//   scale is given (a single-view step), else the gradient as given (a
//   batch step's sum);
// - the quaternion: the step reads the stored features, and the projection
//   normalizes q where it reads it with the norm held constant, so its
//   gradient is the one with respect to q / |q| over |q|. Lane 0, which
//   holds the whole quaternion and its gradient as one float4 each, takes
//   the norm n = max(sqrt(q0^2 + q1^2 + q2^2 + q3^2), 1e-12) in registers,
//   divides q by it and multiplies the gradient by it: Adam's parameter is
//   q / |q| and its gradient the one with respect to that, an all-zero
//   slot stays 0, and no step copies the features to normalize them;
// - containment: a feature row or position row with a non-finite value is
//   zeroed, and the slots where either was are counted;
// - optax's Adam on both groups, in training/adam.py::adam_update's order
//   of operations;
// - the loss guard: parameters and moments stay as they were when the
//   loss is not finite (the quaternion normalized); the contained position
//   gradient is written out.
//
// It replaces no Pallas kernel: the JAX package leaves Adam to optax and
// XLA fuses the update into a few loops. Eager torch ran the same chain as
// about 50 passes over an (N, 56) float32 array.
//
// Bound: bytes. A slot reads the raw and direct feature gradients, the
// features, mu and nu (5 x 224 bytes) and writes the features, mu and nu
// (3 x 224); reads the position gradient, position, mu and nu (4 x 12) and
// writes the position, mu, nu and the contained gradient (4 x 12): 1,888
// bytes a slot (1,664 without a direct gradient), against some 20 float
// operations a value (the normalization adds some 15 to lane 0 and no
// bytes). Design: a half-warp a slot. Lanes 0-13 each move one
// 16-byte vector of the 224-byte feature row, lane 14 the three position
// values, so a warp reads two whole rows, 448 consecutive bytes, with one
// load instruction per array; a ballot gives each row's finiteness without
// a second pass; one atomic add a block counts the zeroed slots.
//
// Built with -fmad=false (ops/_build.py SOURCE_FLAGS), without fast math:
// every product, sum, quotient and square root rounds on its own, as the
// plain version's torch ops do, so that the two agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace t3dgs_opt {

// One Adam group's settings: the host's constants (betas, eps, a constant
// learning rate) and the device's 0-d values (bias corrections, a
// scheduled learning rate, which replaces `lr` when given).
struct Group {
  const float* bc1;
  const float* bc2;
  const float* lr_ptr;
  float lr;
  float one_minus_b1;
  float b1;
  float one_minus_b2;
  float b2;
  float eps;
};

namespace {

constexpr int kFeatures = 56;
constexpr int kVectors = kFeatures / 4;  // float4 lanes of a feature row
constexpr int kPositionLane = kVectors;  // lane 14 of the half-warp
constexpr int kBlock = 256;              // 16 slots a block
constexpr unsigned kFeatureBits = (1u << kVectors) - 1u;

struct Scalars {
  float bc1, bc2, lr;
  bool zero_quotient;  // bc1, bc2 and eps positive
};

__device__ __forceinline__ Scalars scalars(const Group& g) {
  const float bc1 = *g.bc1, bc2 = *g.bc2;
  return {bc1, bc2, g.lr_ptr != nullptr ? *g.lr_ptr : g.lr,
          bc1 > 0.f && bc2 > 0.f && g.eps > 0.f};
}

// adam_update on one value, then the loss guard (torch.where(loss_ok,
// new, old) on the parameter and both moments). The IEEE division and
// square root send a zero (every moment of a free slot of the pool) to a
// slow subroutine, so a zero takes a shorter way to the same bits: with
// positive bc1, bc2 and eps and v >= 0, (m / bc1) / (sqrt(v / bc2) + eps)
// is m itself when m is a zero of either sign, and sqrt(0) is that 0.
__device__ __forceinline__ void adam(float grad, float& param, float& mu,
                                     float& nu, const Group& g,
                                     const Scalars& s, bool loss_ok) {
  const float m = g.one_minus_b1 * grad + g.b1 * mu;
  const float v = g.one_minus_b2 * (grad * grad) + g.b2 * nu;
  float ratio = m;
  if (!(m == 0.f && v >= 0.f && s.zero_quotient)) {
    const float v_hat = v / s.bc2;
    const float root = v_hat == 0.f ? v_hat : sqrtf(v_hat);
    ratio = (m / s.bc1) / (root + g.eps);
  }
  const float step = s.lr * ratio;
  if (loss_ok) {
    param = param - step;
    mu = m;
    nu = v;
  }
}

// max(|q|, 1e-12), the squares summed in the order x, y, z, w; a NaN norm
// stays NaN, as torch.clamp leaves it. The square root of a zero (a free
// slot of the pool) takes adam()'s shorter way to the same bits.
__device__ __forceinline__ float quaternion_norm(const float4& q) {
  const float squares = q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w;
  const float norm = squares == 0.f ? squares : sqrtf(squares);
  return norm < 1e-12f ? 1e-12f : norm;
}

// c / norm for norm >= 1e-12, +inf or NaN: a zero c over a positive norm is
// c itself, sign included, without the division's slow subroutine.
__device__ __forceinline__ float over_norm(float c, float norm) {
  return c == 0.f && norm > 0.f ? c : c / norm;
}

__device__ __forceinline__ bool finite4(const float4& a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z) && isfinite(a.w);
}

__global__ void __launch_bounds__(kBlock) optimizer_update_kernel(
    int n, const float4* __restrict__ feats, const float4* __restrict__ grad,
    const float4* __restrict__ direct, const float4* __restrict__ scale,
    const float4* __restrict__ band_mask, const float4* __restrict__ mu_f,
    const float4* __restrict__ nu_f, const float* __restrict__ pc,
    const float* __restrict__ grad_pc, const float* __restrict__ mu_p,
    const float* __restrict__ nu_p, Group gf, Group gp,
    const uint8_t* __restrict__ loss_ok_ptr, float4* __restrict__ out_feats,
    float4* __restrict__ out_mu_f, float4* __restrict__ out_nu_f,
    float* __restrict__ out_pc, float* __restrict__ out_mu_p,
    float* __restrict__ out_nu_p, float* __restrict__ out_grad_pc,
    int* __restrict__ nonfinite) {
  const int lane = threadIdx.x & 15;
  const int half = (threadIdx.x >> 4) & 1;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kBlock / 16) + (threadIdx.x >> 4);
  const bool active = row < n;
  const bool loss_ok = *loss_ok_ptr != 0;

  float4 g = make_float4(0.f, 0.f, 0.f, 0.f), p = g;
  float qnorm = 1.f;  // lane 0's quaternion norm
  float gpos[3] = {0.f, 0.f, 0.f};
  bool ok = true;
  if (active && lane < kVectors) {
    const size_t i = static_cast<size_t>(row) * kVectors + lane;
    g = grad[i];
    p = feats[i];
    if (scale != nullptr) {
      const float4 s = scale[lane], m = band_mask[lane];
      const float4 d =
          direct != nullptr ? direct[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      g.x = g.x * s.x * m.x + d.x;
      g.y = g.y * s.y * m.y + d.y;
      g.z = g.z * s.z * m.z + d.z;
      g.w = g.w * s.w * m.w + d.w;
    }
    if (lane == 0) {  // the gradient with respect to q / |q|, contained
      qnorm = quaternion_norm(p);
      g.x = g.x * qnorm;
      g.y = g.y * qnorm;
      g.z = g.z * qnorm;
      g.w = g.w * qnorm;
    }
    ok = finite4(g);
  } else if (active && lane == kPositionLane) {
    const size_t i = static_cast<size_t>(row) * 3;
    for (int c = 0; c < 3; ++c) {
      gpos[c] = grad_pc[i + c];
      ok = ok && isfinite(gpos[c]);
    }
  }
  const unsigned bits = __ballot_sync(0xffffffffu, ok) >> (16 * half);
  const bool feat_ok = (bits & kFeatureBits) == kFeatureBits;
  const bool pos_ok = (bits >> kPositionLane) & 1u;

  if (active && lane < kVectors) {
    if (!feat_ok) g = make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t i = static_cast<size_t>(row) * kVectors + lane;
    float4 m = mu_f[i], v = nu_f[i];
    if (lane == 0) {  // Adam's parameter q / |q|, while the moments load
      p.x = over_norm(p.x, qnorm);
      p.y = over_norm(p.y, qnorm);
      p.z = over_norm(p.z, qnorm);
      p.w = over_norm(p.w, qnorm);
    }
    const Scalars s = scalars(gf);
    adam(g.x, p.x, m.x, v.x, gf, s, loss_ok);
    adam(g.y, p.y, m.y, v.y, gf, s, loss_ok);
    adam(g.z, p.z, m.z, v.z, gf, s, loss_ok);
    adam(g.w, p.w, m.w, v.w, gf, s, loss_ok);
    out_feats[i] = p;
    out_mu_f[i] = m;
    out_nu_f[i] = v;
  } else if (active && lane == kPositionLane) {
    const Scalars s = scalars(gp);
    const size_t i = static_cast<size_t>(row) * 3;
    for (int c = 0; c < 3; ++c) {
      const float gc = pos_ok ? gpos[c] : 0.f;
      float p = pc[i + c], m = mu_p[i + c], v = nu_p[i + c];
      adam(gc, p, m, v, gp, s, loss_ok);
      out_pc[i + c] = p;
      out_mu_p[i + c] = m;
      out_nu_p[i + c] = v;
      out_grad_pc[i + c] = gc;
    }
  }
  const int count =
      __syncthreads_count(active && lane == 0 && !(feat_ok && pos_ok));
  if (threadIdx.x == 0 && count > 0) atomicAdd(nonfinite, count);
}

}  // namespace
}  // namespace t3dgs_opt

// Returns a cudaError_t (0 on success). `direct`, `scale` and `band_mask`
// may be null (no combination when `scale` is; `band_mask` is given with
// it); the feature arrays must be 16-byte aligned. `nonfinite` is zeroed
// here.
extern "C" int t3dgs_optimizer_update(
    int n, const void* feats, const void* grad, const void* direct,
    const void* scale, const void* band_mask, const void* mu_f,
    const void* nu_f, const void* pc, const void* grad_pc, const void* mu_p,
    const void* nu_p, const t3dgs_opt::Group* features,
    const t3dgs_opt::Group* positions, const void* loss_ok, void* out_feats,
    void* out_mu_f, void* out_nu_f, void* out_pc, void* out_mu_p,
    void* out_nu_p, void* out_grad_pc, void* nonfinite, void* stream) {
  using namespace t3dgs_opt;
  const void* aligned[] = {feats, grad, direct, scale, band_mask, mu_f,
                           nu_f, out_feats, out_mu_f, out_nu_f};
  for (const void* a : aligned) {
    if (reinterpret_cast<uintptr_t>(a) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n < 0 || features == nullptr || positions == nullptr ||
      (scale == nullptr) != (band_mask == nullptr) ||
      (direct != nullptr && scale == nullptr) || loss_ok == nullptr ||
      features->bc1 == nullptr || features->bc2 == nullptr ||
      positions->bc1 == nullptr || positions->bc2 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(nonfinite, 0, sizeof(int), st);
  if (e != cudaSuccess || n == 0) return static_cast<int>(e);
  const int slots_per_block = kBlock / 16;
  optimizer_update_kernel<<<(n + slots_per_block - 1) / slots_per_block,
                            kBlock, 0, st>>>(
      n, static_cast<const float4*>(feats), static_cast<const float4*>(grad),
      static_cast<const float4*>(direct), static_cast<const float4*>(scale),
      static_cast<const float4*>(band_mask),
      static_cast<const float4*>(mu_f), static_cast<const float4*>(nu_f),
      static_cast<const float*>(pc), static_cast<const float*>(grad_pc),
      static_cast<const float*>(mu_p), static_cast<const float*>(nu_p),
      *features, *positions, static_cast<const uint8_t*>(loss_ok),
      static_cast<float4*>(out_feats), static_cast<float4*>(out_mu_f),
      static_cast<float4*>(out_nu_f), static_cast<float*>(out_pc),
      static_cast<float*>(out_mu_p), static_cast<float*>(out_nu_p),
      static_cast<float*>(out_grad_pc), static_cast<int*>(nonfinite));
  return static_cast<int>(cudaGetLastError());
}
