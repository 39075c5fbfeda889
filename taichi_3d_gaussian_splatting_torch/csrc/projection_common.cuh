// Shared by the projection's forward (projection_forward.cu, P1) and
// backward (projection_backward.cu, P2) kernels: the per-point forward of
// ops/projection.py::_forward_terms, written once, so that P2 recomputes
// exactly the values P1 produced.
//
// Both sources are compiled with -fmad=false (ops/_build.py): every
// product and sum is rounded on its own, in the order of the plain
// version's torch ops, and the library calls are the ones PyTorch's CUDA
// kernels make (expf, logf, sqrtf, rsqrtf, IEEE division). So P1's masks
// (in_frustum, emit: the 1/255 visibility gate and the frustum edges) and
// its non-finite count match the plain version run on the card exactly,
// and its columns bitwise where no contraction or library difference
// intervenes. Python scalars enter as torch casts them: the double value
// rounded to float (static_cast<float>(double)).
//
// Layout: a block of kBlock points stages its rows of the (N, 56) features
// in shared memory, kRowStride floats a row: the global reads are whole
// 16-byte vectors of consecutive addresses, and the 4 padding floats put
// the rows of a quarter-warp's 16-byte reads on distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace t3dgs_proj {

constexpr int kFeatures = 56;
constexpr int kFeatureVectors = kFeatures / 4;
constexpr int kBlock = 128;
constexpr int kRowStride = 60;

// ops/gaussian.py COV_LOW_PASS and ALPHA_SKIP_THRESHOLD; ops/projection.py
// LOG_FLOOR and the SH constants
constexpr float kLowPass = static_cast<float>(0.3);
constexpr float kLowPass2 = static_cast<float>(0.3 * 0.3);
constexpr float kAlphaSkip = static_cast<float>(1.0 / 255.0);
constexpr float kLogFloor = static_cast<float>(1e-30);
constexpr float kNormFloor = static_cast<float>(1e-24);
constexpr float kRayEps = static_cast<float>(1e-37);
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.48860251190291987;
constexpr double kC2 = 1.0925484305920792;
constexpr double kC3 = 0.94617469575755997;
constexpr double kC3Offset = 0.31539156525251999;
constexpr double kC4 = 0.54627421529603959;
constexpr double kC5 = 0.59004358992664352;
constexpr double kC6 = 2.8906114426405538;
constexpr double kC7 = 0.45704579946446572;
constexpr double kC8 = 0.3731763325901154;
constexpr double kC9 = 1.4453057213202769;

// a Python float as torch casts it
__host__ __device__ constexpr float fl(double x) {
  return static_cast<float>(x);
}

// torch.clamp(x, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.minimum: NaN in either wins
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// What the projection takes besides the points: the (16, K) per-object
// tables of ops/projection.py camera_table and edit_table (edit null
// without editing), the (3, 3) intrinsics, the (16,) SH band mask (null
// without one), the planes and the frustum's bounds in pixels.
struct Params {
  const float* table;
  const float* edit;
  int num_objects;
  const float* intrinsics;
  const float* sh_mask;
  float near_plane, far_plane;
  float u_lo, u_hi, v_lo, v_hi;
};

// Every intermediate of one point's projection that the backward reads,
// and the forward's outputs.
struct Terms {
  float w[9], o[3];      // camera rotation (row-major), ray origin
  float e[9], se[3];     // edit rotation and scale (with editing)
  float fx, fy;
  float xc, yc, zc, inv_z;
  float q[4], q_inv;     // normalized quaternion, 1/|raw|
  float r[9], s[3], m[9];
  float jw[6], p[6];
  float cov_b, fa, fc, det_raw, inv_det;
  float d[3], dn, dir[3];
  float basis[16];
  float u, v, conic_a, conic_b, conic_c, rescale, alpha, color[3];
  float radii, radius_x, radius_y, logw;
};

// Row r of a (16, K) table for object `obj`.
__device__ __forceinline__ float table_row(const float* t, int k, int r,
                                           int obj) {
  return t[r * k + obj];
}

// One point's forward, in ops/projection.py::_forward_terms' order.
// `point`: its (x, y, z); `f`: its 56 features; `obj`: its object, in
// [0, K). Returns the outputs in `t`; in_frustum, finite and visible are
// left to the caller (forward kernel) from t and the raw zc.
__device__ __forceinline__ void forward_terms(const float* point,
                                              const float* f, int obj,
                                              const Params& prm, Terms& t) {
  const int k = prm.num_objects;
  for (int i = 0; i < 9; ++i) t.w[i] = table_row(prm.table, k, i, obj);
  const float tcx = table_row(prm.table, k, 9, obj);
  const float tcy = table_row(prm.table, k, 10, obj);
  const float tcz = table_row(prm.table, k, 11, obj);
  for (int i = 0; i < 3; ++i) t.o[i] = table_row(prm.table, k, 12 + i, obj);
  t.fx = prm.intrinsics[0];
  t.fy = prm.intrinsics[4];
  const float cx = prm.intrinsics[2];
  const float cy = prm.intrinsics[5];
  const float fx = t.fx, fy = t.fy;
  const float* w = t.w;

  float px = point[0], py = point[1], pz = point[2];
  if (prm.edit != nullptr) {
    for (int i = 0; i < 9; ++i) t.e[i] = table_row(prm.edit, k, i, obj);
    for (int i = 0; i < 3; ++i) t.se[i] = table_row(prm.edit, k, 9 + i, obj);
    const float ax = px * t.se[0] + table_row(prm.edit, k, 12, obj);
    const float ay = py * t.se[1] + table_row(prm.edit, k, 13, obj);
    const float az = pz * t.se[2] + table_row(prm.edit, k, 14, obj);
    px = t.e[0] * ax + t.e[1] * ay + t.e[2] * az;
    py = t.e[3] * ax + t.e[4] * ay + t.e[5] * az;
    pz = t.e[6] * ax + t.e[7] * ay + t.e[8] * az;
  }

  // ---- project position (zc clamped at the near plane) ----
  t.xc = w[0] * px + w[1] * py + w[2] * pz + tcx;
  t.yc = w[3] * px + w[4] * py + w[5] * pz + tcy;
  t.zc = w[6] * px + w[7] * py + w[8] * pz + tcz;
  t.inv_z = 1.0f / clamp_min(t.zc, prm.near_plane);
  const float inv_z = t.inv_z, xc = t.xc, yc = t.yc;
  t.u = fx * xc * inv_z + cx;
  t.v = fy * yc * inv_z + cy;

  // ---- quaternion (straight-through normalize) + rotation ----
  t.q_inv = rsqrtf(clamp_min(f[0] * f[0] + f[1] * f[1] + f[2] * f[2] +
                                 f[3] * f[3],
                             kNormFloor));
  for (int i = 0; i < 4; ++i) t.q[i] = f[i] * t.q_inv;
  const float qx = t.q[0], qy = t.q[1], qz = t.q[2], qw = t.q[3];
  float* r = t.r;
  r[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  r[1] = 2.0f * (qx * qy - qw * qz);
  r[2] = 2.0f * (qx * qz + qw * qy);
  r[3] = 2.0f * (qx * qy + qw * qz);
  r[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  r[5] = 2.0f * (qy * qz - qw * qx);
  r[6] = 2.0f * (qx * qz - qw * qy);
  r[7] = 2.0f * (qy * qz + qw * qx);
  r[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
  for (int c = 0; c < 3; ++c) t.s[c] = expf(f[4 + c]);
  // M = R diag(s)
  float* m = t.m;
  for (int row = 0; row < 3; ++row)
    for (int c = 0; c < 3; ++c) m[3 * row + c] = r[3 * row + c] * t.s[c];
  if (prm.edit != nullptr) {
    // M' = R_e (S_e M)
    float b[9];
    for (int row = 0; row < 3; ++row)
      for (int c = 0; c < 3; ++c) b[3 * row + c] = t.se[row] * m[3 * row + c];
    const float* e = t.e;
    for (int row = 0; row < 3; ++row)
      for (int c = 0; c < 3; ++c)
        m[3 * row + c] = e[3 * row] * b[c] + e[3 * row + 1] * b[3 + c] +
                         e[3 * row + 2] * b[6 + c];
  }

  // ---- EWA covariance: cov2d = P P^T with P = (J W) M ----
  const float j00 = fx * inv_z;
  const float j02 = -fx * xc * inv_z * inv_z;
  const float j11 = fy * inv_z;
  const float j12 = -fy * yc * inv_z * inv_z;
  float* jw = t.jw;
  for (int c = 0; c < 3; ++c) {
    jw[c] = j00 * w[c] + j02 * w[6 + c];
    jw[3 + c] = j11 * w[3 + c] + j12 * w[6 + c];
  }
  float* p = t.p;
  for (int row = 0; row < 2; ++row)
    for (int c = 0; c < 3; ++c)
      p[3 * row + c] = jw[3 * row] * m[c] + jw[3 * row + 1] * m[3 + c] +
                       jw[3 * row + 2] * m[6 + c];
  const float cov_a = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
  const float cov_b = p[0] * p[3] + p[1] * p[4] + p[2] * p[5];
  const float cov_c = p[3] * p[3] + p[4] * p[4] + p[5] * p[5];
  t.cov_b = cov_b;

  // ---- conic + low-pass rescale (determinant floored) ----
  const float det_pre = cov_a * cov_c - cov_b * cov_b;
  t.fa = cov_a + kLowPass;
  t.fc = cov_c + kLowPass;
  t.det_raw = t.fa * t.fc - cov_b * cov_b;
  const float det = clamp_min(t.det_raw, kLowPass2);
  t.rescale = sqrtf(clamp_min(det_pre / det, 0.0f));
  t.inv_det = 1.0f / det;
  t.conic_a = t.fc * t.inv_det;
  t.conic_b = -cov_b * t.inv_det;
  t.conic_c = t.fa * t.inv_det;

  // ---- radii and the opacity-aware extents ----
  const float large_eig =
      (cov_a + cov_c +
       sqrtf((cov_a - cov_c) * (cov_a - cov_c) + 4.0f * cov_b * cov_b)) /
      2.0f;
  t.radii = sqrtf(clamp_min(large_eig, 0.0f)) * 3.0f;
  const float radius_x = sqrtf(clamp_min(cov_a, 0.0f)) * 3.0f;
  const float radius_y = sqrtf(clamp_min(cov_c, 0.0f)) * 3.0f;
  t.alpha = sigmoid(f[7]);
  const float peak = t.rescale * t.alpha;
  const float r_eff = sqrtf(clamp_min(
      2.0f * logf(255.0f * clamp_min(peak, kLogFloor)), 0.0f));
  t.radius_x = minimum(radius_x, r_eff * sqrtf(clamp_min(t.fa, 0.0f)));
  t.radius_y = minimum(radius_y, r_eff * sqrtf(clamp_min(t.fc, 0.0f)));

  // ---- SH colour along the camera->point ray ----
  t.d[0] = px - t.o[0];
  t.d[1] = py - t.o[1];
  t.d[2] = pz - t.o[2];
  t.dn = rsqrtf(t.d[0] * t.d[0] + t.d[1] * t.d[1] + t.d[2] * t.d[2] +
                kRayEps);
  for (int i = 0; i < 3; ++i) t.dir[i] = t.d[i] * t.dn;
  const float x = t.dir[0], y = t.dir[1], z = t.dir[2];
  float* bs = t.basis;
  bs[0] = fl(kC0) * 1.0f;
  bs[1] = fl(-kC1) * y;
  bs[2] = fl(kC1) * z;
  bs[3] = fl(-kC1) * x;
  bs[4] = fl(kC2) * x * y;
  bs[5] = fl(-kC2) * y * z;
  bs[6] = fl(kC3) * z * z - fl(kC3Offset);
  bs[7] = fl(-kC2) * x * z;
  bs[8] = fl(kC4) * (x * x - y * y);
  bs[9] = fl(kC5) * y * (-3.0f * x * x + y * y);
  bs[10] = fl(kC6) * x * y * z;
  bs[11] = fl(kC7) * y * (1.0f - 5.0f * z * z);
  bs[12] = fl(kC8) * z * (5.0f * z * z - 3.0f);
  bs[13] = fl(kC7) * x * (1.0f - 5.0f * z * z);
  bs[14] = fl(kC9) * z * (x * x - y * y);
  bs[15] = fl(kC5) * x * (-x * x + 3.0f * y * y);
  if (prm.sh_mask != nullptr)
    for (int i = 0; i < 16; ++i) bs[i] = bs[i] * prm.sh_mask[i];
  for (int ch = 0; ch < 3; ++ch) {
    // sum() from 0, left to right
    float sum = 0.0f;
    for (int i = 0; i < 16; ++i) sum = sum + f[8 + 16 * ch + i] * bs[i];
    t.color[ch] = sigmoid(sum);
  }
  t.logw = logf(clamp_min(t.rescale, kLogFloor)) +
           logf(clamp_min(t.alpha, kLogFloor));
}

// Copy rows [base, base + rows) of the (N, 56) features (16-byte aligned)
// into shared memory, kRowStride floats a row, with all threads of the
// block.
__device__ __forceinline__ void stage_rows(const float* feats, float* rows_smem,
                                           int base, int rows) {
  const float4* src = reinterpret_cast<const float4*>(feats) +
                      static_cast<size_t>(base) * kFeatureVectors;
  for (int j = threadIdx.x; j < rows * kFeatureVectors; j += blockDim.x) {
    const int row = j / kFeatureVectors, col = j % kFeatureVectors;
    *reinterpret_cast<float4*>(rows_smem + row * kRowStride + 4 * col) =
        src[j];
  }
}

// Object of point i: 0 with one object, else its id (clamped into [0, K)).
__device__ __forceinline__ int object_of(const int* object_id, int i,
                                         int num_objects) {
  if (num_objects == 1) return 0;
  return min(max(object_id[i], 0), num_objects - 1);
}

}  // namespace t3dgs_proj
