// The projection's backward (P2) for NVIDIA Hopper (sm_90a): the VJP of the
// blend's nine input columns (u, v, conic a, b, c, logw, r, g, b) with
// respect to the point positions and the 56 features, whose plain version
// is ops/projection.py::project_points_backward_torch (same formulas, same
// order).
//
// The JAX package takes this VJP with jax.vjp of its jitted projection
// (taichi_3d_gaussian_splatting_tpu/ops/rasterizer.py rasterize_with_vjp),
// which XLA fuses; it has no Pallas kernel. Through torch autograd over the
// port's eager projection it took about half of the training step on the
// H100 (each feature-row select's backward writes a dense (56, N) zero
// gradient).
//
// One thread a point. It recomputes the point's forward from its inputs
// (projection_common.cuh forward_terms, compiled with the same flags as
// P1, so the values are P1's) and keeps nothing per point between the
// passes. Every point gets its full chain rule: a zero cotangent times a
// non-finite partial gives NaN, as autograd gives, so that the trainer's
// containment counts the same rows. No gradient goes to the poses or to
// the edit transform.
//
// Bound: bytes. A point reads 12 + 224 bytes of inputs, 36 of cotangents
// (and 4 of object id when K > 1) and writes 12 + 224 bytes of gradients:
// ~510 bytes, against about a thousand float operations. The feature rows
// come in and go out through shared memory as consecutive 16-byte vectors;
// each thread overwrites its row's features with their gradients in place
// once it has read them.

#include "projection_common.cuh"

namespace t3dgs_proj {
namespace {

// Cotangent rows (projection_cuda.py: the blend's nine columns).
enum CotRow { kGu = 0, kGv, kGa, kGb, kGc, kGlogw, kGr, kGg, kGbc };

__global__ void __launch_bounds__(kBlock)
    projection_backward_kernel(const float* __restrict__ pointcloud,
                               const float* __restrict__ feats,
                               const int* __restrict__ object_id, int n,
                               Params prm, const float* __restrict__ cot,
                               long long cot_stride,
                               float* __restrict__ grad_pc,
                               float* __restrict__ grad_feats) {
  __shared__ __align__(16) float rows_smem[kBlock * kRowStride];
  const int base = blockIdx.x * kBlock;
  const int rows = min(kBlock, n - base);
  stage_rows(feats, rows_smem, base, rows);
  __syncthreads();
  const int i = base + threadIdx.x;
  if (i < n) {
    float* f = rows_smem + threadIdx.x * kRowStride;
    Terms t;
    const float point[3] = {pointcloud[3 * i], pointcloud[3 * i + 1],
                            pointcloud[3 * i + 2]};
    forward_terms(point, f, object_of(object_id, i, prm.num_objects), prm, t);
    float g[9];
    for (int k = 0; k < 9; ++k) g[k] = cot[k * cot_stride + i];

    // ---- colour: sigmoid, the SH sums, the basis ----
    float g_sum[3];
    const float gin[3] = {g[kGr], g[kGg], g[kGbc]};
    for (int ch = 0; ch < 3; ++ch)
      g_sum[ch] = gin[ch] * (1.0f - t.color[ch]) * t.color[ch];
    float gb[16];
    for (int k = 0; k < 16; ++k) {
      const float f_r = f[8 + k], f_g = f[24 + k], f_b = f[40 + k];
      f[8 + k] = g_sum[0] * t.basis[k];
      f[24 + k] = g_sum[1] * t.basis[k];
      f[40 + k] = g_sum[2] * t.basis[k];
      gb[k] = g_sum[0] * f_r + g_sum[1] * f_g + g_sum[2] * f_b;
      if (prm.sh_mask != nullptr) gb[k] = gb[k] * prm.sh_mask[k];
    }
    const float x = t.dir[0], y = t.dir[1], z = t.dir[2];
    const float one_5zz = 1.0f - 5.0f * z * z;
    const float gx =
        fl(-kC1) * gb[3] + fl(kC2) * y * gb[4] - fl(kC2) * z * gb[7] +
        fl(2.0 * kC4) * x * gb[8] - fl(6.0 * kC5) * x * y * gb[9] +
        fl(kC6) * y * z * gb[10] + fl(kC7) * one_5zz * gb[13] +
        fl(2.0 * kC9) * x * z * gb[14] +
        fl(3.0 * kC5) * (y * y - x * x) * gb[15];
    const float gy =
        fl(-kC1) * gb[1] + fl(kC2) * x * gb[4] - fl(kC2) * z * gb[5] -
        fl(2.0 * kC4) * y * gb[8] + fl(3.0 * kC5) * (y * y - x * x) * gb[9] +
        fl(kC6) * x * z * gb[10] + fl(kC7) * one_5zz * gb[11] -
        fl(2.0 * kC9) * y * z * gb[14] + fl(6.0 * kC5) * x * y * gb[15];
    const float gz =
        fl(kC1) * gb[2] - fl(kC2) * y * gb[5] + fl(2.0 * kC3) * z * gb[6] -
        fl(kC2) * x * gb[7] + fl(kC6) * x * y * gb[10] -
        fl(10.0 * kC7) * y * z * gb[11] +
        fl(kC8) * (15.0f * z * z - 3.0f) * gb[12] -
        fl(10.0 * kC7) * x * z * gb[13] + fl(kC9) * (x * x - y * y) * gb[14];
    // direction = d * rsqrt(d.d + 1e-37)
    const float* d = t.d;
    const float dn = t.dn;
    const float g_s =
        -0.5f * (gx * d[0] + gy * d[1] + gz * d[2]) * (dn * dn * dn);
    float g_p[3] = {gx * dn + 2.0f * g_s * d[0], gy * dn + 2.0f * g_s * d[1],
                    gz * dn + 2.0f * g_s * d[2]};

    // ---- opacity: logw = ... + log(clamp(sigmoid(alpha), 1e-30)) ----
    const float alpha = t.alpha;
    const float g_alpha =
        alpha >= kLogFloor ? g[kGlogw] / clamp_min(alpha, kLogFloor) : 0.0f;
    f[7] = g_alpha * (1.0f - alpha) * alpha;

    // ---- conic (the determinant floored at COV_LOW_PASS^2) ----
    const float inv_det = t.inv_det, fa = t.fa, fc = t.fc, cov_b = t.cov_b;
    const float g_fc = g[kGa] * inv_det;
    const float g_fa = g[kGc] * inv_det;
    float g_covb = -(g[kGb] * inv_det);
    const float g_inv = g[kGa] * fc - g[kGb] * cov_b + g[kGc] * fa;
    const float g_det =
        t.det_raw >= kLowPass2 ? -g_inv * inv_det * inv_det : 0.0f;
    const float g_cova = g_fa + g_det * fc;
    const float g_covc = g_fc + g_det * fa;
    g_covb = g_covb - 2.0f * g_det * cov_b;

    // ---- cov2d = P P^T ----
    const float* p = t.p;
    float gp[6];
    for (int c = 0; c < 3; ++c) {
      gp[c] = 2.0f * g_cova * p[c] + g_covb * p[3 + c];
      gp[3 + c] = g_covb * p[c] + 2.0f * g_covc * p[3 + c];
    }

    // ---- P = (J W) M ----
    const float* m = t.m;
    const float* jw = t.jw;
    float g_jw[6], g_m[9];
    for (int row = 0; row < 2; ++row)
      for (int k = 0; k < 3; ++k)
        g_jw[3 * row + k] = gp[3 * row] * m[3 * k] +
                            gp[3 * row + 1] * m[3 * k + 1] +
                            gp[3 * row + 2] * m[3 * k + 2];
    for (int k = 0; k < 3; ++k)
      for (int c = 0; c < 3; ++c)
        g_m[3 * k + c] = jw[k] * gp[c] + jw[3 + k] * gp[3 + c];
    const float* w = t.w;
    const float g_j00 = g_jw[0] * w[0] + g_jw[1] * w[1] + g_jw[2] * w[2];
    const float g_j02 = g_jw[0] * w[6] + g_jw[1] * w[7] + g_jw[2] * w[8];
    const float g_j11 = g_jw[3] * w[3] + g_jw[4] * w[4] + g_jw[5] * w[5];
    const float g_j12 = g_jw[3] * w[6] + g_jw[4] * w[7] + g_jw[5] * w[8];

    // ---- u, v and J from (xc, yc, 1 / clamp(zc, near)) ----
    const float fx = t.fx, fy = t.fy, xc = t.xc, yc = t.yc, inv_z = t.inv_z;
    const float inv_z2 = inv_z * inv_z;
    const float g_xc = g[kGu] * fx * inv_z - g_j02 * fx * inv_z2;
    const float g_yc = g[kGv] * fy * inv_z - g_j12 * fy * inv_z2;
    const float g_invz = g[kGu] * fx * xc + g[kGv] * fy * yc + g_j00 * fx +
                         g_j11 * fy - 2.0f * g_j02 * fx * xc * inv_z -
                         2.0f * g_j12 * fy * yc * inv_z;
    const float g_zc = t.zc >= prm.near_plane ? -g_invz * inv_z2 : 0.0f;

    // ---- camera transform: (xc, yc, zc) = W p' + t ----
    for (int c = 0; c < 3; ++c)
      g_p[c] = g_p[c] + w[c] * g_xc + w[3 + c] * g_yc + w[6 + c] * g_zc;

    if (prm.edit != nullptr) {
      // p' = R_e (p * s_e + t_e); M' = R_e (S_e M)
      const float* e = t.e;
      float g_a[3];
      for (int c = 0; c < 3; ++c)
        g_a[c] = e[c] * g_p[0] + e[3 + c] * g_p[1] + e[6 + c] * g_p[2];
      for (int c = 0; c < 3; ++c) g_p[c] = g_a[c] * t.se[c];
      float g_b[9];
      for (int k = 0; k < 3; ++k)
        for (int c = 0; c < 3; ++c)
          g_b[3 * k + c] =
              t.se[k] * (e[k] * g_m[c] + e[3 + k] * g_m[3 + c] +
                         e[6 + k] * g_m[6 + c]);
      for (int k = 0; k < 9; ++k) g_m[k] = g_b[k];
    }

    // ---- M = R diag(exp(log s)) ----
    const float* r = t.r;
    float g_r[9];
    for (int k = 0; k < 3; ++k)
      for (int c = 0; c < 3; ++c) g_r[3 * k + c] = g_m[3 * k + c] * t.s[c];
    for (int c = 0; c < 3; ++c)
      f[4 + c] = (g_m[c] * r[c] + g_m[3 + c] * r[3 + c] +
                  g_m[6 + c] * r[6 + c]) *
                 t.s[c];

    // ---- R(q), q = raw / |raw| with the norm held constant ----
    const float qx = t.q[0], qy = t.q[1], qz = t.q[2], qw = t.q[3];
    const float g_qx =
        2.0f * (qy * (g_r[1] + g_r[3]) + qz * (g_r[2] + g_r[6]) +
                qw * (g_r[7] - g_r[5]) - 2.0f * qx * (g_r[4] + g_r[8]));
    const float g_qy =
        2.0f * (qx * (g_r[1] + g_r[3]) + qz * (g_r[5] + g_r[7]) +
                qw * (g_r[2] - g_r[6]) - 2.0f * qy * (g_r[0] + g_r[8]));
    const float g_qz =
        2.0f * (qx * (g_r[2] + g_r[6]) + qy * (g_r[5] + g_r[7]) +
                qw * (g_r[3] - g_r[1]) - 2.0f * qz * (g_r[0] + g_r[4]));
    const float g_qw = 2.0f * (qx * (g_r[7] - g_r[5]) +
                               qy * (g_r[2] - g_r[6]) + qz * (g_r[3] - g_r[1]));
    f[0] = g_qx * t.q_inv;
    f[1] = g_qy * t.q_inv;
    f[2] = g_qz * t.q_inv;
    f[3] = g_qw * t.q_inv;

    for (int c = 0; c < 3; ++c) grad_pc[3 * i + c] = g_p[c];
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(grad_feats) +
                static_cast<size_t>(base) * kFeatureVectors;
  for (int j = threadIdx.x; j < rows * kFeatureVectors; j += blockDim.x) {
    const int row = j / kFeatureVectors, col = j % kFeatureVectors;
    dst[j] = *reinterpret_cast<const float4*>(rows_smem + row * kRowStride +
                                              4 * col);
  }
}

}  // namespace
}  // namespace t3dgs_proj

// pointcloud (N, 3) f32, feats (N, 56) f32 16-byte aligned, object_id (N,)
// int32 (read only when num_objects > 1), all contiguous; the tables,
// intrinsics and mask as for t3dgs_project_forward; cot: 9 rows of N f32,
// row k at cot + k * cot_stride. Writes grad_pc (N, 3) and grad_feats
// (N, 56, 16-byte aligned), every row. Returns a cudaError_t.
extern "C" int t3dgs_project_backward(
    const void* pointcloud, const void* feats, const void* object_id, int n,
    const void* table, const void* edit, int num_objects,
    const void* intrinsics, const void* sh_mask, float near_plane,
    const void* cot, long long cot_stride, void* grad_pc, void* grad_feats,
    void* stream) {
  using namespace t3dgs_proj;
  if (n < 0 || num_objects < 1 || table == nullptr || intrinsics == nullptr ||
      (num_objects > 1 && object_id == nullptr) || cot_stride < n ||
      (reinterpret_cast<uintptr_t>(feats) % 16) != 0 ||
      (reinterpret_cast<uintptr_t>(grad_feats) % 16) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  Params prm{static_cast<const float*>(table),
             static_cast<const float*>(edit),
             num_objects,
             static_cast<const float*>(intrinsics),
             static_cast<const float*>(sh_mask),
             near_plane, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  projection_backward_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pointcloud), static_cast<const float*>(feats),
      static_cast<const int*>(object_id), n, prm,
      static_cast<const float*>(cot), cot_stride,
      static_cast<float*>(grad_pc), static_cast<float*>(grad_feats));
  return static_cast<int>(cudaGetLastError());
}
