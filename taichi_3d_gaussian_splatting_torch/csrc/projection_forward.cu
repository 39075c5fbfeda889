// The projection's forward (P1) for NVIDIA Hopper (sm_90a): per point, the
// camera transform (and the optional per-object edit), the EWA covariance,
// the conic with its low-pass rescale, the SH colour, the opacity-aware
// extents, the frustum test and the numeric containment of
// ops/projection.py::compute_point_attributes, plus the blend's logw
// column (ops/projection.py::blend_logw).
//
// The JAX package has no Pallas kernel for this stage: it jits
// taichi_3d_gaussian_splatting_tpu/ops/projection.py::compute_point_attributes
// and XLA fuses it into a few loops over the points. Run as about 250
// eager torch ops over (N,) columns, it was the largest stage of the frame
// on the H100; this kernel is that stage in one launch.
//
// Bound: bytes. A point reads 12 (position) + 224 (features) + 1 (invalid
// flag) bytes, and its object id (4) when K > 1, and writes 15 float
// columns and 2 mask bytes: ~300 bytes, against a few hundred float
// operations. One thread a point; the block's feature rows come in
// through shared memory as consecutive 16-byte vectors
// (projection_common.cuh stage_rows), and every output is a (N,) row, so
// each warp writes consecutive addresses. The non-finite count takes one
// atomic add a block.

#include "projection_common.cuh"

namespace t3dgs_proj {
namespace {

// Output rows of the (15, N) float buffer (projection_cuda.py FLOAT_ROWS).
enum OutRow {
  kU = 0, kV, kDepth, kConicA, kConicB, kConicC, kRescale, kAlpha, kColorR,
  kColorG, kColorB, kRadii, kRadiusX, kRadiusY, kLogw, kOutRows
};

__global__ void __launch_bounds__(kBlock)
    projection_forward_kernel(const float* __restrict__ pointcloud,
                              const float* __restrict__ feats,
                              const uint8_t* __restrict__ invalid,
                              const int* __restrict__ object_id, int n,
                              Params prm, float* __restrict__ out,
                              uint8_t* __restrict__ masks,
                              int* __restrict__ nonfinite) {
  __shared__ __align__(16) float rows_smem[kBlock * kRowStride];
  const int base = blockIdx.x * kBlock;
  stage_rows(feats, rows_smem, base, min(kBlock, n - base));
  __syncthreads();
  const int i = base + threadIdx.x;
  bool counted = false;
  if (i < n) {
    Terms t;
    const float point[3] = {pointcloud[3 * i], pointcloud[3 * i + 1],
                            pointcloud[3 * i + 2]};
    forward_terms(point, rows_smem + threadIdx.x * kRowStride,
                  object_of(object_id, i, prm.num_objects), prm, t);
    const bool valid = invalid[i] == 0;
    const bool in_frustum = t.zc > prm.near_plane && t.zc < prm.far_plane &&
                            t.u >= prm.u_lo && t.u < prm.u_hi &&
                            t.v >= prm.v_lo && t.v < prm.v_hi && valid;
    const bool finite =
        isfinite(t.u) && isfinite(t.v) && isfinite(t.zc) &&
        isfinite(t.conic_a) && isfinite(t.conic_b) && isfinite(t.conic_c) &&
        isfinite(t.rescale) && isfinite(t.alpha) && isfinite(t.color[0]) &&
        isfinite(t.color[1]) && isfinite(t.color[2]) &&
        isfinite(t.radius_x) && isfinite(t.radius_y);
    const bool visible = t.rescale * t.alpha >= kAlphaSkip;
    const float row[kOutRows] = {
        t.u, t.v, t.zc, t.conic_a, t.conic_b, t.conic_c, t.rescale,
        t.alpha, t.color[0], t.color[1], t.color[2], t.radii, t.radius_x,
        t.radius_y, t.logw};
    for (int r = 0; r < kOutRows; ++r)
      out[static_cast<size_t>(r) * n + i] = row[r];
    masks[i] = in_frustum;
    masks[static_cast<size_t>(n) + i] = in_frustum && finite && visible;
    counted = valid && !finite;
  }
  const int count = __syncthreads_count(counted);
  if (threadIdx.x == 0 && count > 0) atomicAdd(nonfinite, count);
}

}  // namespace
}  // namespace t3dgs_proj

// pointcloud (N, 3) f32, feats (N, 56) f32 16-byte aligned, invalid (N,)
// uint8 (0 = valid), object_id (N,) int32 (read only when num_objects > 1),
// all contiguous; table / edit (16, K) f32 (edit null without editing);
// intrinsics (3, 3) f32; sh_mask (16,) f32 or null. Writes out (15, N) f32,
// masks (2, N) uint8 [in_frustum, emit] and the int32 nonfinite count
// (zeroed here first). Returns a cudaError_t.
extern "C" int t3dgs_project_forward(
    const void* pointcloud, const void* feats, const void* invalid,
    const void* object_id, int n, const void* table, const void* edit,
    int num_objects, const void* intrinsics, const void* sh_mask,
    float near_plane, float far_plane, float u_lo, float u_hi, float v_lo,
    float v_hi, void* out, void* masks, void* nonfinite, void* stream) {
  using namespace t3dgs_proj;
  if (n < 0 || num_objects < 1 || table == nullptr || intrinsics == nullptr ||
      (num_objects > 1 && object_id == nullptr) ||
      (reinterpret_cast<uintptr_t>(feats) % 16) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(nonfinite, 0, sizeof(int), st);
  if (e != cudaSuccess || n == 0) return static_cast<int>(e);
  Params prm{static_cast<const float*>(table),
             static_cast<const float*>(edit),
             num_objects,
             static_cast<const float*>(intrinsics),
             static_cast<const float*>(sh_mask),
             near_plane, far_plane, u_lo, u_hi, v_lo, v_hi};
  projection_forward_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      static_cast<const float*>(pointcloud), static_cast<const float*>(feats),
      static_cast<const uint8_t*>(invalid),
      static_cast<const int*>(object_id), n, prm, static_cast<float*>(out),
      static_cast<uint8_t*>(masks), static_cast<int*>(nonfinite));
  return static_cast<int>(cudaGetLastError());
}
