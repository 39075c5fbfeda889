// Shared by the K1 ablation probes (perf_rgb_ablate2.cu, S4;
// perf_kernel_ablate.cu, S3; perf_flip_proto.cu, S2): the TPU probes walk a
// tile's key range in chunks of 128 keys aligned down from the tile's first
// key, carry each pixel's transmittance and saturation latch from chunk to
// chunk, and leave the tile once every pixel has latched. A chunk's keys
// outside the tile's range are masked (alpha 0), except in `dma_only`, which
// reads every column of every chunk.
//
// One block of 256 threads per tile, thread p = pixel p (as K1,
// blend_forward.cu): a pixel walks the keys in order, so the TPU kernels'
// per-chunk prefix products become the pixel's running product, and a
// chunk's carry is what that product is at the chunk's end.

#pragma once

#include "../blend_common.cuh"

namespace t3dgs {
namespace probes {

constexpr int kChunk = 128;

// Tile t's key range clamped into [0, mk] (as tile_chunks), the first
// column of its first 128-key chunk, and its chunk count (0 for an empty
// range): the TPU probes' aligned_start and num_chunks.
struct ChunkRange {
  int start, end, aligned, chunks;
  __device__ __forceinline__ int stop() const {
    return aligned + chunks * kChunk;
  }
};

__device__ __forceinline__ ChunkRange chunk_range(const int* tile_starts,
                                                  const int* tile_ends, int t,
                                                  int mk) {
  ChunkRange r;
  r.start = min(max(tile_starts[t], 0), mk);
  r.end = max(min(tile_ends[t], mk), r.start);
  r.aligned = r.start / kChunk * kChunk;
  r.chunks = r.end > r.start ? (r.end - r.aligned + kChunk - 1) / kChunk : 0;
  return r;
}

// blend_common.cuh's Stager for a key type of the row set's own
// (Rows::Key, unpacked by Rows::unpack): the same cp.async double buffer,
// batch b landing in raw[b & 1] two batches ahead of its use.
template <class Rows, int BATCH>
struct KeyStager {
  uint32_t (*raw)[Rows::kRows][BATCH];  // [2]
  typename Rows::Key* keys;             // [BATCH]
  const uint32_t* data;
  size_t mk;
  int start, end, k;

  __device__ __forceinline__ int batches() const {
    return end > start ? (end - start - 1) / BATCH + 1 : 0;
  }
  __device__ __forceinline__ int first(int b) const {
    return start + b * BATCH;
  }
  __device__ __forceinline__ int count(int b) const {
    return static_cast<int>(min(static_cast<long long>(BATCH),
                                static_cast<long long>(end) - start -
                                    static_cast<long long>(b) * BATCH));
  }
  __device__ __forceinline__ void issue(int b) {
    if (k < count(b)) {
      const size_t col = static_cast<size_t>(first(b) + k);
#pragma unroll
      for (int r = 0; r < Rows::kRows; ++r) {
        __pipeline_memcpy_async(&raw[b & 1][r][k],
                                data + Rows::src_row(r) * mk + col, 4);
      }
    }
    __pipeline_commit();
  }
  __device__ __forceinline__ void wait() const { __pipeline_wait_prior(1); }
  __device__ __forceinline__ void unpack(int b) {
    if (k < count(b)) keys[k] = Rows::template unpack<BATCH>(raw[b & 1], k);
  }
  __device__ __forceinline__ void drain() const { __pipeline_wait_prior(0); }
};

}  // namespace probes
}  // namespace t3dgs
