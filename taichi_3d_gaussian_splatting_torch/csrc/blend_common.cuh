// Shared by the forward (blend_forward.cu) and backward (blend_backward.cu)
// per-tile blend kernels: the tile layout, the slab rows, the chunk work
// list, the key staging, and the one per-(pixel, key) alpha step whose skip
// / clamp / saturation decisions the backward must reproduce exactly as the
// forward made them.
//
// A key at the 1/255 skip gate or the 1e-4 saturation edge that contributed
// in the forward but not in the backward (or the reverse) would get a
// gradient for a colour it never blended. Both kernels therefore call
// blend_alpha below, compiled from this one source with the same flags (no
// fast math, expf), so their skip decisions are bit-identical on the card;
// the backward takes the saturation decision from the forward's `last`.
//
// Tensor cores are not used, by decision: the TPU kernel's tile-centred
// monomial matmul for the exponent, in TF32 or bf16, would move the exponent
// by ~1e-3 relative and flip keys at the 1/255 and 1e-4 gates.
//
// Work list (blend_cuda.py chunk_work_list is its plain version): each
// tile's segment [tile_starts[t], tile_ends[t]), clamped into [0, mk], is
// cut into chunks of at most `chunk` keys (blend_cuda.py CHUNK_KEYS, passed
// by the wrappers), one work item each (an empty tile is one empty item).
// Tiles of more than one chunk ("split" tiles) come first, so the long work
// starts first; each group stays in tile order. build_work_kernel writes
// one column of item fields per item, rows of an int32 (kItemRows, stride)
// array: tile (-1: no item), first key, end key, chunk index j in the tile,
// chunk count n of the tile. The items of one tile are consecutive, so item
// i's tile starts at item i - j. It also zeroes one counter per tile, with
// which the last chunk of a split tile to finish finds that it is the last
// (last_chunk_of_tile).

#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace t3dgs {

constexpr int kTileWidth = 16;
constexpr int kTileHeight = 16;
constexpr int kPixels = kTileWidth * kTileHeight;
constexpr float kAlphaSkip = 1.0f / 255.0f;
constexpr float kAlphaClamp = 0.99f;
constexpr float kSaturation = 1e-4f;

constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kItemRows = 5;
enum ItemRow { kItemTile = 0, kItemStart = 1, kItemEnd = 2, kItemIndex = 3,
               kItemCount = 4 };

struct WorkItem {
  int tile, start, end, j, n;
};

// Item i of the work list.
__device__ __forceinline__ WorkItem load_item(const int* items, int stride,
                                              int i) {
  WorkItem w;
  w.tile = items[kItemTile * stride + i];
  w.start = items[kItemStart * stride + i];
  w.end = items[kItemEnd * stride + i];
  w.j = items[kItemIndex * stride + i];
  w.n = items[kItemCount * stride + i];
  return w;
}

// One staged key as vectors: a (pixel, key) pair reads `geo` and `cw`
// (two broadcast loads from shared memory instead of six scalar ones), and
// `col` only where the key contributes.
struct StagedKey {
  float4 geo;  // u, v, conic a, conic b
  float4 col;  // r, g, b, depth
  float2 cw;   // conic c, logw
};

// The slab rows a kernel stages, as raw 32-bit words: packed8 all 8 rows;
// wide16 (blend_cuda.py ROW_*) rows 0-5 (u, v, a, b, c, logw) and 8-10
// (r, g, b), and 11 (depth) with WITH_DEPTH.
template <bool PACKED8, bool WITH_DEPTH>
struct SlabRows {
  static constexpr int kRows = PACKED8 ? 8 : (WITH_DEPTH ? 10 : 9);
  __device__ static __forceinline__ int src_row(int r) {
    return PACKED8 ? r : (r < 6 ? r : r + 2);
  }
  // Unpack key k of a raw batch (raw[row][key]). packed8 rows 6 and 7 hold
  // bf16(r)|bf16(g) and bf16(b)|bf16(depth); a bf16's bits are the top
  // half of its f32.
  template <int BATCH>
  __device__ static __forceinline__ StagedKey unpack(uint32_t (*raw)[BATCH],
                                                    int k) {
    StagedKey s;
    s.geo = make_float4(__uint_as_float(raw[0][k]), __uint_as_float(raw[1][k]),
                        __uint_as_float(raw[2][k]), __uint_as_float(raw[3][k]));
    s.cw = make_float2(__uint_as_float(raw[4][k]), __uint_as_float(raw[5][k]));
    float r, g, b, d = 0.0f;
    if (PACKED8) {
      const uint32_t rg = raw[6][k];
      const uint32_t bd = raw[7][k];
      r = __uint_as_float(rg & 0xFFFF0000u);
      g = __uint_as_float(rg << 16);
      b = __uint_as_float(bd & 0xFFFF0000u);
      if (WITH_DEPTH) d = __uint_as_float(bd << 16);
    } else {
      r = __uint_as_float(raw[6][k]);
      g = __uint_as_float(raw[7][k]);
      b = __uint_as_float(raw[8][k]);
      if (WITH_DEPTH) d = __uint_as_float(raw[9][k]);
    }
    s.col = make_float4(r, g, b, d);
    return s;
  }
};

// Double-buffered staging of a key range [start, end) in batches of BATCH
// keys, thread k copying key k of a batch. Batch b lands by cp.async in
// raw[b & 1] two batches ahead of its use, so its device-memory round trip
// overlaps the blending of the batch before. Every thread commits one
// cp.async group per issue(), copies or not, so that __pipeline_wait_prior
// counts the same groups in every thread.
//
// Per batch b the kernel does: wait(); barrier; unpack(b); barrier;
// issue(b + 2); then reads keys[0, count(b)).
template <class Rows, int BATCH>
struct Stager {
  uint32_t (*raw)[Rows::kRows][BATCH];  // [2]
  StagedKey* keys;                      // [BATCH]
  const uint32_t* data;
  size_t mk;
  int start, end, k;

  __device__ __forceinline__ int batches() const {
    return end > start ? (end - start + BATCH - 1) / BATCH : 0;
  }
  __device__ __forceinline__ int first(int b) const {
    return start + b * BATCH;
  }
  __device__ __forceinline__ int count(int b) const {
    return min(BATCH, end - first(b));
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
  // batch b has landed (b + 1 may still be in flight)
  __device__ __forceinline__ void wait() const { __pipeline_wait_prior(1); }
  __device__ __forceinline__ void unpack(int b) {
    if (k < count(b)) keys[k] = Rows::template unpack<BATCH>(raw[b & 1], k);
  }
  // before the block leaves: no copy may still be writing shared memory
  __device__ __forceinline__ void drain() const { __pipeline_wait_prior(0); }
};

// What one key does to one pixel.
enum BlendKind { kSkip = 0, kSaturate = 1, kContribute = 2 };

struct BlendAlpha {
  float alpha_exp;  // exp(exponent), before the skip gate and the clamp
  float alpha;      // min(alpha_exp, 0.99)
  float t_next;     // T * (1 - alpha)
  int kind;         // BlendKind
};

// The alpha step of the front-to-back blend at pixel centre (px, py) for a
// staged key (geo = u, v, a, b; cw = c, logw) with the pixel's
// transmittance T so far: skip if alpha < 1/255; otherwise clamp at 0.99,
// and the key saturates the pixel (and does not contribute) if
// T (1 - alpha) < 1e-4. The exponent is written as the first design wrote
// it, so that it rounds as before: a form with fewer operations rounded
// differently and moved keys across the 1/255 gate against the plain
// version (PERF.md).
__device__ __forceinline__ BlendAlpha blend_alpha(float px, float py,
                                                  const float4& geo,
                                                  const float2& cw, float T) {
  BlendAlpha r;
  const float dx = px - geo.x;
  const float dy = py - geo.y;
  r.alpha_exp = expf(-0.5f * (geo.z * dx * dx + cw.x * dy * dy) -
                     geo.w * dx * dy + cw.y);
  r.alpha = fminf(r.alpha_exp, kAlphaClamp);
  r.t_next = T * (1.0f - r.alpha);
  r.kind = r.alpha_exp < kAlphaSkip
               ? kSkip
               : (r.t_next < kSaturation ? kSaturate : kContribute);
  return r;
}

// Pixel centre of tile pixel p (p = v_in * 16 + u_in, centre + 0.5).
__device__ __forceinline__ float pixel_x(int t, int p, int tiles_per_row) {
  return static_cast<float>((t % tiles_per_row) * kTileWidth + p % kTileWidth) +
         0.5f;
}

__device__ __forceinline__ float pixel_y(int t, int p, int tiles_per_row) {
  return static_cast<float>((t / tiles_per_row) * kTileHeight +
                            p / kTileWidth) +
         0.5f;
}

constexpr int kBuildThreads = 1024;

// Exclusive sum of (x, y) over the block's threads; returns the totals.
__device__ __forceinline__ int2 block_exclusive_sum(int2& v) {
  __shared__ int2 warp_total[kBuildThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFullMask, inc.x, off);
    const int y = __shfl_up_sync(kFullMask, inc.y, off);
    if (lane >= off) {
      inc.x += x;
      inc.y += y;
    }
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int2 w = warp_total[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFullMask, w.x, off);
      const int y = __shfl_up_sync(kFullMask, w.y, off);
      if (lane >= off) {
        w.x += x;
        w.y += y;
      }
    }
    warp_total[lane] = w;
  }
  __syncthreads();
  const int2 base = warp > 0 ? warp_total[warp - 1] : make_int2(0, 0);
  v = make_int2(base.x + inc.x - v.x, base.y + inc.y - v.y);
  return warp_total[kBuildThreads / 32 - 1];
}

// Tile t's range clamped into [0, mk] (a malformed range reads no memory
// outside the slab; the wrapper cannot check the values without a host
// sync), and its count of chunks of at most `chunk` keys: (start, end, n).
__device__ __forceinline__ int3 tile_chunks(const int* tile_starts,
                                            const int* tile_ends, int t,
                                            int mk, int chunk) {
  const int start = min(max(tile_starts[t], 0), mk);
  const int end = max(min(tile_ends[t], mk), start);
  return make_int3(start, end, max(1, (end - start + chunk - 1) / chunk));
}

// The work list, by one block of kBuildThreads threads: thread k takes a
// run of consecutive tiles, the block sums the split tiles, their items and
// the other tiles before each run, and each thread places its tiles (split
// tiles first, each group in tile order) and writes their items and zeroes
// their counters. Columns past the last item are written as "no item".
// `items` has num_items columns; an item past them (only for malformed,
// overlapping ranges) is dropped, and its tile is never merged.
static __global__ void __launch_bounds__(kBuildThreads)
build_work_kernel(const int* __restrict__ tile_starts,
                  const int* __restrict__ tile_ends, int num_tiles, int mk,
                  int chunk, int* __restrict__ counters,
                  int* __restrict__ items, int num_items) {
  const int per = (num_tiles + kBuildThreads - 1) / kBuildThreads;
  const int t0 = min(static_cast<int>(threadIdx.x) * per, num_tiles);
  const int t1 = min(t0 + per, num_tiles);
  int2 mine = make_int2(0, 0);  // items of split tiles, other tiles
  for (int t = t0; t < t1; ++t) {
    const int n = tile_chunks(tile_starts, tile_ends, t, mk, chunk).z;
    if (n > 1) {
      mine.x += n;
    } else {
      ++mine.y;
    }
  }
  int2 at = mine;
  const int2 total = block_exclusive_sum(at);
  for (int t = t0; t < t1; ++t) {
    const int3 c = tile_chunks(tile_starts, tile_ends, t, mk, chunk);
    int first;
    if (c.z > 1) {
      first = at.x;
      at.x += c.z;
    } else {
      first = total.x + at.y;
      ++at.y;
    }
    counters[t] = 0;
    for (int j = 0; j < c.z && first + j < num_items; ++j) {
      const int i = first + j;
      items[kItemTile * num_items + i] = t;
      items[kItemStart * num_items + i] = c.x + j * chunk;
      items[kItemEnd * num_items + i] = min(c.x + (j + 1) * chunk, c.y);
      items[kItemIndex * num_items + i] = j;
      items[kItemCount * num_items + i] = c.z;
    }
  }
  for (int i = total.x + total.y + threadIdx.x; i < num_items;
       i += kBuildThreads) {
    items[kItemTile * num_items + i] = -1;
#pragma unroll
    for (int r = 1; r < kItemRows; ++r) items[r * num_items + i] = 0;
  }
}

// Launch build_work_kernel on `st`.
static inline cudaError_t build_work(const int* tile_starts,
                                     const int* tile_ends, int num_tiles,
                                     int mk, int chunk, int* counters,
                                     int* items, int num_items,
                                     cudaStream_t st) {
  build_work_kernel<<<1, kBuildThreads, 0, st>>>(
      tile_starts, tile_ends, num_tiles, mk, chunk, counters, items,
      num_items);
  return cudaGetLastError();
}

// Called by every thread of a block that wrote the partials of chunk j of
// a split tile: returns true in the block of the tile's last chunk to
// finish, once the other chunks' partials are visible to it. The partials
// are merged there, in chunk order, so the result does not depend on which
// block comes last.
__device__ __forceinline__ bool last_chunk_of_tile(int* counters, int tile,
                                                   int n, int* s_flag) {
  __threadfence();  // this thread's partials, before the count
  __syncthreads();
  if (threadIdx.x == 0) *s_flag = atomicAdd(&counters[tile], 1) == n - 1;
  __syncthreads();
  if (!*s_flag) return false;
  __threadfence();  // the other chunks' partials, before reading them
  return true;
}

}  // namespace t3dgs
