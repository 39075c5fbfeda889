// Per-tile front-to-back alpha blend for NVIDIA Hopper (sm_90a).
//
// Replaces taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py::_forward_kernel
// in both of its instances: blend_forward_rgb (K1: RGB_ONLY, wide16 or
// packed8 slab) and blend_forward (K2: full outputs, wide16 slab). Its
// backward is blend_backward.cu, which replays this blend through the same
// alpha step (blend_common.cuh::blend_alpha).
//
// Bound at the main path's shapes (976x544, 2,074 tiles; the 430k scene's
// 561,637 keys and the 1.03M heavy scene's 1,381,647): per contributing
// (pixel, key) pair 26 float operations for K1 and 28 for K2 (one expf),
// per skipped pair 14 (the exponent, the expf and the skip compare) and 18
// for a pixel's saturating key, against 67 TFLOP/s; the slab (32 or 40
// bytes a key) and the 8 KB output a tile move in ~0.02 ms at 3.35 TB/s.
// So the operations bound it; tests/torch_chunk_fixtures.py work() counts
// the pairs of an input and its bound.
//
// What limited the first design (one block of 256 threads per tile, one
// pixel a thread, one shared buffer of 10 scalar arrays):
//  1. load imbalance: the 1.03M heavy scene's longest tile has 22,500 keys
//     against a mean of 666, and its one block walked them all in order
//     while the rest of the card idled (2.2 ms of the frame);
//  2. each batch waited a full device-memory round trip between barriers;
//  3. each pair read 10 scalars from shared memory.
// What this design does:
//  1. Work list (blend_common.cuh): segments are cut into chunks of at most
//     blend_cuda.py CHUNK_KEYS = 768 keys, one block each, split tiles'
//     chunks first. 768 is at least the 430k scene's longest segment
//     (664), so that scene blends in one pass with no merge; the
//     22,500-key tile becomes 30 chunks. Shorter chunks (256, 512) cost more in pass A than they saved
//     on the card, and 1024 no less (PERF.md).
//  2. cp.async stages batch b + 2 while batch b blends (blend_common.cuh
//     Stager).
//  3. A key is staged as vectors: a pair reads two broadcast vectors for
//     its alpha and the colour vector only where it contributes. One pixel
//     a thread, one block of 256 per item: two pixels a thread (each staged
//     key read once for both) took more registers and ran slower on the
//     card (PERF.md).
//
// Transmittance across chunks, exactly. Chunk j of a split tile needs each
// pixel's T at its start.
//  - Pass A (chunk_transmittance_kernel): every chunk but the last computes
//    per pixel T_chunk = prod (1 - min(alpha, 0.99)) over its non-skipped
//    keys, from 1; it may stop once the product falls below 1e-4.
//  - Pass B (blend_forward_kernel): chunk j starts from T_in = prod_{k<j}
//    T_chunk(k). Each factor lies in [0.01, 1], and a product rounded to
//    nearest never grows when multiplied by such a factor, so T is
//    non-increasing along the segment. Hence T_in < 1e-4 exactly when the
//    pixel saturated in an earlier chunk (the saturating key's factor is in
//    the product), up to the rounding of that product at the 1e-4 edge, and
//    then chunk j contributes nothing. Otherwise every non-skipped key of
//    the earlier chunks contributed, T_in is the sequential T up to
//    rounding order, and chunk j blends from it with the same saturation
//    test.
//  - Merge (in pass B): each chunk of a split tile writes its partials (r,
//    g, b, sum w, sum w d, last, count, T at its end) and its state (ran
//    through, saturated in this chunk, or started saturated) and counts
//    itself done on the tile's counter; the last chunk to finish sums them
//    in chunk order, taking last as the max and T from the chunk summed
//    last, and computes depth after the merge. It stops before a chunk that
//    started saturated and after the chunk in which the pixel saturated.
//    Where T_in(j + 1) = T_in(j) T_chunk(j) rounds to >= 1e-4 although pass
//    B saturated the pixel in chunk j, chunk j + 1 starts active; with T_in
//    within rounding of 1e-4 it saturates the pixel at its first
//    non-skipped key (alpha >= 1/255) and blends nothing, but its T is not
//    the pixel's: the merge takes T from chunk j, the T before the
//    saturating key, as the sequential blend ends, and whatever a chunk
//    after j holds never reaches the output. So the merged `last` never
//    passes the saturating key, and K3, which takes every non-skipped key
//    below `last`, replays exactly the keys blended here. No float
//    atomics: a frame is the same from run to run.
//
// Deliberately not carried over from the TPU kernel: its log-doubling prefix
// product for the transmittance (see blend_common.cuh for its monomial
// matmul). A sequential per-pixel loop rounds differently, so the kernel is
// compared with its plain version (blend_cuda.py::blend_forward_torch) and
// with the TPU kernel under tolerances, not bitwise.
//
// No fast math: the 1/255 skip gate and the 1e-4 saturation stop are
// threshold compares, and an approximate exp would flip keys at the edge.

#include "blend_common.cuh"

namespace {

using namespace t3dgs;

constexpr int kOutRows = 8;
// partial rows of a chunk of a split tile (blend_cuda.py PARTIAL_ROWS)
constexpr int kPartRows = 9;
enum PartRow { kPartR = 0, kPartG, kPartB, kPartW, kPartWD, kPartLast,
               kPartCount, kPartT, kPartState };
// what a chunk did to a pixel (row kPartState)
enum ChunkState { kRanThrough = 0, kSaturatedHere = 1, kStartedSaturated = 2 };

// Pass A: T_chunk of every chunk of a split tile but its last.
template <bool PACKED8>
__global__ void __launch_bounds__(kPixels)
chunk_transmittance_kernel(const uint32_t* __restrict__ data,
                           const int* __restrict__ items, int stride,
                           float* __restrict__ tchunk, int mk,
                           int tiles_per_row) {
  using Rows = SlabRows<PACKED8, false>;
  __shared__ __align__(16) uint32_t raw[2][Rows::kRows][kPixels];
  __shared__ StagedKey keys[kPixels];
  const int i = blockIdx.x;
  const WorkItem w = load_item(items, stride, i);
  if (w.tile < 0 || w.n <= 1 || w.j == w.n - 1) return;
  const int p = threadIdx.x;
  const float px = pixel_x(w.tile, p, tiles_per_row);
  const float py = pixel_y(w.tile, p, tiles_per_row);
  float T = 1.0f;
  bool done = false;
  Stager<Rows, kPixels> st{raw, keys, data, static_cast<size_t>(mk), w.start,
                           w.end, p};
  const int nb = st.batches();
  st.issue(0);
  st.issue(1);
  for (int b = 0; b < nb; ++b) {
    st.wait();
    if (__syncthreads_count(!done) == 0) break;
    st.unpack(b);
    __syncthreads();
    st.issue(b + 2);
    if (done) continue;
    const int n = st.count(b);
    for (int jj = 0; jj < n; ++jj) {
      const BlendAlpha a = blend_alpha(px, py, keys[jj].geo, keys[jj].cw, T);
      if (a.kind == kSkip) continue;
      T = a.t_next;
      if (T < kSaturation) {
        done = true;
        break;
      }
    }
  }
  st.drain();
  tchunk[static_cast<size_t>(i) * kPixels + p] = T;
}

// One pixel's output rows (blend_cuda.py OUT_*).
template <bool RGB_ONLY>
__device__ __forceinline__ void write_out(float* out, int tile, int p, float r,
                                          float g, float b, float sw,
                                          float swd, float T, float last,
                                          float count) {
  float* o = out + static_cast<size_t>(tile) * kOutRows * kPixels + p;
  o[0 * kPixels] = r;
  o[1 * kPixels] = g;
  o[2 * kPixels] = b;
  o[3 * kPixels] = RGB_ONLY ? 0.0f : swd / fmaxf(sw, 1e-6f);
  o[4 * kPixels] = 1.0f - T;
  o[5 * kPixels] = sw;
  o[6 * kPixels] = RGB_ONLY ? 0.0f : last;
  o[7 * kPixels] = RGB_ONLY ? 0.0f : count;
}

// Pass B: blend one work item. A tile of one chunk writes its output; a
// chunk of a split tile starts from T_in and writes its partials, and the
// tile's last chunk to finish merges them.
template <bool PACKED8, bool RGB_ONLY>
__global__ void __launch_bounds__(kPixels)
blend_forward_kernel(const uint32_t* __restrict__ data,
                     const int* __restrict__ items, int stride,
                     const float* __restrict__ tchunk,
                     float* __restrict__ partial, int* __restrict__ counters,
                     float* __restrict__ out, int num_split_items, int mk,
                     int tiles_per_row) {
  using Rows = SlabRows<PACKED8, !RGB_ONLY>;
  __shared__ __align__(16) uint32_t raw[2][Rows::kRows][kPixels];
  __shared__ StagedKey keys[kPixels];
  const int i = blockIdx.x;
  const WorkItem w = load_item(items, stride, i);
  // (a split tile's item beyond the scratch exists only for malformed,
  // overlapping ranges: it is dropped, and no memory outside is touched)
  if (w.tile < 0 || (w.n > 1 && i >= num_split_items)) return;
  const int p = threadIdx.x;
  const float px = pixel_x(w.tile, p, tiles_per_row);
  const float py = pixel_y(w.tile, p, tiles_per_row);
  // T_in of chunk j: the product of the earlier chunks' T_chunk
  float T = 1.0f;
  for (int c = 0; c < w.j; ++c) {
    T *= tchunk[static_cast<size_t>(i - w.j + c) * kPixels + p];
  }
  const bool active = T >= kSaturation;
  bool done = !active;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_w = 0.0f, acc_d = 0.0f;
  int last = 0;
  int count = 0;

  Stager<Rows, kPixels> st{raw, keys, data, static_cast<size_t>(mk), w.start,
                           w.end, p};
  const int nb = st.batches();
  st.issue(0);
  st.issue(1);
  // Uniform across the block: every thread, done or not, reaches both
  // barriers of every batch; the block leaves once every pixel is done.
  for (int b = 0; b < nb; ++b) {
    st.wait();
    if (__syncthreads_count(!done) == 0) break;
    st.unpack(b);
    __syncthreads();
    st.issue(b + 2);
    if (done) continue;
    const int n = st.count(b);
    const int col0 = st.first(b);
    for (int jj = 0; jj < n; ++jj) {
      const BlendAlpha a = blend_alpha(px, py, keys[jj].geo, keys[jj].cw, T);
      if (a.kind == kSkip) continue;
      if (a.kind == kSaturate) {  // the saturating key does not contribute
        done = true;
        break;
      }
      const float4 col = keys[jj].col;
      const float wt = a.alpha * T;
      acc_r += wt * col.x;
      acc_g += wt * col.y;
      acc_b += wt * col.z;
      acc_w += wt;
      if (!RGB_ONLY) {
        acc_d += wt * col.w;
        last = col0 + jj + 1;
        ++count;
      }
      T = a.t_next;
    }
  }
  st.drain();

  if (w.n <= 1) {  // every output element is written, empty tiles included
    write_out<RGB_ONLY>(out, w.tile, p, acc_r, acc_g, acc_b, acc_w, acc_d, T,
                        static_cast<float>(last), static_cast<float>(count));
    return;
  }
  float* o = partial + static_cast<size_t>(i) * kPartRows * kPixels + p;
  o[kPartR * kPixels] = acc_r;
  o[kPartG * kPixels] = acc_g;
  o[kPartB * kPixels] = acc_b;
  o[kPartW * kPixels] = acc_w;
  o[kPartWD * kPixels] = acc_d;
  o[kPartLast * kPixels] = static_cast<float>(last);
  o[kPartCount * kPixels] = static_cast<float>(count);
  o[kPartT * kPixels] = T;
  o[kPartState * kPixels] = static_cast<float>(
      !active ? kStartedSaturated : (done ? kSaturatedHere : kRanThrough));
  // Merge: the tile's last chunk to finish sums the partials of its
  // chunks in chunk order up to the one that saturated the pixel, takes
  // last as the max and T from the chunk summed last, and computes depth
  // after the sums.
  __shared__ int s_last_chunk;
  if (!last_chunk_of_tile(counters, w.tile, w.n, &s_last_chunk)) return;
  float r = 0.0f, g = 0.0f, bl = 0.0f, sw = 0.0f, swd = 0.0f, lst = 0.0f,
        cnt = 0.0f, t_out = 1.0f;
  for (int c = 0; c < w.n; ++c) {
    // written by other blocks: read past the L1 cache
    const float* s =
        partial + static_cast<size_t>(i - w.j + c) * kPartRows * kPixels + p;
    const float state = __ldcg(s + kPartState * kPixels);
    if (state == kStartedSaturated) break;  // and so did every later chunk
    r += __ldcg(s + kPartR * kPixels);
    g += __ldcg(s + kPartG * kPixels);
    bl += __ldcg(s + kPartB * kPixels);
    sw += __ldcg(s + kPartW * kPixels);
    swd += __ldcg(s + kPartWD * kPixels);
    lst = fmaxf(lst, __ldcg(s + kPartLast * kPixels));
    cnt += __ldcg(s + kPartCount * kPixels);
    t_out = __ldcg(s + kPartT * kPixels);
    if (state == kSaturatedHere) break;
  }
  write_out<RGB_ONLY>(out, w.tile, p, r, g, bl, sw, swd, t_out, lst, cnt);
}

template <bool PACKED8, bool RGB_ONLY>
cudaError_t launch(const uint32_t* data, const int* items, int num_items,
                   int num_split_items, int* counters, float* tchunk,
                   float* partial, float* out, int mk, int tiles_per_row,
                   cudaStream_t st) {
  if (num_split_items > 0) {
    chunk_transmittance_kernel<PACKED8><<<num_split_items, kPixels, 0, st>>>(
        data, items, num_items, tchunk, mk, tiles_per_row);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  blend_forward_kernel<PACKED8, RGB_ONLY><<<num_items, kPixels, 0, st>>>(
      data, items, num_items, tchunk, partial, counters, out, num_split_items,
      mk, tiles_per_row);
  return cudaGetLastError();
}

}  // namespace

// The chunk work list of tile ranges tile_starts/ends ((num_tiles,) int32)
// over a slab of mk columns, in chunks of at most `chunk` keys, into items
// ((5, num_items) int32, blend_common.cuh), zeroing counters ((num_tiles,)
// int32). Launches one block on `stream` and returns cudaGetLastError() (0
// on success).
extern "C" int t3dgs_build_work_list(const void* tile_starts,
                                     const void* tile_ends, int num_tiles,
                                     int mk, int chunk, void* counters,
                                     void* items, int num_items,
                                     void* stream) {
  if (num_tiles <= 0 || num_items <= 0 || mk < 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(build_work(
      static_cast<const int*>(tile_starts), static_cast<const int*>(tile_ends),
      num_tiles, mk, chunk, static_cast<int*>(counters),
      static_cast<int*>(items), num_items, static_cast<cudaStream_t>(stream)));
}

// data: (8 or 16, mk) slab; tile_starts/ends: (num_tiles,) int32; items:
// (5, num_items) int32 and counters: (num_tiles,) int32 scratch for the
// work list of chunks of at most `chunk` keys, num_items and
// num_split_items its bounds (blend_cuda.py ChunkWorkList); tchunk:
// (max(num_split_items, 1), 256) and partial: (max(num_split_items, 1), 9,
// 256) f32 scratch; out: (num_tiles, 8, 256)
// f32, every element written. Launches the work list, pass A (if
// num_split_items > 0) and pass B on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 on success). packed8 requires
// rgb_only.
extern "C" int t3dgs_blend_forward(const void* data, const void* tile_starts,
                                   const void* tile_ends, int num_tiles,
                                   int chunk, void* items, int num_items,
                                   int num_split_items, void* counters,
                                   void* tchunk, void* partial, void* out,
                                   int mk, int tiles_per_row, int packed8,
                                   int rgb_only, void* stream) {
  if (num_tiles <= 0 || chunk <= 0 || num_items <= 0 ||
      num_split_items < 0 || num_split_items > num_items ||
      tiles_per_row <= 0 || mk < 0 || (packed8 && !rgb_only)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* it = static_cast<int*>(items);
  int* cn = static_cast<int*>(counters);
  cudaError_t e = build_work(static_cast<const int*>(tile_starts),
                             static_cast<const int*>(tile_ends), num_tiles,
                             mk, chunk, cn, it, num_items, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint32_t* d = static_cast<const uint32_t*>(data);
  float* tc = static_cast<float*>(tchunk);
  float* pa = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (packed8) {
    e = launch<true, true>(d, it, num_items, num_split_items, cn, tc, pa, o,
                           mk, tiles_per_row, st);
  } else if (rgb_only) {
    e = launch<false, true>(d, it, num_items, num_split_items, cn, tc, pa, o,
                            mk, tiles_per_row, st);
  } else {
    e = launch<false, false>(d, it, num_items, num_split_items, cn, tc, pa, o,
                             mk, tiles_per_row, st);
  }
  return static_cast<int>(e);
}
