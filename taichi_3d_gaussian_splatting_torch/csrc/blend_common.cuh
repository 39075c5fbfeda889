// Shared by the forward (blend_forward.cu) and backward (blend_backward.cu)
// per-tile blend kernels: the tile layout, the slab rows, and the one
// per-(pixel, key) alpha step whose skip / clamp / saturation decisions the
// backward's replay must reproduce exactly as the forward made them.
//
// A key at the 1/255 skip gate or the 1e-4 saturation edge that contributed
// in the forward but not in the replay (or the reverse) would get a gradient
// for a colour it never blended. Both kernels therefore call blend_alpha
// below, compiled from this one source with the same flags (no fast math,
// expf), so their decisions are bit-identical on the card.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace t3dgs {

constexpr int kTileWidth = 16;
constexpr int kTileHeight = 16;
constexpr int kPixels = kTileWidth * kTileHeight;  // threads per block
constexpr float kAlphaSkip = 1.0f / 255.0f;
constexpr float kAlphaClamp = 0.99f;
constexpr float kSaturation = 1e-4f;

// wide16 slab rows (blend_cuda.py ROW_*)
constexpr int kRowU = 0, kRowV = 1, kRowA = 2, kRowB = 3, kRowC = 4,
              kRowLogw = 5, kRowR = 8, kRowG = 9, kRowBCol = 10,
              kRowDepth = 11;

// What one key does to one pixel.
enum BlendKind { kSkip = 0, kSaturate = 1, kContribute = 2 };

struct BlendAlpha {
  float alpha_exp;  // exp(exponent), before the skip gate and the clamp
  float alpha;      // min(alpha_exp, 0.99)
  float t_next;     // T * (1 - alpha)
  int kind;         // BlendKind
};

// The alpha step of the front-to-back blend at pixel centre (px, py) for a
// key (u, v, conic a/b/c, logw) with the pixel's transmittance T so far:
// skip if alpha < 1/255; otherwise clamp at 0.99, and the key saturates the
// pixel (and does not contribute) if T (1 - alpha) < 1e-4.
__device__ __forceinline__ BlendAlpha blend_alpha(float px, float py, float u,
                                                  float v, float a, float b,
                                                  float c, float logw,
                                                  float T) {
  BlendAlpha r;
  const float dx = px - u;
  const float dy = py - v;
  r.alpha_exp = expf(-0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy + logw);
  r.alpha = fminf(r.alpha_exp, kAlphaClamp);
  r.t_next = T * (1.0f - r.alpha);
  r.kind = r.alpha_exp < kAlphaSkip
               ? kSkip
               : (r.t_next < kSaturation ? kSaturate : kContribute);
  return r;
}

// Pixel centre of thread p in tile t (p = v_in * 16 + u_in, centre + 0.5).
__device__ __forceinline__ float pixel_x(int t, int p, int tiles_per_row) {
  return static_cast<float>((t % tiles_per_row) * kTileWidth + p % kTileWidth) +
         0.5f;
}

__device__ __forceinline__ float pixel_y(int t, int p, int tiles_per_row) {
  return static_cast<float>((t / tiles_per_row) * kTileHeight +
                            p / kTileWidth) +
         0.5f;
}

}  // namespace t3dgs
