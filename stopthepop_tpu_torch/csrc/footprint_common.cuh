// Per-warp footprint culling of staged pairs, shared by the tile blends that
// stage a batch of pairs and let every pixel of the tile evaluate each of
// them: K1 (global_blend_fwd.cu), K2 (global_blend_bwd.cu) and K3
// (kbuffer_blend_fwd.cu).
//
// A block of 256 threads covers a 16x16 tile; warp w covers a WW x WH
// rectangle of it (16x2: two rows; 8x4: a block of 8 columns and 4 rows),
// lanes row-major inside the rectangle. When a batch is staged, each thread
// computes for its pair an 8-bit mask: bit w is clear only where no pixel of
// warp w's rectangle can pass the pair's alpha test, which is, in every
// tile blend of the port,
//
//   power = 0.5 (a dx^2 + c dy^2) + b dx dy,  dx = x - px,  dy = y - py,
//   alpha = min(0.99, o exp(-power)) >= 1/255   (and power >= 0),
//
// at integer pixel coordinates (px, py). Passing needs power <= ln(255 o)
// up to float rounding, so the pair can pass only inside the ellipse
// 0.5 d^T C d <= L, C = [[a, b], [b, c]], L = ln(255 o) widened by a margin
// (kLevelScale, kLevelPad) that covers the rounding of power, expf and the
// product: power's float error is at most ~12 ulp of 0.5 (a dx^2 + c dy^2),
// which is at most 1 / (1 - |b| / sqrt(ac)) times power, and the conics this
// test handles keep that factor below ~2000 (kDetGuard), so the kernels'
// power stays within 0.15% of the exact quadratic. A warp keeps the pair
// where the continuous rectangle of its pixel centres meets the ellipse's
// bounding box: half-extents sqrt(2 L Sigma_xx) and sqrt(2 L Sigma_yy),
// Sigma = C^-1, widened by 1% and 1e-3 pixel; four compares a warp. (The
// exact minimum of the quadratic over each rectangle kept ~14% fewer steps
// at the bench frame but cost more than it saved on an H100; PERF.md.)
//
// A conic that is not positive definite or close to singular (a <= 0,
// c <= 0 or ac - b^2 <= kDetGuard ac) and any non-finite value keep the pair
// at every warp; an opacity below 1/255 passes nowhere and culls it at every
// warp. A warp skips a pair whose bit is clear, with a branch uniform across
// the warp: every lane would have skipped it, so no state and no output
// changes, bit for bit. The plain mirror is
// kernels/footprint.py::warp_footprint_mask; tests/test_torch_footprint.py
// holds it against the per-pixel alpha test.

#pragma once

#include <cuda_runtime.h>

namespace footprint {

constexpr int kTile = 16;
constexpr int kWarps = kTile * kTile / 32;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kDetGuard = 1.0e-3f;
constexpr float kLevelScale = 1.02f;
constexpr float kLevelPad = 1.0e-4f;
constexpr float kExtentScale = 1.01f;
constexpr float kExtentPad = 1.0e-3f;

// Neither infinite nor NaN.
__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= 3.40282347e38f;
}

// Thread t's pixel inside the tile, for warps of WW x WH pixels.
template <int WW, int WH>
__device__ __forceinline__ int2 pixel_in_tile(int t) {
  static_assert(WW * WH == 32 && kTile % WW == 0, "a warp is 32 pixels");
  constexpr int across = kTile / WW;
  const int warp = t >> 5;
  const int lane = t & 31;
  return make_int2((warp % across) * WW + lane % WW,
                   (warp / across) * WH + lane / WW);
}

// The 8-bit mask of the warps of a tile whose pixel (0, 0) is (ox, oy) that
// can pass the pair at (m.x, m.y) with conic and opacity co.
template <int WW, int WH>
__device__ __forceinline__ unsigned warp_mask(float2 m, float4 co, float ox,
                                              float oy) {
  constexpr unsigned kAll = (1u << kWarps) - 1u;
  const float a = co.x, b = co.y, c = co.z, o = co.w;
  if (!(finite(o) && finite(m.x) && finite(m.y))) return kAll;
  if (o < kAlphaThreshold) return 0u;
  const float det = a * c - b * b;
  if (!(a > 0.0f && c > 0.0f && det > kDetGuard * (a * c))) return kAll;
  const float level =
      fmaxf(logf(255.0f * o), 0.0f) * kLevelScale + kLevelPad;
  const float hx = sqrtf(2.0f * level * c / det) * kExtentScale + kExtentPad;
  const float hy = sqrtf(2.0f * level * a / det) * kExtentScale + kExtentPad;
  if (!(finite(hx) && finite(hy))) return kAll;
  constexpr int across = kTile / WW;
  unsigned mask = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float x0 = ox + static_cast<float>((w % across) * WW);
    const float y0 = oy + static_cast<float>((w / across) * WH);
    const bool hit = x0 - m.x <= hx &&
                     (x0 + static_cast<float>(WW - 1)) - m.x >= -hx &&
                     y0 - m.y <= hy &&
                     (y0 + static_cast<float>(WH - 1)) - m.y >= -hy;
    mask |= hit ? (1u << w) : 0u;
  }
  return mask;
}

}  // namespace footprint
