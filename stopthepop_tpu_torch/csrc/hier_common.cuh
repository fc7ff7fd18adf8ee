// Device code shared by the HIERARCHICAL blend kernels K5 (hier_blend_fwd.cu)
// and K6 (hier_blend_bwd.cu): the constants, the view ray, the ray depth and
// the sub-tile culling power. K6 replays K5 bit for bit, so both must run
// the same operations in the same order. Everything is __forceinline__: the
// kernels compile as if the code were written in place.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace hier {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kBlock = kTileX * kTileY;
constexpr int kSub = 16;    // 4x4 sub-tiles of a tile
constexpr int kBatch = 64;  // TAIL_BATCH
constexpr int kTailMax = 512;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTThreshold = 1.0e-4f;
constexpr float kDenFloor = 1.0e-5f;
constexpr float kPatch = 3.0f;  // the sub-tile rect's patch width

// The world-space view ray through pixel coordinate (fx, fy)
// (ops/transforms.py::compute_view_ray, as K3 computes it).
__device__ __forceinline__ void view_ray(float fx, float fy,
                                         const float* __restrict__ cam,
                                         float ndc_sx, float ndc_sy,
                                         float& vx, float& vy, float& vz) {
  const float ndc_x = fx * ndc_sx - 1.0f;
  const float ndc_y = fy * ndc_sy - 1.0f;
  float p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = ndc_x * cam[j] + ndc_y * cam[4 + j] + cam[12 + j];
  }
  const float rx = p[0] / p[3] - cam[16];
  const float ry = p[1] / p[3] - cam[17];
  const float rz = p[2] / p[3] - cam[18];
  const float norm = sqrtf(rx * rx + ry * ry + rz * rz);
  vx = rx / norm;
  vy = ry / norm;
  vz = rz / norm;
}

// Depth of the max-contribution point along a ray
// (ops/stopthepop.py::depth_along_ray). q: xx xy xz yy yz zz u0 u1 u2.
__device__ __forceinline__ float ray_depth(const float q[9], float vx,
                                           float vy, float vz) {
  const float num = q[6] * vx + q[7] * vy + q[8] * vz;
  const float den = q[0] * vx * vx + q[3] * vy * vy + q[5] * vz * vz +
                    2.0f * (q[1] * vx * vy + q[2] * vx * vz + q[4] * vy * vz);
  return num / fmaxf(kDenFloor, den);
}

// torch.clamp(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

// Smallest Gaussian power over the pixel rect [rmin, rmin + 3]^2
// (ops/stopthepop.py::max_contrib_power_rect with patch 3x3).
__device__ __forceinline__ float subtile_power(float2 m, float4 co,
                                               float rmin_x, float rmin_y) {
  const float rmax_x = rmin_x + kPatch;
  const float rmax_y = rmin_y + kPatch;
  const bool x_left = (rmin_x - m.x) > 0.0f;
  const bool y_above = (rmin_y - m.y) > 0.0f;
  const bool not_in_x = x_left || (m.x > rmax_x);
  const bool not_in_y = y_above || (m.y > rmax_y);
  if (!(not_in_x || not_in_y)) return 0.0f;
  const float px = x_left ? rmin_x : rmax_x;
  const float py = y_above ? rmin_y : rmax_y;
  const float dx = x_left ? kPatch : -kPatch;
  const float dy = y_above ? kPatch : -kPatch;
  const float diffx = m.x - px;
  const float diffy = m.y - py;
  const float tx = not_in_y ? clamp01((dx * co.x * diffx + dx * co.y * diffy) /
                                      (dx * dx * co.x))
                            : 0.0f;
  const float ty = not_in_x ? clamp01((dy * co.y * diffx + dy * co.z * diffy) /
                                      (dy * dy * co.z))
                            : 0.0f;
  const float ex = m.x - (px + tx * dx);
  const float ey = m.y - (py + ty * dy);
  return 0.5f * (co.x * ex * ex + co.z * ey * ey) + co.y * ex * ey;
}

}  // namespace hier
