// PER_PIXEL_FULL sort-mode tile blend, forward only (kernel K7 of the port).
//
// Replaces stopthepop_tpu/kernels/full_blend.py::blend_full_forward (the
// Pallas _fwd_kernel, which evaluates a whole segment into five
// [seg_full, 128] VMEM planes, sorts them with an unstable bitonic network
// and cuts segments at seg_full). The reference sorts each pixel's tile range
// with cub::BlockRadixSort (renderSortedFullCUDA, resorted_render.cuh:
// 474-675). K7 needs neither a cap nor scratch memory nor a library sort:
//
//   * one block of 256 threads per 16x16 tile, one thread per pixel
//     (pixels row-major within the tile), K3's shape: the block stages
//     batches of 256 of its segment's pairs in shared memory through the
//     sorted ids (xy, conic+opacity and the 9 floats of the packed inverse
//     covariance, 60 bytes a pair); pixels outside the image start done;
//   * each pixel takes its active pairs (power >= 0, alpha >= 1/255, depth
//     t = (u . d) / max(1e-5, d^T Sigma^-1 d) along its view ray >= 0) in
//     rounds. A round streams the whole segment and keeps, in a register
//     window of K entries (depth, stream position, alpha) sorted by
//     (depth, position), the K smallest actives above the pixel's floor
//     (d_f, p_f) in that lexicographic order: a new entry goes behind every
//     entry of equal or smaller depth (positions only grow within a round),
//     and a full window drops its last entry, so an entry enters a full
//     window iff its depth is below the last one's;
//   * after the segment, the pixel blends its window front to back with the
//     log-space running sum of the JAX oracle (render/naive.py::
//     blend_prefix): S += log1p(-alpha), U = exp(S); U < 1e-4 ends the
//     pixel; otherwise w = alpha T, C += w rgb (rgb read through the pair's
//     id), depth_acc += w depth, T = U, n_contrib += 1. A window with fewer
//     than K entries held the pixel's last actives and ends it too;
//     otherwise the floor moves to the window's last entry, whose key is
//     above every key blended so far and below every key not yet seen;
//   * the block runs rounds while any of its pixels is live
//     (__syncthreads_or). The floor is lexicographic on (depth, position):
//     exact depth ties are real (densification's clone makes bit-identical
//     Gaussians) and a depth-only floor would drop or repeat them.
//
// The order is the stable sort of the actives by depth, entry for entry, so
// the output equals the plain version (kernels/full_blend.py), which sorts
// with torch.sort(stable=True) and walks the sorted entries.
//
// What bounds it on an H100: the function needs each (pixel, pair) alpha once
// (about 11 FP32 operations and an expf), a ray depth for the pairs that pass
// the alpha tests (24), the sort of each pixel's actives, and a log1pf, an
// expf and about 10 operations an entry blended; bytes are the id list, the
// rows and ~50 MB of output at 1080p: bound by operations. K7 repeats the
// alpha and depth of every pair in every round, so its time grows with the
// rounds its slowest pixel needs (actives / K where a pixel never
// saturates); the window of K entries keeps each round's insert at K
// compares and selects. K = 16 measured faster than 8 on the
// 1080p bench frame; every window loop is unrolled with compile-time indices
// so that the window stays in registers.
//
// Numerics: accurate expf and log1pf, IEEE division and square root, and
// built with -fmad=false, so that each product and sum rounds as in the plain
// version.
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain C
// interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kBlock = kTileX * kTileY;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTThreshold = 1.0e-4f;
constexpr float kDenFloor = 1.0e-5f;
constexpr int K = 16;  // the register window, kernels/full_blend.py::WINDOW

__global__ void __launch_bounds__(kBlock)
full_blend_fwd_kernel(const int* __restrict__ point_list,
                      const int* __restrict__ starts,
                      const int* __restrict__ ends,
                      const float2* __restrict__ xy,
                      const float4* __restrict__ conic_opacity,
                      const float* __restrict__ rgb,
                      const float* __restrict__ inv9,
                      const float* __restrict__ cam,
                      float ndc_sx, float ndc_sy, int grid_x, int width,
                      int height, float* __restrict__ out_color,
                      float* __restrict__ out_final_t,
                      int* __restrict__ out_n_contrib,
                      float* __restrict__ out_depth) {
  __shared__ float2 s_xy[kBlock];
  __shared__ float4 s_co[kBlock];
  __shared__ float4 s_i0[kBlock];  // xx, xy, xz, yy
  __shared__ float4 s_i1[kBlock];  // yz, zz, u0, u1
  __shared__ float s_u2[kBlock];   // u2

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int px = (tile % grid_x) * kTileX + t % kTileX;
  const int py = (tile / grid_x) * kTileY + t / kTileX;
  const bool inside = px < width && py < height;
  const float pfx = static_cast<float>(px);
  const float pfy = static_cast<float>(py);

  // The pixel's view ray (ops/transforms.py::compute_view_ray), as in K3.
  const float ndc_x = pfx * ndc_sx - 1.0f;
  const float ndc_y = pfy * ndc_sy - 1.0f;
  float p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = ndc_x * cam[j] + ndc_y * cam[4 + j] + cam[12 + j];
  }
  const float rx = p[0] / p[3] - cam[16];
  const float ry = p[1] / p[3] - cam[17];
  const float rz = p[2] / p[3] - cam[18];
  const float norm = sqrtf(rx * rx + ry * ry + rz * rz);
  const float vdx = rx / norm;
  const float vdy = ry / norm;
  const float vdz = rz / norm;

  const int start = starts[tile];
  const int count = ends[tile] - start;

  float S = 0.0f;
  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d_acc = 0.0f;
  int nc = 0;
  bool done = !inside;
  float floor_d = -CUDART_INF_F;
  int floor_p = -1;
  float wd[K], wa[K];
  int wp[K];

  while (__syncthreads_or(!done)) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      wd[i] = CUDART_INF_F;
      wa[i] = 0.0f;
      wp[i] = 0;
    }
    int fill = 0;
    for (int base = 0; base < count; base += kBlock) {
      // Barrier: the previous batch is consumed by every thread before the
      // next one overwrites shared memory.
      __syncthreads();
      const int kk = base + t;
      if (kk < count) {
        const int g = point_list[start + kk];
        const float* q = inv9 + 9 * static_cast<long long>(g);
        s_xy[t] = xy[g];
        s_co[t] = conic_opacity[g];
        s_i0[t] = make_float4(q[0], q[1], q[2], q[3]);
        s_i1[t] = make_float4(q[4], q[5], q[6], q[7]);
        s_u2[t] = q[8];
      }
      __syncthreads();
      if (done) continue;

      const int n = min(kBlock, count - base);
      for (int j = 0; j < n; ++j) {
        const float2 m = s_xy[j];
        const float4 co = s_co[j];
        const float dx = m.x - pfx;
        const float dy = m.y - pfy;
        const float power =
            0.5f * (co.x * dx * dx + co.z * dy * dy) + co.y * dx * dy;
        if (power < 0.0f) continue;
        const float alpha = fminf(kAlphaMax, co.w * expf(-power));
        if (alpha < kAlphaThreshold) continue;
        const float4 i0 = s_i0[j];
        const float4 i1 = s_i1[j];
        const float num = i1.z * vdx + i1.w * vdy + s_u2[j] * vdz;
        const float den = i0.x * vdx * vdx + i0.w * vdy * vdy +
                          i1.y * vdz * vdz +
                          2.0f * (i0.y * vdx * vdy + i0.z * vdx * vdz +
                                  i1.x * vdy * vdz);
        const float depth = num / fmaxf(kDenFloor, den);
        if (!(depth >= 0.0f)) continue;
        const int pos_s = base + j;
        // Above the floor, (depth, position) lexicographically.
        if (!(depth > floor_d || (depth == floor_d && pos_s > floor_p)))
          continue;
        if (fill == K && !(depth < wd[K - 1])) continue;
        // Insert behind every entry of equal or smaller depth; a full
        // window drops its last entry.
        int pos = 0;
#pragma unroll
        for (int i = 0; i < K; ++i) pos += (wd[i] <= depth) ? 1 : 0;
#pragma unroll
        for (int i = K - 1; i > 0; --i) {
          if (i > pos) {
            wd[i] = wd[i - 1];
            wa[i] = wa[i - 1];
            wp[i] = wp[i - 1];
          } else if (i == pos) {
            wd[i] = depth;
            wa[i] = alpha;
            wp[i] = pos_s;
          }
        }
        if (pos == 0) {
          wd[0] = depth;
          wa[0] = alpha;
          wp[0] = pos_s;
        }
        if (fill < K) ++fill;
      }
    }

    if (done) continue;
    // Blend the window front to back.
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (done || i >= fill) break;
      S = S + log1pf(-wa[i]);
      const float U = expf(S);
      if (U < kTThreshold) {
        done = true;
      } else {
        const int g = point_list[start + wp[i]];
        const float w = wa[i] * T;
        c0 = c0 + w * rgb[3 * g];
        c1 = c1 + w * rgb[3 * g + 1];
        c2 = c2 + w * rgb[3 * g + 2];
        d_acc = d_acc + w * wd[i];
        T = U;
        ++nc;
      }
    }
    if (!done) {
      if (fill < K) {
        done = true;
      } else {
        floor_d = wd[K - 1];
        floor_p = wp[K - 1];
      }
    }
  }

  if (inside) {
    const int pix = py * width + px;
    const int plane = width * height;
    out_color[pix] = c0;
    out_color[plane + pix] = c1;
    out_color[2 * plane + pix] = c2;
    out_final_t[pix] = T;
    out_n_contrib[pix] = nc;
    out_depth[pix] = d_acc;
  }
}

}  // namespace

extern "C" int stp_full_blend_fwd(
    const void* point_list, const void* starts, const void* ends,
    const void* xy, const void* conic_opacity, const void* rgb,
    const void* inv9, const void* cam, float ndc_sx, float ndc_sy, int grid_x,
    int grid_y, int width, int height, void* out_color, void* out_final_t,
    void* out_n_contrib, void* out_depth, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles == 0) return 0;
  full_blend_fwd_kernel<<<num_tiles, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(point_list), static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const float2*>(xy),
      static_cast<const float4*>(conic_opacity),
      static_cast<const float*>(rgb), static_cast<const float*>(inv9),
      static_cast<const float*>(cam), ndc_sx, ndc_sy, grid_x, width, height,
      static_cast<float*>(out_color), static_cast<float*>(out_final_t),
      static_cast<int*>(out_n_contrib), static_cast<float*>(out_depth));
  return static_cast<int>(cudaGetLastError());
}
