// PER_PIXEL_KBUFFER sort-mode tile blend, forward (kernel K3 of the port).
//
// Replaces stopthepop_tpu/kernels/kbuffer_blend.py::blend_kbuffer_forward
// (the Pallas _fwd_kernel). Its shape is the reference's renderkBufferCUDA
// (resorted_render.cuh:17-221) and K1's (global_blend_fwd.cu):
//
//   * one block of 256 threads per 16x16 tile, one thread per pixel, each
//     warp an 8x4 block of pixels (footprint_common.cuh); pixels outside
//     the image start done and are not written;
//   * the block reads its own [start, end) range of the (tile, depth)-sorted
//     Gaussian id list and stages batches of 256 pairs in shared memory
//     through the sorted ids: xy, conic+opacity, rgb and the 9 floats of the
//     packed inverse covariance (Sigma^-1 and u = Sigma^-1 (mean - campos)),
//     76 bytes a pair, 19 KB a batch, and each pair's footprint mask: the
//     warps whose pixels it can reach; a warp skips the others;
//   * each thread computes its pixel's world-space view ray once
//     (stopthepop_common.cuh:68-74: rows 0, 1, 3 of the inverse
//     view-projection, the integer pixel coordinate) and keeps a window of
//     up to k entries (ray depth, alpha, r, g, b) in registers, sorted by
//     depth. MAX_K, a template parameter over the reference's window sizes
//     {1, 2, 4, 8, 12, 16, 20, 24}, sizes the arrays; every window loop is
//     unrolled with compile-time indices so that they stay in registers, and
//     the runtime k <= MAX_K decides when the window is full (slots past k
//     stay at +inf);
//   * per pair: power and alpha as in K1; the pair is valid where
//     power >= 0, alpha >= 1/255 and its depth along the ray
//     t = (u . d) / max(1e-5, d^T Sigma^-1 d) >= 0. A valid pair that finds
//     k entries first pops the front entry, then goes in behind every entry
//     of equal or smaller depth. A pop commits (blends its rgb and depth with
//     w = alpha T) where U = T (1 - alpha) >= 1e-4, and sets the done latch
//     where U < 1e-4; a done pixel never commits again and does no more
//     work. After the stream, the window drains front to back;
//   * the batch goes in chunks of 32 pairs, in two phases that keep a warp's
//     lanes together: each lane first marks the chunk's pairs that pass the
//     alpha tests at its pixel (a 32-bit mask), then takes its marked pairs
//     one a round, in stream order, for the ray depth, the pop and the
//     insert, with the alpha evaluated again by the same expression. A warp
//     runs as many rounds as its busiest lane has passers, not one round for
//     every pair that any lane passes; each lane meets its pairs in the same
//     order as a per-pair loop, so every output has its bits;
//   * the block leaves the stream when __syncthreads_count says that every
//     pixel is done: exact, because a done pixel's outputs are final.
//
// Outputs, written straight into the image layout: color [3, H, W] (raw; the
// background is composited by the caller), final_T [H, W], n_contrib [H, W]
// (the number of commits, not K1's position), depth_acc [H, W] (sum of
// w * ray depth).
//
// What bounds it on an H100: the (pixel, pair) evaluations, each about 11
// FP32 operations for the alpha plus one expf, and for the pairs that pass
// the alpha tests about 24 more for the ray depth; for each insert, k
// compares and k selects for each of the 5 window fields; 10 operations a
// commit. Against that, ~50 MB written at 1080p and the id list and
// per-Gaussian rows read: bound by operations. Its design against that
// bound: every staged pair is read from device memory once per tile and
// served to 256 pixels from shared memory; a warp evaluates only the pairs
// whose footprint reaches it (~38% of the (warp, pair) steps at the 1080p
// bench frame) and runs the depth and insert without divergence; the window
// never leaves registers; done pixels stop; the smallest instantiation >= k
// runs. On an H100 (PERF.md) 8x4 warps ran faster than two rows of 16, the
// box test faster than the exact one, and 4 blocks an SM faster than 2, 3
// or 5.
//
// Numerics: accurate expf, IEEE division and square root, and built with
// -fmad=false, so that each product and sum rounds as in the plain PyTorch
// version (kernels/kbuffer_blend.py) that the tests and chip_smoke.py hold it
// against, and as kernel K4 replays it.
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain C
// interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "footprint_common.cuh"

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kBlock = kTileX * kTileY;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTThreshold = 1.0e-4f;
constexpr float kDenFloor = 1.0e-5f;
// Each warp covers kWarpW x kWarpH pixels of the tile and culls staged pairs
// by their footprint (footprint_common.cuh).
constexpr int kWarpW = 8;
constexpr int kWarpH = 4;
// Resident blocks an SM asked of the compiler for windows up to 4: at
// MAX_K = 4 four blocks (64 registers, 12 B of spill stores) ran faster on an
// H100 than two (92 registers) or five (48 registers, 150 B spilled)
// (PERF.md).
constexpr int kMinBlocks = 4;

template <int MAX_K>
__global__ void __launch_bounds__(kBlock, MAX_K <= 4 ? kMinBlocks : 1)
kbuffer_blend_fwd_kernel(const int* __restrict__ point_list,
                         const int* __restrict__ starts,
                         const int* __restrict__ ends,
                         const float2* __restrict__ xy,
                         const float4* __restrict__ conic_opacity,
                         const float* __restrict__ rgb,
                         const float* __restrict__ inv9,
                         const float* __restrict__ cam,
                         float ndc_sx, float ndc_sy, int k,
                         int grid_x, int width, int height,
                         float* __restrict__ out_color,
                         float* __restrict__ out_final_t,
                         int* __restrict__ out_n_contrib,
                         float* __restrict__ out_depth) {
  __shared__ float2 s_xy[kBlock];
  __shared__ float4 s_co[kBlock];
  __shared__ float4 s_i0[kBlock];  // xx, xy, xz, yy
  __shared__ float4 s_i1[kBlock];  // yz, zz, u0, u1
  __shared__ float4 s_i2[kBlock];  // u2, r, g, b
  __shared__ unsigned char s_mask[kBlock];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int ox = (tile % grid_x) * kTileX;
  const int oy = (tile / grid_x) * kTileY;
  const int2 in_tile = footprint::pixel_in_tile<kWarpW, kWarpH>(t);
  const int px = ox + in_tile.x;
  const int py = oy + in_tile.y;
  const bool inside = px < width && py < height;
  const float pfx = static_cast<float>(px);
  const float pfy = static_cast<float>(py);

  // The pixel's view ray (ops/transforms.py::compute_view_ray).
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

  float wd[MAX_K], wa[MAX_K], wr[MAX_K], wg[MAX_K], wb[MAX_K];
#pragma unroll
  for (int i = 0; i < MAX_K; ++i) {
    wd[i] = CUDART_INF_F;
    wa[i] = 0.0f;
    wr[i] = 0.0f;
    wg[i] = 0.0f;
    wb[i] = 0.0f;
  }
  int fill = 0;
  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d_acc = 0.0f;
  int nc = 0;
  bool done = !inside;

  // Pop the front entry: commit it unless it would take T below 1e-4.
  auto pop = [&]() {
    const float a0 = wa[0];
    const float U = T * (1.0f - a0);
    if (U < kTThreshold) {
      done = true;
    } else {
      const float w = a0 * T;
      c0 = c0 + w * wr[0];
      c1 = c1 + w * wg[0];
      c2 = c2 + w * wb[0];
      d_acc = d_acc + w * wd[0];
      T = U;
      ++nc;
    }
#pragma unroll
    for (int i = 0; i + 1 < MAX_K; ++i) {
      wd[i] = wd[i + 1];
      wa[i] = wa[i + 1];
      wr[i] = wr[i + 1];
      wg[i] = wg[i + 1];
      wb[i] = wb[i + 1];
    }
    wd[MAX_K - 1] = CUDART_INF_F;
    wa[MAX_K - 1] = 0.0f;
    wr[MAX_K - 1] = 0.0f;
    wg[MAX_K - 1] = 0.0f;
    wb[MAX_K - 1] = 0.0f;
    --fill;
  };

  // Pair j's alpha at this pixel, or -1 where it fails the alpha tests.
  auto alpha_of = [&](int j) {
    const float2 m = s_xy[j];
    const float4 co = s_co[j];
    const float dx = m.x - pfx;
    const float dy = m.y - pfy;
    const float power =
        0.5f * (co.x * dx * dx + co.z * dy * dy) + co.y * dx * dy;
    if (power < 0.0f) return -1.0f;
    const float alpha = fminf(kAlphaMax, co.w * expf(-power));
    return alpha < kAlphaThreshold ? -1.0f : alpha;
  };

  for (int base = 0; base < count; base += kBlock) {
    // Barrier: the previous batch is consumed by every thread before the
    // next one overwrites shared memory.
    if (__syncthreads_count(done) == kBlock) break;
    const int kk = base + t;
    if (kk < count) {
      const int g = point_list[start + kk];
      const float* q = inv9 + 9 * static_cast<long long>(g);
      const float2 m = xy[g];
      const float4 co = conic_opacity[g];
      s_xy[t] = m;
      s_co[t] = co;
      s_i0[t] = make_float4(q[0], q[1], q[2], q[3]);
      s_i1[t] = make_float4(q[4], q[5], q[6], q[7]);
      s_i2[t] = make_float4(q[8], rgb[3 * g], rgb[3 * g + 1], rgb[3 * g + 2]);
      s_mask[t] = static_cast<unsigned char>(
          footprint::warp_mask<kWarpW, kWarpH>(
              m, co, static_cast<float>(ox), static_cast<float>(oy)));
    }
    __syncthreads();
    if (__all_sync(kFull, done)) continue;

    // Chunks of 32 pairs. Phase 1: each lane marks the pairs of the chunk
    // that pass the alpha tests at its pixel, over the pairs the warp's
    // footprint keeps. Phase 2: each lane takes its marked pairs in stream
    // order, one a round, the warp running as many rounds as its busiest
    // lane: the ray depth, the depth test, the pop and the insert, as the
    // per-pair loop made them.
    const int n = min(kBlock, count - base);
    for (int c = 0; c < n; c += 32) {
      const unsigned keep = __ballot_sync(
          kFull, c + lane < n && ((s_mask[c + lane] >> warp) & 1u));
      unsigned pass = 0u;
      if (!done) {
        for (unsigned rest = keep; rest != 0u; rest &= rest - 1u) {
          const int jj = __ffs(rest) - 1;
          if (alpha_of(c + jj) >= 0.0f) pass |= 1u << jj;
        }
      }
      while (__any_sync(kFull, pass != 0u)) {
        if (pass == 0u) continue;
        const int j = c + __ffs(pass) - 1;
        pass &= pass - 1u;
        const float alpha = alpha_of(j);
        const float4 i0 = s_i0[j];
        const float4 i1 = s_i1[j];
        const float4 i2 = s_i2[j];
        const float num = i1.z * vdx + i1.w * vdy + i2.x * vdz;
        const float den = i0.x * vdx * vdx + i0.w * vdy * vdy +
                          i1.y * vdz * vdz +
                          2.0f * (i0.y * vdx * vdy + i0.z * vdx * vdz +
                                  i1.x * vdy * vdz);
        const float depth = num / fmaxf(kDenFloor, den);
        if (!(depth >= 0.0f)) continue;
        if (fill == k) {
          pop();
          if (done) {
            pass = 0u;
            continue;
          }
        }
        // Insert behind every entry of equal or smaller depth.
        int pos = 0;
#pragma unroll
        for (int i = 0; i < MAX_K; ++i) pos += (wd[i] <= depth) ? 1 : 0;
#pragma unroll
        for (int i = MAX_K - 1; i > 0; --i) {
          if (i > pos) {
            wd[i] = wd[i - 1];
            wa[i] = wa[i - 1];
            wr[i] = wr[i - 1];
            wg[i] = wg[i - 1];
            wb[i] = wb[i - 1];
          } else if (i == pos) {
            wd[i] = depth;
            wa[i] = alpha;
            wr[i] = i2.y;
            wg[i] = i2.z;
            wb[i] = i2.w;
          }
        }
        if (pos == 0) {
          wd[0] = depth;
          wa[0] = alpha;
          wr[0] = i2.y;
          wg[0] = i2.z;
          wb[0] = i2.w;
        }
        ++fill;
      }
    }
  }

  for (int i = 0; i < k && !done && fill > 0; ++i) pop();

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

template <int MAX_K>
cudaError_t launch(const void* point_list, const void* starts,
                   const void* ends, const void* xy, const void* conic_opacity,
                   const void* rgb, const void* inv9, const void* cam,
                   float ndc_sx, float ndc_sy, int k, int num_tiles,
                   int grid_x, int width, int height, void* out_color,
                   void* out_final_t, void* out_n_contrib, void* out_depth,
                   cudaStream_t stream) {
  kbuffer_blend_fwd_kernel<MAX_K><<<num_tiles, kBlock, 0, stream>>>(
      static_cast<const int*>(point_list), static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const float2*>(xy),
      static_cast<const float4*>(conic_opacity),
      static_cast<const float*>(rgb), static_cast<const float*>(inv9),
      static_cast<const float*>(cam), ndc_sx, ndc_sy, k, grid_x, width,
      height, static_cast<float*>(out_color),
      static_cast<float*>(out_final_t), static_cast<int*>(out_n_contrib),
      static_cast<float*>(out_depth));
  return cudaGetLastError();
}

}  // namespace

// max_k: the instantiation (one of 1, 2, 4, 8, 12, 16, 20, 24), k <= max_k.
extern "C" int stp_kbuffer_blend_fwd(
    const void* point_list, const void* starts, const void* ends,
    const void* xy, const void* conic_opacity, const void* rgb,
    const void* inv9, const void* cam, float ndc_sx, float ndc_sy, int k,
    int max_k, int grid_x, int grid_y, int width, int height, void* out_color,
    void* out_final_t, void* out_n_contrib, void* out_depth, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (k < 1 || k > max_k) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STP_LAUNCH(MK)                                                       \
  case MK:                                                                   \
    return static_cast<int>(launch<MK>(                                      \
        point_list, starts, ends, xy, conic_opacity, rgb, inv9, cam, ndc_sx, \
        ndc_sy, k, num_tiles, grid_x, width, height, out_color, out_final_t, \
        out_n_contrib, out_depth, s));
  switch (max_k) {
    STP_LAUNCH(1)
    STP_LAUNCH(2)
    STP_LAUNCH(4)
    STP_LAUNCH(8)
    STP_LAUNCH(12)
    STP_LAUNCH(16)
    STP_LAUNCH(20)
    STP_LAUNCH(24)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STP_LAUNCH
}

// Instantiation max_k on this device: out[0] resident blocks per SM, out[1]
// registers a thread, out[2] local (spill) bytes a thread, out[3] shared
// bytes a block.
extern "C" int stp_kbuffer_blend_fwd_occupancy(int max_k, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
#define STP_OCC(MK)                                                          \
  case MK:                                                                   \
    err = cudaFuncGetAttributes(&attr, kbuffer_blend_fwd_kernel<MK>);        \
    if (err == cudaSuccess)                                                  \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
          out, kbuffer_blend_fwd_kernel<MK>, kBlock, 0);                     \
    break;
  switch (max_k) {
    STP_OCC(1)
    STP_OCC(2)
    STP_OCC(4)
    STP_OCC(8)
    STP_OCC(12)
    STP_OCC(16)
    STP_OCC(20)
    STP_OCC(24)
    default:
      break;
  }
#undef STP_OCC
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
