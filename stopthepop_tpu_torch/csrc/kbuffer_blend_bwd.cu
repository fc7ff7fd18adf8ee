// PER_PIXEL_KBUFFER sort-mode tile blend, backward (kernel K4 of the port).
//
// Replaces stopthepop_tpu/kernels/kbuffer_blend.py::blend_kbuffer_backward
// (the Pallas _bwd_kernel). It computes what that kernel computes — one
// replay of K3's window per pixel that uses the saved forward output, each
// committed pop's gradient sent to the pair that sourced it, no atomics — in
// the shape of K3 (kbuffer_blend_fwd.cu):
//
//   * one block of 256 threads per 16x16 tile, one thread per pixel; pixels
//     outside the image, and pixels that committed nothing, take no part;
//   * per pixel: the colour and final-T cotangents g (3), g_T and the saved
//     raw colour and final_T give S_tot = colour . g and K_T = g_T T_final;
//     n_contrib (K3's commit count) ends the pixel's replay at its last
//     commit: nothing after it has a gradient;
//   * the block replays K3 exactly (same staging, same expf and operation
//     order, built with -fmad=false), so every valid/insert/pop/commit
//     decision falls as in the forward. The window holds ray depth, alpha,
//     c.g (the pair's rgb . g) and src, the pair's position in the tile's
//     segment. At each commit (JAX kbuffer_blend.py:658-675, the algebra of
//     K2):
//       w      = a0 T
//       acc    = acc + w (c.g)
//       galpha = a0 < 0.99 ? (c.g) T - (S_tot - acc + K_T) / (1 - a0) : 0
//       dpower = -a0 galpha
//     d(x, y, a, b, c) from dpower and the source pair's xy and conic,
//     d_opacity = galpha a0 / o, d_rgb = w g;
//   * the grouped routing of route_common.cuh, which K6 shares. A lane
//     commits at most once a step (one pop for each valid arrival, one for
//     each drain iteration). At each stream or drain step's end the
//     committing lanes of a warp that name the same pair sum their 9 staged
//     terms in ascending lane order, and the group's lowest lane adds the
//     sum into the pair's row of the warp's rows in a 320-byte-a-pair
//     scratch in device memory (which also holds the pair's xy and conic for
//     the commits): one independent read-modify-write a distinct pair and
//     step. After the replay each pair's 8 warp rows are added in warp order
//     into d_pair[start + src] of the block's plane. Every slot of the tile
//     is written and every order is fixed, so two runs give the same bits.
//
// Output: d_pair [S, N, 9] float32 in sorted-slot order, columns
// (d_x, d_y, d_a, d_b, d_c, d_opacity, d_r, d_g, d_b). With a 32x16
// binning tile (S = 2) the two 16x16 blocks of a binning tile replay the
// same segment; block b takes plane sub_tile[b] of d_pair and of the
// scratch, so no two blocks share a row. Without sub_tile S = 1.
//
// What bounds it on an H100: the replay (K3's evaluations, depths, inserts
// and pops) plus about 45 FP32 operations for each commit (the alpha
// gradient with its divide, the nine terms and their sums); bound by
// operations, as K3 is. Its design against that bound: every staged pair is
// read once per tile and served to 256 pixels from shared memory, the window
// stays in registers, a pixel stops at its last commit and the block when
// every pixel has. The routing takes most of the rest: adding each
// committing lane's terms in turn would chain up to 32 dependent
// read-modify-writes a column and step; grouped, each distinct pair takes
// one, and those of different pairs overlap.
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain C
// interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "route_common.cuh"

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kBlock = kTileX * kTileY;
using route::kCols;
using route::kFeat;
using route::kPairFloats;
using route::kWarps;
static_assert(route::kBlock == kBlock, "one thread a pixel of the tile");
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTThreshold = 1.0e-4f;
constexpr float kDenFloor = 1.0e-5f;

// Four blocks an SM (64 registers a thread) ran faster on an H100 than the
// three that 70 registers allow (PERF.md).
template <int MAX_K>
__global__ void __launch_bounds__(kBlock, 4)
kbuffer_blend_bwd_kernel(const int* __restrict__ point_list,
                         const int* __restrict__ starts,
                         const int* __restrict__ ends,
                         const float2* __restrict__ xy,
                         const float4* __restrict__ conic_opacity,
                         const float* __restrict__ rgb,
                         const float* __restrict__ inv9,
                         const float* __restrict__ cam,
                         float ndc_sx, float ndc_sy, int k,
                         const float* __restrict__ color,
                         const float* __restrict__ final_t,
                         const int* __restrict__ n_contrib,
                         const float* __restrict__ grad_color,
                         const float* __restrict__ grad_final_t,
                         int grid_x, int width, int height,
                         const int* __restrict__ sub_tile, int num_pairs,
                         float* __restrict__ scratch,
                         float* __restrict__ d_pair) {
  __shared__ float2 s_xy[kBlock];
  __shared__ float4 s_co[kBlock];
  __shared__ float4 s_i0[kBlock];  // xx, xy, xz, yy
  __shared__ float4 s_i1[kBlock];  // yz, zz, u0, u1
  __shared__ float4 s_i2[kBlock];  // u2, r, g, b
  __shared__ float s_stage[kWarps][32 * kCols];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int px = (tile % grid_x) * kTileX + t % kTileX;
  const int py = (tile / grid_x) * kTileY + t / kTileX;
  const bool inside = px < width && py < height;
  const float pfx = static_cast<float>(px);
  const float pfy = static_cast<float>(py);

  const int start = starts[tile];
  const int count = ends[tile] - start;
  // The segment's first row in the block's plane.
  const long long row0 =
      (sub_tile == nullptr ? 0LL
                           : static_cast<long long>(sub_tile[tile]) * num_pairs) +
      start;

  // The segment's rows: features [count][kFeat], then the per-warp sums
  // [kWarps][count][kCols].
  float* rows = scratch + row0 * kPairFloats;
  float4* feat = reinterpret_cast<float4*>(rows);
  float* acc = rows + count * kFeat;
  for (int i = t; i < kWarps * count * kCols; i += kBlock) acc[i] = 0.0f;
  for (int s = t; s < count; s += kBlock) {
    const int g = point_list[start + s];
    const float2 m = xy[g];
    feat[2 * s] = make_float4(m.x, m.y, 0.0f, 0.0f);
    feat[2 * s + 1] = conic_opacity[g];
  }
  route::Router router{acc + warp * count * kCols, s_stage[warp], lane};

  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, s_tot = 0.0f, kt = 0.0f;
  int n_target = 0;
  if (inside) {
    const int pix = py * width + px;
    const int plane = width * height;
    g0 = grad_color[pix];
    g1 = grad_color[plane + pix];
    g2 = grad_color[2 * plane + pix];
    s_tot = color[pix] * g0 + color[plane + pix] * g1 +
            color[2 * plane + pix] * g2;
    kt = grad_final_t[pix] * final_t[pix];
    n_target = n_contrib[pix];
  }

  // The pixel's view ray, as K3 computes it.
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

  float wd[MAX_K], wa[MAX_K], wc[MAX_K];
  int ws[MAX_K];
#pragma unroll
  for (int i = 0; i < MAX_K; ++i) {
    wd[i] = CUDART_INF_F;
    wa[i] = 0.0f;
    wc[i] = 0.0f;
    ws[i] = 0;
  }
  int fill = 0;
  float T = 1.0f;
  float acc_g = 0.0f;
  int nc = 0;
  bool done = n_target == 0;  // outside pixels have n_target 0 too

  // Pop the front entry; on a commit stage its 9 gradient terms.
  auto pop = [&]() {
    const float a0 = wa[0];
    const float U = T * (1.0f - a0);
    if (U < kTThreshold) {
      done = true;
    } else {
      const float cg = wc[0];
      const int src = ws[0];
      const float w = a0 * T;
      acc_g = acc_g + w * cg;
      const float galpha =
          a0 < kAlphaMax ? cg * T - (s_tot - acc_g + kt) / (1.0f - a0) : 0.0f;
      const float4 f = feat[2 * src];
      const float4 co = feat[2 * src + 1];
      const float dx = f.x - pfx;
      const float dy = f.y - pfy;
      const float dpower = -a0 * galpha;
      float* st = router.stage();
      st[0] = dpower * (co.x * dx + co.y * dy);
      st[1] = dpower * (co.z * dy + co.y * dx);
      st[2] = dpower * 0.5f * dx * dx;
      st[3] = dpower * dx * dy;
      st[4] = dpower * 0.5f * dy * dy;
      st[5] = galpha * a0 / fmaxf(co.w, 1e-12f);
      st[6] = w * g0;
      st[7] = w * g1;
      st[8] = w * g2;
      router.staged(src);
      T = U;
      ++nc;
      if (nc == n_target) done = true;
    }
#pragma unroll
    for (int i = 0; i + 1 < MAX_K; ++i) {
      wd[i] = wd[i + 1];
      wa[i] = wa[i + 1];
      wc[i] = wc[i + 1];
      ws[i] = ws[i + 1];
    }
    wd[MAX_K - 1] = CUDART_INF_F;
    wa[MAX_K - 1] = 0.0f;
    wc[MAX_K - 1] = 0.0f;
    ws[MAX_K - 1] = 0;
    --fill;
  };

  __syncthreads();  // rows zeroed and features written
  for (int base = 0; base < count; base += kBlock) {
    // Barrier: the previous batch is consumed before it is overwritten.
    if (__syncthreads_count(done) == kBlock) break;
    const int kk = base + t;
    if (kk < count) {
      const int g = point_list[start + kk];
      const float* q = inv9 + 9 * static_cast<long long>(g);
      s_xy[t] = xy[g];
      s_co[t] = conic_opacity[g];
      s_i0[t] = make_float4(q[0], q[1], q[2], q[3]);
      s_i1[t] = make_float4(q[4], q[5], q[6], q[7]);
      s_i2[t] = make_float4(q[8], rgb[3 * g], rgb[3 * g + 1], rgb[3 * g + 2]);
    }
    __syncthreads();

    const int n = min(kBlock, count - base);
    for (int jj = 0; jj < n; ++jj) {
      if (!done) {
        const int j = base + jj;
        const float2 m = s_xy[jj];
        const float4 co = s_co[jj];
        const float dx = m.x - pfx;
        const float dy = m.y - pfy;
        const float power =
            0.5f * (co.x * dx * dx + co.z * dy * dy) + co.y * dx * dy;
        if (power >= 0.0f) {
          const float alpha = fminf(kAlphaMax, co.w * expf(-power));
          if (alpha >= kAlphaThreshold) {
            const float4 i0 = s_i0[jj];
            const float4 i1 = s_i1[jj];
            const float4 i2 = s_i2[jj];
            const float num = i1.z * vdx + i1.w * vdy + i2.x * vdz;
            const float den = i0.x * vdx * vdx + i0.w * vdy * vdy +
                              i1.y * vdz * vdz +
                              2.0f * (i0.y * vdx * vdy + i0.z * vdx * vdz +
                                      i1.x * vdy * vdz);
            const float depth = num / fmaxf(kDenFloor, den);
            if (depth >= 0.0f) {
              if (fill == k) pop();
              if (!done) {
                const float cg = i2.y * g0 + i2.z * g1 + i2.w * g2;
                int pos = 0;
#pragma unroll
                for (int i = 0; i < MAX_K; ++i) pos += (wd[i] <= depth) ? 1 : 0;
#pragma unroll
                for (int i = MAX_K - 1; i > 0; --i) {
                  if (i > pos) {
                    wd[i] = wd[i - 1];
                    wa[i] = wa[i - 1];
                    wc[i] = wc[i - 1];
                    ws[i] = ws[i - 1];
                  } else if (i == pos) {
                    wd[i] = depth;
                    wa[i] = alpha;
                    wc[i] = cg;
                    ws[i] = j;
                  }
                }
                if (pos == 0) {
                  wd[0] = depth;
                  wa[0] = alpha;
                  wc[0] = cg;
                  ws[0] = j;
                }
                ++fill;
              }
            }
          }
        }
      }
      router.step_end();
    }
  }

  for (int i = 0; i < k; ++i) {
    if (!done && fill > 0) pop();
    router.step_end();
  }

  __syncthreads();
  for (int idx = t; idx < count * kCols; idx += kBlock) {
    float sum = acc[idx];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = sum + acc[w * count * kCols + idx];
    d_pair[row0 * kCols + idx] = sum;
  }
}

template <int MAX_K>
cudaError_t launch(const void* point_list, const void* starts,
                   const void* ends, const void* xy, const void* conic_opacity,
                   const void* rgb, const void* inv9, const void* cam,
                   float ndc_sx, float ndc_sy, int k, const void* color,
                   const void* final_t, const void* n_contrib,
                   const void* grad_color, const void* grad_final_t,
                   int num_tiles, int grid_x, int width, int height,
                   const void* sub_tile, int num_pairs, void* scratch,
                   void* d_pair, cudaStream_t stream) {
  kbuffer_blend_bwd_kernel<MAX_K><<<num_tiles, kBlock, 0, stream>>>(
      static_cast<const int*>(point_list), static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const float2*>(xy),
      static_cast<const float4*>(conic_opacity),
      static_cast<const float*>(rgb), static_cast<const float*>(inv9),
      static_cast<const float*>(cam), ndc_sx, ndc_sy, k,
      static_cast<const float*>(color), static_cast<const float*>(final_t),
      static_cast<const int*>(n_contrib),
      static_cast<const float*>(grad_color),
      static_cast<const float*>(grad_final_t), grid_x, width, height,
      static_cast<const int*>(sub_tile), num_pairs,
      static_cast<float*>(scratch), static_cast<float*>(d_pair));
  return cudaGetLastError();
}

}  // namespace

// max_k: the instantiation (one of 1, 2, 4, 8, 12, 16, 20, 24), k <= max_k.
// sub_tile: [grid_x * grid_y] int32, each blend tile's plane, or null for
// one plane; num_pairs: N, the rows of a plane. scratch: [S, N, 80] float32,
// one row of features and per-warp sums a pair (written before it is read;
// no initial value needed); d_pair: [S, N, 9].
extern "C" int stp_kbuffer_blend_bwd(
    const void* point_list, const void* starts, const void* ends,
    const void* xy, const void* conic_opacity, const void* rgb,
    const void* inv9, const void* cam, float ndc_sx, float ndc_sy, int k,
    int max_k, const void* color, const void* final_t, const void* n_contrib,
    const void* grad_color, const void* grad_final_t, int grid_x, int grid_y,
    int width, int height, const void* sub_tile, int num_pairs, void* scratch,
    void* d_pair, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (k < 1 || k > max_k) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STP_LAUNCH(MK)                                                        \
  case MK:                                                                    \
    return static_cast<int>(launch<MK>(                                       \
        point_list, starts, ends, xy, conic_opacity, rgb, inv9, cam, ndc_sx,  \
        ndc_sy, k, color, final_t, n_contrib, grad_color, grad_final_t,       \
        num_tiles, grid_x, width, height, sub_tile, num_pairs, scratch,      \
        d_pair, s));
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
extern "C" int stp_kbuffer_blend_bwd_occupancy(int max_k, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
#define STP_OCC(MK)                                                          \
  case MK:                                                                   \
    err = cudaFuncGetAttributes(&attr, kbuffer_blend_bwd_kernel<MK>);        \
    if (err == cudaSuccess)                                                  \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
          out, kbuffer_blend_bwd_kernel<MK>, kBlock, 0);                     \
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
