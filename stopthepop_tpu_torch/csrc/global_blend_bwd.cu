// GLOBAL sort-mode tile blend, backward (kernel K2 of the port).
//
// Replaces stopthepop_tpu/kernels/global_blend.py::blend_global_backward (the
// Pallas _bwd_kernel). It computes what that kernel computes — one
// front-to-back replay of each tile's sorted pair segment that uses the saved
// forward output, per-pair gradients written into each pair's own slot, no
// atomics — in the shape of K1 (global_blend_fwd.cu):
//
//   * one block of 256 threads per 16x16 tile, one thread per pixel, each
//     warp an 8x4 block of pixels (footprint_common.cuh); pixels outside the
//     image take no part;
//   * per pixel: the colour and final-T cotangents g (3), g_T and the saved
//     raw colour and final_T give S_tot = colour . g and KT = g_T T_final;
//   * the block stages batches of 256 Gaussians in shared memory through the
//     sorted ids and replays them exactly as K1 blended them (same expf, same
//     operation order, built with -fmad=false), so every skip and the "stop
//     before T < 1e-4" decision fall as in the forward. Per blended pair:
//       w      = alpha T_before
//       prefix = prefix + w (rgb . g)
//       galpha = (rgb . g) T_before - (S_tot - prefix + KT) / (1 - alpha)
//     gated to 0 where the 0.99 clamp was active; dpower = -alpha galpha;
//     d(x, y, a, b, c) from dpower, d_opacity = galpha alpha / o and
//     d_rgb = w g (Pallas global_blend.py:355-396);
//   * a staged pair carries its footprint mask: a warp evaluates only the
//     pairs whose footprint reaches it, and stops evaluating once all its
//     lanes are done; a skipped pair adds zeros;
//   * each of the 9 per-pair values is summed over the tile's 256 pixels in
//     a fixed order: one reduce-scatter over each warp (12 shuffles for the
//     9 sums, pairing lane l with l ^ 16, l ^ 8, ..., l ^ 1 as a shuffle-down
//     tree does; skipped, as a zero, where no lane of the warp blended the
//     pair), then the 8 warp partials in warp order, from shared memory,
//     once per group of 32 pairs. The sum goes to the pair's sorted slot in
//     the block's plane of d_pair: two runs give the same bits;
//   * the replay stops at the tile's largest n_contrib (1-based position in
//     the segment of the last pair blended, as K1 writes it): no pair past it
//     has a gradient. Its rows stay as the caller allocated them (zeros).
//
// Output: d_pair [S, N, 9] float32 in sorted-slot order, columns
// (d_x, d_y, d_a, d_b, d_c, d_opacity, d_r, d_g, d_b). The blocks are K1's:
// one a blend tile, a piece of at most 16x16 pixels of a binning tile
// (render/pipeline.py::binning_pieces), its origin and extent from the
// piece table, the lanes outside it done from the start. With a binning
// tile of S pieces the S blocks of a binning tile replay the same segment,
// and block b writes plane sub_tile[b] (its index in the parent), so no two
// blocks write one row; the caller sums the planes in a fixed order.
// Without sub_tile (16x16 bins) S = 1.
//
// What bounds it on an H100: the same (pixel, pair) evaluations as K1, each
// now about 3-4x K1's FP32 operations (replay, the alpha gradient and its
// divide, the nine per-pair terms), plus the nine warp reductions per pair
// and warp: bound by operations, as K1 is. Its design against that bound:
// every staged Gaussian is read once per tile and served to 256 pixels from
// shared memory; the replay ends at the tile's last contributor; a warp
// evaluates ~38% of the (warp, pair) steps at the 1080p bench frame (its
// footprint test) and reduces only where a lane blended, in 12 shuffles in
// place of 45; one barrier per 32 pairs. On an H100 (PERF.md) 8x4 warps ran
// faster than two rows of 16 and the box test faster than the exact one.
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain C
// interface, loaded with ctypes.

#include <cuda_runtime.h>

#include "footprint_common.cuh"

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kBlock = kTileX * kTileY;
constexpr int kWarps = kBlock / 32;
constexpr int kGroup = 32;  // pairs reduced across warps per barrier
constexpr int kCols = 9;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTThreshold = 1.0e-4f;
// Each warp covers kWarpW x kWarpH pixels of the tile and culls staged pairs
// by their footprint (footprint_common.cuh). The lane order is the
// order of the warp's sums, which kernels/global_blend.py::_warp_tree_sum
// repeats.
constexpr int kWarpW = 8;
constexpr int kWarpH = 4;
// Five blocks an SM (48 registers, no spills) ran faster on an H100 than the
// four that 64 registers allow (PERF.md).
constexpr int kMinBlocks = 5;

// One step of the reduce-scatter: lanes whose bit `off` is clear keep the
// first `keep` of their n partial sums and send the rest, lanes whose bit is
// set keep the rest and send the first; each adds what its partner sent.
// The partner is lane ^ off, as in a shuffle-down tree at offset off, so
// every sum has the tree's bits (float addition commutes).
template <int N, int KEEP>
__device__ __forceinline__ void scatter_step(float (&v)[10], int off,
                                             bool upper) {
#pragma unroll
  for (int i = 0; i < KEEP; ++i) {
    const float lo = v[i];
    const float hi = i + KEEP < N ? v[i + KEEP] : 0.0f;
    const float got = __shfl_xor_sync(kFull, upper ? lo : hi, off);
    v[i] = (upper ? hi : lo) + got;
  }
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
global_blend_bwd_kernel(const int* __restrict__ point_list,
                        const int* __restrict__ starts,
                        const int* __restrict__ ends,
                        const float2* __restrict__ xy,
                        const float4* __restrict__ conic_opacity,
                        const float* __restrict__ rgb,
                        const float* __restrict__ color,
                        const float* __restrict__ final_t,
                        const int* __restrict__ n_contrib,
                        const float* __restrict__ grad_color,
                        const float* __restrict__ grad_final_t,
                        const int4* __restrict__ pieces, int width,
                        int height,
                        const int* __restrict__ sub_tile,
                        long long plane_floats,
                        float* __restrict__ d_pair) {
  __shared__ float2 s_xy[kBlock];
  __shared__ float4 s_co[kBlock];
  __shared__ float4 s_rgb[kBlock];
  __shared__ unsigned char s_mask[kBlock];
  __shared__ float s_part[kWarps][kGroup][kCols];
  __shared__ int s_last[kWarps];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int4 piece = pieces[tile];  // x0, y0, w, h
  const int ox = piece.x;
  const int oy = piece.y;
  const int2 in_tile = footprint::pixel_in_tile<kWarpW, kWarpH>(t);
  const int px = ox + in_tile.x;
  const int py = oy + in_tile.y;
  const bool inside = in_tile.x < piece.z && in_tile.y < piece.w &&
                      px < width && py < height;
  const float pfx = static_cast<float>(px);
  const float pfy = static_cast<float>(py);

  // After the reduce-scatter lane l holds column 5 b4 + 3 b3 + 2 b2 + b1
  // (b_i its bits) where that is a column of its level (< 5, < 3, < 2 ...),
  // in both lanes of each pair (b0); the lane with b0 = 0 writes it.
  const int sub3 = 2 * ((lane >> 2) & 1) + ((lane >> 1) & 1);
  const int sub5 = 3 * ((lane >> 3) & 1) + sub3;
  const int my_col = 5 * ((lane >> 4) & 1) + sub5;
  const bool writer = (lane & 1) == 0 && sub3 < 3 && sub5 < 5 && my_col < kCols;

  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, s_tot = 0.0f, kt = 0.0f;
  int nc = 0;
  if (inside) {
    const int pix = py * width + px;
    const int plane = width * height;
    g0 = grad_color[pix];
    g1 = grad_color[plane + pix];
    g2 = grad_color[2 * plane + pix];
    s_tot = color[pix] * g0 + color[plane + pix] * g1 +
            color[2 * plane + pix] * g2;
    kt = grad_final_t[pix] * final_t[pix];
    nc = n_contrib[pix];
  }

  // The tile's last contributor: a block max of n_contrib.
  const int warp_last = __reduce_max_sync(kFull, nc);
  if (lane == 0) s_last[warp] = warp_last;
  __syncthreads();
  int last = s_last[0];
  for (int w = 1; w < kWarps; ++w) last = max(last, s_last[w]);

  const int start = starts[tile];
  const int count = min(ends[tile] - start, last);
  float* __restrict__ d_out =
      sub_tile == nullptr ? d_pair : d_pair + sub_tile[tile] * plane_floats;

  float T = 1.0f;
  float prefix = 0.0f;
  bool done = !inside;

  for (int base = 0; base < count; base += kBlock) {
    // Barrier: the previous batch is consumed before it is overwritten.
    __syncthreads();
    const int k = base + t;
    if (k < count) {
      const int g = point_list[start + k];
      const float2 m = xy[g];
      const float4 co = conic_opacity[g];
      s_xy[t] = m;
      s_co[t] = co;
      s_rgb[t] = make_float4(rgb[3 * g], rgb[3 * g + 1], rgb[3 * g + 2], 0.0f);
      s_mask[t] = static_cast<unsigned char>(
          footprint::warp_mask<kWarpW, kWarpH>(
              m, co, static_cast<float>(ox), static_cast<float>(oy)));
    }
    __syncthreads();

    const int n = min(kBlock, count - base);
    for (int sub = 0; sub < n; sub += kGroup) {
      const int m = min(kGroup, n - sub);
      // The warp's partial sums start at zero: a pair that the footprint
      // culls, that no lane blends, or that comes after every lane is done
      // adds zeros.
      for (int i = lane; i < kGroup * kCols; i += 32) {
        (&s_part[warp][0][0])[i] = 0.0f;
      }
      __syncwarp();
      const unsigned keep =
          __all_sync(kFull, done)
              ? 0u
              : __ballot_sync(kFull, lane < m &&
                                         ((s_mask[sub + lane] >> warp) & 1u));
      for (unsigned rest = keep; rest != 0u; rest &= rest - 1u) {
        const int jj = __ffs(rest) - 1;
        const int j = sub + jj;
        float v[10];
#pragma unroll
        for (int c = 0; c < 10; ++c) v[c] = 0.0f;
        bool blend = false;
        if (!done) {
          const float2 mu = s_xy[j];
          const float4 co = s_co[j];
          const float dx = mu.x - pfx;
          const float dy = mu.y - pfy;
          const float power =
              0.5f * (co.x * dx * dx + co.z * dy * dy) + co.y * dx * dy;
          if (power >= 0.0f) {
            const float alpha_raw = co.w * expf(-power);
            const float alpha = fminf(kAlphaMax, alpha_raw);
            if (alpha >= kAlphaThreshold) {
              const float test_t = T * (1.0f - alpha);
              if (test_t < kTThreshold) {
                done = true;
              } else {
                blend = true;
                const float4 f = s_rgb[j];
                const float w = alpha * T;
                const float cdotg = f.x * g0 + f.y * g1 + f.z * g2;
                prefix = prefix + w * cdotg;
                float galpha =
                    cdotg * T - (s_tot - prefix + kt) / (1.0f - alpha);
                if (!(alpha_raw < kAlphaMax)) galpha = 0.0f;
                const float dpower = -alpha * galpha;
                v[0] = dpower * (co.x * dx + co.y * dy);
                v[1] = dpower * (co.z * dy + co.y * dx);
                v[2] = dpower * 0.5f * dx * dx;
                v[3] = dpower * dx * dy;
                v[4] = dpower * 0.5f * dy * dy;
                v[5] = galpha * alpha / fmaxf(co.w, 1e-12f);
                v[6] = w * g0;
                v[7] = w * g1;
                v[8] = w * g2;
                T = test_t;
              }
            }
          }
        }
        if (__any_sync(kFull, blend)) {
          // 10 padded columns to one a lane pair in 12 shuffles.
          scatter_step<10, 5>(v, 16, (lane & 16) != 0);
          scatter_step<5, 3>(v, 8, (lane & 8) != 0);
          scatter_step<3, 2>(v, 4, (lane & 4) != 0);
          scatter_step<2, 1>(v, 2, (lane & 2) != 0);
          v[0] = v[0] + __shfl_xor_sync(kFull, v[0], 1);
          if (writer) s_part[warp][jj][my_col] = v[0];
        }
      }
      __syncthreads();
      for (int idx = t; idx < m * kCols; idx += kBlock) {
        const int jj = idx / kCols;
        const int c = idx - jj * kCols;
        float s = s_part[0][jj][c];
        for (int w = 1; w < kWarps; ++w) s = s + s_part[w][jj][c];
        d_out[static_cast<long long>(start + base + sub + jj) * kCols + c] = s;
      }
      __syncthreads();
    }
  }
}

}  // namespace

// pieces: [num_pieces] int4 (x0, y0, w, h), 16-byte aligned, one block
// each; starts/ends [num_pieces], each blend tile's range (its binning
// tile's); sub_tile: [num_pieces] int32, each blend tile's plane of d_pair,
// or null for one plane; num_pairs: N, the rows of a plane; d_pair:
// [S, N, 9] float32, zeroed by the caller.
extern "C" int stp_global_blend_bwd(const void* point_list, const void* starts,
                                    const void* ends, const void* xy,
                                    const void* conic_opacity, const void* rgb,
                                    const void* color, const void* final_t,
                                    const void* n_contrib,
                                    const void* grad_color,
                                    const void* grad_final_t,
                                    const void* pieces, int num_pieces,
                                    int width, int height,
                                    const void* sub_tile, int num_pairs,
                                    void* d_pair, void* stream) {
  if (num_pieces > 0) {
    global_blend_bwd_kernel<<<num_pieces, kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(point_list), static_cast<const int*>(starts),
        static_cast<const int*>(ends), static_cast<const float2*>(xy),
        static_cast<const float4*>(conic_opacity),
        static_cast<const float*>(rgb), static_cast<const float*>(color),
        static_cast<const float*>(final_t),
        static_cast<const int*>(n_contrib),
        static_cast<const float*>(grad_color),
        static_cast<const float*>(grad_final_t),
        static_cast<const int4*>(pieces), width, height,
        static_cast<const int*>(sub_tile),
        static_cast<long long>(num_pairs) * kCols,
        static_cast<float*>(d_pair));
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 on this device: out[0] resident blocks per SM, out[1] registers a
// thread, out[2] local (spill) bytes a thread, out[3] shared bytes a block.
extern "C" int stp_global_blend_bwd_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, global_blend_bwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, global_blend_bwd_kernel, kBlock, 0));
}
