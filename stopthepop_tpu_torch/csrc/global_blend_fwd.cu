// GLOBAL sort-mode tile blend, forward (kernel K1 of the port).
//
// Replaces stopthepop_tpu/kernels/global_blend.py::blend_global_forward (the
// Pallas _fwd_kernel). Its shape is the reference's renderCUDA
// (forward.cu:234-366), which the Pallas kernel re-architected for the TPU:
//
//   * one block of 256 threads per blend tile of at most 16x16 pixels, one
//     thread per pixel, each warp an 8x4 block of pixels
//     (footprint_common.cuh, as in K2);
//   * the block reads its own [start, end) range of the (tile, depth)-sorted
//     Gaussian id list and stages batches of 256 Gaussians in shared memory
//     (xy, conic+opacity, rgb, depth: 40 bytes each, and a one-byte
//     footprint mask: 10.25 KB a batch), reading the per-Gaussian rows
//     through the sorted ids;
//   * each thread blends the batch front to back, sequentially: per pair
//     power = 0.5 (a dx^2 + c dy^2) + b dx dy, alpha = min(0.99, o e^-power);
//     skip if power < 0 or alpha < 1/255; stop before the pair that would
//     take T below 1e-4 (forward.cu:312-335);
//   * pixels outside the image start done and are not written; the block
//     leaves its loop when __syncthreads_count says that every pixel is done.
//
// The blend tiles are the pieces of the binning tiles (render/pipeline.py::
// binning_pieces): each binning tile is cut, from its own origin, into
// pieces of at most 16x16 pixels, which are the image's 16x16 grid where
// both of its sides are multiples of 16. A block reads its piece's origin
// and extent from the piece table and its parent's range from starts/ends,
// and starts the lanes outside the piece done, as those outside the image.
// The footprint masks use the block's whole 16x16 rect: a larger rect only
// keeps more pairs, and no bit changes.
//
// Outputs, written straight into the image layout: color [3, H, W] (raw,
// the background is composited by the caller), final_T [H, W], n_contrib
// [H, W] (1-based position in the tile's segment of the last pair blended),
// depth_acc [H, W] (sum of depth * alpha * T).
//
// What bounds it on an H100: the pair-pixel evaluations, each about 11 FP32
// operations plus one expf (SFU), and 9 more for each blend; against that,
// ~50 MB written (2.07M pixels x 6 values) and the sorted id list and
// per-Gaussian rows read: bound by operations. Of the up to ~1.28M pairs x
// 256 pixels of a 1080p frame of the 500K-Gaussian bench scene, only the
// evaluations in warps that the pair's footprint can reach are needed (37.5%
// of the (warp, pair) steps). Its design against that bound:
//
//   * every staged Gaussian is read from device memory once per tile and
//     served to all 256 pixels from shared memory;
//   * the thread that stages a pair computes its 8-bit warp mask
//     (footprint::warp_mask): bit w is clear only where no pixel of warp w
//     can pass the pair's alpha test, which is this kernel's test;
//   * a warp walks each group of 32 staged pairs through a ballot of its
//     bits, popping the kept pairs in stream order with __ffs, and stops
//     walking the batch once all its lanes are done. A pair that no lane of
//     the warp can pass would only have been skipped; it changes no T,
//     colour, depth, done or last contributor, so every output keeps its
//     bits. Lanes that are done take part in every ballot and skip the
//     arithmetic;
//   * the early exit skips the rest of a tile once all its pixels are
//     saturated, off-image pixels included from the start.
//
// Numerics: accurate expf, and built with -fmad=false, so that each product
// and sum rounds as in the plain PyTorch version that the tests and
// chip_smoke.py hold it against (kernels/global_blend.py).
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain C
// interface, loaded with ctypes.

#include <cuda_runtime.h>

#include "footprint_common.cuh"

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kBlock = kTileX * kTileY;
constexpr int kGroup = 32;  // staged pairs under one ballot
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTThreshold = 1.0e-4f;
// Each warp covers kWarpW x kWarpH pixels of the tile and culls staged pairs
// by their footprint (footprint_common.cuh); kernels/global_blend.py's
// WARP_SHAPE names them.
constexpr int kWarpW = 8;
constexpr int kWarpH = 4;
// Six blocks an SM (36 registers, no spills) ran faster on an H100 than the
// five that 47 registers allow and than eight (32 registers, spills)
// (PERF.md).
constexpr int kMinBlocks = 6;

__global__ void __launch_bounds__(kBlock, kMinBlocks)
global_blend_fwd_kernel(const int* __restrict__ point_list,
                        const int* __restrict__ starts,
                        const int* __restrict__ ends,
                        const float2* __restrict__ xy,
                        const float4* __restrict__ conic_opacity,
                        const float* __restrict__ rgb,
                        const float* __restrict__ depth,
                        const int4* __restrict__ pieces, int width,
                        int height,
                        float* __restrict__ out_color,
                        float* __restrict__ out_final_t,
                        int* __restrict__ out_n_contrib,
                        float* __restrict__ out_depth) {
  __shared__ float2 s_xy[kBlock];
  __shared__ float4 s_co[kBlock];
  __shared__ float4 s_rgbd[kBlock];
  __shared__ unsigned char s_mask[kBlock];

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

  const int start = starts[tile];
  const int count = ends[tile] - start;

  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d_acc = 0.0f;
  int last_contributor = 0;
  bool done = !inside;

  for (int base = 0; base < count; base += kBlock) {
    // Barrier: the previous batch is consumed by every thread before the
    // next one overwrites shared memory.
    if (__syncthreads_count(done) == kBlock) break;
    const int k = base + t;
    if (k < count) {
      const int g = point_list[start + k];
      const float2 m = xy[g];
      const float4 co = conic_opacity[g];
      s_xy[t] = m;
      s_co[t] = co;
      s_rgbd[t] = make_float4(rgb[3 * g], rgb[3 * g + 1], rgb[3 * g + 2],
                              depth[g]);
      s_mask[t] = static_cast<unsigned char>(
          footprint::warp_mask<kWarpW, kWarpH>(
              m, co, static_cast<float>(ox), static_cast<float>(oy)));
    }
    __syncthreads();

    const int n = min(kBlock, count - base);
    for (int sub = 0; sub < n; sub += kGroup) {
      if (__all_sync(kFull, done)) break;
      const unsigned keep = __ballot_sync(
          kFull, sub + lane < n && ((s_mask[sub + lane] >> warp) & 1u));
      for (unsigned rest = keep; rest != 0u && !done; rest &= rest - 1u) {
        const int j = sub + __ffs(rest) - 1;
        const float2 m = s_xy[j];
        const float4 co = s_co[j];
        const float dx = m.x - pfx;
        const float dy = m.y - pfy;
        const float power =
            0.5f * (co.x * dx * dx + co.z * dy * dy) + co.y * dx * dy;
        if (power < 0.0f) continue;
        const float alpha = fminf(kAlphaMax, co.w * expf(-power));
        if (alpha < kAlphaThreshold) continue;
        const float test_t = T * (1.0f - alpha);
        if (test_t < kTThreshold) {
          done = true;
          continue;
        }
        const float w = alpha * T;
        const float4 f = s_rgbd[j];
        c0 = c0 + f.x * w;
        c1 = c1 + f.y * w;
        c2 = c2 + f.z * w;
        d_acc = d_acc + f.w * w;
        T = test_t;
        last_contributor = base + j + 1;
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
    out_n_contrib[pix] = last_contributor;
    out_depth[pix] = d_acc;
  }
}

}  // namespace

// One block a blend tile: pieces [num_pieces] int4 (x0, y0, w, h), 16-byte
// aligned; starts/ends [num_pieces], each blend tile's range (its binning
// tile's).
extern "C" int stp_global_blend_fwd(const void* point_list, const void* starts,
                                    const void* ends, const void* xy,
                                    const void* conic_opacity, const void* rgb,
                                    const void* depth, const void* pieces,
                                    int num_pieces, int width, int height,
                                    void* out_color, void* out_final_t,
                                    void* out_n_contrib, void* out_depth,
                                    void* stream) {
  if (num_pieces > 0) {
    global_blend_fwd_kernel<<<num_pieces, kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(point_list), static_cast<const int*>(starts),
        static_cast<const int*>(ends), static_cast<const float2*>(xy),
        static_cast<const float4*>(conic_opacity),
        static_cast<const float*>(rgb), static_cast<const float*>(depth),
        static_cast<const int4*>(pieces), width, height,
        static_cast<float*>(out_color), static_cast<float*>(out_final_t),
        static_cast<int*>(out_n_contrib), static_cast<float*>(out_depth));
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 on this device: out[0] resident blocks per SM, out[1] registers a
// thread, out[2] local (spill) bytes a thread, out[3] shared bytes a block.
extern "C" int stp_global_blend_fwd_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, global_blend_fwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, global_blend_fwd_kernel, kBlock, 0));
}
