// GLOBAL sort-mode tile blend, forward (kernel K1 of the port).
//
// Replaces stopthepop_tpu/kernels/global_blend.py::blend_global_forward (the
// Pallas _fwd_kernel). Its shape is the reference's renderCUDA
// (forward.cu:234-366), which the Pallas kernel re-architected for the TPU:
//
//   * one block of 256 threads per 16x16 tile, one thread per pixel
//     (pixels row-major within the tile);
//   * the block reads its own [start, end) range of the (tile, depth)-sorted
//     Gaussian id list and stages batches of 256 Gaussians in shared memory
//     (xy, conic+opacity, rgb, depth: 40 bytes each, 10 KB a batch), reading
//     the per-Gaussian arrays through the sorted ids;
//   * each thread blends the batch front to back, sequentially: per pair
//     power = 0.5 (a dx^2 + c dy^2) + b dx dy, alpha = min(0.99, o e^-power);
//     skip if power < 0 or alpha < 1/255; stop before the pair that would
//     take T below 1e-4 (forward.cu:312-335);
//   * the block leaves its loop when __syncthreads_count says that every
//     pixel is done;
//   * pixels outside the image are computed but not written.
//
// Outputs, written straight into the image layout: color [3, H, W] (raw,
// the background is composited by the caller), final_T [H, W], n_contrib
// [H, W] (1-based position in the tile's segment of the last pair blended),
// depth_acc [H, W] (sum of depth * alpha * T).
//
// What bounds it on an H100: the pair-pixel evaluations, up to ~1.28M pairs
// x 256 pixels per 1080p frame of the 500K-Gaussian bench scene, each about
// 16 FP32 operations plus one expf (SFU), and 9 more for each blend; against
// that, ~50 MB written (2.07M pixels x 6 values) and the sorted id list and
// per-Gaussian rows read. Its design against the operation bound: every
// staged Gaussian is read from device memory once per tile and then served
// to all 256 pixels from shared memory; the early exit skips the rest of a
// tile once all its pixels are saturated.
//
// Numerics: accurate expf, and built with -fmad=false, so that each product
// and sum rounds as in the plain PyTorch version that the tests and
// chip_smoke.py hold it against (kernels/global_blend.py).
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain C
// interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kBlock = kTileX * kTileY;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTThreshold = 1.0e-4f;

__global__ void __launch_bounds__(kBlock)
global_blend_fwd_kernel(const int* __restrict__ point_list,
                        const int* __restrict__ starts,
                        const int* __restrict__ ends,
                        const float2* __restrict__ xy,
                        const float4* __restrict__ conic_opacity,
                        const float* __restrict__ rgb,
                        const float* __restrict__ depth,
                        int grid_x, int width, int height,
                        float* __restrict__ out_color,
                        float* __restrict__ out_final_t,
                        int* __restrict__ out_n_contrib,
                        float* __restrict__ out_depth) {
  __shared__ float2 s_xy[kBlock];
  __shared__ float4 s_co[kBlock];
  __shared__ float4 s_rgbd[kBlock];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int px = (tile % grid_x) * kTileX + t % kTileX;
  const int py = (tile / grid_x) * kTileY + t / kTileX;
  const bool inside = px < width && py < height;
  const float pfx = static_cast<float>(px);
  const float pfy = static_cast<float>(py);

  const int start = starts[tile];
  const int count = ends[tile] - start;

  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d_acc = 0.0f;
  int last_contributor = 0;
  bool done = false;

  for (int base = 0; base < count; base += kBlock) {
    // Barrier: the previous batch is consumed by every thread before the
    // next one overwrites shared memory.
    if (__syncthreads_count(done) == kBlock) break;
    const int k = base + t;
    if (k < count) {
      const int g = point_list[start + k];
      s_xy[t] = xy[g];
      s_co[t] = conic_opacity[g];
      s_rgbd[t] = make_float4(rgb[3 * g], rgb[3 * g + 1], rgb[3 * g + 2],
                              depth[g]);
    }
    __syncthreads();

    const int n = min(kBlock, count - base);
    for (int j = 0; !done && j < n; ++j) {
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

extern "C" int stp_global_blend_fwd(const void* point_list, const void* starts,
                                    const void* ends, const void* xy,
                                    const void* conic_opacity, const void* rgb,
                                    const void* depth, int grid_x, int grid_y,
                                    int width, int height, void* out_color,
                                    void* out_final_t, void* out_n_contrib,
                                    void* out_depth, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles > 0) {
    global_blend_fwd_kernel<<<num_tiles, kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(point_list), static_cast<const int*>(starts),
        static_cast<const int*>(ends), static_cast<const float2*>(xy),
        static_cast<const float4*>(conic_opacity),
        static_cast<const float*>(rgb), static_cast<const float*>(depth),
        grid_x, width, height, static_cast<float*>(out_color),
        static_cast<float*>(out_final_t), static_cast<int*>(out_n_contrib),
        static_cast<float*>(out_depth));
  }
  return static_cast<int>(cudaGetLastError());
}
