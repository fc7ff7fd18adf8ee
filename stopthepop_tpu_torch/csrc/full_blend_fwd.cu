// PER_PIXEL_FULL sort-mode tile blend, forward only (kernel K7 of the port).
//
// Replaces stopthepop_tpu/kernels/full_blend.py::blend_full_forward (the
// Pallas _fwd_kernel, which evaluates a whole segment into five
// [seg_full, 128] VMEM planes, sorts them with an unstable bitonic network
// and cuts segments at seg_full). The reference sorts each pixel's tile range
// with cub::BlockRadixSort (renderSortedFullCUDA, resorted_render.cuh:
// 474-675). K7 needs neither a cap nor scratch in device memory nor a library
// sort:
//
//   * one block of 256 threads per 16x16 tile, one thread per pixel
//     (pixels row-major within the tile), K3's shape: the block stages
//     batches of 256 of its segment's pairs in shared memory through the
//     sorted ids (xy, conic+opacity and the 9 floats of the packed inverse
//     covariance, 60 bytes a pair); pixels outside the image start done;
//   * each pixel keeps a list of up to kList entries (ray depth, stream
//     position) in shared memory, sorted by (depth, position). The list is
//     entry-major, [kList][256], so that a lane's entry i lies at
//     i * 256 + lane and the warp's accesses fall in distinct banks whatever
//     fill each lane has reached;
//   * a pass streams the whole segment. Each pixel takes its active pairs
//     (power >= 0, alpha >= 1/255, depth t = (u . d) / max(1e-5,
//     d^T Sigma^-1 d) along its view ray >= 0) above its floor (d_f, p_f) in
//     (depth, position) order. While its list has room it appends them in
//     stream order; a list that fills is sorted then by a stable insertion
//     sort on depth (ties stay in stream order), and from then on it takes
//     an entry only if its depth is below the last one's: entries of greater
//     depth move one slot up, the new entry goes behind the first entry of
//     equal or smaller depth, and the last entry drops out. A list that
//     never fills is sorted once after the segment;
//   * after the segment, the pixel blends its list front to back with the
//     log-space running sum of the JAX oracle (render/naive.py::
//     blend_prefix): alpha is derived again from the pair's rows (read
//     through point_list[start + position]) with the stream's operations in
//     the stream's order, so its bits are the stream's; S += log1p(-alpha),
//     U = exp(S); U < 1e-4 ends the pixel; otherwise w = alpha T,
//     C += w rgb, depth_acc += w depth, T = U, n_contrib += 1. A list that
//     is not full held the pixel's last actives and ends it too; otherwise
//     the floor moves to the list's last entry, whose key is above every
//     key blended so far and below every key not yet taken, and the block
//     runs another pass while any of its pixels is live
//     (__syncthreads_or). The floor is lexicographic on (depth, position):
//     exact depth ties are real (densification's clone makes bit-identical
//     Gaussians) and a depth-only floor would drop or repeat them;
//   * thread 0 adds the block's passes to one int64 counter in device
//     memory with one atomicAdd after its last pass. A pixel that
//     saturates at its k-th active needs ceil(k / kList) passes, one whose
//     A actives run out A / kList + 1; the block runs as many as its
//     slowest pixel. Nothing else reads the counter, so no output depends
//     on it.
//
// The order is the stable sort of the actives by depth, entry for entry, so
// the output equals the plain version (kernels/full_blend.py), which sorts
// with torch.sort(stable=True) and walks the sorted entries.
//
// What bounds it on an H100: the function needs each (pixel, pair) alpha once
// (about 11 FP32 operations and an expf), a ray depth for the pairs that pass
// the alpha tests (24), the sort of each pixel's actives, and a log1pf, an
// expf and about 10 operations an entry blended; bytes are the id list, the
// rows and ~50 MB of output at 1080p: bound by operations. A window in
// registers would pay an unrolled compare and shift over all its slots at
// every insert and, being short, stream the segment again for every pixel
// that holds more actives than it before saturating. The list takes 8
// bytes an entry in shared memory, so it is long enough that a tile takes
// one pass where its pixels hold at most kList actives before they
// saturate (61 commits at most on the 1080p bench frame, 1.109 passes a
// tile there), an append costs one store, and the sort after the stream
// costs the inversions of a stream that Z_DEPTH keeps close to ray-depth
// order.
// kList trades passes against resident blocks: the list takes kList * 2 KB
// of the SM's 228 KB (kMinBlocks below); 48 entries leave two blocks an SM.
// Alpha is derived again at the blend rather than stored, which would take
// 12 bytes an entry and one block an SM at 48 entries.
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
// Entries a pixel's list holds (kernels/full_blend.py::WINDOW).
constexpr int kList = 48;
constexpr size_t kListBytes = sizeof(float2) * kList * kBlock;
// The staging batch: xy, conic+opacity, two float4 and a float of the
// inverse covariance a pair.
constexpr size_t kStageBytes = kBlock * (8 + 16 + 16 + 16 + 4);
// Blocks that fit an SM's 228 KB of shared memory (1 KB of it reserved a
// block).
constexpr int kMinBlocks =
    static_cast<int>(233472 / (kListBytes + kStageBytes + 1024));
static_assert(kMinBlocks >= 1, "the list does not fit an SM");

__device__ __forceinline__ float pair_alpha(float2 m, float4 co, float pfx,
                                            float pfy, float* power) {
  const float dx = m.x - pfx;
  const float dy = m.y - pfy;
  *power = 0.5f * (co.x * dx * dx + co.z * dy * dy) + co.y * dx * dy;
  return fminf(kAlphaMax, co.w * expf(-*power));
}

// Stable insertion sort of a lane's first n entries by depth.
__device__ __forceinline__ void sort_list(float2* list, int n) {
  for (int k = 1; k < n; ++k) {
    const float2 e = list[k * kBlock];
    int i = k;
    for (; i > 0; --i) {
      const float2 prev = list[(i - 1) * kBlock];
      if (!(prev.x > e.x)) break;
      list[i * kBlock] = prev;
    }
    list[i * kBlock] = e;
  }
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
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
                      float* __restrict__ out_depth,
                      unsigned long long* __restrict__ passes) {
  __shared__ float2 s_xy[kBlock];
  __shared__ float4 s_co[kBlock];
  __shared__ float4 s_i0[kBlock];  // xx, xy, xz, yy
  __shared__ float4 s_i1[kBlock];  // yz, zz, u0, u1
  __shared__ float s_u2[kBlock];   // u2
  // [kList][kBlock] entries (depth, position bits); this lane's column.
  extern __shared__ float2 s_list[];
  float2* list = s_list + threadIdx.x;

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
  int rounds = 0;  // passes over the segment

  while (__syncthreads_or(!done)) {
    ++rounds;
    int fill = 0;
    float last_d = CUDART_INF_F;  // the last entry's depth once full
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
        float power;
        const float alpha = pair_alpha(s_xy[j], s_co[j], pfx, pfy, &power);
        if (power < 0.0f || alpha < kAlphaThreshold) continue;
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
        if (fill < kList) {
          list[fill * kBlock] = make_float2(depth, __int_as_float(pos_s));
          if (++fill == kList) {
            sort_list(list, kList);
            last_d = list[(kList - 1) * kBlock].x;
          }
          continue;
        }
        if (!(depth < last_d)) continue;
        int i = kList - 1;  // the last entry drops out
        // From the back: entries of greater depth move one slot up.
        for (; i > 0; --i) {
          const float2 prev = list[(i - 1) * kBlock];
          if (!(prev.x > depth)) break;
          list[i * kBlock] = prev;
        }
        list[i * kBlock] = make_float2(depth, __int_as_float(pos_s));
        last_d = list[(kList - 1) * kBlock].x;
      }
    }

    if (done) continue;
    if (fill < kList) sort_list(list, fill);
    // Blend the list front to back.
    for (int i = 0; i < fill; ++i) {
      const float2 e = list[i * kBlock];
      const int g = point_list[start + __float_as_int(e.y)];
      float power;
      const float alpha = pair_alpha(xy[g], conic_opacity[g], pfx, pfy, &power);
      S = S + log1pf(-alpha);
      const float U = expf(S);
      if (U < kTThreshold) {
        done = true;
        break;
      }
      const float w = alpha * T;
      c0 = c0 + w * rgb[3 * g];
      c1 = c1 + w * rgb[3 * g + 1];
      c2 = c2 + w * rgb[3 * g + 2];
      d_acc = d_acc + w * e.x;
      T = U;
      ++nc;
    }
    if (!done) {
      if (fill < kList) {
        done = true;
      } else {
        const float2 e = list[(kList - 1) * kBlock];
        floor_d = e.x;
        floor_p = __float_as_int(e.y);
      }
    }
  }

  if (t == 0) atomicAdd(passes, static_cast<unsigned long long>(rounds));

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
    void* out_n_contrib, void* out_depth, void* passes, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      full_blend_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kListBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  full_blend_fwd_kernel<<<num_tiles, kBlock, kListBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(point_list), static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const float2*>(xy),
      static_cast<const float4*>(conic_opacity),
      static_cast<const float*>(rgb), static_cast<const float*>(inv9),
      static_cast<const float*>(cam), ndc_sx, ndc_sy, grid_x, width, height,
      static_cast<float*>(out_color), static_cast<float*>(out_final_t),
      static_cast<int*>(out_n_contrib), static_cast<float*>(out_depth),
      static_cast<unsigned long long*>(passes));
  return static_cast<int>(cudaGetLastError());
}

// What K7 reaches on this device: out[0] resident blocks per SM, out[1]
// registers a thread, out[2] local (spill) bytes a thread, out[3] static and
// out[4] dynamic (the list's) shared bytes a block, out[5] the list's
// entries a pixel.
extern "C" int stp_full_blend_fwd_occupancy(int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      full_blend_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kListBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, full_blend_fwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = static_cast<int>(kListBytes);
  out[5] = kList;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, full_blend_fwd_kernel, kBlock, kListBytes));
}
