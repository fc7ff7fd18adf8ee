// HIERARCHICAL sort-mode tile blend, backward (kernel K6 of the port).
//
// Replaces stopthepop_tpu/kernels/hier_blend.py::blend_hier_backward (the
// Pallas _bwd_kernel; the batched cascade where built from
// hier_blend_bwd_batched.cu). It computes what that kernel
// computes — one replay of K5's cascade per pixel from the saved forward
// output, each committed head pop's gradient sent to the pair that sourced
// it — with no atomics:
//
//   * one block of 256 threads per 16x16 tile runs the cascade of
//     hier_common.cuh, K5's own replay (built with -fmad=false, so every pop
//     falls as in the forward). Its payload is each entry's position src in
//     the tile's segment, whose Gaussian id point_list[start + src] is
//     looked up where an entry's rows are read (a Gaussian appears at most
//     once in a tile's stream);
//   * per pixel: the colour and final-T cotangents g (3), g_T and the saved
//     raw colour and final_T give S_tot = colour . g and K_T = g_T T_final
//     (the background stays outside, render/pipeline.py, so autograd has
//     folded g . bg into g_T);
//   * at each commit of a0 > 0 (a head pop where U = T (1 - a0) >= 1e-4),
//     the algebra of K4:
//       w      = a0 T
//       acc    = acc + w (c.g)
//       galpha = a0 < 0.99 ? (c.g) T - (S_tot - acc + K_T) / (1 - a0) : 0
//       dpower = -a0 galpha
//     d(x, y, a, b, c) from dpower and the source pair's xy and conic,
//     d_opacity = galpha a0 / o, d_rgb = w g;
//   * a commit of a0 = 0 changes neither T nor any sum: it is neither
//     counted nor routed. A pixel's replay ends once it has made n_contrib
//     commits (K5's n_contrib counts the same); a pixel whose replay has
//     ended, or that lies outside the image, skips its head work, and a quad
//     whose 4 pixels have ended its mid work, but every thread keeps ranking
//     tail entries for its sub-tile and takes part in every barrier and
//     warp step until the whole block is done (__syncthreads_and);
//   * the grouped routing of route_common.cuh, which K4 shares: per-(tile,
//     warp) rows of every pair of the segment in a 320-byte-a-pair scratch
//     in device memory; at each step's end the lanes that commit the same
//     pair sum their terms in ascending lane order and add the sum into the
//     pair's row once; after the replay each pair's 8 warp rows are added in
//     warp order into d_pair[start + src] of the block's plane. Every order
//     is fixed, so two runs give the same bits.
//
// Output: d_pair [S, N, 9] float32 in sorted-slot order, columns
// (d_x, d_y, d_a, d_b, d_c, d_opacity, d_r, d_g, d_b). No gradient flows to
// the inverse covariances, the camera or the culling thresholds: they only
// choose the order and the validity. With a 32x16 binning tile (S = 2) the
// two 16x16 blocks of a binning tile replay the same segment; block b takes
// plane sub_tile[b] of d_pair and of the scratch. Without sub_tile S = 1.
//
// What bounds it on an H100: operations, as K5 (the replay: tail keys, the
// per-quad mid keys and inserts, the per-pixel evaluations and head
// inserts) plus about 45 FP32 operations a commit (the alpha gradient with
// its divide, the nine terms and their sums). Its design against that
// bound: K5's (one replay, three blocks an SM at the default sizes), a
// pixel stops at its last commit and the block once every pixel has; the
// routing costs a ballot a step and one add into the scratch per distinct
// committed pair.
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain C
// interface, loaded with ctypes.

#include "hier_common.cuh"

// The cadence this library is built for. hier_blend_bwd_batched.cu defines
// STP_HIER_BATCHED and includes this file, so that the batched
// instantiations compile in an nvcc process of their own, beside these.
#ifdef STP_HIER_BATCHED
#define STP_ENTRY(suffix) stp_hier_blend_bwd_batched##suffix
constexpr bool kBatched = true;
#else
#define STP_ENTRY(suffix) stp_hier_blend_bwd##suffix
constexpr bool kBatched = false;
#endif
#include "route_common.cuh"

namespace {

using namespace hier;
using route::kCols;
using route::kFeat;
using route::kPairFloats;
using route::kWarps;

static_assert(route::kBlock == kBlock, "one thread a pixel of the tile");

// The gradient at each commit, and its routing at each step's end.
struct Grad {
  static constexpr bool kByPosition = true;
  const float* __restrict__ rgb;
  const float4* feat;   // the segment's features, by src
  route::Router router;
  float pfx, pfy, g0, g1, g2, s_tot, k_t;
  int n_target;
  float acc_g = 0.0f;
  int nc = 0;

  // A commit of a0 = 0 changes nothing (w = 0, T stays, every term is +-0,
  // which leaves a sum that starts at +0 as it is): not counted, not routed.
  __device__ __forceinline__ bool commit(float a0, float T, float, int gid,
                                         int src) {
    if (!(a0 > 0.0f)) return false;
    const float* col = rgb + 3 * static_cast<long long>(gid);
    const float cg = __ldg(col) * g0 + __ldg(col + 1) * g1 + __ldg(col + 2) * g2;
    const float w = a0 * T;
    acc_g = acc_g + w * cg;
    const float galpha =
        a0 < kAlphaMax ? cg * T - (s_tot - acc_g + k_t) / (1.0f - a0) : 0.0f;
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
    return ++nc == n_target;
  }

  __device__ __forceinline__ void step_end() { router.step_end(); }
};

// The batched cascade at one block an SM: at two, the default sizes spill
// (PERF.md).
template <int MID_MAX, int HEAD_MAX, bool BATCHED>
__global__ void __launch_bounds__(
    kBlock, (BATCHED ? 1 : min_blocks<MID_MAX, HEAD_MAX, false>()))
hier_blend_bwd_kernel(Args a, const float* __restrict__ color,
                      const float* __restrict__ final_t,
                      const int* __restrict__ n_contrib,
                      const float* __restrict__ grad_color,
                      const float* __restrict__ grad_final_t,
                      const int* __restrict__ sub_tile, int num_pairs,
                      float* __restrict__ scratch,
                      float* __restrict__ d_pair) {
  __shared__ Smem<true> sh;
  __shared__ float s_stage[kWarps][32 * kCols];
  extern __shared__ float s_tail[];
  const Pixel p(a.grid_x, a.width, a.height);
  const int tile = blockIdx.x;
  const int start = a.starts[tile];
  const int count = a.ends[tile] - start;
  // The segment's first row in the block's plane.
  const long long row0 =
      (sub_tile == nullptr ? 0LL
                           : static_cast<long long>(sub_tile[tile]) * num_pairs) +
      start;

  const int t = threadIdx.x;
  // The segment's rows: features [count][kFeat], then the per-warp sums
  // [kWarps][count][kCols].
  float* rows = scratch + row0 * kPairFloats;
  float4* feat = reinterpret_cast<float4*>(rows);
  float* acc = rows + count * kFeat;
  for (int i = t; i < kWarps * count * kCols; i += kBlock) acc[i] = 0.0f;
  for (int i = t; i < count; i += kBlock) {
    const int g = a.point_list[start + i];
    const float2 m = a.xy[g];
    feat[2 * i] = make_float4(m.x, m.y, 0.0f, 0.0f);
    feat[2 * i + 1] = a.conic_opacity[g];
  }

  // The cotangent terms and n_target stay 0 outside the image.
  Grad hook{a.rgb, feat,
            {acc + p.warp * count * kCols, s_stage[p.warp], p.lane},
            static_cast<float>(p.px), static_cast<float>(p.py)};
  if (p.inside) {
    const int pix = p.py * a.width + p.px;
    const int plane = a.width * a.height;
    hook.g0 = grad_color[pix];
    hook.g1 = grad_color[plane + pix];
    hook.g2 = grad_color[2 * plane + pix];
    hook.s_tot = color[pix] * hook.g0 + color[plane + pix] * hook.g1 +
                 color[2 * plane + pix] * hook.g2;
    hook.k_t = grad_final_t[pix] * final_t[pix];
    hook.n_target = n_contrib[pix];
  }
  // Outside pixels have n_target 0 too. The replay's first barrier comes
  // before its first routing: the rows are zeroed and the features written.
  replay<MID_MAX, HEAD_MAX, BATCHED>(a, p, sh, s_tail, hook,
                                     hook.n_target == 0);

  __syncthreads();
  for (int idx = t; idx < count * kCols; idx += kBlock) {
    float sum = acc[idx];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = sum + acc[w * count * kCols + idx];
    d_pair[row0 * kCols + idx] = sum;
  }
}

template <int MID_MAX, int HEAD_MAX, bool BATCHED>
cudaError_t launch(const Args& a, int num_tiles, const void* color,
                   const void* final_t, const void* n_contrib,
                   const void* grad_color, const void* grad_final_t,
                   const void* sub_tile, int num_pairs, void* scratch,
                   void* d_pair, cudaStream_t stream) {
  cudaError_t err =
      set_tail(hier_blend_bwd_kernel<MID_MAX, HEAD_MAX, BATCHED>, a.kt);
  if (err != cudaSuccess) return err;
  hier_blend_bwd_kernel<MID_MAX, HEAD_MAX, BATCHED>
      <<<num_tiles, kBlock, tail_bytes(a.kt), stream>>>(
          a, static_cast<const float*>(color),
          static_cast<const float*>(final_t),
          static_cast<const int*>(n_contrib),
          static_cast<const float*>(grad_color),
          static_cast<const float*>(grad_final_t),
          static_cast<const int*>(sub_tile), num_pairs,
          static_cast<float*>(scratch), static_cast<float*>(d_pair));
  return cudaGetLastError();
}

#define STP_INSTANCES(X) \
  X(8, 4) X(8, 8) X(8, 16) X(12, 4) X(12, 8) X(12, 16) X(20, 4) X(20, 8) \
  X(20, 16)

// mid_max / head_max: the instantiation (mid in 8, 12, 20; head in 4, 8, 16),
// km <= mid_max, kh <= head_max; kt in 1..512. sub_tile: [grid_x * grid_y]
// int32, each blend tile's plane, or null for one plane; num_pairs: N, the
// rows of a plane. scratch: [S, N, 80] float32, one row of features and
// per-warp sums a pair (written before it is read; no initial value
// needed); d_pair: [S, N, 9].
int run(const void* point_list, const void* starts, const void* ends,
        const void* xy, const void* conic_opacity, const void* rgb,
        const void* inv9, const void* power_thr, const void* cam, float ndc_sx,
        float ndc_sy, int kt, int km, int kh, int mid_max, int head_max,
        int culling, const void* color, const void* final_t,
        const void* n_contrib, const void* grad_color,
        const void* grad_final_t, int grid_x, int grid_y, int width,
        int height, const void* sub_tile, int num_pairs, void* scratch,
        void* d_pair, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (kt < 1 || kt > kTailMax || km < 1 || km > mid_max || kh < 1 ||
      kh > head_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return 0;
  const Args a{static_cast<const int*>(point_list),
               static_cast<const int*>(starts),
               static_cast<const int*>(ends),
               static_cast<const float2*>(xy),
               static_cast<const float4*>(conic_opacity),
               static_cast<const float*>(rgb),
               static_cast<const float*>(inv9),
               static_cast<const float*>(power_thr),
               static_cast<const float*>(cam),
               ndc_sx, ndc_sy, kt, km, kh, culling, grid_x, width, height};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define STP_LAUNCH(M, H)                                                    \
  if (mid_max == M && head_max == H)                                        \
    return static_cast<int>(launch<M, H, kBatched>(                         \
        a, num_tiles, color, final_t, n_contrib, grad_color, grad_final_t,  \
        sub_tile, num_pairs, scratch, d_pair, st));
  STP_INSTANCES(STP_LAUNCH)
#undef STP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instantiation (mid_max, head_max) at tail size kt on this device:
// out[0] resident blocks per SM, out[1] registers a thread, out[2] local
// (spill) bytes a thread, out[3] shared bytes a block.
int query(int kt, int mid_max, int head_max, int* out) {
#define STP_OCC(M, H)                                              \
  if (mid_max == M && head_max == H)                               \
    return static_cast<int>(                                       \
        occupancy(hier_blend_bwd_kernel<M, H, kBatched>, kt, out));
  STP_INSTANCES(STP_OCC)
#undef STP_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K6 with the per-entry cascade (stp_hier_blend_bwd), or, built from
// hier_blend_bwd_batched.cu, with the batched one
// (stp_hier_blend_bwd_batched, the same interface).
extern "C" int STP_ENTRY()(
    const void* point_list, const void* starts, const void* ends,
    const void* xy, const void* conic_opacity, const void* rgb,
    const void* inv9, const void* power_thr, const void* cam, float ndc_sx,
    float ndc_sy, int kt, int km, int kh, int mid_max, int head_max,
    int culling, const void* color, const void* final_t,
    const void* n_contrib, const void* grad_color, const void* grad_final_t,
    int grid_x, int grid_y, int width, int height, const void* sub_tile,
    int num_pairs, void* scratch, void* d_pair, void* stream) {
  return run(point_list, starts, ends, xy, conic_opacity, rgb, inv9, power_thr,
             cam, ndc_sx, ndc_sy, kt, km, kh, mid_max, head_max, culling,
             color, final_t, n_contrib, grad_color, grad_final_t, grid_x,
             grid_y, width, height, sub_tile, num_pairs, scratch, d_pair,
             stream);
}

extern "C" int STP_ENTRY(_occupancy)(int kt, int mid_max, int head_max,
                                      int* out) {
  return query(kt, mid_max, head_max, out);
}
