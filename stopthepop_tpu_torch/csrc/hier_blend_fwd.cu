// HIERARCHICAL sort-mode tile blend, forward (kernel K5 of the port).
//
// Replaces stopthepop_tpu/kernels/hier_blend.py::blend_hier_forward (the
// Pallas _fwd_kernel). Semantics: JAX render/naive.py::
// render_hierarchical_naive with batched_cascade=False (True where built
// from hier_blend_fwd_batched.cu), restated in
// stopthepop_tpu_torch/kernels/hier_blend.py. One block of 256
// threads per 16x16 tile runs the cascade of hier_common.cuh (the staging,
// the tail, the mid keys computed once a quad, the mid and head windows and
// the drain), which K6 replays. K5's hook is the blend: a commit
// adds w = a T times the entry's rgb (fetched by its Gaussian id) to the
// colour and w times its head depth to depth_acc, and counts the commits of
// a > 0. Pixels outside the image start done and are not written.
//
// Outputs, written straight into the image layout: color [3, H, W] (raw; the
// background is composited by the caller), final_T [H, W], n_contrib
// [H, W] (commits with alpha > 0), depth_acc [H, W] (sum of w * head depth).
//
// What bounds it on an H100: operations. Per (stream position, sub-tile) a
// key (a ray depth, 24 operations); per (emitted entry, quad) the quad-center
// ray depth and a mid insert; per (mid pop, pixel) the head ray depth and an
// alpha (~35) and a head insert; 10 a commit. Against that, the id list and
// ~68 bytes of rows a Gaussian are read and ~50 MB written at 1080p. The
// tail merge (64 + kt compares per entry over 16 threads, and a binary
// search) sits on top of the bound. Its design against the bound: the
// stream is read once per tile, the tail never leaves shared memory; each
// quad computes its mid keys once, in a pass whose row loads overlap; an
// entry's head depth and alpha are computed when it reaches the head; the
// windows stay in registers, with a full window's pop and insert in one
// pass, so that three blocks (24 warps) fit on an SM at the default sizes;
// done pixels and quads skip their work, and a finished tile stops.
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a and
// -fmad=false (each product and sum rounds as in the plain version); plain C
// interface, loaded with ctypes.

#include "hier_common.cuh"

// The cadence this library is built for. hier_blend_fwd_batched.cu defines
// STP_HIER_BATCHED and includes this file, so that the batched
// instantiations compile in an nvcc process of their own, beside these.
#ifdef STP_HIER_BATCHED
#define STP_ENTRY(suffix) stp_hier_blend_fwd_batched##suffix
constexpr bool kBatched = true;
#else
#define STP_ENTRY(suffix) stp_hier_blend_fwd##suffix
constexpr bool kBatched = false;
#endif

namespace {

using namespace hier;

// The blend at each commit.
struct Blend {
  static constexpr bool kByPosition = false;
  const float* __restrict__ rgb;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d_acc = 0.0f;
  int nc = 0;

  __device__ __forceinline__ bool commit(float a0, float T, float d_head,
                                         int gid, int) {
    const float w = a0 * T;
    const float* col = rgb + 3 * static_cast<long long>(gid);
    c0 = c0 + w * __ldg(col);
    c1 = c1 + w * __ldg(col + 1);
    c2 = c2 + w * __ldg(col + 2);
    d_acc = d_acc + w * d_head;
    nc += (a0 > 0.0f) ? 1 : 0;
    return false;
  }
  __device__ __forceinline__ void step_end() {}
};

template <int MID_MAX, int HEAD_MAX, bool BATCHED>
__global__ void __launch_bounds__(kBlock,
                                  (min_blocks<MID_MAX, HEAD_MAX, BATCHED>()))
hier_blend_fwd_kernel(Args a, float* __restrict__ out_color,
                      float* __restrict__ out_final_t,
                      int* __restrict__ out_n_contrib,
                      float* __restrict__ out_depth) {
  __shared__ Smem<false> sh;
  extern __shared__ float s_tail[];
  const Pixel p(a.grid_x, a.width, a.height);
  Blend hook{a.rgb};
  const float T =
      replay<MID_MAX, HEAD_MAX, BATCHED>(a, p, sh, s_tail, hook, !p.inside);
  if (p.inside) {
    const int pix = p.py * a.width + p.px;
    const int plane = a.width * a.height;
    out_color[pix] = hook.c0;
    out_color[plane + pix] = hook.c1;
    out_color[2 * plane + pix] = hook.c2;
    out_final_t[pix] = T;
    out_n_contrib[pix] = hook.nc;
    out_depth[pix] = hook.d_acc;
  }
}

template <int MID_MAX, int HEAD_MAX, bool BATCHED>
cudaError_t launch(const Args& a, int num_tiles, void* out_color,
                   void* out_final_t, void* out_n_contrib, void* out_depth,
                   cudaStream_t stream) {
  cudaError_t err =
      set_tail(hier_blend_fwd_kernel<MID_MAX, HEAD_MAX, BATCHED>, a.kt);
  if (err != cudaSuccess) return err;
  hier_blend_fwd_kernel<MID_MAX, HEAD_MAX, BATCHED>
      <<<num_tiles, kBlock, tail_bytes(a.kt), stream>>>(
          a, static_cast<float*>(out_color), static_cast<float*>(out_final_t),
          static_cast<int*>(out_n_contrib), static_cast<float*>(out_depth));
  return cudaGetLastError();
}

#define STP_INSTANCES(X) \
  X(8, 4) X(8, 8) X(8, 16) X(12, 4) X(12, 8) X(12, 16) X(20, 4) X(20, 8) \
  X(20, 16)

// mid_max / head_max: the instantiation (mid in 8, 12, 20; head in 4, 8, 16),
// km <= mid_max, kh <= head_max; kt in 1..512.
int run(const void* point_list, const void* starts, const void* ends,
        const void* xy, const void* conic_opacity, const void* rgb,
        const void* inv9, const void* power_thr, const void* cam, float ndc_sx,
        float ndc_sy, int kt, int km, int kh, int mid_max, int head_max,
        int culling, int grid_x, int grid_y, int width, int height,
        void* out_color, void* out_final_t, void* out_n_contrib,
        void* out_depth, void* stream) {
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
#define STP_LAUNCH(M, H)                                                   \
  if (mid_max == M && head_max == H)                                       \
    return static_cast<int>(launch<M, H, kBatched>(                        \
        a, num_tiles, out_color, out_final_t, out_n_contrib, out_depth,    \
        st));
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
        occupancy(hier_blend_fwd_kernel<M, H, kBatched>, kt, out));
  STP_INSTANCES(STP_OCC)
#undef STP_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K5 with the per-entry cascade (stp_hier_blend_fwd), or, built from
// hier_blend_fwd_batched.cu, with the batched one
// (stp_hier_blend_fwd_batched, the same interface).
extern "C" int STP_ENTRY()(
    const void* point_list, const void* starts, const void* ends,
    const void* xy, const void* conic_opacity, const void* rgb,
    const void* inv9, const void* power_thr, const void* cam, float ndc_sx,
    float ndc_sy, int kt, int km, int kh, int mid_max, int head_max,
    int culling, int grid_x, int grid_y, int width, int height,
    void* out_color, void* out_final_t, void* out_n_contrib, void* out_depth,
    void* stream) {
  return run(point_list, starts, ends, xy, conic_opacity, rgb, inv9, power_thr,
             cam, ndc_sx, ndc_sy, kt, km, kh, mid_max, head_max, culling,
             grid_x, grid_y, width, height, out_color, out_final_t,
             out_n_contrib, out_depth, stream);
}

extern "C" int STP_ENTRY(_occupancy)(int kt, int mid_max, int head_max,
                                      int* out) {
  return query(kt, mid_max, head_max, out);
}
