// HIERARCHICAL sort-mode tile blend, forward (kernel K5 of the port).
//
// Replaces stopthepop_tpu/kernels/hier_blend.py::blend_hier_forward (the
// Pallas _fwd_kernel, per-entry cascade). Semantics: JAX
// render/naive.py::render_hierarchical_naive with batched_cascade=False,
// restated in stopthepop_tpu_torch/kernels/hier_blend.py. Shape: K1/K3's, one
// block of 256 threads per 16x16 tile, with the reference's {16, 4, 4}
// thread map (hierarchical_render.cuh:240-300): half-warp s is 4x4 sub-tile
// s (row-major in the tile), its lanes 4q..4q+3 are 2x2 quad q, lane r of a
// quad is pixel (r & 1, r >> 1). Pixels outside the image start done and are
// not written.
//
//   * Staging. Per batch of TAIL_BATCH = 64 stream positions, threads 0..63
//     stage the Gaussian id and the rows the tail reads in shared memory: xy,
//     conic+opacity, the 9 floats of the packed inverse covariance and the
//     culling threshold log(opacity / alpha threshold), 68 bytes a position.
//   * Tail, per sub-tile, in dynamic shared memory: (key, Gaussian id) for
//     the kt held entries and the 64 emitted ones, ping-ponged between two
//     buffers of kt + 64 entries (16 x (kt + 64) x 8 B x 2 a block, 32 KB at
//     kt = 64). The 16 threads of a sub-tile compute its 64 keys (the depth
//     along the sub-tile-center ray; -inf where invalid), rank each batch
//     entry stably (#{j: k_j < k_i} + #{j before i: k_j == k_i}) plus the
//     hold entries of key <= its own (binary search in the sorted hold), and
//     each hold entry at its index plus the batch entries of smaller key.
//     That is the stable sort of (hold, batch) that the oracle takes, by
//     construction: no library sort. Entries 0..63 are emitted in that order,
//     entries 64.. are the new hold. After the stream, ceil(kt / 64) batches
//     of +inf keys push the hold out.
//   * Per-pixel quantities are recomputed at emission. An emitted entry with
//     a finite key is read again by its Gaussian id through the read-only
//     cache (the 16 lanes of a sub-tile read one address), and each lane
//     computes the depth along its quad-center ray (the mid key), along its
//     own ray (the head key) and its alpha with the plain version's formulas
//     in the same order. The mid key is then bit-identical across a quad, so
//     every lane keeps its own copy of its quad's mid window, with no
//     shuffles. Entries of alpha 0 for the pixel keep their slot; the fill
//     counts, and so every pop decision, are uniform over the sub-tile.
//   * Mid and head windows live in registers: (key, head depth, alpha, id)
//     and (key, alpha, id), templated over the reference's window sizes
//     (MID_MAX in {8, 12, 20}, HEAD_MAX in {4, 8, 16}); loops are unrolled
//     with compile-time indices and the fill tests use the runtime km, kh;
//     slots past them stay at +inf. A full window pops its front before the
//     insert, which goes behind every entry of equal or smaller key. A head
//     pop blends: U = T (1 - a) commits where the pixel is not done and
//     U >= 1e-4 (rgb fetched by the entry's id), and sets done where
//     U < 1e-4.
//   * Early exit per tile only: before each batch and before the drain,
//     __syncthreads_and(done) ends the tile once every pixel is done, which
//     is exact (a done pixel never commits). Work of single done pixels is
//     not skipped.
//
// Outputs, written straight into the image layout: color [3, H, W] (raw; the
// background is composited by the caller), final_T [H, W], n_contrib
// [H, W] (commits with alpha > 0), depth_acc [H, W] (sum of w * head depth).
//
// What bounds it on an H100: operations. Per (stream position, sub-tile) a
// key (a ray depth, 24 operations); per (emitted entry, pixel) an alpha and
// two ray depths (~59) and a mid insert (km compares and selects over 4
// fields); per mid pop a head insert (kh over 3 fields); 10 a commit.
// Against that, the id list and ~68 bytes of rows a Gaussian are read and
// ~50 MB written at 1080p. The tail merge (64 + kt compares per entry over
// 16 threads, and a binary search) sits on top of the bound. Its design
// against the bound: the stream is read once per tile, the tail never
// leaves shared memory, the mid and head windows never leave registers, the
// smallest instantiation holding km and kh runs, and a finished tile stops.
//
// Numerics: accurate expf, IEEE division and square root, and built with
// -fmad=false, so that each product and sum rounds as in the plain PyTorch
// version (kernels/hier_blend.py) that the tests and chip_smoke.py hold it
// against.
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain C
// interface, loaded with ctypes.

#include "hier_common.cuh"

namespace {

using namespace hier;

template <int MID_MAX, int HEAD_MAX>
__global__ void __launch_bounds__(kBlock)
hier_blend_fwd_kernel(const int* __restrict__ point_list,
                      const int* __restrict__ starts,
                      const int* __restrict__ ends,
                      const float2* __restrict__ xy,
                      const float4* __restrict__ conic_opacity,
                      const float* __restrict__ rgb,
                      const float* __restrict__ inv9,
                      const float* __restrict__ power_thr,
                      const float* __restrict__ cam, float ndc_sx,
                      float ndc_sy, int kt, int km, int kh, int culling,
                      int grid_x, int width, int height,
                      float* __restrict__ out_color,
                      float* __restrict__ out_final_t,
                      int* __restrict__ out_n_contrib,
                      float* __restrict__ out_depth) {
  __shared__ int s_gid[kBatch];
  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_co[kBatch];
  __shared__ float s_q[9][kBatch];
  __shared__ float s_thr[kBatch];
  __shared__ float s_bkey[kSub][kBatch];
  // Tail: buffer b of sub-tile s at (b * kSub + s) * len, keys then ids.
  extern __shared__ float s_tail[];
  const int len = kt + kBatch;
  float* tail_key = s_tail;
  int* tail_gid = reinterpret_cast<int*>(s_tail + 2 * kSub * len);

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int s = t >> 4;   // sub-tile
  const int l = t & 15;   // lane in the sub-tile
  const int q = l >> 2;   // quad in the sub-tile
  const int r = l & 3;    // pixel in the quad
  const int st_x = (tile % grid_x) * kTileX + (s & 3) * 4;
  const int st_y = (tile / grid_x) * kTileY + (s >> 2) * 4;
  const int qd_x = st_x + (q & 1) * 2;
  const int qd_y = st_y + (q >> 1) * 2;
  const int px = qd_x + (r & 1);
  const int py = qd_y + (r >> 1);
  const bool inside = px < width && py < height;
  const float pfx = static_cast<float>(px);
  const float pfy = static_cast<float>(py);
  const float st_fx = static_cast<float>(st_x);
  const float st_fy = static_cast<float>(st_y);

  float vtx, vty, vtz, vmx, vmy, vmz, vhx, vhy, vhz;
  view_ray(st_fx + 1.5f, st_fy + 1.5f, cam, ndc_sx, ndc_sy, vtx, vty, vtz);
  view_ray(static_cast<float>(qd_x) + 0.5f, static_cast<float>(qd_y) + 0.5f,
           cam, ndc_sx, ndc_sy, vmx, vmy, vmz);
  view_ray(pfx, pfy, cam, ndc_sx, ndc_sy, vhx, vhy, vhz);

  const int start = starts[tile];
  const int count = ends[tile] - start;

  // The first hold: kt entries of key -inf.
  int cur = 0;
  for (int h = l; h < kt; h += kSub) {
    tail_key[s * len + kBatch + h] = -CUDART_INF_F;
    tail_gid[s * len + kBatch + h] = 0;
  }

  float mk[MID_MAX], mdh[MID_MAX], ma[MID_MAX];
  int mg[MID_MAX];
  float hk[HEAD_MAX], ha[HEAD_MAX];
  int hg[HEAD_MAX];
#pragma unroll
  for (int i = 0; i < MID_MAX; ++i) {
    mk[i] = CUDART_INF_F;
    mdh[i] = 0.0f;
    ma[i] = 0.0f;
    mg[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < HEAD_MAX; ++i) {
    hk[i] = CUDART_INF_F;
    ha[i] = 0.0f;
    hg[i] = 0;
  }
  int fm = 0, fh = 0;
  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d_acc = 0.0f;
  int nc = 0;
  bool done = !inside;

  // Pop the head's front: the blend.
  auto head_pop = [&]() {
    const float a0 = ha[0];
    const float U = T * (1.0f - a0);
    if (!done) {
      if (U < kTThreshold) {
        done = true;
      } else {
        const float w = a0 * T;
        const float* col = rgb + 3 * static_cast<long long>(hg[0]);
        c0 = c0 + w * __ldg(col);
        c1 = c1 + w * __ldg(col + 1);
        c2 = c2 + w * __ldg(col + 2);
        d_acc = d_acc + w * hk[0];
        T = U;
        nc += (a0 > 0.0f) ? 1 : 0;
      }
    }
#pragma unroll
    for (int i = 0; i + 1 < HEAD_MAX; ++i) {
      hk[i] = hk[i + 1];
      ha[i] = ha[i + 1];
      hg[i] = hg[i + 1];
    }
    hk[HEAD_MAX - 1] = CUDART_INF_F;
    ha[HEAD_MAX - 1] = 0.0f;
    hg[HEAD_MAX - 1] = 0;
    --fh;
  };

  // Pop the mid's front into the head (head pop first where it is full).
  auto mid_pop = [&]() {
    if (fh == kh) head_pop();
    const float key = mdh[0];
    const float a = ma[0];
    const int g = mg[0];
    int pos = 0;
#pragma unroll
    for (int i = 0; i < HEAD_MAX; ++i) pos += (hk[i] <= key) ? 1 : 0;
#pragma unroll
    for (int i = HEAD_MAX - 1; i > 0; --i) {
      if (i > pos) {
        hk[i] = hk[i - 1];
        ha[i] = ha[i - 1];
        hg[i] = hg[i - 1];
      } else if (i == pos) {
        hk[i] = key;
        ha[i] = a;
        hg[i] = g;
      }
    }
    if (pos == 0) {
      hk[0] = key;
      ha[0] = a;
      hg[0] = g;
    }
    ++fh;
#pragma unroll
    for (int i = 0; i + 1 < MID_MAX; ++i) {
      mk[i] = mk[i + 1];
      mdh[i] = mdh[i + 1];
      ma[i] = ma[i + 1];
      mg[i] = mg[i + 1];
    }
    mk[MID_MAX - 1] = CUDART_INF_F;
    mdh[MID_MAX - 1] = 0.0f;
    ma[MID_MAX - 1] = 0.0f;
    mg[MID_MAX - 1] = 0;
    --fm;
  };

  // One tail round: merge the batch keys in s_bkey (ids in s_gid) with the
  // hold of buffer `cur` into buffer 1 - cur, then run the 64 emitted
  // entries through this pixel's mid and head windows.
  auto tail_round = [&](bool drain) {
    const int nxt = 1 - cur;
    const float* hold_k = tail_key + (cur * kSub + s) * len + kBatch;
    const int* hold_g = tail_gid + (cur * kSub + s) * len + kBatch;
    float* out_k = tail_key + (nxt * kSub + s) * len;
    int* out_g = tail_gid + (nxt * kSub + s) * len;
    const float* bk = s_bkey[s];
    for (int j = l; j < kBatch; j += kSub) {
      const float key = bk[j];
      int rank = 0;
      for (int i = 0; i < kBatch; ++i) {
        const float ki = bk[i];
        rank += (ki < key || (i < j && ki == key)) ? 1 : 0;
      }
      int lo = 0, hi = kt;  // hold entries of key <= this key
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (hold_k[mid] <= key) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      out_k[rank + lo] = key;
      out_g[rank + lo] = drain ? 0 : s_gid[j];
    }
    for (int h = l; h < kt; h += kSub) {
      const float key = hold_k[h];
      int rank = h;
      for (int i = 0; i < kBatch; ++i) rank += (bk[i] < key) ? 1 : 0;
      out_k[rank] = key;
      out_g[rank] = hold_g[h];
    }
    cur = nxt;
    __syncthreads();

    for (int e = 0; e < kBatch; ++e) {
      const float key = out_k[e];
      if (!(key > -CUDART_INF_F && key < CUDART_INF_F)) continue;
      const int g = out_g[e];
      const float2 m = __ldg(xy + g);
      const float4 co = __ldg(conic_opacity + g);
      float qv[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) qv[i] = __ldg(inv9 + 9 * static_cast<long long>(g) + i);
      const float d_mid = ray_depth(qv, vmx, vmy, vmz);
      const float d_head = ray_depth(qv, vhx, vhy, vhz);
      const float dx = m.x - pfx;
      const float dy = m.y - pfy;
      const float power =
          0.5f * (co.x * dx * dx + co.z * dy * dy) + co.y * dx * dy;
      const float alpha = fminf(kAlphaMax, co.w * expf(-power));
      const bool ok =
          power >= 0.0f && alpha >= kAlphaThreshold && d_head >= 0.0f;
      const float a_eff = ok ? alpha : 0.0f;
      if (fm == km) mid_pop();
      int pos = 0;
#pragma unroll
      for (int i = 0; i < MID_MAX; ++i) pos += (mk[i] <= d_mid) ? 1 : 0;
#pragma unroll
      for (int i = MID_MAX - 1; i > 0; --i) {
        if (i > pos) {
          mk[i] = mk[i - 1];
          mdh[i] = mdh[i - 1];
          ma[i] = ma[i - 1];
          mg[i] = mg[i - 1];
        } else if (i == pos) {
          mk[i] = d_mid;
          mdh[i] = d_head;
          ma[i] = a_eff;
          mg[i] = g;
        }
      }
      if (pos == 0) {
        mk[0] = d_mid;
        mdh[0] = d_head;
        ma[0] = a_eff;
        mg[0] = g;
      }
      ++fm;
    }
  };

  bool finished = false;
  for (int base = 0; base < count; base += kBatch) {
    // Barrier: the previous round's emitted entries are read by every
    // thread before the staging and key buffers are overwritten.
    if (__syncthreads_and(done)) {
      finished = true;
      break;
    }
    const int n = min(kBatch, count - base);
    if (t < kBatch) {
      int g = 0;
      if (t < n) {
        g = point_list[start + base + t];
        const float* qg = inv9 + 9 * static_cast<long long>(g);
        s_xy[t] = xy[g];
        s_co[t] = conic_opacity[g];
#pragma unroll
        for (int i = 0; i < 9; ++i) s_q[i][t] = qg[i];
        s_thr[t] = power_thr[g];
      }
      s_gid[t] = g;
    }
    __syncthreads();
    for (int j = l; j < kBatch; j += kSub) {
      float key = -CUDART_INF_F;
      if (j < n) {
        float qv[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) qv[i] = s_q[i][j];
        const float d_tail = ray_depth(qv, vtx, vty, vtz);
        bool valid = d_tail >= 0.0f;
        if (culling && valid) {
          valid = subtile_power(s_xy[j], s_co[j], st_fx, st_fy) <= s_thr[j];
        }
        if (valid) key = d_tail;
      }
      s_bkey[s][j] = key;
    }
    __syncthreads();
    tail_round(false);
  }
  if (!finished) finished = __syncthreads_and(done);
  if (!finished) {
    for (int d = 0; d < kt; d += kBatch) {
      __syncthreads();
      for (int j = l; j < kBatch; j += kSub) s_bkey[s][j] = CUDART_INF_F;
      __syncthreads();
      tail_round(true);
    }
    for (int i = 0; i < km; ++i) {
      if (fm > 0) mid_pop();
    }
    for (int i = 0; i < kh; ++i) {
      if (fh > 0) head_pop();
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

template <int MID_MAX, int HEAD_MAX>
cudaError_t launch(const void* point_list, const void* starts,
                   const void* ends, const void* xy, const void* conic_opacity,
                   const void* rgb, const void* inv9, const void* power_thr,
                   const void* cam, float ndc_sx, float ndc_sy, int kt, int km,
                   int kh, int culling, int num_tiles, int grid_x, int width,
                   int height, void* out_color, void* out_final_t,
                   void* out_n_contrib, void* out_depth, cudaStream_t stream) {
  const size_t smem = 2 * kSub * static_cast<size_t>(kt + kBatch) *
                      (sizeof(float) + sizeof(int));
  auto kernel = hier_blend_fwd_kernel<MID_MAX, HEAD_MAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<num_tiles, kBlock, smem, stream>>>(
      static_cast<const int*>(point_list), static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const float2*>(xy),
      static_cast<const float4*>(conic_opacity),
      static_cast<const float*>(rgb), static_cast<const float*>(inv9),
      static_cast<const float*>(power_thr), static_cast<const float*>(cam),
      ndc_sx, ndc_sy, kt, km, kh, culling, grid_x, width, height,
      static_cast<float*>(out_color), static_cast<float*>(out_final_t),
      static_cast<int*>(out_n_contrib), static_cast<float*>(out_depth));
  return cudaGetLastError();
}

}  // namespace

// mid_max / head_max: the instantiation (mid in 8, 12, 20; head in 4, 8, 16),
// km <= mid_max, kh <= head_max; kt in 1..512.
extern "C" int stp_hier_blend_fwd(
    const void* point_list, const void* starts, const void* ends,
    const void* xy, const void* conic_opacity, const void* rgb,
    const void* inv9, const void* power_thr, const void* cam, float ndc_sx,
    float ndc_sy, int kt, int km, int kh, int mid_max, int head_max,
    int culling, int grid_x, int grid_y, int width, int height,
    void* out_color, void* out_final_t, void* out_n_contrib, void* out_depth,
    void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (kt < 1 || kt > kTailMax || km < 1 || km > mid_max || kh < 1 ||
      kh > head_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define STP_LAUNCH(M, H)                                                     \
  if (mid_max == M && head_max == H)                                         \
    return static_cast<int>(launch<M, H>(                                    \
        point_list, starts, ends, xy, conic_opacity, rgb, inv9, power_thr,   \
        cam, ndc_sx, ndc_sy, kt, km, kh, culling, num_tiles, grid_x, width,  \
        height, out_color, out_final_t, out_n_contrib, out_depth, st));
  STP_LAUNCH(8, 4)
  STP_LAUNCH(8, 8)
  STP_LAUNCH(8, 16)
  STP_LAUNCH(12, 4)
  STP_LAUNCH(12, 8)
  STP_LAUNCH(12, 16)
  STP_LAUNCH(20, 4)
  STP_LAUNCH(20, 8)
  STP_LAUNCH(20, 16)
#undef STP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
