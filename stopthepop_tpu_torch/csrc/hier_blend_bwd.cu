// HIERARCHICAL sort-mode tile blend, backward (kernel K6 of the port).
//
// Replaces stopthepop_tpu/kernels/hier_blend.py::blend_hier_backward (the
// Pallas _bwd_kernel, per-entry cascade). It computes what that kernel
// computes — one replay of K5's cascade per pixel from the saved forward
// output, each committed head pop's gradient sent to the pair that sourced
// it — in the shape of K5 (hier_blend_fwd.cu) with the routing of K4
// (kbuffer_blend_bwd.cu), and no atomics:
//
//   * one block of 256 threads per 16x16 tile with K5's {16, 4, 4} thread
//     map: half-warp s is 4x4 sub-tile s, lanes 4q..4q+3 its 2x2 quad q;
//   * per pixel: the colour and final-T cotangents g (3), g_T and the saved
//     raw colour and final_T give S_tot = colour . g and K_T = g_T T_final
//     (the background stays outside, render/pipeline.py, so autograd has
//     folded g . bg into g_T);
//   * the block replays K5 exactly: the same staging, ray depths and culling
//     (hier_common.cuh), the same entry evaluation and stable tail merge
//     with its 64-entry cadence and +inf drain batches, the same window
//     rules (pop before insert, ties behind, alpha-0 entries keep their
//     slots), built with -fmad=false, so every pop falls as in the forward.
//     The tail and the windows hold each entry's position src in the tile's
//     segment where K5 holds its Gaussian id; the id is point_list[start +
//     src] (a Gaussian appears at most once in a tile's stream), and c . g
//     is formed at the commit from rgb[id] and the pixel's g;
//   * at each commit (a head pop where U = T (1 - a0) >= 1e-4), the algebra
//     of K4:
//       w      = a0 T
//       acc    = acc + w (c.g)
//       galpha = a0 < 0.99 ? (c.g) T - (S_tot - acc + K_T) / (1 - a0) : 0
//       dpower = -a0 galpha
//     d(x, y, a, b, c) from dpower and the source pair's xy and conic,
//     d_opacity = galpha a0 / o, d_rgb = w g;
//   * only commits of a0 > 0 count, and only they are routed: a commit of
//     a0 = 0 (an entry that keeps its slot but gives the pixel nothing)
//     changes neither T nor any sum. A pixel's replay ends once it has made
//     n_contrib of them (K5's n_contrib counts the same); nothing after the
//     last one has a gradient. A pixel whose
//     replay has ended, or that lies outside the image, skips its windows
//     and gradients but keeps ranking and scattering tail entries for its
//     sub-tile and keeps taking part in every barrier and ballot until the
//     whole block is done (__syncthreads_and);
//   * routing, as K4: each (tile, warp) owns rows acc[warp][src][9] for every
//     pair of the tile's segment, in the tile's own rows [start, end) of a
//     320-byte-a-pair scratch in device memory (with the pair's xy and
//     conic). A lane commits at most once a step (one head pop per emitted
//     tail entry, per mid drain step, per head drain step); at each step the
//     committing lanes stage their 9 terms and src, and lane c (c < 9) adds
//     column c of every committing lane in ascending lane order. After the
//     replay, each pair's 8 warp rows are added in warp order into
//     d_pair[start + src]. Every slot of the tile is written, so two runs
//     give the same bits.
//
// Output: d_pair [N, 9] float32 in sorted-slot order, columns
// (d_x, d_y, d_a, d_b, d_c, d_opacity, d_r, d_g, d_b). No gradient flows to
// the inverse covariances, the camera or the culling thresholds: they only
// choose the order and the validity.
//
// What bounds it on an H100: operations, as K5 (the replay: tail keys, the
// per-pixel evaluations and the window inserts) plus about 45 FP32
// operations a commit (the alpha gradient with its divide, the nine terms
// and their sums). Its design against that bound: K5's (the stream read
// once per tile, the tail in shared memory, the windows in registers, the
// smallest instantiation holding km and kh), a pixel stops at its last
// commit and the block once every pixel has; the routing costs a ballot a
// step and one add into the scratch per committing lane and column.
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain C
// interface, loaded with ctypes.

#include "hier_common.cuh"

namespace {

using namespace hier;

constexpr int kWarps = kBlock / 32;
constexpr int kCols = 9;
// Floats a pair takes in the scratch: 8 of features (xy, pad, conic and
// opacity) and kWarps * kCols of gradient sums.
constexpr int kFeat = 8;
constexpr int kPairFloats = kFeat + kWarps * kCols;

// K5 writes its tail merge and its evaluation of an emitted entry in place;
// K6 has them as functions below, with the same operations in the same
// order.

// An emitted entry, Gaussian g, at pixel (pfx, pfy): the depth along the
// quad-center ray vm (the mid key), along the pixel's ray vh (the head key)
// and the blend alpha, 0 where the entry gives the pixel nothing.
__device__ __forceinline__ void eval_entry(
    int g, const float2* __restrict__ xy,
    const float4* __restrict__ conic_opacity, const float* __restrict__ inv9,
    float vmx, float vmy, float vmz, float vhx, float vhy, float vhz,
    float pfx, float pfy, float& d_mid, float& d_head, float& a_eff) {
  const float2 m = __ldg(xy + g);
  const float4 co = __ldg(conic_opacity + g);
  float qv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) qv[i] = __ldg(inv9 + 9 * static_cast<long long>(g) + i);
  d_mid = ray_depth(qv, vmx, vmy, vmz);
  d_head = ray_depth(qv, vhx, vhy, vhz);
  const float dx = m.x - pfx;
  const float dy = m.y - pfy;
  const float power = 0.5f * (co.x * dx * dx + co.z * dy * dy) + co.y * dx * dy;
  const float alpha = fminf(kAlphaMax, co.w * expf(-power));
  const bool ok = power >= 0.0f && alpha >= kAlphaThreshold && d_head >= 0.0f;
  a_eff = ok ? alpha : 0.0f;
}

// One sub-tile's stable merge of the batch keys bk[0..63] (ids ids[j], or 0
// for a drain batch) with its sorted hold (kt entries) into out (kt + 64
// entries), run by the sub-tile's 16 threads (lane l): each batch entry goes
// to #{batch keys < its own} + #{earlier batch keys == its own} + #{hold
// keys <= its own} (binary search), each hold entry to its index plus the
// batch keys below it. That is the stable sort of (hold, batch).
__device__ __forceinline__ void tail_merge(const float* bk, const int* ids,
                                           bool drain, const float* hold_k,
                                           const int* hold_g, float* out_k,
                                           int* out_g, int kt, int l) {
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
    out_g[rank + lo] = drain ? 0 : ids[j];
  }
  for (int h = l; h < kt; h += kSub) {
    const float key = hold_k[h];
    int rank = h;
    for (int i = 0; i < kBatch; ++i) rank += (bk[i] < key) ? 1 : 0;
    out_k[rank] = key;
    out_g[rank] = hold_g[h];
  }
}

// Register windows: put v at slot pos (entries from pos on move back one),
// and drop the front entry (the last slot takes pad). Loops unroll with
// compile-time indices, so the windows stay in registers.
template <int N, typename V>
__device__ __forceinline__ void win_put(V (&w)[N], int pos, V v) {
#pragma unroll
  for (int i = N - 1; i > 0; --i) {
    if (i > pos) {
      w[i] = w[i - 1];
    } else if (i == pos) {
      w[i] = v;
    }
  }
  if (pos == 0) w[0] = v;
}

template <int N, typename V>
__device__ __forceinline__ void win_shift(V (&w)[N], V pad) {
#pragma unroll
  for (int i = 0; i + 1 < N; ++i) w[i] = w[i + 1];
  w[N - 1] = pad;
}

// Slot of a new entry of key `key`: behind every entry of equal or smaller
// key (empty slots hold +inf).
template <int N>
__device__ __forceinline__ int win_pos(const float (&k)[N], float key) {
  int pos = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) pos += (k[i] <= key) ? 1 : 0;
  return pos;
}

template <int MID_MAX, int HEAD_MAX>
__global__ void __launch_bounds__(kBlock)
hier_blend_bwd_kernel(const int* __restrict__ point_list,
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
                      const float* __restrict__ color,
                      const float* __restrict__ final_t,
                      const int* __restrict__ n_contrib,
                      const float* __restrict__ grad_color,
                      const float* __restrict__ grad_final_t,
                      float* __restrict__ scratch,
                      float* __restrict__ d_pair) {
  __shared__ int s_pos[kBatch];  // stream position of each staged entry
  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_co[kBatch];
  __shared__ float s_q[9][kBatch];
  __shared__ float s_thr[kBatch];
  __shared__ float s_bkey[kSub][kBatch];
  __shared__ float s_stage[kWarps][32 * kCols];
  __shared__ int s_src[kWarps][32];
  // Tail: buffer b of sub-tile s at (b * kSub + s) * len, keys then
  // stream positions.
  extern __shared__ float s_tail[];
  const int len = kt + kBatch;
  float* tail_key = s_tail;
  int* tail_src = reinterpret_cast<int*>(s_tail + 2 * kSub * len);

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
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

  const int start = starts[tile];
  const int count = ends[tile] - start;

  // The segment's rows: features [count][kFeat], then the per-warp sums
  // [kWarps][count][kCols].
  float* rows = scratch + static_cast<long long>(start) * kPairFloats;
  float4* feat = reinterpret_cast<float4*>(rows);
  float* acc = rows + count * kFeat;
  for (int i = t; i < kWarps * count * kCols; i += kBlock) acc[i] = 0.0f;
  for (int p = t; p < count; p += kBlock) {
    const int g = point_list[start + p];
    const float2 m = xy[g];
    feat[2 * p] = make_float4(m.x, m.y, 0.0f, 0.0f);
    feat[2 * p + 1] = conic_opacity[g];
  }
  float* acc_warp = acc + warp * count * kCols;

  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, s_tot = 0.0f, k_t = 0.0f;
  int n_target = 0;
  if (inside) {
    const int pix = py * width + px;
    const int plane = width * height;
    g0 = grad_color[pix];
    g1 = grad_color[plane + pix];
    g2 = grad_color[2 * plane + pix];
    s_tot = color[pix] * g0 + color[plane + pix] * g1 +
            color[2 * plane + pix] * g2;
    k_t = grad_final_t[pix] * final_t[pix];
    n_target = n_contrib[pix];
  }

  float vtx, vty, vtz, vmx, vmy, vmz, vhx, vhy, vhz;
  view_ray(st_fx + 1.5f, st_fy + 1.5f, cam, ndc_sx, ndc_sy, vtx, vty, vtz);
  view_ray(static_cast<float>(qd_x) + 0.5f, static_cast<float>(qd_y) + 0.5f,
           cam, ndc_sx, ndc_sy, vmx, vmy, vmz);
  view_ray(pfx, pfy, cam, ndc_sx, ndc_sy, vhx, vhy, vhz);

  // The first hold: kt entries of key -inf.
  int cur = 0;
  for (int h = l; h < kt; h += kSub) {
    tail_key[s * len + kBatch + h] = -CUDART_INF_F;
    tail_src[s * len + kBatch + h] = 0;
  }

  // Windows: mid (key, head depth, alpha, src), head (key, alpha, src).
  float mk[MID_MAX], mdh[MID_MAX], ma[MID_MAX];
  int ms[MID_MAX];
  float hk[HEAD_MAX], ha[HEAD_MAX];
  int hs[HEAD_MAX];
#pragma unroll
  for (int i = 0; i < MID_MAX; ++i) {
    mk[i] = CUDART_INF_F;
    mdh[i] = 0.0f;
    ma[i] = 0.0f;
    ms[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < HEAD_MAX; ++i) {
    hk[i] = CUDART_INF_F;
    ha[i] = 0.0f;
    hs[i] = 0;
  }
  int fm = 0, fh = 0;
  float T = 1.0f;
  float acc_g = 0.0f;
  int nc = 0;
  bool done = n_target == 0;  // outside pixels have n_target 0 too

  // Pop the head's front (only while not done); on a commit of a0 > 0
  // stage its 9 gradient terms. A commit of a0 = 0 changes nothing (w = 0,
  // T stays, every term is +-0, which leaves a sum that starts at +0 as it
  // is), so it is neither counted nor routed.
  auto head_pop = [&]() -> bool {
    bool commit = false;
    const float a0 = ha[0];
    const float U = T * (1.0f - a0);
    if (U < kTThreshold) {
      done = true;
    } else if (a0 > 0.0f) {
      commit = true;
      const int src = hs[0];
      const float* col = rgb + 3 * static_cast<long long>(point_list[start + src]);
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
      float* st = &s_stage[warp][lane * kCols];
      st[0] = dpower * (co.x * dx + co.y * dy);
      st[1] = dpower * (co.z * dy + co.y * dx);
      st[2] = dpower * 0.5f * dx * dx;
      st[3] = dpower * dx * dy;
      st[4] = dpower * 0.5f * dy * dy;
      st[5] = galpha * a0 / fmaxf(co.w, 1e-12f);
      st[6] = w * g0;
      st[7] = w * g1;
      st[8] = w * g2;
      s_src[warp][lane] = src;
      T = U;
      if (++nc == n_target) done = true;
    }
    win_shift(hk, CUDART_INF_F);
    win_shift(ha, 0.0f);
    win_shift(hs, 0);
    --fh;
    return commit;
  };

  // Pop the mid's front into the head (head pop first where it is full).
  auto mid_pop = [&]() -> bool {
    const bool commit = fh == kh ? head_pop() : false;
    const int pos = win_pos(hk, mdh[0]);
    win_put(hk, pos, mdh[0]);
    win_put(ha, pos, ma[0]);
    win_put(hs, pos, ms[0]);
    ++fh;
    win_shift(mk, CUDART_INF_F);
    win_shift(mdh, 0.0f);
    win_shift(ma, 0.0f);
    win_shift(ms, 0);
    --fm;
    return commit;
  };

  // Warp-uniform: fold this step's commits into the warp's rows, column c
  // by lane c, committing lanes in ascending order.
  auto route = [&](bool commit) {
    unsigned m = __ballot_sync(0xffffffffu, commit);
    if (m == 0u) return;
    __syncwarp();
    if (lane < kCols) {
      while (m) {
        const int c = __ffs(m) - 1;
        m &= m - 1u;
        float* a = acc_warp + s_src[warp][c] * kCols + lane;
        *a = *a + s_stage[warp][c * kCols + lane];
      }
    }
    __syncwarp();
  };

  // One tail round, as K5's: merge the batch keys in s_bkey (positions in
  // s_pos) with the hold of buffer `cur` into buffer 1 - cur, then run the
  // 64 emitted entries through this pixel's mid and head windows, a step
  // each.
  auto tail_round = [&](bool drain) {
    const int nxt = 1 - cur;
    const float* hold_k = tail_key + (cur * kSub + s) * len + kBatch;
    const int* hold_s = tail_src + (cur * kSub + s) * len + kBatch;
    float* out_k = tail_key + (nxt * kSub + s) * len;
    int* out_s = tail_src + (nxt * kSub + s) * len;
    tail_merge(s_bkey[s], s_pos, drain, hold_k, hold_s, out_k, out_s, kt, l);
    cur = nxt;
    __syncthreads();

    for (int e = 0; e < kBatch; ++e) {
      bool commit = false;
      const float key = out_k[e];
      if (!done && key > -CUDART_INF_F && key < CUDART_INF_F) {
        const int src = out_s[e];
        float d_mid, d_head, a_eff;
        eval_entry(point_list[start + src], xy, conic_opacity, inv9, vmx, vmy,
                   vmz, vhx, vhy, vhz, pfx, pfy, d_mid, d_head, a_eff);
        if (fm == km) commit = mid_pop();
        const int pos = win_pos(mk, d_mid);
        win_put(mk, pos, d_mid);
        win_put(mdh, pos, d_head);
        win_put(ma, pos, a_eff);
        win_put(ms, pos, src);
        ++fm;
      }
      route(commit);
    }
  };

  __syncthreads();  // rows zeroed and features written
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
      if (t < n) {
        const int g = point_list[start + base + t];
        const float* qg = inv9 + 9 * static_cast<long long>(g);
        s_xy[t] = xy[g];
        s_co[t] = conic_opacity[g];
#pragma unroll
        for (int i = 0; i < 9; ++i) s_q[i][t] = qg[i];
        s_thr[t] = power_thr[g];
      }
      s_pos[t] = base + t;
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
      bool commit = false;
      if (!done && fm > 0) commit = mid_pop();
      route(commit);
    }
    for (int i = 0; i < kh; ++i) {
      bool commit = false;
      if (!done && fh > 0) commit = head_pop();
      route(commit);
    }
  }

  __syncthreads();
  for (int idx = t; idx < count * kCols; idx += kBlock) {
    float sum = acc[idx];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = sum + acc[w * count * kCols + idx];
    d_pair[static_cast<long long>(start) * kCols + idx] = sum;
  }
}

template <int MID_MAX, int HEAD_MAX>
cudaError_t launch(const void* point_list, const void* starts,
                   const void* ends, const void* xy, const void* conic_opacity,
                   const void* rgb, const void* inv9, const void* power_thr,
                   const void* cam, float ndc_sx, float ndc_sy, int kt, int km,
                   int kh, int culling, int num_tiles, int grid_x, int width,
                   int height, const void* color, const void* final_t,
                   const void* n_contrib, const void* grad_color,
                   const void* grad_final_t, void* scratch, void* d_pair,
                   cudaStream_t stream) {
  const size_t smem = 2 * kSub * static_cast<size_t>(kt + kBatch) *
                      (sizeof(float) + sizeof(int));
  auto kernel = hier_blend_bwd_kernel<MID_MAX, HEAD_MAX>;
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
      static_cast<const float*>(color), static_cast<const float*>(final_t),
      static_cast<const int*>(n_contrib),
      static_cast<const float*>(grad_color),
      static_cast<const float*>(grad_final_t), static_cast<float*>(scratch),
      static_cast<float*>(d_pair));
  return cudaGetLastError();
}

}  // namespace

// mid_max / head_max: the instantiation (mid in 8, 12, 20; head in 4, 8, 16),
// km <= mid_max, kh <= head_max; kt in 1..512. scratch: [N, 80] float32, one
// row of features and per-warp sums a pair (written before it is read; no
// initial value needed).
extern "C" int stp_hier_blend_bwd(
    const void* point_list, const void* starts, const void* ends,
    const void* xy, const void* conic_opacity, const void* rgb,
    const void* inv9, const void* power_thr, const void* cam, float ndc_sx,
    float ndc_sy, int kt, int km, int kh, int mid_max, int head_max,
    int culling, const void* color, const void* final_t,
    const void* n_contrib, const void* grad_color, const void* grad_final_t,
    int grid_x, int grid_y, int width, int height, void* scratch,
    void* d_pair, void* stream) {
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
        height, color, final_t, n_contrib, grad_color, grad_final_t,         \
        scratch, d_pair, st));
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
