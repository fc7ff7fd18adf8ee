// The HIERARCHICAL cascade shared by the blend kernels K5 (hier_blend_fwd.cu)
// and K6 (hier_blend_bwd.cu). K6 replays K5 bit for bit, so both run this one
// replay: the staging, the tail keys and merge, the mid and head windows and
// the drain. Each kernel supplies a hook: what a commit (a head pop where
// U = T (1 - a) >= 1e-4) does, and what ends a step (K6 routes its gradient
// terms there). Everything is __forceinline__: each kernel compiles as if the
// code were written in place.
//
// The replay, one block of 256 threads per 16x16 tile, with the reference's
// {16, 4, 4} thread map: half-warp s is 4x4 sub-tile s (row-major in the
// tile), its lanes 4q..4q+3 are 2x2 quad q, lane r of a quad is pixel
// (r & 1, r >> 1).
//
//   * Staging. Per batch of TAIL_BATCH = 64 stream positions, threads 0..63
//     stage each position's payload (K5: its Gaussian id; K6: its position
//     in the tile's segment) and the rows the tail keys read: xy,
//     conic+opacity, the 9 floats of the packed inverse covariance and the
//     culling threshold.
//   * Tail, per sub-tile, in dynamic shared memory: (key, payload) for the kt
//     held entries and the 64 emitted ones, ping-ponged between two buffers
//     of kt + 65 entries (33 KB a block at kt = 64). The 16 threads of a
//     sub-tile compute its 64 keys (the depth along the sub-tile-center ray;
//     -inf where invalid) and place each entry of the stable sort of (hold,
//     batch) by rank (tail_merge: each lane ranks its 4 batch entries, and
//     then 4 hold entries at a time, in one pass over the batch keys read 4
//     at a time). Entries 0..63 are emitted, in that order; the rest are the
//     new hold. After the stream, ceil(kt / 64) batches of +inf keys push
//     the hold out.
//   * Mid keys, once a quad. After each merge each lane computes the depth
//     along its quad-center ray (the mid key) of 16 of the 64 emitted
//     entries, with their covariance rows loaded 2 entries at a time, into
//     sh.mid[e][quad]; K6 first looks up the emitted entries' Gaussian ids
//     by position, one pass of the sub-tile's 16 lanes. The rays (sub-tile,
//     quad and pixel centers) are kept in shared memory, not registers.
//   * Mid window, one a quad: each of its 4 lanes keeps the same copy of
//     (mid key, payload) in registers, so an insert needs no exchange
//     between lanes. Head window, one a pixel, in registers: (head depth,
//     alpha, payload). The per-pixel head depth and alpha of an entry are
//     computed when it leaves the mid for the head, with the formulas and
//     order of the plain version; a done pixel skips all of it (it never
//     commits), and a quad whose 4 pixels are done skips its mid keys.
//   * Window rules: a full window pops its front before the insert, which
//     goes behind every entry of equal or smaller key; an entry of alpha 0
//     for the pixel keeps its slot, so the fill counts, and every pop
//     decision, are uniform over the sub-tile. A full window's pop and
//     insert are one pass over its slots (win_pos_popped, win_put_popped).
//     After the drain, km mid steps pop every mid entry into the head, then
//     kh head steps blend the rest.
//   * Early exit per tile: before each batch and before the drain,
//     __syncthreads_and(done) ends the tile once every pixel is done, which
//     is exact (a done pixel never commits).
//   * Occupancy: registers, not shared memory, bound the blocks an SM
//     holds. The default sizes (MID_MAX, HEAD_MAX) = (8, 4) are built for
//     three blocks an SM (80 registers), the other sizes up to (12, 8) for
//     two, the rest for one; kt = 512 fits one block.
//
// The batched cascade (BATCHED, JAX render/naive.py's batched_cascade): the
// tail is the same; its 64 emitted entries of a round enter the mid window
// in 8 sub-batches of kCasc = 8, ghosts and drain pads among them keyed
// -inf. Each mid round is the stable sort of the hold (km entries,
// ascending, first all -inf "bubbles") and the sub-batch in emission order:
// each entry goes behind every entry of equal or smaller key, one after the
// other, in a register window of MID_MAX + 8 slots; the first 8 are emitted
// and the last km kept. The emitted entries, keyed by their head depth
// where the mid key is finite (else by that key, with alpha 0), run the
// same round through a head window of HEAD_MAX + 8 slots (kh held), and
// the head's 8 emitted entries blend in order, a step each. After the
// tail's drain, ceil(km / 8) mid rounds of +inf pads, then the kh held
// head entries blend in order. An entry of alpha 0 (bubble, ghost, pad, or
// a real entry that gives the pixel nothing) changes nothing and is
// skipped; so is a warp's sub-batch in which neither of its sub-tiles
// emits a finite key (it changes nothing). The wider windows take
// registers: the batched instantiations are built for fewer blocks an SM
// (min_blocks).
//
// Numerics: accurate expf, IEEE division and square root, and built with
// -fmad=false, so that each product and sum rounds as in the plain PyTorch
// versions (kernels/hier_blend.py).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace hier {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kBlock = kTileX * kTileY;
constexpr int kSub = 16;    // 4x4 sub-tiles of a tile
constexpr int kQuads = 4;   // 2x2 quads of a sub-tile
constexpr int kBatch = 64;  // TAIL_BATCH
constexpr int kCasc = 8;    // CASC_BATCH: the batched cascade's sub-batch
constexpr int kTailMax = 512;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTThreshold = 1.0e-4f;
constexpr float kDenFloor = 1.0e-5f;
constexpr float kPatch = 3.0f;  // the sub-tile rect's patch width

// Blocks of 256 threads an SM should hold (__launch_bounds__): three at the
// default window sizes, two up to (12, 8), one for the widest windows; for
// the batched cascade two at the default sizes (K5; K6 takes one, which
// ran faster on an H100 than two with spills, PERF.md) and one above.
template <int MID_MAX, int HEAD_MAX, bool BATCHED>
constexpr int min_blocks() {
  return BATCHED ? ((MID_MAX == 8 && HEAD_MAX == 4) ? 2 : 1)
         : (MID_MAX == 8 && HEAD_MAX == 4) ? 3
         : (MID_MAX <= 12 && HEAD_MAX <= 8) ? 2
                                           : 1;
}

// The world-space view ray through pixel coordinate (fx, fy)
// (ops/transforms.py::compute_view_ray, as K3 computes it).
__device__ __forceinline__ void view_ray(float fx, float fy,
                                         const float* __restrict__ cam,
                                         float ndc_sx, float ndc_sy,
                                         float& vx, float& vy, float& vz) {
  const float ndc_x = fx * ndc_sx - 1.0f;
  const float ndc_y = fy * ndc_sy - 1.0f;
  float p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = ndc_x * cam[j] + ndc_y * cam[4 + j] + cam[12 + j];
  }
  const float rx = p[0] / p[3] - cam[16];
  const float ry = p[1] / p[3] - cam[17];
  const float rz = p[2] / p[3] - cam[18];
  const float norm = sqrtf(rx * rx + ry * ry + rz * rz);
  vx = rx / norm;
  vy = ry / norm;
  vz = rz / norm;
}

// Depth of the max-contribution point along a ray
// (ops/stopthepop.py::depth_along_ray). q: xx xy xz yy yz zz u0 u1 u2.
__device__ __forceinline__ float ray_depth(const float q[9], float vx,
                                           float vy, float vz) {
  const float num = q[6] * vx + q[7] * vy + q[8] * vz;
  const float den = q[0] * vx * vx + q[3] * vy * vy + q[5] * vz * vz +
                    2.0f * (q[1] * vx * vy + q[2] * vx * vz + q[4] * vy * vz);
  return num / fmaxf(kDenFloor, den);
}

// torch.clamp(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

// Smallest Gaussian power over the pixel rect [rmin, rmin + 3]^2
// (ops/stopthepop.py::max_contrib_power_rect with patch 3x3).
__device__ __forceinline__ float subtile_power(float2 m, float4 co,
                                               float rmin_x, float rmin_y) {
  const float rmax_x = rmin_x + kPatch;
  const float rmax_y = rmin_y + kPatch;
  const bool x_left = (rmin_x - m.x) > 0.0f;
  const bool y_above = (rmin_y - m.y) > 0.0f;
  const bool not_in_x = x_left || (m.x > rmax_x);
  const bool not_in_y = y_above || (m.y > rmax_y);
  if (!(not_in_x || not_in_y)) return 0.0f;
  const float px = x_left ? rmin_x : rmax_x;
  const float py = y_above ? rmin_y : rmax_y;
  const float dx = x_left ? kPatch : -kPatch;
  const float dy = y_above ? kPatch : -kPatch;
  const float diffx = m.x - px;
  const float diffy = m.y - py;
  const float tx = not_in_y ? clamp01((dx * co.x * diffx + dx * co.y * diffy) /
                                      (dx * dx * co.x))
                            : 0.0f;
  const float ty = not_in_x ? clamp01((dy * co.y * diffx + dy * co.z * diffy) /
                                      (dy * dy * co.z))
                            : 0.0f;
  const float ex = m.x - (px + tx * dx);
  const float ey = m.y - (py + ty * dy);
  return 0.5f * (co.x * ex * ex + co.z * ey * ey) + co.y * ex * ey;
}

// The kernels' inputs, as their C interfaces take them.
struct Args {
  const int* __restrict__ point_list;
  const int* __restrict__ starts;
  const int* __restrict__ ends;
  const float2* __restrict__ xy;
  const float4* __restrict__ conic_opacity;
  const float* __restrict__ rgb;
  const float* __restrict__ inv9;
  const float* __restrict__ power_thr;
  const float* __restrict__ cam;
  float ndc_sx, ndc_sy;
  int kt, km, kh, culling, grid_x, width, height;
};

// A thread's place in its tile: sub-tile s, quad q, pixel r of the quad.
struct Pixel {
  int lane, warp, s, l, q, r;
  int st_x, st_y, qd_x, qd_y, px, py;
  bool inside;
  unsigned qmask;  // the quad's 4 lanes

  __device__ __forceinline__ explicit Pixel(int grid_x, int width,
                                            int height) {
    const int tile = blockIdx.x;
    const int t = threadIdx.x;
    lane = t & 31;
    warp = t >> 5;
    s = t >> 4;
    l = t & 15;
    q = l >> 2;
    r = l & 3;
    st_x = (tile % grid_x) * kTileX + (s & 3) * 4;
    st_y = (tile / grid_x) * kTileY + (s >> 2) * 4;
    qd_x = st_x + (q & 1) * 2;
    qd_y = st_y + (q >> 1) * 2;
    px = qd_x + (r & 1);
    py = qd_y + (r >> 1);
    inside = px < width && py < height;
    qmask = 0xfu << (lane & 28);
  }
};

// Static shared memory of the replay. egid (the emitted entries' Gaussian
// ids) is needed only where the payload is a stream position. The rows of
// bkey are 4 floats longer and those of egid and the tail 1 longer, so that
// the two half-warps of a warp read them from different banks.
template <bool kByPosition>
struct Smem {
  int pay[kBatch];
  float2 xy[kBatch];
  float4 co[kBatch];
  float q[9][kBatch];
  float thr[kBatch];
  alignas(16) float bkey[kSub][kBatch + 4];
  int egid[kByPosition ? kSub : 1][kBatch + 1];
  float mid[kBatch][kSub * kQuads];  // mid key of emitted entry e, per quad
  float vt[kSub][3];                 // sub-tile-center rays
  float vm[kSub * kQuads][3];        // quad-center rays
  float vh[3][kBlock];               // pixel rays (out of registers)
};

// Dynamic shared memory of the tail, bytes: two buffers a sub-tile of
// kt + 65 (key, payload) entries.
__host__ __device__ constexpr size_t tail_bytes(int kt) {
  return 2 * kSub * static_cast<size_t>(kt + kBatch + 1) *
         (sizeof(float) + sizeof(int));
}

// Let `kernel` take the tail of size kt in dynamic shared memory.
template <class Kernel>
cudaError_t set_tail(Kernel kernel, int kt) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(tail_bytes(kt)));
}

// What `kernel` reaches at tail size kt on this device: out[0] resident
// blocks per SM, out[1] registers a thread, out[2] local (spill) bytes a
// thread, out[3] shared bytes a block.
template <class Kernel>
cudaError_t occupancy(Kernel kernel, int kt, int* out) {
  cudaError_t err = set_tail(kernel, kt);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes + tail_bytes(kt));
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kBlock,
                                                       tail_bytes(kt));
}

// The rows an entry's per-pixel evaluation reads.
struct Rows {
  float2 m;
  float4 co;
  float q[9];
};

__device__ __forceinline__ void load_rows(Rows& w, int g, const Args& a) {
  w.m = __ldg(a.xy + g);
  w.co = __ldg(a.conic_opacity + g);
  const float* qg = a.inv9 + 9 * static_cast<long long>(g);
#pragma unroll
  for (int i = 0; i < 9; ++i) w.q[i] = __ldg(qg + i);
}

// An entry at pixel (pfx, pfy): the depth along the pixel's ray vh (the head
// key) and the blend alpha, 0 where the entry gives the pixel nothing.
__device__ __forceinline__ void eval_pixel(const Rows& w, float vhx, float vhy,
                                           float vhz, float pfx, float pfy,
                                           float& d_head, float& a_eff) {
  d_head = ray_depth(w.q, vhx, vhy, vhz);
  const float dx = w.m.x - pfx;
  const float dy = w.m.y - pfy;
  const float power =
      0.5f * (w.co.x * dx * dx + w.co.z * dy * dy) + w.co.y * dx * dy;
  const float alpha = fminf(kAlphaMax, w.co.w * expf(-power));
  const bool ok = power >= 0.0f && alpha >= kAlphaThreshold && d_head >= 0.0f;
  a_eff = ok ? alpha : 0.0f;
}

// One sub-tile's stable merge of the batch keys bk[0..63] (payloads pay[j],
// or 0 for a drain batch; bk 16-byte aligned) with its sorted hold (kt
// entries) into out (kt + 64 entries), run by the sub-tile's 16 threads
// (lane l): each batch entry goes to #{batch keys < its own} + #{earlier
// batch keys == its own} + #{hold keys <= its own} (binary search), each
// hold entry to its index plus the batch keys below it. That is the stable
// sort of (hold, batch). A lane ranks its 4 batch entries (j = l + 16 m),
// and its hold entries 4 at a time, in one pass over the batch keys.
__device__ __forceinline__ void tail_merge(const float* bk, const int* pay,
                                           bool drain, const float* hold_k,
                                           const int* hold_p, float* out_k,
                                           int* out_p, int kt, int l) {
  constexpr int M = kBatch / kSub;  // batch entries a lane places
  const float4* bk4 = reinterpret_cast<const float4*>(bk);
  float key[M];
  int rank[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    key[m] = bk[l + kSub * m];
    rank[m] = 0;
  }
#pragma unroll 4
  for (int i4 = 0; i4 < kBatch / 4; ++i4) {
    const float4 v = bk4[i4];
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * i4 + c;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        rank[m] += (vv[c] < key[m] || (i < l + kSub * m && vv[c] == key[m])) ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    int lo = 0, hi = kt;  // hold entries of key <= this key
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (hold_k[mid] <= key[m]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out_k[rank[m] + lo] = key[m];
    out_p[rank[m] + lo] = drain ? 0 : pay[l + kSub * m];
  }
  for (int h0 = l; h0 < kt; h0 += M * kSub) {
    float hkey[M];
    int hr[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int h = h0 + kSub * m;
      hkey[m] = h < kt ? hold_k[h] : 0.0f;
      hr[m] = h;
    }
#pragma unroll 4
    for (int i4 = 0; i4 < kBatch / 4; ++i4) {
      const float4 v = bk4[i4];
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int m = 0; m < M; ++m) hr[m] += (vv[c] < hkey[m]) ? 1 : 0;
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int h = h0 + kSub * m;
      if (h < kt) {
        out_k[hr[m]] = hkey[m];
        out_p[hr[m]] = hold_p[h];
      }
    }
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

// Drop the front of a full window and insert an entry of key `key` in one
// pass: the same window as win_shift (an empty slot, +inf, at the back)
// then win_pos and win_put.
template <int N>
__device__ __forceinline__ int win_pos_popped(const float (&k)[N], float key) {
  int pos = (CUDART_INF_F <= key) ? 1 : 0;
#pragma unroll
  for (int i = 1; i < N; ++i) pos += (k[i] <= key) ? 1 : 0;
  return pos;
}

template <int N, typename V>
__device__ __forceinline__ void win_put_popped(V (&w)[N], int pos, V v,
                                               V pad) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const V below = i + 1 < N ? w[i + 1 < N ? i + 1 : i] : pad;
    w[i] = i < pos ? below : (i == pos ? v : w[i]);
  }
}

__device__ __forceinline__ bool finite_key(float k) {
  return k > -CUDART_INF_F && k < CUDART_INF_F;
}

// The batched cascade's windows: the slot of a new entry among the first n
// (behind every entry of equal or smaller key), and the window after its
// first kCasc entries leave.
template <int N>
__device__ __forceinline__ int win_pos_n(const float (&k)[N], int n,
                                         float key) {
  int pos = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) pos += (i < n && k[i] <= key) ? 1 : 0;
  return pos;
}

template <int N, typename V>
__device__ __forceinline__ void win_drop_casc(V (&w)[N]) {
#pragma unroll
  for (int i = 0; i + kCasc < N; ++i) w[i] = w[i + kCasc];
}

// The replay of one tile (the notes at the top). `done` is the pixel's latch
// to start from (true outside the image, and in K6 where the pixel made no
// commit). Hook:
//   kByPosition          the payload is a stream position (K6), whose
//                        Gaussian id is point_list[start + payload];
//   bool commit(a0, T, d_head, gid, payload)
//                        a head pop that commits (U >= 1e-4, the pixel not
//                        done); true where the pixel's replay ends there;
//   void step_end()      after every step (each emitted entry, each drain
//                        step; in the batched cascade each head blend and
//                        each drain blend), called by every thread of the
//                        warp.
// Returns the pixel's final transmittance.
template <int MID_MAX, int HEAD_MAX, bool BATCHED, class Hook>
__device__ __forceinline__ float replay(const Args& a, const Pixel& p,
                                        Smem<Hook::kByPosition>& sh,
                                        float* s_tail, Hook& hook,
                                        bool done) {
  const float kInf = CUDART_INF_F;
  const int t = threadIdx.x;
  const int s = p.s, l = p.l, r = p.r;
  const int sq = s * kQuads + p.q;
  const unsigned qmask = p.qmask;
  const int kt = a.kt, km = a.km, kh = a.kh;
  const float pfx = static_cast<float>(p.px);
  const float pfy = static_cast<float>(p.py);
  const float st_fx = static_cast<float>(p.st_x);
  const float st_fy = static_cast<float>(p.st_y);

  if (l == 0) {
    view_ray(st_fx + 1.5f, st_fy + 1.5f, a.cam, a.ndc_sx, a.ndc_sy,
             sh.vt[s][0], sh.vt[s][1], sh.vt[s][2]);
  }
  if (r == 0) {
    view_ray(static_cast<float>(p.qd_x) + 0.5f,
             static_cast<float>(p.qd_y) + 0.5f, a.cam, a.ndc_sx, a.ndc_sy,
             sh.vm[sq][0], sh.vm[sq][1], sh.vm[sq][2]);
  }
  view_ray(pfx, pfy, a.cam, a.ndc_sx, a.ndc_sy, sh.vh[0][t], sh.vh[1][t],
           sh.vh[2][t]);

  const int tile = blockIdx.x;
  const int start = a.starts[tile];
  const int count = a.ends[tile] - start;
  const int len = kt + kBatch + 1;
  float* tail_key = s_tail;
  int* tail_pay = reinterpret_cast<int*>(s_tail + 2 * kSub * len);

  // The first hold: kt entries of key -inf.
  int cur = 0;
  for (int h = l; h < kt; h += kSub) {
    tail_key[s * len + kBatch + h] = -kInf;
    tail_pay[s * len + kBatch + h] = 0;
  }

  // Each lane keeps its own copy of its quad's mid window (mid key,
  // payload; empty slots +inf, -1) and its pixel's head window (head depth,
  // alpha, payload; empty slots +inf, 0, 0). The batched cascade's windows
  // have 8 more slots and start as -inf bubbles (payload -1).
  constexpr int MW = BATCHED ? MID_MAX + kCasc : MID_MAX;
  constexpr int HW = BATCHED ? HEAD_MAX + kCasc : HEAD_MAX;
  const float empty_key = BATCHED ? -kInf : kInf;
  float mk[MW];
  int mp[MW];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    mk[i] = empty_key;
    mp[i] = -1;
  }
  float hk[HW], ha[HW];
  int hp[HW];
#pragma unroll
  for (int i = 0; i < HW; ++i) {
    hk[i] = empty_key;
    ha[i] = 0.0f;
    hp[i] = BATCHED ? -1 : 0;
  }
  // The Gaussian id of a payload.
  auto gid_of = [&](int pay) {
    return Hook::kByPosition ? a.point_list[start + pay] : pay;
  };
  int fm = 0, fh = 0;
  float T = 1.0f;

  // The blend decision at the head's front (the pixel is not done): U =
  // T (1 - a) commits where U >= 1e-4, else the pixel is done.
  auto head_blend = [&]() {
    const float a0 = ha[0];
    const float U = T * (1.0f - a0);
    if (U < kTThreshold) {
      done = true;
    } else {
      if (hook.commit(a0, T, hk[0], gid_of(hp[0]), hp[0])) done = true;
      T = U;
    }
  };

  // Pop the head's front (the pixel is not done).
  auto head_pop = [&]() {
    head_blend();
    win_shift(hk, kInf);
    win_shift(ha, 0.0f);
    win_shift(hp, 0);
    --fh;
  };

  // An entry (payload pay; -1 for an empty mid slot) leaves the mid for
  // this pixel's head (head pop first where it is full); its head depth
  // and alpha are computed here. The pixel is not done.
  auto to_head = [&](int pay) {
    const bool full = fh == kh;
    if (full) {
      head_blend();
      if (done) return;
    }
    float d_head = 0.0f, a_eff = 0.0f;
    if (pay >= 0) {
      Rows w;
      load_rows(w, gid_of(pay), a);
      eval_pixel(w, sh.vh[0][t], sh.vh[1][t], sh.vh[2][t], pfx, pfy, d_head,
                 a_eff);
    }
    const int hpay = pay >= 0 ? pay : 0;
    if (full) {
      const int pos = win_pos_popped(hk, d_head);
      win_put_popped(hk, pos, d_head, kInf);
      win_put_popped(ha, pos, a_eff, 0.0f);
      win_put_popped(hp, pos, hpay, 0);
    } else {
      const int pos = win_pos(hk, d_head);
      win_put(hk, pos, d_head);
      win_put(ha, pos, a_eff);
      win_put(hp, pos, hpay);
      ++fh;
    }
  };

  // The batched cascade's blend of an entry of alpha a0 > 0 and head depth
  // d0 (0 where not finite) at a pixel that is not done.
  auto casc_blend = [&](float a0, float d0, int pay) {
    const float U = T * (1.0f - a0);
    if (U < kTThreshold) {
      done = true;
    } else {
      if (hook.commit(a0, T, finite_key(d0) ? d0 : 0.0f, gid_of(pay), pay)) {
        done = true;
      }
      T = U;
    }
  };

  // The batched cascade, once 8 entries have gone into the mid window (km
  // + 8 held): its first 8 go into the head window in order, and the
  // head's first 8 blend, a step each.
  auto casc_emit = [&]() {
    if (!done) {
#pragma unroll
      for (int j = 0; j < kCasc; ++j) {
        const int pay = mp[j];
        float key = mk[j], a_eff = 0.0f;
        if (pay >= 0) {
          Rows w;
          load_rows(w, gid_of(pay), a);
          float d_head;
          eval_pixel(w, sh.vh[0][t], sh.vh[1][t], sh.vh[2][t], pfx, pfy,
                     d_head, a_eff);
          if (finite_key(key)) key = d_head;
        }
        const int pos = win_pos_n(hk, kh + j, key);
        win_put(hk, pos, key);
        win_put(ha, pos, a_eff);
        win_put(hp, pos, pay);
      }
      win_drop_casc(mk);
      win_drop_casc(mp);
    }
#pragma unroll
    for (int j = 0; j < kCasc; ++j) {
      if (!done && ha[j] > 0.0f) casc_blend(ha[j], hk[j], hp[j]);
      hook.step_end();
    }
    win_drop_casc(hk);
    win_drop_casc(ha);
    win_drop_casc(hp);
  };

  // Pop the mid front into the head (drain).
  auto mid_pop = [&]() {
    const int pay = mp[0];
    win_shift(mk, kInf);
    win_shift(mp, -1);
    --fm;
    to_head(pay);
  };

  // One tail round: merge the batch keys in sh.bkey (payloads in sh.pay)
  // with the hold of buffer `cur` into buffer 1 - cur, then run the 64
  // emitted entries through the mid window, a step each.
  auto tail_round = [&](bool drain) {
    const int nxt = 1 - cur;
    const float* hold_k = tail_key + (cur * kSub + s) * len + kBatch;
    const int* hold_p = tail_pay + (cur * kSub + s) * len + kBatch;
    float* out_k = tail_key + (nxt * kSub + s) * len;
    int* out_p = tail_pay + (nxt * kSub + s) * len;
    tail_merge(sh.bkey[s], sh.pay, drain, hold_k, hold_p, out_k, out_p, kt, l);
    cur = nxt;
    __syncthreads();

    const bool quad_live = __any_sync(qmask, !done);
    const int* egid = out_p;
    if constexpr (Hook::kByPosition) {
      for (int e = l; e < kBatch; e += kSub) {
        if (finite_key(out_k[e])) sh.egid[s][e] = a.point_list[start + out_p[e]];
      }
      __syncwarp(0xffffu << (p.lane & 16));
      egid = sh.egid[s];
    }
    if (quad_live) {
      const float vmx = sh.vm[sq][0], vmy = sh.vm[sq][1], vmz = sh.vm[sq][2];
#pragma unroll 2
      for (int i = 0; i < kBatch / kQuads; ++i) {
        const int e = r * (kBatch / kQuads) + i;
        if (finite_key(out_k[e])) {
          const float* qg = a.inv9 + 9 * static_cast<long long>(egid[e]);
          float qv[9];
#pragma unroll
          for (int k = 0; k < 9; ++k) qv[k] = __ldg(qg + k);
          sh.mid[e][sq] = ray_depth(qv, vmx, vmy, vmz);
        }
      }
    }
    __syncwarp(qmask);

    if constexpr (BATCHED) {
      // Ghosts and drain pads go into the mid window keyed -inf. A
      // sub-batch of those alone changes nothing: it and the -inf entries
      // at the holds' fronts (payload -1, alpha 0) trade places, and only
      // -inf entries leave either window. So a warp whose two sub-tiles
      // emit no finite key in a sub-batch skips it, its steps included
      // (no lane commits there).
      for (int e0 = 0; e0 < kBatch; e0 += kCasc) {
        bool any = false;
#pragma unroll
        for (int j = 0; j < kCasc; ++j) any = any || finite_key(out_k[e0 + j]);
        if (!__any_sync(0xffffffffu, any)) continue;
        if (!done) {
#pragma unroll
          for (int j = 0; j < kCasc; ++j) {
            const bool fin = finite_key(out_k[e0 + j]);
            const float d = fin ? sh.mid[e0 + j][sq] : -kInf;
            const int pos = win_pos_n(mk, km + j, d);
            win_put(mk, pos, d);
            win_put(mp, pos, fin ? out_p[e0 + j] : -1);
          }
        }
        casc_emit();
      }
      return;
    }
    for (int e = 0; e < kBatch; ++e) {
      if (!done && finite_key(out_k[e])) {
        const float d = sh.mid[e][sq];
        if (fm == km) {  // a full mid pops its front, then takes the entry
          const int pay = mp[0];
          const int pos = win_pos_popped(mk, d);
          win_put_popped(mk, pos, d, kInf);
          win_put_popped(mp, pos, out_p[e], -1);
          to_head(pay);
        } else {
          const int pos = win_pos(mk, d);
          win_put(mk, pos, d);
          win_put(mp, pos, out_p[e]);
          ++fm;
        }
      }
      hook.step_end();
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
      int pay = 0;
      if (t < n) {
        const int g = a.point_list[start + base + t];
        const float* qg = a.inv9 + 9 * static_cast<long long>(g);
        sh.xy[t] = a.xy[g];
        sh.co[t] = a.conic_opacity[g];
#pragma unroll
        for (int i = 0; i < 9; ++i) sh.q[i][t] = qg[i];
        sh.thr[t] = a.power_thr[g];
        pay = Hook::kByPosition ? base + t : g;
      }
      sh.pay[t] = pay;
    }
    __syncthreads();
    const float vtx = sh.vt[s][0], vty = sh.vt[s][1], vtz = sh.vt[s][2];
    for (int j = l; j < kBatch; j += kSub) {
      float key = -kInf;
      if (j < n) {
        float qv[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) qv[i] = sh.q[i][j];
        const float d_tail = ray_depth(qv, vtx, vty, vtz);
        bool valid = d_tail >= 0.0f;
        if (a.culling && valid) {
          valid = subtile_power(sh.xy[j], sh.co[j], st_fx, st_fy) <= sh.thr[j];
        }
        if (valid) key = d_tail;
      }
      sh.bkey[s][j] = key;
    }
    __syncthreads();
    tail_round(false);
  }
  if (!finished) finished = __syncthreads_and(done);
  if (!finished) {
    for (int d = 0; d < kt; d += kBatch) {
      __syncthreads();
      for (int j = l; j < kBatch; j += kSub) sh.bkey[s][j] = kInf;
      __syncthreads();
      tail_round(true);
    }
    if constexpr (BATCHED) {
      // ceil(km / 8) mid rounds of +inf pads, then the head hold in order.
      for (int d = 0; d < km; d += kCasc) {
        if (!done) {
#pragma unroll
          for (int j = 0; j < kCasc; ++j) {
            const int pos = win_pos_n(mk, km + j, kInf);
            win_put(mk, pos, kInf);
            win_put(mp, pos, -1);
          }
        }
        casc_emit();
      }
#pragma unroll
      for (int j = 0; j < HEAD_MAX; ++j) {
        if (j < kh) {
          if (!done && ha[j] > 0.0f) casc_blend(ha[j], hk[j], hp[j]);
          hook.step_end();
        }
      }
    } else {
      for (int i = 0; i < km; ++i) {
        if (!done && fm > 0) mid_pop();
        hook.step_end();
      }
      for (int i = 0; i < kh; ++i) {
        if (!done && fh > 0) head_pop();
        hook.step_end();
      }
    }
  }
  return T;
}

}  // namespace hier
