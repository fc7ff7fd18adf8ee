// Atomic-free routing of per-pair gradients, shared by the backward kernels
// that replay a per-pixel resort: K4 (kbuffer_blend_bwd.cu) and K6
// (hier_blend_bwd.cu).
//
// A pixel commits pair src at a step of its replay that differs from pixel
// to pixel, so K2's fixed tree at a stream position does not apply. Instead
// each (tile, warp) owns private rows acc[warp][src][9] for every pair of the
// tile's segment, in the tile's own rows [start, end) of its plane of a
// scratch in device memory (one plane a sub-tile of the binning tile, so the
// blend tiles that share a segment share no row), 320 bytes a pair: the pair's xy and conic+opacity (8 floats, read
// at commit time for any src) and the 8 warps' rows of 9 sums, [count][8]
// features then [kWarps][count][kCols] sums, which each kernel zeroes and
// fills before its replay. A lane commits at most once a step. At the step's
// end the committing lanes' 9 terms, staged in shared memory, are folded
// into the rows (Router::step_end): lanes that commit the same pair form a
// group (__match_any_sync), and the lowest lane of each group adds the
// group's terms in ascending lane order, then the sum into the pair's row:
// one independent read-modify-write a distinct pair and step. After the
// replay each kernel adds each pair's 8 warp rows in warp order into
// d_pair[start + src] of the tile's plane. Every slot of the tile is written (zero where no
// pixel committed the pair) and every order is fixed, so two runs give the
// same bits. The plain versions follow the same order
// (kernels/kbuffer_blend.py::_route_grouped and _pair_sums).
//
// On an H100 (PERF.md) rows in shared memory for the segments that fit ran
// slower than this scratch, whose rows of the blocks in flight stay in the
// 50 MB L2, and grouping by one ballot a distinct pair in place of
// __match_any_sync ran slower too.

#pragma once

#include <cuda_runtime.h>

namespace route {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kCols = 9;
// Floats a pair takes in the scratch: 8 of features (xy, pad, conic and
// opacity) and kWarps * kCols of gradient sums.
constexpr int kFeat = 8;
constexpr int kPairFloats = kFeat + kWarps * kCols;

// A lane's routing: its warp's rows and staged terms, and this step's
// commit. A committing lane writes its 9 terms to stage() and calls
// staged(src); every lane of the warp calls step_end() at every step.
struct Router {
  float* acc_warp;    // this warp's rows [count][kCols], by src
  float* stage_warp;  // this warp's staged terms, kCols a lane
  int lane;
  bool committed = false;
  int src = 0;

  __device__ __forceinline__ float* stage() const {
    return stage_warp + lane * kCols;
  }

  __device__ __forceinline__ void staged(int s) {
    committed = true;
    src = s;
  }

  // Warp-wide: fold this step's commits into the warp's rows. Lanes that
  // commit the same pair form a group; its lowest lane sums the group's
  // terms in ascending lane order, then adds the sum into the pair's row.
  __device__ __forceinline__ void step_end() {
    const unsigned m = __ballot_sync(0xffffffffu, committed);
    if (m == 0u) return;
    __syncwarp();
    if (committed) {
      const unsigned group = __match_any_sync(m, src);
      if ((group & ((1u << lane) - 1u)) == 0u) {
        float sum[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) sum[c] = stage_warp[lane * kCols + c];
        unsigned rest = group & (group - 1u);
        while (rest) {
          const int o = __ffs(rest) - 1;
          rest &= rest - 1u;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            sum[c] = sum[c] + stage_warp[o * kCols + c];
          }
        }
        float* row = acc_warp + src * kCols;
#pragma unroll
        for (int c = 0; c < kCols; ++c) row[c] = row[c] + sum[c];
      }
      committed = false;
    }
    __syncwarp();
  }
};

}  // namespace route
