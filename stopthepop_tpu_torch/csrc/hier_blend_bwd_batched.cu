// K6 with HIER's batched cascade: the kernel of hier_blend_bwd.cu at the
// BATCHED cadence of hier_common.cuh, with the C entry points
// stp_hier_blend_bwd_batched and stp_hier_blend_bwd_batched_occupancy (the
// interface of stp_hier_blend_bwd). A source of its own, so that
// kernels/build.py compiles its nine instantiations in an nvcc process
// beside the per-entry ones.

#define STP_HIER_BATCHED
#include "hier_blend_bwd.cu"
