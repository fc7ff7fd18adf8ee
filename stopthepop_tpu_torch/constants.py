"""Numerical constants shared by the whole port.

A copy of ``stopthepop_tpu/constants.py`` (the port imports nothing of the
JAX package).

These mirror the reference implementation's thresholds exactly so that images
and gradients are comparable (reference: cuda_rasterizer/auxiliary.h:21-23,
cuda_rasterizer/forward.cu:152-161, forward_common.h:113,
stopthepop/stopthepop_common.cuh:19,448).
"""

# Tile (block) size in pixels. Reference: cuda_rasterizer/config.h:16-17.
TILE_X = 16
TILE_Y = 16
TILE_PIXELS = TILE_X * TILE_Y

# Alpha-blending thresholds. Reference: auxiliary.h:21-23, forward.cu:323-331.
ALPHA_THRESHOLD = 1.0 / 255.0
ALPHA_MAX = 0.99
T_THRESHOLD = 1.0e-4

# EWA dilation (low-pass filter) variance. Reference: forward_common.h:113.
DILATION_H_VAR = 0.3
# Mip-Splatting convolution-scaling numerical floor. forward_common.h:123.
EWA_DET_FLOOR = 0.000025

# Gaussian extent in standard deviations (sqrt of chi-square bound).
# Reference: forward.cu:156 (3.33 = default, tight bound = sqrt(2 ln(a/eps))).
EXTENT_SIGMA = 3.33
MIN_LAMBDA = 0.01

# Frustum near-plane cull. Reference: auxiliary.h:226 (p_view.z <= 0.2).
NEAR_Z = 0.2

# View-frustum tangent clamp for the EWA Jacobian. forward_common.h:81-82.
FOV_CLAMP = 1.3

# Inverse-covariance scale floor. stopthepop_common.cuh:19-21.
INV_COV_SCALE_FLOOR = 1.0e-3
# depthAlongRay denominator floor. stopthepop_common.cuh:52.
RAY_DEPTH_DEN_FLOOR = 1.0e-5

# Per-tile depth bias; keeps per-tile depths positive so that they sort
# correctly as unsigned bit patterns. stopthepop_common.cuh:448.
PER_TILE_DEPTH_BIAS = 8.0

# world2ndc homogeneous epsilon. auxiliary.h:86.
NDC_W_EPS = 1.0e-7

# Sentinel tile id for unissued duplication slots (sorts after all real
# tiles). Reference: config.h INVALID_TILE_ID / stopthepop_common.cuh:507.
INVALID_TILE_ID = 0x7FFFFFFF

# Default capacity multiplier for the static duplication buffer:
# capacity = ceil(PAIR_CAPACITY_FACTOR * P) unless overridden.
PAIR_CAPACITY_FACTOR = 16

# Batch size of the hierarchical tail's sort+merge window (entries consumed
# per tail round; the reference's analogous batcher cadence is 32,
# hierarchical_render.cuh:158-192 — 64 here fills half a stream chunk).
TAIL_BATCH = 64
# Sub-batch of the HIERARCHICAL batched cascade: the entries a mid or head
# round sorts into its window at once (JAX kernels/hier_blend.py's
# CASC_BATCH default); divides TAIL_BATCH.
CASC_BATCH = 8
