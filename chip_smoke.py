#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (stopthepop_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --profile  # and a torch.profiler trace of 3
                                     # training steps in each mode (phases
                                     # train_profile, train_kb_profile,
                                     # train_hier_profile)
    python3 chip_smoke.py --tile-only      # the build and phase 23 alone;
                                           # no last line
    python3 chip_smoke.py --parallel-only  # the build and phase 24 alone,
                                           # one rank per card (a host of
                                           # several cards); no last line
    python3 chip_smoke.py --cascade-only   # the build and phase 25 alone;
                                           # no last line
    python3 chip_smoke.py --io-only        # phase 26 alone (no CUDA
                                           # kernel is built); no last line
    python3 chip_smoke.py --preprocess-only  # the build and phase 27
                                             # alone; no last line
    python3 chip_smoke.py --full-only  # the build and phase 15's K7 at
                                       # FULL_SHAPES alone; no last line
    python3 chip_smoke.py --pairs-only  # the build and phase 28 alone;
                                        # no last line

Phases, one JSON line each; any failure exits non-zero:
  1. build: compile every CUDA kernel of the port with nvcc (in parallel);
     registers and spills per instantiation (ptxas), and for K5 and K6 the
     resident blocks per SM of each instantiation at tail sizes 64 and 512;
     then the host PNG and PLY codecs with g++ (host_build_s).
  2. kernel: hold kernel K1 (GLOBAL blend, forward) against its plain PyTorch
     version on the card — a 70x45 random scene, phase 11's deep-segment
     scene and the full 1920x1080 frame of the 500K-Gaussian bench scene
     (every output bitwise equal) — and time both; the share of (warp,
     pair) steps K1's footprint test keeps and the plain version's
     warp-step counts at 1080p, K1's bound over the evaluations it keeps
     and over all of them; K1's registers, spills and blocks an SM.
  3. main: save a 500K-Gaussian model as PLY, load it back, render 4
     orbit frames at 1920x1080 through render/cli.py::render_frames (GLOBAL,
     Z_DEPTH, rect + tight-opacity culling) under inference_mode; every frame
     finite and not background, ~1M+ pairs a frame, K1 and the preprocess
     kernel K8 (no gradient is wanted) launched exactly once per frame and
     no other kernel. Then a per-stage breakdown of one frame (CUDA events;
     preprocess by K8 and by its plain version). Every serving path below
     (phases 8, 12, 16, 19-21, 23-25) launches K8 once a frame as well, and
     every training step none.
  4. kernel_bwd: hold kernel K2 (GLOBAL blend, backward) against its plain
     version on the same two scenes and phase 11's deep-segment scene with
     seeded random cotangents (each of the 9 per-pair gradient columns
     within 1e-4 of that column's largest value); two K2 launches and two
     full BlendGlobal backward passes bitwise equal; time K2 and its plain
     version; the share of (warp, pair) steps K2's footprint test keeps and
     the plain version's warp-step counts at 1080p; K2's registers, spills
     and blocks an SM.
  5. train: the training path at full width — the bench model, the bench
     camera at 1920x1080, a seeded random target, one warm-up step and 5
     timed steps of train/trainer.py's step (K1, K2, L1 + D-SSIM, per-group
     Adam); loss finite and falling, every gradient finite and nonzero
     somewhere, K1 and K2 launched once a step and no other kernel. Then a
     per-stage breakdown (forward, backward, optimizer; and the loss's own
     forward and backward; CUDA events). With --profile, a torch.profiler
     trace of 3 more steps:
     device busy time, idle share and the kernels that take the most time.
  6. train_cli: the training CLI at small size in GLOBAL (asked for: the
     CLI defaults to HIER; at its default binning tile there, 32x16) — a
     NeRF-synthetic dataset of 8 renders of the
     procedural scene at 200x200, a few hundred iterations of
     train/cli.py::main with densification and an opacity reset; eval PSNR
     rises, the Gaussian count changes, the PLY loads, only K1 and K2
     launch, and K8 once for each evaluation frame.
  7. kernel_kb: hold kernel K3 (PER_PIXEL_KBUFFER blend, forward) against
     its plain version — phase 2's 70x45 scene and a denser draw of it and
     phase 11's deep-segment scene with windows k = 1, 4, 8 and 24, and the
     1080p/500K bench frame with k = 4 (every output bitwise equal) — and
     time both; the share of (warp, pair) steps K3's footprint test keeps,
     the plain version's warp-step counts and the rounds of K3's second
     phase at 1080p; K3's registers, spills and blocks an SM at MAX_K = 4.
  8. main_kb: render 4 orbit frames of the 500K model at 1920x1080 through
     render/cli.py::render_frames in PPX_KBUFFER (k = 4); every frame finite
     and not background, K3 launched exactly once a frame and K1, K2, K4 not
     at all. Then a per-stage breakdown of one frame.
  9. kernel_kb_bwd: hold kernel K4 (k-buffer backward) against its plain
     version on the same scenes and on phase 11's deep-segment scene at
     k = 4 (bitwise equal; each gradient column also within 1e-4 of its
     largest value); two K4 launches and two full BlendKBuffer backward
     passes bitwise equal; time K4 and its plain version; its registers,
     spills, shared memory a block and blocks an SM at MAX_K = 4.
 10. train_kb: 5 training steps at 1080p/500K in PPX_KBUFFER; loss finite and
     falling, every gradient finite and nonzero somewhere, K3 and K4 once a
     step, no other kernel; step time and a per-stage breakdown.
 11. kernel_hier: hold kernel K5 (HIERARCHICAL blend, forward) against its
     plain version — phase 7's two 70x45 scenes with queues (tile_4x4,
     tile_2x2, per_pixel) = (64, 8, 4), (16, 8, 4), (8, 4, 2) and
     (256, 20, 16), and (16, 8, 4) with hierarchical 4x4 and tile-based
     culling, a 32x32 scene of 4 tiles whose segments hold >= 2,000 pairs
     each at (64, 8, 4), then the 1080p/500K bench frame at (64, 8, 4)
     (every output bitwise equal, n_contrib exactly) — and time both.
 12. main_hier: render 4 orbit frames of the 500K model at 1920x1080 through
     render/cli.py::render_frames in HIER (default queues 64, 8, 4); every
     frame finite and not background, K5 launched exactly once a frame and
     K1-K4 not at all. Then a per-stage breakdown of one frame.
 13. kernel_hier_bwd: hold kernel K6 (HIERARCHICAL backward) against its
     plain version — phase 11's two scenes and queue cases and (32, 12, 8),
     so that three of K6's nine instantiations launch, phase 11's
     deep-segment scene, and the 1080p/500K
     frame at (64, 8, 4) (each gradient column within 1e-4 of its largest
     value, and bitwise equal); two K6 launches and two full BlendHier
     backward passes bitwise equal; time K6 and its plain version.
 14. train_hier: 5 training steps at 1080p/500K in HIER (64, 8, 4); loss
     finite and falling, every gradient finite and nonzero somewhere, K5 and
     K6 once a step, K1-K4 not at all; step time and a per-stage breakdown.
 15. kernel_full: hold kernel K7 (PER_PIXEL_FULL, the exact per-pixel sort,
     forward only) against its plain version — phase 7's two 70x45 scenes
     and the clone trap scene (32x32: bit-identical clones, pixels with
     more than three lists of actives), phase 11's deep-segment scene, then
     the 1080p/500K bench frame (every output bitwise equal) — and time
     both; K7's bound from the plain version's counts, its list length,
     its passes (rounds) per tile, its registers, spills, shared memory a
     block and blocks an SM. Then K7 at the benchmark's PER_PIXEL_FULL
     configuration (portbench/configs/db-playroom-full.json: 2.3M
     Gaussians at 1264x832 on 16x16 bins, ~4.9M pairs a frame), at three
     orbit cameras: every output bitwise equal to the plain version's, the
     device pass counter equal to the plain version's count and its tiles
     to the grid's, and at the first camera K7's time, the plain version's
     and K7's bound; one line a configuration. Also the
     API's full_mode="auto" rule on the card: a 70x45 scene through
     GaussianRasterizer takes K7 under no_grad and the dense oracle when
     asked for gradients, and the two agree.
 16. main_full: render 4 orbit frames of the 500K model at 1920x1080 through
     render/cli.py::render_frames in PPX_FULL (the API's auto rule takes K7
     at this size); every frame finite and not background, K7 launched
     exactly once a frame and K1-K6 never. Then a per-stage breakdown of
     one frame.
 17. quality: frame 0 of the orbit in the 8 cases of benchmarks/quality.py
     (GLOBAL Z_DEPTH, PTD_CENTER, PTD_MAX; KBUFFER k = 4, 16; PTD_MAX +
     KBUFFER k = 4; HIER 64/8/4 and 16/8/4 with PTD_MAX), each against the
     K7 FULL render of the same frame: PSNR, mean and max absolute
     difference of the images clipped to [0, 1]; one line a case.
 18. train_batched: train/trainer.py::make_batched_train_step on the bench
     model, 4 orbit cameras at 1080p with seeded random targets, GLOBAL:
     its gradients equal the mean of 4 single-camera gradients (1e-5 of
     each tensor's largest value), then 3 timed steps with K1 and K2
     launched 4 times a step and no other kernel; the loss finite and
     falling; ms per step and per camera against phase 5's step; peak
     memory.
 19. colmap: a COLMAP capture written with the port's writers (16 PNG
     renders of the bench model at 1237x822, a points3D of 100K of its
     means); train/cli.py::main on it for 100 iterations in its default
     mode, HIER (K5, K6): eval PSNR rises, the PLY loads; render/cli.py
     renders its 16 views in PPX_KBUFFER (K3).
 20. debug_viz: Depth, Transmittance, GaussianCountPerPixel and
     GaussianCountPerTile at 1080p/500K through GaussianRasterizer in
     GLOBAL, PPX_KBUFFER, HIER and PPX_FULL (K1, K3, K5, K7 once a render):
     each field is the render's own full_output quantity to the bit and the
     image its colormap; render_depth=True through render_frames; both
     sort-error modes on the 70x45 and the deep 32x32 scenes against the
     same maps on the CPU (1e-5), and the k-buffer and HIER oracles'
     sort-error means there.
 21. timed: render/pipeline.py::render_tiled_timed with StageTimer(interval
     2), 4 frames at 1080p/500K: the image bitwise render_tiled's, the four
     stage times per interval; utils/profiling.py::trace of one frame names
     K1's kernel.
 22. snapshot: a debug=True render with bad inputs raises and writes a
     snapshot_fw equal to the inputs; a good one is bitwise the plain render.
 23. tile: the binning tile (render/pipeline.py), 32x16 (bench.py's and the
     training CLI's GLOBAL default) beside 16x16. (a) A 70x45 scene at
     32x16 (five 16x16 columns: the right column of binning tiles has no
     second half): K1, K3, K5 and K7 on the split segments bitwise equal
     to their plain versions, K2, K4 and K6 with two gradient planes
     against theirs (K2 within 1e-4 of each column's largest value, K4
     and K6 bitwise; two launches bitwise; the rows no tile reads zero).
     (b) The same at the 1080p/500K bench frame, with the plain versions'
     counts (K1's and K2's footprint-kept shares, the bounds at 32x16)
     and each kernel's time at 32x16; K2, K4 and K6 with one plane of an
     all-zero sub-tile map bitwise their calls without a map at 16x16.
     (c) The GLOBAL image at 32x16 within 5e-5 of the 16x16 one and each
     parameter's gradient within 1e-4 of its largest value; two full
     backward passes at 32x16 bitwise. (d) The serving path (4 orbit
     frames) and the training step (5 steps) in GLOBAL at 16x16 and
     32x16, the steps in PPX_KBUFFER and HIER and the PPX_FULL frames at
     32x16, and GLOBAL steps at 24x16 and 8x8: pairs, frame and step ms and
     stages, launches, peak memory, each path with the launch counts set to
     0 just before it. (e) GLOBAL at bins whose sides are not multiples of
     16, cut into pieces of at most 16x16 (20x12 on the 70x45 scene, 24x16
     and 8x8 on the bench frame): K1 on the pieces bitwise its plain
     version, and its image and final T bitwise the 16x16 grid's; K2 with
     its planes within 1e-4 of each column's largest value of its plain
     version, two launches bitwise; at 1080p the plain versions' counts,
     K1's and K2's times and bounds, and the API's image bitwise the 16x16
     one.
 24. parallel: the multi-device layer (stopthepop_tpu_torch/parallel/), one
     process per card through parallel/hosts.py::launch (spawned, NCCL, a
     file store); a rank that fails fails the phase. Each rank, on the bench
     model: (a) one ("data", "gauss") step, each rank with a target of its
     own, against the single-device step with the same Adam on the mean
     loss over every rank's target (loss within 1e-5, gradients within 1e-4
     of each tensor's largest value, updated parameters within 1e-5 where
     the mean gradient is not within rounding of 0; bitwise with one rank),
     then 3 timed steps; (b) make_spatial_render of the 4 orbit
     frames in GLOBAL, PPX_KBUFFER (k = 4) and HIER (64, 8, 4) against the
     single-device renders (1e-5 GLOBAL, 1e-4 resort modes) and one
     spatial step in each of the three modes (loss within 2e-5, each
     gradient within 1e-4 of its tensor's largest value); (c) the same
     renders with make_ring_render and one ring GLOBAL step; the stages of
     a band frame in each mode (preprocess, all-gather, pairs, render_band,
     gather_bands) beside the single-device frame's, and render_band of an
     empty band at the image's size and at the band's (CUDA events); the
     collectives at the paths' shapes (CUDA events).
     Rank 0 also holds the collective-free cores with 4 bands and 4 shards
     on one card (render_band; ring_step and ring_blend in ring order),
     stitched, against the full render in GLOBAL (1e-5) and HIER (1e-4).
     Every path with the launch counts set to 0 just before it and read
     just after (K1, K3 or K5 once a band and frame; the forward and
     backward kernels once a step); ms a frame and a step, peak memory a
     rank.
 25. cascade: HIER's batched cascade (batched_cascade=True). (a) K5 and K6
     batched against their plain versions, bitwise (K6 also two launches
     bitwise), on phase 7's two 70x45 scenes at queues (64, 8, 4),
     (16, 5, 3), (8, 4, 2), (256, 20, 16) and (16, 8, 4) with hierarchical
     4x4 and tile-based culling, the deep 32x32 scene, the clone trap scene
     at (16, 8, 4), and (b) the 1080p/500K bench frame at (64, 8, 4), with
     each case's largest difference from the per-entry image (some case
     must differ); at 1080p also two full BlendHier backward passes
     bitwise, the times of K5 and K6 batched and per-entry and of their
     plain versions, the bounds from the plain versions' counts, and the
     batched instantiations' registers, spills and blocks an SM. (c) 4
     orbit frames through the API, batched and per-entry (K5 once a frame),
     (d) the PSNR against the FULL render of frame 0 of HIER 64/8/4 and
     16/8/4 (PTD_MAX), batched and per-entry, as phase 17 renders them, and
     (e) 5 training steps with the batched cascade (K5 and K6 once a step),
     each path with the launch counts set to 0 just before it.
 26. io: the native capture IO (io/images.py, io/ply.py over
     native/{png_io,ply_io}.cpp, built with g++ at first use) against its
     plain versions on the card's host. COLMAP_VIEWS frames at COLMAP_W x
     COLMAP_H RGB and as many at 800x800 RGBA (NeRF-synthetic), their rows
     cycling through the five PNG filter types with Paeth the most common
     (utils/testing.py::filtered_png), read through read_png_batch (native,
     8 threads), read_png one by one and _read_png_python: every image equal
     to the one written, to the bit; seconds of each and per image. The
     bench model saved with save_gaussian_model (500K Gaussians, SH degree
     3, 62 properties) and read with read_ply (8 threads) and
     _read_ply_numpy, equal to the bit; seconds of each. No kernel launches.
 27. kernel_preprocess: hold kernel K8 (the per-Gaussian preprocess,
     forward, render/preprocess.py::preprocess where no gradient is
     wanted) against preprocess_plain on the same inputs, every field of
     every row bitwise, culled rows included (NaN equal to NaN), and K8
     launched once a call. A small scene of 24,576 Gaussians (rows behind
     the near plane, opacities under 1/255, thin Gaussians whose dilated
     determinant is 0: the line counts them) in 27 cases: every setting of
     rect bounding, tight-opacity bounding and proper EWA scaling in Z and
     DISTANCE order, SH degree 0-3 in rows of 16 and of (degree + 1)^2
     coefficients, colors_precomp, bins of 32x16 and 24x16, a scale
     modifier of 0.7. Then the 1080p/500K serving frame and the
     benchmark's three configurations (portbench/configs: 6.1M Gaussians
     at 1237x822 on 16x16 bins, 2.54M at 979x546 on 32x16, 2.3M at
     1264x832 on 16x16), each at three
     orbit cameras; at the first, K8's and the plain version's mean ms
     over 20 launches and K8's share of its bytes bound (368 B a Gaussian
     at SH degree 3, read and written once).
     Every launch check of the run counts the pair stream's two kernels
     (kernels/pairs.py) too: once a forward blend wherever the pairs are
     built in Z_DEPTH without tile-based culling, never in the train CLI's
     runs, which cull by tile.
 28. kernel_pairs: hold the pair stream's kernels (kernels/pairs.py:
     duplicate_with_keys, CUB's scan and radix sort, identify_tile_ranges;
     render/duplicate.py::build_pairs for CUDA tensors in Z_DEPTH and
     DISTANCE without tile-based culling) against the torch path
     (expand_pairs, sort_expanded), every PairBuffer field bitwise (floats
     by their bits; the torch path is the plain version), with one launch
     of each wrapper a call; at the benchmark's three
     configurations (6.1M Gaussians at 1237x822 on 16x16 bins, 2.54M at
     979x546 on 32x16, 2.3M at 1264x832 on 16x16) and three orbit cameras
     in Z_DEPTH, DISTANCE at the first; then once more with the model's
     leaves requiring grad (the training step's preprocess), and with a
     quarter of the grid's columns emptied (every Gaussian whose rect
     starts there touching no tile): the largest tile's range and the
     empty tiles are in the line, and each case's largest difference of
     any field. At the first camera: the kernels' call and the torch
     path's ms, and each kernel's device
     ms (torch.profiler: the two of csrc/pairs.cu, CUB's scan and sort)
     beside its bytes over 3.35 TB/s. Then the wrappers' launches in 2
     frames through render/cli.py::render_frames and, but in
     PER_PIXEL_FULL, in 1 training step, in the configuration's sort mode
     (HIER, GLOBAL, PER_PIXEL_FULL): one of each a frame and a step.
 29. the kernels line: each ported kernel with its launches on its main
     path (the training steps of phase 5 for K1/K2, of phase 10 for K3/K4
     and of phase 14 for K6, the HIER frames of phase 12 for K5, the FULL
     frames of phase 16 for K7, the frames of phase 3 for K8; for the pair
     stream's kernels the frames of phases 3, 8, 12 and 16 and the steps
     of phases 5, 10 and 14, each counted from 0), its error
     against the plain version, its time, the plain version's time and its
     bound on this card (K8's at the 1080p frame, at the benchmark's
     configurations under "at_shapes"; K7's at its PER_PIXEL_FULL
     configuration under "at_shapes", with the passes a tile at each
     camera); under
     "at_tile" its time, error and launches at 32x16 (phase 23's steps,
     the FULL frames for K7) and, for K1, K2, K4 and K6, its bound there,
     and for K1 and K2 the same at 24x16 and 8x8 (phase 23's steps); under
     "batched" K5's and K6's with the batched cascade (phase 25's frames
     for K5, its steps for K6).
The line before the last is the card's name and power limit from nvidia-smi;
the last line is {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package. Without a CUDA device
it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
WIDTH, HEIGHT, NUM_GAUSSIANS, FRAMES = 1920, 1080, 500_000, 4
MIN_PAIRS = 900_000  # the bench scene emits ~1.28M pairs a frame at 1080p
ATOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor) op/s.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# Operations counted per (pixel, pair) alpha evaluation of K1 (dx, dy and the
# quadratic form) and per blend (w, three colour and one depth update);
# expf, min and compares are not counted, so the bound stays a lower bound.
OPS_PER_EVAL, OPS_PER_BLEND = 11, 9
# K2 replays each evaluation as K1 does (11), counted only in the warps its
# footprint test keeps (the rest need none), and per blend forms the alpha
# gradient and the nine per-pair terms (36 operations) and adds them into
# the nine per-pair sums (9).
OPS_PER_BLEND_BWD = 45
K2_RTOL = 1e-4  # of each gradient column's largest magnitude
# K3 evaluates each (pixel, pair) alpha as K1 does (11), counted only in the
# warps its footprint test keeps; for the pairs that pass the alpha tests,
# the ray depth: u . d (5) and d^T Sigma^-1 d (18) and the divide (1). Each
# insert takes k compares and k selects for each of the 5 window fields
# (6 k); each commit w, three colour and one depth update, the new T and the
# count (10). The floor, the min and the tests are not counted.
OPS_PER_DEPTH, OPS_PER_INSERT_SLOT, OPS_PER_COMMIT = 24, 6, 10
# K4 replays K3's evaluations, depths and inserts (its window holds 4
# fields, counted as K3's 5) and per commit forms the alpha gradient and the
# nine terms and adds them into the pair's sums (45, as K2). K6 replays K5's
# events and takes the same 45 for each commit with alpha > 0.
OPS_PER_COMMIT_BWD = 45
KB_K = 4           # the default SortQueueSizes.per_pixel
KB_SMALL_KS = (1, 4, 8, 24)
# K5, per (stream position, sub-tile) of a live tile: the tail key, a ray
# depth (24); per entry placed by a tail merge, at least one operation (1).
# Per (emitted entry, pixel): the alpha (11) and the head ray depth (24).
# Per (emitted entry, quad), once for the quad's 4 pixels although K5 does
# it in each lane: the mid ray depth (24) and the mid insert, km compares
# and km selects for each of the 4 window fields (5 km). Per (mid pop,
# pixel), the head insert (4 kh: 3 fields). Per commit with alpha > 0, as
# K3 (10); pops that add nothing are not counted. The merge's ranking
# compares, the pops' shifts and the tests are not counted.
OPS_PER_TAIL_KEY, OPS_PER_TAIL_SLOT, OPS_PER_HIER_EVAL = 24, 1, 35
OPS_PER_MID_SLOT, OPS_PER_HEAD_SLOT = 5, 4
HIER_QUEUES = (64, 8, 4)  # the default SortQueueSizes
# (queues, hierarchical 4x4 and tile-based culling) on the 70x45 scenes.
HIER_SMALL_CASES = (((64, 8, 4), False), ((16, 8, 4), False),
                    ((8, 4, 2), False), ((256, 20, 16), False),
                    ((16, 8, 4), True))
# K6 also at (32, 12, 8): with the cases above, three of its nine
# instantiations (MID_MAX, HEAD_MAX) = (8, 4), (12, 8), (20, 16) launch.
HIER_BWD_EXTRA_CASES = (((32, 12, 8), False),)
# K5 and K6 on deep segments: random_scene(22, 4000, extent=0.5) at 32x32
# (4 tiles), every tile's segment at least HIER_DEEP_MIN pairs, so that hold
# entries stay through many tail batches; at HIER_QUEUES.
HIER_DEEP_SIZE, HIER_DEEP_MIN = 32, 2000
# K7, as K3 per evaluation and ray depth; per pair of actives compared by
# the sort, log2(n!) for a pixel's n actives (the fewest compares that sort
# them), one operation; per sorted entry the blend reads, the running sum's
# add; per commit as K3 (10). log1pf and expf are not counted.
OPS_PER_SORT_COMPARE, OPS_PER_BLENDED = 1, 1
TRAIN_STEPS = 5
# The training CLI's run: a NeRF-synthetic dataset of CLI_VIEWS renders of
# a CLI_SCENE-Gaussian procedural scene at CLI_SIZE x CLI_SIZE.
CLI_ITERS, CLI_VIEWS, CLI_SIZE, CLI_SCENE, CLI_INIT = 300, 8, 200, 20_000, 2_000
# The batched training step: BATCH orbit cameras a step, BATCH_STEPS timed.
BATCH, BATCH_STEPS = 4, 3
# The COLMAP capture: COLMAP_VIEWS views at the size of MipNeRF-360
# bicycle's images_4, a points3D of COLMAP_POINTS, COLMAP_ITERS iterations.
COLMAP_VIEWS, COLMAP_W, COLMAP_H = 16, 1237, 822
COLMAP_POINTS, COLMAP_ITERS = 100_000, 100
# Phase io: frames at NeRF-synthetic's 800x800 RGBA beside the COLMAP size;
# each frame's rows take these filter types in turn (Paeth the most common,
# as libpng's adaptive filters pick them); the PLY reader's threads.
IO_RGBA, IO_FILTERS, IO_PLY_THREADS = 800, (4, 4, 1, 4, 2, 4, 3, 0), 8
TIMED_FRAMES = 4
# Phase parallel: bands and shards of the collective-free cores on one card
# (check d), and the ring's per-step pair capacity (the bench frame has
# ~1.28M pairs a frame, so no step overflows it).
PAR_BANDS, RING_CAPACITY = 4, 4_000_000
# Phase tile: the binning tile of bench.py's and the training CLI's GLOBAL
# default, and the fewest pairs a bench frame must emit at it (~0.83M
# expected, 1.28M at 16x16).
TILE, MIN_PAIRS_TILE = (32, 16), 500_000
# GLOBAL bins whose sides are not multiples of 16 (cut into pieces of at most
# 16x16): on the bench frame, and on the 70x45 scene.
ODD_TILES, ODD_SMALL_TILE = ((24, 16), (8, 8)), (20, 12)
# Phase cascade: HIER's batched cascade on the 70x45 scenes at these
# (queues, hierarchical 4x4 and tile-based culling); (16, 5, 3) has a mid
# window that is no multiple of the sub-batch of 8.
CASC_SMALL_CASES = (((64, 8, 4), False), ((16, 5, 3), False),
                    ((8, 4, 2), False), ((256, 20, 16), False),
                    ((16, 8, 4), True))
# The sort-mode cases of phase quality that the batched cascade renders too.
CASC_QUALITY = (("HIER 64/8/4", (64, 8, 4)), ("HIER 16/8/4", (16, 8, 4)))
# Phase kernel_preprocess: K8 at the serving frame and at the benchmark's
# configurations (portbench/configs: MipNeRF-360 bicycle, Tanks and Temples
# truck, Deep Blending playroom) as (case, Gaussians, width, height, binning
# tile), SH degree 3, rect and tight-opacity culling, at PREP_THETAS_DEG
# orbit cameras (fov 60); PREP_ITERS launches timed; a small scene of
# PREP_SMALL Gaussians for the edge cases. Phase kernel_full holds K7 at the
# benchmark's PER_PIXEL_FULL configurations, FULL_SHAPES, at the same
# cameras.
PLAYROOM = ("db-playroom-full", 2_300_000, 1264, 832, (16, 16))
PREP_SHAPES = (("1920x1080, 500K Gaussians", NUM_GAUSSIANS, WIDTH, HEIGHT,
                (16, 16)),
               ("m360-bicycle-hier", 6_100_000, 1237, 822, (16, 16)),
               ("tandt-truck-global", 2_540_000, 979, 546, (32, 16)),
               PLAYROOM)
FULL_SHAPES = (PLAYROOM,)
PREP_THETAS_DEG, PREP_ITERS, PREP_SMALL = (0.0, 120.0, 240.0), 20, 24_576
# Bytes K8 moves a Gaussian besides its SH rows ((degree + 1)^2 x 12 B):
# the mean, opacity, scales and rotation read, PreprocessOutput's 15 fields
# written. Its few hundred operations a Gaussian take under a tenth of the
# bytes' time, so the bytes bound it.
PREP_BYTES_READ, PREP_BYTES_WRITTEN = 12 + 4 + 12 + 16, 132
# Phase kernel_pairs: the pair stream's kernels (kernels/pairs.py) at the
# benchmark's configurations, each in its sort mode for the frames and steps
# that count the launches; PAIRS_ITERS calls timed. Bytes a Gaussian of the
# scan (count read, offset written) and of the expansion (count, rect,
# depth, offset read); a pair's bytes written by the expansion (key, slot,
# the slot's Gaussian), moved by each radix pass (key and slot, read and
# written) and by the sort's histogram (key read), read (key, slot, its
# Gaussian) and written (tile, depth, Gaussian, int64 slot) by the last
# pass; a tile's range bytes.
PAIRS_SHAPES = (("m360-bicycle-hier", 6_100_000, 1237, 822, (16, 16), "HIER"),
                ("tandt-truck-global", 2_540_000, 979, 546, (32, 16),
                 "GLOBAL"),
                (*PLAYROOM, "PPX_FULL"))
PAIRS_ITERS = 20
PAIRS_SCAN_BYTES, PAIRS_GAUSS_BYTES = 4 + 8, 4 + 8 + 4 + 4 + 8
PAIRS_DUP_BYTES, PAIRS_PASS_BYTES, PAIRS_HIST_BYTES = 16, 24, 8
PAIRS_LAST_READ, PAIRS_LAST_WRITTEN, PAIRS_TILE_BYTES = 16, 20, 8


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, phase, msg):
    if not cond:
        print(json.dumps({"phase": phase, "ok": False, "error": msg}),
              file=sys.stderr, flush=True)
        sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def blend_args(prep, pairs):
    return (pairs.gauss_id, pairs.starts, pairs.ends, prep.mean2d.contiguous(),
            prep.conic_opacity.contiguous(), prep.rgb.contiguous(),
            prep.depth.contiguous())


def binned_pairs(prep, tile, tile_based_culling=False, width=None,
                 height=None):
    """The pairs of ``prep`` (a ``width`` x ``height`` frame, by default
    the bench frame) on the grid of the binning tile ``tile``: (pairs, the
    same pairs with the 16x16 blend tiles' ranges, render/pipeline.py's
    BlendSegments of the split)."""
    from stopthepop_tpu_torch.render.duplicate import build_pairs
    from stopthepop_tpu_torch.render.pipeline import (
        split_binning_segments,
        tile_grid,
    )

    width = WIDTH if width is None else width
    height = HEIGHT if height is None else height

    bgx, bgy = tile_grid(width, height, *tile)
    pairs = build_pairs(prep, grid_x=bgx, grid_y=bgy,
                        tile_based_culling=tile_based_culling,
                        tile_x=tile[0], tile_y=tile[1])
    segs = split_binning_segments(pairs.starts, pairs.ends, width, height,
                                  *tile)
    return pairs, pairs._replace(starts=segs.starts, ends=segs.ends), segs


def prepare_binned(scene_or_model, cam, width, height, tile,
                   tile_based_culling=False):
    """Preprocess at the binning tile ``tile`` and build its pairs:
    (prep, pairs, pairs with the blend tiles' ranges, BlendSegments, the
    blend grid's keywords)."""
    from stopthepop_tpu_torch.render.pipeline import tile_grid
    from stopthepop_tpu_torch.render.preprocess import preprocess

    m = scene_or_model
    prep = preprocess(
        m["means3d"], m["opacities"], scales=m["scales"],
        rotations=m["rotations"], shs=m["shs"],
        viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        campos=cam.campos, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        image_width=width, image_height=height, sh_degree=3,
        rect_bounding=True, tight_opacity_bounding=True,
        tile_x=tile[0], tile_y=tile[1],
    )
    pairs, view, segs = binned_pairs(prep, tile, tile_based_culling, width,
                                     height)
    gx, gy = tile_grid(width, height)
    return prep, pairs, view, segs, dict(grid_x=gx, grid_y=gy, width=width,
                                         height=height)


def prepare(scene_or_model, cam, width, height, tile_based_culling=False):
    """prepare_binned at 16x16 bins: (prep, pairs, the blend grid's
    keywords)."""
    prep, pairs, _, _, kw = prepare_binned(
        scene_or_model, cam, width, height, (16, 16), tile_based_culling)
    return prep, pairs, kw


def model_arrays(model):
    return {"means3d": model.means3d, "opacities": model.opacities(),
            "scales": model.scales(), "rotations": model.rotations_normalized(),
            "shs": model.shs()}


def compare_kernel(name, args, kw, *, count_evaluations=False):
    """K1 against its plain version on the same inputs, to the bit; returns
    stats (with ``count_evaluations`` also the plain version's counts and
    warp counts)."""
    from stopthepop_tpu_torch.kernels.global_blend import (
        blend_global_forward,
        blend_global_forward_plain,
    )

    before = blend_global_forward.launches
    got = blend_global_forward(*args, **kw)
    torch.cuda.synchronize()
    check(blend_global_forward.launches == before + 1, "kernel",
          f"{name}: launch counter did not move")
    warps = {} if count_evaluations else None
    ref = blend_global_forward_plain(*args, **kw,
                                     count_evaluations=count_evaluations,
                                     warp_counts=warps)
    err_color = (got[0] - ref[0]).abs().max().item()
    err_t = (got[1] - ref[1]).abs().max().item()
    n_bad = int((got[2] != ref[2]).sum())
    err_depth = ((got[3] - ref[3]).abs() / ref[3].abs().clamp(min=1.0)).max().item()
    finite = all(bool(torch.isfinite(x).all()) for x in (got[0], got[1], got[3]))
    stats = {"max_abs_err_color": err_color, "max_abs_err_final_t": err_t,
             "n_contrib_mismatches": n_bad, "max_rel_err_depth_acc": err_depth,
             "finite": finite,
             "bitwise_equal_plain": all(torch.equal(g, r)
                                        for g, r in zip(got, ref))}
    check(finite and stats["bitwise_equal_plain"], "kernel",
          f"{name}: kernel disagrees: {stats}")
    if count_evaluations:
        stats["evaluations"], stats["blends"] = ref[4], ref[5]
        stats.update(warps, footprint_kept_share=kept_share(warps))
    return stats


def compare_kernel_bwd(name, args, kw, cotangents, *, count_evaluations=False):
    """K2 against its plain version on K1's output for ``args``; two K2
    launches must give the same bits. Returns (stats, K2 inputs)."""
    from stopthepop_tpu_torch.kernels.global_blend import (
        GRAD_COLS,
        blend_global_backward,
        blend_global_backward_plain,
        blend_global_forward,
    )

    color, final_t, n_contrib, _ = blend_global_forward(*args, **kw)
    bwd_args = (*args[:6], color, final_t, n_contrib, *cotangents)
    before = blend_global_backward.launches
    got = blend_global_backward(*bwd_args, **kw)
    again = blend_global_backward(*bwd_args, **kw)
    torch.cuda.synchronize()
    check(blend_global_backward.launches == before + 2, "kernel_bwd",
          f"{name}: launch counter did not move")
    warps = {} if count_evaluations else None
    ref = blend_global_backward_plain(*bwd_args, **kw,
                                      count_evaluations=count_evaluations,
                                      warp_counts=warps)
    if count_evaluations:
        ref, evaluations, blends = ref
    scale = ref.abs().amax(dim=0)
    err = (got - ref).abs().amax(dim=0)
    stats = {
        "max_abs_err": float(err.max()),
        "max_abs_err_by_column": dict(zip(GRAD_COLS, err.tolist())),
        "column_max": dict(zip(GRAD_COLS, scale.tolist())),
        "finite": bool(torch.isfinite(got).all()),
        "bitwise_repeat": bool(torch.equal(got, again)),
    }
    check(stats["finite"] and bool((err <= K2_RTOL * scale).all()),
          "kernel_bwd", f"{name}: kernel disagrees: {stats}")
    check(stats["bitwise_repeat"], "kernel_bwd",
          f"{name}: two K2 launches differ")
    if count_evaluations:
        stats["evaluations"], stats["blends"] = evaluations, blends
        stats.update(warps, footprint_kept_share=kept_share(warps))
    return stats, bwd_args


def kept_share(counts):
    """The share of (warp, pair) steps that a footprint test keeps."""
    return counts["warp_pairs_kept"] / max(counts["warp_pairs"], 1)


def backward_grads(prep, apply, cotangents):
    """Per-Gaussian (xy, conic_opacity, rgb) gradients of one full backward
    pass of a blend Function: ``apply(xy, conic_opacity, rgb)`` runs its
    forward (e.g. BlendGlobal: K1; then K2, unsort, segmented sum)."""
    rows = [t.detach().clone().requires_grad_(True)
            for t in (prep.mean2d, prep.conic_opacity, prep.rgb)]
    color, final_t, _, _ = apply(*rows)
    torch.autograd.backward([color, final_t], list(cotangents))
    return [r.grad for r in rows]


def check_backward_repeats(phase, name, prep, apply, cotangents):
    """Two full backward passes (``backward_grads``) give the same bits, and
    finite gradients that are not all zero."""
    first = backward_grads(prep, apply, cotangents)
    second = backward_grads(prep, apply, cotangents)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    check(same, phase, f"two {name} backward passes differ")
    check(all(bool(torch.isfinite(g).all()) and bool((g != 0).any())
              for g in first), phase,
          "per-Gaussian gradients not finite or all zero")
    return same


def kb_args(prep, pairs, cam):
    """K3/K4 inputs of a preprocessed frame: ids, ranges, rows, camera."""
    return (pairs.gauss_id, pairs.starts, pairs.ends, prep.mean2d.contiguous(),
            prep.conic_opacity.contiguous(), prep.rgb.contiguous(),
            prep.cov3d_inv9.contiguous(), cam.inv_viewprojmatrix.contiguous(),
            cam.campos.contiguous())


def compare_resort(phase, name, wrapper, plain, args, kw, *,
                   count_evaluations=False):
    """A forward kernel that takes a camera (K3, K5) against its plain
    version on the same inputs; returns (stats, the kernel's output)."""
    before = wrapper.launches
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    check(wrapper.launches == before + 1, phase,
          f"{name}: launch counter did not move")
    ref = plain(*args, **kw, count_evaluations=count_evaluations)
    err_depth = ((got[3] - ref[3]).abs() / ref[3].abs().clamp(min=1.0)).max().item()
    stats = {"max_abs_err_color": (got[0] - ref[0]).abs().max().item(),
             "max_abs_err_final_t": (got[1] - ref[1]).abs().max().item(),
             "n_contrib_mismatches": int((got[2] != ref[2]).sum()),
             "max_rel_err_depth_acc": err_depth,
             "max_commits": int(got[2].max()),
             "bitwise_equal_plain": all(torch.equal(g, r)
                                        for g, r in zip(got, ref[:4])),
             "finite": all(bool(torch.isfinite(x).all())
                           for x in (got[0], got[1], got[3]))}
    check(stats["finite"] and stats["max_abs_err_color"] <= ATOL
          and stats["max_abs_err_final_t"] <= ATOL
          and stats["n_contrib_mismatches"] == 0 and err_depth <= ATOL,
          phase, f"{name}: kernel disagrees: {stats}")
    if count_evaluations:
        stats.update(ref[4])
    return stats, got


def compare_kb(name, args, kw, k, *, count_evaluations=False):
    """K3 against its plain version, to the bit; returns (stats, K3's
    output)."""
    from stopthepop_tpu_torch.kernels import kbuffer_blend as kb

    stats, got = compare_resort(
        "kernel_kb", name, kb.blend_kbuffer_forward,
        kb.blend_kbuffer_forward_plain, args, {**kw, "k": k},
        count_evaluations=count_evaluations)
    check(stats["bitwise_equal_plain"], "kernel_kb",
          f"{name}: K3 is not bitwise equal to its plain version: {stats}")
    if count_evaluations:
        stats["footprint_kept_share"] = kept_share(stats)
    return {"k": k, **stats}, got


def compare_resort_bwd(phase, name, wrapper, plain, bwd_args, kw, *,
                       count_evaluations=False):
    """A backward kernel that takes a camera (K4, K6) against its plain
    version on the same inputs (its forward's inputs, raw colour, final_T,
    n_contrib and the cotangents): each gradient column within K2_RTOL of
    its largest magnitude, the same bits as the plain version, and two
    launches with the same bits. Returns stats."""
    from stopthepop_tpu_torch.kernels.global_blend import GRAD_COLS

    before = wrapper.launches
    got = wrapper(*bwd_args, **kw)
    again = wrapper(*bwd_args, **kw)
    torch.cuda.synchronize()
    check(wrapper.launches == before + 2, phase,
          f"{name}: launch counter did not move")
    ref = plain(*bwd_args, **kw, count_evaluations=count_evaluations)
    if count_evaluations:
        ref, counts = ref
    scale = ref.abs().amax(dim=0)
    err = (got - ref).abs().amax(dim=0)
    stats = {
        "max_abs_err": float(err.max()),
        "max_abs_err_by_column": dict(zip(GRAD_COLS, err.tolist())),
        "column_max": dict(zip(GRAD_COLS, scale.tolist())),
        "finite": bool(torch.isfinite(got).all()),
        "bitwise_repeat": bool(torch.equal(got, again)),
        "bitwise_equal_plain": bool(torch.equal(got, ref)),
    }
    check(stats["finite"] and bool((err <= K2_RTOL * scale).all()),
          phase, f"{name}: kernel disagrees: {stats}")
    check(stats["bitwise_repeat"], phase, f"{name}: two launches differ")
    check(stats["bitwise_equal_plain"], phase,
          f"{name}: not bitwise equal to its plain version: {stats}")
    if count_evaluations:
        stats["replay"] = counts
    return stats


def compare_kb_bwd(name, args, kw, k, fwd, cotangents, *,
                   count_evaluations=False):
    """K4 against its plain version on K3's output ``fwd``. Returns (stats,
    K4 inputs)."""
    from stopthepop_tpu_torch.kernels import kbuffer_blend as kb

    bwd_args = (*args, fwd[0], fwd[1], fwd[2], *cotangents)
    stats = compare_resort_bwd(
        "kernel_kb_bwd", name, kb.blend_kbuffer_backward,
        kb.blend_kbuffer_backward_plain, bwd_args, {**kw, "k": k},
        count_evaluations=count_evaluations)
    return {"k": k, **stats}, bwd_args


def hier_args(prep, pairs, cam):
    """K5 inputs of a preprocessed frame: K3's and the culling thresholds."""
    args = kb_args(prep, pairs, cam)
    return (*args[:7], prep.opacity_power_threshold.contiguous(), *args[7:])


def compare_hier(name, args, kw, *, count_evaluations=False,
                 phase="kernel_hier"):
    """K5 against its plain version, to the bit; returns stats."""
    from stopthepop_tpu_torch.kernels import hier_blend as hb

    stats, _ = compare_resort(
        phase, name, hb.blend_hier_forward,
        hb.blend_hier_forward_plain, args, kw,
        count_evaluations=count_evaluations)
    check(stats["max_abs_err_color"] == 0.0
          and stats["max_abs_err_final_t"] == 0.0
          and stats["max_rel_err_depth_acc"] == 0.0, phase,
          f"{name}: K5 is not bitwise equal to its plain version: {stats}")
    return {"queues": list(kw["queue_sizes"]),
            "hier_4x4_culling": kw["hier_4x4_culling"], **stats}


def compare_hier_bwd(name, args, kw, cotangents, *, count_evaluations=False,
                     phase="kernel_hier_bwd"):
    """K6 against its plain version on K5's output for ``args``. Returns
    (stats, K6 inputs)."""
    from stopthepop_tpu_torch.kernels import hier_blend as hb

    fwd = hb.blend_hier_forward(*args, **kw)
    bwd_args = (*args, fwd[0], fwd[1], fwd[2], *cotangents)
    stats = compare_resort_bwd(
        phase, name, hb.blend_hier_backward,
        hb.blend_hier_backward_plain, bwd_args, kw,
        count_evaluations=count_evaluations)
    return {"queues": list(kw["queue_sizes"]),
            "hier_4x4_culling": kw["hier_4x4_culling"], **stats}, bwd_args


def hier_deep_case(dev, phase="kernel_hier"):
    """The deep-segment case of K5 and K6: (case name, prepare() output,
    camera); fails unless every segment holds HIER_DEEP_MIN pairs."""
    from stopthepop_tpu_torch.utils.testing import make_camera, random_scene

    scene = random_scene(22, 4000, extent=0.5, device=dev)
    cam = make_camera(HIER_DEEP_SIZE, HIER_DEEP_SIZE, device=dev)
    prep, pairs, kw = prepare(
        {"means3d": scene.means3d, "opacities": scene.opacities,
         "scales": scene.scales, "rotations": scene.rotations,
         "shs": scene.shs}, cam, HIER_DEEP_SIZE, HIER_DEEP_SIZE)
    segments = (pairs.ends - pairs.starts).tolist()
    check(min(segments) >= HIER_DEEP_MIN, phase,
          f"the deep scene's segments are too short: {segments}")
    return (f"{HIER_DEEP_SIZE}x{HIER_DEEP_SIZE} deep segments {segments}",
            (prep, pairs, kw), cam)


def compare_full(name, args, kw, *, count_evaluations=False):
    """K7 against its plain version, to the bit; returns stats."""
    from stopthepop_tpu_torch.kernels import full_blend as fb

    stats = compare_resort(
        "kernel_full", name, fb.blend_full_forward,
        fb.blend_full_forward_plain, args, kw,
        count_evaluations=count_evaluations)[0]
    check(stats["max_abs_err_color"] == 0.0
          and stats["max_abs_err_final_t"] == 0.0
          and stats["max_rel_err_depth_acc"] == 0.0, "kernel_full",
          f"{name}: K7 is not bitwise equal to its plain version: {stats}")
    return stats


def full_auto_rule(scene, cam):
    """PER_PIXEL_FULL through ``GaussianRasterizer`` with full_mode="auto"
    on a small scene on the card: under no_grad it launches K7 once; asked
    for gradients it takes the dense oracle (no K7 launch), whose image and
    final_T equal K7's within ATOL (n_contrib on under 2% of the pixels,
    tests/test_torch_full.py's allowance) and whose gradients are finite.
    Returns stats."""
    from stopthepop_tpu_torch.config import ExtendedSettings, SortMode
    from stopthepop_tpu_torch.kernels import full_blend as fb
    from stopthepop_tpu_torch.render.rasterize import GaussianRasterizer

    ext = ExtendedSettings()
    ext.sort_settings.sort_mode = SortMode.PPX_FULL
    raster = GaussianRasterizer(
        raster_settings(cam, ext, cam.width, cam.height), full_output=True)

    def render(means):
        return raster(means, None, scene["opacities"], shs=scene["shs"],
                      scales=scene["scales"], rotations=scene["rotations"])

    before = fb.blend_full_forward.launches
    with torch.no_grad():
        k7 = render(scene["means3d"])
    k7_launches = fb.blend_full_forward.launches - before
    means = scene["means3d"].clone().requires_grad_(True)
    dense = render(means)
    dense_launches = fb.blend_full_forward.launches - before - k7_launches
    dense.color.sum().backward()
    stats = {"k7_launches_no_grad": k7_launches,
             "k7_launches_with_grad": dense_launches,
             "max_abs_err_color": float((dense.color.detach() - k7.color).abs().max()),
             "max_abs_err_final_t": float((dense.final_t.detach() - k7.final_t).abs().max()),
             "n_contrib_mismatch": float((dense.n_contrib != k7.n_contrib).float().mean()),
             "grad_finite": bool(torch.isfinite(means.grad).all()),
             "grad_nonzero": bool((means.grad != 0).any())}
    check(k7_launches == 1 and dense_launches == 0, "kernel_full",
          f"auto rule: K7 launches {k7_launches} without and {dense_launches} "
          "with gradients (want 1 and 0)")
    check(stats["max_abs_err_color"] <= ATOL and stats["max_abs_err_final_t"] <= ATOL
          and stats["n_contrib_mismatch"] < 0.02, "kernel_full",
          f"auto rule: the dense oracle and K7 differ: {stats}")
    check(stats["grad_finite"] and stats["grad_nonzero"], "kernel_full",
          "auto rule: the dense oracle's gradients are not finite or all zero")
    return stats


def full_ops(n):
    """Operations of the PER_PIXEL_FULL function from the plain version's
    counts ``n``."""
    return (OPS_PER_EVAL * n["evaluations"] + OPS_PER_DEPTH * n["depths"]
            + OPS_PER_SORT_COMPARE * n["sort_compares"]
            + OPS_PER_BLENDED * n["blended"] + OPS_PER_COMMIT * n["commits"])


def full_bytes(n_pairs, gaussians, tiles, width, height):
    """Bytes K7 moves at least: the point list, each tile's range, the rows
    it reads a Gaussian (xy, conic and opacity, rgb, inverse covariance),
    the camera and the four output planes."""
    return 4 * (n_pairs + 2 * tiles + gaussians * (2 + 4 + 3 + 9) + 19
                + width * height * 6)


def full_shapes_phase(dev):
    """K7 at FULL_SHAPES (phase kernel_full, see the module notes): at each
    of PREP_THETAS_DEG orbit cameras (fov 60) of the configuration's scene
    (bench_model at its Gaussians: the benchmark's distributions), K7 on
    the frame's pairs bitwise equal to its plain version, and its device
    pass counter moved by the plain version's count of passes and its tiles
    by the grid's; at the first camera K7's and the plain version's ms and
    K7's bound. One line a shape; returns the lines."""
    from stopthepop_tpu_torch.io.cameras import orbit_camera, to_camera_arrays
    from stopthepop_tpu_torch.kernels import full_blend as fb
    from stopthepop_tpu_torch.utils.testing import Camera

    lines = []
    for name, n, width, height, tile in FULL_SHAPES:
        model = bench_model(dev, n)
        with torch.inference_mode():
            a = model_arrays(model)
            del model
            cams = []
            for theta in PREP_THETAS_DEG:
                dc = orbit_camera(math.radians(theta), math.radians(60.0),
                                  width, height)
                cams.append(Camera(*to_camera_arrays(dc, dev),
                                   tanfovx=dc.tanfovx, tanfovy=dc.tanfovy,
                                   width=width, height=height))
            per_cam = []
            for theta, cam in zip(PREP_THETAS_DEG, cams):
                case = f"{name} theta={theta:g}"
                prep, _, view, _, kw = prepare_binned(a, cam, width, height,
                                                      tile)
                args = kb_args(prep, view, cam)
                passes0, tiles0 = fb.pass_counts()
                st = compare_full(case, args, kw, count_evaluations=True)
                passes1, tiles1 = fb.pass_counts()
                tiles = kw["grid_x"] * kw["grid_y"]
                counter = {"passes": passes1 - passes0,
                           "tiles": tiles1 - tiles0}
                check(counter == {"passes": st["passes"], "tiles": tiles},
                      "kernel_full", f"{case}: K7's pass counter read "
                      f"{counter}, the plain version {st['passes']} passes "
                      f"over {tiles} tiles")
                row = {"theta_deg": theta, "pairs": view.num_rendered,
                       "tiles": tiles,
                       "max_segment": int((view.ends - view.starts).max()),
                       "passes_per_tile": st["passes"] / tiles,
                       "max_passes": st["rounds"]["max"],
                       "bitwise_equal_plain": st["bitwise_equal_plain"],
                       "max_abs_err": max(st["max_abs_err_color"],
                                          st["max_abs_err_final_t"]),
                       "counter": counter}
                if not per_cam:
                    k7_ms = cuda_ms(lambda: fb.blend_full_forward(*args, **kw),
                                    20)
                    plain_ms = cuda_ms(lambda: fb.blend_full_forward_plain(
                        *args, **kw), 1, 0)
                    ops = full_ops(st)
                    nbytes = full_bytes(view.num_rendered, n, tiles, width,
                                        height)
                    bytes_ms, ops_ms = bound_ms(nbytes, ops)
                    row.update(k7_ms=k7_ms, plain_ms=plain_ms, bytes=nbytes,
                               ops=ops, bytes_bound_ms=bytes_ms,
                               ops_bound_ms=ops_ms,
                               bound_ms=max(bytes_ms, ops_ms),
                               bound_by=("bytes" if bytes_ms >= ops_ms
                                         else "operations"))
                per_cam.append(row)
                del prep, view, args
        first = per_cam[0]
        lines.append({"case": name, "gaussians": n, "width": width,
                      "height": height, "tile": list(tile),
                      "cameras": per_cam,
                      **{k: first[k] for k in (
                          "k7_ms", "plain_ms", "bound_ms", "bound_by")}})
        del a
        torch.cuda.empty_cache()
    return lines


def psnr_stats(img, ref):
    """PSNR (dB), mean and max absolute difference of two images clipped to
    [0, 1]."""
    a, b = img.clamp(0.0, 1.0), ref.clamp(0.0, 1.0)
    diff = (a - b).abs()
    mse = float((diff * diff).mean())
    return {"psnr_vs_full": 10.0 * math.log10(1.0 / max(mse, 1e-12)),
            "mean_abs": float(diff.mean()), "max_abs": float(diff.max())}


def serve_phase(phase, model, cams, settings, kernel, args_fn, blend, dev,
                tile=(16, 16), min_pairs=MIN_PAIRS):
    """One serving path: a warm-up frame, then the orbit ``cams`` through
    render/cli.py::render_frames with every launch count set to 0 just
    before and read just after. Every frame is finite, not background and
    has at least ``min_pairs`` pairs; ``kernel``, the preprocess kernel
    K8 and the pair stream's kernels launched once a frame and no other
    kernel at all. Then frame 0's
    stages (CUDA events): preprocess (K8, as the frames run it; its plain
    version beside it), the pair build (on the grid of the binning tile
    ``tile``, split over the 16x16 blend tiles) and
    ``blend(*args_fn(prep, pairs, cam))``, ``pairs`` with the blend tiles'
    ranges. Returns the phase's fields and the launch counts."""
    from stopthepop_tpu_torch.io.cameras import to_camera_arrays
    from stopthepop_tpu_torch.render.cli import render_frames
    from stopthepop_tpu_torch.render.preprocess import (
        preprocess,
        preprocess_plain,
    )

    tile_shape = None if tuple(tile) == (16, 16) else tuple(tile)
    render_frames(model, cams[:1], settings, dev,
                  tile_shape=tile_shape)  # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    outs = render_frames(model, cams, settings, dev, tile_shape=tile_shape)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, o in enumerate(outs):
        check(o.color.shape == (3, HEIGHT, WIDTH), phase,
              f"frame {i} shape {tuple(o.color.shape)}")
        check(bool(torch.isfinite(o.color).all()), phase, f"frame {i} not finite")
        check(bool((o.color != 0.0).any()), phase, f"frame {i} is background")
        check(o.num_rendered >= min_pairs, phase,
              f"frame {i}: only {o.num_rendered} pairs")
    check(launched(launches, with_pairs({kernel: len(cams), "k8": len(cams)})),
          phase, f"launches {launches} for {len(cams)} frames")
    pairs_per_frame = [o.num_rendered for o in outs]
    del outs
    cam0 = to_camera_arrays(cams[0], dev)
    with torch.inference_mode():
        a = model_arrays(model)

        def pre(fn=preprocess):
            return fn(
                a["means3d"], a["opacities"], scales=a["scales"],
                rotations=a["rotations"], shs=a["shs"],
                viewmatrix=cam0.viewmatrix, projmatrix=cam0.projmatrix,
                campos=cam0.campos, tanfovx=cams[0].tanfovx,
                tanfovy=cams[0].tanfovy, image_width=WIDTH,
                image_height=HEIGHT, sh_degree=3, rect_bounding=True,
                tight_opacity_bounding=True, tile_x=tile[0], tile_y=tile[1])

        stage = {"preprocess_ms": cuda_ms(pre, 10),
                 "preprocess_plain_ms": cuda_ms(
                     lambda: pre(preprocess_plain), 10)}
        prep0 = pre()
        stage["pairs_ms"] = cuda_ms(lambda: binned_pairs(prep0, tile), 10)
        args0 = args_fn(prep0, binned_pairs(prep0, tile)[1], cam0)
        stage[f"{kernel}_ms"] = cuda_ms(lambda: blend(*args0), 20)
    return {"frames": len(cams), "width": WIDTH, "height": HEIGHT,
            "gaussians": NUM_GAUSSIANS, "pairs_per_frame": pairs_per_frame,
            "ms_per_frame": dt * 1e3 / len(cams), "frames_per_s": len(cams) / dt,
            "launches": launches, "frame0_stage_ms": stage,
            "peak_mem_gib": peak}, launches


def train_phase(phase, model, static, cam, target, dev, kernels,
                render_kwargs=None, min_pairs=MIN_PAIRS):
    """The training path at full width in one sort mode: one warm-up step,
    then TRAIN_STEPS steps of train/trainer.py's step with every launch
    count set to 0 just before and read just after. The loss is finite and
    falls, each of ``kernels`` and the pair stream's kernels launched once
    a step and no other kernel at all, every gradient finite and nonzero somewhere, at least
    ``min_pairs`` pairs a step. Then the stages of 3 more steps (CUDA
    events). ``render_kwargs`` go to the step (``tile_shape``). Returns the
    phase's fields, the densification stats and a function taking one more
    step (for the profiler)."""
    from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES
    from stopthepop_tpu_torch.train import trainer

    state = trainer.init_train_state(model, trainer.make_3dgs_optimizer(model))
    stats = trainer.init_densify_stats(model.num_gaussians, dev)
    step_fn = trainer.make_train_step(static=static,
                                      render_kwargs=render_kwargs)
    state, stats, _ = step_fn(state, cam, target, stats)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms, step_pairs = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, stats, aux = step_fn(state, cam, target, stats)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(aux["loss"]))
        step_pairs.append(aux["num_rendered"])
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(v) for v in losses), phase, f"loss not finite: {losses}")
    check(losses[-1] < losses[0], phase, f"loss did not fall: {losses}")
    check(launched(launches, with_pairs(dict.fromkeys(kernels, TRAIN_STEPS))),
          phase, f"launches {launches} in {TRAIN_STEPS} steps")
    for name in PARAM_NAMES:
        g = getattr(model, name).grad
        check(g is not None and bool(torch.isfinite(g).all())
              and bool((g != 0).any()), phase, f"gradient of {name}")
    check(min(step_pairs) >= min_pairs, phase, f"pairs per step {step_pairs}")
    stage = {"forward_ms": 0.0, "backward_ms": 0.0, "optimizer_ms": 0.0}
    reps = 3
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _, _ = trainer.step_forward(state, cam, target, static=static,
                                          render_kwargs=render_kwargs)
        ev[1].record()
        trainer.step_backward(state, loss)
        ev[2].record()
        state = trainer.step_update(state)
        ev[3].record()
        torch.cuda.synchronize()
        for key, a, b in (("forward_ms", 0, 1), ("backward_ms", 1, 2),
                          ("optimizer_ms", 2, 3)):
            stage[key] += ev[a].elapsed_time(ev[b]) / reps

    def one_step():
        nonlocal state, stats
        state, stats, _ = step_fn(state, cam, target, stats)

    fields = {"steps": TRAIN_STEPS, "width": WIDTH, "height": HEIGHT,
              "gaussians": NUM_GAUSSIANS, "losses": losses,
              "ms_per_step": sum(step_ms) / TRAIN_STEPS, "step_ms": step_ms,
              "stage_ms": stage, "pairs_per_step": step_pairs,
              "launches": launches, "peak_mem_gib": peak}
    return fields, stats, one_step


def hier_ops(n, ops_per_commit):
    """Operations of K5's cascade at HIER_QUEUES from the plain replay's
    counts ``n``, with ``ops_per_commit`` for each commit of alpha > 0 (K5's
    blend, or K6's gradient terms)."""
    _, km, kh = HIER_QUEUES
    return (OPS_PER_TAIL_KEY * n["tail_keys"]
            + OPS_PER_TAIL_SLOT * n["tail_slots"]
            + OPS_PER_HIER_EVAL * n["evaluations"]
            + (OPS_PER_DEPTH + OPS_PER_MID_SLOT * km) * n["mid_inserts"]
            + OPS_PER_HEAD_SLOT * kh * n["head_inserts"]
            + ops_per_commit * n["commits"])


def bound_ms(bytes_moved, ops):
    """(bytes bound ms, operations bound ms) on an H100 SXM."""
    return bytes_moved / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3


def profile_steps(step, n: int, unprofiled_ms: float):
    """torch.profiler over ``n`` calls of ``step``: device busy time (the
    sum of the kernels' device times; one stream, so no overlap; the
    device-side copies of host annotations such as Optimizer.step, which
    span kernels and carry a host event's name, left out), wall time
    and the kernels with the most device time, all per step. The profiler
    slows the host, so the idle share is also given against
    ``unprofiled_ms``, the step's time without it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    host_names = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and e.key not in host_names]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    check(busy_ms > 0, "train_profile", "the profiler saw no device time")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "unprofiled_ms_per_step": unprofiled_ms,
            "device_idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels) / n,
            "top_kernels": [
                {"name": e.key[:120], "ms_per_step": e.self_device_time_total / 1e3 / n,
                 "launches_per_step": e.count / n} for e in kernels[:15]]}


def bench_model(dev, n=NUM_GAUSSIANS):
    """The bench scene: ``n`` (500K) Gaussians from seed 0, log-scales
    minus 2.3 (trained-scene-like footprints, bench.py:109-111)."""
    from stopthepop_tpu_torch.models.gaussians import init_random

    model = init_random(n, seed=0, extent=1.5, sh_degree=3, device=dev)
    with torch.no_grad():
        model.scales_log -= 2.3
    return model


def raster_settings(cam, ext, width, height, **kw):
    """GaussianRasterizationSettings of a testing Camera."""
    from stopthepop_tpu_torch.config import GaussianRasterizationSettings

    return GaussianRasterizationSettings(
        image_height=height, image_width=width, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=torch.zeros(3, device=cam.campos.device),
        scale_modifier=1.0, viewmatrix=cam.viewmatrix,
        projmatrix=cam.projmatrix, inv_viewprojmatrix=cam.inv_viewprojmatrix,
        sh_degree=3, campos=cam.campos, prefiltered=False, settings=ext, **kw)


def culled_settings(mode=None):
    """ExtendedSettings with rect and tight-opacity culling, in ``mode``."""
    from stopthepop_tpu_torch.config import ExtendedSettings

    ext = ExtendedSettings()
    if mode is not None:
        ext.sort_settings.sort_mode = mode
    ext.culling_settings.rect_bounding = True
    ext.culling_settings.tight_opacity_bounding = True
    return ext


def model_grads(model):
    from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES

    return {k: getattr(model, k).grad.detach().clone() for k in PARAM_NAMES}


def batched_train_phase(static, dev, single_step_ms):
    """train_batched: the bench model, BATCH orbit cameras at 1080p with
    seeded random targets through train/trainer.py::make_batched_train_step
    in GLOBAL. First its gradients against the mean of BATCH single-camera
    gradients at the same weights (within 1e-5 of each tensor's largest
    value); that step is the warm-up. Then BATCH_STEPS timed steps with the
    launch counts set to 0 just before and read just after: K1 and K2
    and the pair stream's kernels launched BATCH times a step and no other
    kernel, the loss finite and
    falling; the step's ms, its ms per camera against the single-camera
    ``train`` step, and peak memory from a reset counter."""
    from stopthepop_tpu_torch.io.cameras import CameraArrays, orbit_camera, to_camera_arrays
    from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES
    from stopthepop_tpu_torch.train import trainer

    model = bench_model(dev)
    views = [to_camera_arrays(orbit_camera(2 * math.pi * i / BATCH,
                                           math.radians(60.0), WIDTH, HEIGHT),
                              dev) for i in range(BATCH)]
    cams = CameraArrays(*(torch.stack([getattr(v, f) for v in views])
                          for f in CameraArrays._fields))
    targets = torch.rand((BATCH, 3, HEIGHT, WIDTH), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    state = trainer.init_train_state(model, trainer.make_3dgs_optimizer(model))
    single = {k: torch.zeros_like(getattr(model, k)) for k in PARAM_NAMES}
    for b in range(BATCH):
        state.optimizer.zero_grad(set_to_none=True)
        loss, _, _ = trainer.step_forward(state, views[b], targets[b],
                                          static=static)
        loss.backward()
        for k, g in model_grads(model).items():
            single[k] += g / BATCH
    stats = trainer.init_densify_stats(model.num_gaussians, dev)
    step_fn = trainer.make_batched_train_step(static=static)
    state, stats, _ = step_fn(state, cams, targets, stats)  # warm-up
    grad_err = {}
    for k, g in model_grads(model).items():
        scale = float(single[k].abs().max())
        grad_err[k] = float((g - single[k]).abs().max()) / max(scale, 1e-30)
        check(scale > 0 and grad_err[k] <= 1e-5, "train_batched",
              f"{k}: batched gradient is not the mean of {BATCH} single-camera "
              f"gradients ({grad_err[k]} of the largest)")
    del single
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms = [], []
    for _ in range(BATCH_STEPS):
        t0 = time.perf_counter()
        state, stats, aux = step_fn(state, cams, targets, stats)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(aux["loss"]))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          "train_batched", f"loss not finite or not falling: {losses}")
    check(launched(launches, with_pairs(dict.fromkeys(
        ("k1", "k2"), BATCH * BATCH_STEPS))), "train_batched",
          f"launches {launches} in {BATCH_STEPS} steps of {BATCH} cameras")
    check(int(stats.denom.max()) == BATCH * (BATCH_STEPS + 1), "train_batched",
          f"denom max {int(stats.denom.max())}")
    ms = sum(step_ms) / BATCH_STEPS
    return {"cameras": BATCH, "steps": BATCH_STEPS, "width": WIDTH,
            "height": HEIGHT, "gaussians": NUM_GAUSSIANS, "losses": losses,
            "ms_per_step": ms, "step_ms": step_ms,
            "ms_per_camera": ms / BATCH,
            "single_camera_train_ms_per_step": single_step_ms,
            "pairs_per_camera": aux["num_rendered"],
            "grad_err_vs_single_mean": grad_err, "launches": launches,
            "peak_mem_gib": peak}


def colmap_phase(out_dir, dev):
    """colmap: a COLMAP capture of the bench model written with the port's
    writers (utils/synthetic.py::write_colmap_capture): COLMAP_VIEWS PNG
    renders at COLMAP_W x COLMAP_H (MipNeRF-360 bicycle's images_4) and a
    points3D of COLMAP_POINTS of its means with their colours. Then
    train/cli.py::main on it for COLMAP_ITERS iterations in the CLI's
    default mode, HIER (K5, K6): eval PSNR rises, the PLY loads; then
    render/cli.py renders every view of the capture in PPX_KBUFFER (K3)."""
    from stopthepop_tpu_torch.io.images import read_png
    from stopthepop_tpu_torch.io.ply import load_gaussian_model
    from stopthepop_tpu_torch.render import cli as render_cli
    from stopthepop_tpu_torch.train import cli as train_cli
    from stopthepop_tpu_torch.utils.synthetic import write_colmap_capture

    data = out_dir / "colmap"
    t0 = time.perf_counter()
    write_colmap_capture(str(data), bench_model(dev), views=COLMAP_VIEWS,
                         width=COLMAP_W, height=COLMAP_H, points=COLMAP_POINTS,
                         device=dev)
    write_s = time.perf_counter() - t0
    ply = out_dir / "colmap.ply"
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # the CLI's progress lines
        res = train_cli.main([
            "--data", str(data), "--iters", str(COLMAP_ITERS),
            "--eval-every", str(COLMAP_ITERS // 4), "--out", str(ply),
            "--device", str(dev), "--seed", "0"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    evals = [res.eval_psnr[k] for k in sorted(res.eval_psnr)]
    check(all(math.isfinite(v) for v in evals) and evals[-1] > evals[0],
          "colmap", f"eval PSNR did not rise: {res.eval_psnr}")
    # K5 once a step and once an evaluation frame, which alone (no
    # gradient) takes K8; the CLI culls by tile, so its pairs take the
    # torch path.
    check(train_launches["k5"] >= COLMAP_ITERS and launched(train_launches, {
        "k5": train_launches["k5"], "k6": COLMAP_ITERS,
        "k8": train_launches["k5"] - COLMAP_ITERS}), "colmap",
          f"launches {train_launches} in {COLMAP_ITERS} HIER iterations")
    trained = load_gaussian_model(str(ply), device=dev)
    check(trained.num_gaussians == COLMAP_POINTS == res.state.model.num_gaussians,
          "colmap", "the PLY does not hold the model trained from points3D")
    frames = out_dir / "colmap_frames"
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        render_cli.main(["--ply", str(ply), "--data", str(data),
                         "--frames", str(COLMAP_VIEWS), "--out", str(frames),
                         "--sort-mode", "PPX_KBUFFER", "--device", str(dev)])
    render_s = time.perf_counter() - t0
    render_launches = read_launches()
    check(launched(render_launches, with_pairs({
        "k3": COLMAP_VIEWS + 1, "k8": COLMAP_VIEWS + 1})),  # and a warm-up
          "colmap", f"render launches {render_launches}")
    shapes = {read_png(str(frames / f"frame_{i:04d}.png")).shape
              for i in range(COLMAP_VIEWS)}
    check(shapes == {(COLMAP_H, COLMAP_W, 3)}, "colmap",
          f"rendered frame shapes {shapes}")
    return {"views": COLMAP_VIEWS, "width": COLMAP_W, "height": COLMAP_H,
            "points3D": COLMAP_POINTS, "write_s": write_s,
            "iters": COLMAP_ITERS, "eval_psnr": res.eval_psnr,
            "train_s": train_s, "train_launches": train_launches,
            "render_s": render_s, "render_launches": render_launches}


def io_phase(out_dir, dev):
    """io: the native PNG and PLY codecs against their plain versions (see
    the module docstring, phase 26). Returns its fields."""
    import shutil

    import numpy as np

    from stopthepop_tpu_torch.io import images, ply
    from stopthepop_tpu_torch.kernels import build
    from stopthepop_tpu_torch.utils.testing import filtered_png

    t0 = time.perf_counter()
    build.build_host(["png_io", "ply_io"])
    build_s = time.perf_counter() - t0
    data = out_dir / "io"
    data.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    kinds = {"rgb_colmap": (COLMAP_H, COLMAP_W, 3), "rgba_nerf": (IO_RGBA, IO_RGBA, 4)}
    written, paths = {}, {}
    t0 = time.perf_counter()
    for kind, (h, w, c) in kinds.items():
        y, x = np.mgrid[0:h, 0:w]
        for i in range(COLMAP_VIEWS):
            smooth = np.stack([x * (k + 1) // 3 + y * (c - k) // 4 + 29 * i
                               for k in range(c)], axis=-1)
            img = ((smooth + rng.integers(0, 16, (h, w, c))) % 256).astype(np.uint8)
            path = data / f"{kind}_{i:02d}.png"
            path.write_bytes(filtered_png(img, IO_FILTERS))
            paths.setdefault(kind, []).append(str(path))
            written[str(path)] = img
    write_s = time.perf_counter() - t0
    every = [p for kind in kinds for p in paths[kind]]
    reset_launches()
    t0 = time.perf_counter()
    batch = images.read_png_batch(every, n_threads=8)
    batch_s = time.perf_counter() - t0
    for p, img in zip(every, batch):
        check(np.array_equal(img, written[p]), "io", f"read_png_batch: {p}")
    per_kind = {}
    for kind, kind_paths in paths.items():
        t0 = time.perf_counter()
        native = [images.read_png(p) for p in kind_paths]
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = [images._read_png_python(p) for p in kind_paths]
        plain_s = time.perf_counter() - t0
        for p, a, b in zip(kind_paths, native, plain):
            check(np.array_equal(a, written[p]) and np.array_equal(b, written[p]),
                  "io", f"native or plain PNG read differs: {p}")
        h, w, c = kinds[kind]
        per_kind[kind] = {
            "frames": len(kind_paths), "width": w, "height": h, "channels": c,
            "native_s": native_s, "plain_s": plain_s,
            "native_s_per_image": native_s / len(kind_paths),
            "plain_s_per_image": plain_s / len(kind_paths),
            "plain_over_native": plain_s / native_s,
        }
    del batch, native, plain, written
    shutil.rmtree(data)

    path = str(out_dir / "io_model.ply")
    t0 = time.perf_counter()
    ply.save_gaussian_model(path, bench_model(dev))
    ply_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = ply.read_ply(path, n_threads=IO_PLY_THREADS)
    ply_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = ply._read_ply_numpy(path)
    ply_plain_s = time.perf_counter() - t0
    check(list(native) == list(plain) and len(native) == 62
          and all(np.array_equal(native[k].view(np.uint32), plain[k].view(np.uint32))
                  for k in plain), "io", "native and plain PLY reads differ")
    n_verts = len(native["x"])
    ply_bytes = Path(path).stat().st_size
    Path(path).unlink()
    launches = read_launches()
    check(not any(launches.values()), "io", f"kernel launches {launches}")
    return {"host_build_s": build_s, "filters": list(IO_FILTERS),
            "png_write_s": write_s, "png": per_kind,
            "png_batch_frames": len(every), "png_batch_threads": 8,
            "png_batch_native_s": batch_s,
            "ply": {"gaussians": n_verts, "properties": len(native),
                    "bytes": ply_bytes, "write_s": ply_write_s,
                    "threads": IO_PLY_THREADS, "native_s": ply_native_s,
                    "plain_s": ply_plain_s,
                    "plain_over_native": ply_plain_s / ply_native_s},
            "bitwise": True, "launches": launches}


def debug_viz_phase(model, bench_cam, cams, small_arrays, dev):
    """debug_viz: Depth, Transmittance, GaussianCountPerPixel and
    GaussianCountPerTile at 1080p/500K through GaussianRasterizer in GLOBAL,
    PPX_KBUFFER, HIER and PPX_FULL, each render launching its blend kernel
    (K1, K3, K5, K7) once: each field equals the same render's full_output
    quantity (depth_acc / (1 - T), final_T, n_contrib, the pair counts) to
    the bit, the image is its colormap and the statistics its own.
    render_depth=True through render/cli.py::render_frames. Both
    sort-error modes on the 70x45 and the deep 32x32 scenes, their maps
    against the same function on the CPU (1e-5 of the larger of 1 and the
    map's largest value); the k-buffer (k = 4) and HIER (64, 8, 4) oracles'
    sort-error maps there, their means per mode."""
    from stopthepop_tpu_torch.config import DebugVisualization as DV
    from stopthepop_tpu_torch.config import SortMode
    from stopthepop_tpu_torch.render import naive
    from stopthepop_tpu_torch.render.cli import render_frames
    from stopthepop_tpu_torch.render.debug_viz import (
        DebugVisualizationData,
        apply_colormap,
        debug_field,
        field_stats,
        normalize_field,
        sort_error_maps,
        tile_count_map,
    )
    from stopthepop_tpu_torch.render.rasterize import GaussianRasterizer
    from stopthepop_tpu_torch.utils.testing import make_camera, random_scene

    kernel_of = {SortMode.GLOBAL: "k1", SortMode.PPX_KBUFFER: "k3",
                 SortMode.HIER: "k5", SortMode.PPX_FULL: "k7"}
    a = model_arrays(model)
    with torch.inference_mode():
        _, pairs, _ = prepare(a, bench_cam, WIDTH, HEIGHT)
        counts = pairs.ends - pairs.starts
        del pairs
    fields = {}
    for mode, kernel in kernel_of.items():
        rs = raster_settings(bench_cam, culled_settings(mode), WIDTH, HEIGHT)
        for viz in (DV.Depth, DV.Transmittance, DV.GaussianCountPerPixel,
                    DV.GaussianCountPerTile):
            data = DebugVisualizationData(debug_pixel=(WIDTH // 2, HEIGHT // 2))
            reset_launches()
            with torch.inference_mode():
                out = GaussianRasterizer(
                    rs, full_output=True, debug_visualization=viz,
                    debug_data=data)(a["means3d"], None, a["opacities"],
                                     shs=a["shs"], scales=a["scales"],
                                     rotations=a["rotations"])
                torch.cuda.synchronize()
                launches = read_launches()
                case = f"{mode.name} {viz.name}"
                check(launched(launches, with_pairs({kernel: 1, "k8": 1})),
                      "debug_viz", f"{case}: launches {launches}")
                field, table = debug_field(
                    viz, final_t=out.final_t, n_contrib=out.n_contrib,
                    depth_acc=out.depth_acc, pair_counts=counts, width=WIDTH,
                    height=HEIGHT)
                expect = {
                    DV.Depth: lambda: out.depth_acc / (1.0 - out.final_t).clamp(min=1e-6),
                    DV.Transmittance: lambda: out.final_t,
                    DV.GaussianCountPerPixel: lambda: out.n_contrib.float(),
                    DV.GaussianCountPerTile: lambda: tile_count_map(
                        counts, WIDTH, HEIGHT),
                }[viz]()
                lo, hi, mean, std = (float(v) for v in field_stats(field))
                check(torch.equal(field, expect) and bool(torch.isfinite(field).all())
                      and torch.equal(out.color, apply_colormap(
                          normalize_field(field), table))
                      and (data.minimum, data.maximum, data.mean, data.std)
                      == (lo, hi, mean, std)
                      and out.num_rendered == int(counts.sum()), "debug_viz",
                      f"{case}: the image is not the colormap of the render's "
                      "own field")
            fields[case] = {"min": lo, "max": hi, "mean": mean, "std": std}
    reset_launches()
    depth_out = render_frames(model, cams[:1], culled_settings(), dev,
                              render_depth=True)[0]
    launches = read_launches()
    expect = depth_out.depth_acc / (1.0 - depth_out.final_t).clamp(min=1e-6)
    from stopthepop_tpu_torch.render.colormaps import TURBO_TABLE

    check(launched(launches, with_pairs({"k1": 1, "k8": 1})) and torch.equal(
        depth_out.color, apply_colormap(normalize_field(expect), TURBO_TABLE)),
        "debug_viz", f"render_depth through render_frames: launches {launches}")

    # The sort-error maps on the small scenes, on the card and on the CPU.
    deep = random_scene(22, 4000, extent=0.5, device="cpu")
    scenes = (
        ("70x45 random scene, 300 Gaussians", small_arrays, (70, 45)),
        (f"{HIER_DEEP_SIZE}x{HIER_DEEP_SIZE} deep scene, 4000 Gaussians",
         {"means3d": deep.means3d, "opacities": deep.opacities,
          "scales": deep.scales, "rotations": deep.rotations, "shs": deep.shs},
         (HIER_DEEP_SIZE, HIER_DEEP_SIZE)))
    sort_error = []
    for case, arrays, (w, h) in scenes:
        on = {k: v.to(dev) for k, v in arrays.items()}
        off = {k: v.cpu() for k, v in arrays.items()}
        cam, cpu_cam = make_camera(w, h, device=dev), make_camera(w, h, device="cpu")
        row = {"case": case}
        with torch.inference_mode():
            prep, _, _ = prepare(on, cam, w, h)
            cpu_prep, _, _ = prepare(off, cpu_cam, w, h)
            maps = sort_error_maps(prep, w, h, cam.campos, cam.inv_viewprojmatrix)
            ref = sort_error_maps(cpu_prep, w, h, cpu_cam.campos,
                                  cpu_cam.inv_viewprojmatrix)
            for name, m, r, viz in zip(("opacity", "distance"), maps, ref,
                                       (DV.SortErrorOpacity, DV.SortErrorDistance)):
                err = float((m.cpu() - r).abs().max())
                tol = 1e-5 * max(1.0, float(r.abs().max()))
                check(err <= tol and bool(torch.isfinite(m).all()), "debug_viz",
                      f"{case}: GLOBAL {name} map off the CPU's by {err}")
                data = DebugVisualizationData()
                img = GaussianRasterizer(
                    raster_settings(cam, culled_settings(), w, h),
                    debug_visualization=viz, debug_data=data)(
                        on["means3d"], None, on["opacities"], shs=on["shs"],
                        scales=on["scales"], rotations=on["rotations"])[0]
                check(bool(torch.isfinite(img).all())
                      and data.maximum == float(m.max()), "debug_viz",
                      f"{case}: the {viz.name} render is not its map")
                row[f"global_{name}_max_abs_err_vs_cpu"] = err
                row[f"global_{name}_mean"] = float(m.mean())
            kb = naive.render_kbuffer_naive(
                prep, torch.zeros(3, device=dev), w, h, cam.campos,
                cam.inv_viewprojmatrix, k=KB_K, sort_error=True)
            hier = naive.render_hierarchical_naive(
                prep, torch.zeros(3, device=dev), w, h, cam.campos,
                cam.inv_viewprojmatrix, queue_sizes=HIER_QUEUES,
                sort_error=True)
            for mode, out in (("kbuffer", kb), ("hier", hier)):
                check(all(bool(torch.isfinite(x).all()) for x in out),
                      "debug_viz", f"{case}: {mode} oracle not finite")
                row[f"{mode}_opacity_mean"] = float(out[3].mean())
                row[f"{mode}_distance_mean"] = float(out[4].mean())
        sort_error.append(row)
    return {"fields": fields, "sort_error": sort_error}


def timed_phase(model, bench_cam, out_dir, dev):
    """timed: render/pipeline.py::render_tiled_timed with
    StageTimer(interval=2) for TIMED_FRAMES frames at 1080p/500K (K1 and K8
    once a frame): the image bitwise render_tiled's, the four stage times of the
    last interval; then utils/profiling.py::trace of one more frame names
    K1's kernel in its file."""
    from stopthepop_tpu_torch.kernels import global_blend
    from stopthepop_tpu_torch.render.pipeline import render_tiled, render_tiled_timed
    from stopthepop_tpu_torch.render.preprocess import preprocess
    from stopthepop_tpu_torch.utils.profiling import STAGES, StageTimer, trace

    a = model_arrays(model)
    bg = torch.zeros(3, device=dev)

    def prep_fn():
        return preprocess(
            a["means3d"], a["opacities"], scales=a["scales"],
            rotations=a["rotations"], shs=a["shs"],
            viewmatrix=bench_cam.viewmatrix, projmatrix=bench_cam.projmatrix,
            campos=bench_cam.campos, tanfovx=bench_cam.tanfovx,
            tanfovy=bench_cam.tanfovy, image_width=WIDTH, image_height=HEIGHT,
            sh_degree=3, rect_bounding=True, tight_opacity_bounding=True)

    kw = dict(image_width=WIDTH, image_height=HEIGHT)
    timer = StageTimer(interval=2)
    reports = []
    with torch.inference_mode():
        reset_launches()
        for i in range(TIMED_FRAMES):
            timed = render_tiled_timed(prep_fn, timer, bg, **kw)
            if (i + 1) % timer.interval == 0:
                reports.append(timer.timings_text)
        launches = read_launches()
        untimed = render_tiled(prep_fn(), bg, **kw)
        same = all(torch.equal(x, y) for x, y in zip(
            timed[:3] + timed[4:], untimed[:3] + untimed[4:]))
        check(same, "timed", "the timed render differs from render_tiled")
        check(launched(launches, with_pairs({"k1": TIMED_FRAMES,
                                             "k8": TIMED_FRAMES})), "timed",
              f"launches {launches} in {TIMED_FRAMES} frames")
        with trace(str(out_dir / "trace")):
            render_tiled_timed(prep_fn, StageTimer(enabled=False), bg, **kw)
    with open(out_dir / "trace" / "trace.json") as f:
        text = f.read()
    check(f"{global_blend.KERNEL}_kernel" in text, "timed",
          "the trace does not name K1's kernel")
    stage_ms = [{ln.split(":")[0]: float(ln.split()[1])
                 for ln in rep.splitlines()} for rep in reports]
    check(len(stage_ms) == TIMED_FRAMES // 2
          and all(list(st) == list(STAGES) for st in stage_ms), "timed",
          f"timings text {reports}")
    return {"frames": TIMED_FRAMES, "interval": 2, "width": WIDTH,
            "height": HEIGHT, "gaussians": NUM_GAUSSIANS,
            "stage_ms_by_interval": stage_ms, "launches": launches,
            "trace_names_k1": True, "bitwise_equal_render_tiled": same}


def snapshot_phase(model, bench_cam):
    """snapshot, in a temporary STP_SNAPSHOT_DIR: a debug=True render of
    the bench model with one opacity too many raises on the card and
    writes a snapshot_fw whose host copies equal the inputs; a good
    debug=True render is bitwise the plain render."""
    import os
    import tempfile

    from stopthepop_tpu_torch.render.rasterize import GaussianRasterizer
    from stopthepop_tpu_torch.utils.snapshot import load_snapshot

    a = model_arrays(model)
    rs = raster_settings(bench_cam, culled_settings(), WIDTH, HEIGHT)
    inputs = dict(shs=a["shs"], scales=a["scales"], rotations=a["rotations"])
    bad = torch.cat([a["opacities"], a["opacities"][:1]])
    old = os.environ.get("STP_SNAPSHOT_DIR")
    with tempfile.TemporaryDirectory() as d:
        os.environ["STP_SNAPSHOT_DIR"] = d
        try:
            with torch.inference_mode():
                try:
                    with contextlib.redirect_stdout(sys.stderr):
                        GaussianRasterizer(rs._replace(debug=True))(
                            a["means3d"], None, bad, **inputs)
                    raised = None
                except RuntimeError as e:
                    raised = str(e).splitlines()[0][:200]
                check(raised is not None, "snapshot", "the bad render did not raise")
                snap = load_snapshot(os.path.join(d, "snapshot_fw.npz"))
                equal = all(
                    (snap[k] == v.cpu().numpy()).all() for k, v in (
                        ("means3D", a["means3d"]), ("opacities", bad),
                        ("sh", a["shs"]), ("scales", a["scales"]),
                        ("rotations", a["rotations"]),
                        ("viewmatrix", bench_cam.viewmatrix)))
                check(equal, "snapshot", "snapshot_fw differs from the inputs")
                plain = GaussianRasterizer(rs, full_output=True)(
                    a["means3d"], None, a["opacities"], **inputs)
                debug = GaussianRasterizer(rs._replace(debug=True),
                                           full_output=True)(
                    a["means3d"], None, a["opacities"], **inputs)
                same = all(torch.equal(x, y) for x, y in zip(plain[:5],
                                                             debug[:5]))
                check(same and not os.path.exists(
                    os.path.join(d, "snapshot_bw.npz")), "snapshot",
                    "the debug render differs from the plain render")
                files = sorted(os.listdir(d))
        finally:
            if old is None:
                del os.environ["STP_SNAPSHOT_DIR"]
            else:
                os.environ["STP_SNAPSHOT_DIR"] = old
    return {"error": raised, "snapshot_files": files,
            "snapshot_equals_inputs": equal, "debug_render_bitwise_plain": same}


def float_bits(t):
    """Float32 bits as integers that order as the floats do (-0 one below
    +0)."""
    i = t.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF) - 1, i)


def preprocess_diffs(kernel, plain):
    """{field: {"rows", "ulp"}} of the PreprocessOutput fields in which
    ``kernel`` and ``plain`` differ: the rows that differ and, for a float
    field, the largest difference in units in the last place (NaN equals
    NaN)."""
    out = {}
    for name, k, p in zip(plain._fields, kernel, plain):
        if k.shape != p.shape or k.dtype != p.dtype:
            out[name] = {"shape": [list(k.shape), list(p.shape)],
                         "dtype": [str(k.dtype), str(p.dtype)]}
            continue
        if k.is_floating_point():
            diff = (float_bits(k) - float_bits(p)).abs().masked_fill(
                torch.isnan(k) & torch.isnan(p), 0)
        else:
            diff = (k != p).to(torch.int64)
        rows = diff.reshape(diff.shape[0], -1).amax(dim=1)
        if bool((rows > 0).any()):
            out[name] = {"rows": int((rows > 0).sum()),
                         "ulp": int(rows.max()) if k.is_floating_point()
                         else None}
    return out


def k8_case(case, means3d, opacities, kw):
    """K8 through render/preprocess.py::preprocess (card tensors, no
    gradient: one launch) against preprocess_plain on the same inputs;
    every field of every row, culled rows included, has to be equal.
    Returns the rows the plain version keeps valid."""
    from stopthepop_tpu_torch.kernels import preprocess_fwd as k8
    from stopthepop_tpu_torch.render.preprocess import (
        preprocess,
        preprocess_plain,
    )

    before = k8.preprocess_fwd.launches
    kernel = preprocess(means3d, opacities, **kw)
    check(k8.preprocess_fwd.launches == before + 1, "kernel_preprocess",
          f"{case}: {k8.preprocess_fwd.launches - before} K8 launches")
    plain = preprocess_plain(means3d, opacities, **kw)
    diffs = preprocess_diffs(kernel, plain)
    check(not diffs, "kernel_preprocess",
          f"{case}: K8 differs from the plain preprocess: {diffs}")
    return int(plain.valid.sum())


def k8_small_cases(dev):
    """The small scene's cases, (name, means3d, opacities, kwargs), and the
    rows whose dilated 2D determinant is 0 in the plain version's
    arithmetic: PREP_SMALL Gaussians, an eighth behind the near plane, an
    eighth with opacities under 1/255, a quarter thin Gaussians at 45
    degrees in the image (rank-one covariances whose determinant can round
    to 0)."""
    from stopthepop_tpu_torch.config import GlobalSortOrder
    from stopthepop_tpu_torch.ops.covariance import (
        compute_cov2d,
        compute_cov3d,
        dilate_cov2d,
    )
    from stopthepop_tpu_torch.ops.transforms import in_frustum
    from stopthepop_tpu_torch.utils.testing import make_camera, random_scene

    scene = random_scene(11, PREP_SMALL, device=dev)
    means, scales = scene.means3d.clone(), scene.scales.clone()
    rots, opac = scene.rotations.clone(), scene.opacities.clone()
    w, h = 96, 64
    cam = make_camera(w, h, campos=(0.2, 0.1, -4.0), device=dev)
    n = PREP_SMALL // 8
    means[:n, 2] = torch.linspace(-8.0, -3.81, n, device=dev)
    opac[n:2 * n] = torch.linspace(1e-4, 5e-3, n, device=dev)
    thin = slice(2 * n, 4 * n)
    half = math.radians(22.5)
    rots[thin] = torch.tensor([math.cos(half), 0.0, 0.0, math.sin(half)],
                              device=dev)
    scales[thin, 0] = torch.logspace(2.0, 5.0, 2 * n, device=dev)
    scales[thin, 1:] = 1e-7
    means[thin] = means[thin] * 0.2
    base = dict(scales=scales, rotations=rots, shs=scene.shs,
                viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
                campos=cam.campos, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
                image_width=w, image_height=h, sh_degree=3)
    cases = []
    for bits in range(16):
        rect, tight, ewa, dist = (bool(bits >> k & 1) for k in range(4))
        order = GlobalSortOrder.DISTANCE if dist else GlobalSortOrder.Z_DEPTH
        cases.append((f"rect={int(rect)} tight={int(tight)} ewa={int(ewa)} "
                      f"{order.name}", dict(
                          base, rect_bounding=rect,
                          tight_opacity_bounding=tight,
                          proper_ewa_scaling=ewa, sort_order=order)))
    culled = dict(base, rect_bounding=True, tight_opacity_bounding=True)
    for deg in range(4):
        for rows in sorted({16, (deg + 1) ** 2}):
            cases.append((f"sh_degree={deg} M={rows}", dict(
                culled, sh_degree=deg, shs=scene.shs[:, :rows].contiguous())))
    cases.append(("colors_precomp", dict(culled, shs=None,
                                         colors_precomp=scene.colors)))
    for tx, ty in ((32, 16), (24, 16)):
        cases.append((f"bins {tx}x{ty}", dict(culled, tile_x=tx, tile_y=ty)))
    cases.append(("scale_modifier=0.7", dict(culled, scale_modifier=0.7)))
    visible, p_view = in_frustum(means, cam.viewmatrix)
    p_view = torch.where(visible[:, None], p_view,
                         p_view.new_tensor([0.0, 0.0, 1.0]))
    cov2d = compute_cov2d(p_view, w / (2.0 * cam.tanfovx),
                          h / (2.0 * cam.tanfovy), cam.tanfovx, cam.tanfovy,
                          compute_cov3d(scales, 1.0, rots), cam.viewmatrix)
    det_zero = int((dilate_cov2d(cov2d, False)[1] == 0.0).sum())
    return [(c, means, opac, kw) for c, kw in cases], det_zero


def preprocess_phase(dev):
    """Phase kernel_preprocess (see the module notes): one line for the
    small scene's cases, then one a shape of PREP_SHAPES; returns the
    lines."""
    from stopthepop_tpu_torch.io.cameras import orbit_camera, to_camera_arrays
    from stopthepop_tpu_torch.render.preprocess import (
        preprocess,
        preprocess_plain,
    )

    lines = []
    with torch.inference_mode():
        cases, det_zero = k8_small_cases(dev)
        check(det_zero > 0, "kernel_preprocess",
              "no row of the small scene has a dilated determinant of 0")
        valid = {case: k8_case(case, means, opac, kw)
                 for case, means, opac, kw in cases}
        lines.append({"case": f"small scene, {PREP_SMALL} Gaussians",
                      "det_zero_rows": det_zero, "cases": len(cases),
                      "valid_rows": valid})
        del cases
    for name, n, width, height, tile in PREP_SHAPES:
        model = bench_model(dev, n)
        with torch.inference_mode():
            a = model_arrays(model)
            del model
            kws = []
            for theta in PREP_THETAS_DEG:
                cam = orbit_camera(math.radians(theta), math.radians(60.0),
                                   width, height)
                arrays = to_camera_arrays(cam, dev)
                kws.append(dict(
                    scales=a["scales"], rotations=a["rotations"],
                    shs=a["shs"], viewmatrix=arrays.viewmatrix,
                    projmatrix=arrays.projmatrix, campos=arrays.campos,
                    tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
                    image_width=width, image_height=height, sh_degree=3,
                    rect_bounding=True, tight_opacity_bounding=True,
                    tile_x=tile[0], tile_y=tile[1]))
            valid = [k8_case(f"{name} theta={theta:g}", a["means3d"],
                             a["opacities"], kw)
                     for theta, kw in zip(PREP_THETAS_DEG, kws)]
            k8_ms = cuda_ms(lambda: preprocess(
                a["means3d"], a["opacities"], **kws[0]), PREP_ITERS)
            plain_ms = cuda_ms(lambda: preprocess_plain(
                a["means3d"], a["opacities"], **kws[0]), PREP_ITERS)
        bytes_moved = n * (PREP_BYTES_READ + 16 * 12 + PREP_BYTES_WRITTEN)
        bytes_ms = bound_ms(bytes_moved, 0)[0]
        lines.append({"case": name, "gaussians": n, "width": width,
                      "height": height, "tile": list(tile),
                      "thetas_deg": list(PREP_THETAS_DEG), "valid_rows": valid,
                      "k8_ms": k8_ms, "plain_ms": plain_ms,
                      "bytes": bytes_moved, "bytes_bound_ms": bytes_ms,
                      "share_of_bound": bytes_ms / k8_ms})
        del a, kws
        torch.cuda.empty_cache()
    return lines


def pairs_diffs(got, want):
    """({field: differing elements (or the dtypes and shapes)} of the
    PairBuffer fields in which ``got`` and ``want`` differ, floats by their
    bits (-0.0 is not 0.0); the largest absolute difference of any field of
    a dtype and shape they share)."""
    out, err = {}, 0.0
    if got.num_rendered != want.num_rendered:
        out["num_rendered"] = [got.num_rendered, want.num_rendered]
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if name == "num_rendered":
            continue
        if a.dtype != b.dtype or a.shape != b.shape:
            out[name] = {"dtype": [str(a.dtype), str(b.dtype)],
                         "shape": [list(a.shape), list(b.shape)]}
            continue
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        differ = int((a != b).sum())
        if differ:
            out[name] = differ
    return out, err


def pairs_torch_path(prep, gx, gy, order):
    from stopthepop_tpu_torch.render.duplicate import (
        expand_pairs,
        sort_expanded,
    )

    return sort_expanded(*expand_pairs(prep, grid_x=gx, sort_order=order),
                         num_tiles=gx * gy,
                         num_gaussians=prep.tiles_touched.shape[0])


def pairs_launches():
    from stopthepop_tpu_torch.kernels import pairs as kp

    return {"duplicate_with_keys": kp.duplicate_with_keys.launches,
            "sort_and_identify": kp.sort_and_identify.launches}


def pairs_case(case, prep, gx, gy, order):
    """The kernels through render/duplicate.py::build_pairs (one launch of
    each wrapper) against the torch path: every PairBuffer field bitwise.
    Returns the case's row, with the largest difference of any field."""
    from stopthepop_tpu_torch.render.duplicate import build_pairs

    before = pairs_launches()
    got = build_pairs(prep, grid_x=gx, grid_y=gy, sort_order=order)
    after = pairs_launches()
    check(all(after[k] == before[k] + 1 for k in after), "kernel_pairs",
          f"{case}: launches {before} -> {after}")
    want = pairs_torch_path(prep, gx, gy, order)
    diffs, err = pairs_diffs(got, want)
    check(not diffs, "kernel_pairs",
          f"{case}: the kernels differ from the torch path: {diffs}")
    counts = (want.ends - want.starts).to(torch.int64)
    largest = int(counts.argmax())
    return {"case": case, "pairs": want.num_rendered, "tiles": gx * gy,
            "max_abs_err": err,
            "empty_tiles": int((counts == 0).sum()),
            "largest_tile": largest, "max_segment": int(counts[largest]),
            "largest_range": [int(got.starts[largest]),
                              int(got.ends[largest])]}


def pairs_kernel_ms(fn, iters):
    """Device ms a call of each kernel ``fn`` launches (torch.profiler over
    ``iters`` calls): the two of csrc/pairs.cu, CUB's scan and sort, and
    any other by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        name = ("duplicate_with_keys" if "duplicate_with_keys" in e.key else
                "identify_tile_ranges" if "identify_tile_ranges" in e.key else
                "cub_sort" if "DeviceRadixSort" in e.key else
                "cub_scan" if "DeviceScan" in e.key else e.key[:80])
        out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out


def pairs_bound_ms(P, N, T, bits):
    """Each step's bytes over the card's bandwidth, ms."""
    passes = -(-bits // 8)
    nbytes = {
        "cub_scan": P * PAIRS_SCAN_BYTES,
        "duplicate_with_keys": P * PAIRS_GAUSS_BYTES + N * PAIRS_DUP_BYTES,
        "cub_sort": N * (PAIRS_HIST_BYTES + PAIRS_PASS_BYTES * passes),
        "identify_tile_ranges": (N * (PAIRS_LAST_READ + PAIRS_LAST_WRITTEN)
                                 + T * PAIRS_TILE_BYTES),
    }
    return nbytes, {k: bound_ms(v, 0)[0] for k, v in nbytes.items()}


def pairs_mode_launches(model, width, height, tile, mode, dev):
    """The wrappers' launches in 2 frames through render/cli.py::render_frames
    and, where the mode trains, in 1 training step, at the configuration's
    shape and binning tile in its sort mode."""
    from stopthepop_tpu_torch.config import GaussianRasterizationSettings, SortMode
    from stopthepop_tpu_torch.io.cameras import orbit_camera, to_camera_arrays
    from stopthepop_tpu_torch.render.cli import render_frames
    from stopthepop_tpu_torch.train import trainer

    ext = culled_settings(SortMode[mode])
    cams = [orbit_camera(math.radians(t), math.radians(60.0), width, height)
            for t in (30.0, 31.0)]
    out = {}
    before = pairs_launches()
    with torch.inference_mode():
        render_frames(model, cams, ext, dev, tile_shape=tuple(tile))
    after = pairs_launches()
    out["frames"] = {k: after[k] - before[k] for k in after}
    check(all(n == len(cams) for n in out["frames"].values()), "kernel_pairs",
          f"{mode}: launches in {len(cams)} frames: {out['frames']}")
    if mode == "PPX_FULL":  # forward only: no training step
        return out
    static = GaussianRasterizationSettings(
        image_height=height, image_width=width, tanfovx=cams[0].tanfovx,
        tanfovy=cams[0].tanfovy, bg=torch.zeros(3, device=dev),
        scale_modifier=1.0, viewmatrix=None, projmatrix=None,
        inv_viewprojmatrix=None, sh_degree=3, campos=None, prefiltered=False,
        settings=ext)
    state = trainer.init_train_state(model, trainer.make_3dgs_optimizer(model))
    stats = trainer.init_densify_stats(model.num_gaussians, dev)
    step = trainer.make_train_step(static=static,
                                   render_kwargs={"tile_shape": tuple(tile)})
    target = torch.rand((3, height, width), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    before = pairs_launches()
    step(state, to_camera_arrays(cams[0], dev), target, stats)
    torch.cuda.synchronize()
    after = pairs_launches()
    out["step"] = {k: after[k] - before[k] for k in after}
    check(all(n == 1 for n in out["step"].values()), "kernel_pairs",
          f"{mode}: launches in a training step: {out['step']}")
    return out


def pairs_phase(dev):
    """Phase kernel_pairs (see the module notes): one line a shape of
    PAIRS_SHAPES; returns the lines."""
    from stopthepop_tpu_torch.config import GlobalSortOrder
    from stopthepop_tpu_torch.io.cameras import orbit_camera, to_camera_arrays
    from stopthepop_tpu_torch.kernels import pairs as kp
    from stopthepop_tpu_torch.render.duplicate import build_pairs
    from stopthepop_tpu_torch.render.pipeline import tile_grid
    from stopthepop_tpu_torch.render.preprocess import preprocess

    lines = []
    for name, n, width, height, tile, mode in PAIRS_SHAPES:
        model = bench_model(dev, n)
        gx, gy = tile_grid(width, height, *tile)
        cams = [orbit_camera(math.radians(t), math.radians(60.0), width,
                             height) for t in PREP_THETAS_DEG]

        def prep_at(cam, order, a):
            arrays = to_camera_arrays(cam, dev)
            return preprocess(
                a["means3d"], a["opacities"], scales=a["scales"],
                rotations=a["rotations"], shs=a["shs"],
                viewmatrix=arrays.viewmatrix, projmatrix=arrays.projmatrix,
                campos=arrays.campos, tanfovx=cam.tanfovx,
                tanfovy=cam.tanfovy, image_width=width, image_height=height,
                sh_degree=3, rect_bounding=True, tight_opacity_bounding=True,
                sort_order=order, tile_x=tile[0], tile_y=tile[1])

        rows = []
        with torch.inference_mode():
            a = model_arrays(model)
            for theta, cam in zip(PREP_THETAS_DEG, cams):
                prep = prep_at(cam, GlobalSortOrder.Z_DEPTH, a)
                rows.append({"theta_deg": theta, **pairs_case(
                    f"{name} theta={theta:g}", prep, gx, gy,
                    GlobalSortOrder.Z_DEPTH)})
                if len(rows) > 1:
                    continue
                # Times at the first camera.
                N, P = rows[0]["pairs"], n

                def kernels():
                    return build_pairs(prep, grid_x=gx, grid_y=gy)

                timed = {
                    "kernels_ms": cuda_ms(kernels, PAIRS_ITERS),
                    "torch_path_ms": cuda_ms(lambda: pairs_torch_path(
                        prep, gx, gy, GlobalSortOrder.Z_DEPTH), 5),
                    "kernel_ms": pairs_kernel_ms(kernels, PAIRS_ITERS)}
                nbytes, bounds = pairs_bound_ms(P, N, gx * gy,
                                                kp.end_bit(gx * gy))
                timed.update(end_bit=kp.end_bit(gx * gy), bytes=nbytes,
                             bound_ms=bounds, bound_total_ms=sum(
                                 bounds.values()),
                             share_of_bound={
                                 k: bounds[k] / timed["kernel_ms"][k]
                                 for k in bounds
                                 if timed["kernel_ms"].get(k)})
                rows[0].update(timed)
                prep_d = prep_at(cam, GlobalSortOrder.DISTANCE, a)
                rows.append({"theta_deg": theta, "order": "DISTANCE",
                             **pairs_case(f"{name} theta={theta:g} DISTANCE",
                                          prep_d, gx, gy,
                                          GlobalSortOrder.DISTANCE)})
                del prep_d
            del a, prep
        # The model's leaves requiring grad (the training step's
        # preprocess, under autograd), then with a quarter of the grid's
        # columns emptied: every Gaussian whose rect starts there touches
        # no tile.
        prep = prep_at(cams[0], GlobalSortOrder.Z_DEPTH, model_arrays(model))
        check(prep.depth.requires_grad, "kernel_pairs",
              f"{name}: the depth does not require grad")
        grad = pairs_case(f"{name} grad", prep, gx, gy,
                          GlobalSortOrder.Z_DEPTH)
        cut = gx // 4
        emptied = prep._replace(tiles_touched=torch.where(
            prep.rect_min[:, 0] < cut, 0, prep.tiles_touched))
        grad_emptied = pairs_case(f"{name} grad, {cut} columns emptied",
                                  emptied, gx, gy, GlobalSortOrder.Z_DEPTH)
        check(grad_emptied["empty_tiles"] >= cut * gy, "kernel_pairs",
              f"{name}: {grad_emptied['empty_tiles']} empty tiles")
        del prep, emptied
        launches = pairs_mode_launches(model, width, height, tile, mode, dev)
        lines.append({"case": name, "gaussians": n, "width": width,
                      "height": height, "tile": list(tile), "mode": mode,
                      "cameras": rows, "grad": grad,
                      "grad_emptied": grad_emptied,
                      "mode_launches": launches})
        del model
        torch.cuda.empty_cache()
    return lines


def unread_rows(segs, n_pairs):
    """[S, N] bool: the rows of each plane that no blend tile's range
    covers (the missing halves of the binning tiles at the right or bottom
    edge), which a backward must leave at zero."""
    S = segs.num_sub
    edge = torch.zeros((S, n_pairs + 1), dtype=torch.int64,
                       device=segs.starts.device)
    sub = segs.sub_tile.to(torch.int64)
    one = torch.ones_like(sub)
    edge.index_put_((sub, segs.starts.to(torch.int64)), one, accumulate=True)
    edge.index_put_((sub, segs.ends.to(torch.int64)), -one, accumulate=True)
    return torch.cumsum(edge, dim=1)[:, :n_pairs] == 0


def compare_planes(phase, name, wrapper, plain, bwd_args, kw, segs, *,
                   bitwise, plain_kw=None):
    """A backward kernel (K2, K4, K6) with the sub-tile planes of ``segs``
    against its plain version on the same inputs: each gradient column of
    the [S, N, 9] planes within K2_RTOL of its largest magnitude (and the
    same bits where ``bitwise``), two launches with the same bits, and the
    rows no blend tile reads zero. Returns (stats, the plain version's
    extra outputs)."""
    from stopthepop_tpu_torch.kernels.global_blend import GRAD_COLS

    planes = {"sub_tile": segs.sub_tile, "num_sub": segs.num_sub}
    before = wrapper.launches
    got = wrapper(*bwd_args, **kw, **planes)
    again = wrapper(*bwd_args, **kw, **planes)
    torch.cuda.synchronize()
    check(wrapper.launches == before + 2, phase,
          f"{name}: launch counter did not move")
    ref = plain(*bwd_args, **kw, **planes, **(plain_kw or {}))
    extra = ()
    if isinstance(ref, tuple):
        ref, *extra = ref
    n_pairs = got.shape[1]
    unread = unread_rows(segs, n_pairs)
    g2, r2 = got.reshape(-1, len(GRAD_COLS)), ref.reshape(-1, len(GRAD_COLS))
    scale = r2.abs().amax(dim=0)
    err = (g2 - r2).abs().amax(dim=0)
    stats = {
        "planes": segs.num_sub, "pairs": n_pairs,
        "unread_rows": int(unread.sum()),
        "unread_rows_zero": bool((got[unread] == 0).all()),
        "max_abs_err": float(err.max()),
        "max_abs_err_by_column": dict(zip(GRAD_COLS, err.tolist())),
        "column_max": dict(zip(GRAD_COLS, scale.tolist())),
        "finite": bool(torch.isfinite(got).all()),
        "bitwise_repeat": bool(torch.equal(got, again)),
        "bitwise_equal_plain": bool(torch.equal(got, ref)),
    }
    check(tuple(got.shape) == (segs.num_sub, n_pairs, len(GRAD_COLS))
          and stats["finite"] and bool((err <= K2_RTOL * scale).all()),
          phase, f"{name}: kernel disagrees: {stats}")
    check(stats["bitwise_repeat"], phase, f"{name}: two launches differ")
    check(stats["unread_rows_zero"], phase,
          f"{name}: rows no tile reads are not zero")
    check(stats["bitwise_equal_plain"] or not bitwise, phase,
          f"{name}: not bitwise equal to its plain version: {stats}")
    return stats, extra


def one_plane_bits(phase, name, wrapper, bwd_args, kw):
    """One plane through an all-zero sub-tile map gives the bits of the
    call without a map (16x16 bins, where no two tiles share a segment)."""
    num_tiles = kw["grid_x"] * kw["grid_y"]
    zero = torch.zeros(num_tiles, dtype=torch.int32, device=bwd_args[0].device)
    one = wrapper(*bwd_args, **kw, sub_tile=zero, num_sub=1)
    none = wrapper(*bwd_args, **kw)
    torch.cuda.synchronize()
    same = one.shape[0] == 1 and torch.equal(one[0], none)
    check(same, phase, f"{name}: one plane differs from no plane map")
    return same


def tile_phase(model, bench_cam, cams, small, static, target, cotangents,
               dev):
    """The binning tile: phase 23's checks and times (see the module
    notes). Returns the phase's fields."""
    from stopthepop_tpu_torch.config import SortMode
    from stopthepop_tpu_torch.io.cameras import CameraArrays
    from stopthepop_tpu_torch.kernels import full_blend as fb
    from stopthepop_tpu_torch.kernels import global_blend as gb
    from stopthepop_tpu_torch.kernels import hier_blend as hb
    from stopthepop_tpu_torch.kernels import kbuffer_blend as kb
    from stopthepop_tpu_torch.kernels.blend_vjp import BlendGlobal
    from stopthepop_tpu_torch.render.cli import render_model
    from stopthepop_tpu_torch.utils.testing import make_camera

    out = {"tile": list(TILE)}
    hq = {"queue_sizes": HIER_QUEUES, "hier_4x4_culling": False}

    def kernels_at(case, prep, view, segs, kw, cam, width, height, counts):
        """K1-K7 on the split segments of one frame against their plain
        versions; K2, K4 and K6 with two planes. ``counts``: also the
        plain versions' event counts (the bench frame)."""
        st = {}
        args = blend_args(prep, view)
        st["k1"] = compare_kernel(f"{case} K1", args, kw,
                                  count_evaluations=counts)
        fwd = gb.blend_global_forward(*args, **kw)
        cot = cotangents(width, height)
        k2_args = (*args[:6], fwd[0], fwd[1], fwd[2], *cot)
        warps = {}
        st["k2"], extra = compare_planes(
            "tile", f"{case} K2", gb.blend_global_backward,
            gb.blend_global_backward_plain, k2_args, kw, segs, bitwise=False,
            plain_kw={"count_evaluations": True, "warp_counts": warps}
            if counts else None)
        if counts:
            st["k2"].update(evaluations=extra[0], blends=extra[1], **warps,
                            footprint_kept_share=kept_share(warps))
        kargs = kb_args(prep, view, cam)
        st["k3"], k3_out = compare_kb(f"{case} K3", kargs, kw, KB_K,
                                      count_evaluations=counts)
        k4_args = (*kargs, k3_out[0], k3_out[1], k3_out[2], *cot)
        st["k4"], extra = compare_planes(
            "tile", f"{case} K4", kb.blend_kbuffer_backward,
            kb.blend_kbuffer_backward_plain, k4_args, {**kw, "k": KB_K}, segs,
            bitwise=True, plain_kw={"count_evaluations": counts})
        if counts:
            st["k4"]["replay"] = extra[0]
        hargs = hier_args(prep, view, cam)
        hkw = {**kw, **hq}
        st["k5"] = compare_hier(f"{case} K5", hargs, hkw,
                                count_evaluations=counts)
        k5_out = hb.blend_hier_forward(*hargs, **hkw)
        k6_args = (*hargs, k5_out[0], k5_out[1], k5_out[2], *cot)
        st["k6"], extra = compare_planes(
            "tile", f"{case} K6", hb.blend_hier_backward,
            hb.blend_hier_backward_plain, k6_args, hkw, segs, bitwise=True,
            plain_kw={"count_evaluations": counts})
        if counts:
            st["k6"]["replay"] = extra[0]
        st["k7"] = compare_full(f"{case} K7", kargs, kw,
                                count_evaluations=counts)
        return st, (args, k2_args, kargs, k4_args, hargs, k6_args)

    # (a) The 70x45 scene: five 16x16 columns, so the right column of 32x16
    # binning tiles has no second half on the image.
    small_cam = make_camera(70, 45, device=dev)
    with torch.no_grad():
        prep, pairs, view, segs, kw = prepare_binned(small, small_cam, 70, 45,
                                                     TILE)
        check(segs.num_sub == 2 and kw["grid_x"] == 5, "tile",
              "the 70x45 scene is not split over an odd width")
        out["small"], _ = kernels_at("70x45", prep, view, segs, kw, small_cam,
                                     70, 45, False)
    out["small"]["pairs"] = pairs.num_rendered
    check(out["small"]["k2"]["unread_rows"] > 0, "tile",
          "the 70x45 scene has no missing half")

    # (b) The bench frame at 32x16, and one plane at 16x16.
    P = NUM_GAUSSIANS
    with torch.no_grad():
        prep, pairs, view, segs, kw = prepare_binned(
            model_arrays(model), bench_cam, WIDTH, HEIGHT, TILE)
        bench, (args, k2_args, kargs, k4_args, hargs,
                k6_args) = kernels_at("1080p", prep, view, segs, kw,
                                      bench_cam, WIDTH, HEIGHT, True)
        planes = {"sub_tile": segs.sub_tile, "num_sub": segs.num_sub}
        hkw = {**kw, **hq}
        ms = {
            "k1": cuda_ms(lambda: gb.blend_global_forward(*args, **kw), 20),
            "k2": cuda_ms(lambda: gb.blend_global_backward(
                *k2_args, **kw, **planes), 20),
            "k3": cuda_ms(lambda: kb.blend_kbuffer_forward(
                *kargs, k=KB_K, **kw), 20),
            "k4": cuda_ms(lambda: kb.blend_kbuffer_backward(
                *k4_args, k=KB_K, **kw, **planes), 20),
            "k5": cuda_ms(lambda: hb.blend_hier_forward(*hargs, **hkw), 20),
            "k6": cuda_ms(lambda: hb.blend_hier_backward(
                *k6_args, **hkw, **planes), 20),
            "k7": cuda_ms(lambda: fb.blend_full_forward(*kargs, **kw), 20),
        }
    N, T = pairs.num_rendered, kw["grid_x"] * kw["grid_y"]
    S = segs.num_sub
    k1 = bench["k1"]
    bounds = {
        "k1": bound_ms(4 * (N + 6 * T + P * 10 + WIDTH * HEIGHT * 6),
                       OPS_PER_EVAL * k1["evaluations_kept"]
                       + OPS_PER_BLEND * k1["blends"]),
        "k2": bound_ms(4 * (N + 7 * T + P * 9 + WIDTH * HEIGHT * 9
                            + S * N * 9),
                       OPS_PER_EVAL * bench["k2"]["evaluations_kept"]
                       + OPS_PER_BLEND_BWD * bench["k2"]["blends"]),
        "k4": bound_ms(4 * (N + 3 * T + P * 18 + 19 + WIDTH * HEIGHT * 9
                            + S * N * 9),
                       OPS_PER_EVAL * bench["k4"]["replay"]["evaluations"]
                       + OPS_PER_DEPTH * bench["k4"]["replay"]["depths"]
                       + OPS_PER_INSERT_SLOT * KB_K
                       * bench["k4"]["replay"]["inserts"]
                       + OPS_PER_COMMIT_BWD * bench["k4"]["replay"]["commits"]),
        "k6": bound_ms(4 * (N + 3 * T + P * 19 + 19 + WIDTH * HEIGHT * 9
                            + S * N * 9),
                       hier_ops(bench["k6"]["replay"], OPS_PER_COMMIT_BWD)),
    }
    with torch.no_grad():
        prep16, pairs16, _, _, kw16 = prepare_binned(
            model_arrays(model), bench_cam, WIDTH, HEIGHT, (16, 16))
        a16 = blend_args(prep16, pairs16)
        f16 = gb.blend_global_forward(*a16, **kw16)
        cot = cotangents(WIDTH, HEIGHT)
        k16 = kb_args(prep16, pairs16, bench_cam)
        kf16 = kb.blend_kbuffer_forward(*k16, k=KB_K, **kw16)
        h16 = hier_args(prep16, pairs16, bench_cam)
        hf16 = hb.blend_hier_forward(*h16, **kw16, **hq)
        one_plane = {
            "k2": one_plane_bits("tile", "K2", gb.blend_global_backward,
                                 (*a16[:6], *f16[:3], *cot), kw16),
            "k4": one_plane_bits("tile", "K4", kb.blend_kbuffer_backward,
                                 (*k16, *kf16[:3], *cot), {**kw16, "k": KB_K}),
            "k6": one_plane_bits("tile", "K6", hb.blend_hier_backward,
                                 (*h16, *hf16[:3], *cot), {**kw16, **hq}),
        }
    out["bench"] = {
        "pairs": N, "pairs_16x16": pairs16.num_rendered,
        "max_segment": int((pairs.ends - pairs.starts).max()),
        "max_segment_16x16": int((pairs16.ends - pairs16.starts).max()),
        "kernels": bench, "ms": ms,
        "bound_ms": {k: max(b) for k, b in bounds.items()},
        "bound_by": {k: "bytes" if b[0] >= b[1] else "operations"
                     for k, b in bounds.items()},
        "one_plane_bitwise_no_map": one_plane,
        "k1_footprint_kept_share": k1["footprint_kept_share"],
        "k2_footprint_kept_share": bench["k2"]["footprint_kept_share"],
    }
    del prep, pairs, view, segs, args, k2_args, kargs, k4_args, hargs, k6_args
    del prep16, a16, f16, k16, kf16, h16, hf16

    # (c) The GLOBAL image and gradients at 32x16 against 16x16, and two
    # backward passes at 32x16 with the same bits.
    from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES

    cam = CameraArrays(bench_cam.viewmatrix, bench_cam.projmatrix,
                       bench_cam.inv_viewprojmatrix, bench_cam.campos)
    w = cotangents(WIDTH, HEIGHT)[0]
    imgs, grads = {}, {}
    for name, tile in (("16x16", None), ("32x16", TILE)):
        for p in PARAM_NAMES:
            getattr(model, p).grad = None
        color, _ = render_model(model, cam, static=static, tile_shape=tile)
        (color * w).sum().backward()
        imgs[name] = color.detach()
        grads[name] = model_grads(model)
    img_err = float((imgs["32x16"] - imgs["16x16"]).abs().max())
    check(img_err <= 5e-5, "tile",
          f"the 32x16 image is {img_err} from the 16x16 one")
    grad_err = {
        p: float((grads["32x16"][p] - grads["16x16"][p]).abs().max()
                 / grads["16x16"][p].abs().max().clamp(min=1e-30))
        for p in PARAM_NAMES}
    check(max(grad_err.values()) <= K2_RTOL, "tile",
          f"32x16 gradients against 16x16: {grad_err}")
    del grads
    out["odd"] = odd_bins(model, bench_cam, small, static, cam, imgs["16x16"],
                          cotangents, dev)
    del imgs
    with torch.no_grad():
        prep, pairs, view, segs, kw = prepare_binned(
            model_arrays(model), bench_cam, WIDTH, HEIGHT, TILE)
    repeat = check_backward_repeats(
        "tile", "BlendGlobal at 32x16", prep,
        lambda *rows: BlendGlobal.apply(
            *rows, prep.depth.detach().contiguous(), pairs, kw["grid_x"],
            kw["grid_y"], WIDTH, HEIGHT, None, segs),
        cotangents(WIDTH, HEIGHT))
    del prep, pairs, view, segs
    out["vs_16x16"] = {"image_max_abs_err": img_err,
                       "grad_max_err_over_tensor_max": grad_err,
                       "bitwise_repeat_backward_32x16": repeat}

    # (d) Frames and steps at both bins, each path with the launch counts
    # set to 0 just before it and read just after.
    settings = static.settings
    for name, tile in (("16x16", (16, 16)), ("32x16", TILE)):
        kwargs = {"tile_shape": None if tile == (16, 16) else tile}
        fields, _ = serve_phase(
            f"tile_main_{name}", model, cams, settings, "k1",
            lambda prep, pairs, cam: blend_args(prep, pairs),
            functools.partial(gb.blend_global_forward, **kw16), dev,
            tile=tile, min_pairs=MIN_PAIRS_TILE)
        out[f"main_{name}"] = fields
        for mode, ks in (("GLOBAL", ("k1", "k2")),
                         ("PPX_KBUFFER", ("k3", "k4")),
                         ("HIER", ("k5", "k6"))):
            if mode != "GLOBAL" and tile == (16, 16):
                continue  # phases 10 and 14
            mode_static = static
            if mode != "GLOBAL":
                mode_settings = culled_settings(SortMode[mode])
                mode_settings.sort_settings.queue_sizes.per_pixel = (
                    KB_K if mode == "PPX_KBUFFER" else HIER_QUEUES[2])
                mode_static = static._replace(settings=mode_settings)
            fields, _, _ = train_phase(
                f"tile_train_{mode}_{name}", model, mode_static, cam, target,
                dev, ks, render_kwargs=kwargs, min_pairs=MIN_PAIRS_TILE)
            out[f"train_{mode}_{name}"] = fields
    for tile in ODD_TILES:
        name = f"{tile[0]}x{tile[1]}"
        out[f"train_GLOBAL_{name}"], _, _ = train_phase(
            f"tile_train_GLOBAL_{name}", model, static, cam, target, dev,
            ("k1", "k2"), render_kwargs={"tile_shape": tile},
            min_pairs=MIN_PAIRS_TILE)
    # PPX_FULL serves at 32x16 too (K7 once a frame); phase 16 at 16x16.
    out["main_full_32x16"], _ = serve_phase(
        "tile_main_full_32x16", model, cams, culled_settings(SortMode.PPX_FULL),
        "k7", kb_args, functools.partial(fb.blend_full_forward, **kw16), dev,
        tile=TILE, min_pairs=MIN_PAIRS_TILE)
    return out


def odd_bins(model, bench_cam, small, static, cam, img16, cotangents, dev):
    """Phase 23 (e): GLOBAL at binning tiles whose sides are not multiples
    of 16, cut into pieces of at most 16x16 pixels: K1 on the pieces
    bitwise its plain version and its image and final T bitwise the 16x16
    grid's, K2 with its planes within K2_RTOL of its plain version (20x12 on
    the 70x45 scene; ODD_TILES on the bench frame, with the plain versions'
    counts, both kernels' times and bounds); the API's image at each of
    ODD_TILES bitwise the 16x16 one (``img16``). Returns the fields."""
    from stopthepop_tpu_torch.kernels import global_blend as gb
    from stopthepop_tpu_torch.render.cli import render_model
    from stopthepop_tpu_torch.utils.testing import make_camera

    out = {}
    small_cam = make_camera(70, 45, device=dev)
    P = NUM_GAUSSIANS
    for case, arrays, ccam, (w, h), tiles in (
            ("70x45", small, small_cam, (70, 45), (ODD_SMALL_TILE,)),
            ("1080p", model_arrays(model), bench_cam, (WIDTH, HEIGHT),
             ODD_TILES)):
        bench = case == "1080p"
        with torch.no_grad():
            prep16, pairs16, _, _, kw16 = prepare_binned(arrays, ccam, w, h,
                                                         (16, 16))
            ref16 = gb.blend_global_forward(*blend_args(prep16, pairs16),
                                            **kw16)
            del prep16, pairs16
            cot = cotangents(w, h)
            for tile in tiles:
                name = f"{case} {tile[0]}x{tile[1]}"
                prep, pairs, view, segs, kw = prepare_binned(arrays, ccam, w,
                                                             h, tile)
                pkw = {**kw, "pieces": segs.pieces}
                args = blend_args(prep, view)
                st = {"pairs": pairs.num_rendered,
                      "pieces": int(segs.pieces.shape[0]),
                      "planes": segs.num_sub}
                st["k1"] = compare_kernel(f"{name} K1", args, pkw,
                                          count_evaluations=bench)
                fwd = gb.blend_global_forward(*args, **pkw)
                st["k1_bitwise_16x16"] = (torch.equal(fwd[0], ref16[0])
                                          and torch.equal(fwd[1], ref16[1]))
                check(st["k1_bitwise_16x16"], "tile",
                      f"{name}: K1's image is not the 16x16 grid's")
                k2_args = (*args[:6], *fwd[:3], *cot)
                warps = {}
                st["k2"], extra = compare_planes(
                    "tile", f"{name} K2", gb.blend_global_backward,
                    gb.blend_global_backward_plain, k2_args, pkw, segs,
                    bitwise=False,
                    plain_kw={"count_evaluations": True,
                              "warp_counts": warps} if bench else None)
                if bench:
                    planes = {"sub_tile": segs.sub_tile,
                              "num_sub": segs.num_sub, "pieces": segs.pieces}
                    st["k2"].update(evaluations=extra[0], blends=extra[1],
                                    **warps,
                                    footprint_kept_share=kept_share(warps))
                    st["ms"] = {
                        "k1": cuda_ms(lambda: gb.blend_global_forward(
                            *args, **pkw), 20),
                        "k2": cuda_ms(lambda: gb.blend_global_backward(
                            *k2_args, **kw, **planes), 20)}
                    N, T = pairs.num_rendered, segs.pieces.shape[0]
                    bounds = {
                        "k1": bound_ms(
                            4 * (N + 6 * T + P * 10 + WIDTH * HEIGHT * 6),
                            OPS_PER_EVAL * st["k1"]["evaluations_kept"]
                            + OPS_PER_BLEND * st["k1"]["blends"]),
                        "k2": bound_ms(
                            4 * (N + 7 * T + P * 9 + WIDTH * HEIGHT * 9
                                 + segs.num_sub * N * 9),
                            OPS_PER_EVAL * st["k2"]["evaluations_kept"]
                            + OPS_PER_BLEND_BWD * st["k2"]["blends"])}
                    st["bound_ms"] = {k: max(b) for k, b in bounds.items()}
                    st["bound_by"] = {
                        k: "bytes" if b[0] >= b[1] else "operations"
                        for k, b in bounds.items()}
                out[name] = st
                del prep, pairs, view, segs, args, fwd, k2_args
    for tile in ODD_TILES:
        with torch.no_grad():
            img, _ = render_model(model, cam, static=static, tile_shape=tile)
        same = torch.equal(img, img16)
        check(same, "tile", f"the API's image at {tile} is not the 16x16 one")
        out[f"1080p {tile[0]}x{tile[1]}"]["api_image_bitwise_16x16"] = same
    return out


def tile_only(dev):
    """Phase 23 with the inputs the run before it would make: the bench
    model, the bench and orbit cameras, phase 2's 70x45 scene, phase 5's
    settings and target and phase 4's cotangents. Returns its fields."""
    from stopthepop_tpu_torch.config import GaussianRasterizationSettings
    from stopthepop_tpu_torch.io.cameras import orbit_camera
    from stopthepop_tpu_torch.utils.testing import make_camera

    small = small_scene_arrays(dev)[0][1]
    bench_cam = make_camera(WIDTH, HEIGHT, campos=(0.0, 0.0, -4.0), device=dev)
    cams = [orbit_camera(2 * math.pi * i / FRAMES, math.radians(60.0), WIDTH,
                         HEIGHT) for i in range(FRAMES)]
    gen = torch.Generator(device=dev).manual_seed(7)

    def cotangents(width, height):
        return (torch.randn((3, height, width), generator=gen, device=dev),
                torch.randn((height, width), generator=gen, device=dev))

    static = GaussianRasterizationSettings(
        image_height=HEIGHT, image_width=WIDTH, tanfovx=bench_cam.tanfovx,
        tanfovy=bench_cam.tanfovy, bg=torch.zeros(3, device=dev),
        scale_modifier=1.0, viewmatrix=None, projmatrix=None,
        inv_viewprojmatrix=None, sh_degree=3, campos=None, prefiltered=False,
        settings=culled_settings())
    target = torch.rand((3, HEIGHT, WIDTH), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    return tile_phase(bench_model(dev), bench_cam, cams, small, static, target,
                      cotangents, dev)


def small_scene_arrays(dev):
    """The two 70x45 scenes of phases 2 and 7 (the second of larger
    Gaussians, whose windows overflow more): (case, arrays) each."""
    from stopthepop_tpu_torch.utils.testing import random_scene

    out = []
    for case, kw in (("70x45 random scene, 300 Gaussians", {}),
                     ("70x45 random scene, 300 larger Gaussians",
                      {"scale_range": (0.05, 0.4)})):
        sc = random_scene(0, 300, device=dev, **kw)
        out.append((case, {"means3d": sc.means3d, "opacities": sc.opacities,
                           "scales": sc.scales, "rotations": sc.rotations,
                           "shs": sc.shs}))
    return tuple(out)


def hier_frames(model, cams, settings, dev, batched):
    """HIER frames of ``model`` from ``cams`` through the API
    (render/cli.py::render_model), with the batched cascade where
    ``batched``: (colours, seconds)."""
    from stopthepop_tpu_torch.config import GaussianRasterizationSettings
    from stopthepop_tpu_torch.io.cameras import to_camera_arrays
    from stopthepop_tpu_torch.render.cli import render_model

    static = GaussianRasterizationSettings(
        image_height=HEIGHT, image_width=WIDTH, tanfovx=cams[0].tanfovx,
        tanfovy=cams[0].tanfovy, bg=torch.zeros(3, device=dev),
        scale_modifier=1.0, viewmatrix=None, projmatrix=None,
        inv_viewprojmatrix=None, sh_degree=3, campos=None, prefiltered=False,
        settings=settings)
    arrays = [to_camera_arrays(c, dev) for c in cams]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        colors = [render_model(model, a, static=static,
                               batched_cascade=batched)[0] for a in arrays]
    torch.cuda.synchronize()
    return colors, time.perf_counter() - t0


def cascade_phase(model, bench_cam, cams, static, target, cotangents, dev):
    """Phase 25: HIER's batched cascade (see the module notes). Returns the
    phase's fields."""
    from stopthepop_tpu_torch.config import GlobalSortOrder, SortMode
    from stopthepop_tpu_torch.io.cameras import CameraArrays
    from stopthepop_tpu_torch.kernels import hier_blend as hb
    from stopthepop_tpu_torch.kernels.blend_vjp import BlendHier
    from stopthepop_tpu_torch.render.cli import render_frames
    from stopthepop_tpu_torch.utils.testing import clone_trap_scene, make_camera

    out = {"sub_batch": hb.CASC_BATCH, "occupancy": {
        kernel: {f"MID,HEAD={m},{h} kt=64": hb.occupancy(kernel, 64, m, h,
                                                          batched=True)
                 for m in hb.MID_SIZES for h in hb.HEAD_SIZES}
        for kernel in (hb.KERNEL, hb.BWD_KERNEL)}}

    def both(case, args, kw, size, count_evaluations=False):
        """Batched K5 and K6 against their plain versions, to the bit, and
        how far the batched image lies from the per-entry one."""
        bkw = {**kw, "batched_cascade": True}
        st = {"case": case,
              "k5": compare_hier(case, args, bkw, phase="cascade",
                                 count_evaluations=count_evaluations)}
        st["k6"], bwd_args = compare_hier_bwd(
            case, args, bkw, cotangents(*size), phase="cascade",
            count_evaluations=count_evaluations)
        per_entry = hb.blend_hier_forward(*args, **kw)
        st["max_abs_diff_per_entry"] = float(
            (bwd_args[-5] - per_entry[0]).abs().max())
        return st, bwd_args

    # (a) The 70x45 scenes, the deep 32x32 scene and the clone trap scene.
    cases = []
    small_cam = make_camera(70, 45, device=dev)
    trap = clone_trap_scene(dev)
    trap_arrays = {"means3d": trap.means3d, "opacities": trap.opacities,
                   "scales": trap.scales, "rotations": trap.rotations,
                   "shs": trap.shs}
    with torch.no_grad():
        for case, arrays in small_scene_arrays(dev):
            for queues, cull in CASC_SMALL_CASES:
                prep, pairs, kw = prepare(arrays, small_cam, 70, 45,
                                          tile_based_culling=cull)
                st, _ = both(f"{case}, queues={queues}, culling={cull}",
                             hier_args(prep, pairs, small_cam),
                             {**kw, "queue_sizes": queues,
                              "hier_4x4_culling": cull}, (70, 45))
                cases.append({"pairs": pairs.num_rendered, **st})
        deep_case, (prep, pairs, kw), deep_cam = hier_deep_case(dev, "cascade")
        st, _ = both(deep_case, hier_args(prep, pairs, deep_cam),
                     {**kw, "queue_sizes": HIER_QUEUES,
                      "hier_4x4_culling": False},
                     (HIER_DEEP_SIZE, HIER_DEEP_SIZE))
        cases.append({"pairs": pairs.num_rendered, **st})
        trap_cam = make_camera(32, 32, device=dev)
        prep, pairs, kw = prepare(trap_arrays, trap_cam, 32, 32)
        st, _ = both("32x32 clone trap scene", hier_args(prep, pairs, trap_cam),
                     {**kw, "queue_sizes": (16, 8, 4),
                      "hier_4x4_culling": False}, (32, 32))
        cases.append({"pairs": pairs.num_rendered, **st})
    check(max(c["max_abs_diff_per_entry"] for c in cases) > 0.0, "cascade",
          "no scene tells the batched cascade from the per-entry one")
    out["cases"] = cases

    # (b) The bench frame at the default queues: bitwise, times, bounds, and
    # two full backward passes with the same bits.
    hkw_pe = {"queue_sizes": HIER_QUEUES, "hier_4x4_culling": False}
    with torch.no_grad():
        prep, pairs, kw = prepare(model_arrays(model), bench_cam, WIDTH, HEIGHT)
        args = hier_args(prep, pairs, bench_cam)
        hkw = {**kw, **hkw_pe}
        st, bwd_args = both("1080p", args, hkw, (WIDTH, HEIGHT),
                            count_evaluations=True)
        bkw = {**hkw, "batched_cascade": True}
        fwd_pe = hb.blend_hier_forward(*args, **hkw)
        bwd_pe = (*args, *fwd_pe[:3], *bwd_args[-2:])
        ms = {}
        for name, run in (
                ("k5_batched", lambda: hb.blend_hier_forward(*args, **bkw)),
                ("k5_per_entry", lambda: hb.blend_hier_forward(*args, **hkw)),
                ("k6_batched", lambda: hb.blend_hier_backward(*bwd_args,
                                                              **bkw)),
                ("k6_per_entry", lambda: hb.blend_hier_backward(*bwd_pe,
                                                                **hkw))):
            ms[name] = cuda_ms(run, 20)
        ms["k5_plain"] = cuda_ms(lambda: hb.blend_hier_forward_plain(
            *args, **bkw), 1, 0)
        ms["k6_plain"] = cuda_ms(lambda: hb.blend_hier_backward_plain(
            *bwd_args, **bkw), 1, 0)
    st["bitwise_repeat_backward"] = check_backward_repeats(
        "cascade", "BlendHier (batched)", prep,
        lambda *rows: BlendHier.apply(
            *rows, *args[6:], pairs, HIER_QUEUES, False, kw["grid_x"],
            kw["grid_y"], WIDTH, HEIGHT, None, None, True),
        cotangents(WIDTH, HEIGHT))
    N, T, P = pairs.num_rendered, kw["grid_x"] * kw["grid_y"], NUM_GAUSSIANS
    bounds = {
        "k5": bound_ms(4 * (N + 2 * T + P * 19 + 19 + WIDTH * HEIGHT * 6),
                       hier_ops(st["k5"], OPS_PER_COMMIT)),
        "k6": bound_ms(4 * (N + 2 * T + P * 19 + 19 + WIDTH * HEIGHT * 9
                            + N * 9),
                       hier_ops(st["k6"]["replay"], OPS_PER_COMMIT_BWD))}
    out["bench"] = {**st, "pairs": N, "ms": ms,
                    "bound_ms": {k: max(b) for k, b in bounds.items()},
                    "bound_by": {k: "bytes" if b[0] >= b[1] else "operations"
                                 for k, b in bounds.items()}}
    del prep, pairs, args, bwd_args, fwd_pe, bwd_pe

    # (c) The serving path: 4 orbit frames through the API, batched and
    # per-entry, each with the launch counts set to 0 just before it.
    hier_settings = culled_settings(SortMode.HIER)
    hier_frames(model, cams[:1], hier_settings, dev, True)  # warm-up
    for name, batched in (("frames_batched", True),
                          ("frames_per_entry", False)):
        reset_launches()
        colors, dt = hier_frames(model, cams, hier_settings, dev, batched)
        launches = read_launches()
        check(launched(launches, with_pairs({"k5": len(cams),
                                             "k8": len(cams)})),
              "cascade", f"{name}: launches {launches}")
        check(all(bool(torch.isfinite(c).all()) and bool((c != 0).any())
                  for c in colors), "cascade", f"{name}: a frame is not finite "
              "or is background")
        out[name] = {"frames": len(cams), "ms_per_frame": dt * 1e3 / len(cams),
                     "launches": launches}
        del colors

    # (d) Quality: frame 0 against the FULL render, batched and per-entry
    # (the bench model as phase 17 renders it, before any step).
    full_img = render_frames(model, cams[:1], culled_settings(SortMode.PPX_FULL),
                             dev)[0].color
    quality = {}
    for case, queues in CASC_QUALITY:
        q = culled_settings(SortMode.HIER)
        q.sort_settings.sort_order = GlobalSortOrder.PTD_MAX
        qs = q.sort_settings.queue_sizes
        qs.tile_4x4, qs.tile_2x2, qs.per_pixel = queues
        for batched in (True, False):
            img = hier_frames(model, cams[:1], q, dev, batched)[0][0]
            check(bool(torch.isfinite(img).all()), "cascade",
                  f"{case}: not finite")
            quality[f"{case} {'batched' if batched else 'per-entry'}"] = (
                psnr_stats(img, full_img))
    out["quality"] = quality

    # (e) The training step, 5 steps, batched.
    cam = CameraArrays(bench_cam.viewmatrix, bench_cam.projmatrix,
                       bench_cam.inv_viewprojmatrix, bench_cam.campos)
    out["train_batched"], _, _ = train_phase(
        "cascade_train", model, static._replace(settings=hier_settings), cam,
        target, dev, ("k5", "k6"), render_kwargs={"batched_cascade": True})
    return out


def cascade_only(dev):
    """Phase 25 with the inputs the run before it would make (the bench
    model and cameras, phase 5's settings and target, seeded cotangents).
    Returns its fields."""
    from stopthepop_tpu_torch.config import GaussianRasterizationSettings
    from stopthepop_tpu_torch.io.cameras import orbit_camera
    from stopthepop_tpu_torch.utils.testing import make_camera

    bench_cam = make_camera(WIDTH, HEIGHT, campos=(0.0, 0.0, -4.0), device=dev)
    cams = [orbit_camera(2 * math.pi * i / FRAMES, math.radians(60.0), WIDTH,
                         HEIGHT) for i in range(FRAMES)]
    gen = torch.Generator(device=dev).manual_seed(7)

    def cotangents(width, height):
        return (torch.randn((3, height, width), generator=gen, device=dev),
                torch.randn((height, width), generator=gen, device=dev))

    static = GaussianRasterizationSettings(
        image_height=HEIGHT, image_width=WIDTH, tanfovx=bench_cam.tanfovx,
        tanfovy=bench_cam.tanfovy, bg=torch.zeros(3, device=dev),
        scale_modifier=1.0, viewmatrix=None, projmatrix=None,
        inv_viewprojmatrix=None, sh_degree=3, campos=None, prefiltered=False,
        settings=culled_settings())
    target = torch.rand((3, HEIGHT, WIDTH), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    return cascade_phase(bench_model(dev), bench_cam, cams, static, target,
                         cotangents, dev)


def parallel_settings(cam, mode):
    """Raster settings of the parallel phase for a camera with ``tanfovx``
    and ``tanfovy``: the bench culling, Z_DEPTH, ``mode`` with the default
    queues (the k-buffer window KB_K, the HIER queues HIER_QUEUES)."""
    from stopthepop_tpu_torch.config import GaussianRasterizationSettings

    return GaussianRasterizationSettings(
        image_height=HEIGHT, image_width=WIDTH, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=torch.zeros(3), scale_modifier=1.0,
        viewmatrix=None, projmatrix=None, inv_viewprojmatrix=None,
        sh_degree=3, campos=None, prefiltered=False,
        settings=culled_settings(mode))


def max_err(a, b):
    return float((a - b).detach().abs().max())


def image_check(what, img, ref, tol):
    """{max_abs_err, pixels_differing, tolerance} of a render against its
    single-device reference, which it must match within ``tol``."""
    check(img.shape == ref.shape, "parallel", f"{what}: shape {tuple(img.shape)}")
    diff = (img - ref).abs().amax(dim=0)
    fields = {"max_abs_err": float(diff.max()),
              "pixels_differing": int((diff > 0).sum()), "tolerance": tol}
    check(fields["max_abs_err"] <= tol, "parallel", f"{what}: {fields}")
    return fields


def band_stages(shard, model, cam, st, rank, world):
    """The stages of this rank's band frame (``spatial.band_render`` without
    gradients, then ``gather_bands``), each timed alone with CUDA events
    (mean of 10 calls; collectives on every rank together), beside the
    single-device frame's preprocess and render of the same camera; and
    ``render_band`` of the band with no Gaussian in it, at the image's size
    (how the port renders a band) and at the band's size (a one-band image
    of band_h rows), their difference the cost of the full-size tile grid
    and outputs alone, forward and (with K2) backward in GLOBAL."""
    import torch.distributed as dist

    from stopthepop_tpu_torch.config import SortMode
    from stopthepop_tpu_torch.parallel import collectives, spatial
    from stopthepop_tpu_torch.render.duplicate import build_pairs

    group = dist.group.WORLD
    dev = shard.means3d.device
    rs = spatial._with_camera(st, cam, dev)
    cfg = spatial.plan_bands(WIDTH, HEIGHT, world)
    one = spatial.plan_bands(WIDTH, HEIGHT, 1)
    banded = spatial.plan_bands(WIDTH, cfg.band_h, 1)
    ms = functools.partial(cuda_ms, iters=10)
    with torch.no_grad():
        feat, ints = spatial._preprocess_features(shard, rs)
        feat_all = collectives.all_gather_plain(feat, group)
        ints_all = collectives.all_gather_plain(ints, group)
        empty = ints_all.clone()
        empty[:, 4] = 0  # no row valid: no pair in any tile
        feat1, ints1 = spatial._preprocess_features(model, rs)
        color, _ = spatial.render_band(feat_all, ints_all, rank, cfg, cam, st)

        def pairs(f, i, band, c):
            return build_pairs(
                spatial._band_prep(f, i, band, c), grid_x=c.grid_x,
                grid_y=c.grid_y,
                sort_order=st.settings.sort_settings.sort_order,
                campos=rs.campos, inverse_vp=rs.inv_viewprojmatrix,
                image_width=c.image_width, image_height=c.image_height)

        out = {
            "pairs_band": pairs(feat_all, ints_all, rank, cfg).num_rendered,
            "pairs_image": pairs(feat1, ints1, 0, one).num_rendered,
            "preprocess_shard": ms(
                lambda: spatial._preprocess_features(shard, rs)),
            "all_gather_features": ms(lambda: (
                collectives.all_gather_plain(feat, group),
                collectives.all_gather_plain(ints, group))),
            "band_pairs": ms(lambda: pairs(feat_all, ints_all, rank, cfg)),
            "render_band": ms(lambda: spatial.render_band(
                feat_all, ints_all, rank, cfg, cam, st)),
            "gather_bands": ms(lambda: spatial.gather_bands(color, cfg, group)),
            "single_preprocess": ms(
                lambda: spatial._preprocess_features(model, rs)),
            "single_render": ms(lambda: spatial.render_band(
                feat1, ints1, 0, one, cam, st)),
            "no_pairs_image_size": ms(lambda: spatial.render_band(
                feat_all, empty, rank, cfg, cam, st)),
            "no_pairs_band_size": ms(lambda: spatial.render_band(
                feat_all, empty, 0, banded, cam, st)),
        }
    out["full_size_cost"] = out["no_pairs_image_size"] - out["no_pairs_band_size"]
    if st.settings.sort_settings.sort_mode == SortMode.GLOBAL:
        def fwd_bwd(c, band):
            f = feat_all.detach().requires_grad_(True)
            spatial.render_band(f, empty, band, c, cam, st)[0].sum().backward()

        out["no_pairs_fwd_bwd_image_size"] = ms(lambda: fwd_bwd(cfg, rank))
        out["no_pairs_fwd_bwd_band_size"] = ms(lambda: fwd_bwd(banded, 0))
    return out


def parallel_rank(rank, out_dir):
    """One rank of phase ``parallel`` (started by ``hosts.launch``, one
    process per card, NCCL): checks (a)-(d) on the bench scene; writes its
    fields to ``out_dir/rank<rank>.json``. Every sharded path runs with the
    launch counts set to 0 just before it and read just after."""
    import torch.distributed as dist

    from stopthepop_tpu_torch.config import SortMode
    from stopthepop_tpu_torch.io.cameras import CameraArrays, orbit_camera, to_camera_arrays
    from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES, row_block
    from stopthepop_tpu_torch.parallel import collectives, hosts, ring, spatial
    from stopthepop_tpu_torch.parallel import train as ptrain
    from stopthepop_tpu_torch.render.cli import render_model
    from stopthepop_tpu_torch.train.loss import rgb_loss
    from stopthepop_tpu_torch.train.trainer import make_optimizer
    from stopthepop_tpu_torch.utils.testing import make_camera

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)  # this rank's card (hosts.initialize)
    world = dist.get_world_size()
    model = bench_model(dev)
    bench = make_camera(WIDTH, HEIGHT, campos=(0.0, 0.0, -4.0), device=dev)
    cam = CameraArrays(bench.viewmatrix, bench.projmatrix,
                       bench.inv_viewprojmatrix, bench.campos)
    orbit = [to_camera_arrays(orbit_camera(2 * math.pi * i / FRAMES,
                                           math.radians(60.0), WIDTH, HEIGHT),
                              dev) for i in range(FRAMES)]
    orbit_tan = orbit_camera(0.0, math.radians(60.0), WIDTH, HEIGHT)
    # Every rank's target of check (a); target, the first, is the image the
    # band steps cut into bands.
    targets = [torch.rand((3, HEIGHT, WIDTH), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1 + r))
               for r in range(world)]
    target = targets[0]
    # mode: (sort mode, forward kernel, backward kernel, image tolerance)
    modes = {"GLOBAL": (SortMode.GLOBAL, "k1", "k2", ATOL),
             "PPX_KBUFFER": (SortMode.PPX_KBUFFER, "k3", "k4", 1e-4),
             "HIER": (SortMode.HIER, "k5", "k6", 1e-4)}
    fields = {"rank": rank, "world_size": world}

    def timed(fn):
        """(fn()'s result, its ms, launches, peak GiB): the counts set to
        0 just before, read just after."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3, read_launches(),
                torch.cuda.max_memory_allocated() / 2**30)

    def only(launches, want, what):
        want = with_pairs(want)
        check(launched(launches, want), "parallel",
              f"rank {rank} {what}: launches {launches}, want {want}")

    def single_grads(static):
        """The single-device loss and gradients at the bench camera."""
        ref = row_block(model, 0, 1)
        loss = rgb_loss(render_model(ref, cam, static=static)[0], target)
        loss.backward()
        return float(loss), {k: getattr(ref, k).grad for k in PARAM_NAMES}

    def step_check(name, step, shard, static, kernels):
        loss_ref, grads_ref = single_grads(static)
        opt = make_optimizer(shard.parameters())
        tgt = spatial.band_rows(target, spatial.plan_bands(WIDTH, HEIGHT, world),
                                rank)
        (_, _, loss), ms, launches, peak = timed(
            lambda: step(shard, opt, cam, tgt))
        only(launches, {k: 1 for k in kernels}, name)
        rows = slice(rank * (NUM_GAUSSIANS // world),
                     (rank + 1) * (NUM_GAUSSIANS // world))
        err = {k: max_err(getattr(shard, k).grad, g[rows])
               / max(float(g.abs().max()), 1e-30) for k, g in grads_ref.items()}
        check(abs(float(loss) - loss_ref) <= 2e-5 * (1 + abs(loss_ref))
              and max(err.values()) <= 1e-4, "parallel",
              f"rank {rank} {name}: loss {float(loss)} vs {loss_ref}, "
              f"gradient error {err}")
        warm = [timed(lambda: step(shard, opt, cam, tgt))[1] for _ in range(2)]
        return {"ms_per_step": ms, "ms_per_step_warm": warm,
                "loss": float(loss), "loss_single": loss_ref,
                "grad_err_of_max": err, "launches": launches,
                "peak_mem_gib": peak}

    # (a) the ("data", "gauss") step against the single-device step on the
    # mean loss of every rank's target: each rank renders the bench camera
    # against a target of its own, so that the "gauss" reduce-scatter and
    # the "data" all-reduce sum gradients that differ.
    static = parallel_settings(bench, SortMode.GLOBAL)
    mesh = ptrain.make_mesh()
    step, n_batch = ptrain.make_sharded_train_step(mesh, static=static)
    shard = ptrain.shard_model(mesh, model)
    ref = row_block(model, 0, 1)
    ref_opt = make_optimizer(ref.parameters())
    loss_ref = 0.0
    for t in targets:
        loss_t = rgb_loss(render_model(ref, cam, static=static)[0], t) / world
        loss_t.backward()
        loss_ref += float(loss_t.detach())
    grads_ref = {k: getattr(ref, k).grad.clone() for k in PARAM_NAMES}
    ref_opt.step()
    opt = make_optimizer(shard.parameters())
    (_, _, loss), ms, launches, peak = timed(
        lambda: step(shard, opt, cam, targets[rank]))
    only(launches, {"k1": 1, "k2": 1}, "data x gauss step")
    g_rows = slice(mesh.get_local_rank("gauss") * shard.num_gaussians,
                   (mesh.get_local_rank("gauss") + 1) * shard.num_gaussians)
    grad_err = {k: max_err(getattr(shard, k).grad, g[g_rows])
                / max(float(g.abs().max()), 1e-30) for k, g in grads_ref.items()}
    # Adam's first step moves a parameter by lr * g / (|g| + eps), about
    # lr * sign(g): where the mean gradient lies within the rounding of its
    # sum over the ranks its sign, and so the parameter, may differ by 2 lr.
    # With one rank every parameter is held; with more, those whose mean
    # gradient exceeds 1e-5 of its tensor's largest, far above that
    # rounding (about 1e-7 of the terms for a sum of 4).
    held = {k: (g[g_rows].abs() > (1e-5 * float(g.abs().max()) if world > 1
                                    else -1.0)) for k, g in grads_ref.items()}
    param_err = {k: max_err(getattr(shard, k)[held[k]],
                            getattr(ref, k)[g_rows][held[k]])
                 for k in PARAM_NAMES}
    bitwise = (float(loss) == loss_ref and max(param_err.values()) == 0.0
               and max(grad_err.values()) == 0.0)
    check(abs(float(loss) - loss_ref) <= 1e-5 * abs(loss_ref)
          and max(param_err.values()) <= 1e-5
          and max(grad_err.values()) <= 1e-4, "parallel",
          f"rank {rank} data x gauss: loss {float(loss)} vs {loss_ref}, "
          f"parameters {param_err}, gradient error {grad_err}")
    steps_ms = []
    for _ in range(3):
        _, ms_i, _, _ = timed(lambda: step(shard, opt, cam, targets[rank]))
        steps_ms.append(ms_i)
    fields["a_data_gauss"] = {
        "mesh": list(mesh.shape), "n_batch": n_batch, "first_step_ms": ms,
        "ms_per_step": steps_ms, "loss": float(loss), "loss_single": loss_ref,
        "param_max_abs_err": param_err,
        "params_held": {k: int(m.sum()) for k, m in held.items()},
        "grad_err_of_max": grad_err, "bitwise": bitwise,
        "launches": launches, "peak_mem_gib": peak}
    del ref, ref_opt, shard, opt, grads_ref, held

    # (b) and (c): band-sharded and ring-streamed renders and steps.
    for key, axis, make_render, make_step in (
            ("b_spatial", "tiles",
             lambda m, st: spatial.make_spatial_render(m, static=st),
             lambda m, st: spatial.make_spatial_train_step(m, static=st)),
            ("c_ring", "shards",
             lambda m, st: ring.make_ring_render(
                 m, static=st, per_step_capacity=RING_CAPACITY),
             lambda m, st: ring.make_ring_train_step(
                 m, static=st, per_step_capacity=RING_CAPACITY))):
        mesh = hosts.global_mesh((axis,))
        shard = spatial.shard_model(model, mesh, axis)
        out = {}
        for name, (mode, kernel, _, tol) in modes.items():
            st = parallel_settings(orbit_tan, mode)
            render, _ = make_render(mesh, st)
            with torch.no_grad():
                render(shard, orbit[0])  # warm-up
                imgs, ms, launches, peak = timed(
                    lambda: [render(shard, c) for c in orbit])
                frames = []
                for i, (img, c) in enumerate(zip(imgs, orbit)):
                    if key == "c_ring":
                        img, overflow = img
                        check(not overflow, "parallel", f"ring {name}: overflow")
                    frames.append(image_check(
                        f"rank {rank} {key} {name} frame {i}", img,
                        render_model(model, c, static=st)[0], tol))
            only(launches, {kernel: FRAMES, "k8": FRAMES},
                 f"{key} {name} render")
            out[name] = {"ms_per_frame": ms / FRAMES, "frames": frames,
                         "launches": launches, "peak_mem_gib": peak}
        # The band-sharded step in every mode (K2, K4, K6); the ring's in
        # GLOBAL.
        for name in (modes if key == "b_spatial" else ("GLOBAL",)):
            mode, fwd, bwd, _ = modes[name]
            st = parallel_settings(bench, mode)
            out[f"{name}_step"] = step_check(
                f"{key} {name} step", make_step(mesh, st),
                spatial.shard_model(model, mesh, axis), st, (fwd, bwd))
        fields[key] = out

    # Where a band frame's time goes, and what rendering a band at the
    # image's size costs (CUDA events, mean of 10 calls, orbit frame 0).
    fields["band_stages_ms"] = {
        name: band_stages(row_block(model, rank, world), model, orbit[0],
                          parallel_settings(orbit_tan, mode), rank, world)
        for name, (mode, _, _, _) in modes.items()}

    # The collectives at the shapes these paths give them (CUDA events).
    group = dist.group.WORLD
    with torch.no_grad():
        feat, ints = spatial._preprocess_features(
            row_block(model, rank, world),
            spatial._with_camera(static, cam, dev))
        params = [getattr(model, k).detach() for k in PARAM_NAMES]
        blocks = [p[:p.shape[0] // world].contiguous() for p in params]
        perm = [(i, (i + 1) % world) for i in range(world)]
        band = spatial.band_rows(target, spatial.plan_bands(WIDTH, HEIGHT, world),
                                 rank)
        fields["collectives_ms"] = {
            "all_gather_features": cuda_ms(
                lambda: (collectives.all_gather_plain(feat, group),
                         collectives.all_gather_plain(ints, group)), 10),
            "all_gather_parameters": cuda_ms(lambda: [
                collectives.all_gather_plain(b, group) for b in blocks], 10),
            "reduce_scatter_gradients": cuda_ms(lambda: [
                collectives.reduce_scatter_plain(p, group) for p in params], 10),
            "halo_exchange": cuda_ms(lambda: collectives.halo_exchange_plain(
                band, spatial.HALO, group), 10),
            "ppermute_features": cuda_ms(lambda: (
                collectives.ppermute_plain(feat, perm, group),
                collectives.ppermute_plain(ints, perm, group)), 10),
        }
        del feat, ints, params, blocks

    # (d) n > 1 on one card: the collective-free cores, 4 bands, 4 shards.
    if rank == 0:
        cfg = spatial.plan_bands(WIDTH, HEIGHT, PAR_BANDS)
        out = {}
        for name in ("GLOBAL", "HIER"):
            mode, kernel, _, tol = modes[name]
            st = parallel_settings(bench, mode)
            rs = spatial._with_camera(st, cam, dev)
            with torch.no_grad():
                ref_img = render_model(model, cam, static=st)[0]
                tables = [spatial._preprocess_features(
                    row_block(model, i, PAR_BANDS), rs) for i in range(PAR_BANDS)]
                feat = torch.cat([t[0] for t in tables])
                ints = torch.cat([t[1] for t in tables])

                def spatial_core():
                    return torch.cat([spatial.render_band(
                        feat, ints, b, cfg, cam, st)[0]
                        for b in range(PAR_BANDS)], dim=1)[:, :HEIGHT]

                def ring_core():
                    bands = []
                    for b in range(PAR_BANDS):
                        steps = [ring.ring_step(*tables[(b - s) % PAR_BANDS], b,
                                                cfg, cam, st)
                                 for s in range(PAR_BANDS)]
                        bands.append(ring.ring_blend(steps, b, cfg, cam, st)[0])
                    return torch.cat(bands, dim=1)[:, :HEIGHT]

                for core, fn in (("render_band", spatial_core),
                                 ("ring_step", ring_core)):
                    img, ms, launches, peak = timed(fn)
                    only(launches, {kernel: PAR_BANDS}, f"{core} {name}")
                    out[f"{core}_{name}"] = {
                        "bands": PAR_BANDS, "ms": ms,
                        **image_check(f"{core} {name}, {PAR_BANDS} bands",
                                      img, ref_img, tol),
                        "launches": launches, "peak_mem_gib": peak}
                del tables, feat, ints
        fields["d_cores_one_card"] = out
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(fields, f)


def parallel_phase(out_dir):
    """parallel: one process per card (``parallel/hosts.py::launch``, NCCL,
    a file store), each running ``parallel_rank``; a rank that fails makes
    the phase fail. Returns every rank's fields."""
    import shutil

    from stopthepop_tpu_torch.parallel import hosts

    res = out_dir / "parallel"
    shutil.rmtree(res, ignore_errors=True)
    res.mkdir(parents=True)
    world = torch.cuda.device_count()
    rc = hosts.launch(parallel_rank, world, device="cuda", args=(str(res),))
    check(rc == 0, "parallel", f"a rank failed (launch returned {rc})")
    ranks = []
    for r in range(world):
        with open(res / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return {"world_size": world, "ranks": ranks}


def _wrappers():
    from stopthepop_tpu_torch.kernels import (
        full_blend,
        global_blend,
        hier_blend,
        kbuffer_blend,
        pairs,
        preprocess_fwd,
    )

    return {"k1": global_blend.blend_global_forward,
            "k2": global_blend.blend_global_backward,
            "k3": kbuffer_blend.blend_kbuffer_forward,
            "k4": kbuffer_blend.blend_kbuffer_backward,
            "k5": hier_blend.blend_hier_forward,
            "k6": hier_blend.blend_hier_backward,
            "k7": full_blend.blend_full_forward,
            "k8": preprocess_fwd.preprocess_fwd,
            "pairs_dup": pairs.duplicate_with_keys,
            "pairs_sort": pairs.sort_and_identify}


PAIRS_KERNELS = ("pairs_dup", "pairs_sort")
FORWARD_KERNELS = ("k1", "k3", "k5", "k7")


def with_pairs(want):
    """``want`` with the pair stream's kernels (kernels/pairs.py) launched
    once a forward blend (K1, K3, K5, K7): every render of this run that
    builds its pairs in Z_DEPTH without tile-based culling takes them."""
    n = sum(want.get(k, 0) for k in FORWARD_KERNELS)
    return {**want, **dict.fromkeys(PAIRS_KERNELS, n)}


def launched(launches, want):
    """Whether ``launches`` holds each count of ``want`` and 0 for every
    other kernel."""
    return all(n == want.get(k, 0) for k, n in launches.items())


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    """{"k1": n, ..., "k8": n, "pairs_dup": n, "pairs_sort": n} kernel
    launches since the reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def hier_occupancy():
    """Resident blocks per SM, registers, spill bytes and shared bytes of
    every K5 and K6 instantiation at tail sizes 64 and 512, on this card."""
    from stopthepop_tpu_torch.kernels import hier_blend as hb

    return {kernel: {f"MID,HEAD={m},{h} kt={kt}": hb.occupancy(kernel, kt, m, h)
                     for m in hb.MID_SIZES for h in hb.HEAD_SIZES
                     for kt in (64, hb.TAIL_MAX)}
            for kernel in (hb.KERNEL, hb.BWD_KERNEL)}


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers.*?(\d+) bytes smem")


def ptxas_summary(log: str):
    """{instantiation: {registers, spill_stores, spill_loads, smem}} from
    nvcc's -Xptxas -v output; a template's key is its MAX_K, or its
    (MID_MAX, HEAD_MAX) for K5 and K6 ("batched" added for the batched
    cascade's), or "kernel" for K1 and K2."""
    out, key = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            k = re.findall(r"Li(\d+)E", m.group(1))
            key = (f"MAX_K={k[0]}" if len(k) == 1 else
                   f"MID,HEAD={','.join(k)}"
                   + (" batched" if "Lb1E" in m.group(1) else "")
                   if len(k) == 2 else "kernel")
            out[key] = {}
        elif key and (m := _SPILL.search(line)):
            out[key]["spill_stores"], out[key]["spill_loads"] = map(int, m.groups())
        elif key and (m := _USED.search(line)):
            out[key]["registers"], out[key]["smem"] = map(int, m.groups())
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    want_profile = "--profile" in args
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if "--io-only" in args:
        card = card_line()
        t0 = time.perf_counter()
        fields = io_phase(ROOT / "build" / "chip_smoke", torch.device(DEVICE))
        emit({"phase": "io", "ok": True, **fields,
              "seconds": time.perf_counter() - t0, "card": card})
        print(card)
        return 0
    from stopthepop_tpu_torch.io.cameras import orbit_camera
    from stopthepop_tpu_torch.io.ply import load_gaussian_model, save_gaussian_model
    from stopthepop_tpu_torch.kernels import build, global_blend
    from stopthepop_tpu_torch.kernels.blend_vjp import (
        BlendGlobal,
        BlendHier,
        BlendKBuffer,
    )
    from stopthepop_tpu_torch.models.gaussians import to_numpy_params
    from stopthepop_tpu_torch.render.cli import render_model
    from stopthepop_tpu_torch.utils.testing import make_camera

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build(build.all_sources())
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build.build_host(["png_io", "ply_io"])
    host_build_s = time.perf_counter() - t0
    emit({"phase": "build", "ok": True, "seconds": build_s,
          "host_build_s": host_build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels": {
              n: {"seconds": log["seconds"], "ptxas": ptxas_summary(log["ptxas"])}
              for n, log in build.build_log.items()
          },
          "hier_occupancy": hier_occupancy()})
    if "--tile-only" in args:
        t0 = time.perf_counter()
        fields = tile_only(dev)
        emit({"phase": "tile", "ok": True, **fields,
              "seconds": time.perf_counter() - t0, "card": card})
        print(card)
        return 0
    if "--parallel-only" in args:
        t0 = time.perf_counter()
        fields = parallel_phase(ROOT / "build" / "chip_smoke")
        emit({"phase": "parallel", "ok": True, **fields,
              "seconds": time.perf_counter() - t0, "card": card})
        print(card)
        return 0
    if "--cascade-only" in args:
        t0 = time.perf_counter()
        fields = cascade_only(dev)
        emit({"phase": "cascade", "ok": True, **fields,
              "seconds": time.perf_counter() - t0, "card": card})
        print(card)
        return 0
    if "--preprocess-only" in args:
        for line in preprocess_phase(dev):
            emit({"phase": "kernel_preprocess", "ok": True, **line,
                  "card": card})
        print(card)
        return 0
    if "--pairs-only" in args:
        for line in pairs_phase(dev):
            emit({"phase": "kernel_pairs", "ok": True, **line, "card": card})
        print(card)
        return 0
    if "--full-only" in args:
        for line in full_shapes_phase(dev):
            emit({"phase": "kernel_full", "ok": True, **line, "card": card})
        print(card)
        return 0

    # 2. kernel against plain version -----------------------------------------
    small_scenes = small_scene_arrays(dev)
    small = small_scenes[0][1]
    prep, pairs, kw = prepare(small, make_camera(70, 45, device=dev), 70, 45)
    small_args, small_kw = blend_args(prep, pairs), kw
    small_stats = compare_kernel("70x45", small_args, small_kw)
    emit({"phase": "kernel", "ok": True, "case": "70x45 random scene, 300 Gaussians",
          "pairs": pairs.num_rendered, **small_stats})
    # K1 on deep segments: many staged batches a tile.
    deep_case, (prep, pairs, dkw), _ = hier_deep_case(dev, "kernel")
    deep_stats = compare_kernel(deep_case, blend_args(prep, pairs), dkw)
    emit({"phase": "kernel", "ok": True, "case": deep_case,
          "pairs": pairs.num_rendered, **deep_stats})
    model = bench_model(dev)
    with torch.inference_mode():
        bench_cam = make_camera(WIDTH, HEIGHT, campos=(0.0, 0.0, -4.0), device=dev)
        prep, pairs, kw = prepare(model_arrays(model), bench_cam, WIDTH, HEIGHT)
        bargs = blend_args(prep, pairs)
        full_stats = compare_kernel("1080p", bargs, kw, count_evaluations=True)
        k1_ms = cuda_ms(lambda: global_blend.blend_global_forward(*bargs, **kw), 20)
        plain_ms = cuda_ms(
            lambda: global_blend.blend_global_forward_plain(*bargs, **kw), 2, 1)
    P, N, T = NUM_GAUSSIANS, pairs.num_rendered, kw["grid_x"] * kw["grid_y"]
    bytes_moved = 4 * (N + 6 * T + P * (2 + 4 + 3 + 1) + WIDTH * HEIGHT * 6)
    # The evaluations K1 needs: those in the warps its footprint test keeps
    # (the bound over all of them beside it).
    ops = (OPS_PER_EVAL * full_stats["evaluations_kept"]
           + OPS_PER_BLEND * full_stats["blends"])
    ops_all = (OPS_PER_EVAL * full_stats["evaluations"]
               + OPS_PER_BLEND * full_stats["blends"])
    bytes_ms, ops_ms = bound_ms(bytes_moved, ops)
    emit({"phase": "kernel", "ok": True,
          "case": "1920x1080, 500K Gaussians, bench camera", "pairs": N,
          **full_stats, "k1_ms": k1_ms, "plain_ms": plain_ms,
          "bytes": bytes_moved, "ops": ops, "bytes_bound_ms": bytes_ms,
          "ops_bound_ms": ops_ms, "ops_all_evaluations": ops_all,
          "ops_bound_ms_all_evaluations": bound_ms(bytes_moved, ops_all)[1],
          "occupancy": global_blend.occupancy_fwd(),
          "ptxas": ptxas_summary(build.build_log.get(
              global_blend.KERNEL, {}).get("ptxas", "")).get("kernel"),
          "card": card})

    # 3. main path --------------------------------------------------------------
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ply = out_dir / "model_500k.ply"
    t0 = time.perf_counter()
    save_gaussian_model(str(ply), model)
    loaded = load_gaussian_model(str(ply), device=dev)
    io_s = time.perf_counter() - t0
    saved = to_numpy_params(model)
    for k, v in to_numpy_params(loaded).items():
        check((v == saved[k]).all(), "main", f"PLY round trip changed {k}")
    ply.unlink()
    del saved
    cams = [orbit_camera(2 * math.pi * i / FRAMES, math.radians(60.0), WIDTH, HEIGHT)
            for i in range(FRAMES)]
    settings = culled_settings()
    fields, serve_main = serve_phase(
        "main", loaded, cams, settings, "k1",
        lambda prep, pairs, cam: blend_args(prep, pairs),
        functools.partial(global_blend.blend_global_forward, **kw), dev)
    emit({"phase": "main", "ok": True, **fields, "ply_save_load_s": io_s,
          "card": card})
    del loaded

    # 4. kernel K2 against its plain version ------------------------------------
    gen = torch.Generator(device=dev).manual_seed(7)

    def cotangents(width, height):
        return (torch.randn((3, height, width), generator=gen, device=dev),
                torch.randn((height, width), generator=gen, device=dev))

    with torch.no_grad():
        small_bwd, _ = compare_kernel_bwd("70x45", small_args, small_kw,
                                          cotangents(70, 45))
    emit({"phase": "kernel_bwd", "ok": True,
          "case": "70x45 random scene, 300 Gaussians", **small_bwd})
    # K2 on deep segments: many staged batches a tile.
    deep_case, (prep, pairs, dkw), _ = hier_deep_case(dev, "kernel_bwd")
    with torch.no_grad():
        deep_bwd, _ = compare_kernel_bwd(
            deep_case, blend_args(prep, pairs), dkw,
            cotangents(HIER_DEEP_SIZE, HIER_DEEP_SIZE))
    emit({"phase": "kernel_bwd", "ok": True, "case": deep_case,
          "pairs": pairs.num_rendered, **deep_bwd})
    bench_cam = make_camera(WIDTH, HEIGHT, campos=(0.0, 0.0, -4.0), device=dev)
    with torch.no_grad():
        prep, pairs, kw = prepare(model_arrays(model), bench_cam, WIDTH, HEIGHT)
    cot = cotangents(WIDTH, HEIGHT)
    with torch.no_grad():
        full_bwd, k2_args = compare_kernel_bwd("1080p", blend_args(prep, pairs),
                                               kw, cot, count_evaluations=True)
        k2_ms = cuda_ms(lambda: global_blend.blend_global_backward(*k2_args, **kw), 20)
        k2_plain_ms = cuda_ms(
            lambda: global_blend.blend_global_backward_plain(*k2_args, **kw), 1, 0)
    full_bwd["bitwise_repeat_backward"] = check_backward_repeats(
        "kernel_bwd", "BlendGlobal", prep,
        lambda *rows: BlendGlobal.apply(
            *rows, prep.depth.detach().contiguous(), pairs, kw["grid_x"],
            kw["grid_y"], kw["width"], kw["height"]), cot)
    N = pairs.num_rendered
    k2_bytes = 4 * (N + 6 * T + P * (2 + 4 + 3) + WIDTH * HEIGHT * 9 + N * 9)
    # The evaluations K2 needs: those in the warps its footprint test keeps.
    k2_ops = (OPS_PER_EVAL * full_bwd["evaluations_kept"]
              + OPS_PER_BLEND_BWD * full_bwd["blends"])
    k2_bytes_ms = k2_bytes / PEAK_BYTES_S * 1e3
    k2_ops_ms = k2_ops / PEAK_FP32_S * 1e3
    emit({"phase": "kernel_bwd", "ok": True,
          "case": "1920x1080, 500K Gaussians, bench camera", "pairs": N,
          **full_bwd, "k2_ms": k2_ms, "plain_ms": k2_plain_ms,
          "bytes": k2_bytes, "ops": k2_ops, "bytes_bound_ms": k2_bytes_ms,
          "ops_bound_ms": k2_ops_ms,
          "occupancy": global_blend.occupancy_bwd(),
          "ptxas": ptxas_summary(build.build_log.get(
              global_blend.BWD_KERNEL, {}).get("ptxas", "")).get("kernel"),
          "card": card})
    del prep, pairs, k2_args, cot

    # 5. train: the training step at full width ----------------------------------
    from stopthepop_tpu_torch.config import GaussianRasterizationSettings
    from stopthepop_tpu_torch.io.cameras import CameraArrays
    from stopthepop_tpu_torch.train.loss import rgb_loss

    static = GaussianRasterizationSettings(
        image_height=HEIGHT, image_width=WIDTH, tanfovx=bench_cam.tanfovx,
        tanfovy=bench_cam.tanfovy, bg=torch.zeros(3, device=dev),
        scale_modifier=1.0, viewmatrix=None, projmatrix=None,
        inv_viewprojmatrix=None, sh_degree=3, campos=None, prefiltered=False,
        settings=settings,
    )
    cam = CameraArrays(bench_cam.viewmatrix, bench_cam.projmatrix,
                       bench_cam.inv_viewprojmatrix, bench_cam.campos)
    target = torch.rand((3, HEIGHT, WIDTH), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    train_fields, stats, one_step = train_phase(
        "train", model, static, cam, target, dev, ("k1", "k2"))
    visible = stats.max_radii > 0
    check(bool(visible.any()) and bool((stats.denom[visible] > 0).all())
          and bool(torch.isfinite(stats.grad2d_accum).all()), "train",
          "densification stats")
    # The loss alone (L1 + D-SSIM at 1080p), forward and backward, on the
    # last rendered image.
    stage = train_fields["stage_ms"]
    with torch.no_grad():
        color, _ = render_model(model, cam, static=static)
    color = color.detach().requires_grad_(True)
    stage["loss_forward_ms"] = cuda_ms(lambda: rgb_loss(color, target), 10)
    stage["loss_backward_ms"] = cuda_ms(
        lambda: torch.autograd.grad(rgb_loss(color, target), color),
        10) - stage["loss_forward_ms"]
    del color
    emit({"phase": "train", "ok": True, **train_fields, "card": card})
    if want_profile:
        emit({"phase": "train_profile", "ok": True, "steps": 3,
              **profile_steps(one_step, 3, train_fields["ms_per_step"]),
              "card": card})
    del stats, one_step, model

    # 6. train_cli: the training entry point at small size ----------------------
    from stopthepop_tpu_torch.io.ply import load_gaussian_model as load_ply
    from stopthepop_tpu_torch.train import cli as train_cli
    from stopthepop_tpu_torch.utils.synthetic import (
        structured_scene,
        write_nerf_synthetic,
    )

    data = out_dir / "nerf_synthetic"
    gt, extent = structured_scene(CLI_SCENE, seed=0, device=dev)
    write_nerf_synthetic(str(data), gt, views=CLI_VIEWS, size=CLI_SIZE, device=dev)
    out_ply = out_dir / "trained.ply"
    init_points = CLI_INIT
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # the CLI's progress lines
        res = train_cli.main([
            "--data", str(data), "--iters", str(CLI_ITERS),
            "--init-points", str(init_points), "--scene-extent", str(extent),
            "--densify-from", "50", "--densify-every", "50",
            "--opacity-reset-every", "150", "--densify-until", "250",
            "--eval-every", "100",
            "--sh-ramp-every", "100", "--out", str(out_ply),
            "--sort-mode", "GLOBAL", "--device", str(dev), "--seed", "0",
        ])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli = read_launches()
    cli_k1, cli_k2 = cli["k1"], cli["k2"]
    evals = [res.eval_psnr[k] for k in sorted(res.eval_psnr)]
    trained = load_ply(str(out_ply), device=dev)
    check(all(math.isfinite(v) for v in evals) and evals[-1] > evals[0],
          "train_cli", f"eval PSNR did not rise: {res.eval_psnr}")
    check(res.num_gaussians and res.num_gaussians[-1] != init_points,
          "train_cli", f"Gaussian count did not change: {res.num_gaussians}")
    check(trained.num_gaussians == res.state.model.num_gaussians, "train_cli",
          "PLY does not hold the trained model")
    # K1 once a step and once an evaluation frame, which alone (no
    # gradient) takes K8; the CLI culls by tile, so its pairs take the
    # torch path.
    check(cli_k2 >= CLI_ITERS and cli_k1 >= CLI_ITERS
          and launched(cli, {"k1": cli_k1, "k2": cli_k2,
                             "k8": cli_k1 - cli_k2}),
          "train_cli", f"launches {cli} in {CLI_ITERS} GLOBAL iterations")
    emit({"phase": "train_cli", "ok": True, "iters": CLI_ITERS,
          "views": CLI_VIEWS, "size": CLI_SIZE, "eval_psnr": res.eval_psnr,
          "gaussians": [init_points] + res.num_gaussians, "seconds": cli_s,
          "k1_launches": cli_k1, "k2_launches": cli_k2,
          "k8_launches": cli["k8"], "card": card})

    # 7. kernel_kb: K3 against its plain version --------------------------------
    from stopthepop_tpu_torch.kernels import kbuffer_blend as kb

    # The 300-Gaussian scene of phase 2, and the same draw with larger
    # Gaussians, whose windows overflow more (small_scenes).
    small_cam = make_camera(70, 45, device=dev)
    kb_cases, kb_small_stats = [], []  # (case, K3 inputs, kw, {k: K3 output})
    with torch.no_grad():
        for case, scene_arrays in small_scenes:
            prep, pairs, skw = prepare(scene_arrays, small_cam, 70, 45)
            sargs, fwd = kb_args(prep, pairs, small_cam), {}
            for k in KB_SMALL_KS:
                st, fwd[k] = compare_kb(f"{case}, k={k}", sargs, skw, k)
                kb_small_stats.append(st)
                emit({"phase": "kernel_kb", "ok": True, "case": case,
                      "pairs": pairs.num_rendered, **st})
            kb_cases.append((case, sargs, skw, fwd))
        # K3 on deep segments: many staged batches a tile.
        deep_case, (prep, pairs, dkw), deep_cam = hier_deep_case(
            dev, "kernel_kb")
        dargs = kb_args(prep, pairs, deep_cam)
        for k in KB_SMALL_KS:
            st, _ = compare_kb(f"{deep_case}, k={k}", dargs, dkw, k)
            kb_small_stats.append(st)
            emit({"phase": "kernel_kb", "ok": True, "case": deep_case,
                  "pairs": pairs.num_rendered, **st})
        del prep, pairs, dargs
    model = bench_model(dev)
    with torch.inference_mode():
        prep, pairs, kw = prepare(model_arrays(model), bench_cam, WIDTH, HEIGHT)
        kb_bench_args = kb_args(prep, pairs, bench_cam)
        kb_full, kb_bench_fwd = compare_kb("1080p", kb_bench_args, kw, KB_K,
                                           count_evaluations=True)
        k3_ms = cuda_ms(lambda: kb.blend_kbuffer_forward(
            *kb_bench_args, k=KB_K, **kw), 20)
        k3_plain_ms = cuda_ms(lambda: kb.blend_kbuffer_forward_plain(
            *kb_bench_args, k=KB_K, **kw), 2, 1)
        k3_by_k = {k: cuda_ms(lambda k=k: kb.blend_kbuffer_forward(
            *kb_bench_args, k=k, **kw), 5) for k in (1, 8, 24)}
    N = pairs.num_rendered
    k3_bytes = 4 * (N + 2 * T + P * (2 + 4 + 3 + 9) + 19 + WIDTH * HEIGHT * 6)
    # The evaluations K3 needs: those in the warps its footprint test keeps.
    k3_ops = (OPS_PER_EVAL * kb_full["evaluations_kept"]
              + OPS_PER_DEPTH * kb_full["depths"]
              + OPS_PER_INSERT_SLOT * KB_K * kb_full["inserts"]
              + OPS_PER_COMMIT * kb_full["commits"])
    k3_bytes_ms, k3_ops_ms = bound_ms(k3_bytes, k3_ops)
    emit({"phase": "kernel_kb", "ok": True,
          "case": "1920x1080, 500K Gaussians, bench camera", "pairs": N,
          **kb_full, "k3_ms": k3_ms, "plain_ms": k3_plain_ms,
          "k3_ms_by_window": k3_by_k, "bytes": k3_bytes, "ops": k3_ops,
          "bytes_bound_ms": k3_bytes_ms, "ops_bound_ms": k3_ops_ms,
          "occupancy_max_k_4": kb.occupancy_fwd(kb._instance(KB_K)),
          "ptxas_max_k_4": ptxas_summary(build.build_log.get(
              kb.KERNEL, {}).get("ptxas", "")).get("MAX_K=4"),
          "card": card})

    # 8. main_kb: the serving path in PPX_KBUFFER -------------------------------
    from stopthepop_tpu_torch.config import SortMode

    kb_settings = culled_settings(SortMode.PPX_KBUFFER)
    kb_settings.sort_settings.queue_sizes.per_pixel = KB_K
    fields, serve_kb = serve_phase(
        "main_kb", model, cams, kb_settings, "k3", kb_args,
        functools.partial(kb.blend_kbuffer_forward, k=KB_K, **kw), dev)
    emit({"phase": "main_kb", "ok": True, "k": KB_K, **fields, "card": card})

    # 9. kernel_kb_bwd: K4 against its plain version -----------------------------
    with torch.no_grad():
        kb_small_bwd = []
        for case, sargs, skw, fwd in kb_cases:
            for k in KB_SMALL_KS:
                st, _ = compare_kb_bwd(f"{case}, k={k}", sargs, skw, k,
                                       fwd[k], cotangents(70, 45))
                kb_small_bwd.append(st)
                emit({"phase": "kernel_kb_bwd", "ok": True, "case": case,
                      **st})
        # K3 and K4 on deep segments: K4's routing at trained-scene depth.
        deep_case, (prep, pairs, dkw), deep_cam = hier_deep_case(dev)
        dargs = kb_args(prep, pairs, deep_cam)
        _, dfwd = compare_kb(deep_case, dargs, dkw, KB_K)
        st, _ = compare_kb_bwd(deep_case, dargs, dkw, KB_K, dfwd,
                               cotangents(HIER_DEEP_SIZE, HIER_DEEP_SIZE))
        kb_small_bwd.append(st)
        emit({"phase": "kernel_kb_bwd", "ok": True, "case": deep_case,
              "pairs": pairs.num_rendered, **st})
        del prep, pairs, dargs, dfwd
    cot = cotangents(WIDTH, HEIGHT)
    with torch.no_grad():
        kb_full_bwd, k4_args = compare_kb_bwd(
            "1080p", kb_bench_args, kw, KB_K, kb_bench_fwd, cot,
            count_evaluations=True)
        k4_ms = cuda_ms(lambda: kb.blend_kbuffer_backward(*k4_args, k=KB_K, **kw), 20)
        k4_plain_ms = cuda_ms(
            lambda: kb.blend_kbuffer_backward_plain(*k4_args, k=KB_K, **kw), 1, 0)
        prep, pairs, _ = prepare(model_arrays(model), bench_cam, WIDTH, HEIGHT)
    kb_full_bwd["bitwise_repeat_backward"] = check_backward_repeats(
        "kernel_kb_bwd", "BlendKBuffer", prep,
        lambda *rows: BlendKBuffer.apply(
            *rows, prep.cov3d_inv9.detach().contiguous(),
            bench_cam.inv_viewprojmatrix.contiguous(),
            bench_cam.campos.contiguous(), pairs, KB_K, kw["grid_x"],
            kw["grid_y"], kw["width"], kw["height"]), cot)
    del prep, pairs
    replay = kb_full_bwd["replay"]
    k4_bytes = 4 * (N + 2 * T + P * (2 + 4 + 3 + 9) + 19 + WIDTH * HEIGHT * 9
                    + N * 9)
    k4_ops = (OPS_PER_EVAL * replay["evaluations"]
              + OPS_PER_DEPTH * replay["depths"]
              + OPS_PER_INSERT_SLOT * KB_K * replay["inserts"]
              + OPS_PER_COMMIT_BWD * replay["commits"])
    k4_bytes_ms, k4_ops_ms = bound_ms(k4_bytes, k4_ops)
    emit({"phase": "kernel_kb_bwd", "ok": True,
          "case": "1920x1080, 500K Gaussians, bench camera", "pairs": N,
          **kb_full_bwd, "k4_ms": k4_ms, "plain_ms": k4_plain_ms,
          "bytes": k4_bytes, "ops": k4_ops, "bytes_bound_ms": k4_bytes_ms,
          "ops_bound_ms": k4_ops_ms,
          "occupancy_max_k_4": kb.occupancy_bwd(kb._instance(KB_K)),
          "ptxas_max_k_4": ptxas_summary(build.build_log.get(
              kb.BWD_KERNEL, {}).get("ptxas", "")).get("MAX_K=4"),
          "card": card})
    del k4_args, kb_bench_args, kb_bench_fwd, cot

    # 10. train_kb: the training step in PPX_KBUFFER -----------------------------
    kb_static = static._replace(settings=kb_settings)
    train_kb, _, one_kb_step = train_phase(
        "train_kb", model, kb_static, cam, target, dev, ("k3", "k4"))
    emit({"phase": "train_kb", "ok": True, "k": KB_K, **train_kb,
          "card": card})
    if want_profile:
        emit({"phase": "train_kb_profile", "ok": True, "steps": 3,
              **profile_steps(one_kb_step, 3, train_kb["ms_per_step"]),
              "card": card})
    del one_kb_step, model

    # 11. kernel_hier: K5 against its plain version -----------------------------
    from stopthepop_tpu_torch.kernels import hier_blend as hb

    hier_small_stats = []
    with torch.no_grad():
        for case, scene_arrays in small_scenes:
            for queues, cull in HIER_SMALL_CASES:
                prep, pairs, skw = prepare(scene_arrays, small_cam, 70, 45,
                                           tile_based_culling=cull)
                st = compare_hier(
                    f"{case}, queues={queues}, culling={cull}",
                    hier_args(prep, pairs, small_cam),
                    {**skw, "queue_sizes": queues, "hier_4x4_culling": cull})
                hier_small_stats.append(st)
                emit({"phase": "kernel_hier", "ok": True, "case": case,
                      "pairs": pairs.num_rendered, "tile_based_culling": cull,
                      **st})
        deep_case, (prep, pairs, dkw), deep_cam = hier_deep_case(dev)
        st = compare_hier(deep_case, hier_args(prep, pairs, deep_cam),
                          {**dkw, "queue_sizes": HIER_QUEUES,
                           "hier_4x4_culling": False})
        hier_small_stats.append(st)
        emit({"phase": "kernel_hier", "ok": True, "case": deep_case,
              "pairs": pairs.num_rendered, **st})
    model = bench_model(dev)
    with torch.inference_mode():
        prep, pairs, kw = prepare(model_arrays(model), bench_cam, WIDTH, HEIGHT)
        hier_bench_args = hier_args(prep, pairs, bench_cam)
        hkw = {**kw, "queue_sizes": HIER_QUEUES, "hier_4x4_culling": False}
        hier_full = compare_hier("1080p", hier_bench_args, hkw,
                                 count_evaluations=True)
        k5_ms = cuda_ms(lambda: hb.blend_hier_forward(*hier_bench_args, **hkw), 20)
        k5_plain_ms = cuda_ms(lambda: hb.blend_hier_forward_plain(
            *hier_bench_args, **hkw), 1, 0)
        k5_by_queues = {str(q): cuda_ms(lambda q=q: hb.blend_hier_forward(
            *hier_bench_args, **{**hkw, "queue_sizes": q}), 5)
            for q, cull in HIER_SMALL_CASES[1:4]}
    N = pairs.num_rendered
    counts_hier = (pairs.ends - pairs.starts).to(torch.int64)
    k5_bytes = 4 * (N + 2 * T + P * (2 + 4 + 3 + 9 + 1) + 19
                    + WIDTH * HEIGHT * 6)
    k5_ops = hier_ops(hier_full, OPS_PER_COMMIT)
    k5_bytes_ms, k5_ops_ms = bound_ms(k5_bytes, k5_ops)
    emit({"phase": "kernel_hier", "ok": True,
          "case": "1920x1080, 500K Gaussians, bench camera", "pairs": N,
          "max_segment": int(counts_hier.max()),
          "mean_segment": float(counts_hier.float().mean()),
          **hier_full, "k5_ms": k5_ms, "plain_ms": k5_plain_ms,
          "k5_ms_by_queues": k5_by_queues,
          "bytes": k5_bytes, "ops": k5_ops, "bytes_bound_ms": k5_bytes_ms,
          "ops_bound_ms": k5_ops_ms, "card": card})
    del prep, pairs, hier_bench_args

    # 12. main_hier: the serving path in HIER -----------------------------------
    hier_settings = culled_settings(SortMode.HIER)
    check(tuple(getattr(hier_settings.sort_settings.queue_sizes, f) for f in
                ("tile_4x4", "tile_2x2", "per_pixel")) == HIER_QUEUES,
          "main_hier", "the default queue sizes changed")
    fields, serve_hier = serve_phase(
        "main_hier", model, cams, hier_settings, "k5", hier_args,
        functools.partial(hb.blend_hier_forward, **hkw), dev)
    emit({"phase": "main_hier", "ok": True, "queues": list(HIER_QUEUES),
          **fields, "card": card})

    # 13. kernel_hier_bwd: K6 against its plain version --------------------------
    hier_small_bwd = []
    with torch.no_grad():
        for case, scene_arrays in small_scenes:
            for queues, cull in HIER_SMALL_CASES + HIER_BWD_EXTRA_CASES:
                prep, pairs, skw = prepare(scene_arrays, small_cam, 70, 45,
                                           tile_based_culling=cull)
                st, _ = compare_hier_bwd(
                    f"{case}, queues={queues}, culling={cull}",
                    hier_args(prep, pairs, small_cam),
                    {**skw, "queue_sizes": queues, "hier_4x4_culling": cull},
                    cotangents(70, 45))
                hier_small_bwd.append(st)
                emit({"phase": "kernel_hier_bwd", "ok": True, "case": case,
                      "pairs": pairs.num_rendered, "tile_based_culling": cull,
                      **st})
        deep_case, (prep, pairs, dkw), deep_cam = hier_deep_case(dev)
        st, _ = compare_hier_bwd(
            deep_case, hier_args(prep, pairs, deep_cam),
            {**dkw, "queue_sizes": HIER_QUEUES, "hier_4x4_culling": False},
            cotangents(HIER_DEEP_SIZE, HIER_DEEP_SIZE))
        hier_small_bwd.append(st)
        emit({"phase": "kernel_hier_bwd", "ok": True, "case": deep_case,
              "pairs": pairs.num_rendered, **st})
    cot = cotangents(WIDTH, HEIGHT)
    with torch.no_grad():
        prep, pairs, kw = prepare(model_arrays(model), bench_cam, WIDTH, HEIGHT)
        hier_bench_args = hier_args(prep, pairs, bench_cam)
        hier_full_bwd, k6_args = compare_hier_bwd(
            "1080p", hier_bench_args, hkw, cot, count_evaluations=True)
        k6_ms = cuda_ms(lambda: hb.blend_hier_backward(*k6_args, **hkw), 20)
        k6_plain_ms = cuda_ms(
            lambda: hb.blend_hier_backward_plain(*k6_args, **hkw), 1, 0)
    hier_full_bwd["bitwise_repeat_backward"] = check_backward_repeats(
        "kernel_hier_bwd", "BlendHier", prep,
        lambda *rows: BlendHier.apply(
            *rows, *hier_bench_args[6:], pairs, HIER_QUEUES, False,
            kw["grid_x"], kw["grid_y"], kw["width"], kw["height"]), cot)
    N = pairs.num_rendered
    k6_bytes = 4 * (N + 2 * T + P * (2 + 4 + 3 + 9 + 1) + 19
                    + WIDTH * HEIGHT * 9 + N * 9)
    k6_ops = hier_ops(hier_full_bwd["replay"], OPS_PER_COMMIT_BWD)
    k6_bytes_ms, k6_ops_ms = bound_ms(k6_bytes, k6_ops)
    emit({"phase": "kernel_hier_bwd", "ok": True,
          "case": "1920x1080, 500K Gaussians, bench camera", "pairs": N,
          **hier_full_bwd, "k6_ms": k6_ms, "plain_ms": k6_plain_ms,
          "bytes": k6_bytes, "ops": k6_ops, "bytes_bound_ms": k6_bytes_ms,
          "ops_bound_ms": k6_ops_ms, "card": card})
    del prep, pairs, hier_bench_args, k6_args, cot

    # 14. train_hier: the training step in HIER ---------------------------------
    train_hier, _, one_hier_step = train_phase(
        "train_hier", model, static._replace(settings=hier_settings), cam,
        target, dev, ("k5", "k6"))
    emit({"phase": "train_hier", "ok": True, "queues": list(HIER_QUEUES),
          **train_hier, "card": card})
    if want_profile:
        emit({"phase": "train_hier_profile", "ok": True, "steps": 3,
              **profile_steps(one_hier_step, 3, train_hier["ms_per_step"]),
              "card": card})
    del one_hier_step, model

    # 15. kernel_full: K7 against its plain version ------------------------------
    from stopthepop_tpu_torch.kernels import full_blend as fb
    from stopthepop_tpu_torch.utils.testing import clone_trap_scene

    trap = clone_trap_scene(dev)
    trap_cam = make_camera(32, 32, device=dev)
    full_cases = small_scenes + (
        ("32x32 clone trap scene", {
            "means3d": trap.means3d, "opacities": trap.opacities,
            "scales": trap.scales, "rotations": trap.rotations,
            "shs": trap.shs}),)
    full_small_stats = []
    with torch.no_grad():
        for case, scene_arrays in full_cases:
            ccam, size = ((trap_cam, (32, 32)) if "trap" in case
                          else (small_cam, (70, 45)))
            prep, pairs, skw = prepare(scene_arrays, ccam, *size)
            st = compare_full(case, kb_args(prep, pairs, ccam), skw,
                              count_evaluations=True)
            full_small_stats.append(st)
            emit({"phase": "kernel_full", "ok": True, "case": case,
                  "pairs": pairs.num_rendered, **st})
    check(full_small_stats[-1]["max_commits"] > 3 * fb.WINDOW, "kernel_full",
          "the trap scene has no pixel with more than three windows")
    with torch.no_grad():
        deep_case, (prep, pairs, dkw), deep_cam = hier_deep_case(dev)
        st = compare_full(deep_case, kb_args(prep, pairs, deep_cam), dkw,
                          count_evaluations=True)
        full_small_stats.append(st)
        emit({"phase": "kernel_full", "ok": True, "case": deep_case,
              "pairs": pairs.num_rendered, **st})
        del prep, pairs
    emit({"phase": "kernel_full", "ok": True,
          "case": "auto rule through GaussianRasterizer, " + small_scenes[0][0],
          **full_auto_rule(small_scenes[0][1], small_cam)})
    model = bench_model(dev)
    with torch.inference_mode():
        prep, pairs, kw = prepare(model_arrays(model), bench_cam, WIDTH, HEIGHT)
        full_bench_args = kb_args(prep, pairs, bench_cam)
        full_bench = compare_full("1080p", full_bench_args, kw,
                                  count_evaluations=True)
        k7_ms = cuda_ms(lambda: fb.blend_full_forward(*full_bench_args, **kw),
                        20)
        k7_plain_ms = cuda_ms(lambda: fb.blend_full_forward_plain(
            *full_bench_args, **kw), 1, 0)
    N = pairs.num_rendered
    k7_bytes = full_bytes(N, P, T, WIDTH, HEIGHT)
    k7_ops = full_ops(full_bench)
    k7_bytes_ms, k7_ops_ms = bound_ms(k7_bytes, k7_ops)
    emit({"phase": "kernel_full", "ok": True,
          "case": "1920x1080, 500K Gaussians, bench camera", "pairs": N,
          **full_bench, "window": fb.WINDOW, "k7_ms": k7_ms,
          "plain_ms": k7_plain_ms,
          "bytes": k7_bytes, "ops": k7_ops, "bytes_bound_ms": k7_bytes_ms,
          "ops_bound_ms": k7_ops_ms, "occupancy": fb.occupancy(),
          "ptxas": ptxas_summary(build.build_log.get(fb.KERNEL, {}).get("ptxas", "")),
          "card": card})
    del prep, pairs, full_bench_args
    full_lines = full_shapes_phase(dev)
    for line in full_lines:
        emit({"phase": "kernel_full", "ok": True, **line, "card": card})

    # 16. main_full: the serving path in PPX_FULL --------------------------------
    full_settings = culled_settings(SortMode.PPX_FULL)
    fields, serve_full = serve_phase(
        "main_full", model, cams, full_settings, "k7", kb_args,
        functools.partial(fb.blend_full_forward, **kw), dev)
    emit({"phase": "main_full", "ok": True, "window": fb.WINDOW, **fields,
          "card": card})

    # 17. quality: the sort modes against the FULL render ------------------------
    from stopthepop_tpu_torch.config import GlobalSortOrder
    from stopthepop_tpu_torch.render.cli import render_frames

    def quality_settings(mode, order, k=None, hq=None):
        s = culled_settings(mode)
        s.sort_settings.sort_order = order
        q = s.sort_settings.queue_sizes
        if k is not None:
            q.per_pixel = k
        if hq is not None:
            q.tile_4x4, q.tile_2x2, q.per_pixel = hq
        return s

    full_img = render_frames(model, cams[:1], full_settings, dev)[0].color
    G = GlobalSortOrder
    quality_cases = (
        ("GLOBAL Z_DEPTH", SortMode.GLOBAL, G.Z_DEPTH, {}),
        ("GLOBAL PTD_CENTER", SortMode.GLOBAL, G.PTD_CENTER, {}),
        ("GLOBAL PTD_MAX", SortMode.GLOBAL, G.PTD_MAX, {}),
        ("KBUFFER k=4", SortMode.PPX_KBUFFER, G.Z_DEPTH, {"k": 4}),
        ("KBUFFER k=16", SortMode.PPX_KBUFFER, G.Z_DEPTH, {"k": 16}),
        ("PTD_MAX + KBUFFER k=4", SortMode.PPX_KBUFFER, G.PTD_MAX, {"k": 4}),
        ("HIER 64/8/4", SortMode.HIER, G.PTD_MAX, {"hq": (64, 8, 4)}),
        ("HIER 16/8/4", SortMode.HIER, G.PTD_MAX, {"hq": (16, 8, 4)}),
    )
    for case, mode, order, opts in quality_cases:
        img = render_frames(model, cams[:1],
                            quality_settings(mode, order, **opts), dev)[0].color
        check(bool(torch.isfinite(img).all()), "quality", f"{case}: not finite")
        emit({"phase": "quality", "ok": True, "case": case,
              "frame": 0, "width": WIDTH, "height": HEIGHT,
              **psnr_stats(img, full_img), "card": card})
    del full_img, model

    # 18-22. the tools: each phase with its wall time -----------------------------
    def emit_phase(phase, run):
        t0 = time.perf_counter()
        fields = run()
        emit({"phase": phase, "ok": True, **fields,
              "seconds": time.perf_counter() - t0, "card": card})

    emit_phase("train_batched", lambda: batched_train_phase(
        static, dev, train_fields["ms_per_step"]))
    emit_phase("colmap", lambda: colmap_phase(out_dir, dev))
    model = bench_model(dev)
    emit_phase("debug_viz", lambda: debug_viz_phase(model, bench_cam, cams,
                                                    small, dev))
    emit_phase("timed", lambda: timed_phase(model, bench_cam, out_dir, dev))
    emit_phase("snapshot", lambda: snapshot_phase(model, bench_cam))
    del model

    # 23. tile: the binning tile, 32x16 beside 16x16 ------------------------------
    model = bench_model(dev)
    t0 = time.perf_counter()
    tile = tile_phase(model, bench_cam, cams, small, static, target,
                      cotangents, dev)
    emit({"phase": "tile", "ok": True, **tile,
          "seconds": time.perf_counter() - t0, "card": card})
    del model

    # 24. parallel: the multi-device layer, one process per card ------------------
    torch.cuda.empty_cache()
    emit_phase("parallel", lambda: parallel_phase(out_dir))

    # 25. cascade: HIER's batched cascade ----------------------------------------
    model = bench_model(dev)
    t0 = time.perf_counter()
    cascade = cascade_phase(model, bench_cam, cams, static, target,
                            cotangents, dev)
    emit({"phase": "cascade", "ok": True, **cascade,
          "seconds": time.perf_counter() - t0, "card": card})
    del model

    # 26. io: the native capture IO against its plain versions --------------------
    emit_phase("io", lambda: io_phase(out_dir, dev))

    # 27. kernel_preprocess: K8 against the plain preprocess --------------------
    from stopthepop_tpu_torch.kernels import preprocess_fwd as k8

    prep_lines = preprocess_phase(dev)
    for line in prep_lines:
        emit({"phase": "kernel_preprocess", "ok": True, **line, "card": card})
    k8_bench = prep_lines[1]

    # 28. kernel_pairs: the pair stream's kernels against the torch path -------
    from stopthepop_tpu_torch.kernels import pairs as kp

    pairs_lines = pairs_phase(dev)
    for line in pairs_lines:
        emit({"phase": "kernel_pairs", "ok": True, **line, "card": card})

    # 29. kernels -----------------------------------------------------------------
    def at_tile(key, launches):
        """A kernel's numbers at the binning tiles of phase 23: 32x16 and,
        for K1 and K2, the odd bins of ODD_TILES."""
        bench = tile["bench"]
        rows = [{"tile": list(TILE), "ms": bench["ms"][key],
                 "launches": launches,
                 "max_abs_err": max(tile["small"][key].get(
                     "max_abs_err",
                     tile["small"][key].get("max_abs_err_color")),
                     bench["kernels"][key].get(
                         "max_abs_err",
                         bench["kernels"][key].get("max_abs_err_color"))),
                 **({"bound_ms": bench["bound_ms"][key],
                     "bound_by": bench["bound_by"][key]}
                    if key in bench["bound_ms"] else {})}]
        for t in (ODD_TILES if key in ("k1", "k2") else ()):
            odd = tile["odd"][f"1080p {t[0]}x{t[1]}"]
            st = odd[key]
            rows.append({
                "tile": list(t), "ms": odd["ms"][key],
                "launches": tile[f"train_GLOBAL_{t[0]}x{t[1]}"]["launches"][key],
                "max_abs_err": st.get("max_abs_err",
                                      st.get("max_abs_err_color")),
                "bound_ms": odd["bound_ms"][key],
                "bound_by": odd["bound_by"][key]})
        return rows

    def batched(key, kernel, launches):
        """K5's or K6's numbers with the batched cascade (phase 25)."""
        bench = cascade["bench"]
        errs = [c[key].get("max_abs_err", c[key].get("max_abs_err_color"))
                for c in (*cascade["cases"], bench)]
        return {"source": hb.source(kernel, batched=True),
                "ms": bench["ms"][f"{key}_batched"],
                "plain_ms": bench["ms"][f"{key}_plain"],
                "launches": launches, "max_abs_err": max(errs),
                "bound_ms": bench["bound_ms"][key],
                "bound_by": bench["bound_by"][key]}

    emit({"kernels": [{
        "name": global_blend.KERNEL, "route": "cuda",
        "source": global_blend.SOURCE, "replaces": global_blend.REPLACES,
        "launches": train_fields["launches"]["k1"],
        "max_abs_err": max(max(st["max_abs_err_color"], st["max_abs_err_final_t"])
                           for st in (small_stats, deep_stats, full_stats)),
        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "at_tile": at_tile("k1", tile["train_GLOBAL_32x16"]["launches"]["k1"]),
    }, {
        "name": global_blend.BWD_KERNEL, "route": "cuda",
        "source": global_blend.BWD_SOURCE, "replaces": global_blend.BWD_REPLACES,
        "launches": train_fields["launches"]["k2"],
        "max_abs_err": max(small_bwd["max_abs_err"], deep_bwd["max_abs_err"],
                           full_bwd["max_abs_err"]),
        "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": max(k2_bytes_ms, k2_ops_ms),
        "bound_by": "bytes" if k2_bytes_ms >= k2_ops_ms else "operations",
        "library_ms": None,
        "at_tile": at_tile("k2", tile["train_GLOBAL_32x16"]["launches"]["k2"]),
    }, {
        "name": kb.KERNEL, "route": "cuda", "source": kb.SOURCE,
        "replaces": kb.REPLACES, "launches": train_kb["launches"]["k3"],
        "max_abs_err": max(max(kb_full["max_abs_err_color"],
                               kb_full["max_abs_err_final_t"]),
                           *(max(st["max_abs_err_color"], st["max_abs_err_final_t"])
                             for st in kb_small_stats)),
        "ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": max(k3_bytes_ms, k3_ops_ms),
        "bound_by": "bytes" if k3_bytes_ms >= k3_ops_ms else "operations",
        "library_ms": None,
        "at_tile": at_tile(
            "k3", tile["train_PPX_KBUFFER_32x16"]["launches"]["k3"]),
    }, {
        "name": kb.BWD_KERNEL, "route": "cuda", "source": kb.BWD_SOURCE,
        "replaces": kb.BWD_REPLACES,
        "launches": train_kb["launches"]["k4"],
        "max_abs_err": max(kb_full_bwd["max_abs_err"],
                           *(st["max_abs_err"] for st in kb_small_bwd)),
        "ms": k4_ms, "plain_ms": k4_plain_ms,
        "bound_ms": max(k4_bytes_ms, k4_ops_ms),
        "bound_by": "bytes" if k4_bytes_ms >= k4_ops_ms else "operations",
        "library_ms": None,
        "at_tile": at_tile(
            "k4", tile["train_PPX_KBUFFER_32x16"]["launches"]["k4"]),
    }, {
        "name": hb.KERNEL, "route": "cuda", "source": hb.SOURCE,
        "replaces": hb.REPLACES, "launches": serve_hier["k5"],
        "max_abs_err": max(max(st["max_abs_err_color"], st["max_abs_err_final_t"])
                           for st in (hier_full, *hier_small_stats)),
        "ms": k5_ms, "plain_ms": k5_plain_ms,
        "bound_ms": max(k5_bytes_ms, k5_ops_ms),
        "bound_by": "bytes" if k5_bytes_ms >= k5_ops_ms else "operations",
        "library_ms": None,
        "at_tile": at_tile("k5", tile["train_HIER_32x16"]["launches"]["k5"]),
        "batched": batched("k5", hb.KERNEL,
                           cascade["frames_batched"]["launches"]["k5"]),
    }, {
        "name": hb.BWD_KERNEL, "route": "cuda", "source": hb.BWD_SOURCE,
        "replaces": hb.BWD_REPLACES, "launches": train_hier["launches"]["k6"],
        "max_abs_err": max(st["max_abs_err"]
                           for st in (hier_full_bwd, *hier_small_bwd)),
        "ms": k6_ms, "plain_ms": k6_plain_ms,
        "bound_ms": max(k6_bytes_ms, k6_ops_ms),
        "bound_by": "bytes" if k6_bytes_ms >= k6_ops_ms else "operations",
        "library_ms": None,
        "at_tile": at_tile("k6", tile["train_HIER_32x16"]["launches"]["k6"]),
        "batched": batched("k6", hb.BWD_KERNEL,
                           cascade["train_batched"]["launches"]["k6"]),
    }, {
        "name": fb.KERNEL, "route": "cuda", "source": fb.SOURCE,
        "replaces": fb.REPLACES, "launches": serve_full["k7"],
        "max_abs_err": max(max(st["max_abs_err_color"], st["max_abs_err_final_t"])
                           for st in (full_bench, *full_small_stats)),
        "ms": k7_ms, "plain_ms": k7_plain_ms,
        "bound_ms": max(k7_bytes_ms, k7_ops_ms),
        "bound_by": "bytes" if k7_bytes_ms >= k7_ops_ms else "operations",
        "library_ms": None,
        "at_tile": at_tile("k7",
                           tile["main_full_32x16"]["launches"]["k7"]),
        "at_shapes": [{"case": ln["case"], "gaussians": ln["gaussians"],
                       "k7_ms": ln["k7_ms"], "plain_ms": ln["plain_ms"],
                       "bound_ms": ln["bound_ms"], "bound_by": ln["bound_by"],
                       "max_abs_err": max(c["max_abs_err"]
                                          for c in ln["cameras"]),
                       "passes_per_tile": [c["passes_per_tile"]
                                           for c in ln["cameras"]]}
                      for ln in full_lines],
    }, {
        "name": k8.KERNEL, "route": "cuda", "source": k8.SOURCE,
        "replaces": k8.REPLACES, "launches": serve_main["k8"],
        # kernel_preprocess fails on any difference from the plain version.
        "max_abs_err": 0.0,
        "ms": k8_bench["k8_ms"], "plain_ms": k8_bench["plain_ms"],
        "bound_ms": k8_bench["bytes_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "occupancy": k8.occupancy(),
        "ptxas": ptxas_summary(build.build_log.get(k8.KERNEL, {}).get(
            "ptxas", "")).get("kernel"),
        "at_shapes": [{k: ln[k] for k in ("case", "gaussians", "k8_ms",
                                          "plain_ms", "bytes_bound_ms",
                                          "share_of_bound")}
                      for ln in prep_lines[2:]],
    }, {
        "name": kp.KERNEL, "route": "cuda", "source": kp.SOURCE,
        "replaces": kp.REPLACES,
        # Counted from 0 before each path's frames and steps.
        "launches": {"frames": FRAMES, "steps": TRAIN_STEPS, **{
            mode: {path: {k: counts[k] for k in PAIRS_KERNELS}
                   for path, counts in paths.items()}
            for mode, paths in (
                ("GLOBAL", {"frames": serve_main,
                            "steps": train_fields["launches"]}),
                ("PPX_KBUFFER", {"frames": serve_kb,
                                 "steps": train_kb["launches"]}),
                ("HIER", {"frames": serve_hier,
                          "steps": train_hier["launches"]}),
                ("PPX_FULL", {"frames": serve_full}))}},
        # Against the torch path (the plain version), every case of phase
        # kernel_pairs.
        "max_abs_err": max(row["max_abs_err"] for ln in pairs_lines
                           for row in (*ln["cameras"], ln["grad"],
                                       ln["grad_emptied"])),
        "at_shapes": [{"case": ln["case"], "pairs": ln["cameras"][0]["pairs"],
                       **{k: ln["cameras"][0][k] for k in (
                           "kernels_ms", "torch_path_ms", "kernel_ms",
                           "bound_ms", "bound_total_ms")}}
                      for ln in pairs_lines],
    }]})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
