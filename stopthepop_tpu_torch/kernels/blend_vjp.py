"""Differentiable blends: ``torch.autograd.Function``s pairing K1 with K2
(GLOBAL), K3 with K4 (PER_PIXEL_KBUFFER) and K5 with K6 (HIERARCHICAL).

The counterparts of ``stopthepop_tpu/kernels/blend_vjp.py::make_blend_global``,
``make_blend_kbuffer`` and ``make_blend_hier``.
The seam sits where the reference splits its hand-written backward: the
blend-level gradients with respect to the per-Gaussian rows (xy, conic and
opacity, rgb) come from kernel K2; everything upstream (preprocess) is plain
torch and differentiates by autograd.

Forward: K1. Saved: the per-Gaussian rows, the pair buffer and K1's raw
color, final_T and n_contrib. Backward:
  1. K2 gives the per-pair gradients [N, 9] in sorted-slot order;
  2. ``orig_slot`` unsorts them into the Gaussian-major expansion order, a
     write to unique indices;
  3. one segmented sum over each Gaussian's contiguous run gives
     d_xy [P, 2], d_conic_opacity [P, 4] and d_rgb [P, 3].
Every step is deterministic: no atomics, no ``index_add_``; each run is
summed in float32 in run order, so no prefix sum over the whole stream loses
digits on small Gaussians. ``depth`` gets no gradient, as in the JAX
package. The background stays outside the Function (render/pipeline.py), so
autograd folds it into the final_T cotangent.

``BlendKBuffer`` has the same seam and steps with K3 and K4 in place of K1 and
K2. ``cov3d_inv9`` and the camera get no gradient: the per-ray depths only
choose the window order, a discrete choice, as in the reference and the JAX
package.

``BlendHier`` has the seam and steps again with K5 and K6. Besides
``cov3d_inv9`` and the camera, ``opacity_power_threshold`` (the 4x4 culling
test) gets no gradient: it only decides which entries are valid.

Each Function takes an optional ``snapshot``: the (host arrays,
settings) of a ``debug=True`` render. Its backward then copies the
cotangents to the host before the kernel launches, and a backward that
raises writes them with the arrays to snapshot_bw.npz
(``utils/snapshot.py``) before re-raising.

And a last, optional ``segs`` (``BlendSegments``): the blend tiles' ranges
and pieces under the binning tile (render/pipeline.py::
split_binning_segments). Blend tiles that share their binning tile's
segment then write their per-pair gradients into planes of their own
(kernels K2, K4 and K6 take the sub-tile map), and ``sum_planes`` adds the
planes in plane order before step 2: no two tiles write one row, and the
order stays fixed (the JAX package's ``grad_row_split``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.profiling import span
from ..utils.snapshot import host_copies, snapshot_on_failure
from .global_blend import blend_global_backward, blend_global_forward
from .hier_blend import blend_hier_backward, blend_hier_forward
from .kbuffer_blend import blend_kbuffer_backward, blend_kbuffer_forward


def _backward(ctx, grad_color, grad_final_t, run):
    """``run()``, under ``snapshot_on_failure("bw", ...)`` when the
    forward was given a snapshot."""
    if ctx.snapshot is None:
        return run()
    arrays, meta = ctx.snapshot
    arrays = {**arrays, **host_copies({"grad_color": grad_color,
                                       "grad_final_t": grad_final_t})}
    with snapshot_on_failure("bw", arrays, meta, device=grad_color.device):
        return run()


class BlendSegments(NamedTuple):
    """The pair ranges the blend tiles read, their planes, and the pieces
    they are."""
    starts: torch.Tensor              # [T] int32 per-blend-tile range start
    ends: torch.Tensor                # [T] int32 per-blend-tile range end
    sub_tile: Optional[torch.Tensor]  # [T] int32 plane of each tile, or None
    num_sub: int                      # planes: blend tiles a binning tile
    # [T, 4] int32 (x0, y0, w, h) of each blend tile (K1 and K2 take it;
    # the resort modes' blend tiles are the image's 16x16 grid).
    pieces: torch.Tensor


def _ranges(pairs, segs):
    """(starts, ends, plane keywords of the backward wrappers)."""
    if segs is None:
        return pairs.starts, pairs.ends, {}
    return segs.starts, segs.ends, (
        {} if segs.sub_tile is None
        else {"sub_tile": segs.sub_tile, "num_sub": segs.num_sub})


def sum_planes(d_pair):
    """[S, N, 9] per-sub-tile gradient planes -> [N, 9], added in plane
    order 0..S-1; an [N, 9] input is returned as it is."""
    if d_pair.dim() == 2:
        return d_pair
    total = d_pair[0]
    for s in range(1, d_pair.shape[0]):
        total = total + d_pair[s]
    return total


def reduce_pair_grads(d_pair, orig_slot, gauss_offsets):
    """Per-pair gradients in sorted-slot order -> per-Gaussian sums [P, 9]."""
    d_exp = torch.empty_like(d_pair)
    d_exp[orig_slot] = d_pair
    return torch.segment_reduce(d_exp, "sum", offsets=gauss_offsets, axis=0,
                                unsafe=True)


class BlendGlobal(torch.autograd.Function):
    """(xy, conic_opacity, rgb, depth, pairs, grid) -> K1's four outputs,
    differentiable in xy, conic_opacity and rgb through color and final_T."""

    @staticmethod
    def forward(ctx, xy, conic_opacity, rgb, depth, pairs, grid_x, grid_y,
                width, height, snapshot=None, segs=None):
        kw = dict(grid_x=grid_x, grid_y=grid_y, width=width, height=height,
                  pieces=None if segs is None else segs.pieces)
        starts, ends, planes = _ranges(pairs, segs)
        color, final_t, n_contrib, depth_acc = blend_global_forward(
            pairs.gauss_id, starts, ends, xy, conic_opacity, rgb, depth, **kw)
        ctx.save_for_backward(xy, conic_opacity, rgb, color, final_t,
                              n_contrib)
        ctx.pairs = pairs
        ctx.ranges = (starts, ends)
        ctx.kw = {**kw, **planes}
        ctx.snapshot = snapshot
        ctx.mark_non_differentiable(n_contrib, depth_acc)
        return color, final_t, n_contrib, depth_acc

    @staticmethod
    def backward(ctx, grad_color, grad_final_t, _grad_n, _grad_depth):
        with span("blend_bwd"):
            (xy, conic_opacity, rgb, color, final_t,
             n_contrib) = ctx.saved_tensors
            pairs = ctx.pairs
            # Autograd hands zeros for an unused output (materialize_grads).
            d_pair = _backward(
                ctx, grad_color, grad_final_t, lambda: blend_global_backward(
                    pairs.gauss_id, *ctx.ranges, xy, conic_opacity, rgb,
                    color, final_t, n_contrib, grad_color.contiguous(),
                    grad_final_t.contiguous(), **ctx.kw))
            d = reduce_pair_grads(sum_planes(d_pair), pairs.orig_slot,
                                  pairs.gauss_offsets)
            return (d[:, 0:2], d[:, 2:6], d[:, 6:9]) + (None,) * 8


class BlendKBuffer(torch.autograd.Function):
    """(xy, conic_opacity, rgb, cov3d_inv9, inverse_vp, campos, pairs, k,
    grid) -> K3's four outputs, differentiable in xy, conic_opacity and rgb
    through color and final_T."""

    @staticmethod
    def forward(ctx, xy, conic_opacity, rgb, cov3d_inv9, inverse_vp, campos,
                pairs, k, grid_x, grid_y, width, height, snapshot=None,
                segs=None):
        kw = dict(k=k, grid_x=grid_x, grid_y=grid_y, width=width,
                  height=height)
        starts, ends, planes = _ranges(pairs, segs)
        color, final_t, n_contrib, depth_acc = blend_kbuffer_forward(
            pairs.gauss_id, starts, ends, xy, conic_opacity, rgb,
            cov3d_inv9, inverse_vp, campos, **kw)
        ctx.save_for_backward(xy, conic_opacity, rgb, cov3d_inv9, inverse_vp,
                              campos, color, final_t, n_contrib)
        ctx.pairs = pairs
        ctx.ranges = (starts, ends)
        ctx.kw = {**kw, **planes}
        ctx.snapshot = snapshot
        ctx.mark_non_differentiable(n_contrib, depth_acc)
        return color, final_t, n_contrib, depth_acc

    @staticmethod
    def backward(ctx, grad_color, grad_final_t, _grad_n, _grad_depth):
        with span("blend_bwd"):
            (xy, conic_opacity, rgb, cov3d_inv9, inverse_vp, campos, color,
             final_t, n_contrib) = ctx.saved_tensors
            pairs = ctx.pairs
            d_pair = _backward(
                ctx, grad_color, grad_final_t, lambda: blend_kbuffer_backward(
                    pairs.gauss_id, *ctx.ranges, xy, conic_opacity, rgb,
                    cov3d_inv9, inverse_vp, campos, color, final_t, n_contrib,
                    grad_color.contiguous(), grad_final_t.contiguous(),
                    **ctx.kw))
            d = reduce_pair_grads(sum_planes(d_pair), pairs.orig_slot,
                                  pairs.gauss_offsets)
            return (d[:, 0:2], d[:, 2:6], d[:, 6:9]) + (None,) * 11


class BlendHier(torch.autograd.Function):
    """(xy, conic_opacity, rgb, cov3d_inv9, opacity_power_threshold,
    inverse_vp, campos, pairs, queues, hier_4x4_culling, grid) -> K5's four
    outputs, differentiable in xy, conic_opacity and rgb through color and
    final_T. A last, optional ``batched_cascade`` takes K5's and K6's
    batched cadence."""

    @staticmethod
    def forward(ctx, xy, conic_opacity, rgb, cov3d_inv9,
                opacity_power_threshold, inverse_vp, campos, pairs,
                queue_sizes, hier_4x4_culling, grid_x, grid_y, width, height,
                snapshot=None, segs=None, batched_cascade=False):
        kw = dict(queue_sizes=queue_sizes, hier_4x4_culling=hier_4x4_culling,
                  grid_x=grid_x, grid_y=grid_y, width=width, height=height,
                  batched_cascade=batched_cascade)
        starts, ends, planes = _ranges(pairs, segs)
        color, final_t, n_contrib, depth_acc = blend_hier_forward(
            pairs.gauss_id, starts, ends, xy, conic_opacity, rgb,
            cov3d_inv9, opacity_power_threshold, inverse_vp, campos, **kw)
        ctx.save_for_backward(xy, conic_opacity, rgb, cov3d_inv9,
                              opacity_power_threshold, inverse_vp, campos,
                              color, final_t, n_contrib)
        ctx.pairs = pairs
        ctx.ranges = (starts, ends)
        ctx.kw = {**kw, **planes}
        ctx.snapshot = snapshot
        ctx.mark_non_differentiable(n_contrib, depth_acc)
        return color, final_t, n_contrib, depth_acc

    @staticmethod
    def backward(ctx, grad_color, grad_final_t, _grad_n, _grad_depth):
        with span("blend_bwd"):
            pairs = ctx.pairs
            d_pair = _backward(
                ctx, grad_color, grad_final_t, lambda: blend_hier_backward(
                    pairs.gauss_id, *ctx.ranges, *ctx.saved_tensors,
                    grad_color.contiguous(), grad_final_t.contiguous(),
                    **ctx.kw))
            d = reduce_pair_grads(sum_planes(d_pair), pairs.orig_slot,
                                  pairs.gauss_offsets)
            return (d[:, 0:2], d[:, 2:6], d[:, 6:9]) + (None,) * 14
