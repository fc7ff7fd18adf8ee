"""Differentiable blends: ``torch.autograd.Function``s pairing K1 with K2
(GLOBAL), K3 with K4 (PER_PIXEL_KBUFFER) and K5 with K6 (HIERARCHICAL).

The counterparts of ``stopthepop_tpu/kernels/blend_vjp.py::make_blend_global``,
``make_blend_kbuffer`` and ``make_blend_hier``.
The seam sits where the reference splits its hand-written backward: the
blend-level gradients with respect to the per-Gaussian rows (xy, conic and
opacity, rgb) come from the backward kernel; everything upstream
(preprocess) is plain torch and differentiates by autograd.

The three Functions share one forward and one backward body (``_Blend``);
each declares only its kernel pair (``Kernels``) and its inputs. Forward:
the forward kernel. Saved: the per-Gaussian rows, the camera tensors, the
pair buffer and the kernel's raw color, final_T and n_contrib. Backward:
  1. the backward kernel gives the per-pair gradients [N, 9] in
     sorted-slot order;
  2. ``orig_slot`` unsorts them into the Gaussian-major expansion order, a
     write to unique indices;
  3. one segmented sum over each Gaussian's contiguous run gives
     d_xy [P, 2], d_conic_opacity [P, 4] and d_rgb [P, 3].
Every step is deterministic: no atomics, no ``index_add_``; each run is
summed in float32 in run order, so no prefix sum over the whole stream loses
digits on small Gaussians. The background stays outside the Function
(render/pipeline.py), so autograd folds it into the final_T cotangent.

No other input gets a gradient, as in the reference and the JAX package:
GLOBAL's ``depth``; PER_PIXEL_KBUFFER's ``cov3d_inv9`` and camera, whose
per-ray depths only choose the window order, a discrete choice; and
HIERARCHICAL's, with ``opacity_power_threshold`` (the 4x4 culling test),
which only decides which entries are valid.

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

import inspect
from types import ModuleType
from typing import NamedTuple, Optional

import torch

from ..utils.profiling import span
from ..utils.snapshot import host_copies, snapshot_on_failure
from . import global_blend, hier_blend, kbuffer_blend


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


class Kernels(NamedTuple):
    """A blend's kernel module and the names of its wrappers there. The
    wrappers are looked up on the module at each call, so a wrapper set on
    the module (a counting one, say) is the one every caller runs."""
    module: ModuleType
    forward: str
    backward: Optional[str] = None  # None: the blend renders forward only


class _Blend(torch.autograd.Function):
    """The forward and backward body of ``BlendGlobal``, ``BlendKBuffer``
    and ``BlendHier``. A subclass declares its ``kernels`` and, in its
    ``forward``, which of its inputs are the differentiable rows, which
    the camera tensors its kernels both take, and its kernels' keywords."""

    @staticmethod
    def body(ctx, kernels, rows, cam, pairs, snapshot, segs, kw,
             forward_only=()):
        """The forward: the kernel on ``rows``, ``cam`` and
        ``forward_only`` (inputs the backward kernel does not take), and
        what the backward needs saved on ``ctx``."""
        starts, ends, planes = _ranges(pairs, segs)
        kernel = getattr(kernels.module, kernels.forward)
        color, final_t, n_contrib, depth_acc = kernel(
            pairs.gauss_id, starts, ends, *rows, *cam, *forward_only, **kw)
        ctx.save_for_backward(*rows, *cam, color, final_t, n_contrib)
        ctx.kernels = kernels
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
            kernel = getattr(ctx.kernels.module, ctx.kernels.backward)
            # Autograd hands zeros for an unused output (materialize_grads).
            d_pair = _backward(
                ctx, grad_color, grad_final_t, lambda: kernel(
                    pairs.gauss_id, *ctx.ranges, *ctx.saved_tensors,
                    grad_color.contiguous(), grad_final_t.contiguous(),
                    **ctx.kw))
            d = reduce_pair_grads(sum_planes(d_pair), pairs.orig_slot,
                                  pairs.gauss_offsets)
            # xy, conic_opacity and rgb lead; no other input has a gradient.
            return (d[:, 0:2], d[:, 2:6], d[:, 6:9]) + (None,) * (
                len(ctx.needs_input_grad) - 3)

    @classmethod
    def apply_named(cls, *tensors, **named):
        """``apply`` with the leading inputs by position and the rest by
        their names in ``forward``'s signature, in whatever order."""
        bound = inspect.signature(cls.forward).bind(None, *tensors, **named)
        bound.apply_defaults()
        return cls.apply(*bound.args[1:])


class BlendGlobal(_Blend):
    """(xy, conic_opacity, rgb, depth, pairs, grid) -> K1's four outputs,
    differentiable in xy, conic_opacity and rgb through color and final_T."""

    kernels = Kernels(global_blend, "blend_global_forward",
                      "blend_global_backward")

    @staticmethod
    def forward(ctx, xy, conic_opacity, rgb, depth, pairs, grid_x, grid_y,
                width, height, snapshot=None, segs=None):
        kw = dict(grid_x=grid_x, grid_y=grid_y, width=width, height=height,
                  pieces=None if segs is None else segs.pieces)
        return _Blend.body(ctx, BlendGlobal.kernels, (xy, conic_opacity, rgb),
                           (), pairs, snapshot, segs, kw,
                           forward_only=(depth,))


class BlendKBuffer(_Blend):
    """(xy, conic_opacity, rgb, cov3d_inv9, inverse_vp, campos, pairs, k,
    grid) -> K3's four outputs, differentiable in xy, conic_opacity and rgb
    through color and final_T."""

    kernels = Kernels(kbuffer_blend, "blend_kbuffer_forward",
                      "blend_kbuffer_backward")

    @staticmethod
    def forward(ctx, xy, conic_opacity, rgb, cov3d_inv9, inverse_vp, campos,
                pairs, k, grid_x, grid_y, width, height, snapshot=None,
                segs=None):
        kw = dict(k=k, grid_x=grid_x, grid_y=grid_y, width=width,
                  height=height)
        return _Blend.body(ctx, BlendKBuffer.kernels,
                           (xy, conic_opacity, rgb),
                           (cov3d_inv9, inverse_vp, campos), pairs, snapshot,
                           segs, kw)


class BlendHier(_Blend):
    """(xy, conic_opacity, rgb, cov3d_inv9, opacity_power_threshold,
    inverse_vp, campos, pairs, queues, hier_4x4_culling, grid) -> K5's four
    outputs, differentiable in xy, conic_opacity and rgb through color and
    final_T. A last, optional ``batched_cascade`` takes K5's and K6's
    batched cadence."""

    kernels = Kernels(hier_blend, "blend_hier_forward", "blend_hier_backward")

    @staticmethod
    def forward(ctx, xy, conic_opacity, rgb, cov3d_inv9,
                opacity_power_threshold, inverse_vp, campos, pairs,
                queue_sizes, hier_4x4_culling, grid_x, grid_y, width, height,
                snapshot=None, segs=None, batched_cascade=False):
        kw = dict(queue_sizes=queue_sizes, hier_4x4_culling=hier_4x4_culling,
                  grid_x=grid_x, grid_y=grid_y, width=width, height=height,
                  batched_cascade=batched_cascade)
        return _Blend.body(ctx, BlendHier.kernels, (xy, conic_opacity, rgb),
                           (cov3d_inv9, opacity_power_threshold, inverse_vp,
                            campos), pairs, snapshot, segs, kw)
