"""Public rasterization API (torch).

Port of ``stopthepop_tpu/render/rasterize.py`` for all four sort modes
under every stream order: GLOBAL, PER_PIXEL_KBUFFER and HIERARCHICAL forward
and backward, PER_PIXEL_FULL forward (kernel K7) and, on small scenes,
differentiable through the dense oracle (``full_mode``). It mirrors the
reference's Python surface (diff_gaussian_rasterization/__init__.py:32-53,
265-314): ``rasterize_gaussians(...)`` and
``GaussianRasterizer`` with the same argument names and validation messages,
returning ``(color [3, H, W], radii [P])``. The render runs on the device of
``means3D``; the settings' tensors follow it there.

Gradients flow by autograd to all 8 reference inputs (means3D, means2D, sh,
colors_precomp, opacities, scales, rotations, cov3Ds_precomp); the blend's
backward is kernel K2, K4 or K6 (kernels/blend_vjp.py), or autograd through
the dense PER_PIXEL_FULL oracle (JAX's ``stop_gradient`` on the tiled FULL
path gives zero gradients; here that path raises instead). ``means2D`` is the
densification dummy: its value does not change the render, and its gradient
is the pixel-space mean gradient scaled by (0.5 W, 0.5 H), as in the JAX
package. There is no pair capacity: the pair count is read back once per
frame, as in the reference. The debug paths are ported too: the six debug
visualization modes and ``render_depth`` (render/debug_viz.py), and the
``debug=True`` failure snapshots (utils/snapshot.py).

``tile_shape`` = (tile_x, tile_y) sets the binning tile, as in the JAX
package (``None``: 16x16, the reference's). GLOBAL takes any multiple of 16
on each side (32x16 is the JAX package's benchmarked and trained default),
the resort modes 16x16 and 32x16; any other raises NotImplementedError
naming the binning tile (render/pipeline.py). ``num_rendered`` counts the
binning tiles' pairs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import DebugVisualization, GaussianRasterizationSettings, SortMode
from ..ops.transforms import mark_visible
from ..utils.profiling import span
from ..utils.snapshot import host_copies, snapshot_on_failure
from .debug_viz import DebugVisualizationData, apply_debug_visualization
from .duplicate import rect_histogram
from .naive import render_full_sort_naive
from .pipeline import render_sorted, sort_mode_of, tile_grid
from .preprocess import preprocess

FULL_MODES = ("auto", "naive", "tiled")
# Off the GPU, or when gradients are asked for, PER_PIXEL_FULL with
# full_mode="auto" takes the dense oracle while its [P, pixels] tables stay
# at or below this many entries (the JAX package's rule,
# render/rasterize.py:314-332), else kernel K7's path.
FULL_NAIVE_MAX = 1 << 26


def full_backend(full_mode: str, device, wants_grad: bool, num_points: int,
                 width: int, height: int) -> str:
    """PER_PIXEL_FULL's backend for ``full_mode``: "naive" (the dense
    oracle) or "tiled" (kernel K7).

    "auto" takes K7 on a CUDA device whenever no gradient is asked for: it
    serves a frame of any size. Otherwise it keeps the JAX package's rule,
    the dense oracle while P·W·H <= ``FULL_NAIVE_MAX``, which is also the
    only backend that gives gradients.
    """
    if full_mode != "auto":
        return full_mode
    if torch.device(device).type == "cuda" and not wants_grad:
        return "tiled"
    return ("naive" if num_points * width * height <= FULL_NAIVE_MAX
            else "tiled")


class RenderOutput(NamedTuple):
    color: torch.Tensor      # [3, H, W]
    radii: torch.Tensor      # [P] int32
    final_t: torch.Tensor    # [H, W]
    n_contrib: torch.Tensor  # [H, W] int32 (GLOBAL: position of the last
                             # blend; PPX_KBUFFER: number of commits; HIER:
                             # number of head-pop commits with alpha > 0;
                             # PPX_FULL: rank of the last committed entry in
                             # the pixel's depth order, its number of commits)
    depth_acc: torch.Tensor  # [H, W] sum(depth * alpha * T) (PPX_KBUFFER,
                             # HIER and PPX_FULL: the depth along the
                             # pixel's ray)
    num_rendered: int        # (binning tile, Gaussian) pairs of this frame
                             # (the dense PPX_FULL path: those its rects
                             # imply)


def rasterize_gaussians(
    means3D,
    means2D,
    sh,
    colors_precomp,
    opacities,
    scales,
    rotations,
    cov3Ds_precomp,
    raster_settings: GaussianRasterizationSettings,
    *,
    full_output: bool = False,
    full_mode: str = "auto",
    debug_visualization: DebugVisualization = DebugVisualization.Disabled,
    debug_data: Optional[DebugVisualizationData] = None,
    tile_shape: Optional[tuple] = None,
    batched_cascade: bool = False,
):
    """Render. Returns (color, radii) like the reference, or RenderOutput.

    ``tile_shape`` = (tile_x, tile_y) is the binning tile (module notes);
    ``None`` is 16x16. ``batched_cascade`` takes HIERARCHICAL's batched
    cadence (mid and head windows in sorted sub-batches of 8,
    ``kernels/hier_blend.py``); the other sort modes ignore it, as the JAX
    package's do.

    ``full_mode`` chooses PER_PIXEL_FULL's backend: "naive", the dense
    differentiable oracle (render/naive.py); "tiled", kernel K7, forward
    only like the reference (its FULL backward throws, backward.cu:733-736),
    so asking it for gradients raises; "auto", see ``full_backend``: K7 on
    the GPU when no gradient is asked for, else naive while P·W·H <= 2**26.

    ``debug_visualization`` replaces the colour by the mode's colormapped
    scalar field (render/debug_viz.py), its statistics going into
    ``debug_data``; ``render_depth=True`` in the settings maps to the Depth
    mode, as in the reference (rasterize_points.cu:104-107). With
    ``debug=True`` the inputs are copied to the host first, and a forward
    or blend backward that raises writes them to snapshot_fw.npz /
    snapshot_bw.npz under ``$STP_SNAPSHOT_DIR`` before re-raising (the
    reference's debug contract, __init__.py:96-103, 149-156).
    """
    if full_mode not in FULL_MODES:
        raise ValueError(f"full_mode must be one of {FULL_MODES}, got {full_mode!r}")
    args = (means3D, means2D, sh, colors_precomp, opacities, scales,
            rotations, cov3Ds_precomp, raster_settings)
    kw = dict(full_output=full_output, full_mode=full_mode,
              debug_visualization=debug_visualization, debug_data=debug_data,
              tile_shape=tile_shape, batched_cascade=batched_cascade)
    rs = raster_settings
    if not rs.debug:
        return _rasterize_impl(*args, **kw)
    arrays = host_copies({
        "means3D": means3D, "means2D": means2D, "sh": sh,
        "colors_precomp": colors_precomp, "opacities": opacities,
        "scales": scales, "rotations": rotations,
        "cov3Ds_precomp": cov3Ds_precomp, "bg": rs.bg,
        "viewmatrix": rs.viewmatrix, "projmatrix": rs.projmatrix,
        "inv_viewprojmatrix": rs.inv_viewprojmatrix, "campos": rs.campos,
    })
    meta = {"settings": rs.settings.to_dict(),
            **{f: getattr(rs, f) for f in (
                "image_height", "image_width", "tanfovx", "tanfovy",
                "scale_modifier", "sh_degree", "prefiltered",
                "render_depth")}}
    with snapshot_on_failure("fw", arrays, meta, device=means3D.device):
        return _rasterize_impl(*args, **kw, snapshot=(arrays, meta))


def _rasterize_impl(
    means3D,
    means2D,
    sh,
    colors_precomp,
    opacities,
    scales,
    rotations,
    cov3Ds_precomp,
    raster_settings: GaussianRasterizationSettings,
    *,
    full_output: bool,
    full_mode: str,
    debug_visualization: DebugVisualization,
    debug_data: Optional[DebugVisualizationData],
    tile_shape: Optional[tuple],
    batched_cascade: bool,
    snapshot=None,
):
    rs = raster_settings

    def none_if_empty(x):
        return None if x is None or x.numel() == 0 else x

    sh = none_if_empty(sh)
    colors_precomp = none_if_empty(colors_precomp)
    scales = none_if_empty(scales)
    rotations = none_if_empty(rotations)
    cov3Ds_precomp = none_if_empty(cov3Ds_precomp)
    sort_mode, sort_kw = sort_mode_of(rs, tile_shape, batched_cascade)
    tile_x, tile_y = sort_kw["tile_x"], sort_kw["tile_y"]
    ext = rs.settings
    dev = means3D.device
    W, H = int(rs.image_width), int(rs.image_height)

    def on_dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    viewmatrix, projmatrix = on_dev(rs.viewmatrix), on_dev(rs.projmatrix)
    campos, bg = on_dev(rs.campos), on_dev(rs.bg)
    inverse_vp = (None if rs.inv_viewprojmatrix is None
                  else on_dev(rs.inv_viewprojmatrix))

    if rs.prefiltered and not bool(mark_visible(means3D, viewmatrix, projmatrix).all()):
        # The reference __trap()s on this contract violation.
        raise RuntimeError(
            "prefiltered=True but some points lie outside the view "
            "frustum (the reference traps on this contract "
            "violation, auxiliary.h:228-232). Run markVisible and "
            "filter, or pass prefiltered=False."
        )

    with span("preprocess"):
        prep = preprocess(
            means3D,
            opacities,
            scales=scales,
            rotations=rotations,
            cov3d_precomp=cov3Ds_precomp,
            shs=sh,
            colors_precomp=colors_precomp,
            scale_modifier=rs.scale_modifier,
            viewmatrix=viewmatrix,
            projmatrix=projmatrix,
            campos=campos,
            tanfovx=rs.tanfovx,
            tanfovy=rs.tanfovy,
            image_width=W,
            image_height=H,
            sh_degree=rs.sh_degree,
            sort_order=sort_kw["sort_order"],
            rect_bounding=ext.culling_settings.rect_bounding,
            tight_opacity_bounding=ext.culling_settings.tight_opacity_bounding,
            proper_ewa_scaling=ext.proper_ewa_scaling,
            tile_x=tile_x,
            tile_y=tile_y,
        )
        if means2D is not None and means2D.numel():
            # Densification-gradient dummy: a value-neutral reroute, so that
            # d loss / d means2D = pixel-space mean gradient * (0.5 W, 0.5 H).
            m2d = means2D[:, :2] * means2D.new_tensor([0.5 * W, 0.5 * H])
            prep = prep._replace(mean2d=prep.mean2d + m2d - m2d.detach())
    num_rendered, pairs, naive = None, None, False
    if sort_mode == SortMode.PPX_FULL:
        inputs = (means3D, means2D, sh, colors_precomp, opacities, scales,
                  rotations, cov3Ds_precomp)
        wants_grad = torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in inputs)
        naive = full_backend(full_mode, dev, wants_grad, means3D.shape[0], W,
                             H) == "naive"
        if wants_grad and not naive:
            raise RuntimeError(
                "PER_PIXEL_FULL through kernel K7 (full_mode='tiled', or "
                "'auto' above P*W*H = 2**26) renders forward only, as the "
                "reference's FULL mode (backward.cu:733-736 throws); for "
                "gradients pass full_mode='naive' (dense, small scenes) or "
                "render under torch.no_grad()")
    if naive:
        color, final_t, n_contrib, depth_acc = render_full_sort_naive(
            prep, bg, W, H, campos, inverse_vp, tile=(tile_x, tile_y))
        final_t, n_contrib = final_t.reshape(H, W), n_contrib.reshape(H, W)
        num_rendered = int(prep.tiles_touched.sum())
    else:
        color, final_t, n_contrib, pairs, depth_acc = render_sorted(
            sort_mode, prep, bg, image_width=W, image_height=H,
            campos=campos, inverse_vp=inverse_vp, snapshot=snapshot,
            **sort_kw)

    viz_mode = DebugVisualization(debug_visualization)
    if rs.render_depth and viz_mode == DebugVisualization.Disabled:
        viz_mode = DebugVisualization.Depth
    if viz_mode != DebugVisualization.Disabled:
        # The pairs of each binning tile. The dense FULL oracle builds no
        # pair list: its counts are those its rects imply.
        counts = (pairs.ends - pairs.starts if pairs is not None else
                  rect_histogram(prep, *tile_grid(W, H, tile_x, tile_y)))
        color = apply_debug_visualization(
            viz_mode, final_t=final_t, n_contrib=n_contrib,
            depth_acc=depth_acc, pair_counts=counts, prep=prep,
            campos=campos, inverse_vp=inverse_vp, width=W, height=H,
            data=debug_data, tile=(tile_x, tile_y))
    if full_output:
        return RenderOutput(
            color, prep.radii, final_t, n_contrib, depth_acc,
            pairs.num_rendered if num_rendered is None else num_rendered)
    return color, prep.radii


class GaussianRasterizer(torch.nn.Module):
    """API-parity rasterizer module (reference __init__.py:265-314)."""

    def __init__(self, raster_settings: GaussianRasterizationSettings, **kw):
        super().__init__()
        self.raster_settings = raster_settings
        self._kw = kw

    def markVisible(self, positions):
        with torch.no_grad():
            rs = self.raster_settings
            dev = positions.device
            return mark_visible(
                positions,
                torch.as_tensor(rs.viewmatrix, dtype=torch.float32, device=dev),
                torch.as_tensor(rs.projmatrix, dtype=torch.float32, device=dev),
            )

    def forward(
        self,
        means3D,
        means2D,
        opacities,
        shs=None,
        colors_precomp=None,
        scales=None,
        rotations=None,
        cov3D_precomp=None,
    ):
        if (shs is None and colors_precomp is None) or (
            shs is not None and colors_precomp is not None
        ):
            raise Exception(
                "Please provide excatly one of either SHs or precomputed colors!"
            )
        if ((scales is None or rotations is None) and cov3D_precomp is None) or (
            (scales is not None or rotations is not None)
            and cov3D_precomp is not None
        ):
            raise Exception(
                "Please provide exactly one of either scale/rotation pair or "
                "precomputed 3D covariance!"
            )
        return rasterize_gaussians(
            means3D,
            means2D,
            shs,
            colors_precomp,
            opacities,
            scales,
            rotations,
            cov3D_precomp,
            self.raster_settings,
            **self._kw,
        )
