"""Dense PER_PIXEL_FULL oracle (torch, differentiable): the small-scene path.

Port of the part of ``stopthepop_tpu/render/naive.py`` that the
PER_PIXEL_FULL sort mode needs: ``_pixel_grid``, ``_alpha``,
``blend_prefix``, ``_finalize`` and ``render_full_sort_naive``. It renders
in O(P x pixels) memory with no tiling, so it serves small scenes only
(``render/rasterize.py`` picks it while P·W·H <= 2**26); larger frames go
through kernel K7 (``kernels/full_blend.py``), which computes the same
function forward only.

The reference's sequential per-pixel loop becomes a masked prefix product:
front to back, U_k = exp(sum_{i<=k} log1p(-alpha_i)), and the loop's early
exit (T < 1e-4 -> done) is the mask [U_k >= 1e-4], since U never rises.
Masks and thresholds are constants for the gradient, as in the reference's
CUDA backward.
"""

from __future__ import annotations

import torch

from ..constants import ALPHA_MAX, ALPHA_THRESHOLD, T_THRESHOLD, TILE_X, TILE_Y
from ..ops.stopthepop import depth_along_ray
from ..ops.transforms import compute_view_ray
from .preprocess import PreprocessOutput


def _pixel_grid(width: int, height: int, device=None):
    """[H*W, 2] pixel coordinates (x, y), row-major like the reference."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def _alpha(conic_opacity, mean2d, pix):
    """Alpha of every Gaussian at every pixel, and where it is skipped.

    conic_opacity [G, 4], mean2d [G, 2], pix [N, 2] -> (alpha [G, N], skip
    [G, N]): power < 0 or alpha < 1/255 skip; alpha clamps at 0.99
    (forward.cu:312-325).
    """
    d = mean2d[:, None, :] - pix[None, :, :]
    a, b, c, opw = (conic_opacity[:, i:i + 1] for i in range(4))
    factor = (0.5 * (a * d[..., 0] ** 2 + c * d[..., 1] ** 2)
              + b * d[..., 0] * d[..., 1])
    alpha = torch.clamp(opw * torch.exp(-factor), max=ALPHA_MAX)
    skip = (factor < 0.0) | (alpha < ALPHA_THRESHOLD)
    return alpha, skip


def blend_prefix(alpha_eff, feats):
    """Blend a front-to-back sorted stack with the masked prefix product.

    alpha_eff [G, N] (0 where skipped), feats [G, N, C]. Returns (T [N], C
    [N, C], idx [N] int32): T the last committed U (1 where nothing
    commits), idx the 1-based position of the last committed entry with
    alpha > 0. (The JAX version also carries T, C and idx between batches
    for its batched renderers, which are not ported.)
    """
    U = torch.exp(torch.cumsum(torch.log1p(-alpha_eff), dim=0))  # inclusive
    T_before = torch.cat([torch.ones_like(U[:1]), U[:-1]], dim=0)
    commit = U >= T_THRESHOLD
    w = alpha_eff * T_before * commit
    C = torch.einsum("gn,gnc->nc", w, feats)
    T = torch.where(commit, U, torch.ones_like(U)).min(dim=0).values
    pos = torch.arange(1, alpha_eff.shape[0] + 1, dtype=torch.int32,
                       device=alpha_eff.device)
    contributed = commit & (alpha_eff > 0.0)
    idx = torch.where(contributed, pos[:, None], 0).max(dim=0).values
    return T, C, idx.to(torch.int32)


def _finalize(C, T, bg, width: int, height: int):
    """C + T * bg, laid out [3, H, W] like the reference."""
    img = C + T[:, None] * bg[None, :]
    return img.reshape(height, width, 3).permute(2, 0, 1)


def render_full_sort_naive(prep: PreprocessOutput, bg, width: int,
                           height: int, campos, inverse_vp):
    """PER_PIXEL_FULL oracle: every pixel sorts all Gaussians by exact depth
    along its ray and blends them front to back.

    A Gaussian counts at a pixel where its rect covers the pixel's tile, it
    is valid, it passes the alpha tests and its ray depth is >= 0
    (resorted_render.cuh:182-184); the sort is stable, so exact ties keep
    Gaussian order. Differentiable through alpha and rgb; the depth channel
    and the order are not. Returns (color [3, H, W], final_T [H*W],
    n_contrib [H*W] int32 (1-based rank of the last committed entry),
    depth_acc [H, W] (sum of w * ray depth)).
    """
    dev = prep.mean2d.device
    pix = _pixel_grid(width, height, dev)
    pix_tx = torch.div(pix[:, 0], TILE_X, rounding_mode="floor").to(torch.int32)
    pix_ty = torch.div(pix[:, 1], TILE_Y, rounding_mode="floor").to(torch.int32)

    viewdir = compute_view_ray(pix, width, height, inverse_vp, campos)
    depth = depth_along_ray(prep.cov3d_inv9[:, None, :], viewdir[None, :, :])

    alpha, skip = _alpha(prep.conic_opacity, prep.mean2d, pix)
    in_rect = ((pix_tx[None, :] >= prep.rect_min[:, None, 0])
               & (pix_tx[None, :] < prep.rect_max[:, None, 0])
               & (pix_ty[None, :] >= prep.rect_min[:, None, 1])
               & (pix_ty[None, :] < prep.rect_max[:, None, 1]))
    drop = skip | ~in_rect | ~prep.valid[:, None] | (depth < 0.0)
    alpha_eff = torch.where(drop, torch.zeros_like(alpha), alpha)

    key = torch.where(alpha_eff > 0.0, depth.detach(),
                      torch.full_like(alpha, float("inf")))
    order = torch.sort(key, dim=0, stable=True).indices  # [P, N]
    alpha_sorted = torch.gather(alpha_eff, 0, order)
    depth_sorted = torch.gather(depth.detach(), 0, order)
    rgb_sorted = prep.rgb[order]  # [P, N, 3]

    # The 4th channel accumulates w * ray depth (the Depth visualization).
    feats = torch.cat([rgb_sorted, depth_sorted[..., None]], dim=-1)
    T, C, idx = blend_prefix(alpha_sorted, feats)
    return (_finalize(C[:, :3], T, bg, width, height), T, idx,
            C[:, 3].reshape(height, width))
