"""Band-sharded rendering and training: image rows x Gaussians over one axis.

Port of ``stopthepop_tpu/parallel/spatial.py`` to torch.distributed, for
scenes and images too large for one card (BASELINE config 5: 10M+
Gaussians at 4K):

  * the Gaussian parameters are sharded over the group: each rank
    preprocesses only its own P/n rows (SH, covariance projection);
  * the image is cut into n horizontal bands of tile rows: each rank runs
    the pair build, the (tile, depth) sort and the blend (K1, K3 or K5, and
    their backwards K2, K4, K6) for its own band only;
  * between the two, one collective: an all-gather of the compact
    per-Gaussian render features (a float table [p, 20] and an int table
    [p, 5]), never of the raw parameters. Its backward is a reduce-scatter,
    so the per-band feature gradients sum onto the rank that owns the rows;
  * the D-SSIM loss needs 5 rows of the neighbouring bands (11x11 window):
    a halo exchange, zero-filled at the true image edges like the
    zero-padded convolution, makes the sharded loss the single-device one.

Every sort order and the resort modes run band-sharded. A band is
rendered in the image's own pixel and tile coordinates: its Gaussians'
rects are clamped to the band's tile rows, the port's
``render/pipeline.py`` renders them unchanged into an image of the full
size whose other tiles hold no pair, and the band's rows are cut out. Every
pixel thus sees the same pairs, keys and view ray as in the single-device
render, and the band renders are the single-device image to the bit. (JAX
renders a band-sized image instead, for the TPU's static shapes, and remaps
its rows onto the image's rays through an adjusted inverse view-projection
matrix, ``band_inverse_vp``; those rays round otherwise, and two ray depths
that tie to the last bits can swap in the resort modes: on an H100 at
1080p, 500K Gaussians, ~1,440 pixels of an orbit frame in PPX_KBUFFER and
HIER with one band. The port needs no such matrix.) ``render_band`` is the
collective-free core: the band's render from the gathered tables.
PER_PIXEL_FULL raises ``NotImplementedError`` (JAX's ``band_render``
renders it as GLOBAL, spatial.py:230-239). The JAX functions' ``interpret``
and static ``band_capacity`` are TPU devices and have no counterpart (the
pair count is dynamic); ``axis`` names a dimension of the DeviceMesh, and
the functions called inside JAX's shard_map take the process ``group``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import GaussianRasterizationSettings, SortMode
from ..constants import TILE_Y
from ..io.cameras import CameraArrays
from ..models.gaussians import GaussianModel, row_block
from ..render.pipeline import render_sorted, sort_mode_of, tile_grid
from ..render.preprocess import PreprocessOutput, preprocess
from ..train.loss import _gaussian_kernel1d
from .collectives import (
    all_gather_plain,
    all_gather_rows,
    halo_exchange,
    halo_exchange_plain,
    psum,
)

HALO = 5  # half of the 11x11 SSIM window


class SpatialConfig(NamedTuple):
    grid_x: int
    grid_y: int        # full-image tile rows (unpadded)
    band_gy: int       # tile rows per band (grid_y padded to n bands)
    image_width: int
    image_height: int  # true image height
    n_bands: int

    @property
    def band_h(self) -> int:
        """Pixel rows a band holds (the last band's past the image height
        are zeros)."""
        return self.band_gy * TILE_Y


def plan_bands(image_width: int, image_height: int,
               n_bands: int) -> SpatialConfig:
    grid_x, grid_y = tile_grid(image_width, image_height)
    band_gy = -(-grid_y // n_bands)
    return SpatialConfig(grid_x, grid_y, band_gy, image_width, image_height,
                         n_bands)


def band_rows(image: torch.Tensor, cfg: SpatialConfig, band: int):
    """Rows of ``band`` of a full [C, H, W] image, zero-padded past the
    image's height: [C, band_h, W] (the target of a band's loss)."""
    rows = image[:, band * cfg.band_h:(band + 1) * cfg.band_h]
    pad = cfg.band_h - rows.shape[1]
    return torch.nn.functional.pad(rows, (0, 0, 0, pad)) if pad else rows


def _with_camera(rs: GaussianRasterizationSettings, cam: CameraArrays,
                 device) -> GaussianRasterizationSettings:
    def on_dev(x):
        return None if x is None else torch.as_tensor(
            x, dtype=torch.float32, device=device)

    return rs._replace(
        viewmatrix=on_dev(cam.viewmatrix), projmatrix=on_dev(cam.projmatrix),
        inv_viewprojmatrix=on_dev(cam.inv_viewprojmatrix),
        campos=on_dev(cam.campos), bg=on_dev(rs.bg))


def _preprocess_features(model: GaussianModel, rs: GaussianRasterizationSettings):
    """Shard preprocess -> (float table [p, 20], int table [p, 5] int32).

    Float columns: mean2d xy, conic_opacity abco, rgb, depth,
    opacity_power_threshold, the packed inverse 3D covariance (6 + 3 u).
    Int columns: rect_min xy, rect_max xy, valid. Depth, threshold and
    covariance carry no gradient, as in the single-device render.
    """
    ext = rs.settings
    prep = preprocess(
        model.means3d, model.opacities(), scales=model.scales(),
        rotations=model.rotations_normalized(), shs=model.shs(),
        scale_modifier=rs.scale_modifier, viewmatrix=rs.viewmatrix,
        projmatrix=rs.projmatrix, campos=rs.campos, tanfovx=rs.tanfovx,
        tanfovy=rs.tanfovy, image_width=rs.image_width,
        image_height=rs.image_height, sh_degree=rs.sh_degree,
        sort_order=ext.sort_settings.sort_order,
        rect_bounding=ext.culling_settings.rect_bounding,
        tight_opacity_bounding=ext.culling_settings.tight_opacity_bounding,
        proper_ewa_scaling=ext.proper_ewa_scaling,
    )
    feat = torch.cat([
        prep.mean2d, prep.conic_opacity, prep.rgb,
        prep.depth.detach()[:, None],
        prep.opacity_power_threshold.detach()[:, None],
        prep.cov3d_inv9.detach(),
    ], dim=1)
    ints = torch.cat([prep.rect_min, prep.rect_max,
                      prep.valid[:, None].to(torch.int32)], dim=1)
    return feat, ints


def _band_tiles(ints: torch.Tensor, band: int, cfg: SpatialConfig):
    """(rect y min, rect y max, valid, tiles) of every row's rect clamped
    into the band's tile rows [band * band_gy, (band + 1) * band_gy), in
    the image's tile coordinates."""
    y0_tile = band * cfg.band_gy
    bmin_y = torch.clamp(ints[:, 1], y0_tile, y0_tile + cfg.band_gy)
    bmax_y = torch.clamp(ints[:, 3], y0_tile, y0_tile + cfg.band_gy)
    h = torch.clamp(bmax_y - bmin_y, min=0)
    w = torch.clamp(ints[:, 2] - ints[:, 0], min=0)
    tiles = (w * h).to(torch.int32)
    valid = (ints[:, 4] > 0) & (tiles > 0)
    return bmin_y, bmax_y, valid, torch.where(valid, tiles, 0)


def _band_prep(feat: torch.Tensor, ints: torch.Tensor, band: int,
               cfg: SpatialConfig) -> PreprocessOutput:
    """The band's PreprocessOutput from feature tables: the rects clamped to
    the band's tile rows, so that the single-device pipeline emits the
    band's pairs only."""
    P = feat.shape[0]
    bmin_y, bmax_y, valid, tiles = _band_tiles(ints, band, cfg)
    zeros = feat.new_zeros((P,))
    return PreprocessOutput(
        valid=valid,
        p_view=feat.new_zeros((P, 3)),
        mean2d=feat[:, 0:2],
        depth=feat[:, 9],
        conic_opacity=feat[:, 2:6],
        rgb=feat[:, 6:9],
        clamped=torch.zeros((P, 3), dtype=torch.bool, device=feat.device),
        radius=zeros,
        radii=torch.zeros((P,), dtype=torch.int32, device=feat.device),
        rect_dims=feat.new_zeros((P, 2)),
        rect_min=torch.stack([ints[:, 0], bmin_y], dim=1),
        rect_max=torch.stack([ints[:, 2], bmax_y], dim=1),
        tiles_touched=tiles,
        cov3d_inv9=feat[:, 11:20],
        opacity_power_threshold=feat[:, 10],
    )


def _band_mode(rs: GaussianRasterizationSettings, what: str):
    """(mode, keywords) of the settings at 16x16 bins
    (``render/pipeline.py::sort_mode_of``); PPX_FULL, which ``what`` does
    not render, raises."""
    mode, kw = sort_mode_of(rs)
    if mode == SortMode.PPX_FULL:
        raise NotImplementedError(
            f"PPX_FULL is the single-device quality oracle (forward only, like "
            f"the reference, backward.cu:733-736); {what} renders GLOBAL, "
            "PPX_KBUFFER and HIER")
    return mode, kw


def render_band(feat_all: torch.Tensor, ints_all: torch.Tensor, band: int,
                cfg: SpatialConfig, cam: CameraArrays,
                static: GaussianRasterizationSettings):
    """The collective-free core of ``band_render``: band ``band``'s
    (color [3, band_h, W], final_T [band_h, W]) from the gathered feature
    tables of every shard, in shard order. The band renders through
    render/pipeline.py at the image's size, and its rows are cut out (zeros
    past the image's height)."""
    rs = _with_camera(static, cam, feat_all.device)
    mode, kw = _band_mode(rs, "band-sharded rendering")
    prep = _band_prep(feat_all, ints_all, band, cfg)
    out = render_sorted(mode, prep, rs.bg, image_width=cfg.image_width,
                        image_height=cfg.image_height, campos=rs.campos,
                        inverse_vp=rs.inv_viewprojmatrix, **kw)
    return band_rows(out[0], cfg, band), band_rows(out[1][None], cfg, band)[0]


def band_render(model_shard: GaussianModel, cam: CameraArrays,
                rs: GaussianRasterizationSettings, cfg: SpatialConfig,
                group: Optional[dist.ProcessGroup] = None):
    """This rank's band (the rank in ``group`` is the band): preprocess
    the shard, all-gather the feature tables, ``render_band``. Returns
    (color [3, band_h, W], final_T [band_h, W])."""
    rs_cam = _with_camera(rs, cam, model_shard.means3d.device)
    feat, ints = _preprocess_features(model_shard, rs_cam)
    # The features' all-gather; its backward reduce-scatters the band's
    # feature gradients onto the rows' owners.
    feat_all = all_gather_rows(feat, group)
    ints_all = all_gather_plain(ints, group)
    return render_band(feat_all, ints_all, dist.get_rank(group), cfg, cam, rs)


def _halo_exchange(x: torch.Tensor, group=None):
    """[C, h, W] -> [C, h + 2 HALO, W] with the neighbour bands' rows."""
    if x.requires_grad and torch.is_grad_enabled():
        return halo_exchange(x, HALO, group)
    return halo_exchange_plain(x, HALO, group)


def _conv11(x: torch.Tensor, w1d):
    """Separable 11x11 Gaussian blur, zero-padded on W, valid-cropped on H
    (the H padding comes from the halo exchange), in JAX's order."""
    def conv_axis(x, axis, pad):
        if pad:
            x = torch.nn.functional.pad(x, (HALO, HALO))
        n = x.shape[axis] - 2 * HALO
        out = 0.0
        for k in range(2 * HALO + 1):
            out = out + float(w1d[k]) * x.narrow(axis, k, n)
        return out

    return conv_axis(conv_axis(x, 2, True), 1, False)


def spatial_rgb_loss(color: torch.Tensor, target: torch.Tensor,
                     cfg: SpatialConfig, group=None,
                     lambda_dssim: float = 0.2):
    """L1 + D-SSIM over band-sharded images, the single-device
    ``train/loss.py::rgb_loss``: the SSIM windows across bands get the
    neighbours' rows by halo exchange. Rows past the true image height are
    zeroed before the windows read them, as the single-device loss
    zero-pads its image (JAX's masks only the sums, so its windows read
    the rendered padding rows), and masked out of both sums. Returns the
    loss on every rank; its backward gives each rank its own band's share
    (``psum``)."""
    band = dist.get_rank(group)
    row = band * cfg.band_h + torch.arange(cfg.band_h, device=color.device)
    rmask = (row < cfg.image_height).to(torch.float32)[None, :, None]
    color, target = color * rmask, target * rmask
    n_px = 3.0 * cfg.image_height * cfg.image_width
    l1 = psum(torch.sum(torch.abs(color - target)), group) / n_px

    w1d = _gaussian_kernel1d()
    cp = _halo_exchange(color, group)
    tp = _halo_exchange(target, group)
    c1, c2 = 0.01**2, 0.03**2
    mu_p = _conv11(cp, w1d)
    mu_t = _conv11(tp, w1d)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_p = _conv11(cp * cp, w1d) - mu_pp
    sigma_t = _conv11(tp * tp, w1d) - mu_tt
    sigma_pt = _conv11(cp * tp, w1d) - mu_pt
    ssim_map = ((2 * mu_pt + c1) * (2 * sigma_pt + c2)) / (
        (mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2))
    ssim = psum(torch.sum(ssim_map * rmask), group) / n_px
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim)


def gather_bands(color: torch.Tensor, cfg: SpatialConfig, group=None):
    """Every rank's band [C, band_h, W] stacked into the full image
    [C, H, W] (band padding cropped), on every rank."""
    c, _, w = color.shape
    bands = all_gather_plain(color[None], group)  # [n, C, band_h, W]
    return bands.permute(1, 0, 2, 3).reshape(c, -1, w)[:, :cfg.image_height]


def sharded_step(model_shard: GaussianModel, optimizer, loss_fn):
    """One Adam step of ``loss_fn(model_shard)``, a replicated loss whose
    backward leaves the shard's gradients in ``.grad``; returns the
    detached loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model_shard)
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_spatial_train_step(
    mesh: DeviceMesh,
    *,
    static: GaussianRasterizationSettings,
    axis: str = "tiles",
    lambda_dssim: float = 0.2,
):
    """The band-sharded train step over the mesh dimension ``axis``.

    ``step(model_shard, optimizer, cam, target_band)``: this rank's row
    block of the model (``shard_model``), an optimizer over it, the camera
    and this rank's band of the target ([3, band_h, W], ``band_rows``).
    Updates the block in place and returns (model_shard, optimizer, loss),
    the loss on every rank; ``.grad`` holds the block's gradients.
    """
    group = mesh.get_group(axis)
    cfg = plan_bands(static.image_width, static.image_height,
                     dist.get_world_size(group))

    def step(model_shard, optimizer, cam, target_band):
        def loss_fn(ms):
            color, _ = band_render(ms, cam, static, cfg, group)
            return spatial_rgb_loss(color, target_band, cfg, group,
                                    lambda_dssim)

        return model_shard, optimizer, sharded_step(model_shard, optimizer,
                                                    loss_fn)

    return step


def make_spatial_render(
    mesh: DeviceMesh,
    *,
    static: GaussianRasterizationSettings,
    axis: str = "tiles",
):
    """Band-sharded inference render: (render, cfg), ``render(model_shard,
    cam)`` the full [3, H, W] image on every rank (band padding cropped)."""
    group = mesh.get_group(axis)
    cfg = plan_bands(static.image_width, static.image_height,
                     dist.get_world_size(group))

    @torch.no_grad()
    def render(model_shard, cam):
        color, _ = band_render(model_shard, cam, static, cfg, group)
        return gather_bands(color, cfg, group)

    return render, cfg


def shard_model(model: GaussianModel, mesh: DeviceMesh,
                axis: str = "tiles") -> GaussianModel:
    """This rank's row block of ``model`` along ``axis``."""
    return row_block(model, mesh.get_local_rank(axis),
                     dist.get_world_size(mesh.get_group(axis)))
