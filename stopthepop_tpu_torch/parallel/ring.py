"""Ring-streamed Gaussian shards: band-sharded rendering in O(P/n) memory.

Port of ``stopthepop_tpu/parallel/ring.py`` (``ring_band_render``,
``make_ring_render``, ``make_ring_train_step``) to torch.distributed. The
image is cut into bands and the Gaussians into shards, as in
``parallel/spatial.py``, but instead of all-gathering every shard's feature
table (O(P) memory a rank) the shards travel around the ring, one
``ppermute`` a step, while each rank bins the pairs of its own band.

Each of the n ring steps (``ring_step``, collective-free) keeps the rows
of the resident shard's feature tables whose Gaussians touch the band,
compacted (the gradient columns mean2d, conic_opacity and rgb, and the
depth, inverse 3D covariance and opacity power threshold, which carry
none), and counts their pairs in the band; so a rank holds O(band pairs)
rows besides its O(P/n) parameters, never O(P). After the last step
(``ring_blend``, collective-free) the steps' rows are concatenated in shard
order (at step s the band holds shard (band - s) mod n) and rendered as
``parallel/spatial.py::render_band`` renders the gathered tables: one pair
build, Gaussian-major over the whole model as in the single-device render,
so exact key ties fall as there (JAX sorts in step order, so its ties
between shards fall otherwise; a 1080p frame of 500K Gaussians has such
ties), then K1, K3 or K5 forward and K2, K4 or K6 backward. In the backward
the compaction gathers land on the resident shard's rows, unique indices,
and the ppermutes' inverse carries the gradients back to the shard's owner.

JAX's static ``per_step_capacity`` truncates a step's pairs to fit its
buffers, a TPU device; the port's pair counts are dynamic and every pair is
rendered, but the ``overflow`` flag still reports a step whose pairs exceed
the capacity, on every rank. ``chunk``, ``seg_cap``, ``carry_bf16`` and
``interpret`` are TPU devices and have no counterpart. PER_PIXEL_FULL and
tile-based culling raise, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import GaussianRasterizationSettings
from ..io.cameras import CameraArrays
from ..models.gaussians import GaussianModel
from .collectives import ppermute, ppermute_plain, psum_plain
from .spatial import (
    SpatialConfig,
    _band_mode,
    _band_tiles,
    _preprocess_features,
    _with_camera,
    gather_bands,
    plan_bands,
    render_band,
    sharded_step,
    spatial_rgb_loss,
)


class RingStep(NamedTuple):
    feat: torch.Tensor     # [m, 20] the rows of the shard touching the band
    ints: torch.Tensor     # [m, 5]
    n_pairs: torch.Tensor  # 0-d: their pairs in the band


def _ring_mode(rs: GaussianRasterizationSettings):
    _band_mode(rs, "ring streaming")
    if rs.settings.culling_settings.tile_based_culling:
        raise NotImplementedError(
            "tile_based_culling under ring streaming needs a pair-domain "
            "histogram per step; use parallel.spatial for it")


def ring_step(feat_r: torch.Tensor, ints_r: torch.Tensor, band: int,
              cfg: SpatialConfig, cam: CameraArrays,
              static: GaussianRasterizationSettings) -> RingStep:
    """One ring step, collective-free: the resident shard's rows that touch
    ``band``, compacted, and their pair count."""
    _ring_mode(_with_camera(static, cam, feat_r.device))
    tiles = _band_tiles(ints_r, band, cfg)[3]
    keep = torch.nonzero(tiles > 0).squeeze(1)
    return RingStep(feat_r.index_select(0, keep), ints_r.index_select(0, keep),
                    tiles.sum())


def ring_blend(steps: Sequence[RingStep], band: int, cfg: SpatialConfig,
               cam: CameraArrays, static: GaussianRasterizationSettings):
    """The band's render from its ring steps, collective-free: (color
    [3, band_h, W], final_T [band_h, W]). ``steps[s]`` is step s of the
    ring, which holds shard (band - s) mod n."""
    n = len(steps)
    steps = [steps[(band - i) % n] for i in range(n)]  # in shard order
    return render_band(torch.cat([s.feat for s in steps]),
                       torch.cat([s.ints for s in steps]), band, cfg, cam,
                       static)


def ring_band_render(
    model_shard: GaussianModel,
    cam: CameraArrays,
    rs: GaussianRasterizationSettings,
    cfg: SpatialConfig,
    *,
    per_step_capacity: int,
    group: Optional[dist.ProcessGroup] = None,
):
    """This rank's band by streaming the shards around the ring of
    ``group`` (the rank is the band). Returns (color [3, band_h, W],
    final_T [band_h, W], overflow), ``overflow`` a bool that is True on
    every rank when any step of any rank had more than
    ``per_step_capacity`` pairs."""
    n, band = dist.get_world_size(group), dist.get_rank(group)
    feat_r, ints_r = _preprocess_features(
        model_shard, _with_camera(rs, cam, model_shard.means3d.device))
    perm = [(i, (i + 1) % n) for i in range(n)]
    steps = []
    for s in range(n):
        steps.append(ring_step(feat_r, ints_r, band, cfg, cam, rs))
        if s + 1 < n:
            feat_r = ppermute(feat_r, perm, group)
            ints_r = ppermute_plain(ints_r, perm, group)
    most = torch.stack([st.n_pairs for st in steps]).max()
    overflow = psum_plain((most > per_step_capacity).to(torch.int64), group)
    color, final_t = ring_blend(steps, band, cfg, cam, rs)
    return color, final_t, bool(overflow > 0)


def make_ring_render(
    mesh: DeviceMesh,
    *,
    static: GaussianRasterizationSettings,
    per_step_capacity: int,
    axis: str = "shards",
):
    """Ring-streamed inference render: (render, cfg), ``render(model_shard,
    cam)`` -> (full [3, H, W] image on every rank, overflow)."""
    group = mesh.get_group(axis)
    cfg = plan_bands(static.image_width, static.image_height,
                     dist.get_world_size(group))

    @torch.no_grad()
    def render(model_shard, cam):
        color, _, overflow = ring_band_render(
            model_shard, cam, static, cfg,
            per_step_capacity=per_step_capacity, group=group)
        return gather_bands(color, cfg, group), overflow

    return render, cfg


def make_ring_train_step(
    mesh: DeviceMesh,
    *,
    static: GaussianRasterizationSettings,
    per_step_capacity: int,
    axis: str = "shards",
    lambda_dssim: float = 0.2,
):
    """The ring-streamed train step: the contract of
    ``parallel.spatial.make_spatial_train_step`` (row block and its
    optimizer, camera, this rank's target band) in O(P/n) memory a rank."""
    group = mesh.get_group(axis)
    cfg = plan_bands(static.image_width, static.image_height,
                     dist.get_world_size(group))

    def step(model_shard, optimizer, cam, target_band):
        def loss_fn(ms):
            color, _, _ = ring_band_render(
                ms, cam, static, cfg, per_step_capacity=per_step_capacity,
                group=group)
            return spatial_rgb_loss(color, target_band, cfg, group,
                                    lambda_dssim)

        return model_shard, optimizer, sharded_step(model_shard, optimizer,
                                                    loss_fn)

    return step
