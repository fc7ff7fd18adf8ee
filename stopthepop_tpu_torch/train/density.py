"""Adaptive density control (densify / clone / split / prune), torch.

Port of ``stopthepop_tpu/train/density.py``. The JAX package allocates the
model at a static capacity with an ``active`` mask, because XLA needs static
shapes; that is a TPU device, and here the parameters are resized instead,
as the upstream 3DGS trainer does. ``capacity`` stays the budget of Gaussians:
densification requests beyond it are dropped and reported, in the JAX
package's order (clones first, then the splits' children by parent).

The optimizer's moments follow the rows: kept rows keep theirs, pruned and
split-away rows are dropped, and the rows the controller writes (clones and
split children) start at zero moments, as JAX ``reset_opt_slots`` leaves
them. ``reset_opacity`` zeroes the moments of every parameter on the rows it
changes, as the JAX CLI does.

Semantics follow the standard 3DGS controller: Gaussians whose averaged
screen-space positional gradient reaches ``grad_threshold`` are densified —
cloned if small (max scale <= percent_dense * scene_extent), split into
``n_split`` samples with scales / 1.6 if large; Gaussians with opacity below
``opacity_cull`` (or, with ``max_screen_size``, too large) are pruned.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..models.gaussians import PARAM_NAMES, GaussianModel
from ..ops.covariance import quat_to_rotmat
from .trainer import DensifyStats, init_densify_stats


class DensifyConfig(NamedTuple):
    grad_threshold: float = 2e-4
    percent_dense: float = 0.01
    opacity_cull: float = 0.005
    split_scale_factor: float = 1.6
    n_split: int = 2
    max_screen_size: Optional[float] = None   # prune if max radius exceeds
    max_world_size_frac: float = 0.1          # of scene_extent, with ^^


def _optimizer_slots(optimizer, model):
    """(group, parameter name) for each model parameter the optimizer holds."""
    by_id = {id(getattr(model, n)): n for n in PARAM_NAMES}
    for group in optimizer.param_groups:
        for p in group["params"]:
            if id(p) in by_id:
                yield group, by_id[id(p)]


@torch.no_grad()
def rebuild_rows(model: GaussianModel, optimizer, keep: torch.Tensor,
                 new_rows: Optional[dict] = None) -> None:
    """Resize every parameter to ``[old[keep], new_rows]`` in place.

    ``keep`` [K] int64 indexes the rows that stay (their Adam moments stay
    with them); ``new_rows`` maps each parameter name to appended rows,
    which start at zero moments. The optimizer's groups are pointed at the
    new parameters.
    """
    slots = list(_optimizer_slots(optimizer, model)) if optimizer else []
    old_state = {n: optimizer.state.pop(getattr(model, n), None)
                 for _, n in slots}
    for name in PARAM_NAMES:
        old = getattr(model, name)
        rows = [old[keep]]
        if new_rows is not None:
            rows.append(new_rows[name].to(old.dtype))
        setattr(model, name, torch.nn.Parameter(torch.cat(rows)))
    for group, name in slots:
        new_p = getattr(model, name)
        group["params"] = [new_p]
        state = old_state[name]
        if not state:
            continue
        n_new = new_p.shape[0] - keep.shape[0]
        for key in ("exp_avg", "exp_avg_sq"):
            moment = state[key][keep]
            state[key] = torch.cat(
                [moment, moment.new_zeros((n_new, *moment.shape[1:]))])
        optimizer.state[new_p] = state


@torch.no_grad()
def zero_moments(optimizer, model: GaussianModel, rows: torch.Tensor) -> None:
    """Zero every parameter's Adam moments on the rows where ``rows`` [P]
    is true (JAX ``reset_opt_slots``)."""
    for _, name in _optimizer_slots(optimizer, model):
        state = optimizer.state.get(getattr(model, name))
        if not state:
            continue
        for key in ("exp_avg", "exp_avg_sq"):
            state[key][rows] = 0.0


@torch.no_grad()
def densify_and_prune(
    model: GaussianModel,
    optimizer,
    stats: DensifyStats,
    generator: torch.Generator,
    scene_extent: float,
    capacity: int,
    cfg: DensifyConfig = DensifyConfig(),
):
    """One densification round, in place on ``model`` and ``optimizer``.

    Returns (stats, info): fresh zero stats for the new rows, and counts
    (``num_active``, ``num_cloned``, ``num_split``, ``num_pruned``,
    ``dropped`` — requests that did not fit in ``capacity``). The split
    samples are drawn from ``generator``.
    """
    dev = model.means3d.device
    avg_grad = stats.grad2d_accum / torch.clamp(stats.denom, min=1)
    max_scale = torch.exp(torch.amax(model.scales_log, dim=-1))
    opacity = torch.sigmoid(model.opacity_logit)

    # -- prune --
    prune = opacity < cfg.opacity_cull
    if cfg.max_screen_size is not None:
        prune = prune | (stats.max_radii > cfg.max_screen_size) | (
            max_scale > cfg.max_world_size_frac * scene_extent)
    active = ~prune

    # -- select densification candidates --
    sel = active & (avg_grad >= cfg.grad_threshold)
    small = max_scale <= cfg.percent_dense * scene_extent
    clone = sel & small
    split = sel & ~small

    # -- the budget: clones take the first free ranks, then the splits'
    # children by parent and child (JAX density.py:135-175) --
    n_free = capacity - int(active.sum())
    clone_idx = torch.nonzero(clone).flatten()
    split_idx = torch.nonzero(split).flatten()
    total_clone = clone_idx.shape[0]
    ok_c = torch.arange(total_clone, device=dev) < n_free
    clone_src = clone_idx[ok_c]
    ranks = (total_clone + torch.arange(split_idx.shape[0], device=dev)[:, None]
             * cfg.n_split + torch.arange(cfg.n_split, device=dev)[None, :])
    fits = ranks < n_free                                  # [S, n_split]
    placed = fits.any(dim=1)
    split_src = split_idx[placed]
    fits = fits[placed]

    # -- split samples: n_split per parent, offsets ~ R N(0, scale) --
    scales = torch.exp(model.scales_log[split_src])
    R = quat_to_rotmat(torch.nn.functional.normalize(
        model.rotations[split_src], dim=-1))
    new_scales_log = model.scales_log[split_src] - math.log(
        cfg.split_scale_factor)
    children = []
    for i in range(cfg.n_split):
        noise = torch.randn(split_src.shape[0], 3, generator=generator,
                            device=generator.device).to(dev) * scales
        ok = fits[:, i]
        child = {n: getattr(model, n)[split_src][ok] for n in PARAM_NAMES}
        child["means3d"] = (model.means3d[split_src]
                            + torch.einsum("pij,pj->pi", R, noise))[ok]
        child["scales_log"] = new_scales_log[ok]
        children.append(child)

    gone = prune.clone()
    gone[split_src] = True
    keep = torch.nonzero(~gone).flatten()
    new_rows = {
        n: torch.cat([getattr(model, n)[clone_src]] + [c[n] for c in children])
        for n in PARAM_NAMES
    }
    rebuild_rows(model, optimizer, keep, new_rows)

    n_split_req = split_idx.shape[0]
    info = {
        "num_active": model.num_gaussians,
        "num_cloned": int(clone_src.shape[0]),
        "num_split": int(split_src.shape[0]),
        "num_pruned": int(prune.sum()),
        "dropped": (total_clone - int(clone_src.shape[0])
                    + cfg.n_split * (n_split_req - int(split_src.shape[0]))),
    }
    return init_densify_stats(model.num_gaussians, dev), info


@torch.no_grad()
def reset_opacity(model: GaussianModel, optimizer=None,
                  max_opacity: float = 0.01) -> torch.Tensor:
    """Periodic opacity clamp (3DGS caps opacities at ``max_opacity``), in
    place. Returns the [P] mask of rows it changed; with an ``optimizer``
    their moments are zeroed."""
    ceil_logit = math.log(max_opacity / (1.0 - max_opacity))
    new_logit = torch.clamp(model.opacity_logit, max=ceil_logit)
    changed = new_logit != model.opacity_logit
    model.opacity_logit.copy_(new_logit)
    if optimizer is not None:
        zero_moments(optimizer, model, changed)
    return changed
