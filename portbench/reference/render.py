"""A frame and a training step of the reference, from the benchmark's inputs.

``scene`` is the dict of raw parameters the benchmark makes (``means3d``
[P, 3], ``scales_log`` [P, 3], ``rotations`` [P, 4], ``opacity_logit`` [P],
``sh_dc`` [P, 1, 3], ``sh_rest`` [P, 15, 3]); ``cam`` a ``Camera`` of
float32 tensors; ``cfg`` the configuration's file as a dict. The background
is black, so the blend's raw colour is the image.

The blend is found by the configuration's ``sort_mode``: the module
``blend_<mode>.py`` (lower case) with ``blend(pairs, prep, cam, cfg,
counts)``, and for training ``blend_<mode>_bwd.py`` with ``backward(pairs,
prep, color, final_t, grad_color, cfg, cam)``, which returns the gradients
by the preprocess field they belong to. Both get the camera, so that a mode
that orders entries by the depth along each pixel's ray can rebuild that
order. A mode without its file raises ``NotImplementedError``; no mode
stands in for another, and a mode is added as its files alone.
"""

from __future__ import annotations

import importlib
import math
from typing import NamedTuple

import torch

from .loss import rgb_loss
from .pairs import build_pairs
from .preprocess import TILE, preprocess

LEAVES = ("means3d", "scales_log", "rotations", "opacity_logit", "sh_dc",
          "sh_rest")
BETAS, EPS = (0.9, 0.999), 1e-15


class Camera(NamedTuple):
    viewmatrix: torch.Tensor  # [4, 4] transposed world-to-view
    projmatrix: torch.Tensor  # [4, 4] transposed world-to-clip
    inverse_vp: torch.Tensor  # [4, 4]
    campos: torch.Tensor      # [3]
    tanfovx: float
    tanfovy: float


def _prep(scene, cam, cfg, lowp):
    """The preprocess of ``scene`` (autograd follows its tensors), in
    bfloat16 where ``lowp``, its outputs back in float32."""
    dt = torch.bfloat16 if lowp else torch.float32
    p = {k: scene[k].to(dt) for k in LEAVES}
    c = cam._replace(viewmatrix=cam.viewmatrix.to(dt),
                     projmatrix=cam.projmatrix.to(dt), campos=cam.campos.to(dt))
    rot = p["rotations"]
    prep = preprocess(
        p["means3d"], torch.exp(p["scales_log"]),
        rot / torch.linalg.norm(rot, dim=-1, keepdim=True),
        torch.sigmoid(p["opacity_logit"]),
        torch.cat([p["sh_dc"], p["sh_rest"]], dim=1), c,
        width=cfg["width"], height=cfg["height"], sh_degree=cfg["sh_degree"],
        tile=(TILE, TILE), rect_bounding=cfg["rect_bounding"],
        tight_opacity_bounding=cfg["tight_opacity_bounding"])
    return prep._replace(**{f: getattr(prep, f).float() for f in (
        "mean2d", "depth", "conic_opacity", "rgb", "cov3d_inv9",
        "opacity_power_threshold")})


def _detached(prep):
    return prep._replace(**{f: getattr(prep, f).detach() for f in (
        "mean2d", "conic_opacity", "rgb", "depth", "cov3d_inv9")})


def mode_module(cfg: dict, part: str = ""):
    """``blend_<mode><part>.py`` of the configuration's sort mode."""
    name = f"blend_{cfg['sort_mode'].lower()}{part}"
    try:
        return importlib.import_module(f"{__package__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.{name}":
            raise
        raise NotImplementedError(
            f"the reference has no {cfg['sort_mode']} "
            f"{'backward' if part else 'blend'}: reference/{name}.py") from None


def _blend(prep, cam, cfg, counts):
    w, h = cfg["width"], cfg["height"]
    pairs = build_pairs(prep, -(-w // TILE), -(-h // TILE))
    color, final_t = mode_module(cfg).blend(pairs, prep, cam, cfg, counts)
    if counts is not None:
        counts["pairs"] = counts.get("pairs", 0) + pairs.gauss_id.shape[0]
        counts["visible"] = counts.get("visible", 0) + int(prep.valid.sum())
        counts["frames"] = counts.get("frames", 0) + 1
    return pairs, color, final_t


def render(scene, cam, cfg, counts: dict | None = None, lowp: bool = False):
    """The frame [3, H, W] that ``cam`` sees."""
    with torch.no_grad():
        prep = _prep(scene, cam, cfg, lowp)
        return _blend(prep, cam, cfg, counts)[1]


def position_lr(step: int, sched) -> float:
    """The 3DGS position learning rate after ``step`` updates (log-lerp)."""
    t = min(max(step / sched["max_steps"], 0.0), 1.0)
    return math.exp(math.log(sched["init"]) * (1 - t)
                    + math.log(sched["final"]) * t)


def train_steps(scene, cams, targets, cfg, mix, lowp: bool = False,
                counts: dict | None = None):
    """``len(cams)`` training steps from ``scene`` (not changed),
    with Adam as the 3DGS trainer sets it up (``mix["lr"]``, the position
    schedule ``mix["position_lr"]``). Returns (losses [float], the first
    step's gradient of each leaf, the leaves after the last step)."""
    backward = mode_module(cfg, "_bwd").backward
    params = {k: scene[k].detach().clone().requires_grad_(True) for k in LEAVES}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(x) for k, x in params.items()}
    losses, first = [], None
    for step, (cam, target) in enumerate(zip(cams, targets)):
        prep = _prep(params, cam, cfg, lowp)
        flat = _detached(prep)
        pairs, color, final_t = _blend(flat, cam, cfg, counts)
        leaf = color.detach().requires_grad_(True)
        loss = rgb_loss(leaf, target, mix["lambda_dssim"])
        loss.backward()
        fields = backward(pairs, flat, color, final_t, leaf.grad, cfg, cam)
        torch.autograd.backward([getattr(prep, f) for f in fields],
                                list(fields.values()))
        grads = {k: p.grad.detach().clone() for k, p in params.items()}
        if lowp:
            grads = {k: g.to(torch.bfloat16).float() for k, g in grads.items()}
        if first is None:
            first = grads
        losses.append(float(loss.detach()))
        t = step + 1
        with torch.no_grad():
            for k, p in params.items():
                lr = (position_lr(step, mix["position_lr"]) if k == "means3d"
                      else mix["lr"][k])
                m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * grads[k]
                v[k] = BETAS[1] * v[k] + (1 - BETAS[1]) * grads[k] * grads[k]
                denom = (v[k].sqrt() / math.sqrt(1 - BETAS[1] ** t)) + EPS
                p -= (lr / (1 - BETAS[0] ** t)) * m[k] / denom
                p.grad = None
    return losses, first, {k: p.detach() for k, p in params.items()}
