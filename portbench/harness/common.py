"""What the drivers share: the run's context, the program's settings and
the device's clock and memory."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Ctx:
    cell: dict
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                      # time.time() at process start
    marks: list = field(default_factory=list)   # (what set-up did, s since start)

    def rng(self):
        return np.random.default_rng(self.seed)

    def mark(self, what: str):
        """Note that set-up has done ``what`` (printed on standard error)."""
        self.marks.append((what, time.time() - self.t_start))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()


def since(t_start: float) -> float:
    return time.time() - t_start


def settings(cfg: dict):
    """The program's ExtendedSettings of the configuration."""
    from stopthepop_tpu_torch.config import (
        ExtendedSettings,
        GlobalSortOrder,
        SortMode,
    )

    ext = ExtendedSettings()
    ext.sort_settings.sort_mode = SortMode[cfg["sort_mode"]]
    ext.sort_settings.sort_order = GlobalSortOrder[cfg["sort_order"]]
    kt, km, kh = cfg["queues"]
    q = ext.sort_settings.queue_sizes
    q.tile_4x4, q.tile_2x2, q.per_pixel = kt, km, kh
    ext.culling_settings.rect_bounding = cfg["rect_bounding"]
    ext.culling_settings.tight_opacity_bounding = cfg["tight_opacity_bounding"]
    return ext


def tile_shape(cfg: dict):
    tile = tuple(cfg["tile"])
    return None if tile == (16, 16) else tile


def model(scene: dict):
    """The program's GaussianModel over the scene's tensors."""
    from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES, GaussianModel

    return GaussianModel(*(scene[k] for k in PARAM_NAMES))


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, -(-95 * len(s) // 100) - 1)]
