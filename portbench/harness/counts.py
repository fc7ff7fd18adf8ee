"""Operations and bytes the work of a frame or a step needs, and the peaks.

Counted from the inputs' shapes and from the events of the reference's own
pass (``reference/``), never from the program's counters, so that a count
stays the same whatever implements a kernel. Each count is of operations
the result cannot be had without: the operations per event are those of
the arithmetic that defines the event (the constants below, after
chip_smoke.py's), with exp, sqrt, compares and selects not counted, so the
least times are lower bounds. ``README.md`` gives the derivations.

What depends on the sort mode (the blend's events and its rows' bytes) is
in ``counts_<mode>.py`` (lower case), found by the configuration's
``sort_mode``: ``ROW_BYTES``, ``blend_ops(n, cfg)`` and
``blend_bwd_ops(n, cfg)``. A mode without its file raises
``NotImplementedError``.
"""

from __future__ import annotations

import importlib

# One NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W power limit):
# float32 outside the tensor cores, and HBM3.
PEAK_FP32_OPS_S = 67e12
PEAK_HBM_BYTES_S = 3.35e12

# Per (pixel, pair) alpha evaluation: dx, dy and the quadratic form (11);
# per blend: w = alpha T, three colour updates and the new T (9); the
# backward of a blend: the alpha gradient and the nine pair terms (36) and
# their sums (9).
OPS_PER_EVAL, OPS_PER_BLEND, OPS_PER_BLEND_BWD = 11, 9, 45
# Preprocess of one Gaussian, forward: view and clip transforms (46),
# pixel centre (6), 3D covariance (60), EWA 2D covariance (80), dilation,
# conic and extent (20), rect (12), SH colour of degree 3 (137), inverse
# covariance payload (51). Its backward: twice the forward.
OPS_PER_GAUSSIAN = 400
OPS_PER_GAUSSIAN_BWD = 800
# Pair expansion and key: the tile index and the packed key (4).
OPS_PER_PAIR = 4
# L1 + D-SSIM per pixel and channel: L1 (3); five Gaussian-filtered maps
# of two 11-tap passes (220); the SSIM map (20). Its backward: twice.
OPS_PER_LOSS_PX, OPS_PER_LOSS_PX_BWD = 243, 486
# Adam per value: two moments (6), bias corrections, sqrt, divide and the
# update (6).
OPS_PER_ADAM_VALUE = 12
# Bytes: a pair's id (4); a tile's range (8); per pixel written: colour,
# final T, count and depth (24); per pixel read by a backward: colour,
# final T, count and two cotangents (36); a pair's nine gradients written
# (36). A Gaussian's blend rows are its mode's ``ROW_BYTES``.
PAIR_BYTES, TILE_BYTES, PIXEL_OUT_BYTES = 4, 8, 24
PIXEL_BWD_BYTES, PAIR_GRAD_BYTES = 36, 36
PARAMS_PER_GAUSSIAN = 59  # 3 + 3 + 4 + 1 + 48 (SH degree 3)


def least_s(ops: float, nbytes: float) -> float:
    """The least time on one H100: the larger of the two bounds."""
    return max(ops / PEAK_FP32_OPS_S, nbytes / PEAK_HBM_BYTES_S)


def _tiles(cfg):
    return -(-cfg["width"] // 16) * -(-cfg["height"] // 16)


def _pixels(cfg):
    return cfg["width"] * cfg["height"]


def mode(cfg: dict):
    """``counts_<mode>.py`` of the configuration's sort mode."""
    name = f"counts_{cfg['sort_mode'].lower()}"
    try:
        return importlib.import_module(f"{__package__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.{name}":
            raise
        raise NotImplementedError(f"no counts of the {cfg['sort_mode']} blend: "
                                  f"harness/{name}.py") from None


def blend_ops(n: dict, cfg: dict) -> float:
    """Operations of one forward blend from the reference's event counts
    ``n`` of one frame."""
    return mode(cfg).blend_ops(n, cfg)


def blend_bwd_ops(n: dict, cfg: dict) -> float:
    return mode(cfg).blend_bwd_ops(n, cfg)


def blend_bytes(n: dict, cfg: dict) -> float:
    return (PAIR_BYTES * n["pairs"] + mode(cfg).ROW_BYTES * n["visible"]
            + TILE_BYTES * _tiles(cfg) + PIXEL_OUT_BYTES * _pixels(cfg))


def blend_bwd_bytes(n: dict, cfg: dict) -> float:
    return (PAIR_BYTES * n["pairs"] + mode(cfg).ROW_BYTES * n["visible"]
            + TILE_BYTES * _tiles(cfg) + PIXEL_BWD_BYTES * _pixels(cfg)
            + PAIR_GRAD_BYTES * n["pairs"])


def frame_ops(n: dict, cfg: dict) -> float:
    """A frame: preprocess of every Gaussian, the pairs, the blend."""
    return (OPS_PER_GAUSSIAN * cfg["gaussians"] + OPS_PER_PAIR * n["pairs"]
            + blend_ops(n, cfg))


def step_ops(n: dict, cfg: dict) -> float:
    """A training step: the frame, the loss and their backwards, Adam."""
    return (frame_ops(n, cfg) + OPS_PER_GAUSSIAN_BWD * cfg["gaussians"]
            + blend_bwd_ops(n, cfg)
            + 3 * _pixels(cfg) * (OPS_PER_LOSS_PX + OPS_PER_LOSS_PX_BWD)
            + OPS_PER_ADAM_VALUE * PARAMS_PER_GAUSSIAN * cfg["gaussians"])
