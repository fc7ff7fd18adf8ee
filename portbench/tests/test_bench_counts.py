"""The yardstick's counts against hand counts at tiny sizes, and the trace
reduction against a hand-made trace."""

import math

import pytest
import torch

from harness import counts, readers, trace
from reference.blend_global import blend_global
from reference.pairs import Pairs
from reference.preprocess import Prep


def _one_gaussian(width, height, cx, cy, sigma2, opacity):
    """A Prep of one isotropic Gaussian in every 16x16 tile, and the hand
    count of the pixels where it blends: power >= 0 and alpha >= 1/255."""
    tiles = -(-width // 16) * -(-height // 16)
    z = torch.zeros(1)
    prep = Prep(valid=torch.ones(1, dtype=torch.bool),
                mean2d=torch.tensor([[cx, cy]]), depth=z + 1.0,
                conic_opacity=torch.tensor([[1 / sigma2, 0.0, 1 / sigma2, opacity]]),
                rgb=torch.tensor([[0.2, 0.4, 0.6]]),
                rect_min=torch.zeros(1, 2, dtype=torch.int32),
                rect_max=torch.zeros(1, 2, dtype=torch.int32),
                tiles_touched=torch.tensor([tiles], dtype=torch.int32),
                cov3d_inv9=torch.zeros(1, 9), opacity_power_threshold=z)
    pairs = Pairs(torch.zeros(tiles, dtype=torch.int64),
                  torch.arange(tiles), torch.arange(tiles) + 1)
    r2 = 2 * sigma2 * math.log(opacity * 255.0)
    hand = sum(1 for y in range(height) for x in range(width)
               if (x - cx) ** 2 + (y - cy) ** 2 <= r2 * (1 - 1e-6))
    return prep, pairs, hand


def test_global_blend_counts_the_blends_by_hand():
    prep, pairs, hand = _one_gaussian(40, 24, 17.3, 11.6, 6.0, 0.8)
    n = {}
    color, final_t = blend_global(pairs, prep, 40, 24, n)
    assert n["blends"] == hand
    assert int((final_t < 1.0).sum()) == hand
    assert color.shape == (3, 24, 40)


def test_ops_and_bytes_by_hand():
    g = {"sort_mode": "GLOBAL", "width": 32, "height": 16, "gaussians": 10,
         "queues": [64, 8, 4]}
    n = {"blends": 100, "pairs": 7, "visible": 5}
    assert counts.blend_ops(n, g) == 20 * 100
    assert counts.blend_bytes(n, g) == 4 * 7 + 40 * 5 + 8 * 2 + 24 * 512
    assert counts.blend_bwd_ops(n, g) == 56 * 100
    assert counts.frame_ops(n, g) == 400 * 10 + 4 * 7 + 2000
    h = dict(g, sort_mode="HIER")
    m = {"tail_keys": 1, "tail_slots": 2, "evaluations": 3, "mid_inserts": 4,
         "head_inserts": 5, "commits": 6, "pairs": 7, "visible": 5}
    assert counts.blend_ops(m, h) == 24 + 2 + 35 * 3 + (24 + 40) * 4 + 16 * 5 + 60
    assert counts.blend_bwd_ops(m, h) == counts.blend_ops(m, h) + 35 * 6
    assert counts.step_ops(n, g) == (counts.frame_ops(n, g) + 800 * 10 + 5600
                                     + 3 * 512 * (243 + 486) + 12 * 59 * 10)
    assert counts.least_s(67e12, 0.0) == pytest.approx(1.0)
    assert counts.least_s(0.0, 3.35e12) == pytest.approx(1.0)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction_by_hand():
    events = [
        _ev("user_annotation", "frame", 0, 100), _ev("user_annotation", "frame", 100, 100),
        _ev("cpu_op", "aten::add", 0, 30), _ev("cpu_op", "aten::item", 40, 50),
        _ev("kernel", "hier_blend_fwd_kernel<8, 4>", 10, 30),
        _ev("kernel", "add_kernel", 30, 20),       # overlaps: busy is the union
        _ev("gpu_memcpy", "Memcpy DtoH", 60, 5),
        _ev("kernel", "hier_blend_fwd_kernel<8, 4>", 120, 40),
    ]
    s = trace.summarize(events, 200e-6, 2, "frame")
    assert s["launches"] == 3
    assert s["busy_s"] == pytest.approx((40 + 5 + 40) * 1e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["frame: aten::add"] == pytest.approx(10e-6)      # 0-10
    assert gaps["frame: aten::item"] == pytest.approx(10e-6)     # 50-60
    assert gaps["frame: no op"] == pytest.approx(55e-6)           # 65-120
    run = {"trace": s, "config": {"sort_mode": "GLOBAL", "width": 16, "height": 16,
                                  "gaussians": 1},
           "counts": {"blends": 1000, "pairs": 1, "visible": 1}, "frame_ms": 2.0}
    assert readers.kernel_ms(run, readers.FWD_BLEND) == pytest.approx(0.035)
    assert readers.launches(run) == 1.5
    assert readers.idle(run) == pytest.approx(100 * (1 - 85 / 200))
    least = max(20 * 1000 / 67e12, (4 + 40 + 8 + 24 * 256) / 3.35e12)
    assert readers.roofline(run, readers.FWD_BLEND, counts.blend_ops,
                            counts.blend_bytes) == pytest.approx(100 * least / 35e-6)
    assert readers.mfu(run, counts.frame_ops, "frame_ms") == pytest.approx(
        100 * (400 + 4 + 20000) / 2e-3 / 67e12)
    assert readers.kernel_ms({"trace": s}, readers.BWD_BLEND) is None
    assert readers.roofline({"trace": s}, readers.FWD_BLEND, counts.blend_ops,
                            counts.blend_bytes) is None
