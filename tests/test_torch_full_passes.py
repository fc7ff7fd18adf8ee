"""Kernel K7's pass counter (``kernels/full_blend.py::pass_counts``): the
plain version's count against a count made by hand from each pixel's
sorted actives, the wrapper's sums over launches, outputs unchanged by the
count, the probe's binding of K7 builds with and without the counter,
and, on the card, K7's device counter against the plain count.

The rule (the module's notes): a pixel that saturates at its k-th active
needs ceil(k / WINDOW) passes, one whose A actives run out A // WINDOW + 1,
and a tile takes as many as its slowest pixel on the image.

This file imports no JAX, so that its card case runs where JAX is absent
(``python -m pytest --noconftest tests/test_torch_full_passes.py -m card``).
"""

import math
import types

import numpy as np
import pytest
import torch

from stopthepop_tpu_torch.constants import T_THRESHOLD
from stopthepop_tpu_torch.kernels import full_blend
from stopthepop_tpu_torch.kernels.full_blend import (
    blend_full_forward,
    blend_full_forward_plain,
    pass_counts,
)
from stopthepop_tpu_torch.render.duplicate import build_pairs
from stopthepop_tpu_torch.render.pipeline import tile_grid
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.utils.testing import (
    clone_trap_scene,
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _deep_scene():
    """2,000 faint Gaussians (opacity 0.09-0.43): about half the pixels
    saturate after 79-180 commits, the rest run out of actives."""
    s = random_scene(3, 2000, scale_range=(0.1, 0.3), device="cpu")
    return s._replace(opacities=s.opacities * 0.45)


SCENES = {"trap": (lambda: clone_trap_scene("cpu"), 32, 32),
          "deep": (_deep_scene, 48, 40)}


def _frame(name, device="cpu"):
    """K7's inputs (args, keywords) of one of ``SCENES``."""
    make, w, h = SCENES[name]
    scene = make()
    cam = make_camera(w, h, device="cpu")
    with torch.no_grad():
        prep = preprocess(
            scene.means3d, scene.opacities, scales=scene.scales,
            rotations=scene.rotations, shs=scene.shs,
            viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
            campos=cam.campos, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
            image_width=w, image_height=h, sh_degree=3)
        gx, gy = tile_grid(w, h)
        pairs = build_pairs(prep, grid_x=gx, grid_y=gy)
    args = tuple(x.contiguous().to(device) for x in (
        pairs.gauss_id, pairs.starts, pairs.ends, prep.mean2d,
        prep.conic_opacity, prep.rgb, prep.cov3d_inv9,
        cam.inv_viewprojmatrix, cam.campos))
    return args, dict(grid_x=gx, grid_y=gy, width=w, height=h)


def _passes_by_hand(args, kw):
    """Each tile's passes by the rule, from every on-image pixel's actives
    sorted by (ray depth, stream position) and walked in float32; and the
    k of each pixel that saturates at its k-th active."""
    point_list, starts, ends, xy, co, _, inv9, inverse_vp, campos = args
    gx, gy, w, h = kw["grid_x"], kw["grid_y"], kw["width"], kw["height"]
    counts = (ends - starts).to(torch.int64)
    pix_x, pix_y, vd = full_blend._view_rays(gx, gy, w, h, inverse_vp,
                                             campos, "cpu")
    inside = torch.ones((gx * gy, 256), dtype=torch.bool)
    _, _, alpha, depth, active = full_blend._chunk_tables(
        point_list, starts, counts, xy, co, inv9, pix_x, pix_y, vd, inside,
        int(counts.max()))
    K = full_blend.WINDOW
    tiles, saturated_at = [], []
    for t in range(gx * gy):
        most = 0
        for p in range(256):
            x, y = (t % gx) * 16 + p % 16, (t // gx) * 16 + p // 16
            if x >= w or y >= h:
                continue
            live = active[t, p].nonzero().flatten().tolist()
            order = sorted(live, key=lambda s: (float(depth[t, p, s]) + 0.0, s))
            S, need = np.float32(0.0), len(order) // K + 1
            for k, s in enumerate(order, start=1):
                S = np.float32(S + np.log1p(-np.float32(alpha[t, p, s])))
                if np.exp(S) < T_THRESHOLD:
                    need = math.ceil(k / K)
                    saturated_at.append(k)
                    break
            most = max(most, need)
        tiles.append(most)
    return tiles, saturated_at


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_pass_count_matches_the_count_by_hand(name):
    args, kw = _frame(name)
    n = blend_full_forward_plain(*args, **kw, count_evaluations=True)[4]
    hand, saturated_at = _passes_by_hand(args, kw)
    assert n["passes"] == sum(hand)
    assert n["rounds"]["max"] == max(hand)
    assert n["rounds"]["mean"] == pytest.approx(sum(hand) / len(hand))
    # Tiles of more than two passes, pixels that saturate and pixels whose
    # actives run out; in the deep scene pixels saturate after a first list.
    assert max(hand) > 2 and saturated_at
    assert len(saturated_at) < kw["width"] * kw["height"]
    if name == "deep":
        assert max(saturated_at) > 2 * full_blend.WINDOW


def test_wrapper_sums_passes_and_tiles_over_launches():
    args, kw = _frame("trap")
    n = blend_full_forward_plain(*args, **kw, count_evaluations=True)[4]
    passes0, tiles0 = pass_counts()
    for _ in range(2):
        blend_full_forward(*args, **kw)
    passes1, tiles1 = pass_counts()
    assert passes1 - passes0 == 2 * n["passes"]
    assert tiles1 - tiles0 == 2 * kw["grid_x"] * kw["grid_y"]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_counting_leaves_the_outputs_unchanged(name):
    """The wrapper counts on the CPU through the plain version's counts;
    its outputs are the plain version's bits without them."""
    args, kw = _frame(name)
    want = blend_full_forward_plain(*args, **kw)
    counted = blend_full_forward_plain(*args, **kw, count_evaluations=True)
    got = blend_full_forward(*args, **kw)
    assert len(got) == len(want) == 4
    for g, c, w in zip(got, counted[:4], want):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(c, w)


@pytest.mark.parametrize("counter", [True, False])
def test_probe_binds_builds_with_and_without_the_counter(counter):
    """``hier_probe``'s ``full`` family types a K7 build from before the
    pass counter without it and calls it with every other argument of the
    checkout's call; the checkout's build gets them all."""
    from stopthepop_tpu_torch.kernels import hier_probe

    calls = []

    class Entry:
        def __call__(self, *args):
            calls.append(args)
            return 0

    lib = types.SimpleNamespace(stp_full_blend_fwd=Entry(),
                                _stp_no_passes=not counter)
    saved = full_blend._bind
    try:
        hier_probe._Full.bind(None, {"full_blend_fwd": lib})
        fn = full_blend._bind()
    finally:
        full_blend._bind = saved
    args = tuple(range(20))  # ..., out_depth, passes, stream
    assert fn(*args) == 0
    want = args if counter else args[:18] + args[19:]
    assert calls == [want]
    assert len(lib.stp_full_blend_fwd.argtypes) == len(want)


@pytest.mark.card
def test_k7_counter_equals_the_plain_count_at_1080p(card):
    """On a seeded 1080p frame of 500K Gaussians (the bench frame), K7's
    device counter adds what the plain version counts, and its outputs are
    the plain version's bits."""
    from stopthepop_tpu_torch.kernels.hier_probe import _bench_frame

    args, kw, _ = _bench_frame(torch.device("cuda"))
    args = args[:7] + args[8:]
    with torch.no_grad():
        *want, n = blend_full_forward_plain(*args, **kw,
                                            count_evaluations=True)
        passes0, tiles0 = pass_counts()
        got = blend_full_forward(*args, **kw)
        passes1, tiles1 = pass_counts()
    assert tiles1 - tiles0 == kw["grid_x"] * kw["grid_y"]
    assert passes1 - passes0 == n["passes"] > tiles1 - tiles0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
