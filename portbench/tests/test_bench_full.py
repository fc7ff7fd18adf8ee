"""PER_PIXEL_FULL in the benchmark (``db-playroom-full``): the reference
against a frozen small case, hand counts and the program's plain paths;
the counts of ``harness/counts_ppx_full.py``; the ``full_passes_per_tile``
reader; whole runs of ``playroom-full.view`` at a tiny size on the CPU.

``test_bench_reference.py::test_a_mode_added_as_files_breaks_no_test``
runs this file again in a copy of the root where PPX_FULL's reference
blend and counts are stubs; the tests of those two files skip there
(``full_files``)."""

import json

import pytest
import torch
from conftest import BENCH, TINY, run_cell
from test_bench_control import _control
from test_bench_counts import _one_gaussian

from harness import counts, manifest, scene
from reference.render import render

CONFIG, CELL = "db-playroom-full", "playroom-full.view"
# Seed 5 on the CPU, camera at 0.7 rad (radius 4, height 0.5), 70x45:
# (image sum, three pixels, event counts), as the reference gave them when
# the configuration was added.
FROZEN = (2670.947509765625, (0.3218082785606384, 0.453984797000885,
                              0.28837335109710693),
          {"evaluations": 960830, "actives": 25791, "commits": 25791,
           "pairs": 3971, "visible": 2835})
PIXELS = ((0, 22, 35), (1, 10, 20), (2, 30, 50))


@pytest.fixture
def full_files():
    from harness import counts_ppx_full
    from reference import blend_ppx_full as ref

    if not (hasattr(ref, "blend_ppx_full") and hasattr(counts_ppx_full, "OPS_PER_EVAL")):
        pytest.skip("PPX_FULL's reference blend and counts are stubs in this copy")


def _cfg():
    cfg = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    cfg.update(TINY)
    return cfg


def test_frozen_frame(full_files):
    cfg = _cfg()
    s = scene.make_scene(cfg, scene.generator(5, "cpu"), "cpu")
    cam = scene.reference_camera(scene.orbit_camera(0.7, cfg, 4.0, 0.5), "cpu")
    n = {}
    img = render(s, cam, cfg, n)
    total, pixels, events = FROZEN
    assert float(img.sum()) == pytest.approx(total, rel=1e-5)
    for (c, y, x), v in zip(PIXELS, pixels):
        assert float(img[c, y, x]) == pytest.approx(v, abs=1e-5)
    assert {k: n[k] for k in events} == events


@pytest.mark.parametrize("naive_max", [1 << 26, 0], ids=["auto", "k7-plain"])
def test_reference_matches_the_programs_plain_path(full_files, monkeypatch,
                                                   naive_max):
    """Through ``render_frames`` on the CPU, the program renders the
    reference's frame to 1e-6, by either backend its ``full_mode="auto"``
    takes there: the dense oracle at this size, and K7's plain version
    above the oracle's limit (lowered to 0 here)."""
    from harness import common

    from stopthepop_tpu_torch.render import rasterize
    from stopthepop_tpu_torch.render.cli import render_frames

    monkeypatch.setattr(rasterize, "FULL_NAIVE_MAX", naive_max)
    cfg = _cfg()
    s = scene.make_scene(cfg, scene.generator(9, "cpu"), "cpu")
    cam = scene.orbit_camera(2.1, cfg, 4.0, 0.5)
    want = render(s, scene.reference_camera(cam, "cpu"), cfg)
    got = render_frames(common.model(s), [scene.program_camera(cam)],
                        common.settings(cfg), "cpu",
                        tile_shape=common.tile_shape(cfg))[0].color
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


def test_reference_counts_by_hand(full_files):
    """One Gaussian in every tile, with zero inverse covariance: every ray
    depth is 0, so it is active and commits wherever its alpha passes."""
    w, h = 40, 24
    cfg = dict(_cfg(), width=w, height=h)
    cam = scene.reference_camera(scene.orbit_camera(0.0, cfg, 4.0, 0.5), "cpu")
    from reference.blend_ppx_full import blend_ppx_full

    prep, pairs, hand = _one_gaussian(w, h, 17.3, 11.6, 6.0, 0.8)
    n = {}
    color, final_t = blend_ppx_full(pairs, prep, cam, w, h, n)
    assert n == {"evaluations": w * h, "actives": hand, "commits": hand}
    assert int((final_t < 1.0).sum()) == hand
    assert color.shape == (3, h, w)


def test_counts_by_hand(full_files):
    cfg = {"sort_mode": "PPX_FULL", "width": 32, "height": 16, "gaussians": 10,
           "queues": [64, 8, 4]}
    n = {"evaluations": 1000, "actives": 100, "commits": 40, "pairs": 7,
         "visible": 5}
    assert counts.blend_ops(n, cfg) == 11 * 1000 + 24 * 100 + 10 * 40
    assert counts.blend_bytes(n, cfg) == 4 * 7 + 72 * 5 + 8 * 2 + 24 * 512
    assert counts.frame_ops(n, cfg) == 400 * 10 + 4 * 7 + 13800
    with pytest.raises(NotImplementedError, match="forward only"):
        counts.blend_bwd_ops(n, cfg)
    with pytest.raises(NotImplementedError, match="forward only"):
        counts.step_ops(n, cfg)


def test_pass_reader_without_a_counter(monkeypatch):
    from stopthepop_tpu_torch.kernels import full_blend

    read = manifest.reader("full_passes_per_tile")
    monkeypatch.setattr(full_blend, "pass_counts", lambda: (0, 0))
    assert read({}) is None
    monkeypatch.delattr(full_blend, "pass_counts")
    assert read({}) is None


def test_pass_reader_after_a_cpu_render(monkeypatch):
    """After a frame through K7's plain version on the CPU, the reader
    gives the program's passes over its tiles."""
    from harness import common

    from stopthepop_tpu_torch.kernels import full_blend
    from stopthepop_tpu_torch.render import rasterize
    from stopthepop_tpu_torch.render.cli import render_frames

    monkeypatch.setattr(rasterize, "FULL_NAIVE_MAX", 0)
    cfg = _cfg()
    s = scene.make_scene(cfg, scene.generator(3, "cpu"), "cpu")
    passes0, tiles0 = full_blend.pass_counts()
    render_frames(common.model(s), [scene.program_camera(
        scene.orbit_camera(0.4, cfg, 4.0, 0.5))], common.settings(cfg), "cpu")
    passes, tiles = full_blend.pass_counts()
    assert tiles - tiles0 == -(-cfg["width"] // 16) * -(-cfg["height"] // 16)
    assert passes - passes0 >= tiles - tiles0
    value = manifest.reader("full_passes_per_tile")({})
    assert value == passes / tiles >= 1.0


def test_sound_run_is_correct(full_files, tiny_root):
    rc, res = run_cell(tiny_root, CELL)
    assert rc == 0 and res["correct"], res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95", "peak_mem_gib",
                                   "setup_s"}


def test_planted_fault_is_caught(full_files, tiny_root):
    bench = manifest.load(tiny_root)
    kind = manifest.traffic(manifest.cell(bench, CELL)["traffic"], tiny_root)["kind"]
    with manifest.driver(kind, tiny_root).FAULTS["altered_frame"]():
        rc, res = run_cell(tiny_root, CELL)
    assert rc == 0 and res["correct"] is False, res
    assert res["checks"]["frame_mse"]["value"] > res["checks"]["frame_mse"]["limit"]


def test_control_fails_at_a_tiny_size(full_files, tiny_root):
    assert _control(tiny_root, CELL, 41, torch.device("cpu"))
