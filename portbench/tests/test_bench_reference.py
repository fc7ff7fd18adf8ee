"""The plain reference against a frozen small case, and against the
program's own plain versions on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, ROOT, TINY

from harness import scene
from reference.render import render, train_steps


def _cfg(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(TINY)
    return cfg


# Seed 5 on the CPU, camera at 0.7 rad (radius 4, height 0.5), 70x45:
# (image sum, three pixels, event counts), as the reference gave them when
# the benchmark was written.
FROZEN = {
    "m360-bicycle-hier": (2671.3779296875, (0.32180824875831604, 0.453984797000885,
                                            0.28837335109710693),
                          {"tail_keys": 63536, "tail_slots": 174080,
                           "evaluations": 960830, "mid_inserts": 244613,
                           "head_inserts": 960830, "commits": 25791,
                           "pairs": 3971, "visible": 2835}),
    "tandt-truck-global": (2671.0068359375, (0.3218189775943756, 0.453984797000885,
                                             0.2887178361415863),
                           {"blends": 25791, "pairs": 3971, "visible": 2835}),
}
PIXELS = ((0, 22, 35), (1, 10, 20), (2, 30, 50))


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_frozen_frame(name):
    cfg = _cfg(name)
    s = scene.make_scene(cfg, scene.generator(5, "cpu"), "cpu")
    cam = scene.reference_camera(scene.orbit_camera(0.7, cfg, 4.0, 0.5), "cpu")
    n = {}
    img = render(s, cam, cfg, n)
    total, pixels, events = FROZEN[name]
    assert float(img.sum()) == pytest.approx(total, rel=1e-5)
    for (c, y, x), v in zip(PIXELS, pixels):
        assert float(img[c, y, x]) == pytest.approx(v, abs=1e-5)
    assert {k: n[k] for k in events} == events


def test_frozen_training_steps():
    cfg = _cfg("tandt-truck-global")
    mix = json.loads((BENCH / "traffic" / "train.json").read_text())
    g = scene.generator(5, "cpu")
    s = scene.make_scene(cfg, g, "cpu")
    targets = scene.make_targets(cfg, 2, g, "cpu")
    cams = [scene.reference_camera(scene.orbit_camera(a, cfg, 4.0, 0.5), "cpu")
            for a in (0.3, 1.9)]
    losses, first, final = train_steps(s, cams, list(targets), cfg, mix)
    assert losses == pytest.approx([0.4688229560852051, 0.4721958637237549], rel=1e-5)
    assert float(first["means3d"].norm()) == pytest.approx(0.08701492846012115, rel=1e-3)
    assert float(first["sh_rest"].norm()) == pytest.approx(0.006405842024832964, rel=1e-3)
    assert float((final["opacity_logit"] - s["opacity_logit"]).norm()) == pytest.approx(
        2.0291736125946045, rel=1e-3)
    assert float((final["means3d"] - s["means3d"]).norm()) == pytest.approx(
        0.02249489724636078, rel=1e-3)


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_reference_matches_the_programs_plain_path(name):
    """The program on the CPU (its kernels' plain versions) renders the
    reference's frame to 1e-6."""
    from harness import common

    from stopthepop_tpu_torch.render.cli import render_frames

    cfg = _cfg(name)
    s = scene.make_scene(cfg, scene.generator(9, "cpu"), "cpu")
    cam = scene.orbit_camera(2.1, cfg, 4.0, 0.5)
    want = render(s, scene.reference_camera(cam, "cpu"), cfg)
    got = render_frames(common.model(s), [scene.program_camera(cam)],
                        common.settings(cfg), "cpu",
                        tile_shape=common.tile_shape(cfg))[0].color
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


def test_a_mode_without_its_files_is_refused():
    """No sort mode stands in for another: the reference's blend, its
    backward and the counts are found by the mode's name or refused. The
    mode planted here is one that no file will ever serve."""
    from harness import counts
    from reference.render import mode_module

    mode = "NO_SUCH_MODE"
    cfg = dict(_cfg("tandt-truck-global"), sort_mode=mode)
    s = scene.make_scene(cfg, scene.generator(5, "cpu"), "cpu")
    cam = scene.reference_camera(scene.orbit_camera(0.7, cfg, 4.0, 0.5), "cpu")
    name = f"blend_{mode.lower()}"
    with pytest.raises(NotImplementedError, match=f"reference/{name}.py"):
        render(s, cam, cfg)
    with pytest.raises(NotImplementedError, match=f"reference/{name}_bwd.py"):
        train_steps(s, [cam], [torch.zeros(3, cfg["height"], cfg["width"])], cfg,
                    json.loads((BENCH / "traffic" / "train.json").read_text()))
    with pytest.raises(NotImplementedError, match=f"counts_{mode.lower()}.py"):
        counts.blend_ops({}, cfg)
    assert mode_module(dict(cfg, sort_mode="HIER")).__name__ == "reference.blend_hier"


def test_every_configuration_finds_its_modes_files():
    """Each configuration of BENCHMARK.json finds its sort mode's reference
    blend and counts; one that a training cell uses, the blend's backward
    too."""
    from harness import counts, manifest
    from reference.render import mode_module

    bench = manifest.load()
    trained = {w["config"] for w in bench["workloads"]
               if manifest.traffic(w["traffic"])["kind"] == "train"}
    for c in bench["configs"]:
        cfg = manifest.config(bench, c["name"])
        mode = cfg["sort_mode"].lower()
        assert mode_module(cfg).__name__ == f"reference.blend_{mode}"
        assert counts.mode(cfg).__name__ == f"harness.counts_{mode}"
        if c["name"] in trained:
            assert mode_module(cfg, "_bwd").__name__ == f"reference.blend_{mode}_bwd"


STUB_BLEND = '''"""A stub of a sort mode's reference blend."""


def blend(pairs, prep, cam, cfg, counts=None):
    raise NotImplementedError("a stub")
'''
STUB_COUNTS = '''"""A stub of a sort mode's counts."""

ROW_BYTES = 40


def blend_ops(n, cfg):
    return 0.0


def blend_bwd_ops(n, cfg):
    return 0.0
'''


def test_a_mode_added_as_files_breaks_no_test(tmp_path):
    """A sort mode is added as files alone: in a copy of the root with a
    stub PPX_FULL reference blend and counts and a PPX_FULL configuration
    (new files and a new entry, no file that is there edited), every other
    test of portbench/tests still passes."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "stopthepop_tpu_torch").symlink_to(ROOT / "stopthepop_tpu_torch")
    (tmp_path / "portbench/reference/blend_ppx_full.py").write_text(STUB_BLEND)
    (tmp_path / "portbench/harness/counts_ppx_full.py").write_text(STUB_COUNTS)
    cfg = json.loads((BENCH / "configs/m360-bicycle-hier.json").read_text())
    cfg.update(name="added-full", sort_mode="PPX_FULL")
    (tmp_path / "portbench/configs/added-full.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "added-full", "source": "x",
                             "file": "portbench/configs/added-full.json",
                             "reduced": [], "why": "added"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "portbench/tests", "-q",
         "-p", "no:cacheprovider", "-p", "xdist", "-n", "2",
         "-k", "not test_a_mode_added_as_files_breaks_no_test"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=1200,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-4000:]
