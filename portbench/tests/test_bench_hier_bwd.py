"""The reference's HIER backward (``reference/blend_hier_bwd.py``) against
the program's plain K6 and against autograd through the reference's own
cascade, a frozen HIER training step, and the cell ``bicycle-hier.train``
run whole at a tiny size on the CPU: sound, and with each of its driver's
faults planted."""

import json
from types import SimpleNamespace

import pytest
import torch
from conftest import BENCH, TINY, run_cell

from harness import manifest, scene
from reference import render as ref
from reference.blend_hier import blend_hier
from reference.blend_hier_bwd import blend_hier_backward
from reference.pairs import build_pairs

CELL = "bicycle-hier.train"


def _cfg():
    cfg = json.loads((BENCH / "configs" / "m360-bicycle-hier.json").read_text())
    cfg.update(TINY)
    return cfg


@pytest.fixture(scope="module")
def frame():
    """A tiny bicycle frame's detached preprocess, pairs, camera and a
    seeded colour cotangent."""
    cfg = _cfg()
    s = scene.make_scene(cfg, scene.generator(5, "cpu"), "cpu")
    cam = scene.reference_camera(scene.orbit_camera(0.7, cfg, 4.0, 0.5), "cpu")
    prep = ref._detached(ref._prep(s, cam, cfg, False))
    pairs = build_pairs(prep, -(-cfg["width"] // 16), -(-cfg["height"] // 16))
    g = torch.rand((3, cfg["height"], cfg["width"]),
                   generator=scene.generator(6, "cpu"))
    return cfg, prep, pairs, cam, g


def _ours(cfg, prep, pairs, cam, g):
    color, _ = blend_hier(pairs, prep, cam, cfg["width"], cfg["height"],
                          tuple(cfg["queues"]))
    return blend_hier_backward(pairs, prep, cam, color, g, cfg["width"],
                               cfg["height"], tuple(cfg["queues"]))


def _close(got, want):
    """Each of the nine columns within 1e-5 of the column's largest value.
    Both sides sum float32 terms in another order (K6 per warp, lane and
    pair, then the program per Gaussian; the reference per Gaussian in
    pixel order; autograd per operation), each Gaussian over at most some
    hundreds of terms: rounding of ~1e-6 of the column at worst, 2.4e-7
    seen."""
    scale = want.abs().amax(dim=0)
    gap = (got - want).abs().amax(dim=0)
    assert bool((scale > 0).all()) and bool((gap <= 1e-5 * scale).all()), (gap, scale)


def test_backward_matches_the_programs_plain_k6(frame):
    """The program's ``BlendHier`` on CPU tensors (its forward K5's plain
    version, its backward K6's, ``blend_hier_backward_plain``) over the
    reference's rows and pairs."""
    from stopthepop_tpu_torch.kernels.blend_vjp import BlendHier

    cfg, prep, pairs, cam, g = frame
    n, p = pairs.gauss_id.shape[0], prep.mean2d.shape[0]
    runs = torch.argsort(pairs.gauss_id, stable=True)
    orig_slot = torch.empty_like(runs)
    orig_slot[runs] = torch.arange(n)
    prog_pairs = SimpleNamespace(
        gauss_id=pairs.gauss_id.to(torch.int32),
        starts=pairs.starts.to(torch.int32), ends=pairs.ends.to(torch.int32),
        orig_slot=orig_slot, gauss_offsets=torch.cat([
            torch.zeros(1, dtype=torch.int64),
            torch.cumsum(torch.bincount(pairs.gauss_id, minlength=p), 0)]))
    rows = [prep.mean2d.clone().requires_grad_(True),
            prep.conic_opacity.clone().requires_grad_(True),
            prep.rgb.clone().requires_grad_(True)]
    color = BlendHier.apply(
        *rows, prep.cov3d_inv9, prep.opacity_power_threshold,
        cam.inverse_vp.contiguous(), cam.campos, prog_pairs,
        tuple(cfg["queues"]), False, -(-cfg["width"] // 16),
        -(-cfg["height"] // 16), cfg["width"], cfg["height"])[0]
    (color * g).sum().backward()
    _close(_ours(cfg, prep, pairs, cam, g), torch.cat([r.grad for r in rows], 1))


def test_backward_matches_autograd_through_the_cascade(frame):
    """The reference's cascade is differentiable torch in alpha and rgb:
    autograd through it is a second witness of the same gradients."""
    cfg, prep, pairs, cam, g = frame
    rows = {f: getattr(prep, f).clone().requires_grad_(True)
            for f in ("mean2d", "conic_opacity", "rgb")}
    color, _ = blend_hier(pairs, prep._replace(**rows), cam, cfg["width"],
                          cfg["height"], tuple(cfg["queues"]))
    (color * g).sum().backward()
    _close(_ours(cfg, prep, pairs, cam, g),
           torch.cat([r.grad for r in rows.values()], 1))


def test_frozen_training_steps():
    """Two HIER steps of the reference at the tiny size, as it gave them
    when the backward was written (seed 5 on the CPU, cameras at 0.3 and
    1.9 rad)."""
    cfg = _cfg()
    mix = json.loads((BENCH / "traffic" / "train-2check.json").read_text())
    g = scene.generator(5, "cpu")
    s = scene.make_scene(cfg, g, "cpu")
    targets = scene.make_targets(cfg, 2, g, "cpu")
    cams = [scene.reference_camera(scene.orbit_camera(a, cfg, 4.0, 0.5), "cpu")
            for a in (0.3, 1.9)]
    losses, first, final = ref.train_steps(s, cams, list(targets), cfg, mix)
    assert losses == pytest.approx([0.46898913383483887, 0.47232991456985474],
                                   rel=1e-5)
    assert float(first["means3d"].norm()) == pytest.approx(0.08730378746986389, rel=1e-3)
    assert float(first["sh_rest"].norm()) == pytest.approx(0.0063986824825406075, rel=1e-3)
    assert float((final["opacity_logit"] - s["opacity_logit"]).norm()) == pytest.approx(
        2.0323078632354736, rel=1e-3)
    assert float((final["means3d"] - s["means3d"]).norm()) == pytest.approx(
        0.022521933540701866, rel=1e-3)


@pytest.fixture
def cell_root(tiny_root):
    """The tiny root with the cell's mix taking no warm-up steps: they come
    after the compared steps, and each takes the program's plain K5 and K6
    some seconds on the CPU."""
    mix = manifest.cell(manifest.load(tiny_root), CELL)["traffic"]
    path = tiny_root / "portbench" / "traffic" / f"{mix}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), warmup_steps=0)))
    return tiny_root


def test_sound_run_is_correct(cell_root):
    rc, res = run_cell(cell_root, CELL)
    assert rc == 0 and res["correct"], res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "frozen_state"])
def test_planted_fault_is_caught(cell_root, fault):
    with manifest.driver("train", cell_root).FAULTS[fault]():
        rc, res = run_cell(cell_root, CELL)
    assert rc == 0 and res["correct"] is False, res
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in res["checks"].values())
