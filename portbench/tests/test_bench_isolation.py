"""What the benchmark may load and where it may run."""

import os
import subprocess
import sys

from conftest import BENCH, ROOT, copy_root

from harness import runner


def test_forbidden_names_are_compared_whole():
    ok = ["jaxtyping", "stopthepop_tpu_torch", "stopthepop_tpu_torch.render",
          "flaxen", "torch"]
    assert runner.forbidden_modules(ok) == []
    assert runner.forbidden_modules(ok + ["stopthepop_tpu.render"]) == ["stopthepop_tpu"]
    assert runner.forbidden_modules(ok + ["jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib"]


def _python(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import json, torch\n"
        "from harness import scene\n"
        "from reference.render import render, train_steps\n"
        "cfg = json.load(open(%r)); cfg.update(gaussians=500, width=40, height=24)\n"
        "s = scene.make_scene(cfg, scene.generator(1, 'cpu'), 'cpu')\n"
        "cam = scene.reference_camera(scene.orbit_camera(0.1, cfg, 4.0, 0.5), 'cpu')\n"
        "render(s, cam, cfg)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'stopthepop_tpu_torch', 'stopthepop_tpu', 'jax', 'jaxlib', 'flax'}))\n"
    ) % (str(BENCH), str(BENCH / "configs" / "m360-bicycle-hier.json"))
    out = _python(code, cwd=str(BENCH))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    copy_root(tmp_path)
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from harness import runner\n"
        "from pathlib import Path\n"
        "rc = runner.main(['--workload', 'truck-global.view', '--seed', '7',"
        " '--seconds', '0.2'], time.time(), root=Path(%r), device='cpu')\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print('RC', rc, sorted(top & set(runner.FORBIDDEN)), 'stopthepop_tpu_torch' in top)\n"
    ) % (str(BENCH), str(ROOT), str(tmp_path))
    out = _python(code, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "RC 0 [] True"


def test_run_without_a_card_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "truck-global.view",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_without_the_program_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the
    run cannot import the program and prints no result."""
    copy_root(tmp_path)
    code = (
        "import sys, time; sys.path[:0] = [%r]\n"
        "from pathlib import Path\n"
        "from harness import runner\n"
        "sys.exit(runner.main(['--workload', 'truck-global.view', '--seed', '7',"
        " '--seconds', '0.2'], time.time(), root=Path(%r), device='cpu'))\n"
    ) % (str(tmp_path / "portbench"), str(tmp_path))
    out = _python(code, cwd=str(tmp_path))
    assert out.returncode != 0
    assert "stopthepop_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""
