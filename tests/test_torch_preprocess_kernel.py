"""Kernel K8's dispatch and interface, on the CPU.

K8 (``csrc/preprocess_fwd.cu``) runs only on the card, where
``chip_smoke.py`` (phase kernel_preprocess) holds it against the plain
preprocess field by field. Here: the rule that picks it
(``takes_kernel``), that CPU inputs take the plain path and open no
``stp/preprocess_kernel`` span, that the dispatch hands the kernel's wrapper
the call's arguments and opens the span, that the ctypes binding matches
the C interface, and that the library's name hashes the source.
"""

import ctypes
import re
import shutil
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stopthepop_tpu_torch.config import GlobalSortOrder
from stopthepop_tpu_torch.kernels import build
from stopthepop_tpu_torch.kernels import preprocess_fwd as k8
from stopthepop_tpu_torch.render import preprocess as pre
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

W, H = 40, 28
CASES = [(dev, grad, req, cov) for dev in ("cuda", "cpu")
         for grad in (True, False) for req in (True, False)
         for cov in (False, True)]


@pytest.mark.parametrize(
    "device,grad_mode,requires_grad,cov3d_precomp", CASES,
    ids=[f"{d}-grad{int(g)}-req{int(r)}-cov{int(c)}" for d, g, r, c in CASES])
def test_takes_kernel_rule(device, grad_mode, requires_grad, cov3d_precomp):
    means = torch.zeros(4, 3, requires_grad=requires_grad)
    cov = torch.zeros(4, 6) if cov3d_precomp else None
    with torch.set_grad_enabled(grad_mode):
        got = k8.takes_kernel(torch.device(device), (means, None), cov)
    want = (device == "cuda" and not cov3d_precomp
            and not (grad_mode and requires_grad))
    assert got == want


@pytest.mark.parametrize("cov3d_precomp", [False, True])
def test_takes_kernel_under_inference_mode_with_a_parameter(cov3d_precomp):
    # A model's means3d is an nn.Parameter with requires_grad set even
    # under inference_mode, which turns grad mode off: no gradient wanted.
    means = torch.nn.Parameter(torch.zeros(4, 3))
    cov = torch.zeros(4, 6) if cov3d_precomp else None
    with torch.inference_mode():
        assert k8.takes_kernel("cuda", (means,), cov) == (not cov3d_precomp)
        assert not k8.takes_kernel("cpu", (means,), cov)
    assert not k8.takes_kernel("cuda", (means,), cov)


def _call(scene, cam, **kw):
    return dict(scales=scene.scales, rotations=scene.rotations,
                shs=scene.shs, viewmatrix=cam.viewmatrix,
                projmatrix=cam.projmatrix, campos=cam.campos,
                tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, image_width=W,
                image_height=H, sh_degree=3, rect_bounding=True,
                tight_opacity_bounding=True, **kw)


def _span_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_cpu_inputs_take_the_plain_path_and_open_no_kernel_span(grad):
    scene = random_scene(2, 64, device="cpu")
    cam = make_camera(W, H, device="cpu")
    means = scene.means3d.clone().requires_grad_(grad)
    launches = k8.preprocess_fwd.launches
    with torch.set_grad_enabled(grad):
        out, names = _span_names(
            lambda: pre.preprocess(means, scene.opacities,
                                   **_call(scene, cam)))
    plain = pre.preprocess_plain(scene.means3d, scene.opacities,
                                 **_call(scene, cam))
    assert "stp/preprocess_kernel" not in names
    assert k8.preprocess_fwd.launches == launches
    for a, b in zip(out, plain):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize(
    "order,colors",
    [(GlobalSortOrder.Z_DEPTH, False), (GlobalSortOrder.DISTANCE, False),
     (GlobalSortOrder.Z_DEPTH, True)],
    ids=["z", "distance", "colors_precomp"])
def test_dispatch_hands_the_kernel_the_call(monkeypatch, order, colors):
    # Stand in for a CUDA device: the rule says yes and the wrapper is the
    # plain version driven by the arguments the dispatch passes it.
    seen = []

    def wrapper(means3d, opacities, *, distance_order, **kw):
        seen.append(distance_order)
        o = GlobalSortOrder.DISTANCE if distance_order else GlobalSortOrder.Z_DEPTH
        return list(pre.preprocess_plain(means3d, opacities, sort_order=o,
                                         **kw))

    monkeypatch.setattr(pre, "takes_kernel", lambda *a: True)
    monkeypatch.setattr(pre, "preprocess_fwd", wrapper)
    scene = random_scene(3, 64, device="cpu")
    cam = make_camera(W, H, device="cpu")
    kw = _call(scene, cam, sort_order=order, proper_ewa_scaling=True,
               scale_modifier=0.8, tile_x=32, tile_y=16)
    if colors:
        kw.update(shs=None, colors_precomp=scene.colors)
    out, names = _span_names(lambda: pre.preprocess(
        scene.means3d, scene.opacities, **kw))
    assert "stp/preprocess_kernel" in names
    assert seen == [order == GlobalSortOrder.DISTANCE]
    plain = pre.preprocess_plain(scene.means3d, scene.opacities, **kw)
    assert isinstance(out, pre.PreprocessOutput)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


def test_wrapper_refuses_cpu_tensors():
    scene = random_scene(4, 8, device="cpu")
    cam = make_camera(W, H, device="cpu")
    with pytest.raises(ValueError, match="no preprocess kernel"):
        k8.preprocess_fwd(
            scene.means3d, scene.opacities, colors_precomp=None,
            scale_modifier=1.0, distance_order=False,
            proper_ewa_scaling=False, tile_x=16, tile_y=16,
            **_call(scene, cam))


def test_binding_matches_the_c_interface():
    src = (build.CSRC / f"{k8.KERNEL}.cu").read_text()
    params = re.search(r'int stp_preprocess_fwd\(([^)]*)\)', src).group(1)
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctype.get(p.strip().rsplit(" ", 1)[0], ctypes.c_void_p)
            for p in params.split(",")]
    lib = types.SimpleNamespace(stp_preprocess_fwd=types.SimpleNamespace())
    assert k8.bind(lib).argtypes == want
    assert len(k8.FIELDS) == len(pre.PreprocessOutput._fields)
    assert [f[0] for f in k8.FIELDS] == list(pre.PreprocessOutput._fields)


def test_library_path_hashes_the_preprocess_source(tmp_path, monkeypatch):
    # Naming only: the build itself needs nvcc and runs on the GPU machine.
    path = build.library_path(k8.KERNEL)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("preprocess_fwd-") and path.suffix == ".so"
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in build.all_sources()}
    with open(csrc / "preprocess_fwd.cu", "a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n) for n in build.all_sources()}
    assert after.pop(k8.KERNEL) != before.pop(k8.KERNEL)
    assert after == before
