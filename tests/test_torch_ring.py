"""The port's ring-streamed Gaussian shards (parallel/ring.py) on the CPU, in
4 Gloo processes, against the JAX package's.

One group of 4 processes (``utils/testing.py::run_ranks``) runs every case
once; the JAX references come from this process, on the first 4 of the
conftest's virtual CPU devices, in interpret mode, as tests/test_ring.py
computes them (SIZE 128, 256 Gaussians from PRNGKey(0), camera at
(0, 0, -4), background (0.1, 0.2, 0.3), per_step_capacity 1024):

- ``make_ring_render`` against JAX's in GLOBAL with Z_DEPTH and PTD_CENTER
  and in PPX_KBUFFER (PTD_MAX, k = 4, the quality configuration of
  test_ring.py's resort test): atol = rtol = 1e-5 (test_ring.py:87-88),
  no overflow, every rank holding the whole image;
- the collective-free core, ``ring_step`` fed the 4 shards in ring order
  for each band and ``ring_blend``, stitched in one process, equals the
  4-process render to the bit;
- ``overflow`` reported on every rank with ``per_step_capacity=8``;
- one step of ``make_ring_train_step`` in GLOBAL and PPX_KBUFFER: its loss
  against the port's single-device loss (and, in GLOBAL, JAX's) at
  atol = rtol = 2e-5 (test_ring.py:154), its gradients of the 6 parameter
  tensors against the port's single-device autograd gradients at 1e-4 of
  each tensor's largest value (the ring sums the bands and steps in
  another order than one segment_reduce);
- PPX_FULL and tile-based culling raise NotImplementedError, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from stopthepop_tpu.config import ExtendedSettings as JExt
from stopthepop_tpu.config import GaussianRasterizationSettings as JSettings
from stopthepop_tpu.config import GlobalSortOrder as JOrder
from stopthepop_tpu.config import SortMode as JSortMode
from stopthepop_tpu.models.gaussians import init_random as jax_init_random
from stopthepop_tpu.parallel.ring import make_ring_render as jax_ring_render
from stopthepop_tpu.parallel.spatial import shard_model as jax_shard_model
from stopthepop_tpu.train.loss import rgb_loss as jax_rgb_loss
from stopthepop_tpu.train.trainer import CameraArrays as JCams
from stopthepop_tpu.train.trainer import render_model as jax_render_model
from stopthepop_tpu.utils.testing import make_camera as jax_make_camera

from stopthepop_tpu_torch.config import (
    ExtendedSettings,
    GaussianRasterizationSettings,
    GlobalSortOrder,
    SortMode,
)
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES, from_numpy_params
from stopthepop_tpu_torch.parallel.ring import ring_step
from stopthepop_tpu_torch.parallel.spatial import (
    _preprocess_features,
    _with_camera,
    plan_bands,
)
from stopthepop_tpu_torch.render.cli import render_model
from stopthepop_tpu_torch.train.loss import rgb_loss
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    run_ranks,
)

one_thread_under_xdist()

WORLD = 4
SIZE = 128
P = 256
BG = (0.1, 0.2, 0.3)
CAPACITY = 1024
# (case, sort mode, stream order); PPX_KBUFFER with a window of 4.
RENDERS = (("z_depth", "GLOBAL", "Z_DEPTH"),
           ("ptd_center", "GLOBAL", "PTD_CENTER"),
           ("kbuffer", "PPX_KBUFFER", "PTD_MAX"))
STEPS = (("global", "GLOBAL", "Z_DEPTH"), ("kbuffer", "PPX_KBUFFER", "Z_DEPTH"))

_BODY = r"""
from stopthepop_tpu_torch.config import ExtendedSettings, GaussianRasterizationSettings, GlobalSortOrder, SortMode
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES, from_numpy_params, row_block
from stopthepop_tpu_torch.parallel import ring, spatial
from stopthepop_tpu_torch.train.trainer import make_optimizer
from stopthepop_tpu_torch.utils.testing import make_camera

inp = np.load(f"{workdir}/inputs.npz")
SIZE, CAPACITY = int(inp["size"]), int(inp["capacity"])
out = {}
mesh = hosts.global_mesh(("shards",))
model = from_numpy_params({k: inp[k] for k in PARAM_NAMES}, device="cpu")
cam = make_camera(SIZE, SIZE, campos=(0.0, 0.0, -4.0), device="cpu")
cams = CameraArrays(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                    cam.campos)


def static(mode, order):
    ext = ExtendedSettings()
    ext.sort_settings.sort_mode = SortMode[mode]
    ext.sort_settings.sort_order = GlobalSortOrder[order]
    ext.sort_settings.queue_sizes.per_pixel = 4
    return GaussianRasterizationSettings(
        image_height=SIZE, image_width=SIZE, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=torch.tensor(inp["bg"]), scale_modifier=1.0,
        viewmatrix=None, projmatrix=None, inv_viewprojmatrix=None,
        sh_degree=3, campos=None, prefiltered=False, settings=ext)


shard = spatial.shard_model(model, mesh, "shards")
for case, mode, order in RENDERS:
    st = static(mode, order)
    render, cfg = ring.make_ring_render(mesh, static=st,
                                        per_step_capacity=CAPACITY)
    img, overflow = render(shard, cams)
    out[f"img_{case}"], out[f"overflow_{case}"] = img.numpy(), np.array(overflow)
    if rank == 0:
        rs = spatial._with_camera(st, cams, "cpu")
        with torch.no_grad():
            tables = [spatial._preprocess_features(row_block(model, i, world), rs)
                      for i in range(world)]
            bands = []
            for b in range(world):
                steps = [ring.ring_step(*tables[(b - s) % world], b, cfg, cams, st)
                         for s in range(world)]
                bands.append(ring.ring_blend(steps, b, cfg, cams, st)[0])
        out[f"core_{case}"] = torch.cat(bands, dim=1)[:, :SIZE].numpy()

render, _ = ring.make_ring_render(mesh, static=static("GLOBAL", "Z_DEPTH"),
                                  per_step_capacity=8)
out["overflow_8"] = np.array(render(shard, cams)[1])

cfg = spatial.plan_bands(SIZE, SIZE, world)
for case, mode, order in STEPS:
    step = ring.make_ring_train_step(mesh, static=static(mode, order),
                                     per_step_capacity=CAPACITY)
    shard = spatial.shard_model(model, mesh, "shards")
    opt = make_optimizer(shard.parameters())
    target = spatial.band_rows(torch.tensor(inp["step_target"]), cfg, rank)
    shard, opt, loss = step(shard, opt, cams, target)
    out[f"step_loss_{case}"] = loss.numpy()
    for k in PARAM_NAMES:
        out[f"grad_{case}_{k}"] = getattr(shard, k).grad.numpy()
np.savez(f"{workdir}/rank{rank}.npz", **out)
"""


def _static(settings_cls, ext_cls, mode_cls, order_cls, cam, bg, mode, order,
            culling=False):
    ext = ext_cls()
    ext.sort_settings.sort_mode = mode_cls[mode]
    ext.sort_settings.sort_order = order_cls[order]
    ext.sort_settings.queue_sizes.per_pixel = 4
    ext.culling_settings.tile_based_culling = culling
    return settings_cls(
        image_height=SIZE, image_width=SIZE, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=bg, scale_modifier=1.0,
        viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        inv_viewprojmatrix=cam.inv_viewprojmatrix, sh_degree=3,
        campos=cam.campos, prefiltered=False, settings=ext)


def _jax_setup(mode, order):
    cam = jax_make_camera(SIZE, SIZE, campos=(0.0, 0.0, -4.0))
    static = _static(JSettings, JExt, JSortMode, JOrder, cam, jnp.array(BG),
                     mode, order)
    return static, JCams(cam.viewmatrix, cam.projmatrix,
                         cam.inv_viewprojmatrix, cam.campos)


def _port_setup(mode, order, culling=False):
    cam = make_camera(SIZE, SIZE, campos=(0.0, 0.0, -4.0), device="cpu")
    static = _static(GaussianRasterizationSettings, ExtendedSettings, SortMode,
                     GlobalSortOrder, cam, torch.tensor(BG), mode, order,
                     culling)
    return static, CameraArrays(cam.viewmatrix, cam.projmatrix,
                                cam.inv_viewprojmatrix, cam.campos)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ring")
    model = jax_init_random(jax.random.PRNGKey(0), P)
    inp = {k: np.asarray(v) for k, v in model._asdict().items()}
    inp.update(size=np.array(SIZE), capacity=np.array(CAPACITY),
               bg=np.array(BG, np.float32))
    inp["step_target"] = np.random.default_rng(5).uniform(
        0.0, 1.0, (3, SIZE, SIZE)).astype(np.float32)
    np.savez(workdir / "inputs.npz", **inp)
    body = f"RENDERS, STEPS = {RENDERS!r}, {STEPS!r}\n" + _BODY
    return model, inp, run_ranks(body, WORLD, workdir)


@pytest.mark.parametrize("case,mode,order", RENDERS, ids=[r[0] for r in RENDERS])
def test_ring_render_matches_jax(run, case, mode, order):
    model, _, out = run
    static, cams = _jax_setup(mode, order)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("shards",))
    render, _ = jax_ring_render(mesh, static=static,
                                per_step_capacity=CAPACITY, interpret=True)
    ref, overflow = render(jax_shard_model(model, mesh, axis="shards"), cams)
    assert not bool(overflow)
    for o in out:
        assert not bool(o[f"overflow_{case}"])
        np.testing.assert_array_equal(o[f"img_{case}"], out[0][f"img_{case}"])
    np.testing.assert_allclose(out[0][f"img_{case}"], np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", [r[0] for r in RENDERS])
def test_ring_core_stitched_equals_sharded(run, case):
    _, _, out = run
    np.testing.assert_array_equal(out[0][f"core_{case}"], out[0][f"img_{case}"])


def test_ring_overflow_reported(run):
    _, _, out = run
    assert all(bool(o["overflow_8"]) for o in out)


@pytest.mark.parametrize("case,mode,order", STEPS, ids=[s[0] for s in STEPS])
def test_ring_step_matches_single_device(run, case, mode, order):
    _, inp, out = run
    static, cams = _port_setup(mode, order)
    model = from_numpy_params({k: inp[k] for k in PARAM_NAMES}, device="cpu")
    color, _ = render_model(model, cams, static=static)
    loss = rgb_loss(color, torch.tensor(inp["step_target"]))
    loss.backward()
    refs = [float(loss.detach())]
    if mode == "GLOBAL":
        jstatic, jcams = _jax_setup(mode, order)
        img, _ = jax_render_model(jax_init_random(jax.random.PRNGKey(0), P),
                                  jcams, static=jstatic, pair_capacity=8192,
                                  interpret=True)
        refs.append(float(jax_rgb_loss(img, jnp.asarray(inp["step_target"]))))
    for o in out:
        for ref in refs:
            np.testing.assert_allclose(float(o[f"step_loss_{case}"]), ref,
                                       atol=2e-5, rtol=2e-5)
    for name in PARAM_NAMES:
        ref = getattr(model, name).grad.numpy()
        got = np.concatenate([o[f"grad_{case}_{name}"] for o in out])
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("mode,culling", [("PPX_FULL", False),
                                          ("GLOBAL", True)])
def test_ppx_full_and_tile_culling_raise(mode, culling):
    static, cams = _port_setup(mode, "Z_DEPTH", culling)
    model = from_numpy_params(
        {k: np.asarray(v) for k, v in
         jax_init_random(jax.random.PRNGKey(0), 8)._asdict().items()},
        device="cpu")
    with torch.no_grad():
        feat, ints = _preprocess_features(
            model, _with_camera(static, cams, "cpu"))
    match = "PPX_FULL" if mode == "PPX_FULL" else "tile_based_culling"
    with pytest.raises(NotImplementedError, match=match):
        ring_step(feat, ints, 0, plan_bands(SIZE, SIZE, 1), cams, static)
