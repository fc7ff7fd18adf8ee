"""The port's band-sharded rendering and training (parallel/spatial.py) on the
CPU, in 4 Gloo processes, against the JAX package's.

One group of 4 processes (``utils/testing.py::run_ranks``) runs every case
once; the JAX references come from this process, on the first 4 of the
conftest's virtual CPU devices, in interpret mode, as tests/test_spatial.py
computes them (SIZE 128, 256 Gaussians from PRNGKey(0), camera at
(0, 0, -4), background (0.1, 0.2, 0.3)):

- ``make_spatial_render`` on 4 bands against JAX's: GLOBAL at atol = rtol
  = 1e-5 (test_spatial.py:70-71), PPX_KBUFFER (k = 4) at atol 1e-4
  (test_spatial.py:149-150); every rank holds the whole image;
- the collective-free core ``render_band`` over bands 0..3, stitched in one
  process from the shards' feature tables, equals the 4-process render to
  the bit;
- ``spatial_rgb_loss`` on random band-sharded images against the port's
  single-image ``rgb_loss``, at a height the bands split evenly and at one
  they pad: loss at atol = rtol = 2e-5 (test_spatial.py:100), gradient
  with respect to the image at 1e-4 of its largest value (the halo's SSIM
  sums in JAX's order, W then H);
- one step of ``make_spatial_train_step`` in GLOBAL, PPX_KBUFFER and HIER
  (queues 64, 8, 4): its
  loss against the port's single-device loss (and, in GLOBAL, JAX's) at
  2e-5, its gradients of the 6 parameter tensors against the port's
  single-device autograd gradients at 1e-4 of each tensor's largest value
  (the reduce-scatter sums the bands in another order than one
  segment_reduce);
- PPX_FULL raises NotImplementedError, where JAX renders GLOBAL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from stopthepop_tpu.config import ExtendedSettings as JExt
from stopthepop_tpu.config import GaussianRasterizationSettings as JSettings
from stopthepop_tpu.config import SortMode as JSortMode
from stopthepop_tpu.models.gaussians import init_random as jax_init_random
from stopthepop_tpu.parallel.spatial import make_spatial_render as jax_spatial_render
from stopthepop_tpu.parallel.spatial import shard_model as jax_shard_model
from stopthepop_tpu.train.loss import rgb_loss as jax_rgb_loss
from stopthepop_tpu.train.trainer import CameraArrays as JCams
from stopthepop_tpu.train.trainer import render_model as jax_render_model
from stopthepop_tpu.utils.testing import make_camera as jax_make_camera

from stopthepop_tpu_torch.config import (
    ExtendedSettings,
    GaussianRasterizationSettings,
    SortMode,
)
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES, from_numpy_params
from stopthepop_tpu_torch.parallel.spatial import (
    _preprocess_features,
    _with_camera,
    plan_bands,
    render_band,
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
MODES = ("GLOBAL", "PPX_KBUFFER")
STEP_MODES = MODES + ("HIER",)
LOSS_HEIGHTS = (128, 120)

_BODY = r"""
from stopthepop_tpu_torch.config import ExtendedSettings, GaussianRasterizationSettings, SortMode
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES, from_numpy_params, row_block
from stopthepop_tpu_torch.parallel import spatial
from stopthepop_tpu_torch.train.trainer import make_optimizer
from stopthepop_tpu_torch.utils.testing import make_camera

inp = np.load(f"{workdir}/inputs.npz")
SIZE = int(inp["size"])
out = {}
mesh = hosts.global_mesh(("tiles",))
model = from_numpy_params({k: inp[k] for k in PARAM_NAMES}, device="cpu")
shard = spatial.shard_model(model, mesh)
cam = make_camera(SIZE, SIZE, campos=(0.0, 0.0, -4.0), device="cpu")
cams = CameraArrays(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                    cam.campos)


def static(mode):
    ext = ExtendedSettings()
    ext.sort_settings.sort_mode = SortMode[mode]
    ext.sort_settings.queue_sizes.per_pixel = 4
    return GaussianRasterizationSettings(
        image_height=SIZE, image_width=SIZE, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=torch.tensor(inp["bg"]), scale_modifier=1.0,
        viewmatrix=None, projmatrix=None, inv_viewprojmatrix=None,
        sh_degree=3, campos=None, prefiltered=False, settings=ext)


for mode in ("GLOBAL", "PPX_KBUFFER"):
    render, cfg = spatial.make_spatial_render(mesh, static=static(mode))
    out[f"img_{mode}"] = render(shard, cams).numpy()
    if rank == 0:
        rs = spatial._with_camera(static(mode), cams, "cpu")
        with torch.no_grad():
            tables = [spatial._preprocess_features(row_block(model, i, world), rs)
                      for i in range(world)]
            feat = torch.cat([t[0] for t in tables])
            ints = torch.cat([t[1] for t in tables])
            bands = [spatial.render_band(feat, ints, b, cfg, cams, static(mode))[0]
                     for b in range(world)]
        out[f"core_{mode}"] = torch.cat(bands, dim=1)[:, :SIZE].numpy()

for h in (128, 120):
    cfg = spatial.plan_bands(SIZE, h, world)
    color = spatial.band_rows(torch.tensor(inp[f"color_{h}"]), cfg, rank)
    color.requires_grad_(True)
    target = spatial.band_rows(torch.tensor(inp[f"target_{h}"]), cfg, rank)
    loss = spatial.spatial_rgb_loss(color, target, cfg)
    loss.backward()
    out[f"loss_{h}"], out[f"dcolor_{h}"] = loss.detach().numpy(), color.grad.numpy()

cfg = spatial.plan_bands(SIZE, SIZE, world)
for mode in ("GLOBAL", "PPX_KBUFFER", "HIER"):
    step = spatial.make_spatial_train_step(mesh, static=static(mode))
    shard = spatial.shard_model(model, mesh)
    opt = make_optimizer(shard.parameters())
    target = spatial.band_rows(torch.tensor(inp["step_target"]), cfg, rank)
    shard, opt, loss = step(shard, opt, cams, target)
    out[f"step_loss_{mode}"] = loss.numpy()
    for k in PARAM_NAMES:
        out[f"grad_{mode}_{k}"] = getattr(shard, k).grad.numpy()
np.savez(f"{workdir}/rank{rank}.npz", **out)
"""


def _static(settings_cls, ext_cls, mode_cls, cam, bg, mode):
    ext = ext_cls()
    ext.sort_settings.sort_mode = mode_cls[mode]
    ext.sort_settings.queue_sizes.per_pixel = 4
    return settings_cls(
        image_height=SIZE, image_width=SIZE, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=bg, scale_modifier=1.0,
        viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        inv_viewprojmatrix=cam.inv_viewprojmatrix, sh_degree=3,
        campos=cam.campos, prefiltered=False, settings=ext)


def _jax_setup(mode):
    cam = jax_make_camera(SIZE, SIZE, campos=(0.0, 0.0, -4.0))
    static = _static(JSettings, JExt, JSortMode, cam, jnp.array(BG), mode)
    cams = JCams(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                 cam.campos)
    return static, cams


def _port_setup(mode):
    cam = make_camera(SIZE, SIZE, campos=(0.0, 0.0, -4.0), device="cpu")
    static = _static(GaussianRasterizationSettings, ExtendedSettings, SortMode,
                     cam, torch.tensor(BG), mode)
    cams = CameraArrays(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                        cam.campos)
    return static, cams


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(11)
    model = jax_init_random(jax.random.PRNGKey(0), P)
    inp = {k: np.asarray(v) for k, v in model._asdict().items()}
    inp.update(size=np.array(SIZE), bg=np.array(BG, np.float32))
    for h in LOSS_HEIGHTS:
        for name in ("color", "target"):
            inp[f"{name}_{h}"] = rng.uniform(0.0, 1.0, (3, h, SIZE)).astype(
                np.float32)
    inp["step_target"] = rng.uniform(0.0, 1.0, (3, SIZE, SIZE)).astype(
        np.float32)
    np.savez(workdir / "inputs.npz", **inp)
    return model, inp, run_ranks(_BODY, WORLD, workdir)


@pytest.mark.parametrize("mode", MODES)
def test_spatial_render_matches_jax(run, mode):
    model, _, out = run
    static, cams = _jax_setup(mode)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("tiles",))
    render, _ = jax_spatial_render(mesh, static=static, band_capacity=4096,
                                   interpret=True)
    ref = np.asarray(render(jax_shard_model(model, mesh), cams))
    tol = dict(atol=1e-5, rtol=1e-5) if mode == "GLOBAL" else dict(atol=1e-4)
    for o in out:
        assert o[f"img_{mode}"].shape == ref.shape
        np.testing.assert_array_equal(o[f"img_{mode}"], out[0][f"img_{mode}"])
    np.testing.assert_allclose(out[0][f"img_{mode}"], ref, **tol)


@pytest.mark.parametrize("mode", MODES)
def test_render_band_core_stitched_equals_sharded(run, mode):
    _, _, out = run
    np.testing.assert_array_equal(out[0][f"core_{mode}"], out[0][f"img_{mode}"])


@pytest.mark.parametrize("height", LOSS_HEIGHTS)
def test_spatial_rgb_loss_matches_rgb_loss(run, height):
    _, inp, out = run
    cfg = plan_bands(SIZE, height, WORLD)
    color = torch.tensor(inp[f"color_{height}"], requires_grad=True)
    loss = rgb_loss(color, torch.tensor(inp[f"target_{height}"]))
    loss.backward()
    ref = color.grad.numpy()
    got = np.concatenate([o[f"dcolor_{height}"] for o in out], axis=1)
    assert got.shape[1] == WORLD * cfg.band_h >= height
    for o in out:
        np.testing.assert_allclose(float(o[f"loss_{height}"]),
                                   float(loss.detach()),
                                   atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got[:, :height], ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    assert not got[:, height:].any()


@pytest.mark.parametrize("mode", STEP_MODES)
def test_spatial_step_matches_single_device(run, mode):
    _, inp, out = run
    static, cams = _port_setup(mode)
    model = from_numpy_params({k: inp[k] for k in PARAM_NAMES}, device="cpu")
    target = torch.tensor(inp["step_target"])
    color, _ = render_model(model, cams, static=static)
    loss = rgb_loss(color, target)
    loss.backward()
    refs = [float(loss.detach())]
    if mode == "GLOBAL":
        jstatic, jcams = _jax_setup(mode)
        jmodel = jax_init_random(jax.random.PRNGKey(0), P)
        img, _ = jax_render_model(jmodel, jcams, static=jstatic,
                                  pair_capacity=8192, interpret=True)
        refs.append(float(jax_rgb_loss(img, jnp.asarray(inp["step_target"]))))
    for o in out:
        for ref in refs:
            np.testing.assert_allclose(float(o[f"step_loss_{mode}"]), ref,
                                       atol=2e-5, rtol=2e-5)
    for name in PARAM_NAMES:
        ref = getattr(model, name).grad.numpy()
        got = np.concatenate([o[f"grad_{mode}_{name}"] for o in out])
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)


def test_ppx_full_raises():
    static, cams = _port_setup("PPX_FULL")
    model = from_numpy_params(
        {k: np.asarray(v) for k, v in
         jax_init_random(jax.random.PRNGKey(0), 8)._asdict().items()},
        device="cpu")
    with torch.no_grad():
        feat, ints = _preprocess_features(
            model, _with_camera(static, cams, "cpu"))
    with pytest.raises(NotImplementedError, match="PPX_FULL"):
        render_band(feat, ints, 0, plan_bands(SIZE, SIZE, 1), cams, static)
