"""The port's PER_PIXEL_FULL sort mode (the dense oracle ``render/naive.py``,
the plain version of kernel K7 through ``render_tiled_full``, the API and
the CLIs) against the JAX package, on the CPU.

The same numpy-drawn scene goes through both packages' preprocess.
Tolerances: image and final_T atol 1e-5 and depth_acc 1e-4 against the JAX
oracle ``render_full_sort_naive``, n_contrib different on under 2% of the
pixels (the JAX test's allowance for near-threshold flips: the oracle sums
its log-space prefix with ``cumsum``, the port in order). The largest
errors seen on these scenes: 1.2e-7 (image), 1.8e-7 (final_T), 1.7e-6
(depth_acc), no n_contrib flip. Against the JAX Pallas kernel in interpret
mode, on a scene without depth near-ties (its bitonic network is not
stable and it forms the ray with a reciprocal): its test's atol 1e-4.

The trap scene clones Gaussians bit for bit (exact depth ties) and gives
pixels more than three lists of K7's actives. A small numpy model of K7's
rounds (a list of K entries above a floor) equals the plain version
there with the floor compared on (depth, stream position), and differs
from it with a floor on depth alone, which drops tied clones.
"""

import bisect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stopthepop_tpu
from stopthepop_tpu.config import GlobalSortOrder as JOrder
from stopthepop_tpu.io.images import read_png
from stopthepop_tpu.render.naive import render_full_sort_naive as jax_full_naive
from stopthepop_tpu.render.pipeline import render_tiled_full as jax_render_full
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess
from stopthepop_tpu.utils.testing import bucket_pair_capacity

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.constants import T_THRESHOLD
from stopthepop_tpu_torch.io.ply import save_gaussian_model
from stopthepop_tpu_torch.kernels import full_blend
from stopthepop_tpu_torch.kernels.full_blend import (
    blend_full_forward,
    blend_full_forward_plain,
)
from stopthepop_tpu_torch.models.gaussians import init_random
from stopthepop_tpu_torch.render import cli as render_cli
from stopthepop_tpu_torch.render import rasterize
from stopthepop_tpu_torch.render.naive import render_full_sort_naive
from stopthepop_tpu_torch.render.pipeline import (
    render_tiled_full,
    render_tiled_kbuffer,
    tile_grid,
)
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.train import cli as train_cli
from stopthepop_tpu_torch.utils.testing import (
    clone_trap_scene,
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

BG = np.array([0.15, 0.05, 0.3], np.float32)


def _j(x):
    return jnp.asarray(x.numpy())


def _preps(w, h, scene, order=0):
    cam = make_camera(w, h, device="cpu")
    kw = dict(tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, image_width=w,
              image_height=h, sh_degree=3)
    t = preprocess(scene.means3d, scene.opacities, scales=scene.scales,
                   rotations=scene.rotations, shs=scene.shs,
                   viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
                   campos=cam.campos, sort_order=stt.GlobalSortOrder(order),
                   **kw)
    j = jax_preprocess(
        _j(scene.means3d), _j(scene.opacities), scales=_j(scene.scales),
        rotations=_j(scene.rotations), shs=_j(scene.shs),
        viewmatrix=_j(cam.viewmatrix), projmatrix=_j(cam.projmatrix),
        campos=_j(cam.campos), sort_order=JOrder(order), **kw)
    return cam, t, j


def _jax_oracle(cam, j, w, h):
    img, T, n, D = jax_full_naive(j, jnp.asarray(BG), w, h, _j(cam.campos),
                                  _j(cam.inv_viewprojmatrix))
    return np.asarray(img), np.asarray(T), np.asarray(n), np.asarray(D)


def _tiled(cam, t, w, h, order=0, cull=False):
    return render_tiled_full(
        t, torch.from_numpy(BG), image_width=w, image_height=h,
        campos=cam.campos, inverse_vp=cam.inv_viewprojmatrix,
        sort_order=stt.GlobalSortOrder(order), tile_based_culling=cull)


def _assert_matches_oracle(img, final_t, n_contrib, depth_acc, ref):
    rimg, rT, rn, rD = ref
    np.testing.assert_allclose(img.numpy(), rimg, atol=1e-5)
    np.testing.assert_allclose(final_t.numpy().reshape(-1), rT, atol=1e-5)
    np.testing.assert_allclose(depth_acc.numpy(), rD, atol=1e-4)
    assert n_contrib.dtype == torch.int32
    assert (n_contrib.numpy().reshape(-1) != rn).mean() < 0.02


# The draws of tests/test_full_sort.py (seed, Gaussians) at 48x48, with numpy.
SCENES = [(5, 200), (11, 60)]


@pytest.mark.parametrize("seed,n", SCENES)
def test_naive_oracle_matches_jax(seed, n):
    w = h = 48
    cam, t, j = _preps(w, h, random_scene(seed, n, device="cpu"))
    img, final_t, n_contrib, depth_acc = render_full_sort_naive(
        t, torch.from_numpy(BG), w, h, cam.campos, cam.inv_viewprojmatrix)
    assert img.shape == (3, h, w) and final_t.shape == (w * h,)
    _assert_matches_oracle(img, final_t, n_contrib, depth_acc,
                           _jax_oracle(cam, j, w, h))


@pytest.mark.parametrize("seed,n,order,cull", [
    (5, 200, 0, False), (11, 60, 0, False), (5, 200, 3, True)],
    ids=["200-zdepth", "60-zdepth", "200-ptd_max-tilecull"])
def test_plain_k7_matches_jax_oracle(seed, n, order, cull):
    # The stream order and tile-based culling change which pairs a tile
    # holds and in what order, not the per-pixel sort's result.
    w = h = 48
    cam, t, j = _preps(w, h, random_scene(seed, n, device="cpu"), order)
    img, final_t, n_contrib, pairs, depth_acc = _tiled(cam, t, w, h, order,
                                                       cull)
    assert pairs.num_rendered > 0
    _assert_matches_oracle(img, final_t, n_contrib, depth_acc,
                           _jax_oracle(cam, j, w, h))


def test_plain_k7_matches_jax_pallas_kernel():
    w = h = 48
    scene = random_scene(6, 200, scale_range=(0.02, 0.2), device="cpu")
    cam, t, j = _preps(w, h, scene)
    img, final_t, n_contrib, _, depth_acc = _tiled(cam, t, w, h)
    jimg, jT, jn, jpairs, jD = jax_render_full(
        j, jnp.asarray(BG), image_width=w, image_height=h,
        capacity=bucket_pair_capacity(j), campos=_j(cam.campos),
        inverse_vp=_j(cam.inv_viewprojmatrix), seg_full=256, interpret=True)
    assert not bool(jpairs.overflow)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(depth_acc.numpy(), np.asarray(jD), atol=1e-3)
    assert (n_contrib.numpy() != np.asarray(jn)).mean() < 0.02


# ---------------------------------------------------------------------------
# The trap scene: exact ties and many windows of actives
# ---------------------------------------------------------------------------

def test_trap_scene_plain_k7_equals_oracle():
    w = h = 32
    cam, t, j = _preps(w, h, clone_trap_scene("cpu"))
    img, final_t, n_contrib, _, depth_acc = _tiled(cam, t, w, h)
    rimg, rT, rn, rD = _jax_oracle(cam, j, w, h)
    np.testing.assert_allclose(img.numpy(), rimg, atol=1e-5)
    np.testing.assert_allclose(final_t.numpy().reshape(-1), rT, atol=1e-5)
    np.testing.assert_allclose(depth_acc.numpy(), rD, atol=1e-4)
    np.testing.assert_array_equal(n_contrib.numpy().reshape(-1), rn)
    # More than three lists of K7's commits on a pixel, and pixels that
    # stop at the threshold.
    assert int(n_contrib.max()) > 3 * full_blend.WINDOW
    assert float(final_t.min()) < 2 * T_THRESHOLD


def _k7_rounds(entries, K, lexicographic):
    """K7's rounds for one pixel (numpy float32): ``entries`` its actives in
    stream order as (depth, position, alpha, (r, g, b)). Returns (C, T,
    n_contrib)."""
    f32 = np.float32
    floor = (-np.inf, -1)
    S, T, C, nc = f32(0), f32(1), np.zeros(3, f32), 0
    while True:
        win, keys = [], []
        for e in entries:
            d, p = e[0], e[1]
            above = d > floor[0] or (lexicographic and d == floor[0]
                                     and p > floor[1])
            if not above or (len(win) == K and not d < keys[-1]):
                continue
            i = bisect.bisect_right(keys, d)
            win.insert(i, e)
            keys.insert(i, d)
            del win[K:], keys[K:]
        for d, p, a, rgb in win:
            S = f32(S + np.log1p(-a))
            U = f32(np.exp(S))
            if U < T_THRESHOLD:
                return C, T, nc
            C = (C + f32(a * T) * rgb).astype(f32)
            T, nc = U, nc + 1
        if len(win) < K:
            return C, T, nc
        floor = win[-1][:2]


def test_trap_scene_needs_a_lexicographic_floor():
    w = h = 32
    cam, t, _ = _preps(w, h, clone_trap_scene("cpu"))
    gx, gy = tile_grid(w, h)
    _, _, _, pairs, _ = _tiled(cam, t, w, h)
    counts = (pairs.ends - pairs.starts).to(torch.int64)
    pix_x, pix_y, vd = full_blend._view_rays(gx, gy, w, h,
                                             cam.inv_viewprojmatrix,
                                             cam.campos, "cpu")
    inside = torch.ones((gx * gy, 256), dtype=torch.bool)
    gid, _, alpha, depth, active = full_blend._chunk_tables(
        pairs.gauss_id, pairs.starts, counts, t.mean2d, t.conic_opacity,
        t.cov3d_inv9, pix_x, pix_y, vd, inside, int(counts.max()))
    ref_C, ref_T, ref_n, _ = blend_full_forward_plain(
        pairs.gauss_id, pairs.starts, pairs.ends, t.mean2d,
        t.conic_opacity, t.rgb, t.cov3d_inv9, cam.inv_viewprojmatrix,
        cam.campos, grid_x=gx, grid_y=gy, width=w, height=h)
    rgb = t.rgb.numpy()
    err = {True: 0.0, False: 0.0}
    for tile in range(gx * gy):
        for px in range(0, 256, 3):
            x = (tile % gx) * 16 + px % 16
            y = (tile // gx) * 16 + px // 16
            live = active[tile, px].nonzero().flatten().tolist()
            entries = [(np.float32(depth[tile, px, s]), s,
                        np.float32(alpha[tile, px, s]),
                        rgb[int(gid[tile, s])]) for s in live]
            for lex in (True, False):
                C, T, nc = _k7_rounds(entries, full_blend.WINDOW, lex)
                if lex:
                    assert nc == int(ref_n[y, x])
                err[lex] = max(err[lex],
                               float(np.abs(C - ref_C[:, y, x].numpy()).max()),
                               abs(float(T) - float(ref_T[y, x])))
    assert err[True] < 1e-5
    assert err[False] > 1e-2  # a depth-only floor drops tied clones


def test_kbuffer_24_equals_full_on_shallow_scene():
    # With no more actives a pixel than the window holds, the k-buffer is an
    # exact per-pixel sort (tests/test_kbuffer.py:67-87).
    w = h = 32
    cam, t, _ = _preps(w, h, random_scene(6, 60, device="cpu"))
    img, final_t, n_contrib, _, _ = _tiled(cam, t, w, h)
    assert int(n_contrib.max()) <= 24 and float(final_t.min()) > 1e-3
    kimg, kT, _, _, _ = render_tiled_kbuffer(
        t, torch.from_numpy(BG), image_width=w, image_height=h,
        campos=cam.campos, inverse_vp=cam.inv_viewprojmatrix, k=24)
    np.testing.assert_allclose(kimg.numpy(), img.numpy(), atol=1e-5)
    np.testing.assert_allclose(kT.numpy(), final_t.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# The API, the auto rule, gradients and the CLIs
# ---------------------------------------------------------------------------

def _full_settings(mod, cam, as_array):
    ext = mod.ExtendedSettings()
    ext.sort_settings.sort_mode = mod.SortMode.PPX_FULL
    return mod.GaussianRasterizationSettings(
        image_height=cam.height, image_width=cam.width, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=as_array(BG), scale_modifier=1.0,
        viewmatrix=as_array(cam.viewmatrix), projmatrix=as_array(cam.projmatrix),
        inv_viewprojmatrix=as_array(cam.inv_viewprojmatrix), sh_degree=3,
        campos=as_array(cam.campos), prefiltered=False, settings=ext)


def test_naive_gradients_match_jax_api():
    w = h = 24
    n = 40
    cam = make_camera(w, h, device="cpu")
    scene = random_scene(12, n, scale_range=(0.05, 0.4), device="cpu")
    weights = np.random.default_rng(5).standard_normal((3, h, w)).astype(np.float32)
    names = ("means3D", "scales", "rotations", "opacities", "shs")
    inputs = dict(means3D=scene.means3d, scales=scene.scales,
                  rotations=scene.rotations, opacities=scene.opacities,
                  shs=scene.shs)
    leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
    color, _ = stt.GaussianRasterizer(
        _full_settings(stt, cam, torch.as_tensor), full_mode="naive")(
            leaves["means3D"], None, leaves["opacities"], shs=leaves["shs"],
            scales=leaves["scales"], rotations=leaves["rotations"])
    loss = (color * torch.from_numpy(weights)).sum()
    loss.backward()

    rs = _full_settings(stopthepop_tpu, cam, lambda x: jnp.asarray(np.asarray(x)))

    def jloss(means, scales, rots, opac, shs):
        img, _ = stopthepop_tpu.rasterize_gaussians(
            means, None, shs, None, opac, scales, rots, None, rs,
            full_mode="naive")
        return jnp.sum(img * weights)

    jv, jg = jax.value_and_grad(jloss, argnums=tuple(range(5)))(
        *(_j(inputs[k]) for k in names))
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    for name, ref in zip(names, jg):
        got, ref = leaves[name].grad.numpy(), np.asarray(ref)
        assert np.isfinite(got).all() and np.abs(got).max() > 0, name
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(got, ref, atol=2e-4 * scale, rtol=2e-3,
                                   err_msg=f"gradient mismatch for {name}")


def test_auto_rule_and_forward_only_tiled_path(monkeypatch):
    w, h, n = 24, 16, 30
    cam = make_camera(w, h, device="cpu")
    scene = random_scene(3, n, scale_range=(0.05, 0.4), device="cpu")
    rs = _full_settings(stt, cam, torch.as_tensor)
    args = (scene.means3d, None, scene.opacities)
    kw = dict(colors_precomp=scene.colors, scales=scene.scales,
              rotations=scene.rotations)
    assert rasterize.FULL_NAIVE_MAX == 1 << 26
    calls = []
    for name in ("render_full_sort_naive", "render_sorted"):
        fn = getattr(rasterize, name)
        monkeypatch.setattr(rasterize, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n)
                            or _fn(*a, **k))
    outs = {}
    # At the limit the dense oracle, one past it kernel K7's path (the
    # tiled render of PPX_FULL).
    for limit, want in ((n * w * h, "render_full_sort_naive"),
                        (n * w * h - 1, "render_sorted")):
        monkeypatch.setattr(rasterize, "FULL_NAIVE_MAX", limit)
        with torch.no_grad():
            outs[want] = stt.GaussianRasterizer(rs, full_output=True)(*args, **kw)
        assert calls.pop() == want and not calls
    naive, tiled = outs["render_full_sort_naive"], outs["render_sorted"]
    np.testing.assert_allclose(tiled.color.numpy(), naive.color.numpy(), atol=1e-5)
    np.testing.assert_allclose(tiled.final_t.numpy(), naive.final_t.numpy(),
                               atol=1e-5)
    assert (tiled.n_contrib != naive.n_contrib).float().mean() < 0.02
    assert tiled.num_rendered == naive.num_rendered > 0
    # The tiled path is forward only: gradients raise, under either choice.
    means = scene.means3d.clone().requires_grad_(True)
    for mode in ("auto", "tiled"):
        with pytest.raises(RuntimeError, match="full_mode='naive'"):
            stt.GaussianRasterizer(rs, full_mode=mode)(means, None,
                                                       scene.opacities, **kw)
    with pytest.raises(ValueError, match="full_mode"):
        stt.GaussianRasterizer(rs, full_mode="dense")(*args, **kw)
    # The dense path gives gradients.
    monkeypatch.setattr(rasterize, "FULL_NAIVE_MAX", 1 << 26)
    color, _ = stt.GaussianRasterizer(rs)(means, None, scene.opacities, **kw)
    color.sum().backward()
    assert torch.isfinite(means.grad).all() and (means.grad != 0).any()


SMALL, LARGE = (10, 8, 8), (3, 1 << 13, 1 << 12)  # P·W·H 640, 1.5 * 2**26


@pytest.mark.parametrize("mode,device,wants_grad,size,want", [
    ("auto", "cuda", False, LARGE, "tiled"),
    ("auto", "cuda", False, SMALL, "tiled"),  # K7 serves small frames too
    ("auto", "cuda", True, SMALL, "naive"),   # only the oracle has gradients
    ("auto", "cuda", True, LARGE, "tiled"),   # and then raises
    ("auto", "cpu", False, SMALL, "naive"),   # the JAX package's rule
    ("auto", "cpu", False, LARGE, "tiled"),
    ("naive", "cuda", False, LARGE, "naive"),
    ("tiled", "cpu", True, SMALL, "tiled"),
])
def test_full_backend_choice(mode, device, wants_grad, size, want):
    assert rasterize.full_backend(mode, torch.device(device), wants_grad,
                                  *size) == want


def test_render_cli_writes_full_frames_by_either_path(tmp_path, monkeypatch):
    model = init_random(60, seed=0, extent=1.5, device="cpu")
    save_gaussian_model(str(tmp_path / "m.ply"), model)
    frames = {}
    for limit, name in ((1 << 26, "naive"), (0, "tiled")):
        monkeypatch.setattr(rasterize, "FULL_NAIVE_MAX", limit)
        render_cli.main(["--ply", str(tmp_path / "m.ply"), "--out",
                         str(tmp_path / name), "--frames", "2", "--width",
                         "40", "--height", "24", "--sort-mode", "PPX_FULL",
                         "--device", "cpu"])
        frames[name] = [read_png(str(tmp_path / name / f"frame_{i:04d}.png"))
                        for i in range(2)]
    for a, b in zip(frames["naive"], frames["tiled"]):
        assert a.shape == (24, 40, 3) and a.max() > 0
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_train_cli_refuses_full(tmp_path):
    # Refused when the arguments are parsed, before the data is read.
    with pytest.raises(ValueError, match="forward only"):
        train_cli.main(["--data", str(tmp_path), "--sort-mode", "PPX_FULL",
                        "--device", "cpu"])


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    w, h = 40, 24
    gx, gy = tile_grid(w, h)
    cam = make_camera(w, h, device="cpu")
    empty = torch.zeros(0, dtype=torch.int32)
    ranges = torch.zeros(gx * gy, dtype=torch.int32)
    rows = (torch.zeros(5, 2), torch.zeros(5, 4), torch.zeros(5, 3),
            torch.zeros(5, 9), cam.inv_viewprojmatrix, cam.campos)
    kw = dict(grid_x=gx, grid_y=gy, width=w, height=h)
    before = blend_full_forward.launches
    color, final_t, n_contrib, depth_acc = blend_full_forward(
        empty, ranges, ranges, *rows, **kw)
    assert blend_full_forward.launches == before  # the CPU runs no kernel
    assert (color == 0).all() and (final_t == 1).all()
    assert (n_contrib == 0).all() and (depth_acc == 0).all()
    meta = [x.to("meta") for x in (empty, ranges, ranges, *rows)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        blend_full_forward(*meta, **kw)
