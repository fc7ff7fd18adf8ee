"""The port's HIERARCHICAL forward (plain version of kernel K5,
``render_tiled_hier``, the API and the CLIs) against the JAX package, on the
CPU.

The same numpy-drawn scene goes through both packages' preprocess. The
plain K5 is held against the JAX oracle ``render_hierarchical_naive``
(per-entry cascade) at color and final_T atol 1e-5, with n_contrib equal on
at least 99.9% of the pixels (two float paths may order a near-tie
differently), and against the JAX Pallas kernel in interpret mode on one
scene without depth near-ties at that test's atol 3e-5 (the Pallas kernel
merges its tail with an unstable bitonic network and forms the view ray with
a reciprocal, so it may differ from its own oracle at near-ties).

The trap tests run a hand-built scene through a small per-pixel numpy
cascade: with the oracle's rules it equals the oracle, and with each rule
that a straight port may get wrong (alpha-0 entries dropped, ties in the
tail in reverse order, a sliding tail instead of batches of 64, pixel
centers at +0.5) it differs from it, while the port equals the oracle.
"""

import bisect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stopthepop_tpu
from stopthepop_tpu.config import GlobalSortOrder as JOrder
from stopthepop_tpu.io.images import read_png
from stopthepop_tpu.render.naive import render_hierarchical_naive
from stopthepop_tpu.render.pipeline import render_tiled_hier as jax_render_hier
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess
from stopthepop_tpu.utils.testing import bucket_pair_capacity

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.constants import T_THRESHOLD
from stopthepop_tpu_torch.io.ply import save_gaussian_model
from stopthepop_tpu_torch.kernels.hier_blend import (
    blend_hier_forward,
    blend_hier_forward_plain,
    subtile_of_pixel,
)
from stopthepop_tpu_torch.models.gaussians import init_random
from stopthepop_tpu_torch.ops.stopthepop import depth_along_ray
from stopthepop_tpu_torch.ops.transforms import compute_view_ray
from stopthepop_tpu_torch.render import cli as render_cli
from stopthepop_tpu_torch.render.pipeline import render_tiled_hier, tile_grid
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.train import cli as train_cli
from stopthepop_tpu_torch.utils.synthetic import structured_scene, write_nerf_synthetic
from stopthepop_tpu_torch.utils.testing import (
    Scene,
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

BG = np.array([0.15, 0.05, 0.3], np.float32)
ATOL = 1e-5


def _j(x):
    return jnp.asarray(x.numpy())


def _preps(cam, scene, order=0, colors=False):
    kw = dict(tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
              image_width=cam.width, image_height=cam.height,
              sort_order=order)
    col = (dict(colors_precomp=scene.colors) if colors
           else dict(shs=scene.shs, sh_degree=3))
    t = preprocess(scene.means3d, scene.opacities, scales=scene.scales,
                   rotations=scene.rotations, viewmatrix=cam.viewmatrix,
                   projmatrix=cam.projmatrix, campos=cam.campos,
                   **{**kw, "sort_order": stt.GlobalSortOrder(order)}, **col)
    j = jax_preprocess(
        _j(scene.means3d), _j(scene.opacities), scales=_j(scene.scales),
        rotations=_j(scene.rotations), viewmatrix=_j(cam.viewmatrix),
        projmatrix=_j(cam.projmatrix), campos=_j(cam.campos),
        **{**kw, "sort_order": JOrder(order)},
        **{k: _j(v) if isinstance(v, torch.Tensor) else v
           for k, v in col.items()})
    return t, j


def _port(cam, t, queues, order=0, tile_cull=False, hier_cull=False):
    with torch.no_grad():
        return render_tiled_hier(
            t, torch.from_numpy(BG), image_width=cam.width,
            image_height=cam.height, campos=cam.campos,
            inverse_vp=cam.inv_viewprojmatrix, queue_sizes=queues,
            sort_order=stt.GlobalSortOrder(order),
            tile_based_culling=tile_cull, hier_4x4_culling=hier_cull)


def _oracle(cam, j, queues, order=0, tile_cull=False, hier_cull=False):
    img, final_t, nc = render_hierarchical_naive(
        j, jnp.asarray(BG), cam.width, cam.height, _j(cam.campos),
        _j(cam.inv_viewprojmatrix), queue_sizes=queues,
        sort_order=JOrder(order), tile_based_culling=tile_cull,
        hier_4x4_culling=hier_cull)
    return np.asarray(img), np.asarray(final_t), np.asarray(nc)


def _assert_matches_oracle(port, oracle):
    img, final_t, n_contrib = port[:3]
    np.testing.assert_allclose(img.numpy(), oracle[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(final_t.numpy().reshape(-1), oracle[1],
                               atol=ATOL, rtol=0)
    assert n_contrib.dtype == torch.int32
    assert (n_contrib.numpy().reshape(-1) == oracle[2]).mean() >= 0.999


def _evaluations(cam, t, pairs, queues, hier_cull):
    gx, gy = tile_grid(cam.width, cam.height)
    out = blend_hier_forward_plain(
        pairs.gauss_id, pairs.starts, pairs.ends, t.mean2d, t.conic_opacity,
        t.rgb, t.cov3d_inv9, t.opacity_power_threshold,
        cam.inv_viewprojmatrix, cam.campos, queue_sizes=queues,
        hier_4x4_culling=hier_cull, grid_x=gx, grid_y=gy, width=cam.width,
        height=cam.height, count_evaluations=True)
    return out[4]["evaluations"]


CASES = {
    # name: (size, Gaussians, seed, scene kwargs, queues, order, culling)
    "16-8-4": (48, 150, 8, dict(scale_range=(0.05, 0.4)), (16, 8, 4), 0, False),
    "8-4-2": (48, 150, 8, dict(scale_range=(0.05, 0.4)), (8, 4, 2), 0, False),
    # Dense enough that tile streams overflow the 64-deep tail
    # (tests/test_hierarchical.py::test_hier_default_queues_match_oracle).
    "64-8-4-dense": (32, 400, 21, dict(extent=0.6), (64, 8, 4), 0, False),
    "64-20-16": (32, 150, 8, dict(scale_range=(0.05, 0.4)), (64, 20, 16), 0,
                 False),
    "16-8-4-culling": (48, 150, 9, dict(scale_range=(0.05, 0.4)), (16, 8, 4),
                       0, True),
    "16-8-4-ptd_center": (48, 150, 8, dict(scale_range=(0.05, 0.4)),
                          (16, 8, 4), 2, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k5_matches_jax_oracle(case):
    size, n, seed, scene_kw, queues, order, cull = CASES[case]
    cam = make_camera(size, size, device="cpu")
    t, j = _preps(cam, random_scene(seed, n, device="cpu", **scene_kw), order)
    port = _port(cam, t, queues, order, cull, cull)
    _assert_matches_oracle(port, _oracle(cam, j, queues, order, cull, cull))
    counts = port[3].ends - port[3].starts
    if case == "64-8-4-dense":
        assert int(counts.max()) > 2 * 64  # several tail batches a tile
    assert port[2].max() > queues[2]      # the head window overflows
    if cull:  # the 4x4 culling drops entries from the tail
        assert _evaluations(cam, t, port[3], queues, True) < _evaluations(
            cam, t, port[3], queues, False)


def test_plain_k5_matches_jax_pallas_kernel():
    # The JAX Pallas kernel in interpret mode, at the JAX test's atol, on a
    # scene without depth near-ties (see the module docstring).
    w = h = 32
    cam = make_camera(w, h, device="cpu")
    t, j = _preps(cam, random_scene(6, 50, scale_range=(0.02, 0.2),
                                    device="cpu"))
    queues = (8, 4, 2)
    img, final_t, n_contrib, _, _ = _port(cam, t, queues)
    jimg, jt, jn, _, _ = jax_render_hier(
        j, jnp.asarray(BG), image_width=w, image_height=h,
        capacity=bucket_pair_capacity(j), campos=_j(cam.campos),
        inverse_vp=_j(cam.inv_viewprojmatrix), queue_sizes=queues,
        interpret=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=3e-5)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(jt), atol=3e-5)
    # depth_acc is not compared here: the Pallas kernel adds w * d0 also
    # where a head step pops nothing (w = 0, d0 = +inf from an empty slot),
    # so its depth_acc is NaN on every covered pixel. The trap test below
    # holds the port's depth_acc against a per-pixel cascade instead.
    assert (n_contrib.numpy() == np.asarray(jn)).mean() >= 0.999
    assert n_contrib.max() > queues[2]


# ---------------------------------------------------------------------------
# Traps: a hand-built 16x16 scene and a per-pixel numpy cascade
# ---------------------------------------------------------------------------

TRAP_QUEUES = (16, 4, 2)


def _trap_scene():
    """One 16x16 tile, 20 Gaussians twice (same geometry, other color), and
    a third of the rest with opacity 0.0045: valid for the tail, alpha below
    1/255 (so 0) at every pixel farther than half a sigma from their
    center."""
    rng = np.random.default_rng(5)
    n = 210
    means = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.6, 1.6, n),
                      rng.uniform(-1.0, 1.0, n)], axis=1)
    scales = np.exp(rng.uniform(math.log(0.25), math.log(0.7), (n, 3)))
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.25, 0.6, n)
    opac[rng.permutation(n)[: n // 3]] = 0.0045
    colors = rng.uniform(0.0, 1.0, (n, 3))
    dup = np.flatnonzero(opac > 0.1)[:20]
    idx = np.concatenate([np.arange(n), dup])
    colors = np.concatenate([colors, rng.uniform(0.0, 1.0, (len(dup), 3))])
    arrays = (means[idx], scales[idx], q[idx], opac[idx],
              np.zeros((len(idx), 16, 3)), colors)
    return Scene(*(torch.as_tensor(np.asarray(x, np.float32)) for x in arrays))


def _cascade_inputs(t, pairs, cam, pixel_offset):
    """Per stream position s of the one tile, in float32 torch ops: the
    sub-tile key [S, 16] (-inf where invalid), the mid and head keys and the
    blend alpha [S, 256], and the rgb [S, 3]."""
    gid = pairs.gauss_id.long()
    j = torch.arange(256)
    px, py = (j % 16).float(), (j // 16).float()

    def rays(fx, fy):
        return compute_view_ray(torch.stack([fx, fy], -1), 16, 16,
                                cam.inv_viewprojmatrix, cam.campos)

    inv = t.cov3d_inv9[gid][:, None, :]
    d_head = depth_along_ray(inv, rays(px + pixel_offset, py + pixel_offset)[None])
    d_mid = depth_along_ray(inv, rays(torch.floor(px / 2) * 2 + 0.5,
                                      torch.floor(py / 2) * 2 + 0.5)[None])
    s = torch.arange(16)
    d_tail = depth_along_ray(inv, rays((s % 4) * 4 + 1.5, (s // 4) * 4 + 1.5)[None])
    co = t.conic_opacity[gid]
    dx = t.mean2d[gid, 0:1] - (px + pixel_offset)
    dy = t.mean2d[gid, 1:2] - (py + pixel_offset)
    power = 0.5 * (co[:, 0:1] * dx * dx + co[:, 2:3] * dy * dy) + co[:, 1:2] * dx * dy
    alpha = torch.clamp(co[:, 3:4] * torch.exp(-power), max=0.99)
    ok = (power >= 0) & (alpha >= 1.0 / 255.0) & (d_head >= 0)
    key = torch.where(d_tail >= 0, d_tail, -math.inf)
    return (key.numpy(), d_mid.numpy(), d_head.numpy(),
            torch.where(ok, alpha, 0.0).numpy(), t.rgb[gid].numpy())


def _tail_emission(keys, kt, batch, stable):
    """Real entries (stream positions) in the order the tail emits them."""
    def srt(entries):
        if stable:
            return sorted(entries, key=lambda e: e[0])
        return [e for _, e in sorted(enumerate(entries),
                                     key=lambda ie: (ie[1][0], -ie[0]))]

    hold, out = [(-math.inf, -1)] * kt, []
    S = len(keys)
    for b0 in range(0, S, batch):
        part = [(float(keys[s]), s) for s in range(b0, min(b0 + batch, S))]
        cat = srt(hold + part + [(-math.inf, -1)] * (batch - len(part)))
        out, hold = out + cat[:batch], cat[batch:]
    for _ in range(-(-kt // batch)):
        cat = srt(hold + [(math.inf, -1)] * batch)
        out, hold = out + cat[:batch], cat[batch:]
    return [s for k, s in out if math.isfinite(k)]


def _reference(inputs, queues, *, ride_through=True, stable=True, batch=64,
               mid_depth=False):
    """The HIER cascade of one tile pixel by pixel (float64 blend), with the
    oracle's rules unless told otherwise. Returns color [3, 16, 16] and
    depth_acc [16, 16] (sum of w * d_head, or of w * d_mid with
    ``mid_depth``)."""
    key_t, d_mid, d_head, a, rgb = inputs
    kt, km, kh = queues
    d_blend = d_mid if mid_depth else d_head
    color = np.zeros((256, 3))
    T_all, D_all = np.ones(256), np.zeros(256)
    sub_of = subtile_of_pixel("cpu").numpy()
    for sub in range(16):
        emitted = _tail_emission(key_t[:, sub], kt, batch, stable)
        for p in np.flatnonzero(sub_of == sub):
            st = {"T": 1.0, "C": np.zeros(3), "D": 0.0, "done": False}
            mid, head = [], []

            def blend(s):
                U = st["T"] * (1.0 - a[s, p])
                if not st["done"]:
                    if U < T_THRESHOLD:
                        st["done"] = True
                    else:
                        st["C"] = st["C"] + a[s, p] * st["T"] * rgb[s]
                        st["D"] = st["D"] + a[s, p] * st["T"] * d_blend[s, p]
                        st["T"] = U

            def insert(win, key, s):
                win.insert(bisect.bisect_right([k for k, _ in win], key), (key, s))

            def push_head(s):
                if len(head) == kh:
                    blend(head.pop(0)[1])
                insert(head, d_head[s, p], s)

            for s in emitted:
                if not ride_through and a[s, p] == 0:
                    continue
                if len(mid) == km:
                    push_head(mid.pop(0)[1])
                insert(mid, d_mid[s, p], s)
            while mid:
                push_head(mid.pop(0)[1])
            while head:
                blend(head.pop(0)[1])
            color[p], T_all[p], D_all[p] = st["C"], st["T"], st["D"]
    img = color + T_all[:, None] * BG[None, :]
    return img.T.reshape(3, 16, 16), D_all.reshape(16, 16)


@pytest.fixture(scope="module")
def trap():
    cam = make_camera(16, 16, device="cpu")
    t, j = _preps(cam, _trap_scene(), colors=True)
    port = _port(cam, t, TRAP_QUEUES)
    oracle = _oracle(cam, j, TRAP_QUEUES)
    return cam, t, port, oracle


@pytest.mark.parametrize("wrong", [
    dict(ride_through=False), dict(stable=False), dict(batch=1),
    dict(pixel_offset=0.5)],
    ids=["alpha0-ride-through", "stable-ties", "tail-batch-cadence",
         "integer-pixel"])
def test_hier_traps(trap, wrong):
    cam, t, port, oracle = trap
    pairs = port[3]
    assert int(pairs.ends[0] - pairs.starts[0]) > 2 * 64  # three tail batches
    gid = pairs.gauss_id.long()
    # Exact ties: the 20 duplicates sit next to their originals.
    keys = t.depth[gid]
    assert int((keys[1:] == keys[:-1]).sum()) >= 20
    assert (t.conic_opacity[gid, 3] < 0.005).sum() > 40
    _assert_matches_oracle(port, oracle)
    offset = wrong.pop("pixel_offset", 0.0)
    right, _ = _reference(_cascade_inputs(t, pairs, cam, 0.0), TRAP_QUEUES)
    np.testing.assert_allclose(right, oracle[0].reshape(3, 16, 16), atol=ATOL)
    bad, _ = _reference(_cascade_inputs(t, pairs, cam, offset), TRAP_QUEUES,
                        **wrong)
    assert np.abs(bad - oracle[0].reshape(3, 16, 16)).max() > 1e-3


def test_hier_depth_acc_matches_per_pixel_cascade(trap):
    # The JAX oracle returns no depth_acc and the Pallas kernel's is NaN (see
    # above), so the port's is held against the per-pixel cascade, whose
    # image equals the oracle's (test_hier_traps), at the Pallas test's
    # atol. The quad-center depth in place of the pixel ray's is caught.
    cam, t, port, oracle = trap
    inputs = _cascade_inputs(t, port[3], cam, 0.0)
    img, depth = _reference(inputs, TRAP_QUEUES)
    np.testing.assert_allclose(img, oracle[0].reshape(3, 16, 16), atol=ATOL)
    np.testing.assert_allclose(port[4].numpy(), depth, atol=3e-5, rtol=0)
    assert depth.max() > 1.0
    _, wrong = _reference(inputs, TRAP_QUEUES, mid_depth=True)
    assert np.abs(wrong - depth).max() > 1e-3


# ---------------------------------------------------------------------------
# API and entry points
# ---------------------------------------------------------------------------

def _hier_settings(cam, queues=(64, 8, 4), cull=False, **kw):
    ext = stt.ExtendedSettings()
    ext.sort_settings.sort_mode = stt.SortMode.HIER
    q = ext.sort_settings.queue_sizes
    q.tile_4x4, q.tile_2x2, q.per_pixel = queues
    ext.culling_settings.hierarchical_4x4_culling = cull
    ext.culling_settings.tile_based_culling = cull
    return stt.GaussianRasterizationSettings(
        image_height=cam.height, image_width=cam.width, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=torch.from_numpy(BG), scale_modifier=1.0,
        viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        inv_viewprojmatrix=cam.inv_viewprojmatrix, sh_degree=3,
        campos=cam.campos, prefiltered=False, settings=ext, **kw)


def test_rasterizer_hier_matches_jax_oracle():
    # The scene and settings of the "16-8-4-culling" case, through the API.
    cam = make_camera(48, 48, device="cpu")
    scene = random_scene(9, 150, scale_range=(0.05, 0.4), device="cpu")
    queues = (16, 8, 4)
    with torch.no_grad():
        out = stt.GaussianRasterizer(_hier_settings(cam, queues, True),
                                     full_output=True)(
            scene.means3d, None, scene.opacities, shs=scene.shs,
            scales=scene.scales, rotations=scene.rotations)
    _, j = _preps(cam, scene)
    _assert_matches_oracle((out.color, out.final_t, out.n_contrib),
                           _oracle(cam, j, queues, tile_cull=True,
                                   hier_cull=True))
    covered = out.n_contrib > 0
    assert out.num_rendered > 0 and covered.any()
    # depth_acc sums w * (depth along the pixel's ray): 0 where nothing
    # committed; 1 - final_T is the sum of the weights.
    assert (out.depth_acc[~covered] == 0).all() and (out.depth_acc[covered] > 0).all()


def test_render_cli_writes_hier_frames(tmp_path):
    model = init_random(60, seed=0, extent=1.5, device="cpu")
    save_gaussian_model(str(tmp_path / "m.ply"), model)
    render_cli.main(["--ply", str(tmp_path / "m.ply"), "--out",
                     str(tmp_path / "frames"), "--frames", "2", "--width",
                     "40", "--height", "24", "--sort-mode", "HIER",
                     "--device", "cpu"])
    for i in range(2):
        img = read_png(str(tmp_path / "frames" / f"frame_{i:04d}.png"))
        assert img.shape == (24, 40, 3) and img.max() > 0


@pytest.mark.parametrize("queues", [(0, 8, 4), (513, 8, 4), (64, 0, 4),
                                    (64, 21, 4), (64, 8, 0), (64, 8, 17)])
def test_queue_sizes_out_of_range_raise(queues):
    cam = make_camera(32, 32, device="cpu")
    scene = random_scene(0, 20, device="cpu")
    with pytest.raises(ValueError, match="HIER queue size"):
        stt.GaussianRasterizer(_hier_settings(cam, queues))(
            scene.means3d, None, scene.opacities, colors_precomp=scene.colors,
            scales=scene.scales, rotations=scene.rotations)
    gx, gy = tile_grid(32, 32)
    empty = torch.zeros(0, dtype=torch.int32)
    ranges = torch.zeros(gx * gy, dtype=torch.int32)
    with pytest.raises(ValueError, match="HIER queue size"):
        blend_hier_forward_plain(
            empty, ranges, ranges, torch.zeros(1, 2), torch.zeros(1, 4),
            torch.zeros(1, 3), torch.zeros(1, 9), torch.zeros(1),
            cam.inv_viewprojmatrix, cam.campos, queue_sizes=queues,
            hier_4x4_culling=False, grid_x=gx, grid_y=gy, width=32, height=32)


def test_hier_needs_the_inverse_view_projection():
    cam = make_camera(32, 32, device="cpu")
    scene = random_scene(0, 20, device="cpu")
    rs = _hier_settings(cam)._replace(inv_viewprojmatrix=None)
    with pytest.raises(ValueError, match="inv_viewprojmatrix"):
        stt.GaussianRasterizer(rs)(
            scene.means3d, None, scene.opacities, colors_precomp=scene.colors,
            scales=scene.scales, rotations=scene.rotations)


def test_hier_gradients_raise_naming_k6(tmp_path):
    # HIER's backward (kernel K6) is ported: the API gives finite, non-zero
    # gradients and the training CLI trains in HIER (tests of their values:
    # tests/test_torch_hier_bwd.py, tests/test_torch_hier_train.py).
    cam = make_camera(32, 32, device="cpu")
    scene = random_scene(0, 20, device="cpu")
    opac = scene.opacities.clone().requires_grad_(True)
    color, _ = stt.GaussianRasterizer(_hier_settings(cam))(
        scene.means3d, None, opac, colors_precomp=scene.colors,
        scales=scene.scales, rotations=scene.rotations)
    color.sum().backward()
    assert torch.isfinite(opac.grad).all() and (opac.grad != 0).any()
    gt, _ = structured_scene(400, 0, device="cpu")
    write_nerf_synthetic(str(tmp_path), gt, views=1, size=16, device="cpu")
    res = train_cli.main(["--data", str(tmp_path), "--iters", "1",
                          "--init-points", "60", "--eval-every", "1",
                          "--densify-from", "100", "--sort-mode", "HIER",
                          "--device", "cpu"])
    assert res.state.step == 1 and math.isfinite(res.eval_psnr[1])
    grad = res.state.model.opacity_logit.grad
    assert torch.isfinite(grad).all() and (grad != 0).any()


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    w, h = 40, 24
    gx, gy = tile_grid(w, h)
    cam = make_camera(w, h, device="cpu")
    empty = torch.zeros(0, dtype=torch.int32)
    ranges = torch.zeros(gx * gy, dtype=torch.int32)
    rows = (torch.zeros(5, 2), torch.zeros(5, 4), torch.zeros(5, 3),
            torch.zeros(5, 9), torch.zeros(5), cam.inv_viewprojmatrix,
            cam.campos)
    kw = dict(queue_sizes=(64, 8, 4), hier_4x4_culling=False, grid_x=gx,
              grid_y=gy, width=w, height=h)
    before = blend_hier_forward.launches
    color, final_t, n_contrib, depth_acc = blend_hier_forward(
        empty, ranges, ranges, *rows, **kw)
    assert blend_hier_forward.launches == before  # the CPU runs no kernel
    assert (color == 0).all() and (final_t == 1).all()
    assert (n_contrib == 0).all() and (depth_acc == 0).all()
    meta = [x.to("meta") for x in (empty, ranges, ranges, *rows)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        blend_hier_forward(*meta, **kw)
