"""The per-warp footprint test of kernels K1, K2 and K3 (the plain mirror
``kernels/footprint.py`` of ``csrc/footprint_common.cuh``) on the CPU.

- The test never drops a (warp, pair) at which the per-pixel alpha test of
  the tile blends (power >= 0, min(0.99, o exp(-power)) >= 1/255, float32,
  integer pixel coordinates) passes at some pixel of the warp: seeded numpy
  draws of random conics and opacities, pairs placed so that a pixel lies
  just inside ln(255 o), thin and rotated ellipses, non-positive-definite
  conics and opacities below 1/255, for both warp shapes (16x2, 8x4).
  Exact: no tolerance.
- The plain K1, K2 and K3, skipping the pairs the test culls as the kernels
  do, give the same bits as without the cull (K1 on a scene with partial
  tiles and on one with segments of 2,000+ pairs that saturate pixels), no
  step at which a pixel of K1 stops is culled, K1's off-image pixels, which
  start done, change no output, and K2's summation order follows
  its warp shape (``_warp_tree_sum``; tests/test_torch_blend_bwd.py holds
  the plain K2 in its 8x4 lane order against the JAX package's VJP).
- The Python constants name the kernels' own (``kWarpW``, ``kWarpH`` in
  each source).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stopthepop_tpu_torch.constants import (
    ALPHA_MAX,
    ALPHA_THRESHOLD,
    T_THRESHOLD,
    TILE_X,
)
from stopthepop_tpu_torch.kernels import footprint as fp
from stopthepop_tpu_torch.kernels import global_blend as gb
from stopthepop_tpu_torch.kernels import kbuffer_blend as kb
from stopthepop_tpu_torch.render.duplicate import build_pairs
from stopthepop_tpu_torch.render.pipeline import tile_grid
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

N = 4000
DRAWS = ("random", "near_threshold", "thin_rotated", "non_pd", "low_opacity")
CSRC = Path(fp.__file__).resolve().parent.parent / "csrc"


def _conics(rng, n, var_lo, var_hi):
    """Conics (a, b, c) of 2-D Gaussians with variances in [var_lo, var_hi]
    along random axes: the inverse of R diag(v) R^T."""
    v1 = rng.uniform(var_lo, var_hi, n)
    v2 = rng.uniform(var_lo, var_hi, n)
    th = rng.uniform(0.0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    cxx = cs * cs * v1 + sn * sn * v2
    cyy = sn * sn * v1 + cs * cs * v2
    cxy = cs * sn * (v1 - v2)
    det = cxx * cyy - cxy * cxy
    return cyy / det, -cxy / det, cxx / det


def _draw(kind, seed):
    """(xy [N, 2], conic_opacity [N, 4], tile_origin [N, 2]) float32."""
    rng = np.random.default_rng(seed)
    origin = rng.integers(0, 8, (N, 2)).astype(np.float64) * TILE_X
    o = rng.uniform(0.01, 1.0, N)
    if kind == "thin_rotated":
        # Slivers: variances 0.3 and 50-3000 along a random axis.
        v_long = rng.uniform(50.0, 3000.0, N)
        th = rng.uniform(0.0, np.pi, N)
        cs, sn = np.cos(th), np.sin(th)
        cxx = cs * cs * v_long + sn * sn * 0.3
        cyy = sn * sn * v_long + cs * cs * 0.3
        cxy = cs * sn * (v_long - 0.3)
        det = cxx * cyy - cxy * cxy
        a, b, c = cyy / det, -cxy / det, cxx / det
    else:
        a, b, c = _conics(rng, N, 0.3, 40.0)
    xy = origin + rng.uniform(-30.0, 46.0, (N, 2))
    if kind == "near_threshold":
        # The ellipse power = ln(255 o) touches a pixel on an edge of the
        # tile from outside (its leftmost, rightmost, top or bottom point is
        # the pixel), scaled by 1 +- 2e-6: the pixel is the warp's only
        # candidate and lies just inside or just outside the level set.
        det = a * c - b * b
        sxx, syy, sxy = c / det, a / det, -b / det
        r2 = 2.0 * np.log(255.0 * o) * (1.0 + rng.uniform(-2e-6, 2e-6, N))
        along = rng.integers(0, 16, N)
        side = rng.integers(0, 4, N)      # right, left, bottom, top
        sign = np.where(side % 2 == 0, 1.0, -1.0)
        horiz = side < 2
        pix_x = np.where(horiz, np.where(side == 0, 15, 0), along)
        pix_y = np.where(horiz, along, np.where(side == 2, 15, 0))
        off_x = np.where(horiz, np.sqrt(r2 * sxx), np.sqrt(r2) * sxy / np.sqrt(syy))
        off_y = np.where(horiz, np.sqrt(r2) * sxy / np.sqrt(sxx), np.sqrt(r2 * syy))
        xy = origin + np.stack([pix_x, pix_y], axis=1) + sign[:, None] * np.stack(
            [off_x, off_y], axis=1)
    elif kind == "non_pd":
        which = rng.integers(0, 4, N)
        a = np.where(which == 0, -np.abs(a), a)
        c = np.where(which == 1, 0.0, c)
        b = np.where(which == 2, np.sqrt(np.abs(a * c)) * 1.5, b)
        a = np.where(which == 3, np.nan, a)
    elif kind == "low_opacity":
        o = rng.uniform(0.0, 1.0 / 255.0, N)
    co = np.stack([a, b, c, o], axis=1)
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    return f(xy), f(co), f(origin)


def _alpha(xy, co, origin):
    """(power, alpha) [N, 256], pixels row-major in the tile, as the tile
    blends compute them."""
    j = torch.arange(256)
    px = origin[:, 0:1] + (j % TILE_X).to(torch.float32)
    py = origin[:, 1:2] + (j // TILE_X).to(torch.float32)
    dx = xy[:, 0:1] - px
    dy = xy[:, 1:2] - py
    a, b, c, o = (co[:, i:i + 1] for i in range(4))
    power = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    return power, torch.clamp(o * torch.exp(-power), max=ALPHA_MAX)


def _passes(xy, co, origin):
    """[N, 256] per-pixel alpha test, pixels row-major in the tile."""
    power, alpha = _alpha(xy, co, origin)
    return (power >= 0.0) & (alpha >= ALPHA_THRESHOLD)


@pytest.mark.parametrize("shape", fp.SHAPES, ids=["16x2", "8x4"])
@pytest.mark.parametrize("kind", DRAWS)
def test_footprint_keeps_every_warp_where_a_pixel_passes(kind, shape):
    xy, co, origin = _draw(kind, seed=DRAWS.index(kind))
    mask = fp.warp_footprint_mask(xy, co, origin, shape)
    passes = _passes(xy, co, origin)[:, fp.thread_pixels(shape)]
    need = passes.reshape(N, fp.WARPS, 32).any(dim=-1)          # [N, 8]
    have = ((mask[:, None] >> torch.arange(fp.WARPS)) & 1) != 0
    dropped = need & ~have
    assert not bool(dropped.any()), f"{int(dropped.sum())} warps dropped"
    assert bool(need.any()) or kind == "low_opacity"
    if kind == "low_opacity":
        assert not bool(have.any())        # culled at every warp
    elif kind == "non_pd":
        assert bool((mask == 255).all())   # kept at every warp
    elif kind == "random":
        # The test culls: most warps see none of a pair drawn at random.
        assert int(have.sum()) < 0.6 * have.numel()


def _scene(w=70, h=45, n=300, seed=0, scale_range=(0.05, 0.4), extent=1.5):
    scene = random_scene(seed, n, extent=extent, scale_range=scale_range,
                         device="cpu")
    cam = make_camera(w, h, device="cpu")
    prep = preprocess(
        scene.means3d, scene.opacities, scales=scene.scales,
        rotations=scene.rotations, shs=scene.shs, viewmatrix=cam.viewmatrix,
        projmatrix=cam.projmatrix, campos=cam.campos, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, image_width=w, image_height=h, sh_degree=3,
        rect_bounding=True, tight_opacity_bounding=True)
    gx, gy = tile_grid(w, h)
    pairs = build_pairs(prep, grid_x=gx, grid_y=gy)
    args = (pairs.gauss_id, pairs.starts, pairs.ends,
            prep.mean2d.contiguous(), prep.conic_opacity.contiguous(),
            prep.rgb.contiguous())
    return cam, prep, args, dict(grid_x=gx, grid_y=gy, width=w, height=h)


def _cotangents(w, h, seed=7):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal((3, h, w)), dtype=torch.float32),
            torch.tensor(rng.standard_normal((h, w)), dtype=torch.float32))


# K1's scenes: 70x45 (partial tiles at the right and bottom edges) and the
# deep 32x32 scene of chip_smoke.py (4 segments of 2,000+ pairs: many batches
# of 256 staged pairs, and pixels that saturate).
K1_SCENES = {"70x45": {},
             "deep_32x32": dict(w=32, h=32, n=4000, seed=22, extent=0.5,
                                scale_range=(0.01, 0.12))}


@pytest.fixture(params=fp.SHAPES, ids=["16x2", "8x4"])
def warp_shape(request, monkeypatch):
    monkeypatch.setattr(gb, "WARP_SHAPE", request.param)
    monkeypatch.setattr(kb, "WARP_SHAPE", request.param)
    return request.param


@pytest.mark.parametrize("scene", K1_SCENES)
def test_plain_k1_is_bitwise_unchanged_by_the_cull(warp_shape, scene):
    _, prep, args, kw = _scene(**K1_SCENES[scene])
    k1 = (*args, prep.depth.contiguous())
    n = {}
    *ref, evaluations, _ = gb.blend_global_forward_plain(
        *k1, **kw, count_evaluations=True, warp_counts=n)
    got = gb.blend_global_forward_plain(*k1, **kw, footprint_cull=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert 0 < n["warp_pairs_kept"] < n["warp_pairs"]
    assert 0 < n["evaluations_kept"] < evaluations
    if scene == "deep_32x32":
        assert int((args[2] - args[1]).min()) > 2 * 256


def _stop_steps(args, final_t, n_contrib, kw):
    """Per tile, [256] the segment position at which each pixel of K1
    stopped (-1 where it did not): the first pair after its last blended
    one that passes the alpha test (its T then stays, so the pair takes T
    below 1e-4); checked against T."""
    point_list, starts, ends, xy, co, _ = args
    gx, gy = kw["grid_x"], kw["grid_y"]
    nc = gb.pack_image(n_contrib, gx, gy)
    ft = gb.pack_image(final_t, gx, gy)
    inside = gb.pack_image(torch.ones_like(final_t, dtype=torch.bool), gx, gy)
    out = []
    for tile in range(gx * gy):
        s, e = int(starts[tile]), int(ends[tile])
        gid = point_list[s:e].to(torch.int64)
        origin = torch.tensor([[(tile % gx) * TILE_X, (tile // gx) * TILE_X]],
                              dtype=torch.float32).expand(e - s, 2)
        power, alpha = _alpha(xy[gid], co[gid], origin)
        after = ((power >= 0.0) & (alpha >= ALPHA_THRESHOLD)
                 & (torch.arange(e - s)[:, None] >= nc[tile]) & inside[tile])
        first = torch.where(after.any(dim=0), after.int().argmax(dim=0), -1)
        hit = first >= 0
        a = alpha[first.clamp(min=0), torch.arange(256)]
        assert bool((ft[tile] * (1.0 - a) < T_THRESHOLD)[hit].all())
        out.append(first)
    return torch.stack(out)


@pytest.mark.parametrize("scene", K1_SCENES)
def test_plain_k1_never_culls_a_step_at_which_a_pixel_stops(warp_shape, scene):
    # K1 sets done only after a pair passes the alpha test, and the
    # footprint test keeps every warp where a pixel passes: so a pixel's stop
    # step is always kept, and the cull cannot move where a pixel stops.
    _, prep, args, kw = _scene(**K1_SCENES[scene])
    _, final_t, n_contrib, _ = gb.blend_global_forward_plain(
        *args, prep.depth.contiguous(), **kw)
    stops = _stop_steps(args, final_t, n_contrib, kw)          # [T, 256]
    point_list, starts, _, xy, co, _ = args
    warp_of = torch.empty(256, dtype=torch.int64)
    warp_of[fp.thread_pixels(warp_shape)] = torch.arange(256) // 32
    hit = stops >= 0
    tile, pixel = torch.nonzero(hit, as_tuple=True)
    gid = point_list[starts.to(torch.int64)[tile] + stops[hit]].to(torch.int64)
    origin = fp.tile_origins(kw["grid_x"], stops.shape[0], "cpu")[tile]
    masks = fp.warp_footprint_mask(xy[gid], co[gid], origin, warp_shape)
    kept = ((masks >> warp_of[pixel]) & 1) != 0
    assert int(hit.sum()) > 0
    assert bool(kept.all())


def test_plain_k1_off_image_pixels_change_no_output():
    # The 70x45 image over its whole 80x48 tile grid: there no pixel is off
    # the image and every pixel blends; cropped, the same bits.
    _, prep, args, kw = _scene()
    k1 = (*args, prep.depth.contiguous())
    got = gb.blend_global_forward_plain(*k1, **kw)
    grid = dict(kw, width=TILE_X * kw["grid_x"], height=TILE_X * kw["grid_y"])
    whole = gb.blend_global_forward_plain(*k1, **grid)
    for a, b in zip(got, whole):
        assert torch.equal(a, b[..., :kw["height"], :kw["width"]])
    n_whole = whole[2]
    assert bool((n_whole[kw["height"]:] > 0).any())
    assert bool((n_whole[:, kw["width"]:] > 0).any())


def test_plain_k2_is_bitwise_unchanged_by_the_cull(warp_shape):
    cam, prep, args, kw = _scene()
    color, final_t, n_contrib, _ = gb.blend_global_forward_plain(
        *args, prep.depth.contiguous(), **kw)
    bwd = (*args, color, final_t, n_contrib, *_cotangents(70, 45))
    n = {}
    ref = gb.blend_global_backward_plain(*bwd, **kw, warp_counts=n)
    got = gb.blend_global_backward_plain(*bwd, **kw, footprint_cull=True)
    assert torch.equal(got, ref)
    assert 0 < n["warp_pairs_kept"] < n["warp_pairs"]


@pytest.mark.parametrize("k", [1, 4, 24])
def test_plain_k3_is_bitwise_unchanged_by_the_cull(warp_shape, k):
    cam, prep, args, kw = _scene()
    kargs = (*args, prep.cov3d_inv9.contiguous(),
             cam.inv_viewprojmatrix.contiguous(), cam.campos.contiguous())
    *ref, n = kb.blend_kbuffer_forward_plain(*kargs, k=k, **kw,
                                             count_evaluations=True)
    got = kb.blend_kbuffer_forward_plain(*kargs, k=k, **kw,
                                         footprint_cull=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert 0 < n["warp_pairs_kept"] < n["warp_pairs"]
    assert n["chunk_max_passes"] <= n["warp_pass_steps"]


def test_warp_tree_sum_follows_the_warp_shape():
    v = torch.tensor(np.random.default_rng(0).standard_normal((3, 256)),
                     dtype=torch.float32)
    rows = gb._warp_tree_sum(v, (16, 2))
    quads = gb._warp_tree_sum(v, (8, 4))
    # 8x4 warps: lane l of warp w is pixel (8 (w % 2) + l % 8, 4 (w // 2) + l // 8).
    img = v.reshape(3, 16, 16)
    by_hand = torch.stack([img[:, 4 * (w // 2):4 * (w // 2) + 4,
                               8 * (w % 2):8 * (w % 2) + 8].reshape(3, 32)
                           for w in range(8)], dim=1)
    ref = gb._warp_tree_sum(by_hand.reshape(3, 256), (16, 2))
    assert torch.equal(quads, ref)
    torch.testing.assert_close(rows, quads, rtol=1e-5, atol=1e-5)


def _source_shape(name):
    src = (CSRC / f"{name}.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {c} = (\d+);", src).group(1))
                 for c in ("kWarpW", "kWarpH"))


@pytest.mark.parametrize("module,source", [(gb, "global_blend_fwd"),
                                           (gb, "global_blend_bwd"),
                                           (kb, "kbuffer_blend_fwd")],
                         ids=["K1", "K2", "K3"])
def test_python_constants_name_the_kernels(module, source):
    assert module.WARP_SHAPE == _source_shape(source)
    assert module.WARP_SHAPE in fp.SHAPES
