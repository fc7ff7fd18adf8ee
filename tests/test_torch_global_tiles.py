"""GLOBAL binning tiles whose sides are not multiples of 16 (the port's
piece table) against the JAX package, on the CPU.

The port cuts each binning tile, from its own origin, into pieces of at
most 16x16 pixels (``kernels/global_blend.py::binning_pieces``); the plain
K1 and K2 take the piece table. Held here:

- GLOBAL ``render_tiled`` at 24x16, 8x8 and 20x12 on a 56x40 image against
  JAX ``render_tiled`` at the same bin (its Pallas kernels in interpret
  mode, as tests/test_tile_shape.py runs them): image, final T at the
  GLOBAL tolerance 1e-4, n_contrib exactly; and the same renders bitwise
  the port's 16x16 render (tight-opacity bounding: every pixel blends the
  same pairs in the same order);
- the 8 API gradients at 24x16 against the JAX package's (its torch front
  end, which differentiates with ``jax.grad``) at rtol 1e-3, atol 1e-4 of
  each gradient's largest value (tests/test_torch_tile_shape.py's);
- the plain K2's planes at 20x12, summed, against autograd through the
  plain K1;
- the piece table: at 16x16, 32x16 and 32x32 the blend tiles, sub-tile map
  and plane count of the 16x16 grid (the split before the piece table, its
  formula written out here); at 24x16 the pieces' origins, extents and
  planes;
- the training CLI in GLOBAL with ``--tile 24x16``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu import torch_compat as tc
from stopthepop_tpu.render.pipeline import render_tiled as jax_render_tiled

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.kernels import global_blend as gb
from stopthepop_tpu_torch.kernels.blend_vjp import reduce_pair_grads, sum_planes
from stopthepop_tpu_torch.render.duplicate import build_pairs
from stopthepop_tpu_torch.kernels.global_blend import binning_pieces
from stopthepop_tpu_torch.render.pipeline import (
    render_tiled,
    split_binning_segments,
    tile_grid,
)
from stopthepop_tpu_torch.train import cli
from stopthepop_tpu_torch.utils.synthetic import (
    structured_scene,
    write_nerf_synthetic,
)
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

from test_torch_tile_shape import BG, _assert_grads_close, _preps, _settings

one_thread_under_xdist()

W, H = 56, 40
TILES = [(24, 16), (8, 8), (20, 12)]


def _render(t, tile):
    with torch.no_grad():
        return render_tiled(t, torch.from_numpy(BG), image_width=W,
                            image_height=H, tile_x=tile[0], tile_y=tile[1])


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_global_matches_jax_render_tiled(tile):
    t, jp, _, _ = _preps(W, H, tile, n=200, seed=2)
    img, T, n_contrib, pairs, _ = _render(t, tile)
    jimg, jT, jn, jpairs, _ = jax_render_tiled(
        jp, jnp.asarray(BG), image_width=W, image_height=H,
        capacity=pairs.num_rendered + 128, tile_x=tile[0], tile_y=tile[1],
        interpret=True)
    assert not bool(jpairs.overflow)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_array_equal(n_contrib.numpy(), np.asarray(jn))
    # The binning tile changes which pairs exist, not what is blended.
    t16, _, _, _ = _preps(W, H, (16, 16), n=200, seed=2)
    img16, T16, _, _, _ = _render(t16, (16, 16))
    bins = tile_grid(W, H, *tile)
    assert pairs.starts.shape == (bins[0] * bins[1],)
    torch.testing.assert_close(img, img16, rtol=0, atol=0)
    torch.testing.assert_close(T, T16, rtol=0, atol=0)


def test_api_gradients_match_jax_at_24x16():
    scene = random_scene(8, 60, device="cpu")
    cam = make_camera(W, H, device="cpu")
    weights = torch.from_numpy(
        np.random.default_rng(3).standard_normal((3, H, W)).astype(np.float32))
    inputs = dict(means3D=scene.means3d, means2D=torch.zeros((60, 3)),
                  opacities=scene.opacities[:, None], shs=scene.shs,
                  scales=scene.scales, rotations=scene.rotations)

    def run(rasterizer):
        leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
        color, radii = rasterizer(**leaves)
        (color * weights).sum().backward()
        return color.detach(), radii, {k: v.grad for k, v in leaves.items()}

    port = stt.GaussianRasterizer(_settings(stt, cam, torch.as_tensor),
                                  tile_shape=(24, 16))
    ref = tc.GaussianRasterizer(_settings(tc, cam, torch.as_tensor),
                                interpret=True, tile_shape=(24, 16))
    color, radii, grads = run(port)
    rcolor, rradii, rgrads = run(ref)
    np.testing.assert_allclose(color.numpy(), rcolor.numpy(), atol=1e-4)
    np.testing.assert_array_equal(radii.numpy(), rradii.numpy())
    assert grads["means2D"].abs().max() > 0
    _assert_grads_close(grads, rgrads, list(inputs))


def test_plain_piece_planes_match_autograd():
    # 20x12 bins: two pieces a bin across (16 and 4 pixels wide), the last
    # row of bins cut by the image's bottom edge.
    tile = (20, 12)
    t, _, _, cam = _preps(W, H, tile, n=150, seed=8, scale_range=(0.05, 0.3))
    gx, gy = tile_grid(W, H, *tile)
    pairs = build_pairs(t, grid_x=gx, grid_y=gy, tile_x=tile[0],
                        tile_y=tile[1], image_width=W, image_height=H)
    segs = split_binning_segments(pairs.starts, pairs.ends, W, H, *tile)
    assert segs.num_sub == 2 and segs.pieces.shape == (20, 4)
    rows = [x.detach().clone().requires_grad_(True)
            for x in (t.mean2d, t.conic_opacity, t.rgb)]
    kw = dict(grid_x=4, grid_y=3, width=W, height=H, pieces=segs.pieces)
    g_color = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, H, W)).astype(np.float32))
    g_t = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (H, W)).astype(np.float32))
    color, final_t, n_contrib, _ = gb.blend_global_forward_plain(
        pairs.gauss_id, segs.starts, segs.ends, *rows, t.depth.detach(), **kw)
    expect = torch.autograd.grad(
        (color * g_color).sum() + (final_t * g_t).sum(), rows)
    planes = gb.blend_global_backward(
        pairs.gauss_id, segs.starts, segs.ends, *(r.detach() for r in rows),
        color.detach(), final_t.detach(), n_contrib, g_color, g_t, **kw,
        sub_tile=segs.sub_tile, num_sub=segs.num_sub)
    assert planes.shape == (2, pairs.num_rendered, 9)
    assert (planes[0] != 0).any() and (planes[1] != 0).any()
    d = reduce_pair_grads(sum_planes(planes), pairs.orig_slot,
                          pairs.gauss_offsets)
    for name, got, ref in zip(("xy", "conic_opacity", "rgb"),
                              (d[:, 0:2], d[:, 2:6], d[:, 6:9]), expect):
        scale = ref.abs().amax(dim=0)
        assert (scale > 0).all(), name
        assert ((got - ref).abs() <= 1e-5 * scale).all(), name


def _grid_split(width, height, sx, sy):
    """The split of (16 sx) x (16 sy) binning tiles over the 16x16 grid
    before the piece table: each blend tile's parent and plane."""
    gx, gy = tile_grid(width, height)
    bin_gx = (gx + sx - 1) // sx
    bx = torch.arange(gx)
    by = torch.arange(gy)[:, None]
    parent = ((by // sy) * bin_gx + bx // sx).reshape(-1)
    sub = ((bx % sx) + sx * (by % sy)).reshape(-1).to(torch.int32)
    return parent, sub


@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (32, 32)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_piece_table_at_multiples_of_16_is_the_grid(tile):
    w, h = 80, 45   # odd 16x16 width, a cut last row
    parent, plane, pieces = binning_pieces(w, h, *tile, "cpu")
    ref_parent, ref_sub = _grid_split(w, h, tile[0] // 16, tile[1] // 16)
    assert torch.equal(parent, ref_parent) and torch.equal(plane, ref_sub)
    gx, gy = tile_grid(w, h)
    t = torch.arange(gx * gy)
    grid = torch.stack([(t % gx) * 16, (t // gx) * 16,
                        torch.full_like(t, 16), torch.full_like(t, 16)], 1)
    assert pieces.dtype == torch.int32 and torch.equal(pieces.long(), grid)
    n_bins = tile_grid(w, h, *tile)
    starts = torch.arange(n_bins[0] * n_bins[1], dtype=torch.int32) * 10
    segs = split_binning_segments(starts, starts + 7, w, h, *tile)
    assert torch.equal(segs.pieces, pieces)
    assert segs.num_sub == (tile[0] // 16) * (tile[1] // 16)
    assert torch.equal(segs.starts, starts[ref_parent])
    assert torch.equal(segs.ends, starts[ref_parent] + 7)
    if tile == (16, 16):
        assert segs.sub_tile is None
    else:
        assert torch.equal(segs.sub_tile, ref_sub)


def test_piece_table_at_24x16():
    parent, plane, pieces = binning_pieces(W, H, 24, 16, "cpu")
    # Three bins across (0, 24, 48), each a 16- and an 8-wide piece; the
    # third bin's second piece (x0 = 64) lies off the image.
    row = [[0, 0, 16, 16], [16, 0, 8, 16], [24, 0, 16, 16], [40, 0, 8, 16],
           [48, 0, 16, 16]]
    assert pieces[:5].tolist() == row
    assert plane[:5].tolist() == [0, 1, 0, 1, 0]
    assert parent[:5].tolist() == [0, 0, 1, 1, 2]
    assert pieces.shape == (15, 4) and parent[-1] == 8
    # Every pixel of the image lies in exactly one piece.
    cover = torch.zeros(H, W, dtype=torch.int32)
    for x0, y0, w, h in pieces.tolist():
        cover[y0:y0 + h, x0:x0 + w] += 1
    assert (cover == 1).all()


def test_train_cli_takes_any_global_tile(tmp_path, monkeypatch):
    gt, _ = structured_scene(200, 0, device="cpu")
    write_nerf_synthetic(str(tmp_path), gt, views=2, size=32, device="cpu")
    seen = []
    real = cli.make_train_step

    def spy(**kw):
        seen.append(kw["render_kwargs"]["tile_shape"])
        return real(**kw)

    monkeypatch.setattr(cli, "make_train_step", spy)
    res = cli.main(["--data", str(tmp_path), "--iters", "2",
                    "--init-points", "80", "--eval-every", "2",
                    "--densify-from", "100", "--sort-mode", "GLOBAL",
                    "--tile", "24x16", "--device", "cpu"])
    assert seen == [(24, 16)]
    assert res.state.step == 2 and np.isfinite(res.eval_psnr[2])
