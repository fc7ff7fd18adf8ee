"""The port's pair expansion and sort against the JAX package's, on the CPU.

Each side preprocesses the same numpy-drawn scene; the per-tile ordered
Gaussian id lists must be equal exactly (JAX's invalid slots stripped), with
and without tile_based_culling, under the Z_DEPTH, DISTANCE and per-tile-depth
(PTD_CENTER, PTD_MAX) stream orders. The sort permutation ``orig_slot`` must invert
the sort, and the Gaussian-major run offsets must bound each Gaussian's run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu.config import GlobalSortOrder as JOrder
from stopthepop_tpu.render.duplicate import build_pairs as jax_build_pairs
from stopthepop_tpu.render.duplicate import rect_histogram as jax_rect_histogram
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess

from stopthepop_tpu_torch.config import GlobalSortOrder
from stopthepop_tpu_torch.ops.sort import sort_pairs
from stopthepop_tpu_torch.render.duplicate import (
    build_pairs,
    count_pairs,
    expand_pairs,
    rect_histogram,
    sort_expanded,
)
from stopthepop_tpu_torch.render.pipeline import tile_grid
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()


def _preps(w, h, order, cull, seed=11, n=250):
    scene = random_scene(seed, n, device="cpu")
    cam = make_camera(w, h, device="cpu")
    kw = dict(tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, image_width=w,
              image_height=h, sh_degree=3, rect_bounding=cull,
              tight_opacity_bounding=cull)
    t = preprocess(scene.means3d, scene.opacities, scales=scene.scales,
                   rotations=scene.rotations, shs=scene.shs,
                   viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
                   campos=cam.campos, sort_order=order, **kw)
    j = jax_preprocess(
        *(jnp.asarray(x.numpy()) for x in (scene.means3d, scene.opacities)),
        scales=jnp.asarray(scene.scales.numpy()),
        rotations=jnp.asarray(scene.rotations.numpy()),
        shs=jnp.asarray(scene.shs.numpy()),
        viewmatrix=jnp.asarray(cam.viewmatrix.numpy()),
        projmatrix=jnp.asarray(cam.projmatrix.numpy()),
        campos=jnp.asarray(cam.campos.numpy()), sort_order=JOrder(int(order)),
        **kw,
    )
    return t, j


@pytest.mark.parametrize("order", [GlobalSortOrder.Z_DEPTH, GlobalSortOrder.DISTANCE])
@pytest.mark.parametrize("size,cull", [((64, 64), False), ((70, 45), True)])
def test_per_tile_id_lists_match_jax(order, size, cull):
    w, h = size
    gx, gy = tile_grid(w, h)
    t, j = _preps(w, h, order, cull)
    pairs = build_pairs(t, grid_x=gx, grid_y=gy, sort_order=order)
    total = int(count_pairs(t))
    assert pairs.num_rendered == total > 0
    jp = jax_build_pairs(j, capacity=total + 64, grid_x=gx, grid_y=gy,
                         sort_order=JOrder(int(order)))
    jstarts, jends = np.asarray(jp.starts), np.asarray(jp.ends)
    jgid = np.asarray(jp.gauss_id)
    starts, ends = pairs.starts.numpy(), pairs.ends.numpy()
    gid = pairs.gauss_id.numpy()
    for tile in range(gx * gy):
        np.testing.assert_array_equal(
            gid[starts[tile]:ends[tile]], jgid[jstarts[tile]:jends[tile]],
            err_msg=f"tile {tile}",
        )
    # Sorted by tile, then depth; ranges cover exactly their tile.
    tid = pairs.tile_id.numpy()
    assert (np.diff(tid) >= 0).all()
    for tile in range(gx * gy):
        seg = pairs.depth.numpy()[starts[tile]:ends[tile]]
        assert (tid[starts[tile]:ends[tile]] == tile).all()
        assert (np.diff(seg) >= 0).all()
    np.testing.assert_array_equal(ends - starts,
                                  rect_histogram(t, gx, gy).numpy())


@pytest.mark.parametrize("order", [GlobalSortOrder.Z_DEPTH, GlobalSortOrder.DISTANCE])
@pytest.mark.parametrize("size", [(64, 64), (70, 45)])
def test_tile_culled_id_lists_match_jax(order, size):
    w, h = size
    gx, gy = tile_grid(w, h)
    t, j = _preps(w, h, order, True)
    pairs = build_pairs(t, grid_x=gx, grid_y=gy, sort_order=order,
                        tile_based_culling=True)
    total = int(count_pairs(t))
    assert 0 < pairs.num_rendered < total  # the culling dropped some pairs
    jp = jax_build_pairs(j, capacity=total + 64, grid_x=gx, grid_y=gy,
                         sort_order=JOrder(int(order)), tile_based_culling=True)
    jstarts, jends = np.asarray(jp.starts), np.asarray(jp.ends)
    jgid, jvalid = np.asarray(jp.gauss_id), np.asarray(jp.valid)
    starts, ends = pairs.starts.numpy(), pairs.ends.numpy()
    gid = pairs.gauss_id.numpy()
    for tile in range(gx * gy):
        seg = slice(jstarts[tile], jends[tile])
        np.testing.assert_array_equal(
            gid[starts[tile]:ends[tile]], jgid[seg][jvalid[seg]],
            err_msg=f"tile {tile}",
        )
    assert pairs.num_rendered == int(jvalid.sum())


@pytest.mark.parametrize("cull", [False, True], ids=["rect", "tilecull"])
def test_orig_slot_inverts_the_sort(cull):
    t, _ = _preps(70, 45, GlobalSortOrder.Z_DEPTH, True)
    gx, gy = tile_grid(70, 45)
    tile_id, depth, gid = expand_pairs(t, grid_x=gx, tile_based_culling=cull)
    pairs = build_pairs(t, grid_x=gx, grid_y=gy, tile_based_culling=cull)
    order = pairs.orig_slot
    assert order.dtype == torch.int64
    assert torch.equal(torch.sort(order).values,
                       torch.arange(pairs.num_rendered))
    assert torch.equal(tile_id[order], pairs.tile_id)
    assert torch.equal(gid[order], pairs.gauss_id)
    assert torch.equal(depth[order], pairs.depth)
    # Unsorting lays each Gaussian's pairs out as one contiguous run.
    unsorted = torch.empty_like(pairs.gauss_id)
    unsorted[order] = pairs.gauss_id
    off = pairs.gauss_offsets
    assert off.shape == (t.tiles_touched.shape[0] + 1,)
    assert int(off[-1]) == pairs.num_rendered
    for g in range(off.shape[0] - 1):
        assert (unsorted[off[g]:off[g + 1]] == g).all()


def test_expanded_stream_matches_bruteforce():
    t, _ = _preps(80, 48, GlobalSortOrder.Z_DEPTH, True)
    gx, _ = tile_grid(80, 48)
    tile_id, depth, gid = expand_pairs(t, grid_x=gx)
    expected = []
    for g in range(t.valid.shape[0]):
        if not t.valid[g]:
            continue
        (x0, y0), (x1, y1) = t.rect_min[g].tolist(), t.rect_max[g].tolist()
        expected += [(ty * gx + tx, g) for ty in range(y0, y1) for tx in range(x0, x1)]
    assert list(zip(tile_id.tolist(), gid.tolist())) == expected
    torch.testing.assert_close(depth, t.depth[gid.long()], rtol=0, atol=0)


@pytest.mark.parametrize("cull", [False, True])
def test_rect_histogram_matches_jax(cull):
    t, j = _preps(70, 45, GlobalSortOrder.Z_DEPTH, cull)
    gx, gy = tile_grid(70, 45)
    np.testing.assert_array_equal(rect_histogram(t, gx, gy).numpy(),
                                  np.asarray(jax_rect_histogram(j, gx, gy)))


@pytest.mark.parametrize("order", [GlobalSortOrder.PTD_CENTER, GlobalSortOrder.PTD_MAX])
@pytest.mark.parametrize("size,cull", [((64, 64), False), ((70, 45), True)])
def test_per_tile_depth_id_lists_match_jax(order, size, cull):
    w, h = size
    gx, gy = tile_grid(w, h)
    t, j = _preps(w, h, order, True, seed=13)
    cam = make_camera(w, h, device="cpu")
    pairs = build_pairs(t, grid_x=gx, grid_y=gy, sort_order=order,
                        tile_based_culling=cull, campos=cam.campos,
                        inverse_vp=cam.inv_viewprojmatrix, image_width=w,
                        image_height=h)
    total = int(count_pairs(t))
    jp = jax_build_pairs(j, capacity=total + 64, grid_x=gx, grid_y=gy,
                         sort_order=JOrder(int(order)), tile_based_culling=cull,
                         campos=jnp.asarray(cam.campos.numpy()),
                         inverse_vp=jnp.asarray(cam.inv_viewprojmatrix.numpy()),
                         image_width=w, image_height=h)
    jstarts, jends = np.asarray(jp.starts), np.asarray(jp.ends)
    jgid, jvalid = np.asarray(jp.gauss_id), np.asarray(jp.valid)
    starts, ends = pairs.starts.numpy(), pairs.ends.numpy()
    gid = pairs.gauss_id.numpy()
    depth = pairs.depth.numpy()
    for tile in range(gx * gy):
        seg = slice(jstarts[tile], jends[tile])
        np.testing.assert_array_equal(
            gid[starts[tile]:ends[tile]], jgid[seg][jvalid[seg]],
            err_msg=f"tile {tile}",
        )
        assert (np.diff(depth[starts[tile]:ends[tile]]) >= 0).all()
    assert pairs.num_rendered == int(jvalid.sum()) > 0
    assert (depth >= 0).all()
    # Per-tile keys: the same Gaussian takes different depths in different
    # tiles, unlike under Z_DEPTH.
    g0 = int(np.bincount(gid).argmax())
    assert len(np.unique(depth[gid == g0])) > 1


def test_per_tile_depth_orders_raise():
    # The per-tile-depth orders need the camera and the image size.
    t, _ = _preps(32, 32, GlobalSortOrder.Z_DEPTH, False, n=20)
    cam = make_camera(32, 32, device="cpu")
    for order in (GlobalSortOrder.PTD_CENTER, GlobalSortOrder.PTD_MAX):
        with pytest.raises(ValueError, match="campos, inverse_vp"):
            build_pairs(t, grid_x=2, grid_y=2, sort_order=order)
        with pytest.raises(ValueError, match="campos, inverse_vp"):
            build_pairs(t, grid_x=2, grid_y=2, sort_order=order,
                        campos=cam.campos, image_width=32, image_height=32)


def test_sort_key_ties_negative_zero_with_zero():
    # A per-tile depth clamped at 0 may come out as -0.0; it sorts as 0.0
    # (stable by stream order), not past every positive depth.
    tiles = torch.tensor([1, 0, 0, 0, 1], dtype=torch.int32)
    depths = torch.tensor([-0.0, 2.0, -0.0, 0.0, 1.0])
    ids = torch.arange(5, dtype=torch.int32)
    s_tile, _, s_ids, _ = sort_pairs(tiles, depths, ids)
    assert s_tile.tolist() == [0, 0, 0, 1, 1]
    assert s_ids.tolist() == [2, 3, 1, 0, 4]


def test_empty_stream():
    t, _ = _preps(32, 32, GlobalSortOrder.Z_DEPTH, False, n=20)
    t = t._replace(tiles_touched=torch.zeros_like(t.tiles_touched))
    pairs = build_pairs(t, grid_x=2, grid_y=2)
    assert pairs.num_rendered == 0
    assert (pairs.starts == pairs.ends).all()


def test_run_offsets_count_each_gaussians_pairs():
    # A Gaussian-major stream in which Gaussians 0, 2 and 5 have no pair.
    gid = torch.tensor([1, 1, 1, 3, 4, 4], dtype=torch.int32)
    tiles = torch.tensor([2, 0, 1, 1, 0, 2], dtype=torch.int32)
    depths = torch.tensor([0.5, 0.5, 0.5, 0.2, 0.9, 0.9])
    pairs = sort_expanded(tiles, depths, gid, num_tiles=3, num_gaussians=6)
    runs = torch.bincount(gid.to(torch.int64), minlength=6)
    assert pairs.gauss_offsets.dtype == torch.int64
    assert pairs.gauss_offsets.tolist() == [0, 0, 3, 3, 4, 6, 6]
    assert torch.equal(pairs.gauss_offsets[1:] - pairs.gauss_offsets[:-1],
                       runs)
    empty = sort_expanded(tiles[:0], depths[:0], gid[:0], num_tiles=3,
                          num_gaussians=4)
    assert empty.gauss_offsets.tolist() == [0] * 5
