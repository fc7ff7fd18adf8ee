"""The port's GLOBAL blend (plain PyTorch version of kernel K1) against the
JAX package's Pallas kernel in interpret mode, on the CPU.

Both sides run their own ``render_tiled`` on one numpy-drawn scene.
Tolerances: color and final_T within atol 1e-4 — JAX's own kernel-against-
oracle tests allow 2e-5..5e-5, and here JAX's log-space prefix product is
held against a sequential product; n_contrib equal on at least 99.9% of the
pixels (a pair at the 1/255 or 1e-4 threshold may fall either way).

The CUDA kernel itself builds and runs only on a GPU; ``chip_smoke.py`` holds
it against this plain version there.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu.config import GlobalSortOrder as JOrder
from stopthepop_tpu.render.pipeline import render_tiled as jax_render_tiled
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess
from stopthepop_tpu.utils.testing import bucket_pair_capacity

from stopthepop_tpu_torch.config import GlobalSortOrder
from stopthepop_tpu_torch.kernels import build
from stopthepop_tpu_torch.kernels.global_blend import (
    blend_global_forward,
    blend_global_forward_plain,
    unpack_image,
)
from stopthepop_tpu_torch.render.duplicate import build_pairs
from stopthepop_tpu_torch.render.pipeline import render_tiled, tile_grid
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

BG = (0.2, 0.3, 0.1)


def _prep_kw(scene, cam, w, h, order, cull):
    return dict(
        scales=scene.scales, rotations=scene.rotations, shs=scene.shs,
        viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        campos=cam.campos, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        image_width=w, image_height=h, sh_degree=3, sort_order=order,
        rect_bounding=cull, tight_opacity_bounding=cull,
    )


@pytest.mark.parametrize("cull", [False, True], ids=["nocull", "cull"])
@pytest.mark.parametrize("order", [GlobalSortOrder.Z_DEPTH, GlobalSortOrder.DISTANCE],
                         ids=["zdepth", "distance"])
@pytest.mark.parametrize("size", [(64, 64), (80, 48), (70, 45)],
                         ids=["64x64", "80x48", "70x45"])
def test_render_tiled_matches_jax(size, order, cull):
    w, h = size
    scene = random_scene(2, 300, device="cpu")
    cam = make_camera(w, h, device="cpu")
    kw = _prep_kw(scene, cam, w, h, order, cull)
    prep = preprocess(scene.means3d, scene.opacities, **kw)
    color, final_t, n_contrib, pairs, _ = render_tiled(
        prep, torch.tensor(BG), image_width=w, image_height=h, sort_order=order,
    )

    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    jkw["sort_order"] = JOrder(int(order))
    jprep = jax_preprocess(jnp.asarray(scene.means3d.numpy()),
                           jnp.asarray(scene.opacities.numpy()), **jkw)
    jcolor, jfinal_t, jn, jpairs, _ = jax_render_tiled(
        jprep, jnp.asarray(BG), image_width=w, image_height=h,
        capacity=bucket_pair_capacity(jprep), sort_order=JOrder(int(order)),
        interpret=True,
    )
    assert not bool(jpairs.overflow)
    assert color.shape == (3, h, w) and final_t.shape == (h, w)
    np.testing.assert_allclose(color.numpy(), np.asarray(jcolor), atol=1e-4, rtol=0)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(jfinal_t), atol=1e-4, rtol=0)
    same = (n_contrib.numpy() == np.asarray(jn)).mean()
    assert same >= 0.999, same
    assert pairs.num_rendered > 0 and (final_t < 1).any()


def _small_inputs(w=40, h=24, seed=4):
    scene = random_scene(seed, 120, device="cpu")
    cam = make_camera(w, h, device="cpu")
    prep = preprocess(scene.means3d, scene.opacities,
                      **_prep_kw(scene, cam, w, h, GlobalSortOrder.Z_DEPTH, True))
    gx, gy = tile_grid(w, h)
    pairs = build_pairs(prep, grid_x=gx, grid_y=gy)
    args = (pairs.gauss_id, pairs.starts, pairs.ends, prep.mean2d,
            prep.conic_opacity, prep.rgb, prep.depth.contiguous())
    return args, dict(grid_x=gx, grid_y=gy, width=w, height=h)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    args, kw = _small_inputs()
    before = blend_global_forward.launches
    out = blend_global_forward(*args, **kw)
    ref = blend_global_forward_plain(*args, **kw)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert blend_global_forward.launches == before
    color, final_t, n_contrib, depth_acc = out
    assert n_contrib.dtype == torch.int32
    assert ((final_t > 0) & (final_t <= 1)).all()
    assert (depth_acc >= 0).all() and (depth_acc > 0).any()


def test_plain_version_counts_evaluations():
    args, kw = _small_inputs()
    *out, evaluations, blends = blend_global_forward_plain(
        *args, **kw, count_evaluations=True)
    counts = (args[2] - args[1]).long()
    assert 0 < blends <= evaluations <= int(counts.sum()) * 256
    assert blends >= int(out[2].clamp(max=1).sum())


def test_wrapper_checks_inputs():
    args, kw = _small_inputs()
    point_list, starts, ends, xy, co, rgb, depth = args
    with pytest.raises(TypeError, match="starts"):
        blend_global_forward(point_list, starts.long(), ends, xy, co, rgb, depth, **kw)
    with pytest.raises(ValueError, match="conic_opacity"):
        blend_global_forward(point_list, starts, ends, xy, co[:, :3], rgb, depth, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        blend_global_forward(point_list, starts, ends, xy,
                             co.T.contiguous().T, rgb, depth, **kw)
    with pytest.raises(ValueError, match="does not tile"):
        blend_global_forward(*args, **{**kw, "width": kw["width"] + 16})


def test_empty_segments_give_background():
    args, kw = _small_inputs()
    empty = torch.zeros(0, dtype=torch.int32)
    zeros = torch.zeros_like(args[1])
    color, final_t, n_contrib, _ = blend_global_forward(
        empty, zeros, zeros, *args[3:], **kw)
    assert (color == 0).all() and (final_t == 1).all() and (n_contrib == 0).all()


def test_unpack_image_crops_row_major_tiles():
    gx, gy, w, h = 3, 2, 40, 20
    tiles = torch.arange(gx * gy * 256, dtype=torch.float32).reshape(gx * gy, 256)
    img = unpack_image(tiles, gx, gy, w, h)
    assert img.shape == (h, w)
    for y, x in ((0, 0), (5, 17), (19, 39), (16, 33)):
        t = (y // 16) * gx + x // 16
        assert img[y, x] == tiles[t, (y % 16) * 16 + x % 16]


def test_kernel_library_is_keyed_by_source_hash():
    # Naming only: the build itself needs nvcc and runs on the GPU machine.
    path = build.library_path("global_blend_fwd")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("global_blend_fwd-") and path.suffix == ".so"
    assert build.all_sources() == ["full_blend_fwd", "global_blend_bwd",
                                   "global_blend_fwd",
                                   "hier_blend_bwd", "hier_blend_bwd_batched",
                                   "hier_blend_fwd", "hier_blend_fwd_batched",
                                   "kbuffer_blend_bwd", "kbuffer_blend_fwd",
                                   "pairs", "preprocess_fwd"]


def test_batched_library_is_keyed_by_the_source_it_includes(tmp_path,
                                                            monkeypatch):
    # hier_blend_fwd_batched.cu includes hier_blend_fwd.cu: an edit of the
    # per-entry source renames both libraries, and of no other kernel.
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("hier_blend_fwd", "hier_blend_fwd_batched", "hier_blend_bwd")
    before = {n: build.library_path(n) for n in names}
    with open(csrc / "hier_blend_fwd.cu", "a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert after["hier_blend_fwd"] != before["hier_blend_fwd"]
    assert after["hier_blend_fwd_batched"] != before["hier_blend_fwd_batched"]
    assert after["hier_blend_bwd"] == before["hier_blend_bwd"]
