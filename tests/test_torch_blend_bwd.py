"""The port's GLOBAL blend backward (plain PyTorch version of kernel K2 and the
``BlendGlobal`` autograd Function) on the CPU.

- The plain K2, reduced per Gaussian, against autograd through the plain K1:
  the same arithmetic summed in another order, so rtol 1e-5 with an atol of
  1e-6 of each column's largest value.
- ``render_tiled``'s gradients with respect to the per-Gaussian rows
  (mean2d, conic_opacity, rgb) against the JAX package's ``render_tiled``
  VJP (its Pallas kernels in interpret mode) on the same preprocess output,
  at the tolerance of tests/test_backward.py (atol 2e-4 of the largest
  value, rtol 2e-3); the background gradient at rtol 1e-4.
- Two backward passes give the same bits.

The CUDA kernel builds and runs only on a GPU; ``chip_smoke.py`` holds it
against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu.render.pipeline import render_tiled as jax_render_tiled
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess
from stopthepop_tpu.utils.testing import bucket_pair_capacity

from stopthepop_tpu_torch.kernels.blend_vjp import BlendGlobal, reduce_pair_grads
from stopthepop_tpu_torch.kernels.global_blend import (
    GRAD_COLS,
    blend_global_backward,
    blend_global_backward_plain,
    blend_global_forward_plain,
    pack_image,
    unpack_image,
)
from stopthepop_tpu_torch.render.duplicate import build_pairs
from stopthepop_tpu_torch.render.pipeline import render_tiled, tile_grid
from stopthepop_tpu_torch.render.preprocess import PreprocessOutput, preprocess
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

ROWS = ("mean2d", "conic_opacity", "rgb")


def _prep(w, h, n=120, seed=3, cull=True):
    scene = random_scene(seed, n, device="cpu")
    cam = make_camera(w, h, device="cpu")
    return preprocess(
        scene.means3d, scene.opacities, scales=scene.scales,
        rotations=scene.rotations, shs=scene.shs, viewmatrix=cam.viewmatrix,
        projmatrix=cam.projmatrix, campos=cam.campos, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, image_width=w, image_height=h, sh_degree=3,
        rect_bounding=cull, tight_opacity_bounding=cull,
    )


def _cotangents(w, h, seed=7):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal((3, h, w)), dtype=torch.float32),
            torch.tensor(rng.standard_normal((h, w)), dtype=torch.float32))


@pytest.mark.parametrize("tile_cull", [False, True], ids=["rect", "tilecull"])
@pytest.mark.parametrize("size", [(48, 40), (70, 45)], ids=["48x40", "70x45"])
def test_plain_k2_matches_autograd_through_plain_k1(size, tile_cull):
    w, h = size
    prep = _prep(w, h)
    gx, gy = tile_grid(w, h)
    pairs = build_pairs(prep, grid_x=gx, grid_y=gy,
                        tile_based_culling=tile_cull)
    kw = dict(grid_x=gx, grid_y=gy, width=w, height=h)
    rows = [getattr(prep, r).detach().clone().requires_grad_(True) for r in ROWS]
    gc, gt = _cotangents(w, h)
    color, final_t, n_contrib, _ = blend_global_forward_plain(
        pairs.gauss_id, pairs.starts, pairs.ends, *rows, prep.depth, **kw)
    ((color * gc).sum() + (final_t * gt).sum()).backward()
    ref = torch.cat([r.grad for r in rows], dim=1)

    d_pair = blend_global_backward(
        pairs.gauss_id, pairs.starts, pairs.ends, *(r.detach() for r in rows),
        color.detach(), final_t.detach(), n_contrib, gc, gt, **kw)
    assert d_pair.shape == (pairs.num_rendered, len(GRAD_COLS))
    got = reduce_pair_grads(d_pair, pairs.orig_slot, pairs.gauss_offsets)
    scale = ref.abs().amax(dim=0)
    assert (scale > 0).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6 * float(scale.max()))
    for col in range(len(GRAD_COLS)):
        np.testing.assert_allclose(got[:, col].numpy(), ref[:, col].numpy(),
                                   rtol=1e-5, atol=1e-6 * float(scale[col]),
                                   err_msg=GRAD_COLS[col])


def test_plain_k2_cuts_the_replay_at_the_last_contributor():
    w, h = 48, 40
    prep = _prep(w, h, n=200)
    gx, gy = tile_grid(w, h)
    pairs = build_pairs(prep, grid_x=gx, grid_y=gy)
    kw = dict(grid_x=gx, grid_y=gy, width=w, height=h)
    rows = [getattr(prep, r).detach() for r in ROWS]
    color, final_t, n_contrib, _ = blend_global_forward_plain(
        pairs.gauss_id, pairs.starts, pairs.ends, *rows, prep.depth, **kw)
    gc, gt = _cotangents(w, h)
    d_pair, evaluations, blends = blend_global_backward_plain(
        pairs.gauss_id, pairs.starts, pairs.ends, *rows, color, final_t,
        n_contrib, gc, gt, **kw, count_evaluations=True)
    last = pack_image(n_contrib, gx, gy).amax(dim=1)
    for tile in range(gx * gy):
        s, e = int(pairs.starts[tile]), int(pairs.ends[tile])
        assert (d_pair[s + int(last[tile]):e] == 0).all()
    assert 0 < blends <= evaluations


def test_pack_image_inverts_unpack_image():
    gx, gy, w, h = 3, 2, 40, 20
    img = torch.arange(2 * h * w, dtype=torch.float32).reshape(2, h, w)
    tiles = pack_image(img, gx, gy)
    assert tiles.shape == (2, gx * gy, 256)
    torch.testing.assert_close(unpack_image(tiles, gx, gy, w, h), img,
                               rtol=0, atol=0)
    assert tiles[:, -1, -1].eq(0).all()  # past the image edge


def _jax_prep(w, h, cull, seed=5, n=80):
    scene = random_scene(seed, n, device="cpu")
    cam = make_camera(w, h, device="cpu")
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    return jax_preprocess(
        j(scene.means3d), j(scene.opacities), scales=j(scene.scales),
        rotations=j(scene.rotations), colors_precomp=j(scene.colors),
        viewmatrix=j(cam.viewmatrix), projmatrix=j(cam.projmatrix),
        campos=j(cam.campos), tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        image_width=w, image_height=h, rect_bounding=cull,
        tight_opacity_bounding=cull,
    )


@pytest.mark.parametrize("tile_cull", [False, True], ids=["rect", "tilecull"])
def test_render_tiled_grads_match_jax_vjp(tile_cull):
    w, h = 48, 48
    jprep = _jax_prep(w, h, cull=True)
    bg = np.array([0.3, 0.1, 0.2], np.float32)
    weights = np.random.default_rng(99).standard_normal((3, h, w)).astype(np.float32)
    cap = bucket_pair_capacity(jprep)

    def jloss(mean2d, conic_opacity, rgb, jbg):
        p = jprep._replace(mean2d=mean2d, conic_opacity=conic_opacity, rgb=rgb)
        img, final_t, _, _, _ = jax_render_tiled(
            p, jbg, image_width=w, image_height=h, capacity=cap,
            tile_based_culling=tile_cull, interpret=True)
        return jnp.sum(img * weights) + 0.1 * jnp.sum(final_t)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        jprep.mean2d, jprep.conic_opacity, jprep.rgb, jnp.asarray(bg))

    fields = {k: torch.from_numpy(np.array(v)) for k, v in jprep._asdict().items()}
    leaves = {r: fields[r].clone().requires_grad_(True) for r in ROWS}
    tbg = torch.from_numpy(bg).requires_grad_(True)
    prep = PreprocessOutput(**{**fields, **leaves})
    img, final_t, _, pairs, _ = render_tiled(
        prep, tbg, image_width=w, image_height=h, tile_based_culling=tile_cull)
    loss = (img * torch.from_numpy(weights)).sum() + 0.1 * final_t.sum()
    loss.backward()
    assert pairs.num_rendered > 0
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    for name, a in zip(ROWS, jg[:3]):
        a, b = np.asarray(a), leaves[name].grad.numpy()
        assert np.isfinite(b).all(), name
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, atol=2e-4 * scale, rtol=2e-3,
                                   err_msg=f"gradient mismatch for {name}")
    np.testing.assert_allclose(tbg.grad.numpy(), np.asarray(jg[3]), rtol=1e-4)


def test_backward_is_bitwise_deterministic():
    w, h = 48, 40
    prep = _prep(w, h, n=150)
    gx, gy = tile_grid(w, h)
    pairs = build_pairs(prep, grid_x=gx, grid_y=gy, tile_based_culling=True)
    gc, gt = _cotangents(w, h, seed=11)

    def grads():
        rows = [getattr(prep, r).detach().clone().requires_grad_(True)
                for r in ROWS]
        color, final_t, _, _ = BlendGlobal.apply(
            *rows, prep.depth.detach().contiguous(), pairs, gx, gy, w, h)
        ((color * gc).sum() + (final_t * gt).sum()).backward()
        return [r.grad for r in rows]

    for a, b in zip(grads(), grads()):
        assert torch.equal(a, b)
        assert a.abs().max() > 0
