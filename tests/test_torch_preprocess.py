"""The port's preprocess against the JAX package's, field by field, on the CPU.

One numpy-drawn scene feeds both packages. Float fields agree within
rtol = atol = 1e-5; ``valid``, ``radii``, ``rect_min``, ``rect_max``,
``tiles_touched`` and ``clamped`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu.config import GlobalSortOrder as JOrder
from stopthepop_tpu.render.preprocess import get_rect as jax_get_rect
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess

from stopthepop_tpu_torch.config import GlobalSortOrder
from stopthepop_tpu_torch.ops.covariance import compute_cov3d
from stopthepop_tpu_torch.render.preprocess import PreprocessOutput, get_rect, preprocess
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

EXACT = ("valid", "clamped", "radii", "rect_min", "rect_max", "tiles_touched")


def _run_both(w, h, *, seed=0, n=300, precomp=False, **flags):
    scene = random_scene(seed, n, device="cpu")
    cam = make_camera(w, h, campos=(0.2, 0.1, -4.0), device="cpu")
    common = dict(
        scale_modifier=1.0, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        image_width=w, image_height=h, sh_degree=3,
    )
    if precomp:
        tkw = dict(cov3d_precomp=compute_cov3d(scene.scales, 1.0, scene.rotations),
                   colors_precomp=scene.colors)
    else:
        tkw = dict(scales=scene.scales, rotations=scene.rotations, shs=scene.shs)
    jkw = {k: jnp.asarray(v.numpy()) for k, v in tkw.items()}
    jflags = dict(flags)
    if "sort_order" in flags:
        jflags["sort_order"] = JOrder(int(flags["sort_order"]))
    t = preprocess(scene.means3d, scene.opacities, viewmatrix=cam.viewmatrix,
                   projmatrix=cam.projmatrix, campos=cam.campos, **tkw,
                   **common, **flags)
    j = jax_preprocess(
        jnp.asarray(scene.means3d.numpy()), jnp.asarray(scene.opacities.numpy()),
        viewmatrix=jnp.asarray(cam.viewmatrix.numpy()),
        projmatrix=jnp.asarray(cam.projmatrix.numpy()),
        campos=jnp.asarray(cam.campos.numpy()), **jkw, **common, **jflags,
    )
    return t, j


def _compare(t, j):
    assert t._fields == j._fields == PreprocessOutput._fields
    assert len(t._fields) == 15
    for name in t._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.shape == b.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name == "cov3d_inv9":
            # Entries reach ~1e5 (inverse of 0.01-scale covariances).
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-2, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize(
    "size,flags",
    [
        ((64, 64), {}),
        ((80, 48), dict(rect_bounding=True, tight_opacity_bounding=True)),
        ((70, 45), dict(rect_bounding=True, proper_ewa_scaling=True)),
        ((70, 45), dict(tight_opacity_bounding=True,
                        sort_order=GlobalSortOrder.DISTANCE)),
    ],
)
def test_preprocess_fields_match_jax(size, flags):
    t, j = _run_both(*size, **flags)
    assert 0 < int(t.valid.sum()) < t.valid.shape[0]  # some culled, some kept
    _compare(t, j)


def test_preprocess_precomputed_cov_and_colors_match_jax():
    t, j = _run_both(64, 48, seed=3, precomp=True, rect_bounding=True)
    _compare(t, j)


def test_invalid_gaussians_flow_with_safe_view_position():
    scene = random_scene(1, 50, device="cpu")
    means = scene.means3d.clone()
    means[:5, 2] = -6.0  # behind the camera at z = -4
    cam = make_camera(32, 32, device="cpu")
    prep = preprocess(
        means, scene.opacities, scales=scene.scales, rotations=scene.rotations,
        shs=scene.shs, viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        campos=cam.campos, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        image_width=32, image_height=32, sh_degree=3,
    )
    assert not prep.valid[:5].any()
    assert (prep.p_view[:5] == torch.tensor([0.0, 0.0, 1.0])).all()
    assert (prep.radii[:5] == 0).all() and (prep.tiles_touched[:5] == 0).all()
    for f in prep:
        if f.is_floating_point():
            assert torch.isfinite(f).all()


def test_get_rect_matches_jax():
    rng = np.random.default_rng(7)
    mean2d = rng.uniform(-40, 120, (200, 2)).astype(np.float32)
    dims = rng.uniform(0, 30, (200, 2)).astype(np.float32)
    lo, hi = get_rect(torch.from_numpy(mean2d), torch.from_numpy(dims), 5, 4)
    jlo, jhi = jax_get_rect(jnp.asarray(mean2d), jnp.asarray(dims), 5, 4)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
