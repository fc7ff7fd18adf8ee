"""The port's dense oracles (render/naive.py) and GLOBAL sort-error maps
(render/debug_viz.py::sort_error_maps) against the JAX package's, on the CPU.

Both packages get the same inputs: one numpy-drawn scene goes through the
JAX preprocess, and its output is handed to the JAX oracle and, as torch
tensors, to the port's. Images and final_T agree within 1e-5, n_contrib
exactly, and both sort-error maps within 1e-5 of the larger of 1 and the
map's largest value: the distance map sums depth gaps of up to ~10, and
the port forms the view ray's norm term by term (``ops/transforms.py``, as
its kernels do) where JAX calls ``jnp.linalg.norm``, which moves ray depths
by an ulp. Scenes are 32x32 with about 100 Gaussians;
the HIER cases use the default queues (64, 8, 4) and a smaller set. The
batched HIER cascade (``batched_cascade=True``) is held against JAX's batched
oracle, run eagerly under ``jax.disable_jit()``, on the 16x16 scenes of
``test_torch_hier_batched.py``: the two where it and the per-entry cascade
differ by more than 1e-2, and its trap of exact key ties with fewer entries
a quad than the mid window holds.

The trap scene holds two bit-identical Gaussians (as densification's clone
makes them): their ray depths tie exactly, and the second's contribution
counts as out of order (``depth <= dmax``, stopthepop_common.cuh:266), with
a zero depth gap, in every mode's map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu.config import GlobalSortOrder as JOrder
from stopthepop_tpu.render import debug_viz as jdv
from stopthepop_tpu.render import naive as jnaive
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess

from stopthepop_tpu_torch.config import GlobalSortOrder
from stopthepop_tpu_torch.render import naive
from stopthepop_tpu_torch.render.debug_viz import sort_error_maps
from stopthepop_tpu_torch.render.preprocess import PreprocessOutput
from stopthepop_tpu_torch.utils.testing import (
    Scene,
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

from test_torch_hier_batched import SCENES as BATCHED_SCENES
from test_torch_hier_batched import TRAP_QUEUES, _trap_scene

one_thread_under_xdist()

SIZE = 32
ATOL = 1e-5
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _j(x):
    return jnp.asarray(x.numpy())


def _inputs(scene, order=0, colors=False, size=SIZE):
    """(camera, JAX prep, the same prep as torch tensors)."""
    cam = make_camera(size, size, device="cpu")
    col = (dict(colors_precomp=_j(scene.colors)) if colors
           else dict(shs=_j(scene.shs), sh_degree=3))
    jprep = jax_preprocess(
        _j(scene.means3d), _j(scene.opacities), scales=_j(scene.scales),
        rotations=_j(scene.rotations), viewmatrix=_j(cam.viewmatrix),
        projmatrix=_j(cam.projmatrix), campos=_j(cam.campos),
        tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, image_width=size,
        image_height=size, sort_order=JOrder(order), **col)
    tprep = PreprocessOutput(*(torch.from_numpy(np.array(x)) for x in jprep))
    return cam, jprep, tprep


def _cam_args(cam):
    return (cam.campos, cam.inv_viewprojmatrix), (_j(cam.campos),
                                                  _j(cam.inv_viewprojmatrix))


def _assert_close(port, ref, n_exact_at=2, maps_from=3):
    """Outputs equal: n_contrib exactly, images and final_T within ATOL,
    sort-error maps (from output ``maps_from`` on) within ATOL of the
    larger of 1 and their largest value."""
    for i, (p, r) in enumerate(zip(port, ref)):
        p, r = p.numpy(), np.asarray(r)
        if i == n_exact_at:
            np.testing.assert_array_equal(p.reshape(-1), r.reshape(-1))
            continue
        atol = ATOL * (max(1.0, float(np.abs(r).max())) if i >= maps_from
                       else 1.0)
        np.testing.assert_allclose(p.reshape(r.shape), r, atol=atol, rtol=0,
                                   err_msg=f"output {i}")


def _scene(seed=3, n=100):
    return random_scene(seed, n, scale_range=(0.05, 0.3), device="cpu")


@pytest.mark.parametrize("chunk", [32, 256])
def test_global_naive_matches_jax(chunk):
    cam, jprep, tprep = _inputs(_scene())
    port = naive.render_global_naive(tprep, torch.from_numpy(BG), SIZE, SIZE,
                                     chunk=chunk)
    ref = jnaive.render_global_naive(jprep, jnp.asarray(BG), SIZE, SIZE,
                                     chunk=chunk)
    _assert_close(port, ref)
    assert port[2].max() > 1


@pytest.mark.parametrize("order,cull", [(0, False), (2, False), (2, True)],
                         ids=["z_depth", "ptd_center", "ptd_center-culling"])
def test_global_order_naive_and_sort_error_maps_match_jax(order, cull):
    cam, jprep, tprep = _inputs(_scene(), order)
    (tc, tv), (jc, jv) = _cam_args(cam)
    port = naive.render_global_order_naive(
        tprep, torch.from_numpy(BG), SIZE, SIZE, tc, tv,
        sort_order=GlobalSortOrder(order), tile_based_culling=cull)
    ref = jnaive.render_global_order_naive(
        jprep, jnp.asarray(BG), SIZE, SIZE, jc, jv, sort_order=JOrder(order),
        tile_based_culling=cull)
    _assert_close(port, ref)
    maps = sort_error_maps(tprep, SIZE, SIZE, tc, tv,
                           sort_order=GlobalSortOrder(order))
    jmaps = jdv.sort_error_maps(jprep, SIZE, SIZE, jc, jv,
                                sort_order=JOrder(order))
    _assert_close(maps, jmaps, n_exact_at=None, maps_from=0)
    assert float(maps[0].max()) > 0.0 and float(maps[1].max()) > 0.0


@pytest.mark.parametrize("k", [1, 4])
def test_kbuffer_naive_with_sort_error_matches_jax(k):
    cam, jprep, tprep = _inputs(_scene())
    (tc, tv), (jc, jv) = _cam_args(cam)
    port = naive.render_kbuffer_naive(tprep, torch.from_numpy(BG), SIZE, SIZE,
                                      tc, tv, k=k, sort_error=True)
    ref = jnaive.render_kbuffer_naive(jprep, jnp.asarray(BG), SIZE, SIZE, jc,
                                      jv, k=k, sort_error=True)
    _assert_close(port, ref)
    assert float(port[3].max()) > 0.0
    assert port[2].max() > k


def test_kbuffer_naive_culling_and_order_match_jax():
    cam, jprep, tprep = _inputs(_scene(), 3)
    (tc, tv), (jc, jv) = _cam_args(cam)
    port = naive.render_kbuffer_naive(
        tprep, torch.from_numpy(BG), SIZE, SIZE, tc, tv, k=4,
        sort_order=GlobalSortOrder.PTD_MAX, tile_based_culling=True)
    ref = jnaive.render_kbuffer_naive(
        jprep, jnp.asarray(BG), SIZE, SIZE, jc, jv, k=4,
        sort_order=JOrder.PTD_MAX, tile_based_culling=True)
    _assert_close(port, ref)


@pytest.mark.parametrize("queues,cull", [((64, 8, 4), False),
                                         ((16, 4, 2), True)],
                         ids=["64-8-4", "16-4-2-culling"])
def test_hierarchical_naive_with_sort_error_matches_jax(queues, cull):
    # Dense enough that the 16-deep tail, the windows and the heads overflow.
    cam, jprep, tprep = _inputs(random_scene(21, 120, extent=0.6,
                                             device="cpu"))
    (tc, tv), (jc, jv) = _cam_args(cam)
    port = naive.render_hierarchical_naive(
        tprep, torch.from_numpy(BG), SIZE, SIZE, tc, tv, queue_sizes=queues,
        tile_based_culling=cull, hier_4x4_culling=cull, sort_error=True)
    ref = jnaive.render_hierarchical_naive(
        jprep, jnp.asarray(BG), SIZE, SIZE, jc, jv, queue_sizes=queues,
        tile_based_culling=cull, hier_4x4_culling=cull, sort_error=True)
    _assert_close(port, ref)
    assert float(port[3].max()) > 0.0
    assert port[2].max() > queues[2]


@pytest.mark.parametrize("scene", [*BATCHED_SCENES, "trap"])
def test_hierarchical_naive_batched_matches_jax(scene):
    if scene == "trap":
        sc, queues, colors = _trap_scene(), TRAP_QUEUES, True
    else:
        n, seed, extent, queues = BATCHED_SCENES[scene]
        sc = random_scene(seed, n, extent=extent, device="cpu")
        colors = False
    cam, jprep, tprep = _inputs(sc, colors=colors, size=16)
    (tc, tv), (jc, jv) = _cam_args(cam)
    port = naive.render_hierarchical_naive(
        tprep, torch.from_numpy(BG), 16, 16, tc, tv, queue_sizes=queues,
        batched_cascade=True)
    with jax.disable_jit():
        ref = jnaive.render_hierarchical_naive(
            jprep, jnp.asarray(BG), 16, 16, jc, jv, queue_sizes=queues,
            batched_cascade=True)
    _assert_close(port, ref)
    if scene != "trap":  # the scenes that tell the two cadences apart
        per_entry = naive.render_hierarchical_naive(
            tprep, torch.from_numpy(BG), 16, 16, tc, tv, queue_sizes=queues)
        assert float((port[0] - per_entry[0]).abs().max()) > 1e-2


def _clone_pair():
    """Two bit-identical Gaussians at the image centre, drawn with colors."""
    one = [np.array(x, np.float32) for x in (
        [[0.0, 0.0, 0.0]], [[0.4, 0.3, 0.35]], [[1.0, 0.0, 0.0, 0.0]],
        [0.6], np.zeros((1, 16, 3)), [[0.9, 0.2, 0.1]])]
    return Scene(*(torch.from_numpy(np.repeat(x, 2, axis=0)) for x in one))


def test_exactly_tied_depths_count_as_out_of_order():
    cam, jprep, tprep = _inputs(_clone_pair(), colors=True)
    (tc, tv), (jc, jv) = _cam_args(cam)
    bg = torch.from_numpy(BG)
    maps = {
        "global": sort_error_maps(tprep, SIZE, SIZE, tc, tv),
        "kbuffer": naive.render_kbuffer_naive(
            tprep, bg, SIZE, SIZE, tc, tv, k=4, sort_error=True)[3:],
        "hier": naive.render_hierarchical_naive(
            tprep, bg, SIZE, SIZE, tc, tv, queue_sizes=(16, 4, 2),
            sort_error=True)[3:],
    }
    jmaps = {
        "global": jdv.sort_error_maps(jprep, SIZE, SIZE, jc, jv),
        "kbuffer": jnaive.render_kbuffer_naive(
            jprep, jnp.asarray(BG), SIZE, SIZE, jc, jv, k=4,
            sort_error=True)[3:],
        "hier": jnaive.render_hierarchical_naive(
            jprep, jnp.asarray(BG), SIZE, SIZE, jc, jv,
            queue_sizes=(16, 4, 2), sort_error=True)[3:],
    }
    # Where both clones commit, the second's alpha is the opacity error: it
    # is the first's alpha, the same at every such pixel of this pair.
    alpha, skip = naive._alpha(tprep.conic_opacity[:1], tprep.mean2d[:1],
                               naive._pixel_grid(SIZE, SIZE))
    alpha = torch.where(skip, 0.0, alpha)[0].reshape(SIZE, SIZE)
    for mode, (err_op, err_dist) in maps.items():
        _assert_close((err_op, err_dist), jmaps[mode], n_exact_at=None,
                      maps_from=0)
        torch.testing.assert_close(err_op, alpha, rtol=0, atol=0,
                                   msg=f"{mode}: opacity error")
        assert float(err_op.max()) > 0.5, mode
        assert float(err_dist.abs().max()) == 0.0, mode
