"""The port's HIERARCHICAL batched cascade (``batched_cascade=True``: the
plain version of kernel K5, ``render_tiled_hier`` and the API) against the
JAX package, on the CPU.

The same numpy-drawn scene goes through both packages' preprocess. The
plain batched K5 is held against JAX ``render/naive.py::
render_hierarchical_naive(batched_cascade=True)``, run eagerly under
``jax.disable_jit()``: color and final_T within 1e-5, n_contrib exactly,
with and without hierarchical 4x4 culling, on two 16x16 scenes where the
batched and the per-entry images differ by more than 1e-2 (so the test
tells the two cadences apart).

The trap: one 16x16 tile of 14 Gaussians and 5 bit-identical clones with
other colours (exact key ties), 19 pairs, fewer than the 20 entries of the
mid window, run through a per-pixel Python cascade of the batched rules.
With the oracle's rules it equals the port and the JAX oracle; an unstable
merge (ties in reverse order) or +inf in place of the -inf bubbles that the
mid and head holds start with each moves the image by more than 1e-3.

Also: ``sort_error`` with the batched cascade raises, as in JAX, and the
GLOBAL API ignores the keyword, as JAX's does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu.render.naive import render_hierarchical_naive

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.constants import T_THRESHOLD
from stopthepop_tpu_torch.kernels.hier_blend import subtile_of_pixel
from stopthepop_tpu_torch.render import naive
from stopthepop_tpu_torch.render.pipeline import render_tiled_hier
from stopthepop_tpu_torch.utils.testing import (
    Scene,
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

from test_torch_hier import BG, _cascade_inputs, _hier_settings, _j, _preps

one_thread_under_xdist()

ATOL = 1e-5
INF = math.inf

# name: (Gaussians, seed, extent, queues)
SCENES = {"60-gaussians-16-8-4": (60, 1, 1.0, (16, 8, 4)),
          "200-gaussians-4-2-2": (200, 0, 1.5, (4, 2, 2))}


def _port(cam, t, queues, batched, cull=False):
    with torch.no_grad():
        return render_tiled_hier(
            t, torch.from_numpy(BG), image_width=cam.width,
            image_height=cam.height, campos=cam.campos,
            inverse_vp=cam.inv_viewprojmatrix, queue_sizes=queues,
            hier_4x4_culling=cull, batched_cascade=batched)


def _oracle(cam, j, queues, cull=False):
    with jax.disable_jit():
        img, final_t, nc = render_hierarchical_naive(
            j, jnp.asarray(BG), cam.width, cam.height, _j(cam.campos),
            _j(cam.inv_viewprojmatrix), queue_sizes=queues,
            hier_4x4_culling=cull, batched_cascade=True)
    return np.asarray(img), np.asarray(final_t), np.asarray(nc)


def _assert_matches(port, oracle):
    img, final_t, n_contrib = port[:3]
    np.testing.assert_allclose(img.numpy(), oracle[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(final_t.numpy().reshape(-1), oracle[1],
                               atol=ATOL, rtol=0)
    assert n_contrib.dtype == torch.int32
    np.testing.assert_array_equal(n_contrib.numpy().reshape(-1), oracle[2])


@pytest.mark.parametrize("cull", [False, True], ids=["no-culling",
                                                     "4x4-culling"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_plain_batched_k5_matches_jax_oracle(scene, cull):
    n, seed, extent, queues = SCENES[scene]
    cam = make_camera(16, 16, device="cpu")
    t, j = _preps(cam, random_scene(seed, n, extent=extent, device="cpu"))
    port = _port(cam, t, queues, True, cull)
    _assert_matches(port, _oracle(cam, j, queues, cull))
    assert bool(torch.isfinite(port[4]).all())  # depth_acc, non-finite d0 -> 0
    per_entry = _port(cam, t, queues, False, cull)
    assert float((port[0] - per_entry[0]).abs().max()) > 1e-2
    assert int(port[2].max()) > queues[2]  # the head window overflows


# ---------------------------------------------------------------------------
# The trap: exact ties, fewer real entries than the mid window holds
# ---------------------------------------------------------------------------

TRAP_QUEUES = (16, 20, 4)


def _trap_scene():
    """One 16x16 tile: 14 large Gaussians, the first 5 cloned bit for bit
    with other colours."""
    rng = np.random.default_rng(0)
    n, clones = 14, 5
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(-0.6, 0.6, n)], axis=1)
    scales = np.exp(rng.uniform(math.log(0.3), math.log(0.8), (n, 3)))
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.7, n)
    colors = rng.uniform(0.0, 1.0, (n, 3))
    idx = np.concatenate([np.arange(n), np.arange(clones)])
    colors = np.concatenate([colors, rng.uniform(0.0, 1.0, (clones, 3))])
    arrays = (means[idx], scales[idx], q[idx], opac[idx],
              np.zeros((len(idx), 16, 3)), colors)
    return Scene(*(torch.as_tensor(np.asarray(x, np.float32)) for x in arrays))


def _sorted(entries, stable):
    """Sorted by key; ties in their order (``stable``) or reversed."""
    if stable:
        return sorted(entries, key=lambda e: e[0])
    return [e for _, e in sorted(enumerate(entries),
                                 key=lambda ie: (ie[1][0], -ie[0]))]


def _tail_rounds(keys, kt):
    """Each tail round's 64 emitted (key, stream position) of a sub-tile,
    position -1 for the hold's bubbles and the pads."""
    hold, rounds = [(-INF, -1)] * kt, []
    for b0 in range(0, len(keys), 64):
        part = [(float(keys[s]), s) for s in range(b0, min(b0 + 64, len(keys)))]
        cat = _sorted(hold + part + [(-INF, -1)] * (64 - len(part)), True)
        rounds.append(cat[:64])
        hold = cat[64:]
    for _ in range(-(-kt // 64)):
        cat = _sorted(hold + [(INF, -1)] * 64, True)
        rounds.append(cat[:64])
        hold = cat[64:]
    return rounds


def _batched_reference(inputs, queues, stable=True, bubble=-INF):
    """The batched cascade of one tile, pixel by pixel (float64 blend):
    color [3, 16, 16], final_T and n_contrib [16, 16]."""
    key_t, d_mid, d_head, a, rgb = inputs
    kt, km, kh = queues
    color, T_all = np.zeros((256, 3)), np.ones(256)
    nc_all = np.zeros(256, np.int64)
    sub_of = subtile_of_pixel("cpu").numpy()
    for sub in range(16):
        rounds = _tail_rounds(key_t[:, sub], kt)
        for p in np.flatnonzero(sub_of == sub):
            st = {"T": 1.0, "C": np.zeros(3), "done": False, "nc": 0,
                  "mid": [(bubble, -1)] * km, "head": [(bubble, -1, 0.0)] * kh}

            def blend(rows):
                for _, s, alpha in rows:
                    if st["done"] or alpha == 0.0:
                        continue
                    U = st["T"] * (1.0 - alpha)
                    if U < T_THRESHOLD:
                        st["done"] = True
                    else:
                        st["C"] = st["C"] + alpha * st["T"] * rgb[s]
                        st["T"], st["nc"] = U, st["nc"] + 1

            def mid_round(batch):
                srt = _sorted(st["mid"] + batch, stable)
                emit, st["mid"] = srt[:8], srt[8:]
                to_head = [(float(d_head[s, p]) if math.isfinite(k) else k, s,
                            float(a[s, p]) if s >= 0 else 0.0)
                           for k, s in emit]
                srt = _sorted(st["head"] + to_head, stable)
                blend(srt[:8])
                st["head"] = srt[8:]

            for emitted in rounds:
                for b0 in range(0, 64, 8):
                    mid_round([(float(d_mid[s, p]), s) if math.isfinite(k)
                               else (-INF, -1) for k, s in emitted[b0:b0 + 8]])
            for _ in range(-(-km // 8)):
                mid_round([(INF, -1)] * 8)
            blend(st["head"])
            color[p], T_all[p], nc_all[p] = st["C"], st["T"], st["nc"]
    img = color + T_all[:, None] * BG[None, :]
    return (img.T.reshape(3, 16, 16), T_all.reshape(16, 16),
            nc_all.reshape(16, 16))


@pytest.fixture(scope="module")
def trap():
    cam = make_camera(16, 16, device="cpu")
    t, j = _preps(cam, _trap_scene(), colors=True)
    port = _port(cam, t, TRAP_QUEUES, True)
    inputs = _cascade_inputs(t, port[3], cam, 0.0)
    return t, port, _oracle(cam, j, TRAP_QUEUES), inputs


def test_batched_trap_scene_matches_reference_and_oracle(trap):
    t, port, oracle, inputs = trap
    pairs = port[3]
    gid = pairs.gauss_id.long()
    # Exact ties: the 5 clones sit next to their originals; every quad
    # holds fewer real entries than the mid window.
    keys = t.depth[gid]
    assert int((keys[1:] == keys[:-1]).sum()) == 5
    assert int(pairs.ends[0] - pairs.starts[0]) < TRAP_QUEUES[1]
    _assert_matches(port, oracle)
    img, final_t, nc = _batched_reference(inputs, TRAP_QUEUES)
    np.testing.assert_allclose(img, oracle[0].reshape(3, 16, 16), atol=ATOL)
    np.testing.assert_allclose(final_t.reshape(-1), oracle[1], atol=ATOL)
    np.testing.assert_array_equal(nc.reshape(-1), oracle[2])


@pytest.mark.parametrize("wrong", [dict(stable=False), dict(bubble=INF)],
                         ids=["unstable-merge", "+inf-bubbles"])
def test_batched_trap_catches_wrong_rules(trap, wrong):
    _, port, oracle, inputs = trap
    bad, _, _ = _batched_reference(inputs, TRAP_QUEUES, **wrong)
    assert np.abs(bad - oracle[0].reshape(3, 16, 16)).max() > 1e-3
    assert np.abs(bad - port[0].numpy()).max() > 1e-3


# ---------------------------------------------------------------------------
# Refusals and the other sort modes
# ---------------------------------------------------------------------------

def test_sort_error_with_batched_cascade_raises():
    cam = make_camera(16, 16, device="cpu")
    t, _ = _preps(cam, random_scene(1, 20, device="cpu"))
    with pytest.raises(NotImplementedError, match="per-entry cascade only"):
        naive.render_hierarchical_naive(
            t, torch.from_numpy(BG), 16, 16, cam.campos,
            cam.inv_viewprojmatrix, queue_sizes=(16, 8, 4),
            batched_cascade=True, sort_error=True)


def test_batched_keyword_through_the_api():
    # HIER takes it (the API's image is the pipeline's batched one), GLOBAL
    # ignores it.
    cam = make_camera(16, 16, device="cpu")
    n, seed, extent, queues = SCENES["60-gaussians-16-8-4"]
    scene = random_scene(seed, n, extent=extent, device="cpu")
    args = (scene.means3d, None, scene.opacities)
    kw = dict(shs=scene.shs, scales=scene.scales, rotations=scene.rotations)
    rs = _hier_settings(cam, queues)
    got = stt.GaussianRasterizer(rs, batched_cascade=True)(*args, **kw)[0]
    t, _ = _preps(cam, scene)
    torch.testing.assert_close(got, _port(cam, t, queues, True)[0], rtol=0,
                               atol=0)
    per_entry = stt.GaussianRasterizer(rs)(*args, **kw)[0]
    assert float((got - per_entry).abs().max()) > 1e-2
    ext = stt.ExtendedSettings()
    g_rs = rs._replace(settings=ext)
    torch.testing.assert_close(
        stt.GaussianRasterizer(g_rs, batched_cascade=True)(*args, **kw)[0],
        stt.GaussianRasterizer(g_rs)(*args, **kw)[0], rtol=0, atol=0)
