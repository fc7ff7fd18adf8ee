"""The port's HIERARCHICAL backward (plain version of kernel K6, ``BlendHier``
and the API) against autograd and the JAX package's gradients, on the CPU.

- The plain K6 against ``torch.autograd`` through the plain K5 (written in
  differentiable torch operations): per-Gaussian gradients within 1e-5 of
  each column's largest value, at (8, 4, 2) on 48x48, at (64, 8, 4) on a
  one-tile stream that crosses several 64-entry tail batches, with 4x4 and
  tile-based culling, in PTD_CENTER order and at 45x37 (not a multiple of
  16). The two share no gradient code.
- The trap scene of tests/test_torch_hier.py, with a per-pixel numpy replay
  of the backward: with the right rules it equals the plain K6 pair by pair;
  with each rule a straight port may get wrong it differs: the replay
  stopping after n_contrib commits counting those of alpha 0 (K5's
  n_contrib counts only alpha > 0), the tail's ties in reverse order, a
  sliding tail instead of batches of 64, pixel centers at +0.5.
- The 8 gradients of ``GaussianRasterizer`` in HIER mode against
  ``jax.grad`` of the JAX package's preprocess and its hierarchical oracle
  ``render/naive.py::render_hierarchical_naive`` (the means2D dummy written
  out as the rasterizer writes it), at the tolerances of
  tests/test_hierarchical.py's gradient tests (atol 3e-4 of the largest
  value, rtol 3e-3): (8, 4, 2) at 48x48 through SH, scales and rotations,
  and (64, 8, 4) on one deep 16x16 tile through precomputed colors and
  covariances.
- The grouped routing that K4 and K6 share (``_route_grouped``) against a
  numpy model of its order of summation, and equal to a lane-by-lane model
  (each committing lane's terms added into its pair's row in ascending
  lane order, K4's routing before it was grouped) where no two lanes of a
  warp commit the same pair.
- An empty stream; the kernel library's name hashing the shared header.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu.render.naive import render_hierarchical_naive
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.constants import T_THRESHOLD
from stopthepop_tpu_torch.kernels import build
from stopthepop_tpu_torch.kernels.blend_vjp import reduce_pair_grads
from stopthepop_tpu_torch.kernels.kbuffer_blend import WARPS, _route_grouped
from stopthepop_tpu_torch.kernels.hier_blend import (
    blend_hier_backward,
    blend_hier_forward_plain,
    subtile_of_pixel,
    thread_pixel,
)
from stopthepop_tpu_torch.ops.covariance import compute_cov3d
from stopthepop_tpu_torch.render.duplicate import build_pairs
from stopthepop_tpu_torch.render.pipeline import tile_grid
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

from test_torch_hier import (
    BG,
    TRAP_QUEUES,
    _cascade_inputs,
    _hier_settings,
    _port,
    _preps,
    _tail_emission,
    _trap_scene,
)

one_thread_under_xdist()


def _cotangents(w, h, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((3, h, w)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32)))


def _autograd_and_k6(prep, pairs, cam, w, h, queues, cull):
    """(autograd through plain K5, plain K6) per-pair-summed gradients of
    (xy, conic_opacity, rgb), and K5's n_contrib and the plain K6's d_pair."""
    gx, gy = tile_grid(w, h)
    g_color, g_t = _cotangents(w, h)
    rows = [x.detach().clone().requires_grad_(True)
            for x in (prep.mean2d, prep.conic_opacity, prep.rgb)]
    extra = (prep.cov3d_inv9.detach(), prep.opacity_power_threshold.detach(),
             cam.inv_viewprojmatrix, cam.campos)
    kw = dict(queue_sizes=queues, hier_4x4_culling=cull, grid_x=gx, grid_y=gy,
              width=w, height=h)
    color, final_t, n_contrib, _ = blend_hier_forward_plain(
        pairs.gauss_id, pairs.starts, pairs.ends, *rows, *extra, **kw)
    expect = torch.autograd.grad(
        (color * g_color).sum() + (final_t * g_t).sum(), rows)
    d_pair = blend_hier_backward(
        pairs.gauss_id, pairs.starts, pairs.ends, *(r.detach() for r in rows),
        *extra, color.detach(), final_t.detach(), n_contrib, g_color, g_t, **kw)
    d = reduce_pair_grads(d_pair, pairs.orig_slot, pairs.gauss_offsets)
    return expect, (d[:, 0:2], d[:, 2:6], d[:, 6:9]), n_contrib, d_pair


def _assert_columns_close(got, ref, rel=1e-5):
    for name, g, r in zip(("xy", "conic_opacity", "rgb"), got, ref):
        scale = r.abs().amax(dim=0)
        assert (scale > 0).all(), name
        assert ((g - r).abs() <= rel * scale).all(), name


CASES = {
    # name: (w, h, Gaussians, seed, scene kwargs, queues, order, culling)
    "8-4-2": (48, 48, 150, 8, dict(scale_range=(0.05, 0.4)), (8, 4, 2), 0,
              False),
    # One tile whose stream crosses several 64-entry tail batches.
    "64-8-4-deep-tile": (16, 16, 250, 22, dict(extent=0.5), (64, 8, 4), 0,
                         False),
    "16-8-4-culling": (48, 48, 150, 9, dict(scale_range=(0.05, 0.4)),
                       (16, 8, 4), 0, True),
    "16-8-4-ptd_center": (48, 48, 150, 8, dict(scale_range=(0.05, 0.4)),
                          (16, 8, 4), 2, False),
    "45x37": (45, 37, 150, 8, dict(scale_range=(0.05, 0.4)), (16, 8, 4), 0,
              False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_autograd(case):
    w, h, n, seed, scene_kw, queues, order, cull = CASES[case]
    cam = make_camera(w, h, device="cpu")
    scene = random_scene(seed, n, device="cpu", **scene_kw)
    prep = preprocess(
        scene.means3d, scene.opacities, scales=scene.scales,
        rotations=scene.rotations, shs=scene.shs, viewmatrix=cam.viewmatrix,
        projmatrix=cam.projmatrix, campos=cam.campos, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, image_width=w, image_height=h, sh_degree=3,
        sort_order=stt.GlobalSortOrder(order))
    gx, gy = tile_grid(w, h)
    pairs = build_pairs(prep, grid_x=gx, grid_y=gy,
                        sort_order=stt.GlobalSortOrder(order),
                        tile_based_culling=cull, campos=cam.campos,
                        inverse_vp=cam.inv_viewprojmatrix, image_width=w,
                        image_height=h)
    expect, got, n_contrib, _ = _autograd_and_k6(prep, pairs, cam, w, h,
                                                 queues, cull)
    assert n_contrib.max() > queues[2]  # the head window overflows
    if case == "64-8-4-deep-tile":
        assert int(pairs.ends[0] - pairs.starts[0]) > 2 * 64
    _assert_columns_close(got, expect)


def test_thread_pixel_is_k5s_thread_map():
    # Half-warp s is sub-tile s; a quad's 4 lanes hold its 2x2 pixels.
    pix = thread_pixel("cpu")
    assert sorted(pix.tolist()) == list(range(256))
    assert (subtile_of_pixel("cpu")[pix] == torch.arange(256) // 16).all()
    x, y = pix % 16, pix // 16
    assert (x[1::4] == x[0::4] + 1).all() and (y[1::4] == y[0::4]).all()
    assert (x[2::4] == x[0::4]).all() and (y[2::4] == y[0::4] + 1).all()


# ---------------------------------------------------------------------------
# Traps: the scene of tests/test_torch_hier.py and a per-pixel numpy replay
# ---------------------------------------------------------------------------

def _commits(inputs, queues, p, *, ride_through=True, stable=True, batch=64):
    """Pixel p's committing head pops in order, (stream position, alpha, T
    before), by the cascade's rules unless told otherwise."""
    key_t, d_mid, d_head, a, _ = inputs
    kt, km, kh = queues
    sub = int(subtile_of_pixel("cpu")[p])
    st = {"T": 1.0, "done": False}
    out, mid, head = [], [], []

    def blend(s):
        U = st["T"] * (1.0 - a[s, p])
        if not st["done"]:
            if U < T_THRESHOLD:
                st["done"] = True
            else:
                out.append((s, float(a[s, p]), st["T"]))
                st["T"] = U

    def insert(win, key, s):
        keys = [k for k, _ in win]
        pos = sum(k <= key for k in keys)
        win.insert(pos, (key, s))

    def push_head(s):
        if len(head) == kh:
            blend(head.pop(0)[1])
        insert(head, d_head[s, p], s)

    for s in _tail_emission(key_t[:, sub], kt, batch, stable):
        if not ride_through and a[s, p] == 0:
            continue
        if len(mid) == km:
            push_head(mid.pop(0)[1])
        insert(mid, d_mid[s, p], s)
    while mid:
        push_head(mid.pop(0)[1])
    while head:
        blend(head.pop(0)[1])
    return out


def _reference_grads(t, pairs, cam, fwd, cot, offset=0.0,
                     count_alpha0=False, **rules):
    """Per-pair gradients [S, 9] of the one-tile trap stream (float64), the
    replay stopping at K5's n_contrib; with ``count_alpha0`` commits of
    alpha 0 count toward it."""
    inputs = _cascade_inputs(t, pairs, cam, offset)
    gid = pairs.gauss_id.long()
    xy = t.mean2d[gid].double().numpy()
    co = t.conic_opacity[gid].double().numpy()
    rgb = t.rgb[gid].double().numpy()
    color, final_t, n_contrib = (x.double().numpy().reshape(*x.shape[:-2], 256)
                                 for x in fwd)
    g_all, g_t = (x.double().numpy().reshape(*x.shape[:-2], 256) for x in cot)
    d = np.zeros((len(gid), 9))
    for p in range(256):
        px, py = p % 16 + offset, p // 16 + offset
        g = g_all[:, p]
        s_tot = float(color[:, p] @ g)
        k_t = float(g_t[p] * final_t[p])
        acc, nc = 0.0, 0
        for s, a0, T in _commits(inputs, TRAP_QUEUES, p, **rules):
            if nc == n_contrib[p]:
                break
            cg = float(rgb[s] @ g)
            w = a0 * T
            acc += w * cg
            galpha = cg * T - (s_tot - acc + k_t) / (1.0 - a0) if a0 < 0.99 else 0.0
            dx, dy = xy[s, 0] - px, xy[s, 1] - py
            a, b, c, o = co[s]
            dp = -a0 * galpha
            d[s] += [dp * (a * dx + b * dy), dp * (c * dy + b * dx),
                     dp * 0.5 * dx * dx, dp * dx * dy, dp * 0.5 * dy * dy,
                     galpha * a0 / o, w * g[0], w * g[1], w * g[2]]
            nc += 1 if count_alpha0 else int(a0 > 0)
    return d


@pytest.fixture(scope="module")
def trap():
    cam = make_camera(16, 16, device="cpu")
    t, _ = _preps(cam, _trap_scene(), colors=True)
    pairs = _port(cam, t, TRAP_QUEUES)[3]
    expect, got, n_contrib, d_pair = _autograd_and_k6(t, pairs, cam, 16, 16,
                                                      TRAP_QUEUES, False)
    with torch.no_grad():
        fwd = blend_hier_forward_plain(
            pairs.gauss_id, pairs.starts, pairs.ends, t.mean2d,
            t.conic_opacity, t.rgb, t.cov3d_inv9, t.opacity_power_threshold,
            cam.inv_viewprojmatrix, cam.campos, queue_sizes=TRAP_QUEUES,
            hier_4x4_culling=False, grid_x=1, grid_y=1, width=16, height=16)
    right = _reference_grads(t, pairs, cam, fwd[:3], _cotangents(16, 16))
    return t, pairs, cam, fwd, expect, got, d_pair.double().numpy(), right


@pytest.mark.parametrize("wrong", [
    dict(count_alpha0=True), dict(stable=False), dict(batch=1),
    dict(offset=0.5)],
    ids=["alpha0-ride-through", "stable-ties", "tail-batch-cadence",
         "integer-pixel"])
def test_hier_backward_traps(trap, wrong):
    t, pairs, cam, fwd, expect, got, d_pair, right = trap
    assert int(pairs.ends[0] - pairs.starts[0]) > 2 * 64  # three tail batches
    # Commits of alpha 0 come before the last commit of alpha > 0 on many
    # pixels, so the two stop rules differ there.
    _assert_columns_close(got, expect)
    scale = np.abs(d_pair).max(axis=0)
    assert (scale > 0).all()
    assert (np.abs(right - d_pair) <= 1e-5 * scale).all()
    bad = _reference_grads(t, pairs, cam, fwd[:3], _cotangents(16, 16),
                           **wrong)
    assert (np.abs(bad - d_pair) / scale).max() > 1e-2


# ---------------------------------------------------------------------------
# The API against jax.grad of the JAX oracle
# ---------------------------------------------------------------------------

API_CASES = {
    # name: (size, Gaussians, seed, scene kwargs, queues, input path)
    "8-4-2-sh-scale-rot": (48, 100, 16, dict(scale_range=(0.05, 0.4)),
                           (8, 4, 2), "sh-scale-rot"),
    "64-8-4-deep-tile-colors-cov3d": (16, 250, 22, dict(extent=0.5),
                                      (64, 8, 4), "colors-cov3d"),
}


@pytest.mark.parametrize("case", list(API_CASES))
def test_api_gradients_match_jax_oracle(case):
    size, n, seed, scene_kw, queues, path = API_CASES[case]
    scene = random_scene(seed, n, device="cpu", **scene_kw)
    cam = make_camera(size, size, device="cpu")
    weights = np.random.default_rng(3).standard_normal(
        (3, size, size)).astype(np.float32)
    means2d = torch.zeros((n, 3))
    if path == "sh-scale-rot":
        inputs = dict(means3D=scene.means3d, means2D=means2d,
                      opacities=scene.opacities[:, None], shs=scene.shs,
                      scales=scene.scales, rotations=scene.rotations)
    else:
        inputs = dict(means3D=scene.means3d, means2D=means2d,
                      opacities=scene.opacities[:, None],
                      colors_precomp=scene.colors,
                      cov3D_precomp=compute_cov3d(scene.scales, 1.0,
                                                  scene.rotations))
    leaves = {key: v.clone().requires_grad_(True) for key, v in inputs.items()}
    color, _ = stt.GaussianRasterizer(_hier_settings(cam, queues))(**leaves)
    loss = (color * torch.from_numpy(weights)).sum()
    loss.backward()

    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731

    def jloss(means3d, means2d, opac, *rest):
        if path == "sh-scale-rot":
            kw = dict(shs=rest[0], scales=rest[1], rotations=rest[2])
        else:
            kw = dict(colors_precomp=rest[0], cov3d_precomp=rest[1])
        prep = jax_preprocess(
            means3d, opac.reshape(-1), viewmatrix=j(cam.viewmatrix),
            projmatrix=j(cam.projmatrix), campos=j(cam.campos),
            tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, image_width=size,
            image_height=size, sh_degree=3, **kw)
        # The rasterizer's value-neutral means2D reroute.
        m2d = means2d[:, :2] * jnp.array([0.5 * size, 0.5 * size], jnp.float32)
        prep = prep._replace(mean2d=prep.mean2d + m2d - jax.lax.stop_gradient(m2d))
        img, _, _ = render_hierarchical_naive(
            prep, jnp.asarray(BG), size, size, j(cam.campos),
            j(cam.inv_viewprojmatrix), queue_sizes=queues)
        return jnp.sum(img * weights)

    names = list(inputs)
    jv, jg = jax.value_and_grad(jloss, argnums=tuple(range(len(names))))(
        *(j(inputs[key]) for key in names))
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    assert leaves["means2D"].grad.abs().max() > 0
    for name, ref in zip(names, jg):
        got, ref = leaves[name].grad.numpy(), np.asarray(ref)
        assert np.isfinite(got).all(), name
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(got, ref, atol=3e-4 * scale, rtol=3e-3,
                                   err_msg=f"hier gradient mismatch for {name}")


# ---------------------------------------------------------------------------
# Edges
# ---------------------------------------------------------------------------

def test_empty_stream_gives_no_gradient():
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
    color, final_t, n_contrib, _ = blend_hier_forward_plain(
        empty, ranges, ranges, *rows, **kw)
    before = blend_hier_backward.launches
    d_pair = blend_hier_backward(empty, ranges, ranges, *rows, color, final_t,
                                 n_contrib, torch.ones(3, h, w),
                                 torch.ones(h, w), **kw)
    assert d_pair.shape == (0, 9)
    assert blend_hier_backward.launches == before  # the CPU runs no kernel
    # Through the API: every Gaussian behind the camera.
    scene = random_scene(0, 20, device="cpu")
    means = (scene.means3d - torch.tensor([0.0, 0.0, 10.0])).requires_grad_(True)
    color, _ = stt.GaussianRasterizer(_hier_settings(cam))(
        means, None, scene.opacities, colors_precomp=scene.colors,
        scales=scene.scales, rotations=scene.rotations)
    color.sum().backward()
    assert torch.allclose(color, torch.as_tensor(BG)[:, None, None])
    assert (means.grad == 0).all()


def test_wrapper_refuses_other_devices():
    cam = make_camera(16, 16, device="cpu")
    one = torch.zeros(1, dtype=torch.int32)
    args = (one, one, one + 1, torch.zeros(1, 2), torch.zeros(1, 4),
            torch.zeros(1, 3), torch.zeros(1, 9), torch.zeros(1),
            cam.inv_viewprojmatrix, cam.campos, torch.zeros(3, 16, 16),
            torch.ones(16, 16), torch.zeros(16, 16, dtype=torch.int32),
            torch.zeros(3, 16, 16), torch.zeros(16, 16))
    kw = dict(queue_sizes=(64, 8, 4), hier_4x4_culling=False, grid_x=1,
              grid_y=1, width=16, height=16)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        blend_hier_backward(*(x.to("meta") for x in args), **kw)
    with pytest.raises(ValueError, match="HIER queue size"):
        blend_hier_backward(*args, **{**kw, "queue_sizes": (64, 8, 17)})


def test_an_edited_header_changes_every_library_path(tmp_path, monkeypatch):
    # K5 and K6 share csrc/hier_common.cuh: editing it must rebuild both.
    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in build.all_sources()}
    header = tmp_path / "hier_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.all_sources()}
    assert all(before[n] != after[n] for n in before)
    assert all(after[n].name.startswith(f"{n}-") for n in after)


# ---------------------------------------------------------------------------
# The grouped routing of K4 and K6
# ---------------------------------------------------------------------------

def _route_lane_model(acc, commit, src, vals):
    """numpy, lane by lane: each committing lane's terms added into its
    pair's row of its warp, lanes in ascending order."""
    acc = acc.copy()
    for t in range(acc.shape[0]):
        for i in np.flatnonzero(commit[t]):
            w, s = i // 32, int(src[t, i])
            acc[t, w, s] = acc[t, w, s] + vals[t, i]
    return acc


def _route_grouped_model(acc, commit, src, vals):
    """numpy, lane by lane: per tile and warp, the committing lanes that name
    the same pair are summed in ascending lane order from the lowest one's
    terms on, then each group's sum is added into its pair's row."""
    acc = acc.copy()
    for t in range(acc.shape[0]):
        for w in range(WARPS):
            sums = {}
            for lane in range(32):
                i = 32 * w + lane
                if commit[t, i]:
                    s = int(src[t, i])
                    sums[s] = sums[s] + vals[t, i] if s in sums else vals[t, i].copy()
            for s, v in sums.items():
                acc[t, w, s] = acc[t, w, s] + v
    return acc


def _routing_step(seed, pairs):
    rng = np.random.default_rng(seed)
    T, L = 3, 12
    acc = rng.standard_normal((T, WARPS, L, 9)).astype(np.float32)
    commit = rng.random((T, 256)) < 0.6
    src = rng.integers(0, pairs, (T, 256))
    # Magnitudes 1e-8 .. 1e8, so that the order of the sums shows in the bits.
    vals = (rng.standard_normal((T, 256, 9))
            * 10.0 ** rng.integers(-8, 9, (T, 256, 9))).astype(np.float32)
    return acc, commit, src, vals


def test_grouped_routing_sums_each_pair_once_in_lane_order():
    acc, commit, src, vals = _routing_step(3, pairs=4)
    # Two pixels of one warp commit the same pair in this step.
    commit[0, 5] = commit[0, 9] = True
    src[0, 5] = src[0, 9] = 2
    expect = _route_grouped_model(acc, commit, src, vals)
    got = torch.from_numpy(acc.copy())
    _route_grouped(got, torch.from_numpy(commit), torch.from_numpy(src),
                   torch.from_numpy(vals))
    assert np.array_equal(got.numpy(), expect)
    # The order differs from lane-by-lane adds, and this step shows it.
    lane_by_lane = _route_lane_model(acc, commit, src, vals)
    assert not np.array_equal(lane_by_lane, got.numpy())


def test_grouped_routing_is_route_without_shared_pairs():
    acc, commit, _, vals = _routing_step(4, pairs=1)
    # Every lane of a warp names its own pair.
    src = np.tile(np.arange(32) % 12, (3, WARPS))
    commit &= np.arange(256)[None, :] % 32 < 12
    a = torch.from_numpy(acc.copy())
    _route_grouped(a, torch.from_numpy(commit), torch.from_numpy(src),
                   torch.from_numpy(vals))
    assert np.array_equal(a.numpy(), _route_lane_model(acc, commit, src, vals))
    assert not torch.equal(a, torch.from_numpy(acc))
