"""The port's density control, checkpoints and training CLI, on the CPU.

- clone and prune against the JAX package's ``densify_and_prune`` exactly:
  the port resizes the model where JAX fills free slots of a static
  capacity, so the port's rows are compared with JAX's active rows as
  sorted sets, with the same counts and the same capacity drops;
- split by its invariants (the two packages draw their samples
  differently): children's scales are the parent's / 1.6, the other fields
  the parent's, the count and the capacity budget;
- ``reset_opacity`` and the optimizer's rows (kept rows keep their Adam
  moments, written rows start at zero);
- a checkpoint round trip across a resize;
- the point-cloud init (``from_points``, its Morton-window kNN scales)
  against the JAX package's, and the PNG reader (every row filter) and
  ``to_float_rgb`` against the JAX package's pure-Python path;
- the training CLI for 30 iterations in GLOBAL on a tiny synthetic
  dataset, with densification and an opacity reset firing; its PLY loads in
  the JAX package; two iterations at its default, HIER; one on a COLMAP
  capture.
"""

import math
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu.io import images as jimages
from stopthepop_tpu.io.ply import load_gaussian_model as jax_load_model
from stopthepop_tpu.models import gaussians as jgaussians
from stopthepop_tpu.models.gaussians import GaussianModel as JaxModel
from stopthepop_tpu.train import density as jdensity
from stopthepop_tpu.train.trainer import DensifyStats as JStats

from stopthepop_tpu_torch.io.images import read_png, read_png_batch, to_float_rgb
from stopthepop_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    from_points,
    mean_knn_distance,
    from_numpy_params,
    to_numpy_params,
)
from stopthepop_tpu_torch.train import cli
from stopthepop_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from stopthepop_tpu_torch.train.density import (
    DensifyConfig,
    densify_and_prune,
    reset_opacity,
)
from stopthepop_tpu_torch.train.trainer import (
    DensifyStats,
    init_train_state,
    make_3dgs_optimizer,
)
from stopthepop_tpu_torch.utils.synthetic import (
    structured_scene,
    write_colmap_capture,
    write_nerf_synthetic,
)
from stopthepop_tpu_torch.utils.testing import one_thread_under_xdist

one_thread_under_xdist()

EXTENT = 1.3


def _params(n, seed, log_scale):
    rng = np.random.default_rng(seed)
    return {
        "means3d": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "scales_log": (log_scale + 0.1 * rng.standard_normal((n, 3))).astype(np.float32),
        "rotations": rng.standard_normal((n, 4)).astype(np.float32),
        "opacity_logit": rng.uniform(-7, 2, (n,)).astype(np.float32),
        "sh_dc": rng.standard_normal((n, 1, 3)).astype(np.float32),
        "sh_rest": rng.standard_normal((n, 3, 3)).astype(np.float32),
    }


def _stats(n, seed):
    rng = np.random.default_rng(seed + 1)
    return (rng.uniform(0, 8e-4, n).astype(np.float32),
            rng.integers(1, 3, n).astype(np.int32),
            rng.integers(0, 20, n).astype(np.int32))


def _sorted_rows(d):
    rows = np.concatenate([np.asarray(d[k]).reshape(len(d["means3d"]), -1)
                           for k in PARAM_NAMES], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("capacity", [400, 130], ids=["roomy", "tight"])
def test_clone_and_prune_match_jax(capacity):
    n = 120
    params = _params(n, 0, math.log(0.004))  # every densified one is a clone
    accum, denom, radii = _stats(n, 0)

    jmodel = JaxModel(**{k: jnp.asarray(v) for k, v in params.items()})
    jm, active = jdensity.grow_capacity(jmodel, capacity)
    pad = capacity - n
    jstats = JStats(jnp.pad(accum, (0, pad)), jnp.pad(denom, (0, pad)),
                    jnp.pad(radii, (0, pad)))
    jm, jactive, _, jinfo = jdensity.densify_and_prune(
        jm, active, jstats, jax.random.PRNGKey(0), scene_extent=EXTENT)
    keep = np.asarray(jactive)
    jrows = {k: np.asarray(v)[keep] for k, v in jm._asdict().items()}

    model = from_numpy_params(params, device="cpu")
    stats = DensifyStats(torch.from_numpy(accum), torch.from_numpy(denom),
                         torch.from_numpy(radii))
    new_stats, info = densify_and_prune(
        model, None, stats, torch.Generator().manual_seed(0), EXTENT, capacity)
    assert info["num_split"] == int(jinfo["num_split"]) == 0
    for key in ("num_active", "num_cloned", "num_pruned", "dropped"):
        assert info[key] == int(jinfo[key]), key
    assert info["num_cloned"] > 0 and info["num_pruned"] > 0
    assert (info["dropped"] > 0) == (capacity == 130)
    np.testing.assert_array_equal(_sorted_rows(to_numpy_params(model)),
                                  _sorted_rows(jrows))
    assert model.num_gaussians == info["num_active"] <= capacity
    assert new_stats.denom.shape == (model.num_gaussians,)
    assert not new_stats.grad2d_accum.any()


@pytest.mark.parametrize("capacity", [400, 110], ids=["roomy", "tight"])
def test_split_invariants(capacity):
    n = 100
    params = _params(n, 1, math.log(0.05))  # every densified one is split
    params["opacity_logit"][:] = 1.0       # nothing pruned
    accum, denom, radii = _stats(n, 1)
    model = from_numpy_params(params, device="cpu")
    stats = DensifyStats(torch.from_numpy(accum), torch.from_numpy(denom),
                         torch.from_numpy(radii))
    cfg = DensifyConfig()
    sel = accum / denom >= cfg.grad_threshold
    _, info = densify_and_prune(model, None, stats,
                                torch.Generator().manual_seed(3), EXTENT,
                                capacity, cfg)
    n_sel = int(sel.sum())
    free = capacity - n
    placed = min(n_sel, (free + 1) // 2)
    children = min(2 * n_sel, free)
    assert info["num_split"] == placed and info["num_cloned"] == 0
    assert info["dropped"] == 2 * (n_sel - placed)
    assert model.num_gaussians == n - placed + children <= capacity
    new = to_numpy_params(model)
    kept = n - placed
    # Kept rows: the unsplit Gaussians, in order.
    src = np.flatnonzero(~sel)[: kept] if placed == n_sel else None
    if src is not None:
        np.testing.assert_array_equal(new["means3d"][:kept], params["means3d"][src])
    kids = {k: v[kept:] for k, v in new.items()}
    parents = np.flatnonzero(sel)[:placed]
    parent_of = np.concatenate([parents, parents])[: children] if children == 2 * placed \
        else np.concatenate([parents, parents[: children - placed]])
    np.testing.assert_allclose(kids["scales_log"],
                               params["scales_log"][parent_of] - math.log(1.6),
                               rtol=0, atol=1e-6)
    for k in ("rotations", "opacity_logit", "sh_dc", "sh_rest"):
        np.testing.assert_array_equal(kids[k], params[k][parent_of], err_msg=k)
    offset = np.linalg.norm(kids["means3d"] - params["means3d"][parent_of], axis=1)
    assert (offset > 0).all() and offset.max() < 10 * 0.05 * 1.5


def test_optimizer_rows_follow_the_model():
    n = 60
    params = _params(n, 2, math.log(0.004))
    accum, denom, radii = _stats(n, 2)
    model = from_numpy_params(params, device="cpu")
    opt = make_3dgs_optimizer(model)
    for name in PARAM_NAMES:
        getattr(model, name).grad = torch.ones_like(getattr(model, name))
    opt.step()
    before = {n_: opt.state[getattr(model, n_)]["exp_avg"].clone()
              for n_ in PARAM_NAMES}
    prune = torch.sigmoid(model.opacity_logit.detach()) < 0.005
    stats = DensifyStats(torch.from_numpy(accum), torch.from_numpy(denom),
                         torch.from_numpy(radii))
    _, info = densify_and_prune(model, opt, stats, torch.Generator(), EXTENT, 1000)
    kept = int((~prune).sum())
    for group in opt.param_groups:
        (p,) = group["params"]
        name = next(k for k in PARAM_NAMES if getattr(model, k) is p)
        st = opt.state[p]
        assert st["exp_avg"].shape == p.shape and st["exp_avg_sq"].shape == p.shape
        torch.testing.assert_close(st["exp_avg"][:kept], before[name][~prune])
        assert (st["exp_avg"][kept:] == 0).all() and (st["exp_avg_sq"][kept:] == 0).all()
    assert model.num_gaussians == kept + info["num_cloned"]

    changed = reset_opacity(model, opt, max_opacity=0.01)
    ceil = math.log(0.01 / 0.99)
    assert changed.any() and (model.opacity_logit <= ceil + 1e-6).all()
    for group in opt.param_groups:
        st = opt.state[group["params"][0]]
        assert (st["exp_avg"][changed] == 0).all()
        assert (st["exp_avg"][~changed][: min(kept, 5)] != 0).any() or not (~changed).any()


def test_checkpoint_round_trip_across_a_resize(tmp_path):
    params = _params(40, 3, math.log(0.004))
    model = from_numpy_params(params, device="cpu")
    opt = make_3dgs_optimizer(model)
    for name in PARAM_NAMES:
        getattr(model, name).grad = torch.full_like(getattr(model, name), 0.5)
    opt.step()
    state = init_train_state(model, opt)._replace(step=7)
    stats = DensifyStats(torch.arange(40.0), torch.ones(40, dtype=torch.int32),
                         torch.arange(40, dtype=torch.int32))
    path = save_checkpoint(str(tmp_path), state, stats)
    saved = to_numpy_params(model)
    saved_state = {k: v.clone() for k, v in opt.state[model.means3d].items()}
    accum = torch.full((40,), 1.0)
    densify_and_prune(model, opt, stats._replace(grad2d_accum=accum),
                      torch.Generator(), EXTENT, 1000)
    assert model.num_gaussians != 40
    state, back = load_checkpoint(path, state)
    assert state.step == 7 and model.num_gaussians == 40
    for k, v in to_numpy_params(model).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    for k, v in saved_state.items():
        torch.testing.assert_close(opt.state[model.means3d][k], v, rtol=0, atol=0)
    assert opt.param_groups[0]["params"][0] is model.means3d
    torch.testing.assert_close(back.grad2d_accum, stats.grad2d_accum)


def _write_dataset(root, views=4, size=32):
    gt, _ = structured_scene(400, 0, device="cpu")
    write_nerf_synthetic(str(root), gt, views=views, size=size, device="cpu")


def test_train_cli_densifies_and_writes_a_ply_jax_loads(tmp_path):
    _write_dataset(tmp_path)
    assert read_png(str(tmp_path / "r_0.png")).shape == (32, 32, 3)
    out = tmp_path / "model.ply"
    res = cli.main(["--data", str(tmp_path), "--iters", "30",
                    "--init-points", "200", "--densify-from", "10",
                    "--densify-every", "10", "--opacity-reset-every", "20",
                    "--eval-every", "10", "--sh-ramp-every", "10",
                    "--checkpoint-dir", str(tmp_path / "ckpt"),
                    "--checkpoint-every", "15", "--out", str(out),
                    "--sort-mode", "GLOBAL", "--device", "cpu"])
    assert sorted(res.eval_psnr) == [10, 20, 30]
    assert all(np.isfinite(v) for v in res.eval_psnr.values())
    assert res.eval_psnr[30] > res.eval_psnr[10]
    assert len(res.num_gaussians) == 3 and res.num_gaussians[-1] != 200
    jm = jax_load_model(str(out))
    assert jm.means3d.shape[0] == res.state.model.num_gaussians
    np.testing.assert_array_equal(np.asarray(jm.opacity_logit),
                                  res.state.model.opacity_logit.detach().numpy())
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "ckpt_15.pt", "ckpt_30.pt"]


def test_train_cli_raises_for_unported_paths(tmp_path):
    _write_dataset(tmp_path, views=1, size=16)
    # HIER trains now (kernels K5 and K6), and is the CLI's default.
    res = cli.main(["--data", str(tmp_path), "--iters", "2",
                    "--init-points", "60", "--eval-every", "2",
                    "--densify-from", "100", "--device", "cpu"])
    assert res.state.step == 2 and np.isfinite(res.eval_psnr[2])
    assert res.state.model.means3d.grad.abs().max() > 0
    # So is a COLMAP capture (a sparse/ directory): the model starts from
    # its point cloud.
    capture = tmp_path / "capture"
    gt, _ = structured_scene(300, seed=2, device="cpu")
    write_colmap_capture(str(capture), gt, views=3, width=24, height=16,
                         points=80, device="cpu")
    res = cli.main(["--data", str(capture), "--iters", "1",
                    "--eval-every", "1", "--device", "cpu"])
    assert res.state.model.num_gaussians == 80
    assert np.isfinite(res.eval_psnr[1])


@pytest.mark.parametrize("knn", [True, False], ids=["knn", "spacing"])
def test_from_points_matches_jax(knn):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    ours = to_numpy_params(from_points(pts, cols, sh_degree=2,
                                       knn_scale_init=knn, device="cpu"))
    ref = jgaussians.from_points(jnp.asarray(pts), jnp.asarray(cols),
                                 sh_degree=2, knn_scale_init=knn)
    for k, v in ref._asdict().items():
        np.testing.assert_allclose(ours[k], np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(mean_knn_distance(pts),
                               np.asarray(jgaussians.mean_knn_distance(jnp.asarray(pts))),
                               rtol=1e-6)


def _png_with_every_filter(img):
    """PNG bytes of ``img`` [H, W, C] uint8 with row filters 0-4 in turn."""
    h, w, c = img.shape
    rows, prev = [], np.zeros(w * c, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        ft = y % 5
        if ft == 4:
            pa, pb = np.abs(prev - upleft), np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        else:
            pred = [0, left, prev, (left + prev) // 2][ft]
        rows.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(ctype, payload):
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_matches_jax(tmp_path, channels):
    img = np.random.default_rng(channels).integers(
        0, 256, (11, 7, channels)).astype(np.uint8)
    path = tmp_path / "img.png"
    path.write_bytes(_png_with_every_filter(img))
    ours = read_png(str(path))
    np.testing.assert_array_equal(ours.reshape(img.shape), img)
    np.testing.assert_array_equal(
        ours, jimages._read_png_python(str(path)).reshape(ours.shape))
    np.testing.assert_array_equal(read_png_batch([str(path)] * 2)[1], ours)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    np.testing.assert_allclose(to_float_rgb(ours, bg),
                               jimages.to_float_rgb(ours, bg), rtol=0, atol=1e-7)
