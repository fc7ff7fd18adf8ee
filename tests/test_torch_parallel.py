"""The port's collectives, process-group bring-up and ("data", "gauss")
train step (stopthepop_tpu_torch/parallel/) on the CPU, in 4 Gloo processes.

One group of 4 processes (``utils/testing.py::run_ranks``, a file store, one
torch thread each) runs every case once; the tests read its results:

- each collective's forward and gradient against its single-process
  meaning: the gradient of a ``psum``'d replicated loss is the
  single-process one, not 4 times it; ``ppermute`` gives zeros where no
  rank sends and sends a cotangent back along the inverse permutation; a
  send to oneself (a one-rank ring) is a copy; the halo exchange moves both
  directions, forward and backward (exactly: every sum has one term);
- ``hosts.initialize`` twice is a no-op; ``global_mesh`` and ``make_mesh``
  shapes; an explicit ``init_method`` that fails raises, and so do a
  ``world_size`` over 1 or a ``rank`` with no ``init_method`` and no
  torchrun environment; without CUDA and
  without ``device="cpu"`` the entry points raise; ``hosts.launch``
  returns 1 when a rank fails and 0 when every rank returns;
- one (2, 2) ("data", "gauss") step at 32x32 with P = 256 (each rank its
  own target) against the JAX reference of test_parallel.py, the
  single-device JAX step on the mean loss: loss at rtol 1e-5, updated
  parameters at atol 1e-5 (test_parallel.py:80-87); and its gradients
  against the port's single-device autograd gradients at 1e-4 of each
  tensor's largest value (the reduce-scatter sums the 4 cameras' gradients
  in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stopthepop_tpu.config import ExtendedSettings as JExt
from stopthepop_tpu.config import GaussianRasterizationSettings as JSettings
from stopthepop_tpu.models.gaussians import init_random as jax_init_random
from stopthepop_tpu.parallel.train import make_mesh as jax_make_mesh
from stopthepop_tpu.train.loss import rgb_loss as jax_rgb_loss
from stopthepop_tpu.train.trainer import CameraArrays as JCams
from stopthepop_tpu.train.trainer import make_optimizer as jax_make_optimizer
from stopthepop_tpu.train.trainer import render_model as jax_render_model
from stopthepop_tpu.utils.testing import make_camera as jax_make_camera

from stopthepop_tpu_torch.config import ExtendedSettings, GaussianRasterizationSettings
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES, from_numpy_params
from stopthepop_tpu_torch.parallel import hosts
from stopthepop_tpu_torch.parallel.train import mesh_shape
from stopthepop_tpu_torch.render.cli import render_model
from stopthepop_tpu_torch.train.loss import rgb_loss
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    run_ranks,
)

one_thread_under_xdist()

WORLD = 4
SIZE = 32
P = 256
LR = 1e-3

_BODY = r"""
import torch.distributed as dist
from stopthepop_tpu_torch.config import ExtendedSettings, GaussianRasterizationSettings
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES, from_numpy_params
from stopthepop_tpu_torch.parallel import collectives as C
from stopthepop_tpu_torch.parallel import train
from stopthepop_tpu_torch.train.trainer import make_optimizer
from stopthepop_tpu_torch.utils.testing import make_camera

out = {}
hosts.initialize(f"file://{workdir}/store", world, rank, device="cpu")  # no-op
out["world"] = np.array(dist.get_world_size())
out["mesh_tiles"] = np.array(hosts.global_mesh(("tiles",)).shape)
out["mesh_dg"] = np.array(hosts.global_mesh(("data", "gauss")).shape)
out["mesh_explicit"] = np.array(
    hosts.global_mesh(("data", "gauss"), (1, 4)).shape)
for data in (None, 1, 4):
    out[f"make_mesh_{data}"] = np.array(train.make_mesh(data=data).shape)

inp = np.load(f"{workdir}/inputs.npz")
SIZE, LR = int(inp["size"]), float(inp["lr"])


def leaf(name):
    return torch.tensor(inp[f"{name}_{rank}"], requires_grad=True)


x = leaf("gather")
y = C.all_gather_rows(x)
(y * torch.tensor(inp["gather_w"]) * (rank + 1)).sum().backward()
out["gather_y"], out["gather_grad"] = y.detach().numpy(), x.grad.numpy()

x = leaf("psum")
loss = C.psum((x * x).sum())
loss.backward()
out["psum_loss"], out["psum_grad"] = loss.detach().numpy(), x.grad.numpy()

for name, perm in (("chain", [(0, 1), (1, 2), (2, 3)]),
                   ("self", [(r, r) for r in range(world)]),
                   ("ring", [(r, (r + 1) % world) for r in range(world)])):
    x = leaf("perm")
    y = C.ppermute(x, perm)
    (y * torch.tensor(inp[f"perm_w_{rank}"])).sum().backward()
    out[f"{name}_y"], out[f"{name}_grad"] = y.detach().numpy(), x.grad.numpy()

groups = [dist.new_group([r]) for r in range(world)]
x = leaf("perm")
y = C.ppermute(x, [(0, 0)], groups[rank])
(y * torch.tensor(inp[f"perm_w_{rank}"])).sum().backward()
out["solo_y"], out["solo_grad"] = y.detach().numpy(), x.grad.numpy()

x = leaf("halo")
y = C.halo_exchange(x, 2)
(y * torch.tensor(inp[f"halo_w_{rank}"])).sum().backward()
out["halo_y"], out["halo_grad"] = y.detach().numpy(), x.grad.numpy()
out["halo_plain"] = C.halo_exchange_plain(x.detach(), 2).numpy()

mesh = train.make_mesh()
cam = make_camera(SIZE, SIZE, device="cpu")
static = GaussianRasterizationSettings(
    image_height=SIZE, image_width=SIZE, tanfovx=cam.tanfovx,
    tanfovy=cam.tanfovy, bg=torch.zeros(3), scale_modifier=1.0,
    viewmatrix=None, projmatrix=None, inv_viewprojmatrix=None, sh_degree=3,
    campos=None, prefiltered=False, settings=ExtendedSettings())
step, n_batch = train.make_sharded_train_step(mesh, static=static)
model = from_numpy_params({k: inp[k] for k in PARAM_NAMES}, device="cpu")
shard = train.shard_model(mesh, model)
opt = make_optimizer(shard.parameters(), LR)
cams = CameraArrays(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                    cam.campos)
shard, opt, loss = step(shard, opt, cams, torch.tensor(inp[f"target_{rank}"]))
out["n_batch"], out["loss"] = np.array(n_batch), loss.numpy()
out["coord"] = np.array(mesh.get_coordinate())
for k in PARAM_NAMES:
    out[f"new_{k}"] = getattr(shard, k).detach().numpy()
    out[f"grad_{k}"] = getattr(shard, k).grad.numpy()
np.savez(f"{workdir}/rank{rank}.npz", **out)
"""


def _inputs():
    rng = np.random.default_rng(7)
    model = jax_init_random(jax.random.PRNGKey(0), P)
    params = {k: np.asarray(v) for k, v in model._asdict().items()}
    inp = dict(params, size=np.array(SIZE), lr=np.array(LR))
    inp["gather_w"] = rng.standard_normal((WORLD * 3, 2)).astype(np.float32)
    for r in range(WORLD):
        inp[f"gather_{r}"] = rng.standard_normal((3, 2)).astype(np.float32)
        inp[f"psum_{r}"] = rng.standard_normal((5,)).astype(np.float32)
        inp[f"perm_{r}"] = rng.standard_normal((2, 3)).astype(np.float32)
        inp[f"perm_w_{r}"] = rng.standard_normal((2, 3)).astype(np.float32)
        inp[f"halo_{r}"] = rng.standard_normal((2, 6, 3)).astype(np.float32)
        inp[f"halo_w_{r}"] = rng.standard_normal((2, 10, 3)).astype(np.float32)
        inp[f"target_{r}"] = rng.uniform(
            0.0, 1.0, (3, SIZE, SIZE)).astype(np.float32)
    return model, inp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("parallel")
    model, inp = _inputs()
    np.savez(workdir / "inputs.npz", **inp)
    out = run_ranks(_BODY, WORLD, workdir, env={"LOCAL_WORLD_SIZE": "2"})
    return model, inp, out


def test_initialize_twice_is_a_noop_and_mesh_shapes(run):
    _, _, out = run
    for o in out:
        assert int(o["world"]) == WORLD
        assert tuple(o["mesh_tiles"]) == (4,)
        assert tuple(o["mesh_dg"]) == (2, 2)  # 2 hosts of 2 ranks
        assert tuple(o["mesh_explicit"]) == (1, 4)
        assert tuple(o["make_mesh_None"]) == (2, 2)
        assert tuple(o["make_mesh_1"]) == (1, 4)
        assert tuple(o["make_mesh_4"]) == (4, 1)


def test_make_mesh_factorization_matches_jax():
    for n in range(1, 9):
        assert mesh_shape(n) == tuple(jax_make_mesh(n).devices.shape), n
    assert mesh_shape(12) == (3, 4) and mesh_shape(6, data=6) == (6, 1)
    with pytest.raises(ValueError):
        mesh_shape(6, data=4)


def test_entry_points_need_cuda_or_cpu_and_a_good_init_method():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hosts.initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hosts.launch(print, 2)
    with pytest.raises((ValueError, RuntimeError)):
        hosts.initialize("bogus://nowhere", 2, 0, device="cpu")


@pytest.mark.parametrize("world_size,rank", [(4, None), (4, 0), (None, 1)])
def test_initialize_refuses_ranks_without_a_rendezvous(monkeypatch,
                                                       world_size, rank):
    # No init_method and no torchrun environment: no other rank could join,
    # so a world of several ranks, or a rank, is an error, not a lone rank.
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="init_method"):
        hosts.initialize(world_size=world_size, rank=rank, device="cpu")
    assert not torch.distributed.is_initialized()


def test_launch_reports_a_failed_rank():
    # Rank r calls sys.exit(r): rank 1 exits with code 1.
    import sys
    assert hosts.launch(sys.exit, 2, device="cpu") == 1
    assert hosts.launch(print, 2, device="cpu") == 0


def test_all_gather_rows_forward_and_reduce_scatter_backward(run):
    _, inp, out = run
    xs = [inp[f"gather_{r}"] for r in range(WORLD)]
    w = inp["gather_w"]
    # The sum over ranks of loss_r = (r + 1) * sum(w * gathered).
    scale = sum(r + 1 for r in range(WORLD))
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["gather_y"], np.concatenate(xs))
        np.testing.assert_allclose(o["gather_grad"], scale * w[3 * r:3 * r + 3],
                                   rtol=1e-6)


def test_psum_gradient_is_the_single_process_one(run):
    _, inp, out = run
    xs = [inp[f"psum_{r}"] for r in range(WORLD)]
    total = sum(float((x.astype(np.float64) ** 2).sum()) for x in xs)
    for r, o in enumerate(out):
        np.testing.assert_allclose(float(o["psum_loss"]), total, rtol=1e-6)
        # d(sum_r |x_r|^2)/dx_r = 2 x_r, not 4 * 2 x_r.
        np.testing.assert_array_equal(o["psum_grad"], 2.0 * xs[r])


@pytest.mark.parametrize("name,perm", [
    ("chain", [(0, 1), (1, 2), (2, 3)]),
    ("self", [(r, r) for r in range(WORLD)]),
    ("ring", [(r, (r + 1) % WORLD) for r in range(WORLD)]),
])
def test_ppermute_forward_and_inverse_backward(run, name, perm):
    _, inp, out = run
    src = {d: s for s, d in perm}
    dst = {s: d for s, d in perm}
    for r, o in enumerate(out):
        want = (inp[f"perm_{src[r]}"] if r in src
                else np.zeros_like(inp[f"perm_{r}"]))
        np.testing.assert_array_equal(o[f"{name}_y"], want)
        grad = (inp[f"perm_w_{dst[r]}"] if r in dst
                else np.zeros_like(inp[f"perm_{r}"]))
        np.testing.assert_array_equal(o[f"{name}_grad"], grad)


def test_one_rank_ring_is_a_local_copy(run):
    _, inp, out = run
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["solo_y"], inp[f"perm_{r}"])
        np.testing.assert_array_equal(o["solo_grad"], inp[f"perm_w_{r}"])


def test_halo_exchange_both_directions(run):
    _, inp, out = run
    halo = 2
    full = np.concatenate([inp[f"halo_{r}"] for r in range(WORLD)], axis=1)
    h = full.shape[1] // WORLD
    padded = np.pad(full, ((0, 0), (halo, halo), (0, 0)))
    d_padded = np.zeros_like(padded)
    for r in range(WORLD):
        d_padded[:, r * h:r * h + h + 2 * halo] += inp[f"halo_w_{r}"]
    d_full = d_padded[:, halo:-halo]
    for r, o in enumerate(out):
        want = padded[:, r * h:r * h + h + 2 * halo]
        np.testing.assert_array_equal(o["halo_y"], want)
        np.testing.assert_array_equal(o["halo_plain"], want)
        np.testing.assert_allclose(o["halo_grad"], d_full[:, r * h:(r + 1) * h],
                                   rtol=1e-6, atol=1e-6)


def _static(settings_cls, ext, cam, bg):
    return settings_cls(
        image_height=SIZE, image_width=SIZE, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=bg, scale_modifier=1.0,
        viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        inv_viewprojmatrix=cam.inv_viewprojmatrix, sh_degree=3,
        campos=cam.campos, prefiltered=False, settings=ext)


def _stack_blocks(out, key):
    """The full tensor from the gauss blocks of the ranks at data = 0."""
    blocks = sorted((int(o["coord"][1]), o[key]) for o in out
                    if int(o["coord"][0]) == 0)
    return np.concatenate([b for _, b in blocks])


def test_data_gauss_step_matches_jax_single_device(run):
    model, inp, out = run
    cam = jax_make_camera(SIZE, SIZE)
    static = _static(JSettings, JExt(), cam, jnp.zeros(3))
    cams = JCams(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                 cam.campos)
    targets = [jnp.asarray(inp[f"target_{r}"]) for r in range(WORLD)]

    def loss_fn(m):
        color, _ = jax_render_model(m, cams, static=static,
                                    pair_capacity=16 * P, interpret=True)
        return sum(jax_rgb_loss(color, t) for t in targets) / WORLD

    loss_ref, grads = jax.value_and_grad(loss_fn)(model)
    optimizer = jax_make_optimizer(LR)
    updates, _ = optimizer.update(grads, optimizer.init(model), model)
    new_ref = optax.apply_updates(model, updates)
    for o in out:
        assert int(o["n_batch"]) == WORLD
        np.testing.assert_allclose(float(o["loss"]), float(loss_ref), rtol=1e-5)
    for name in PARAM_NAMES:
        np.testing.assert_allclose(
            _stack_blocks(out, f"new_{name}"),
            np.asarray(getattr(new_ref, name)), atol=1e-5,
            err_msg=f"sharded parameter mismatch: {name}")


def test_data_gauss_gradients_match_single_device_port(run):
    _, inp, out = run
    model = from_numpy_params({k: inp[k] for k in PARAM_NAMES}, device="cpu")
    cam = make_camera(SIZE, SIZE, device="cpu")
    static = _static(GaussianRasterizationSettings, ExtendedSettings(), cam,
                     torch.zeros(3))
    cams = CameraArrays(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                        cam.campos)
    color, _ = render_model(model, cams, static=static)
    loss = sum(rgb_loss(color, torch.tensor(inp[f"target_{r}"]))
               for r in range(WORLD)) / WORLD
    loss.backward()
    for name in PARAM_NAMES:
        ref = getattr(model, name).grad.numpy()
        for data in (0, 1):
            blocks = sorted((int(o["coord"][1]), o[f"grad_{name}"])
                            for o in out if int(o["coord"][0]) == data)
            got = np.concatenate([b for _, b in blocks])
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=name)
