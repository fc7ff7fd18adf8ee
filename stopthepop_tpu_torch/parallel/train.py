"""Sharded training step over a ("data", "gauss") mesh (torch.distributed).

Port of ``stopthepop_tpu/parallel/train.py`` (``make_mesh``,
``make_sharded_train_step``, ``shard_model``):

  mesh axes:
    "data"  — camera/batch data parallelism;
    "gauss" — Gaussian-parameter sharding: each rank holds a contiguous row
              block of the parameters and its own Adam state over them; the
              blocks are all-gathered for compute and the gradients come
              back by reduce-scatter, the deterministic stand-in for the
              reference's atomicAdd accumulation (backward.cu:561-592).

Every rank renders its own camera (the batch is n_data * n_gauss): kernel
K1 forward, K2 backward (K3/K4, K5/K6 in the resort modes) through
``render/rasterize.py``. JAX's ``shard_map`` over stacked cameras becomes
one process per rank, each passing its own camera and target. The
all-gather runs outside autograd; the gradients of the gathered leaves are
reduce-scattered over "gauss" and divided by n_gauss, then averaged over
"data", as JAX's psum_scatter and pmean. The JAX step's static
``pair_capacity`` and ``interpret`` are TPU devices and have no counterpart
(the pair count is dynamic); its optax state pytree is a
``torch.optim.Adam`` over the shard's parameters
(``train/trainer.py::make_optimizer``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import GaussianRasterizationSettings
from ..io.cameras import CameraArrays
from ..models.gaussians import PARAM_NAMES, GaussianModel, row_block
from ..render.cli import render_model
from ..train.loss import rgb_loss
from .collectives import all_gather_plain, reduce_scatter_plain
from .hosts import mesh_device_type


def mesh_shape(n: int, data: Optional[int] = None):
    """(data, gauss) for n ranks: the squarest factorization, biased toward
    "gauss", unless ``data`` is given."""
    if data is None:
        data = next(d for d in range(int(n**0.5), 0, -1) if n % d == 0)
    if n % data:
        raise ValueError(f"data={data} does not divide {n} ranks")
    return data, n // data


def make_mesh(n_devices: Optional[int] = None,
              data: Optional[int] = None) -> DeviceMesh:
    """A ("data", "gauss") mesh over the ranks of the default group.

    JAX's ``make_mesh`` may take the first ``n_devices`` devices of a
    process; here every rank is one process and a member, so
    ``n_devices`` (default: the world size) must equal the world size.
    """
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: "
                         "run one process per device of the mesh")
    return init_device_mesh(mesh_device_type(), mesh_shape(n, data),
                            mesh_dim_names=("data", "gauss"))


def _params(model: GaussianModel):
    return [getattr(model, k) for k in PARAM_NAMES]


def make_sharded_train_step(
    mesh: DeviceMesh,
    *,
    static: GaussianRasterizationSettings,
    lambda_dssim: float = 0.2,
):
    """Returns (step, n_batch).

    ``step(model_shard, optimizer, cam, target)`` takes this rank's
    parameter block (``shard_model``), an optimizer over it, this rank's
    camera (CameraArrays of one camera) and target [3, H, W]; it updates the
    block in place and returns (model_shard, optimizer, loss), the loss the
    mean over all n_batch = n_data * n_gauss ranks' cameras (a 0-d tensor
    on every rank). Each parameter's ``.grad`` holds its block of the mean
    gradient afterwards.
    """
    g_data, g_gauss = mesh.get_group("data"), mesh.get_group("gauss")
    n_data, n_gauss = dist.get_world_size(g_data), dist.get_world_size(g_gauss)

    def step(model_shard: GaussianModel, optimizer, cam: CameraArrays,
             target: torch.Tensor):
        shard = _params(model_shard)
        with torch.no_grad():
            model = GaussianModel(*(all_gather_plain(p, g_gauss)
                                    for p in shard))
        color, _ = render_model(model, cam, static=static)
        loss = rgb_loss(color, target, lambda_dssim)
        grads = torch.autograd.grad(loss, _params(model))
        for p, g in zip(shard, grads):
            g = reduce_scatter_plain(g, g_gauss) / n_gauss
            dist.all_reduce(g, group=g_data)
            p.grad = g / n_data
        optimizer.step()
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=g_gauss)
        loss = loss / n_gauss
        dist.all_reduce(loss, group=g_data)
        return model_shard, optimizer, loss / n_data

    return step, n_data * n_gauss


def shard_model(mesh: DeviceMesh, model: GaussianModel) -> GaussianModel:
    """This rank's row block of ``model`` along "gauss" (P % n_gauss == 0)."""
    return row_block(model, mesh.get_local_rank("gauss"),
                     dist.get_world_size(mesh.get_group("gauss")))
