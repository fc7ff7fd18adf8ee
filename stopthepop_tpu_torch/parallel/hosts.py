"""Process-group bring-up: one process per GPU, NCCL, and device meshes.

Port of ``stopthepop_tpu/parallel/hosts.py`` (``initialize``,
``global_mesh``). Where JAX runs one process per host over all of its
devices, torch.distributed runs one process per GPU: ``initialize`` joins
this process to the default group (NCCL on the card; Gloo only for
``device="cpu"``), and ``global_mesh`` lays the ranks out as a named
``DeviceMesh``. Both sharded train steps and the band renderers take such a
mesh. A user launches with torchrun, which sets RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc-per-node=<cards> my_train.py

    from stopthepop_tpu_torch.parallel import hosts
    hosts.initialize()
    mesh = hosts.global_mesh(("data", "gauss"))

``launch`` starts the processes itself (spawned, one per rank, on a file
store) for programs that are not run under torchrun.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve_device


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
) -> None:
    """Join the default process group; a no-op if it exists.

    With no ``init_method``, torchrun's environment (RANK and WORLD_SIZE,
    ``env://``) is read where it is set; without it this process is a
    one-rank world on an in-process store, as JAX runs single-process
    without a coordinator, and a ``world_size`` over 1 or a ``rank`` raises
    ``ValueError``. An explicit ``init_method`` that fails raises.
    The backend is NCCL, and this process's card is
    ``torch.cuda.set_device(LOCAL_RANK)`` (rank modulo the card count
    without torchrun); Gloo only for ``device="cpu"``. Without a GPU and
    without ``device="cpu"`` it raises, as every entry point of the port.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    env = os.environ
    if init_method is None and "RANK" in env and "WORLD_SIZE" in env:
        init_method = "env://"
    if init_method is None and ((world_size or 1) > 1 or rank is not None):
        raise ValueError(
            f"world_size={world_size}, rank={rank} without an init_method "
            "or torchrun's RANK and WORLD_SIZE: no other rank could join")
    if dev.type == "cuda":
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else (rank or 0) % torch.cuda.device_count())
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    else:
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)


def mesh_device_type() -> str:
    """"cuda" for an NCCL default group, else "cpu"."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_mesh(
    axis_names: Sequence[str],
    axis_shape: Optional[Tuple[int, ...]] = None,
) -> DeviceMesh:
    """A mesh over every rank of the default group.

    With no ``axis_shape``: one axis gets every rank; two axes get (hosts,
    ranks per host), hosts = WORLD_SIZE // LOCAL_WORLD_SIZE (torchrun's
    variables; one host without them), so that the trailing axis's
    collectives stay inside a host, as JAX keeps them on ICI.
    """
    n = dist.get_world_size()
    if axis_shape is None:
        if len(axis_names) == 1:
            axis_shape = (n,)
        elif len(axis_names) == 2:
            per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
            axis_shape = (n // per_host, per_host)
        else:
            raise ValueError("pass axis_shape for >2 axes")
    return init_device_mesh(mesh_device_type(), tuple(axis_shape),
                            mesh_dim_names=tuple(axis_names))


def _run(rank: int, fn: Callable, world_size: int, init_method: str,
         device: str, args: tuple) -> None:
    initialize(init_method, world_size, rank, device)
    try:
        fn(rank, *args)
        # No rank tears the group down while another is still in it.
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, *, device=None, args: tuple = ()) -> int:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes, each joined
    to one process group (NCCL, or Gloo with ``device="cpu"``) through a
    file store in a temporary directory. ``fn`` must be importable by the
    children (a module-level function).

    Returns 0 when every rank returned; when a rank raises or dies, the
    others are stopped, its error is printed to stderr and 1 is returned.
    """
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as d:
        init = f"file://{os.path.join(d, 'store')}"
        try:
            torch.multiprocessing.start_processes(
                _run, args=(fn, nprocs, init, dev.type, args), nprocs=nprocs,
                join=True, start_method="spawn")
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            print(f"launch: rank {e.error_index} failed: {e}", file=sys.stderr)
            return 1
    return 0
