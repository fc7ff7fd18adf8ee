"""Collectives over a process group, and their autograd Functions.

The counterparts of the ``jax.lax`` collectives that the JAX package's
parallel layer calls inside ``shard_map`` (``stopthepop_tpu/parallel/``):

  here               JAX                               backward
  -----------------  --------------------------------  --------------------
  all_gather_rows    all_gather(axis=0, tiled=True)    reduce_scatter (sum),
                     (spatial.py:206, train.py:79)     JAX's psum_scatter
  psum               psum of a replicated loss         identity
                     (spatial.py:288, :303)
  ppermute           ppermute (ring.py:220)            the inverse permutation
  halo_exchange      the two ppermutes of              the halos' cotangents
                     spatial.py:_halo_exchange          back to their owners

``psum``'s backward is the identity, not a second sum: every rank holds the
replicated loss and back-propagates its own copy, so each rank's gradient
is the share of its own inputs. (``torch.distributed.nn.all_reduce`` sums
again in its backward, which makes the gradients n times too large.)

Each Function is one autograd node that issues its collectives in one fixed
order, and every rank builds the same graph, so the ranks' backward passes
issue the same collectives in the same order. Tensors that need no gradient
(integer tables, targets) go through the plain functions, outside autograd.

A ppermute is one ``batch_isend_irecv``; a rank that no one sends to gets
zeros, as in JAX, and a send to oneself (a one-rank ring) is a local copy.
``group=None`` is the default (world) group.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _group(group):
    return dist.group.WORLD if group is None else group


def all_gather_plain(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` [r, ...] concatenated along dim 0, in group-rank
    order: [n * r, ...]."""
    group = _group(group)
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter_plain(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``x`` [n * r, ...], this rank's block of r rows."""
    group = _group(group)
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} blocks")
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out


def psum_plain(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``x``, on every rank."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(group))
    return out


def _check_perm(perm: Sequence[Tuple[int, int]], n: int):
    src = [s for s, _ in perm]
    dst = [d for _, d in perm]
    if (len(set(src)) != len(src) or len(set(dst)) != len(dst)
            or not all(0 <= r < n for r in src + dst)):
        raise ValueError(f"not a partial permutation of {n} ranks: {perm}")


def _exchange(sends, recvs, group):
    """One batch of point-to-point transfers: ``sends`` and ``recvs`` are
    (group rank, tensor) lists, none of them to or from this rank."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, r),
                      group) for r, t in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, r), group)
            for r, t in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def ppermute_plain(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
                   group=None) -> torch.Tensor:
    """``jax.lax.ppermute``: group rank s's ``x`` goes to d for each (s, d)
    of ``perm``; a rank that receives nothing gets zeros."""
    group = _group(group)
    rank = dist.get_rank(group)
    _check_perm(perm, dist.get_world_size(group))
    out = torch.zeros_like(x)
    sends, recvs = [], []
    for s, d in perm:
        if s == rank and d == rank:
            out.copy_(x)
        elif s == rank:
            sends.append((d, x))
        elif d == rank:
            recvs.append((s, out))
    _exchange(sends, recvs, group)
    return out


def halo_exchange_plain(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """[C, h, W] -> [C, h + 2 halo, W]: the last ``halo`` rows of the previous
    rank on top, the first ``halo`` rows of the next one below; zeros where
    there is no neighbour (the first and the last rank)."""
    group = _group(group)
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    c, _, w = x.shape
    top = x.new_zeros((c, halo, w))
    bot = x.new_zeros((c, halo, w))
    sends, recvs = [], []
    if rank + 1 < n:
        sends.append((rank + 1, x[:, -halo:]))
        recvs.append((rank + 1, bot))
    if rank > 0:
        sends.append((rank - 1, x[:, :halo]))
        recvs.append((rank - 1, top))
    _exchange(sends, recvs, group)
    return torch.cat([top, x, bot], dim=1)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_plain(x, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_plain(grad, ctx.group), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum_plain(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return ppermute_plain(x, perm, group)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        return ppermute_plain(grad, inverse, ctx.group), None, None


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group = halo, _group(group)
        return halo_exchange_plain(x, halo, group)

    @staticmethod
    def backward(ctx, grad):
        halo, group = ctx.halo, ctx.group
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        d_x = grad[:, halo:-halo].clone()
        from_next = grad.new_zeros(grad[:, :halo].shape)
        from_prev = grad.new_zeros(grad[:, :halo].shape)
        sends, recvs = [], []
        if rank > 0:  # my top halo came from the previous rank's last rows
            sends.append((rank - 1, grad[:, :halo]))
            recvs.append((rank - 1, from_prev))
        if rank + 1 < n:  # my bottom halo came from the next rank's first rows
            sends.append((rank + 1, grad[:, -halo:]))
            recvs.append((rank + 1, from_next))
        _exchange(sends, recvs, group)
        d_x[:, :halo] += from_prev
        d_x[:, -halo:] += from_next
        return d_x, None, None


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable ``all_gather_plain``; its backward reduce-scatters the
    cotangent, so each rank's rows get the sum of every rank's use."""
    return _AllGatherRows.apply(x, group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum over ranks of a term of a replicated loss; its
    backward is the identity (see the module's docstring)."""
    return _PSum.apply(x, group)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Differentiable ``ppermute_plain``; its backward sends each cotangent
    back along the inverse permutation."""
    return _PPermute.apply(x, [tuple(p) for p in perm], group)


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """Differentiable ``halo_exchange_plain``: both directions in one batch,
    forward and backward."""
    return _HaloExchange.apply(x, halo, group)
