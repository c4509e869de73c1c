"""Ulysses sequence parallelism over ``torch.distributed`` (counterpart of
vorta_tpu/parallel/ulysses.py).

The head <-> sequence reshard of the reference (vorta/ulysses/utils.py:
15-120, all_to_all over NCCL with autograd wrappers), here one
``all_to_all_single`` per call.  Each collective is a
``torch.autograd.Function`` whose backward is its exact adjoint, so that
with every rank seeding the backward of its own loss, a replicated
parameter's gradient summed over the group is the gradient of the sum of
the ranks' losses:

  * ``all_to_all_heads_to_seq`` and ``all_to_all_seq_to_heads``: each is
    the other's backward;
  * ``gather_sequence`` (all-gather): the sum over ranks of the gradients
    of this rank's slice (an all-reduce, then the slice: gloo has no
    reduce-scatter);
  * ``slice_local`` (this rank's slice of a replicated tensor): the
    gradient padded with zeros to the replicated shape, no communication.

Each takes a ``ProcessGroup`` where JAX takes a mesh axis name.  The layout
contract is JAX's: ranks hold contiguous latent-frame chunks in rank order,
so the gathered sequence is the raster order, and tile and coreset geometry
compose with no sequence remapping (the reference's frame re-interleave is
not carried over).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    p = _size(group)
    b, h, s, d = x.shape
    if h % p:
        raise ValueError(f"{h} heads not divisible by the group's {p} ranks")
    send = x.reshape(b, p, h // p, s, d).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)  # recv[r]: rank r's rows, my heads
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // p, p * s, d)


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    p = _size(group)
    b, h, s, d = x.shape
    if s % p:
        raise ValueError(f"sequence {s} not divisible by the group's {p} ranks")
    send = x.reshape(b, h, p, s // p, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)  # recv[r]: rank r's heads, my rows
    return recv.permute(1, 0, 2, 3, 4).reshape(b, p * h, s // p, d)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _local(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    p = _size(group)
    if x.shape[dim] % p:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible by the group's {p} ranks")
    n = x.shape[dim] // p
    return x.narrow(dim, _rank(group) * n, n)


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return _local(g, ctx.dim, ctx.group), None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.shape = dim, group, x.shape
        return _local(x, dim, group).clone()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        _local(out, ctx.dim, ctx.group).copy_(g)
        return out, None, None


def all_to_all_heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """(B, H, S_local, D) per rank -> (B, H/P, S_global, D): heads scattered
    over the group, the sequence gathered; every rank ends up with the full
    sequence of a 1/P subset of the heads (rank r: heads r H/P ..)."""
    return _HeadsToSeq.apply(x, group)


def all_to_all_seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """(B, H/P, S_global, D) -> (B, H, S_local, D): the inverse reshard."""
    return _SeqToHeads.apply(x, group)


def gather_sequence(x: torch.Tensor, seq_axis: int, group) -> torch.Tensor:
    """All-gather a sequence-sharded tensor along ``seq_axis``, rank order."""
    return _Gather.apply(x, seq_axis, group)


def slice_local(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/P contiguous slice of a replicated tensor along ``dim``
    (reference shrink_dim, vorta/ulysses/utils.py:218-223)."""
    return _Slice.apply(x, dim, group)


def local_expert_ids(expert_ids, group):
    """This rank's heads of a hard routing given as (ids on the device, the
    same ids on the host), as ``slice_local`` slices the scores; None stays."""
    if expert_ids is None:
        return None
    ids, host = expert_ids
    host = np.asarray(host).reshape(-1)
    n = host.shape[0] // dist.get_world_size(group)
    lo = dist.get_rank(group) * n
    return ids[lo:lo + n], host[lo:lo + n]
