"""Layer-sharded frozen parameters (counterpart of vorta_tpu/parallel/fsdp.py).

For DiTs whose frozen weights exceed one card's memory (the reference
FSDP-shards the frozen 13-14B model, vorta/train/fsdp_utils.py), each rank
of a group keeps the frozen parameters of its 1/P of a block stack's
layers: ``shard_frozen_blocks`` frees the others' storage.  The block loop
then runs block i through ``sharded_block_fetcher``'s ``block_at(i)``: the
owner broadcasts the block's frozen parameters, the block runs on them
(``torch.func.functional_call``), and they are freed once nothing holds
them, so peak weight memory is params / P plus the live block (plus, under
autograd without recompute, every block whose backward is still to come).
A block's frozen parameters are views of one flat buffer per dtype, so a
fetch is one broadcast per dtype, not one per parameter.
Under per-block recompute the fetch runs again in the backward, as JAX's
psum does under ``jax.checkpoint``.  The routers (tiny, trained) stay
replicated: they are never sharded or fetched.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.distributed as dist
from torch import nn


def frozen_names(block: nn.Module) -> List[str]:
    """The block's parameters that are not a router's, by name."""
    return [n for n, _ in block.named_parameters() if "router" not in n.split(".")]


def _params(block: nn.Module) -> Dict[str, nn.Parameter]:
    return dict(block.named_parameters())


def shard_frozen_blocks(blocks: nn.ModuleList, group) -> None:
    """Keep this rank's contiguous 1/P of the blocks' frozen parameters.  An
    owned block's frozen parameters become views of flat buffers, one per
    dtype (``block._frozen_flat``); the other blocks' become empty tensors
    of their dtype and device.  Every block records the flat layout
    (``block._frozen_layout``: per dtype, its (name, shape, offset) entries
    and total size) and the group's (size, rank) as ``block._frozen_shard``."""
    p, me = dist.get_world_size(group), dist.get_rank(group)
    n = len(blocks)
    if n % p:
        raise ValueError(f"layer count {n} not divisible by the group's {p} ranks")
    per = n // p
    for i, block in enumerate(blocks):
        params = _params(block)
        layout: Dict[torch.dtype, tuple] = {}
        for k in frozen_names(block):
            entries, total = layout.get(params[k].dtype, ([], 0))
            entries.append((k, tuple(params[k].shape), total))
            layout[params[k].dtype] = (entries, total + params[k].numel())
        owned = i // per == me
        flats = []
        with torch.no_grad():
            for dtype, (entries, total) in layout.items():
                if owned:
                    flat = torch.cat([params[k].detach().reshape(-1) for k, _, _ in entries])
                    flats.append(flat)
                for k, shape, off in entries:
                    held = params[k]
                    held.data = (flat[off:off + held.numel()].view(shape) if owned
                                 else held.data.new_empty(0))
        block._frozen_layout = layout
        block._frozen_flat = flats if owned else None
        block._frozen_shard = (p, me)


def sharded_block_fetcher(blocks: nn.ModuleList, n_layers: int, group) -> Callable:
    """``block_at(i)``: a callable running block i on its frozen parameters
    broadcast from their owner rank (layers i // (n_layers / P) of the
    group), the routers the block's own.  ``blocks`` must hold this rank's
    layer shard (``shard_frozen_blocks`` over the same group)."""
    p, me = dist.get_world_size(group), dist.get_rank(group)
    if n_layers % p:
        raise ValueError(f"layer count {n_layers} not divisible by the group's {p} ranks")
    per = n_layers // p
    for i, block in enumerate(blocks):
        if getattr(block, "_frozen_shard", None) != (p, me):
            raise ValueError(
                f"block {i} does not hold group rank {me}'s layer shard (layers "
                f"{me * per}..{(me + 1) * per - 1} of {n_layers}); did you shard with "
                "shard_frozen_blocks over this group before the forward?")

    def block_at(i: int) -> Callable:
        block = blocks[i]
        owner = i // per
        src = dist.get_global_rank(group, owner)
        device = next(block.parameters()).device
        fetched = {}
        for j, (dtype, (entries, total)) in enumerate(block._frozen_layout.items()):
            flat = (block._frozen_flat[j] if owner == me
                    else torch.empty(total, dtype=dtype, device=device))
            dist.broadcast(flat, src, group=group)
            for k, shape, off in entries:
                fetched[k] = flat[off:off + math.prod(shape)].view(shape)

        def run(*args, **kwargs):
            return torch.func.functional_call(block, fetched, args, kwargs)

        return run

    return block_at
