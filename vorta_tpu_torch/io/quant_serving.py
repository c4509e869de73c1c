"""Servable stacks for models whose bf16 blocks do not fit one card whole:
a depth-1 model plus quantized block weights (counterpart of
vorta_tpu/io/quant_serving.py, its random-init path).

``build_quantized_wan`` / ``build_quantized_hunyuan`` return
``(model, quantized_blocks)`` for ``WanT2VPipeline(...,
quantized_blocks=...)`` / ``HunyuanT2VPipeline``: the depth-1 model (depth
(1, 1) for HunyuanVideo) carries the non-block modules in the working dtype
and its one block of each kind is the working block each layer is
dequantized into (ops/quant.py ``BlockStack``); peak memory is the
quantized stack plus one such block.

As in the JAX package, one block is drawn from the seed (uniform in
+-0.025 for every leaf, numpy's generator in the JAX package's leaf order,
so the numbers are the JAX package's own), quantized with the leaf decision
scaled by 1 / depth (the threshold is defined on the full stack), and
tiled across the depth on the device; the leaves left unquantized are cast
to bf16.  Routers from a checkpoint are merged per layer, unquantized bf16.
The checkpoint path (real DiT weights) needs the diffusers weight importer,
``io/torch_import``, which is not ported: it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import MIN_BYTES, BlockStack, QTensor, quantize_stacked_tree
from .from_jax import block_leaf_shapes

ROUTER_KEYS = ("['router']['linear']['kernel'].value", "['router']['linear']['bias'].value")


def _refuse_checkpoint(checkpoint) -> None:
    if checkpoint:
        raise NotImplementedError(
            "quantized serving from a DiT checkpoint needs the diffusers weight importer "
            "(io/torch_import), which the port has not ported yet")


def random_block_stack(stack: str, block, depth: int, bits: int, seed: int,
                       device) -> BlockStack:
    """One block's state drawn from ``seed``, quantized, tiled to ``depth``."""
    rng = np.random.default_rng(seed)
    state = {key: torch.from_numpy((rng.random(shape, dtype=np.float32) - 0.5) * 0.05).to(device)
             for key, shape in block_leaf_shapes(stack, block, 1).items()}
    one = quantize_stacked_tree(state, bits=bits, min_bytes=max(1, MIN_BYTES // depth),
                                out_dtype=torch.bfloat16)
    del state
    return BlockStack({key: w.tile(depth) if isinstance(w, QTensor)
                       else w.repeat((depth,) + (1,) * (w.ndim - 1))
                       for key, w in one.items()}, stack)


def merge_routers(stack: BlockStack, router_state: dict, prefix: str) -> None:
    """Per-layer routers (``{f"{prefix}{i}.router.linear.weight": (out, dim),
    ...bias: (out,)}``, a port checkpoint's) into the stack, bf16."""
    n = stack.num_layers
    try:
        w = torch.stack([router_state[f"{prefix}{i}.router.linear.weight"].t() for i in range(n)])
        b = torch.stack([router_state[f"{prefix}{i}.router.linear.bias"] for i in range(n)])
    except KeyError as e:
        raise KeyError(f"router checkpoint lacks {e} for {n} layers of {stack.stack}") from None
    device = stack.leaves[ROUTER_KEYS[1]].device
    for key, value in zip(ROUTER_KEYS, (w, b)):
        stack.set_leaf(key, value.to(device=device, dtype=torch.bfloat16))


def _report(name: str, stacks, bits: int) -> None:
    nbytes = sum(s.nbytes for s in stacks)
    print(f"[quant-serve] {name} {'+'.join(str(s.num_layers) for s in stacks)}-block stack "
          f"quantized to int{bits}: {nbytes / 2**30:.2f} GiB", flush=True)


def build_quantized_wan(cfg, bits: int = 4, checkpoint: Optional[str] = None,
                        router_state: Optional[dict] = None, seed: int = 0,
                        dtype=torch.bfloat16, device=None):
    """(depth-1 WanModel, quantized ``cfg.num_layers``-block BlockStack)."""
    from ..models.wan import WanModel

    _refuse_checkpoint(checkpoint)
    device = resolve_device(device)
    model = WanModel(dataclasses.replace(cfg, num_layers=1), dtype=dtype, device=device,
                     seed=seed)
    stack = random_block_stack("blocks", model.blocks[0], cfg.num_layers, bits, seed, device)
    if router_state is not None:
        merge_routers(stack, router_state, "blocks.")
    _report("wan", [stack], bits)
    return model, stack


def build_quantized_hunyuan(cfg, bits: int = 4, checkpoint: Optional[str] = None,
                            seed: int = 0, dtype=torch.bfloat16, device=None):
    """(depth-(1, 1) HunyuanModel, (dual, single) quantized BlockStacks)."""
    from ..models.hunyuan import HunyuanModel

    _refuse_checkpoint(checkpoint)
    device = resolve_device(device)
    model = HunyuanModel(dataclasses.replace(cfg, dual_layers=1, single_layers=1), dtype=dtype,
                         device=device, seed=seed)
    stacks = (random_block_stack("dual_blocks", model.dual_blocks[0], cfg.dual_layers, bits,
                                 seed, device),
              random_block_stack("single_blocks", model.single_blocks[0], cfg.single_layers,
                                 bits, seed + 1, device))
    _report("hunyuan", stacks, bits)
    return model, stacks
