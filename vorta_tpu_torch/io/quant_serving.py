"""Servable stacks for models whose bf16 blocks do not fit one card whole:
a depth-1 model plus quantized block weights (counterpart of
vorta_tpu/io/quant_serving.py).

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
to bf16.  With a diffusers ``checkpoint`` the stack is the checkpoint's
(io/torch_import.py's map, in the JAX layout leaf by leaf, any leaf the
checkpoint lacks drawn from the seed as the JAX package draws its whole
host state first), quantized one leaf at a time on the device with the
same leaf decision on the full stack; the non-block modules go into the
depth-1 model.  Routers from a router checkpoint (a port step dir's, or a
reference router file's through io/torch_import.py) are merged per layer
afterwards, unquantized bf16.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import MIN_BYTES, BlockStack, QTensor, quantize_stacked_tree
from .from_jax import block_leaf_shapes, block_targets

ROUTER_KEYS = ("['router']['linear']['kernel'].value", "['router']['linear']['bias'].value")


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


def _skip_f32_draws(rng: np.random.Generator, n: int) -> None:
    """Move ``rng`` past ``n`` float32 uniforms without drawing them: each
    takes 32 bits of a 64-bit PCG64 output, the spare half kept for the
    next (numpy's buffered ``next_uint32``)."""
    if n == 0:
        return
    bits = rng.bit_generator
    if bits.state["has_uint32"]:  # the first takes the kept half
        st = bits.state
        st["has_uint32"] = 0
        bits.state = st
        n -= 1
    bits.advance(n // 2)  # drops any kept half, none here
    if n % 2:
        rng.random(1, dtype=np.float32)  # the last keeps its spare half


def checkpoint_block_stack(stack: str, block, depth: int, bits: int, seed: int, state: dict,
                           device) -> BlockStack:
    """The ``depth``-layer stack of ``state`` (the port's state dict, from
    io/torch_import.py) in the JAX layout: each leaf from the checkpoint,
    or, where it lacks one (a router), drawn from ``seed`` at the place the
    JAX package's draw of every leaf in order gives it; quantized (or cast
    to bf16) on ``device`` before the next is made."""
    rng = np.random.default_rng(seed)
    shapes = block_leaf_shapes(stack, block, depth)
    targets = block_targets(stack, block, list(shapes))
    leaves = {}
    for key, shape in shapes.items():
        param, row0, transpose = targets[key]
        names = [f"{stack}.{i}.{param}" for i in range(depth)]
        if not all(n in state for n in names):
            w = (rng.random(shape, dtype=np.float32) - 0.5) * 0.05
        else:
            _skip_f32_draws(rng, math.prod(shape))
            rows = shape[-1] if transpose else shape[1]
            layers = [state[n].float() for n in names]
            if transpose:  # nn.Linear (out, in) rows -> the JAX kernel (in, out)
                layers = [t[row0:row0 + rows].t() for t in layers]
            elif tuple(layers[0].shape) != tuple(shape[1:]):  # a fused projection's bias
                layers = [t[row0:row0 + rows] for t in layers]
            w = torch.stack(layers)
        w = torch.as_tensor(w).to(device)
        leaves.update(quantize_stacked_tree({key: w}, bits=bits, min_bytes=MIN_BYTES,
                                            out_dtype=torch.bfloat16))
        del w
    return BlockStack(leaves, stack)


def _import_checkpoint(model, checkpoint: str, cfg, stacks: tuple, bits: int, seed: int,
                       device) -> list:
    """The checkpoint's non-block modules into the depth-1 ``model``, its
    block stacks (``stacks``: (name, depth, seed offset)) quantized."""
    from .torch_import import (apply_state, hunyuan_state_dict_to_tree, load_state_dict,
                               wan_state_dict_to_tree)

    sd = load_state_dict(checkpoint)
    if hasattr(model, "dual_blocks"):
        state = hunyuan_state_dict_to_tree(sd, cfg.dual_layers, cfg.single_layers,
                                           cfg.refiner_layers, cfg.head_dim)
    else:
        state = wan_state_dict_to_tree(sd, cfg.num_layers, cfg.head_dim)
    del sd
    names = tuple(f"{name}." for name, _, _ in stacks)
    applied, missing = apply_state(model, {k: v for k, v in state.items()
                                           if not k.startswith(names)})
    out = [checkpoint_block_stack(name, getattr(model, name)[0], depth, bits, seed + off,
                                  state, device) for name, depth, off in stacks]
    n_block = sum(k.startswith(names) for k in state)
    print(f"[quant-serve] {checkpoint}: {n_block} block tensors + {len(applied)} non-block "
          f"tensors imported ({len(missing)} missing)", flush=True)
    return out


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


def _router_state(router_checkpoint, router_state, read):
    """The routers to merge: ``router_state`` (port-named tensors) or those
    ``read`` takes from the ``router_checkpoint`` path; not both."""
    if router_checkpoint is None:
        return router_state
    if router_state is not None:
        raise ValueError("pass router_checkpoint or router_state, not both")
    return read(router_checkpoint)


def build_quantized_wan(cfg, bits: int = 4, checkpoint: Optional[str] = None,
                        router_checkpoint: Optional[str] = None, seed: int = 0,
                        dtype=torch.bfloat16, device=None, router_state: Optional[dict] = None):
    """(depth-1 WanModel, quantized ``cfg.num_layers``-block BlockStack):
    the blocks of the diffusers ``checkpoint``, else drawn from ``seed``;
    the routers of ``router_checkpoint`` (a reference router file or a step
    dir of the port's trainer), or ``router_state``, a router checkpoint's
    port-named routers."""
    from ..models.wan import WanModel
    from .checkpoint import load_router_checkpoint
    from .torch_import import wan_router_state

    def read(path):
        if Path(path).suffix in (".pt", ".bin", ".safetensors"):
            return wan_router_state(path, cfg.num_layers)
        return load_router_checkpoint(path)[0]

    router_state = _router_state(router_checkpoint, router_state, read)
    device = resolve_device(device)
    model = WanModel(dataclasses.replace(cfg, num_layers=1), dtype=dtype, device=device,
                     seed=seed)
    if checkpoint:
        (stack,) = _import_checkpoint(model, checkpoint, cfg, (("blocks", cfg.num_layers, 0),),
                                      bits, seed, device)
    else:
        stack = random_block_stack("blocks", model.blocks[0], cfg.num_layers, bits, seed,
                                   device)
    if router_state is not None:
        merge_routers(stack, router_state, "blocks.")
    _report("wan", [stack], bits)
    return model, stack


def build_quantized_hunyuan(cfg, bits: int = 4, checkpoint: Optional[str] = None,
                            router_checkpoint: Optional[str] = None, seed: int = 0,
                            dtype=torch.bfloat16, device=None,
                            router_state: Optional[dict] = None):
    """(depth-(1, 1) HunyuanModel, (dual, single) quantized BlockStacks), as
    ``build_quantized_wan`` (the single stack drawn from ``seed + 1``;
    ``router_checkpoint`` a reference router file)."""
    from ..models.hunyuan import HunyuanModel
    from .torch_import import hunyuan_router_state

    router_state = _router_state(
        router_checkpoint, router_state,
        lambda path: hunyuan_router_state(path, cfg.dual_layers, cfg.single_layers))
    device = resolve_device(device)
    model = HunyuanModel(dataclasses.replace(cfg, dual_layers=1, single_layers=1), dtype=dtype,
                         device=device, seed=seed)
    if checkpoint:
        stacks = tuple(_import_checkpoint(
            model, checkpoint, cfg, (("dual_blocks", cfg.dual_layers, 0),
                                     ("single_blocks", cfg.single_layers, 1)),
            bits, seed, device))
    else:
        stacks = (random_block_stack("dual_blocks", model.dual_blocks[0], cfg.dual_layers,
                                     bits, seed, device),
                  random_block_stack("single_blocks", model.single_blocks[0],
                                     cfg.single_layers, bits, seed + 1, device))
    if router_state is not None:
        merge_routers(stacks[0], router_state, "dual_blocks.")
        merge_routers(stacks[1], router_state, "single_blocks.")
    _report("hunyuan", stacks, bits)
    return model, stacks
