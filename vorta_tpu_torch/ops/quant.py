"""Weight-only int4 / int8 quantization of stacked block weights, for
serving models whose bf16 blocks do not fit one card whole (counterpart of
vorta_tpu/ops/quant.py).

A stacked block state is a flat dict in the JAX package's layout: keys are
its ``jax.tree_util.keystr`` paths within the stack (e.g.
``"['attn1']['to_q']['kernel'].value"``), values (L, ...) tensors with the
layers first and Linear kernels (in, out).  ``quantize_stacked_tree``
replaces every large floating leaf by a ``QTensor``: symmetric
per-(layer, out-channel) scales, int8, or int4 packed 8 nibbles (+8) per
int32 word along the second-to-last axis.  The leaf decision is the JAX
package's, on that layout: ``nbytes >= min_bytes``, ``ndim >= 3`` and
``shape[-2] % 8 == 0`` (the port's nn.Linear weights are (out, in), so the
decision and the packing are made on the JAX layout, never on theirs).

``BlockStack`` serves such a stack: ``load(i, block)`` dequantizes layer
``i`` one leaf at a time into a working block's parameters (io/from_jax.py
maps each leaf onto its parameter), so a forward holds the quantized stack
plus one block in the working dtype.  The (de)quantize passes are plain
torch, as they are plain XLA in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .qmm import divide

MIN_BYTES = 1 << 22


@dataclasses.dataclass
class QTensor:
    """A quantized stacked weight."""

    q: torch.Tensor  # int8, or int32 words of 8 int4 nibbles; layers first
    scale: torch.Tensor  # (L, 1, ..., out) f32
    shape: tuple  # the dequantized shape, layers included
    dtype: torch.dtype  # the dequantized dtype
    bits: int

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, q=self.q.to(device), scale=self.scale.to(device))

    def tile(self, depth: int) -> "QTensor":
        """A one-layer QTensor repeated over ``depth`` layers."""
        reps = (depth,) + (1,) * (self.q.ndim - 1)
        return dataclasses.replace(self, q=self.q.repeat(reps),
                                   scale=self.scale.repeat((depth,) + (1,) * (self.scale.ndim - 1)),
                                   shape=(depth,) + tuple(self.shape[1:]))

    def first_layers(self, n: int) -> "QTensor":
        return dataclasses.replace(self, q=self.q[:n], scale=self.scale[:n],
                                   shape=(n,) + tuple(self.shape[1:]))

    @property
    def nbytes(self) -> int:
        return _nbytes(self.q) + _nbytes(self.scale)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def quantize_leaf(w: torch.Tensor, bits: int, out_dtype: Optional[torch.dtype] = None) -> QTensor:
    """Symmetric per-output-channel (last axis) quantization of (L, ..., out),
    the amax over every axis but the first and the last."""
    wf = w.float()
    red = tuple(range(1, wf.ndim - 1))
    amax = (wf.abs().amax(dim=red, keepdim=True) if red else wf.abs()).clamp(min=1e-12)
    if bits == 8:
        scale = divide(amax, 127.0)
        q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    elif bits == 4:
        if wf.ndim < 2 or wf.shape[-2] % 8:
            raise ValueError(f"int4 packing needs second-to-last dim % 8 == 0, got {tuple(wf.shape)}")
        scale = divide(amax, 7.0)
        q4 = (torch.round(wf / scale).clamp(-7, 7) + 8).to(torch.int64)  # [1, 15]
        words = torch.zeros(wf.shape[:-2] + (wf.shape[-2] // 8, wf.shape[-1]),
                            dtype=torch.int64, device=wf.device)
        for n in range(8):
            words |= q4[..., n::8, :] << (4 * n)
        # the uint32 words as int32, two's complement
        q = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return QTensor(q=q, scale=scale, shape=tuple(w.shape), dtype=out_dtype or w.dtype, bits=bits)


def dequantize(qt: QTensor, layer: Optional[int] = None) -> torch.Tensor:
    """The whole stack, or one layer of it, in the recorded dtype."""
    q, scale, shape = qt.q, qt.scale, tuple(qt.shape)
    if layer is not None:
        q, scale, shape = q[layer], scale[layer], shape[1:]
    if qt.bits == 8:
        w = q.float() * scale
    else:
        nibbles = torch.stack([((q >> (4 * n)) & 0xF) - 8 for n in range(8)], dim=-2)
        w = nibbles.reshape(shape[:-2] + (shape[-2], shape[-1])).float() * scale
    return w.reshape(shape).to(qt.dtype)


def dequantize_tree(qtree):
    """Every QTensor in a (nested) dict / list / tuple replaced by its
    dequantized tensor; other leaves as they are."""
    if isinstance(qtree, QTensor):
        return dequantize(qtree)
    if isinstance(qtree, dict):
        return {k: dequantize_tree(v) for k, v in qtree.items()}
    if isinstance(qtree, (list, tuple)):
        return type(qtree)(dequantize_tree(v) for v in qtree)
    return qtree


def quantizes(w: torch.Tensor, min_bytes: int = MIN_BYTES) -> bool:
    """The JAX package's leaf decision, on its (L, ..., in, out) layout."""
    return (w.is_floating_point() and _nbytes(w) >= min_bytes and w.ndim >= 3
            and w.shape[-2] % 8 == 0)


def quantize_stacked_tree(state: dict, bits: int = 4, min_bytes: int = MIN_BYTES,
                          out_dtype: Optional[torch.dtype] = None) -> dict:
    """Quantize every large floating leaf of a stacked block state; the small
    ones (norms, biases, tables) stay, cast to ``out_dtype`` when given."""
    out = {}
    for key, w in state.items():
        if quantizes(w, min_bytes):
            out[key] = quantize_leaf(w, bits, out_dtype)
        elif out_dtype is not None and w.is_floating_point():
            out[key] = w.to(out_dtype)
        else:
            out[key] = w
    return out


def quantized_bytes(state: dict) -> int:
    return sum(w.nbytes if isinstance(w, QTensor) else _nbytes(w) for w in state.values())


class BlockStack:
    """A stacked block state (leaves in the JAX layout, QTensors among
    them) served one layer at a time through a working block.

    ``stack``: which of the model's block lists it stands for ("blocks" of
    Wan, "dual_blocks" / "single_blocks" of HunyuanVideo), which fixes how
    its leaves map onto a block's parameters.
    """

    def __init__(self, leaves: dict, stack: str):
        self.leaves = dict(leaves)
        self.stack = stack
        depths = {w.shape[0] for w in leaves.values()}
        if len(depths) != 1:
            raise ValueError(f"leaves of {stack} disagree on the depth: {sorted(depths)}")
        self.num_layers = depths.pop()
        self._targets: dict = {}

    @property
    def nbytes(self) -> int:
        return quantized_bytes(self.leaves)

    def to(self, device) -> "BlockStack":
        return BlockStack({k: w.to(device) for k, w in self.leaves.items()}, self.stack)

    def first_layers(self, n: int) -> "BlockStack":
        """The stack cut to its first ``n`` layers (views)."""
        return BlockStack({k: w.first_layers(n) if isinstance(w, QTensor) else w[:n]
                           for k, w in self.leaves.items()}, self.stack)

    def _targets_for(self, block) -> dict:
        if id(block) not in self._targets:
            from ..io.from_jax import block_targets

            self._targets[id(block)] = block_targets(self.stack, block, list(self.leaves))
        return self._targets[id(block)]

    @torch.no_grad()
    def load(self, i: int, block, prefix: str = ""):
        """Copy layer ``i`` into ``block``'s parameters (those under
        ``prefix``, e.g. "router."), dequantizing one leaf at a time;
        returns the block."""
        for key, (param, row0, transpose) in self._targets_for(block).items():
            if not param.startswith(prefix):
                continue
            leaf = self.leaves[key]
            w = dequantize(leaf, i) if isinstance(leaf, QTensor) else leaf[i]
            if transpose:
                w = w.transpose(-1, -2)
            block.get_parameter(param)[row0:row0 + w.shape[0]].copy_(w)
        return block

    def set_leaf(self, key: str, value: torch.Tensor) -> None:
        """Replace one leaf (e.g. a router merged per layer, unquantized)."""
        if key not in self.leaves:
            raise KeyError(f"{self.stack} has no leaf {key}")
        old = self.leaves[key]
        if tuple(value.shape) != tuple(old.shape):
            raise ValueError(f"{key}: {tuple(value.shape)} != {tuple(old.shape)}")
        self.leaves[key] = value
