"""UMT5 encoder for Wan's text conditioning (counterpart of
vorta_tpu/models/umt5.py).

Encoder only: token embedding -> N blocks of (RMSNorm -> self-attention with
a relative position bias -> residual, RMSNorm -> gated-GELU FFN -> residual)
-> final RMSNorm, padded positions zeroed.  UMT5 differs from T5 in that
every layer owns its relative-position bias.  The attention is T5's:
unscaled, scores and softmax in f32 with the key mask, a plain PyTorch
product as JAX's einsums are.  Parameter names follow the JAX modules so
that ``io/from_jax.py`` maps them one to one.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .common import RMSNorm, init_flax_defaults


@dataclasses.dataclass(frozen=True)
class UMT5Config:
    vocab_size: int = 256384
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    eps: float = 1e-6


UMT5_XXL = UMT5Config()
UMT5_TINY = UMT5Config(
    vocab_size=512, d_model=64, d_kv=16, num_heads=4, d_ff=128, num_layers=2
)


def relative_position_bucket(
    relative_position: np.ndarray, num_buckets: int = 32, max_distance: int = 128
) -> np.ndarray:
    """Bidirectional T5 bucket scheme (host-side, static per seq length)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


@functools.lru_cache(maxsize=8)
def _buckets(s: int, num_buckets: int, max_distance: int) -> np.ndarray:
    pos = np.arange(s)
    return relative_position_bucket(pos[None, :] - pos[:, None], num_buckets, max_distance)


def embed_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default Embed init below ``module``: normal, variance 1 / features."""
    for m in module.modules():
        if isinstance(m, nn.Embedding):
            w = torch.randn(m.weight.shape, generator=generator, device=m.weight.device)
            with torch.no_grad():
                m.weight.copy_(w / m.weight.shape[1] ** 0.5)


class UMT5Attention(nn.Module):
    def __init__(self, cfg: UMT5Config, *, dtype, device):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        kw = dict(bias=False, dtype=dtype, device=device)
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, **kw)
        self.k = nn.Linear(cfg.d_model, inner, **kw)
        self.v = nn.Linear(cfg.d_model, inner, **kw)
        self.o = nn.Linear(inner, cfg.d_model, **kw)
        # per-layer relative position bias (the UMT5 difference)
        self.rel_bias = nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads,
                                     dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        h, dk = cfg.num_heads, cfg.d_kv

        def heads(t):
            return t.reshape(b, s, h, dk).transpose(1, 2).float()

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        buckets = torch.from_numpy(_buckets(s, cfg.relative_attention_num_buckets,
                                            cfg.relative_attention_max_distance))
        bias = self.rel_bias(buckets.to(x.device)).permute(2, 0, 1)[None].float()  # (1, H, S, S)
        # T5 attention is unscaled (the scale is folded into its init)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias
        scores = torch.where(mask[:, None, None, :], scores, -1e9)
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)
        return self.o(out.to(x.dtype).transpose(1, 2).reshape(b, s, h * dk))


class UMT5FFN(nn.Module):
    def __init__(self, cfg: UMT5Config, *, dtype, device):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)  # gate
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class UMT5Block(nn.Module):
    def __init__(self, cfg: UMT5Config, *, dtype, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, cfg.eps, device=device)
        self.attn = UMT5Attention(cfg, dtype=dtype, device=device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.eps, device=device)
        self.ffn = UMT5FFN(cfg, dtype=dtype, device=device)

    def forward(self, x, mask):
        x = x + self.attn(self.norm1(x), mask)
        return x + self.ffn(self.norm2(x))


class UMT5Encoder(nn.Module):
    """``device`` defaults to CUDA and raises without it.  Weights are random,
    drawn from ``seed`` with Flax's default initialisers; ``io/from_jax.py``
    and ``io/torch_import.py`` carry real ones across."""

    def __init__(self, cfg: UMT5Config, *, dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=dtype, device=device)
        self.blocks = nn.ModuleList(UMT5Block(cfg, dtype=dtype, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.eps, device=device)
        if device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(seed)
            init_flax_defaults(self, gen)
            embed_init_(self, gen)

    @property
    def device(self) -> torch.device:
        return self.final_norm.weight.device

    def forward(self, input_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """input_ids (B, S) int, mask (B, S) bool -> (B, S, d_model); outputs
        at padded positions are zeroed."""
        x = self.embed(input_ids)
        for block in self.blocks:
            x = block(x, mask)
        x = self.final_norm(x)
        return x * mask[:, :, None].to(x.dtype)
