"""Text encoders for HunyuanVideo conditioning: Llama and CLIP (counterpart
of vorta_tpu/models/text_encoders.py).

HunyuanVideo conditions on (a) the last-layer hidden states of a
Llama-3-8B style decoder run over a templated prompt (``crop_start`` strips
the template prefix), normed, and (b) the CLIP-L pooled text embedding at
the first EOS token.  Both operate on token ids (io/text.py tokenizes).
Their attentions are plain PyTorch products, as JAX's einsums are: Llama's
scores and softmax in f32 (GQA, rotate-half RoPE, causal and key masks),
CLIP's scores in the activation dtype with an f32 softmax (causal).  As in
JAX, CLIP's position embedding is an f32 parameter, so its residual stream
runs in f32 and each projection takes its input in the weights' dtype.
Parameter names follow the JAX modules (``io/from_jax.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .common import FP32LayerNorm, RMSNorm, init_flax_defaults
from .umt5 import embed_init_


# ---------------------------------------------------------------------------
# Llama (decoder-only, used as a text feature extractor)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128320
    dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    eps: float = 1e-5


LLAMA_8B = LlamaConfig()
LLAMA_TINY = LlamaConfig(
    vocab_size=256, dim=64, num_layers=2, num_heads=4, num_kv_heads=2,
    ffn_dim=128, rope_theta=10000.0,
)


@functools.lru_cache(maxsize=8)
def _llama_rope_np(seq_len: int, head_dim: int, theta: float):
    k = np.arange(head_dim // 2, dtype=np.float64)
    inv = theta ** (-2 * k / head_dim)
    ang = np.outer(np.arange(seq_len, dtype=np.float64), inv)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _llama_rope(seq_len: int, head_dim: int, theta: float, device=None):
    """(cos, sin), each (S, head_dim // 2) f32, angles in float64 on the host."""
    cos, sin = _llama_rope_np(seq_len, head_dim, theta)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rotate_half_apply(x, cos, sin):
    """HF Llama convention: rotate_half on split halves (not interleaved)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos_f = torch.cat([cos, cos], dim=-1)
    sin_f = torch.cat([sin, sin], dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos_f + rotated.float() * sin_f).to(x.dtype)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype, device):
        super().__init__()
        d = cfg.dim
        kv_dim = cfg.num_kv_heads * (d // cfg.num_heads)
        kw = dict(bias=False, dtype=dtype, device=device)
        self.cfg = cfg
        self.input_layernorm = RMSNorm(d, cfg.eps, device=device)
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, kv_dim, **kw)
        self.v_proj = nn.Linear(d, kv_dim, **kw)
        self.o_proj = nn.Linear(d, d, **kw)
        self.post_attention_layernorm = RMSNorm(d, cfg.eps, device=device)
        self.gate_proj = nn.Linear(d, cfg.ffn_dim, **kw)
        self.up_proj = nn.Linear(d, cfg.ffn_dim, **kw)
        self.down_proj = nn.Linear(cfg.ffn_dim, d, **kw)

    def forward(self, x, mask, rope):
        cfg = self.cfg
        b, s, d = x.shape
        hd = d // cfg.num_heads
        h = self.input_layernorm(x)
        q = self.q_proj(h).reshape(b, s, cfg.num_heads, hd).transpose(1, 2)
        k = self.k_proj(h).reshape(b, s, cfg.num_kv_heads, hd).transpose(1, 2)
        v = self.v_proj(h).reshape(b, s, cfg.num_kv_heads, hd).transpose(1, 2)
        cos, sin = rope
        q = _rotate_half_apply(q, cos, sin)
        k = _rotate_half_apply(k, cos, sin)
        rep = cfg.num_heads // cfg.num_kv_heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (hd**-0.5)
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(causal[None, None] & mask[:, None, None, :], scores, -1e9)
        attn = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v.float())
        x = x + self.o_proj(attn.to(x.dtype).transpose(1, 2).reshape(b, s, d))
        h = self.post_attention_layernorm(x)
        return x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class LlamaTextEncoder(nn.Module):
    """Decoder-only Llama returning last-layer hidden states (normed).
    ``device`` defaults to CUDA; weights random from ``seed``."""

    def __init__(self, cfg: LlamaConfig, *, dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=dtype, device=device)
        self.layers = nn.ModuleList(LlamaBlock(cfg, dtype=dtype, device=device)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.dim, cfg.eps, device=device)
        if device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(seed)
            init_flax_defaults(self, gen)
            embed_init_(self, gen)

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    def forward(self, input_ids: torch.Tensor, mask: torch.Tensor,
                crop_start: int = 0) -> torch.Tensor:
        """(B, S) ids + (B, S) mask -> (B, S - crop_start, dim) hidden states;
        ``crop_start`` strips the prompt-template prefix."""
        s = input_ids.shape[1]
        rope = _llama_rope(s, self.cfg.dim // self.cfg.num_heads, self.cfg.rope_theta,
                           input_ids.device)
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, mask, rope)
        return self.norm(x)[:, crop_start:]


# ---------------------------------------------------------------------------
# CLIP text encoder (pooled embedding)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_len: int = 77
    eps: float = 1e-5


CLIP_L = CLIPTextConfig()
CLIP_TINY = CLIPTextConfig(vocab_size=128, dim=32, num_layers=2, num_heads=2,
                           ffn_dim=64, max_len=16)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _lin(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A projection of ``x`` cast to the weights' dtype (Flax's Linear casts)."""
    return layer(x.to(layer.weight.dtype))


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, dtype, device):
        super().__init__()
        d = cfg.dim
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.layer_norm1 = FP32LayerNorm(d, cfg.eps, affine=True, device=device)
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)
        self.layer_norm2 = FP32LayerNorm(d, cfg.eps, affine=True, device=device)
        self.fc1 = nn.Linear(d, cfg.ffn_dim, **kw)
        self.fc2 = nn.Linear(cfg.ffn_dim, d, **kw)

    def forward(self, x, causal):
        cfg = self.cfg
        b, s, d = x.shape
        hd = d // cfg.num_heads
        h = self.layer_norm1.fp32(x)

        def heads(t):
            return t.reshape(b, s, cfg.num_heads, hd).transpose(1, 2)

        q, k, v = (heads(_lin(proj, h)) for proj in (self.q_proj, self.k_proj, self.v_proj))
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (hd**-0.5)
        scores = torch.where(causal, scores.float(), -1e9)
        # as in JAX: the probabilities in the residual stream's dtype (f32)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(probs.dtype))
        x = x + _lin(self.out_proj, attn.transpose(1, 2).reshape(b, s, d))
        return x + self.fc2(_quick_gelu(_lin(self.fc1, self.layer_norm2.fp32(x))))


class CLIPTextEncoder(nn.Module):
    """``device`` defaults to CUDA; weights random from ``seed``."""

    def __init__(self, cfg: CLIPTextConfig, *, dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=dtype, device=device)
        self.position_embedding = nn.Parameter(
            torch.empty((cfg.max_len, cfg.dim), dtype=torch.float32, device=device))
        self.blocks = nn.ModuleList(CLIPBlock(cfg, dtype=dtype, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_layer_norm = FP32LayerNorm(cfg.dim, cfg.eps, affine=True, device=device)
        if device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(seed)
            init_flax_defaults(self, gen)
            embed_init_(self, gen)
            with torch.no_grad():
                self.position_embedding.copy_(0.01 * torch.randn(
                    self.position_embedding.shape, generator=gen, device=device))

    @property
    def device(self) -> torch.device:
        return self.position_embedding.device

    def forward(self, input_ids: torch.Tensor, eos_token_id: int = 49407) -> torch.Tensor:
        """(B, S) -> pooled (B, dim) f32: the hidden state at the first EOS
        token, or at the last token where there is none."""
        b, s = input_ids.shape
        x = self.token_embedding(input_ids) + self.position_embedding[None, :s]
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()[None, None]
        for block in self.blocks:
            x = block(x, causal)
        x = self.final_layer_norm.fp32(x)
        is_eos = input_ids == eos_token_id
        idx = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1), s - 1)
        return x[torch.arange(b, device=x.device), idx]
