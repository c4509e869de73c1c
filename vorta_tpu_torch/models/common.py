"""Shared model building blocks (counterpart of vorta_tpu/models/common.py).

LayerNorms compute in float32 whatever the activation dtype (diffusers
FP32LayerNorm semantics); qk RMSNorm runs across the full projected dim
before the head split; the timestep embedding is the flip_sin_to_cos
sinusoid, ``[cos, sin]``.  Parameter names follow the JAX modules so that
``io/from_jax.py`` maps them one to one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's default kernel init: truncated normal (+-2 std) with variance
    1/fan_in, drawn in f32 from ``generator`` and cast into ``weight``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(weight.shape, dtype=torch.float32, device=weight.device)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        weight.copy_(w)


def init_flax_defaults(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every Linear / Conv3d below ``module`` as Flax would:
    lecun-normal kernels, zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv3d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()


class FP32LayerNorm(nn.Module):
    """LayerNorm computed in f32, output cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, affine: bool = False, *, device=None):
        super().__init__()
        self.eps = eps
        self.affine = affine
        if affine:
            self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
            self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def fp32(self, x: torch.Tensor) -> torch.Tensor:
        """The normalisation, keeping the f32 result."""
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            out = out * self.scale[None] + self.bias[None]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fp32(x).to(x.dtype)

    def modulated(self, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``norm(x) * (1 + scale) + shift`` -> x.dtype (AdaLN), one pass
        through the fused-norm kernel.  scale/shift: (B, dim) f32; ``out``: a
        view to write the result into (forward only)."""
        from ..ops.fused_norm import fused_norm

        gamma = self.scale if self.affine else None
        beta = self.bias if self.affine else None
        return fused_norm(x, scale, shift, gamma, beta, False, self.eps, False, out)


class RMSNorm(nn.Module):
    """RMSNorm with learnable gain, computed in f32."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        rms = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * rms * self.weight[None]).to(x.dtype)


def sinusoidal_timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """diffusers get_timestep_embedding: t (B,) -> (B, dim) f32, [cos, sin]
    with ``flip_sin_to_cos`` (the models' default) else [sin, cos], an odd
    ``dim`` padded with a zero column."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear on the sinusoid."""

    def __init__(self, in_dim: int, dim: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class GELUFeedForward(nn.Module):
    """linear -> tanh-approximate gelu -> linear; both projections obey the
    int8 switch (ops/qmm.py QLinear), named ``<site_prefix>.proj_in`` /
    ``.proj_out`` for the static-scale table, or unnamed (dynamic scales)."""

    def __init__(self, dim: int, inner_dim: int, *, dtype=torch.float32, device=None,
                 site_prefix: Optional[str] = None):
        super().__init__()
        from ..ops.qmm import QLinear

        def site(name):
            return f"{site_prefix}.{name}" if site_prefix else None

        self.proj_in = QLinear(dim, inner_dim, dtype=dtype, device=device, site=site("proj_in"))
        self.proj_out = QLinear(inner_dim, dim, dtype=dtype, device=device,
                                site=site("proj_out"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(F.gelu(self.proj_in(x), approximate="tanh"))


class TextProjection(nn.Module):
    """linear -> tanh gelu -> linear (diffusers PixArtAlphaTextProjection)."""

    def __init__(self, in_dim: int, dim: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(x), approximate="tanh"))
