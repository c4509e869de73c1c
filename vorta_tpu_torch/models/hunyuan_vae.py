"""HunyuanVideo causal 3D VAE (counterpart of vorta_tpu/models/hunyuan_vae.py).

Causal 3D convolutions (the Wan VAE's ``CausalConv3d``, run over chunks of
frames), GroupNorm(32) + SiLU residual blocks, x8 spatial / x4 temporal
compression with the causal first-frame asymmetry, latents scaled by one
``scaling_factor``, spatial self-attention per frame in the mid-block.
Public layout channels-last (B, T, H, W, C), channels-first inside.

``GroupNorm`` is Flax's ``nnx.GroupNorm``: eps 1e-6 (PyTorch's default is
1e-5), statistics in f32 over (C / G, T, H, W), the whole clip, as the
mean and mean square (var = E[x^2] - E[x]^2, clamped at 0), output f32.
Its statistics span the clip, so the chunked convolutions
(models/wan_vae.py) cannot take them chunk by chunk: ``GroupNorm.stats``
sums them over the chunks first (in f64), then each chunk's prelude
applies them.  The nearest upsample (space x2, time x2 with the first
frame not duplicated) is likewise made per chunk inside the conv's loop.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from . import wan_vae
from .common import init_flax_defaults
from .wan_vae import CausalConv3d, _to_channels_first, _to_channels_last, frame_attention, up2


@dataclasses.dataclass(frozen=True)
class HunyuanVAEConfig:
    base_dims: Tuple[int, ...] = (128, 256, 512, 512)
    z_dim: int = 16
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.476986
    temporal_upsample: Tuple[bool, ...] = (True, True, False)  # per up stage


HUNYUAN_VAE = HunyuanVAEConfig()
HUNYUAN_VAE_TINY = HunyuanVAEConfig(
    base_dims=(8, 16, 16, 16), layers_per_block=1, norm_groups=4
)


class GroupNorm(nn.Module):
    """nnx.GroupNorm over channels-first (B, C, T, H, W), whole-clip
    statistics; ``scale`` / ``bias`` f32."""

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-6, *, device):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_channels, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, dtype=torch.float32, device=device))

    def stats(self, x: torch.Tensor):
        """(mean, multiplier), each (B, C, 1, 1, 1) f32: the group's mean and
        rsqrt(var + eps) x scale, summed over chunks of frames of at most
        ``CHUNK_ELEMENTS`` elements."""
        b, c, t = x.shape[:3]
        g = self.num_groups
        n = max(1, wan_vae.CHUNK_ELEMENTS // x[:, :, 0].numel())
        s1 = torch.zeros((b, g), dtype=torch.float64, device=x.device)
        s2 = torch.zeros_like(s1)
        for a in range(0, t, n):
            xf = x[:, :, a:a + n].float().reshape(b, g, -1)
            s1 += xf.sum(dim=-1, dtype=torch.float64)
            s2 += xf.square().sum(dim=-1, dtype=torch.float64)
        count = x[0].numel() // g
        mean = (s1 / count).float()
        var = torch.clamp(((s2 / count).float() - mean.square()), min=0.0)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(c // g, dim=1) * self.scale
        return (mean.repeat_interleave(c // g, dim=1)[:, :, None, None, None],
                mul[:, :, None, None, None])

    def normalize(self, x: torch.Tensor, stats) -> torch.Tensor:
        """Frames of the clip ``stats`` came from -> normed, f32."""
        mean, mul = stats
        return (x.float() - mean) * mul + self.bias[:, None, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalize(x, self.stats(x))


def _silu_norm(norm: GroupNorm, x: torch.Tensor):
    """The per-chunk prelude SiLU(GroupNorm(.)) under ``x``'s statistics."""
    stats = norm.stats(x)
    return lambda s: F.silu(norm.normalize(s, stats))


class GNResBlock(nn.Module):
    """GroupNorm + SiLU residual block with causal 3D convs."""

    def __init__(self, in_ch, out_ch, groups, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm(in_ch, min(groups, in_ch), device=device)
        self.conv1 = CausalConv3d(in_ch, out_ch, **kw)
        self.norm2 = GroupNorm(out_ch, min(groups, out_ch), device=device)
        self.conv2 = CausalConv3d(out_ch, out_ch, **kw)
        if in_ch != out_ch:
            self.shortcut = CausalConv3d(in_ch, out_ch, (1, 1, 1), **kw)

    def forward(self, x):
        h = self.conv1(x, _silu_norm(self.norm1, x))
        h = self.conv2(h, _silu_norm(self.norm2, h))
        return h.add_(self.shortcut(x) if hasattr(self, "shortcut") else x)


class GNSpatialAttention(nn.Module):
    """Single-head per-frame spatial self-attention (mid-block), the
    GroupNorm's statistics over the whole clip."""

    def __init__(self, dim, groups, *, dtype, device):
        super().__init__()
        self.norm = GroupNorm(dim, min(groups, dim), device=device)
        self.to_qkv = nn.Linear(dim, dim * 3, dtype=dtype, device=device)
        self.proj = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        stats = self.norm.stats(x)
        return frame_attention(x, lambda s: self.norm.normalize(s, stats), self.to_qkv, self.proj)


class CausalUpsample(nn.Module):
    """Nearest-neighbour x2 upsample (spatial always, temporal optional with
    the causal first-frame split: 2T - 1 output frames), then a causal conv,
    the upsampled frames made per chunk."""

    def __init__(self, dim, out_dim, temporal: bool, *, dtype, device):
        super().__init__()
        self.temporal = temporal
        self.conv = CausalConv3d(dim, out_dim, dtype=dtype, device=device)

    def forward(self, x):
        b, c, t, h, w = x.shape
        if self.temporal:  # frame j of [x0, x0, x1, x1, ...][1:] is x[(j + 1) // 2]
            def src(a, e):
                idx = torch.arange(a + 1, e + 1, device=x.device) // 2
                return up2(x.index_select(2, idx))
            return self.conv.run(src, 2 * t - 1, (b, c, 2 * h, 2 * w))
        return self.conv.run(lambda a, e: up2(x[:, :, a:e]), t, (b, c, 2 * h, 2 * w))


class CausalDownsample(nn.Module):
    """Strided causal conv: spatial /2 always, temporal /2 optional."""

    def __init__(self, dim, out_dim, temporal: bool, *, dtype, device):
        super().__init__()
        self.temporal = temporal
        self.conv = CausalConv3d(dim, out_dim, stride=(2 if temporal else 1, 2, 2),
                                 dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(x)


class HunyuanVAEDecoder(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        g = cfg.norm_groups
        dims = list(reversed(cfg.base_dims))  # e.g. [512, 512, 256, 128]
        top = dims[0]
        self.conv_in = CausalConv3d(cfg.z_dim, top, **kw)
        self.mid_block1 = GNResBlock(top, top, g, **kw)
        self.mid_attn = GNSpatialAttention(top, g, **kw)
        self.mid_block2 = GNResBlock(top, top, g, **kw)
        stages = []
        in_dim = top
        for i, out_dim in enumerate(dims):
            stage = nn.ModuleDict(dict(blocks=nn.ModuleList(
                GNResBlock(in_dim if j == 0 else out_dim, out_dim, g, **kw)
                for j in range(cfg.layers_per_block + 1))))
            if i != len(dims) - 1:
                t_up = cfg.temporal_upsample[i] if i < len(cfg.temporal_upsample) else False
                stage["up"] = CausalUpsample(out_dim, out_dim, t_up, **kw)
            stages.append(stage)
            in_dim = out_dim
        self.stages = nn.ModuleList(stages)
        self.norm_out = GroupNorm(dims[-1], min(g, dims[-1]), device=device)
        self.conv_out = CausalConv3d(dims[-1], 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T_lat, H_lat, W_lat, z) -> (B, 4(T-1)+1, 8H, 8W, 3)."""
        x = self.conv_in(_to_channels_first(z, self.conv_in.conv.weight.dtype))
        x = self.mid_block2(self.mid_attn(self.mid_block1(x)))
        for stage in self.stages:
            for block in stage["blocks"]:
                x = block(x)
            if "up" in stage:
                x = stage["up"](x)
        return _to_channels_last(self.conv_out(x, _silu_norm(self.norm_out, x)))


class HunyuanVAEEncoder(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        g = cfg.norm_groups
        dims = list(cfg.base_dims)
        self.conv_in = CausalConv3d(3, dims[0], **kw)
        stages = []
        in_dim = dims[0]
        # the encoder's temporal downsampling mirrors the decoder's upsample stages
        t_down = list(reversed(cfg.temporal_upsample))
        for i, out_dim in enumerate(dims):
            stage = nn.ModuleDict(dict(blocks=nn.ModuleList(
                GNResBlock(in_dim if j == 0 else out_dim, out_dim, g, **kw)
                for j in range(cfg.layers_per_block))))
            if i != len(dims) - 1:
                stage["down"] = CausalDownsample(out_dim, out_dim,
                                                 t_down[i] if i < len(t_down) else False, **kw)
            stages.append(stage)
            in_dim = out_dim
        self.stages = nn.ModuleList(stages)
        top = dims[-1]
        self.mid_block1 = GNResBlock(top, top, g, **kw)
        self.mid_attn = GNSpatialAttention(top, g, **kw)
        self.mid_block2 = GNResBlock(top, top, g, **kw)
        self.norm_out = GroupNorm(top, min(g, top), device=device)
        self.conv_out = CausalConv3d(top, cfg.z_dim * 2, **kw)

    def forward(self, video: torch.Tensor):
        """(B, T, H, W, 3) -> (mean, logvar), each (B, T_lat, H/8, W/8, z)."""
        x = self.conv_in(_to_channels_first(video, self.conv_in.conv.weight.dtype))
        for stage in self.stages:
            for block in stage["blocks"]:
                x = block(x)
            if "down" in stage:
                x = stage["down"](x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x)))
        out = _to_channels_last(self.conv_out(x, _silu_norm(self.norm_out, x)))
        return out.chunk(2, dim=-1)


class HunyuanVAE(nn.Module):
    """``device`` defaults to CUDA and raises without it; weights random
    from ``seed`` with Flax's default initialisers."""

    def __init__(self, cfg: HunyuanVAEConfig = HUNYUAN_VAE, *, dtype=torch.float32,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = HunyuanVAEEncoder(cfg, dtype=dtype, device=device)
        self.decoder = HunyuanVAEDecoder(cfg, dtype=dtype, device=device)
        if device.type != "meta":
            init_flax_defaults(self, torch.Generator(device=device).manual_seed(seed))

    def denormalize_latents(self, z: torch.Tensor) -> torch.Tensor:
        """Invert the pipeline's scaling (divide by ``scaling_factor``)."""
        return z / self.cfg.scaling_factor

    def decode(self, z: torch.Tensor, denormalize: bool = True) -> torch.Tensor:
        if denormalize:
            z = self.denormalize_latents(z)
        return self.decoder(z)

    def encode(self, video: torch.Tensor):
        return self.encoder(video)
