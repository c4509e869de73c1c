"""Wan 2.1 causal 3D VAE (counterpart of vorta_tpu/models/wan_vae.py).

Causal 3D convolutions (temporal padding only on the past), RMS-normalised
residual blocks, spatial attention in the mid-block, x8 spatial and x4
temporal compression with the causal first-frame asymmetry (T_pixels =
4 * (T_latent - 1) + 1).  Temporal upsampling doubles every frame through a
2C time-conv, then drops the first duplicate.  The public layout is JAX's,
channels-last (B, T, H, W, C); inside, activations are channels-first
(B, C, T, H, W) for cuDNN.

Whole-clip decode on one card.  JAX decodes the whole clip at once.  At
480p x 77f the last stages hold 77 x 480 x 832 pixels at 192 and 96
channels, 5.9e9 and 2.95e9 elements, over 2^31.  So every convolution here
runs over chunks of output frames (``conv3d_frames``), each chunk's input
made frame range by frame range from its source with a (kt - 1)-frame
past halo: the norm and SiLU before a conv, or the nearest upsample, are
applied per chunk inside the conv's loop and never to the whole clip
(whose f32 norm alone would hold 23.6 GB more at 192 channels), and no
cuDNN call takes more than ``CHUNK_ELEMENTS`` elements (one frame where a
frame holds more), far under the 32-bit index range.  This is the same
function: the convs are causal in time, the halo gives each output frame
all its inputs, and the norms are per voxel (HunyuanVAE's GroupNorm, whose
statistics span the clip, sums them over the chunks first:
models/hunyuan_vae.py).  The convolutions themselves stay ``F.conv3d``
(cuDNN), as JAX computes them with XLA's conv, and the mid-block attention
a plain product in f32, per chunk of frames.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .common import init_flax_defaults

CHUNK_ELEMENTS = 1 << 29  # the most elements a chunk's conv input (or f32 scores) holds

Source = Callable[[int, int], torch.Tensor]  # (a, b) -> frames [a, b), (B, C, b - a, H, W)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    latents_mean: Tuple[float, ...] = (
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
    )
    latents_std: Tuple[float, ...] = (
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
    )


WAN_VAE = WanVAEConfig()
WAN_VAE_TINY = WanVAEConfig(base_dim=8, dim_mult=(1, 2, 2, 2), num_res_blocks=1)


def conv3d_frames(conv: nn.Conv3d, src: Source, t_in: int, frame_shape, pad_t: int,
                  pad_hw: Tuple[int, int, int, int]) -> torch.Tensor:
    """``conv`` (no padding of its own) over frames [0, t_in) of a clip that
    ``src`` makes range by range, each frame (B, C, H, W) = ``frame_shape``,
    with ``pad_t`` zero frames in front (causal) and zero pads (top, bottom,
    left, right) around each frame.  Runs over chunks of output frames whose
    input holds at most ``CHUNK_ELEMENTS`` elements (and whose output at
    most as many), so no cuDNN call sees more.  -> (B, Cout, T_out, Ho, Wo)
    in the conv's dtype."""
    kt, kh, kw = conv.kernel_size
    st, sh, sw = conv.stride
    b, _, h, w = frame_shape
    top, bottom, left, right = pad_hw
    ho, wo = (h + top + bottom - kh) // sh + 1, (w + left + right - kw) // sw + 1
    t_out = (t_in + pad_t - kt) // st + 1
    in_frame = b * frame_shape[1] * (h + top + bottom) * (w + left + right)
    out_frame = b * conv.out_channels * ho * wo
    n = max(1, min((CHUNK_ELEMENTS // in_frame - kt) // st + 1, CHUNK_ELEMENTS // out_frame))
    symmetric = top == bottom and left == right
    out = None
    for o0 in range(0, t_out, n):
        o1 = min(t_out, o0 + n)
        a = o0 * st - pad_t  # the chunk's input frames [a, e)
        e = (o1 - 1) * st + kt - pad_t
        xin = src(max(a, 0), e).to(conv.weight.dtype)
        front = max(0, -a)
        if symmetric:
            if front:
                xin = F.pad(xin, (0, 0, 0, 0, front, 0))
            y = F.conv3d(xin, conv.weight, conv.bias, (st, sh, sw), (0, top, left))
        else:
            xin = F.pad(xin, (left, right, top, bottom, front, 0))
            y = F.conv3d(xin, conv.weight, conv.bias, (st, sh, sw))
        if out is None:
            out = y.new_empty((b, conv.out_channels, t_out, ho, wo))
        out[:, :, o0:o1] = y
    return out


def _slices(x: torch.Tensor, prelude=None) -> Source:
    if prelude is None:
        return lambda a, e: x[:, :, a:e]
    return lambda a, e: prelude(x[:, :, a:e])


def up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 in H and W of (B, C, T, H, W)."""
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


class CausalConv3d(nn.Module):
    """Conv3d with symmetric spatial padding ((k - 1) // 2, k // 2) and
    past-only temporal padding, run frame chunk by frame chunk."""

    def __init__(self, in_ch, out_ch, kernel: Tuple[int, int, int] = (3, 3, 3),
                 stride: Tuple[int, int, int] = (1, 1, 1), *, dtype, device):
        super().__init__()
        self.kernel = tuple(kernel)
        self.conv = nn.Conv3d(in_ch, out_ch, kernel, stride, dtype=dtype, device=device)

    def run(self, src: Source, t_in: int, frame_shape) -> torch.Tensor:
        """The conv over a clip that ``src`` makes frame range by range."""
        kt, kh, kw = self.kernel
        pads = ((kh - 1) // 2, kh // 2, (kw - 1) // 2, kw // 2)
        return conv3d_frames(self.conv, src, t_in, frame_shape, kt - 1, pads)

    def forward(self, x: torch.Tensor, prelude=None) -> torch.Tensor:
        """(B, C, T, H, W); ``prelude`` (a per-frame function, e.g. norm +
        SiLU) is applied to each chunk's input frames."""
        return self.run(_slices(x, prelude), x.shape[2], x[:, :, 0].shape)


class ChannelRMSNorm(nn.Module):
    """RMS norm over the channel axis (Wan VAE RMS_norm), in f32, eps 1e-12."""

    def __init__(self, dim: int, *, device):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-first (B, C, ...) -> x.dtype."""
        xf = x.float()
        rms = torch.rsqrt(xf.square().mean(dim=1, keepdim=True) + 1e-12)
        gamma = self.gamma.reshape((1, -1) + (1,) * (x.dim() - 2))
        return (xf * rms * gamma).to(x.dtype)


class ResidualBlock(nn.Module):
    def __init__(self, in_ch, out_ch, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = ChannelRMSNorm(in_ch, device=device)
        self.conv1 = CausalConv3d(in_ch, out_ch, **kw)
        self.norm2 = ChannelRMSNorm(out_ch, device=device)
        self.conv2 = CausalConv3d(out_ch, out_ch, **kw)
        if in_ch != out_ch:
            self.shortcut = CausalConv3d(in_ch, out_ch, (1, 1, 1), **kw)

    def forward(self, x):
        h = self.conv1(x, lambda s: F.silu(self.norm1(s)))
        h = self.conv2(h, lambda s: F.silu(self.norm2(s)))
        return h.add_(self.shortcut(x) if hasattr(self, "shortcut") else x)


def frame_attention(x: torch.Tensor, norm, to_qkv: nn.Linear, proj: nn.Linear) -> torch.Tensor:
    """``x + proj(attention(norm(x)))``, single-head self-attention over each
    frame's H x W grid of (B, C, T, H, W): scores, softmax and the product in
    f32, over chunks of frames whose f32 scores hold at most
    ``CHUNK_ELEMENTS`` elements.  ``norm`` maps a chunk to its normed frames."""
    b, c, t, hh, ww = x.shape
    n = max(1, CHUNK_ELEMENTS // (b * (hh * ww) ** 2))
    out = torch.empty_like(x)
    for a in range(0, t, n):
        xs = x[:, :, a:a + n]
        m = xs.shape[2]
        tok = norm(xs).permute(0, 2, 3, 4, 1).reshape(b * m, hh * ww, c)
        q, k, v = to_qkv(tok.to(to_qkv.weight.dtype)).float().chunk(3, dim=-1)
        probs = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * (c**-0.5), dim=-1)
        o = proj(torch.bmm(probs, v).to(x.dtype))
        out[:, :, a:a + m] = xs + o.reshape(b, m, hh, ww, c).permute(0, 4, 1, 2, 3)
    return out


class SpatialAttention(nn.Module):
    """Single-head self-attention over each frame's spatial grid."""

    def __init__(self, dim, *, dtype, device):
        super().__init__()
        self.norm = ChannelRMSNorm(dim, device=device)
        self.to_qkv = nn.Linear(dim, dim * 3, dtype=dtype, device=device)
        self.proj = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        return frame_attention(x, self.norm, self.to_qkv, self.proj)


class SpatialDownsample(nn.Module):
    """Pad (0, 1) in H and W, then a (1, 3, 3) conv of stride (1, 2, 2)."""

    def __init__(self, dim, *, dtype, device):
        super().__init__()
        self.conv = nn.Conv3d(dim, dim, (1, 3, 3), (1, 2, 2), dtype=dtype, device=device)

    def forward(self, x):
        return conv3d_frames(self.conv, _slices(x), x.shape[2], x[:, :, 0].shape, 0,
                             (0, 1, 0, 1))


class TemporalDownsample(nn.Module):
    def __init__(self, dim, *, dtype, device):
        super().__init__()
        self.conv = CausalConv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), dtype=dtype,
                                 device=device)

    def forward(self, x):
        return self.conv(x)


class SpatialUpsample(nn.Module):
    """Nearest x2 in H and W, then a (1, 3, 3) conv ("SAME"), per chunk."""

    def __init__(self, dim, out_dim, *, dtype, device):
        super().__init__()
        self.conv = nn.Conv3d(dim, out_dim, (1, 3, 3), dtype=dtype, device=device)

    def forward(self, x):
        b, c, t, h, w = x.shape
        return conv3d_frames(self.conv, _slices(x, up2), t, (b, c, 2 * h, 2 * w), 0,
                             (1, 1, 1, 1))


class TemporalUpsample(nn.Module):
    """Double frames causally: 2C time-conv -> interleave -> drop first dup."""

    def __init__(self, dim, *, dtype, device):
        super().__init__()
        self.conv = CausalConv3d(dim, dim * 2, (3, 1, 1), dtype=dtype, device=device)

    def forward(self, x):
        b, c, t, h, w = x.shape
        y = self.conv(x).view(b, 2, c, t, h, w)  # channel k * C + c -> frame 2t + k
        y = y.permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * t, h, w)
        return y[:, :, 1:]  # causal first-frame asymmetry: 2T - 1 frames


def _to_channels_first(z: torch.Tensor, dtype) -> torch.Tensor:
    return z.to(dtype).permute(0, 4, 1, 2, 3).contiguous()


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


class WanVAEDecoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        dims = [cfg.base_dim * m for m in cfg.dim_mult]  # e.g. [96, 192, 384, 384]
        top = dims[-1]
        self.conv_in = CausalConv3d(cfg.z_dim, top, **kw)
        self.mid_block1 = ResidualBlock(top, top, **kw)
        self.mid_attn = SpatialAttention(top, **kw)
        self.mid_block2 = ResidualBlock(top, top, **kw)
        stages = []
        in_dim = top
        rev_dims = list(reversed(dims))
        rev_tdown = list(reversed(cfg.temporal_downsample))
        for i, out_dim in enumerate(rev_dims):
            stage = nn.ModuleDict(dict(blocks=nn.ModuleList(
                ResidualBlock(in_dim if j == 0 else out_dim, out_dim, **kw)
                for j in range(cfg.num_res_blocks + 1))))
            if i < len(rev_tdown) and rev_tdown[i]:
                stage["t_up"] = TemporalUpsample(out_dim, **kw)
            if i != len(rev_dims) - 1:
                stage["s_up"] = SpatialUpsample(out_dim, out_dim, **kw)
            stages.append(stage)
            in_dim = out_dim
        self.stages = nn.ModuleList(stages)
        self.norm_out = ChannelRMSNorm(dims[0], device=device)
        self.conv_out = CausalConv3d(dims[0], 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T_lat, H_lat, W_lat, z_dim) -> (B, 4(T-1)+1, 8H, 8W, 3)."""
        x = self.conv_in(_to_channels_first(z, self.conv_in.conv.weight.dtype))
        x = self.mid_block2(self.mid_attn(self.mid_block1(x)))
        for stage in self.stages:
            for block in stage["blocks"]:
                x = block(x)
            for name in ("t_up", "s_up"):
                if name in stage:
                    x = stage[name](x)
        return _to_channels_last(self.conv_out(x, lambda s: F.silu(self.norm_out(s))))


class WanVAEEncoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        dims = [cfg.base_dim * m for m in cfg.dim_mult]
        self.conv_in = CausalConv3d(3, dims[0], **kw)
        stages = []
        in_dim = dims[0]
        for i, out_dim in enumerate(dims):
            stage = nn.ModuleDict(dict(blocks=nn.ModuleList(
                ResidualBlock(in_dim if j == 0 else out_dim, out_dim, **kw)
                for j in range(cfg.num_res_blocks))))
            if i != len(dims) - 1:
                stage["s_down"] = SpatialDownsample(out_dim, **kw)
                if cfg.temporal_downsample[i]:
                    stage["t_down"] = TemporalDownsample(out_dim, **kw)
            stages.append(stage)
            in_dim = out_dim
        self.stages = nn.ModuleList(stages)
        top = dims[-1]
        self.mid_block1 = ResidualBlock(top, top, **kw)
        self.mid_attn = SpatialAttention(top, **kw)
        self.mid_block2 = ResidualBlock(top, top, **kw)
        self.norm_out = ChannelRMSNorm(top, device=device)
        self.conv_out = CausalConv3d(top, cfg.z_dim * 2, **kw)

    def forward(self, video: torch.Tensor):
        """(B, T, H, W, 3) -> (mean, logvar) each (B, T_lat, H/8, W/8, z)."""
        x = self.conv_in(_to_channels_first(video, self.conv_in.conv.weight.dtype))
        for stage in self.stages:
            for block in stage["blocks"]:
                x = block(x)
            for name in ("s_down", "t_down"):
                if name in stage:
                    x = stage[name](x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x)))
        out = _to_channels_last(self.conv_out(x, lambda s: F.silu(self.norm_out(s))))
        return out.chunk(2, dim=-1)


class WanVAE(nn.Module):
    """``device`` defaults to CUDA and raises without it; weights random
    from ``seed`` with Flax's default initialisers (``io/from_jax.py`` and
    ``io/torch_import.py`` carry real ones across)."""

    def __init__(self, cfg: WanVAEConfig = WAN_VAE, *, dtype=torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = WanVAEEncoder(cfg, dtype=dtype, device=device)
        self.decoder = WanVAEDecoder(cfg, dtype=dtype, device=device)
        if device.type != "meta":
            init_flax_defaults(self, torch.Generator(device=device).manual_seed(seed))

    def denormalize_latents(self, z: torch.Tensor) -> torch.Tensor:
        """Invert the pipeline's latent normalisation (per channel)."""
        std = torch.tensor(self.cfg.latents_std, dtype=torch.float32, device=z.device)
        mean = torch.tensor(self.cfg.latents_mean, dtype=torch.float32, device=z.device)
        return z * std + mean

    def decode(self, z: torch.Tensor, denormalize: bool = True) -> torch.Tensor:
        if denormalize:
            z = self.denormalize_latents(z)
        return self.decoder(z)

    def encode(self, video: torch.Tensor):
        return self.encoder(video)


@contextlib.contextmanager
def chunk_budget(elements: int):
    """Within the block, ``CHUNK_ELEMENTS`` is ``elements`` (``1 << 62``: no
    limit, every conv and attention one call over the whole clip, the
    reference the chunked decode is held against); restored on exit."""
    global CHUNK_ELEMENTS
    old, CHUNK_ELEMENTS = CHUNK_ELEMENTS, elements
    try:
        yield
    finally:
        CHUNK_ELEMENTS = old
