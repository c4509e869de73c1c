"""Tiled VAE decoding (counterpart of vorta_tpu/models/vae_tiling.py).

The latent grid is decoded in overlapping spatial (and temporal) tiles
whose outputs are blended linearly across the overlaps, bounding peak
activation memory by the tile instead of the clip (diffusers'
``vae.enable_tiling()``, which the reference turns on for HunyuanVideo
720p).  Works for both VAEs (causal x8 spatial / x4 temporal with the
first-frame asymmetry).  Tile starts, ramps, weights and placement are the
JAX package's own; the blend accumulates in f32 on the latents' device,
not on the host per tile.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

SPATIAL = 8  # pixel / latent
TEMPORAL = 4  # frames / latent frame (causal: 4(T-1)+1)


def _starts(total: int, tile: int, overlap: int):
    """Tile start offsets with `overlap` latent rows shared between tiles."""
    if total <= tile:
        return [0]
    stride = tile - overlap
    starts = list(range(0, total - tile, stride))
    starts.append(total - tile)
    return starts


def _ramp(n: int):
    return (np.arange(n, dtype=np.float32) + 1.0) / (n + 1.0)


def _edge(wgt: torch.Tensor, axis: int, n: int, lead: bool) -> None:
    """Multiply the first (``lead``) or last ``n`` entries of ``wgt`` along
    ``axis`` by the rising or falling ramp, in place."""
    r = torch.from_numpy(_ramp(n) if lead else _ramp(n)[::-1].copy()).to(wgt.device)
    shape = [1] * wgt.dim()
    shape[axis] = n
    sl = wgt.narrow(axis, 0 if lead else wgt.shape[axis] - n, n)
    sl.mul_(r.reshape(shape))


def tiled_decode(
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,  # (B, T_lat, H_lat, W_lat, C), already denormalized
    tile_latent: Tuple[int, int, int] = (16, 32, 32),
    overlap_latent: Tuple[int, int, int] = (4, 8, 8),
) -> torch.Tensor:
    """Decode ``z`` in overlapping tiles, blending linearly at the seams.

    ``decode_fn`` maps a latent tile (B, t, h, w, C) -> pixels
    (B, 4(t-1)+1, 8h, 8w, 3).  Later temporal tiles start at frame 4 t0;
    every overlap is ramped on both sides (the leading edge of the later
    tile, the trailing edge of the earlier), so the normalised blend
    crossfades with no step at tile boundaries.  One tile: ``decode_fn(z)``
    as it is; else (B, T, H, W, 3) f32 on ``z``'s device."""
    b, t, h, w, _ = z.shape
    tt, th, tw = min(tile_latent[0], t), min(tile_latent[1], h), min(tile_latent[2], w)
    t_starts = _starts(t, tt, overlap_latent[0])
    h_starts = _starts(h, th, overlap_latent[1])
    w_starts = _starts(w, tw, overlap_latent[2])
    if len(t_starts) == 1 and len(h_starts) == 1 and len(w_starts) == 1:
        return decode_fn(z)

    out_t = TEMPORAL * (t - 1) + 1
    out = torch.zeros((b, out_t, SPATIAL * h, SPATIAL * w, 3), dtype=torch.float32,
                      device=z.device)
    weight = torch.zeros((1, out_t, SPATIAL * h, SPATIAL * w, 1), dtype=torch.float32,
                         device=z.device)
    ramps = ((TEMPORAL * overlap_latent[0], t_starts), (SPATIAL * overlap_latent[1], h_starts),
             (SPATIAL * overlap_latent[2], w_starts))
    for t0 in t_starts:
        for h0 in h_starts:
            for w0 in w_starts:
                px = decode_fn(z[:, t0:t0 + tt, h0:h0 + th, w0:w0 + tw]).float()
                pt0, ph0, pw0 = TEMPORAL * t0, SPATIAL * h0, SPATIAL * w0
                ptn, phn, pwn = px.shape[1:4]
                wgt = torch.ones((1, ptn, phn, pwn, 1), dtype=torch.float32, device=z.device)
                for axis, (start, (n, starts)) in enumerate(zip((t0, h0, w0), ramps), 1):
                    if start > 0:
                        _edge(wgt, axis, n, lead=True)
                    if start != starts[-1]:
                        _edge(wgt, axis, n, lead=False)
                region = (slice(None), slice(pt0, pt0 + ptn), slice(ph0, ph0 + phn),
                          slice(pw0, pw0 + pwn))
                out[region] += px * wgt
                weight[region] += wgt
    return out / torch.clamp(weight, min=1e-8)
