"""3D rotary position embeddings for video DiTs (counterpart of
vorta_tpu/ops/rope.py).

Rotation angles are a pure function of the static latent grid: computed
host-side in numpy float64, then cos/sin cast to float32.  Head-dim split
across axes: t gets ``d/2 - 2*(d/6)`` complex frequencies, h and w get
``d/6`` each (for d=128: 22/21/21).  The model uses the contiguous-half
layout (``apply_rope_half``); q/k projection columns and qk-norm gains are
stored permuted to match (``permute_qk_to_half``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Shape3 = Tuple[int, int, int]


def _axis_angles(num_pos: int, num_freqs: int, theta: float) -> np.ndarray:
    """angle[p, k] = p * theta**(-k / num_freqs), float64."""
    k = np.arange(num_freqs, dtype=np.float64)
    inv_freq = theta ** (-k / num_freqs)
    pos = np.arange(num_pos, dtype=np.float64)
    return np.outer(pos, inv_freq)


def rope_axis_split(head_dim: int) -> Tuple[int, int, int]:
    """Number of complex frequency slots per (t, h, w) axis."""
    d6 = head_dim // 6
    return head_dim // 2 - 2 * d6, d6, d6


def video_rope_angles(latent_shape: Shape3, head_dim: int, theta: float = 10000.0) -> np.ndarray:
    """Per-token rotation angles, (S, head_dim // 2) float64, raster token order."""
    t, h, w = latent_shape
    ct, ch, cw = rope_axis_split(head_dim)
    at = _axis_angles(t, ct, theta)
    ah = _axis_angles(h, ch, theta)
    aw = _axis_angles(w, cw, theta)
    full = np.concatenate(
        [
            np.broadcast_to(at[:, None, None, :], (t, h, w, ct)),
            np.broadcast_to(ah[None, :, None, :], (t, h, w, ch)),
            np.broadcast_to(aw[None, None, :, :], (t, h, w, cw)),
        ],
        axis=-1,
    )
    return full.reshape(t * h * w, head_dim // 2)


def rope_cos_sin(latent_shape: Shape3, head_dim: int, theta: float = 10000.0,
                 dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    angles = video_rope_angles(latent_shape, head_dim, theta)
    return np.cos(angles).astype(dtype), np.sin(angles).astype(dtype)


def half_perm(head_dim: int) -> np.ndarray:
    """Interleaved-pair -> contiguous-half permutation: pair (2k, 2k+1)
    moves to (k, k + d//2)."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def permute_qk_to_half(arr: np.ndarray, head_dim: int, axis: int = -1) -> np.ndarray:
    """Permute per-head blocks of ``head_dim`` along ``axis`` from the
    interleaved-pair to the contiguous-half RoPE layout (weight import)."""
    n = arr.shape[axis]
    if n % head_dim:
        raise ValueError(f"axis length {n} is not a multiple of head_dim {head_dim}")
    p = half_perm(head_dim)
    idx = (np.arange(n // head_dim)[:, None] * head_dim + p[None, :]).reshape(-1)
    return np.take(arr, idx, axis=axis)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x[2k], x[2k+1]) of the last dim of (..., S, D)
    in f32, diffusers' layout: out[2k] = x[2k] cos_k - x[2k+1] sin_k;
    out[2k+1] = x[2k] sin_k + x[2k+1] cos_k.  cos / sin: (S, D // 2)."""
    xf = x.float()
    even, odd = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate contiguous halves of the last dim of (..., S, D) in f32:
    out[k] = x[k] cos_k - x[k+D/2] sin_k;  out[k+D/2] = x[k] sin_k + x[k+D/2] cos_k."""
    d = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
