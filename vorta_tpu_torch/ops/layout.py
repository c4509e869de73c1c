"""Raster <-> tile-contiguous sequence layout (counterpart of
vorta_tpu/ops/layout.py).

Reshape + permute: each (tile_t, tile_h, tile_w) tile's tokens become
contiguous, tokens inside a tile raster-ordered, tiles raster-ordered over
tile indices.  The coreset groups of the lowres expert use the same
relayout with the lowres window as the tile.
"""

from __future__ import annotations

from typing import Tuple

import torch

Shape3 = Tuple[int, int, int]


def tile_sequence(x: torch.Tensor, latent_shape: Shape3, tile: Shape3) -> torch.Tensor:
    """(..., S, D) raster order -> tile-contiguous order, S = prod(latent_shape)."""
    t, h, w = latent_shape
    tt, th, tw = tile
    lead, d = x.shape[:-2], x.shape[-1]
    n = len(lead)
    x = x.reshape(*lead, t // tt, tt, h // th, th, w // tw, tw, d)
    perm = tuple(range(n)) + tuple(i + n for i in (0, 2, 4, 1, 3, 5, 6))
    return x.permute(perm).reshape(*lead, t * h * w, d)


def untile_sequence(x: torch.Tensor, latent_shape: Shape3, tile: Shape3) -> torch.Tensor:
    """Inverse of :func:`tile_sequence`."""
    t, h, w = latent_shape
    tt, th, tw = tile
    lead, d = x.shape[:-2], x.shape[-1]
    n = len(lead)
    x = x.reshape(*lead, t // tt, h // th, w // tw, tt, th, tw, d)
    perm = tuple(range(n)) + tuple(i + n for i in (0, 3, 1, 4, 2, 5, 6))
    return x.permute(perm).reshape(*lead, t * h * w, d)
