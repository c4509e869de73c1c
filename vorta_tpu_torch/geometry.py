"""Static attention geometry, host-side numpy (the port's own copy of the
parts of vorta_tpu/geometry.py that the serving path needs, plus the
sliding-tile window starts of vorta_tpu/ops/sta_window.py and sta_row.py)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Shape3 = Tuple[int, int, int]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TokenGeometry:
    """Maps pixel-space video shapes to DiT token-grid shapes.

    A video of ``(frames, height, width)`` pixels passes through a causal 3D
    VAE (temporal x4, spatial x8) and then the DiT patchifier (temporal x1,
    spatial x2), so one token covers ``temporal_vae*temporal_patch`` frames
    and ``spatial_vae*spatial_patch`` pixels per side.  Causal VAEs emit one
    extra leading latent frame, hence the ``mod == 1`` rule (e.g. 77 frames
    -> 20 latent frames).
    """

    temporal_vae: int = 4
    spatial_vae: int = 8
    temporal_patch: int = 1
    spatial_patch: int = 2

    @property
    def temporal_total(self) -> int:
        return self.temporal_vae * self.temporal_patch

    @property
    def spatial_total(self) -> int:
        return self.spatial_vae * self.spatial_patch

    @staticmethod
    def _to_tokens(num_pixels: int, stride: int) -> int:
        n, mod = divmod(num_pixels, stride)
        if mod == 0:
            return n
        if mod == 1:  # causal VAE: first frame stands alone
            return n + 1
        raise ValueError(
            f"pixel extent {num_pixels} is not a multiple (or multiple+1) of stride {stride}"
        )

    def tokens(self, video_shape: Shape3) -> Shape3:
        f, h, w = video_shape
        return (
            self._to_tokens(f, self.temporal_total),
            self._to_tokens(h, self.spatial_total),
            self._to_tokens(w, self.spatial_total),
        )


WAN_GEOMETRY = TokenGeometry(temporal_vae=4, spatial_vae=8)
HUNYUAN_GEOMETRY = TokenGeometry(temporal_vae=4, spatial_vae=8)


# ---------------------------------------------------------------------------
# Coreset (low-res expert) group structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _LowresGeometry:
    latent_shape: Shape3
    window: Shape3
    center_slot: int


@dataclasses.dataclass(frozen=True)
class LowresGroups:
    """Partition of the 3D token grid into non-overlapping windows.

    ``center`` is the raster index of each window's center token; ``margins``
    are the remaining window tokens in raster order.  The low-res expert keeps
    every center plus the ``num_kept_margins`` margin tokens *least similar*
    to their center, and drops the rest (their output is filled with the
    center's output at unpool time).
    """

    center: np.ndarray  # (G,) int32 raster indices
    margins: np.ndarray  # (G, M) int32 raster indices
    num_kept_margins: int  # tokens kept per group besides the center

    @property
    def num_groups(self) -> int:
        return int(self.center.shape[0])

    @property
    def group_size(self) -> int:
        return int(self.margins.shape[1]) + 1

    @property
    def num_dropped(self) -> int:
        return int(self.margins.shape[1]) - self.num_kept_margins

    @property
    def pooled_length(self) -> int:
        return self.num_groups * (1 + self.num_kept_margins)

    @property
    def full_length(self) -> int:
        return self.num_groups * self.group_size


def build_lowres_groups(latent_shape: Shape3, window: Shape3,
                        reduction_rate: float = 0.5) -> LowresGroups:
    """Window the raster-ordered token grid and locate each window's center.

    Windows are non-overlapping, iterated in raster order over window
    indices, and tokens within a window keep their raster order.  The number
    of kept tokens per group is ``int(group_size * (1 - reduction_rate)) - 1``
    margins + 1 center.  The generating geometry is stashed as ``_geom``.
    """
    t, h, w = latent_shape
    wt, wh, ww = window
    if t % wt or h % wh or w % ww:
        raise ValueError(f"window {window} must divide latent shape {latent_shape}")
    gt, gh, gw = t // wt, h // wh, w // ww
    idx = np.arange(t * h * w, dtype=np.int32).reshape(t, h, w)
    blocks = idx.reshape(gt, wt, gh, wh, gw, ww).transpose(0, 2, 4, 1, 3, 5)
    groups = blocks.reshape(gt * gh * gw, wt * wh * ww)
    center_slot = (wt // 2) * wh * ww + (wh // 2) * ww + (ww // 2)
    center = groups[:, center_slot].copy()
    margins = np.delete(groups, center_slot, axis=1)
    num_kept = int(wt * wh * ww * (1.0 - reduction_rate)) - 1
    if not (0 <= num_kept <= margins.shape[1]):
        raise ValueError(
            f"reduction_rate {reduction_rate} with window {window} keeps {num_kept} margins")
    out = LowresGroups(center=center, margins=margins, num_kept_margins=num_kept)
    object.__setattr__(out, "_geom", _LowresGeometry(
        latent_shape=(t, h, w), window=(wt, wh, ww), center_slot=int(center_slot)))
    return out


# ---------------------------------------------------------------------------
# Tile <-> raster layout and sliding-tile (STA) visibility
# ---------------------------------------------------------------------------


def tile_permutation(latent_shape: Shape3, tile: Shape3) -> np.ndarray:
    """``out[i] = seq[perm[i]]`` puts each tile's tokens contiguously, tiles
    raster-ordered over tile indices, tokens inside a tile raster-ordered."""
    t, h, w = latent_shape
    tt, th, tw = tile
    if t % tt or h % th or w % tw:
        raise ValueError(f"tile {tile} must divide latent shape {latent_shape}")
    nt, nh, nw = t // tt, h // th, w // tw
    idx = np.arange(t * h * w, dtype=np.int32).reshape(t, h, w)
    return idx.reshape(nt, tt, nh, th, nw, tw).transpose(0, 2, 4, 1, 3, 5).reshape(-1)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def sta_tile_mask(latent_shape: Shape3, window: Shape3, tile: Shape3) -> np.ndarray:
    """(n_tiles, n_tiles) bool: ``mask[q_tile, kv_tile]`` when the kv tile lies
    inside the window (in tiles) centered on the q tile, the center clamped
    so the window never hangs off the grid: border queries see the same
    window as the nearest interior tile.  A window wider than an axis spans
    it whole."""
    t, h, w = latent_shape
    tt, th, tw = tile
    if t % tt or h % th or w % tw:
        raise ValueError(f"tile {tile} must divide latent shape {latent_shape}")
    nt, nh, nw = t // tt, h // th, w // tw

    def axis_mask(n: int, win: int) -> np.ndarray:
        q = np.arange(n)
        half = win // 2
        lo, hi = half, (n - 1) - half
        if lo > hi:  # window covers the whole axis
            center = np.full_like(q, n // 2)
            return np.abs(center[:, None] - q[None, :]) <= max(half, n)
        center = np.clip(q, lo, hi)
        return np.abs(center[:, None] - q[None, :]) <= half

    mt, mh, mw = axis_mask(nt, window[0]), axis_mask(nh, window[1]), axis_mask(nw, window[2])
    mask = (mt[:, None, None, :, None, None] & mh[None, :, None, None, :, None]
            & mw[None, None, :, None, None, :])
    return mask.reshape(nt * nh * nw, nt * nh * nw)


def expand_tile_mask(tile_mask: np.ndarray, tokens_per_tile: int, block_q: int,
                     block_kv: int) -> np.ndarray:
    """Tile-granular mask -> kernel-block granularity (blocks divide tiles)."""
    if tokens_per_tile % block_q or tokens_per_tile % block_kv:
        raise ValueError(
            f"block sizes ({block_q},{block_kv}) must divide tokens_per_tile={tokens_per_tile}")
    rq, rkv = tokens_per_tile // block_q, tokens_per_tile // block_kv
    return np.kron(tile_mask, np.ones((rq, rkv), dtype=bool))


def full_block_tables(n_q_blocks: int, n_kv_blocks: int):
    """Block tables for dense (full) attention: every kv block active.
    Returns (kv_index (nq, nkv), counts (nq,)), int32."""
    kv_index = np.broadcast_to(np.arange(n_kv_blocks, dtype=np.int32)[None, :],
                               (n_q_blocks, n_kv_blocks)).copy()
    return kv_index, np.full((n_q_blocks,), n_kv_blocks, dtype=np.int32)


def window_starts(latent_shape: Shape3, tile: Shape3, window: Shape3) -> np.ndarray:
    """(n_tiles, 3) int32 element offsets of each q tile's clamped window box.

    Per axis: start_tile = clip(q_tile - win//2, 0, n - win_eff) with
    win_eff = min(win, n), the clamping of ``sta_tile_mask``.
    """
    nt = tuple(latent_shape[i] // tile[i] for i in range(3))
    q = np.stack(np.meshgrid(*(np.arange(n) for n in nt), indexing="ij"), -1).reshape(-1, 3)
    n = np.asarray(nt)
    win_eff = np.minimum(np.asarray(window), n)
    start = np.clip(q - np.asarray(window) // 2, 0, n - win_eff)
    return (start * np.asarray(tile)).astype(np.int32)


def row_starts(latent_shape: Shape3, tile: Shape3, window: Shape3) -> np.ndarray:
    """(nt*nh, 2) int32 element offsets (t0, h0) of each (t, h) tile row's
    window box: every w tile of a row shares them."""
    t, hh, w = latent_shape
    nt, nh, nw = t // tile[0], hh // tile[1], w // tile[2]
    full = window_starts(latent_shape, tile, window).reshape(nt, nh, nw, 3)
    return np.ascontiguousarray(full[:, :, 0, :2].reshape(nt * nh, 2))


def w_window_starts(latent_shape: Shape3, tile: Shape3, window: Shape3) -> list:
    """Element start of the clamped w window of each w tile (the same for
    every (t, h) row)."""
    t, hh, w = latent_shape
    nt, nh, nw = t // tile[0], hh // tile[1], w // tile[2]
    full = window_starts(latent_shape, tile, window).reshape(nt, nh, nw, 3)
    return [int(x) for x in full[0, 0, :, 2]]


def block_mask_to_tables(block_mask: np.ndarray, pad_to: int | None = None):
    """Turn a (n_q_blocks, n_kv_blocks) boolean mask into kernel block tables.

    Returns ``(kv_index, kv_count)``: ``kv_index[q, j]`` is the j-th active kv
    block of q-block ``q`` (ascending), padded by repeating the last active
    block, and ``kv_count[q]`` the number of active blocks.  Rows with no
    active block get index 0 and count 0.
    """
    n_q, _ = block_mask.shape
    counts = block_mask.sum(axis=1).astype(np.int32)
    width = int(pad_to if pad_to is not None else max(int(counts.max(initial=0)), 1))
    kv_index = np.zeros((n_q, width), dtype=np.int32)
    for q in range(n_q):
        active = np.nonzero(block_mask[q])[0]
        if active.size == 0:
            continue
        if active.size > width:
            raise ValueError(f"row {q} has {active.size} active blocks > pad_to={width}")
        kv_index[q, : active.size] = active
        kv_index[q, active.size :] = active[-1]
    return kv_index, counts
