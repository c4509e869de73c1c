"""The three attention experts and the routing combine (counterpart of
vorta_tpu/ops/experts.py).

  0. FULL: dense attention over the raster sequence
  1. LOWRES: attention over the similarity-pooled sequence (ops/coreset.py)
  2. STA: sliding-tile attention over the tile-contiguous sequence

Here each expert runs through the block-sparse flash kernel (ops/flash.py,
stable softmax) with its own static tables, through
``make_sparse_attention``, so gradients flow through the flash backward
kernels (ops/flash_bwd.py); cross-attention to the text is
``padded_dense_attention`` on the same kernel.  ``routed_attention`` combines
them: "soft" weights all three outputs by the router scores (the training
formulation, differentiable in q, k, v and the scores), "hard_ref" one-hots
the scores with the ``tau_sparse`` fallback to FULL and evaluates every
expert (the oracle), and "hard" dispatches each expert once over the heads
routed to it through ops/routed_fused.py, the serving path (forward only).
On the card "soft" and "hard_ref" raise where the flash kernel's block
limits refuse the STA tables (blocks not a multiple of 8 tokens, which the
TPU refuses too).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..config import AttentionConfig
from ..geometry import LowresGroups, build_lowres_groups, cdiv, expand_tile_mask, sta_tile_mask
from .coreset import pool_by_similarity, unpool_by_similarity
from .flash import BlockTables, dense_tables, make_sparse_attention, tables_from_block_mask
from .layout import tile_sequence, untile_sequence

FULL, LOWRES, STA = 0, 1, 2


@functools.lru_cache(maxsize=32)
def lowres_groups_for(cfg: AttentionConfig) -> LowresGroups:
    return build_lowres_groups(cfg.latent_shape, cfg.lowres_window, cfg.lowres_reduction)


@functools.lru_cache(maxsize=32)
def _full_tables(cfg: AttentionConfig):
    s = cfg.seq_len
    nq = cdiv(s, cfg.block_q)
    nkv = cdiv(s, cfg.block_kv)
    return dense_tables(nq, nkv), nq * cfg.block_q, nkv * cfg.block_kv


@functools.lru_cache(maxsize=32)
def _lowres_tables(cfg: AttentionConfig):
    """Dense tables over the pooled sequence (q blocks wholly past it idle),
    the routed LOWRES expert's own."""
    from .routed_fused import _dense_call

    pooled = lowres_groups_for(cfg).pooled_length
    call = _dense_call(pooled, cfg.block_q, cfg.block_kv, pooled)
    return call.tables, call.q_pad, call.kv_pad


@functools.lru_cache(maxsize=32)
def _sta_tables(cfg: AttentionConfig) -> BlockTables:
    bq, bkv = cfg.sta_blocks
    tpt = cfg.tokens_per_tile
    if tpt % bq or tpt % bkv:
        raise ValueError(f"sta blocks ({bq},{bkv}) must divide tokens_per_tile {tpt}")
    tile_mask = sta_tile_mask(cfg.latent_shape, cfg.sta_window, cfg.sta_tile)
    return tables_from_block_mask(expand_tile_mask(tile_mask, tpt, bq, bkv))


@functools.lru_cache(maxsize=64)
def _dense_tables_cached(nq: int, nkv: int):
    return dense_tables(nq, nkv)


def _pad_seq(x: torch.Tensor, target: int) -> torch.Tensor:
    s = x.shape[2]
    if s == target:
        return x
    return F.pad(x, (0, 0, 0, target - s))


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: AttentionConfig,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Expert 0: dense attention over the raster sequence, (B, H, S, d)."""
    tab, sq_pad, skv_pad = _full_tables(cfg)
    s = q.shape[2]
    attn = make_sparse_attention(
        tab, n_kv_blocks=skv_pad // cfg.block_kv, scale=scale, block_q=cfg.block_q,
        block_kv=cfg.block_kv, kv_valid_len=s if s != skv_pad else None)
    out = attn(_pad_seq(q, sq_pad), _pad_seq(k, skv_pad), _pad_seq(v, skv_pad))
    return out[:, :, :s]


def lowres_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: AttentionConfig,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Expert 1: pool by Q's matching, attend over the pooled sequence,
    unpool (dropped positions take their group center's output)."""
    groups = lowres_groups_for(cfg)
    pq, matching = pool_by_similarity(q, groups)
    pk, _ = pool_by_similarity(k, groups, matching)
    pv, _ = pool_by_similarity(v, groups, matching)
    tab, sq_pad, skv_pad = _lowres_tables(cfg)
    p = groups.pooled_length
    attn = make_sparse_attention(
        tab, n_kv_blocks=skv_pad // cfg.block_kv, scale=scale, block_q=cfg.block_q,
        block_kv=cfg.block_kv, kv_valid_len=p if p != skv_pad else None)
    out = attn(_pad_seq(pq, sq_pad), _pad_seq(pk, skv_pad), _pad_seq(pv, skv_pad))
    return unpool_by_similarity(out[:, :, :p], groups, matching).to(q.dtype)


def sta_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: AttentionConfig,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Expert 2: sliding-tile attention over the tile-contiguous layout with
    tile-granular block tables (the oracle of ops/sta_pipe.py)."""
    bq, bkv = cfg.sta_blocks
    shape, tile = cfg.latent_shape, cfg.sta_tile
    attn = make_sparse_attention(_sta_tables(cfg), n_kv_blocks=cfg.seq_len // bkv, scale=scale,
                                 block_q=bq, block_kv=bkv)
    out = attn(tile_sequence(q, shape, tile), tile_sequence(k, shape, tile),
               tile_sequence(v, shape, tile))
    return untile_sequence(out, shape, tile)


def padded_dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_q: Optional[int] = None, block_kv: int = 512,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention for any (Sq, Skv), e.g. cross-attention to text.

    Pads both sides to kernel blocks and masks the padded kv tail.  With
    ``block_q=None``: 2048-row q blocks for short kv (text) and long q,
    else 512, as in the JAX package, so both hold the same tables.
    """
    sq, skv = q.shape[2], k.shape[2]
    if block_q is None:
        block_q = 2048 if (skv <= 512 and sq >= 8192) else 512
    block_q = min(block_q, max(8, 1 << (sq - 1).bit_length()))
    block_kv = min(block_kv, max(8, 1 << (skv - 1).bit_length()))
    nq, nkv = cdiv(sq, block_q), cdiv(skv, block_kv)
    attn = make_sparse_attention(
        _dense_tables_cached(nq, nkv), n_kv_blocks=nkv, scale=scale, block_q=block_q,
        block_kv=block_kv, kv_valid_len=skv if skv != nkv * block_kv else None)
    out = attn(_pad_seq(q, nq * block_q), _pad_seq(k, nkv * block_kv),
               _pad_seq(v, nkv * block_kv))
    return out[:, :, :sq]


def harden_scores(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """(B, H, E) soft scores -> one-hot of the first batch row's top expert,
    FULL where its score is below ``tau``, broadcast over the batch (CFG
    pairs route alike)."""
    s0 = scores[0]
    idx = torch.where(s0.amax(dim=-1) < tau, FULL, s0.argmax(dim=-1))
    onehot = F.one_hot(idx, scores.shape[-1]).to(scores.dtype)
    return onehot[None].expand(scores.shape)


def routed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scores: Optional[torch.Tensor], cfg: AttentionConfig, mode: str = "soft",
                     scale: Optional[float] = None, expert_ids=None) -> torch.Tensor:
    """Run the experts and combine by routing scores (B, H, E).

    mode="hard" dispatches through ops/routed_fused.py; ``expert_ids`` then
    may carry the routing already made, as ``(ids on q's device, the same
    ids on the host)``, else it is made here from ``scores``.
    """
    if mode == "hard":
        from .routed_fused import fused_routed_attention, route_expert_ids

        if expert_ids is None:
            ids = route_expert_ids(scores, cfg.tau_sparse)
            expert_ids = (ids, ids.cpu().numpy())
        return fused_routed_attention(q, k, v, expert_ids[0], cfg, scale=scale,
                                      expert_ids_host=expert_ids[1])
    if mode == "hard_ref":
        scores = harden_scores(scores, cfg.tau_sparse)
    elif mode != "soft":
        raise ValueError(f"unknown routing mode {mode!r}")
    outs = torch.stack([
        full_attention(q, k, v, cfg, scale=scale),
        lowres_attention(q, k, v, cfg, scale=scale),
        sta_attention(q, k, v, cfg, scale=scale),
    ], dim=2)  # (B, H, E, S, D)
    w = scores.float()[:, :, :, None, None]
    return (w * outs.float()).sum(dim=2).to(q.dtype)
