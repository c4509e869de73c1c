"""Per-head routed sparse attention, the serving path (counterpart of
vorta_tpu/ops/routed_fused.py).

Routing is a participation mask: each expert runs as ONE kernel launch over
all heads in its natural layout, and only the heads routed to it do work.
FULL and LOWRES go through the flash_manual kernel with head-shared index
tables and per-head counts, zero for unrouted heads (such rows cost
nothing and write zeros); STA and the lowres pool/unpool take an (H,)
active mask, inactive heads writing zeros.  The outputs add up as in the
JAX package (every head gets exactly its expert's output, the others add
zeros).  An expert no head is routed to is not launched: the caller hands
the routing over on the host as well (``expert_ids_host``), so deciding
which experts run costs no device sync.

The STA heads run the kernel the JAX package runs for the geometry, by
its own gates (``routed_sta_kernel``): one of its window-dense kernels,
sta_pipe, sta_row or sta_window (``sta_dispatch``), or, for tiles it
gives none of them, the tiled pair-bits kernel sta_batched over
``RoutedGeometry.sta``'s tables.

The JAX package's alternative dispatches, selected by the same environment
variables, read at each call as it reads them (outputs equal to the masked
dispatch's, launches differ):

  * ``VORTA_LOWRES_DISPATCH=batched`` (``lowres_all_batched``, both
    branches): one pool in head-map mode over the LOWRES heads (``head_map``
    the routed heads first, the last repeated; ``num_active`` their count),
    one flash_manual over all heads, one head-map unpool, the other heads'
    uninitialized rows masked at the end;
  * ``VORTA_LOWRES_DISPATCH=hybrid`` (``lowres_all_hybrid``, where a
    window-dense STA kernel serves the STA heads, JAX's "fused" branch): a
    pool of each LOWRES head alone into a zero pooled buffer, one
    flash_manual over all heads, an unpool of each LOWRES head alone;
  * ``VORTA_ROUTED_DISPATCH`` other than ``masked`` (the fused branch only,
    as in JAX): the per-head switch, each head running its own expert on a
    one-head slice.  The routing is on the host, so the port loops over
    the heads with no device ``cond``.

Neither variable set: the masked dispatch above, the LOWRES pool in
``active`` mode (JAX runs its per-head pool there; the outputs agree).

``cfg.qk_int8`` (quantized serving): FULL and LOWRES quantize q and k per
head (``quantize_per_head``, dynamic symmetric int8) before padding, LOWRES
after the pool, and run flash_manual's int8 QK mode; STA stays bf16.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import AttentionConfig
from ..geometry import cdiv, sta_tile_mask
from .coreset_pallas import head_map_for, pool_qkv, unpool
from .experts import FULL, LOWRES, STA, _pad_seq, lowres_groups_for
from .flash import BlockTables
from .flash_manual import sparse_flash_attention_manual
from .layout import tile_sequence, untile_sequence
from .qmm import divide
from .sta_batched import pair_bit_tables, sta_flash_headbatched
from .sta_pipe import sta_pipe_attention, supports_pipe
from .sta_row import sta_row_attention, supports_row_dense
from .sta_window import prefer_window_dense, sta_window_attention


class ExpertCall(NamedTuple):
    tables: BlockTables  # (1, nq, W) index table, (1, nq) counts (+ pair bits for STA)
    block_q: int
    block_kv: int
    q_pad: int  # padded q length
    kv_pad: int  # padded kv length
    valid_len: int  # logical kv length


class RoutedGeometry(NamedTuple):
    full: ExpertCall
    lowres: ExpertCall
    sta: ExpertCall  # sta_batched's tables over the tiled sequence
    tokens_per_tile: int


def _dense_call(valid_len: int, block_q: int, block_kv: int, q_len: int) -> ExpertCall:
    """Dense visitation over the first ``valid_len`` kv tokens; q rows wholly
    past ``valid_len`` idle (pooled-padding rows)."""
    q_pad = block_q * cdiv(q_len, block_q)
    kv_pad = block_kv * cdiv(valid_len, block_kv)
    nq, nkv = q_pad // block_q, kv_pad // block_kv
    idx = np.broadcast_to(np.arange(nkv, dtype=np.int32), (1, nq, nkv)).copy()
    cnt = np.full((1, nq), nkv, np.int32)
    cnt[0, np.arange(nq) * block_q >= valid_len] = 0
    return ExpertCall(BlockTables(idx, cnt), block_q, block_kv, q_pad, kv_pad, valid_len)


def _sta_blocks(cfg: AttentionConfig) -> Tuple[int, int]:
    """sta_batched's blocks (the JAX package's): a few tiles each, roughly
    square, their sub-tile pairs within the 32 bits of a pair-bit word."""
    tpt = cfg.tokens_per_tile
    if tpt % 8:
        raise ValueError(f"tokens_per_tile {tpt} must be a multiple of 8")
    m = max(1, min(5, 512 // tpt))
    k = max(1, min(32 // m, 1024 // tpt))
    return m * tpt, k * tpt


def _sta_call(cfg: AttentionConfig) -> ExpertCall:
    """sta_batched's tables over the tiled sequence, padded to its blocks:
    q sub-tile (one tile) m sees kv sub-tile k where the STA tile mask says
    so; the padding sees nothing."""
    s, tpt = cfg.seq_len, cfg.tokens_per_tile
    bq, bkv = _sta_blocks(cfg)
    q_pad, kv_pad = bq * cdiv(s, bq), bkv * cdiv(s, bkv)
    tile_mask = sta_tile_mask(cfg.latent_shape, cfg.sta_window, cfg.sta_tile)
    n_tiles = tile_mask.shape[0]
    vis = np.zeros((q_pad // tpt, kv_pad // tpt), bool)
    vis[:n_tiles, :n_tiles] = tile_mask
    return ExpertCall(pair_bit_tables(vis, bq // tpt, bkv // tpt), bq, bkv, q_pad, kv_pad, s)


@functools.lru_cache(maxsize=16)
def routed_geometry(cfg: AttentionConfig) -> RoutedGeometry:
    """Every expert's tables; raises ValueError where the JAX package's
    does (sta_batched's tables need tiles that divide the grid and hold a
    multiple of 8 tokens)."""
    s = cfg.seq_len
    pooled = lowres_groups_for(cfg).pooled_length
    bq, bkv = cfg.block_q, cfg.block_kv
    return RoutedGeometry(full=_dense_call(s, bq, bkv, s),
                          lowres=_dense_call(pooled, bq, bkv, pooled),
                          sta=_sta_call(cfg), tokens_per_tile=cfg.tokens_per_tile)


def route_expert_ids(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """(B, H, E) soft scores -> (H,) int64 expert ids: top-1 of the first
    batch row (so CFG pairs route alike), FULL where its score is below tau."""
    s0 = scores[0]
    return torch.where(s0.amax(dim=-1) < tau, FULL, s0.argmax(dim=-1))


def routed_sta_kernel(cfg: AttentionConfig, d: int, itemsize: int, text_len: int = 0) -> str:
    """The STA kernel the JAX package's masked dispatch runs for this
    geometry, by its own gates: "sta_pipe", "sta_row" or "sta_window" (its
    window-dense kernels, in that order of preference), else
    "sta_batched".  ``text_len``: the joint text tail's keys, which the
    VMEM budgets count."""
    shape, tile, window = cfg.latent_shape, cfg.sta_tile, cfg.sta_window
    if supports_pipe(shape, tile, d, itemsize, text_len=text_len, window=window):
        return "sta_pipe"
    if not prefer_window_dense(shape, tile):
        return "sta_batched"
    if supports_row_dense(shape, tile, d, itemsize, text_len=text_len, window=window):
        return "sta_row"
    return "sta_window"


WINDOW_DENSE = {"sta_pipe": sta_pipe_attention, "sta_row": sta_row_attention,
                "sta_window": sta_window_attention}


def sta_dispatch(kernel: str, q, k, v, active, cfg: AttentionConfig, scale, **text):
    """One launch of the window-dense STA kernel ``kernel`` over all heads
    (raster layout), with the joint text tail in ``text``."""
    return WINDOW_DENSE[kernel](q, k, v, active, latent_shape=cfg.latent_shape,
                                tile=cfg.sta_tile, window=cfg.sta_window, scale=scale, **text)


def _sta_batched(call: ExpertCall, q, k, v, active, cfg: AttentionConfig, scale):
    """The STA heads through sta_batched: tiled layout, padded to its
    blocks, over ``RoutedGeometry.sta``'s tables."""
    shape, tile = cfg.latent_shape, cfg.sta_tile
    kv_index, kv_count, pair_bits = call.tables.on(q.device)
    out = sta_flash_headbatched(
        *(_pad_seq(tile_sequence(x, shape, tile), pad)
          for x, pad in ((q, call.q_pad), (k, call.kv_pad), (v, call.kv_pad))),
        kv_index, kv_count, active, pair_bits=pair_bits,
        tokens_per_tile=cfg.tokens_per_tile, scale=scale, block_q=call.block_q,
        block_kv=call.block_kv, softmax="fast")
    return untile_sequence(out[:, :, :cfg.seq_len], shape, tile)


def quantize_per_head(x: torch.Tensor):
    """Symmetric per-head int8 quantization with a dynamic amax over batch,
    sequence and dim: (int8 x, (H,) f32 scales), the JAX package's
    ``_quantize_per_head`` (divide, round half to even, clip to +-127)."""
    xf = x.float()
    s = divide(xf.abs().amax(dim=(0, 2, 3)).clamp(min=1e-12), 127.0)
    return torch.round(xf / s[None, :, None, None]).clamp(-127, 127).to(torch.int8), s


def quantize_qk(q: torch.Tensor, k: torch.Tensor):
    """(int8 q, int8 k, (H,) qk_scale = q_scale * k_scale)."""
    q8, sq = quantize_per_head(q)
    k8, sk = quantize_per_head(k)
    return q8, k8, sq * sk


def _masked_call(call: ExpertCall, q, k, v, active: torch.Tensor, scale,
                 qk_int8: bool = False) -> torch.Tensor:
    """One flash_manual launch over all heads; rows of inactive heads get
    count 0.  ``active``: (H,) bool on q's device.  ``qk_int8``: q and k
    quantized per head first (before the padding)."""
    kv_index, kv_count = call.tables.on(q.device)
    cnt = torch.where(active[:, None], kv_count, 0).to(torch.int32)  # (H, nq)
    qk_scale = None
    if qk_int8:
        q, k, qk_scale = quantize_qk(q, k)
    return sparse_flash_attention_manual(
        _pad_seq(q, call.q_pad), _pad_seq(k, call.kv_pad), _pad_seq(v, call.kv_pad),
        kv_index, cnt, scale=scale, block_q=call.block_q, block_kv=call.block_kv,
        kv_valid_len=call.valid_len, softmax="fast", qk_scale=qk_scale)


def _lowres_head(geo: RoutedGeometry, q, k, v, cfg: AttentionConfig, scale) -> torch.Tensor:
    """The LOWRES expert on a one-head slice (the JAX package's
    ``lowres_head``): pool, one flash_manual, unpool through the picks."""
    groups = lowres_groups_for(cfg)
    pq, pk, pv, picks = pool_qkv(q, k, v, groups, return_picks=True)
    one = torch.ones(1, dtype=torch.bool, device=q.device)
    out_p = _masked_call(geo.lowres, pq, pk, pv, one, scale,
                         cfg.qk_int8)[:, :, :groups.pooled_length]
    return unpool(out_p, q, groups, picks=picks)


def lowres_all_batched(geo: RoutedGeometry, q, k, v, expert_id, ids_host,
                       cfg: AttentionConfig, scale) -> torch.Tensor:
    """VORTA_LOWRES_DISPATCH=batched: one head-map pool over the LOWRES
    heads, one masked flash_manual over all heads, one head-map unpool; the
    other heads' uninitialized rows masked at the end."""
    groups = lowres_groups_for(cfg)
    lh = expert_id == LOWRES
    head_map, n = head_map_for(lh, int((ids_host == LOWRES).sum()))
    pq, pk, pv, picks = pool_qkv(q, k, v, groups, head_map=head_map, num_active=n,
                                 return_picks=True)
    out_p = _masked_call(geo.lowres, pq, pk, pv, lh, scale,
                         cfg.qk_int8)[:, :, :groups.pooled_length]
    up = unpool(out_p, q, groups, head_map=head_map, num_active=n, picks=picks)
    return torch.where(lh[None, :, None, None], up, torch.zeros((), dtype=up.dtype,
                                                                 device=up.device))


def lowres_all_hybrid(geo: RoutedGeometry, q, k, v, expert_id, ids_host,
                      cfg: AttentionConfig, scale) -> torch.Tensor:
    """VORTA_LOWRES_DISPATCH=hybrid: each LOWRES head pooled alone into a
    zero pooled buffer, one masked flash_manual over all heads, each LOWRES
    head unpooled alone; the other heads' outputs zero."""
    groups = lowres_groups_for(cfg)
    b, h, _, d = q.shape
    p = groups.pooled_length
    pooled = [torch.zeros((b, h, p, d), dtype=q.dtype, device=q.device) for _ in range(3)]
    picks = {}
    for i in np.flatnonzero(ids_host == LOWRES):
        sl = slice(int(i), int(i) + 1)
        *xs, picks[int(i)] = pool_qkv(q[:, sl], k[:, sl], v[:, sl], groups, return_picks=True)
        for buf, x in zip(pooled, xs):
            buf[:, sl] = x
    out_p = _masked_call(geo.lowres, *pooled, expert_id == LOWRES, scale, cfg.qk_int8)[:, :, :p]
    out = torch.zeros_like(q)
    for i, head_picks in picks.items():
        out[:, i:i + 1] = unpool(out_p[:, i:i + 1], q[:, i:i + 1], groups, picks=head_picks)
    return out


def _switch_dispatch(geo: RoutedGeometry, q, k, v, ids_host, sta_kernel: str,
                     cfg: AttentionConfig, scale) -> torch.Tensor:
    """VORTA_ROUTED_DISPATCH != masked: each head through its own expert on
    a one-head slice, the outputs concatenated (the JAX package's per-head
    ``lax.switch``, a host loop here)."""
    one = torch.ones(1, dtype=torch.bool, device=q.device)
    outs = []
    for i, e in enumerate(ids_host):
        qh, kh, vh = (x[:, i:i + 1] for x in (q, k, v))
        if e == FULL:
            outs.append(_masked_call(geo.full, qh, kh, vh, one, scale,
                                     cfg.qk_int8)[:, :, :cfg.seq_len])
        elif e == LOWRES:
            outs.append(_lowres_head(geo, qh, kh, vh, cfg, scale))
        else:
            outs.append(sta_dispatch(sta_kernel, qh, kh, vh, one.to(torch.int32), cfg, scale))
    return torch.cat(outs, dim=1)


def fused_routed_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    expert_id: torch.Tensor,  # (H,) int on q's device
    cfg: AttentionConfig,
    scale: Optional[float] = None,
    expert_ids_host: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Hard-routed attention (B, H, S, D), each expert launched once over
    the heads routed to it (or as the dispatch variables say, see the module
    doc).  ``expert_ids_host``: the same ids on the host, else read back
    from ``expert_id`` (a device sync)."""
    geo = routed_geometry(cfg)
    if expert_ids_host is None:
        expert_ids_host = expert_id.cpu().numpy()
    ids_host = np.asarray(expert_ids_host).reshape(-1)
    routed = set(int(e) for e in ids_host)
    expert_id = expert_id.to(q.device)
    s = cfg.seq_len
    kernel = routed_sta_kernel(cfg, q.shape[-1], q.element_size())
    fused = kernel != "sta_batched"  # the JAX package's fused branch
    if fused and os.environ.get("VORTA_ROUTED_DISPATCH", "masked") != "masked":
        return _switch_dispatch(geo, q, k, v, ids_host, kernel, cfg, scale)
    lowres_mode = os.environ.get("VORTA_LOWRES_DISPATCH", "")
    out = None

    def add(x):
        nonlocal out
        out = x if out is None else out.add_(x)

    if STA in routed:
        active = (expert_id == STA).to(torch.int32)
        add(_sta_batched(geo.sta, q, k, v, active, cfg, scale) if kernel == "sta_batched"
            else sta_dispatch(kernel, q, k, v, active, cfg, scale))
    if FULL in routed:
        add(_masked_call(geo.full, q, k, v, expert_id == FULL, scale, cfg.qk_int8)[:, :, :s])
    if LOWRES in routed:
        if lowres_mode == "batched":
            add(lowres_all_batched(geo, q, k, v, expert_id, ids_host, cfg, scale))
        elif lowres_mode == "hybrid" and fused:
            add(lowres_all_hybrid(geo, q, k, v, expert_id, ids_host, cfg, scale))
        else:
            groups = lowres_groups_for(cfg)
            active = expert_id == LOWRES
            pq, pk, pv, picks = pool_qkv(q, k, v, groups, active=active.to(torch.int32),
                                         return_picks=True)
            out_p = _masked_call(geo.lowres, pq, pk, pv, active, scale,
                                 cfg.qk_int8)[:, :, :groups.pooled_length]
            add(unpool(out_p, q, groups, active=active.to(torch.int32), picks=picks))
    return torch.zeros_like(q) if out is None else out
