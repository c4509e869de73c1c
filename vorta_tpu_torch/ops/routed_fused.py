"""Per-head routed sparse attention, the serving path (counterpart of
vorta_tpu/ops/routed_fused.py, its masked dispatch).

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

Only the geometries where the JAX package takes this masked dispatch with
its sta_pipe kernel are served; the others name the TPU kernel the JAX
package would run instead (sta_row, sta_window or sta_batched) and raise
NotImplementedError, as does its per-head switch dispatch
(VORTA_ROUTED_DISPATCH).  The JAX package's sta_batched pair-bit tables
(``RoutedGeometry.sta``) belong to that fallback and are not carried.

``cfg.qk_int8`` (quantized serving): FULL and LOWRES quantize q and k per
head (``quantize_per_head``, dynamic symmetric int8) before padding, LOWRES
after the pool, and run flash_manual's int8 QK mode; STA stays bf16.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import AttentionConfig
from ..geometry import cdiv
from .coreset_pallas import pool_qkv, unpool
from .experts import FULL, LOWRES, STA, _pad_seq, lowres_groups_for
from .flash import BlockTables
from .flash_manual import sparse_flash_attention_manual
from .qmm import divide
from .sta_pipe import sta_pipe_attention, supports_pipe


class ExpertCall(NamedTuple):
    tables: BlockTables  # (1, nq, W) index table, (1, nq) counts
    block_q: int
    block_kv: int
    q_pad: int  # padded q length
    kv_pad: int  # padded kv length
    valid_len: int  # logical kv length


class RoutedGeometry(NamedTuple):
    full: ExpertCall
    lowres: ExpertCall
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


@functools.lru_cache(maxsize=16)
def routed_geometry(cfg: AttentionConfig) -> RoutedGeometry:
    s = cfg.seq_len
    pooled = lowres_groups_for(cfg).pooled_length
    bq, bkv = cfg.block_q, cfg.block_kv
    return RoutedGeometry(full=_dense_call(s, bq, bkv, s),
                          lowres=_dense_call(pooled, bq, bkv, pooled),
                          tokens_per_tile=cfg.tokens_per_tile)


def route_expert_ids(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """(B, H, E) soft scores -> (H,) int64 expert ids: top-1 of the first
    batch row (so CFG pairs route alike), FULL where its score is below tau."""
    s0 = scores[0]
    return torch.where(s0.amax(dim=-1) < tau, FULL, s0.argmax(dim=-1))


def prefer_window_dense(latent_shape, tile) -> bool:
    """The JAX package's choice of its window-dense STA kernels
    (sta_window.py:prefer_window_dense): tiles divide the grid, are 8-aligned
    in w or in size, and hold at least 192 tokens."""
    tt, th, tw = tile
    tpt = tt * th * tw
    if any(latent_shape[a] % tile[a] for a in range(3)):
        return False
    return (tw % 8 == 0 or tpt % 8 == 0) and tpt >= 192


def _unserved_sta_kernel(cfg: AttentionConfig, d: int, itemsize: int,
                         text_len: int = 0) -> Optional[str]:
    """None where the JAX package's masked dispatch runs sta_pipe, else the
    name of the TPU kernel it would run instead (its own gates, copied;
    ``text_len``: the joint text tail's keys, which the VMEM budgets count)."""
    shape, tile, window = cfg.latent_shape, cfg.sta_tile, cfg.sta_window
    if supports_pipe(shape, tile, d, itemsize, text_len=text_len, window=window):
        return None
    if not prefer_window_dense(shape, tile):
        return "sta_batched"
    w = shape[2]
    tt, th, tw = tile
    tpt = tt * th * tw
    nw = w // tw
    slab = tt * th * w * d * itemsize
    row_est = (4 * slab + 4 * slab + nw * tpt * (d + 2) * 4
               + 3 * tpt * tt * th * min(window[2], nw) * tw * 4 + 2 * text_len * d * itemsize)
    if tw % 8 == 0 and row_est < 40 * 2**20:  # supports_row_dense
        return "sta_row"
    return "sta_window"


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
    the heads routed to it.  ``expert_ids_host``: the same ids on the host,
    else read back from ``expert_id`` (a device sync)."""
    if os.environ.get("VORTA_ROUTED_DISPATCH", "masked") != "masked":
        raise NotImplementedError("only the masked dispatch is ported; the per-head switch "
                                  "dispatch (VORTA_ROUTED_DISPATCH) is not")
    fallback = _unserved_sta_kernel(cfg, q.shape[-1], q.element_size())
    if fallback is not None:
        raise NotImplementedError(
            f"latent {cfg.latent_shape}, tile {cfg.sta_tile}: the JAX package runs its "
            f"{fallback} kernel here, which is not ported yet")
    if expert_ids_host is None:
        expert_ids_host = expert_id.cpu().numpy()
    routed = set(int(e) for e in np.asarray(expert_ids_host).reshape(-1))
    expert_id = expert_id.to(q.device)
    s = cfg.seq_len
    geo = routed_geometry(cfg)
    out = None

    def add(x):
        nonlocal out
        out = x if out is None else out.add_(x)

    if STA in routed:
        add(sta_pipe_attention(q, k, v, (expert_id == STA).to(torch.int32),
                               latent_shape=cfg.latent_shape, tile=cfg.sta_tile,
                               window=cfg.sta_window, scale=scale))
    if FULL in routed:
        add(_masked_call(geo.full, q, k, v, expert_id == FULL, scale, cfg.qk_int8)[:, :, :s])
    if LOWRES in routed:
        groups = lowres_groups_for(cfg)
        active = expert_id == LOWRES
        pq, pk, pv, picks = pool_qkv(q, k, v, groups, active=active.to(torch.int32),
                                     return_picks=True)
        out_p = _masked_call(geo.lowres, pq, pk, pv, active, scale,
                             cfg.qk_int8)[:, :, :groups.pooled_length]
        add(unpool(out_p, q, groups, active=active.to(torch.int32), picks=picks))
    return torch.zeros_like(q) if out is None else out
