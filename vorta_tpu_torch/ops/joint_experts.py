"""Routed sparse attention over joint video + text sequences, HunyuanVideo's
MMDiT attention (counterpart of vorta_tpu/ops/joint_experts.py), forward.

The three experts over ``[video tokens | text tokens]``:
  * full: dense over the joint sequence;
  * low-res: video pooled by similarity (Q by Q's matching, K and V by K's
    own), text kept verbatim;
  * sliding-tile: the video queries attend to their tile window plus every
    text key; the text queries attend to everything.

The per-prompt text padding is a mask of batch row 0 carried as an additive
kv bias (-1e30 on a padded key) into the kernels; the padded text query rows
are zeroed at the end.  Each expert's layout puts the text segment on a
kernel-block boundary (``joint_layouts``); the bias also masks the
alignment padding between the segments.

Kernels: full and low-res go through ``flash_manual`` with ``kv_bias``
(per-head counts, zero for a head routed away), low-res pools with
``pool_qkv(kv_matching_from_k=True)`` and scatters back with ``unpool``;
given ``active``, as the JAX package's ``joint_lowres_attention`` does, in
head-map mode over the routed heads alone (``head_map_for``), the other
heads' uninitialized pooled rows kept out by their zero counts (their
per-head int8 scales stay their own) and their unpooled rows masked at the
end.
Sliding-tile runs the kernel the JAX package runs (``joint_sta_kernel``,
its gates): where tiles hold at least 192 tokens and the text length is a
multiple of 8, its window-dense branch, the video rows through
``sta_pipe``, ``sta_row`` or ``sta_window`` with the text tail and the text
rows through ``flash_manual`` with ``kv_bias`` and ``kv_valid_len``; else
``sta_batched`` over the tiled-video-plus-text layout, text rows included,
with the pair bits of ``_joint_sta_tables`` and the layout's ``kv_bias``.

``qk_int8`` (quantized serving, routing off included): full and low-res
quantize the assembled joint q and k per head (video, text and the
alignment zeros, which leave the amax unchanged) and run flash_manual's
int8 QK mode, ``kv_bias`` as before; sliding-tile stays bf16.

Hard routing is the masked dispatch of ops/routed_fused.py: each routed
expert runs once over all heads with an (H,) active mask, and each head's
output equals its expert's (the JAX package runs a per-head switch at these
geometries; the heads are independent, so the outputs are the same).  The
``*_ref`` functions are the plain versions (online-softmax attention with
the same masks), the soft-routing formulation; they run the chunked
attention in its recompute-backward form (``attention_chunked_recompute``).  ``"off_ref"`` is full attention through
its plain version, the frozen teacher's mode in Hunyuan router training.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import AttentionConfig
from ..geometry import cdiv, sta_tile_mask
from .attention_ref import attention_chunked_recompute
from .coreset import pool_by_similarity, unpool_by_similarity
from .coreset_pallas import head_map_for, pool_qkv, unpool
from .experts import FULL, LOWRES, STA, _dense_tables_cached, lowres_groups_for
from .flash_manual import sparse_flash_attention_manual
from .layout import tile_sequence, untile_sequence
from .routed_fused import (
    _sta_blocks,
    quantize_qk,
    route_expert_ids,
    routed_sta_kernel,
    sta_dispatch,
)
from .sta_batched import PairBitTables, pair_bit_tables, sta_flash_headbatched
from .sta_window import prefer_window_dense

NEG = -1e30
MODES = ("off", "off_ref", "hard", "soft")


@dataclasses.dataclass(frozen=True)
class JointConfig:
    video: AttentionConfig
    text_len: int  # padded (static) text length


class JointLayout(NamedTuple):
    """Segment offsets of one expert's internal layout."""

    video_len: int  # logical video tokens at offset 0
    text_off: int  # text segment start (block aligned)
    total: int  # padded total length
    block_q: int
    block_kv: int


def _aligned_layout(video_len: int, text_len: int, bq: int, bkv: int) -> JointLayout:
    align = int(np.lcm(bq, bkv))
    text_off = align * cdiv(video_len, align)
    return JointLayout(video_len, text_off, text_off + align * cdiv(text_len, align), bq, bkv)


@functools.lru_cache(maxsize=16)
def joint_layouts(jcfg: JointConfig) -> dict:
    cfg = jcfg.video
    b0 = cfg.block_q
    sq, skv = _sta_blocks(cfg)
    sv, lt = cfg.seq_len, jcfg.text_len
    rows_bq = max(8, 1 << (lt - 1).bit_length())
    return {
        "full": _aligned_layout(sv, lt, b0, b0),
        "lowres": _aligned_layout(lowres_groups_for(cfg).pooled_length, lt, b0, b0),
        "sta": _aligned_layout(sv, lt, sq, skv),
        # the STA expert's text rows: keys [raster video | text] unaligned,
        # padded to block_kv; queries the text alone, padded to rows_bq
        "sta_text_rows": JointLayout(sv, sv, cfg.block_kv * cdiv(sv + lt, cfg.block_kv),
                                     rows_bq, cfg.block_kv),
    }


def _assemble(video: torch.Tensor, text: torch.Tensor, text_off: int, total: int):
    """(B, H, Sv, D) video at 0 and (B, H, L, D) text at ``text_off`` in a
    zero (B, H, total, D) tensor."""
    b, h, sv, d = video.shape
    out = video.new_zeros((b, h, total, d))
    out[:, :, :sv] = video
    out[:, :, text_off:text_off + text.shape[2]] = text
    return out


def _split(joint: torch.Tensor, layout: JointLayout, video_len: int, text_len: int):
    return joint[:, :, :video_len], joint[:, :, layout.text_off:layout.text_off + text_len]


def _text_ok(text_mask: torch.Tensor) -> torch.Tensor:
    """Batch row 0's (L,) bool mask: the kernels share one padding mask across
    the batch (CFG pairs carry identical masks), as in the JAX package."""
    return torch.as_tensor(text_mask)[0].bool()


def _bias(text_mask: torch.Tensor, layout: JointLayout, video_valid: int) -> torch.Tensor:
    """(B, L) bool text mask -> (1, total) f32 additive bias: 0 on the valid
    video and text tokens, -1e30 on padded text and alignment padding."""
    ok = _text_ok(text_mask)
    pos = torch.arange(layout.total, device=ok.device)
    in_text = (pos >= layout.text_off) & (pos < layout.text_off + ok.shape[0])
    text_idx = (pos - layout.text_off).clamp(0, ok.shape[0] - 1)
    valid = (pos < video_valid) | (in_text & ok[text_idx])
    return torch.where(valid, 0.0, NEG).float()[None]


def _text_bias(text_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) bool text mask -> (1, L) f32 additive bias of the text keys
    alone, sta_pipe's text tail's."""
    return torch.where(_text_ok(text_mask), 0.0, NEG).float()[None]


def _active(active, h: int, device) -> torch.Tensor:
    if active is None:
        return torch.ones(h, dtype=torch.bool, device=device)
    return torch.as_tensor(active, device=device).reshape(h).bool()


def _flash(q, k, v, layout: JointLayout, active, bias, scale, kv_valid_len=None,
           qk_int8: bool = False):
    """One flash_manual launch over all heads of an aligned layout, dense
    tables, count 0 for the heads routed away; ``qk_int8``: q and k
    quantized per head first."""
    idx, cnt = _dense_tables_cached(q.shape[2] // layout.block_q,
                                    k.shape[2] // layout.block_kv).on(q.device)
    counts = torch.where(active[:, None], cnt, 0).to(torch.int32)
    qk_scale = None
    if qk_int8:
        q, k, qk_scale = quantize_qk(q, k)
    return sparse_flash_attention_manual(
        q, k, v, idx, counts, scale=scale,
        block_q=layout.block_q, block_kv=layout.block_kv, kv_valid_len=kv_valid_len,
        kv_bias=bias.to(q.device), softmax="fast", qk_scale=qk_scale)


def joint_full_attention(qv, kv_, vv, qt, kt, vt, text_mask, jcfg: JointConfig,
                         active=None, scale: Optional[float] = None):
    """Dense attention over [video | text]: (video (B,H,Sv,D), text (B,H,L,D))."""
    layout = joint_layouts(jcfg)["full"]
    q, k, v = (_assemble(a, b, layout.text_off, layout.total)
               for a, b in ((qv, qt), (kv_, kt), (vv, vt)))
    out = _flash(q, k, v, layout, _active(active, qv.shape[1], qv.device),
                 _bias(text_mask, layout, jcfg.video.seq_len), scale,
                 qk_int8=jcfg.video.qk_int8)
    return _split(out, layout, jcfg.video.seq_len, jcfg.text_len)


def joint_lowres_attention(qv, kv_, vv, qt, kt, vt, text_mask, jcfg: JointConfig,
                           active=None, scale: Optional[float] = None,
                           num_active: Optional[int] = None):
    """Pooled video (Q by Q's matching, K / V by K's own) + verbatim text;
    the video output unpooled through Q's picks.  ``active`` (H,) bool:
    head-map pooling over the routed heads; ``num_active``, their count on
    the host, spares the device read that sizes the launch."""
    groups = lowres_groups_for(jcfg.video)
    layout = joint_layouts(jcfg)["lowres"]
    act = _active(active, qv.shape[1], qv.device)
    hm_kw = {}
    if active is not None:
        head_map, n = head_map_for(act, num_active)
        hm_kw = dict(head_map=head_map, num_active=n)
    pq, pk, pv, picks = pool_qkv(qv, kv_, vv, groups, kv_matching_from_k=True,
                                 return_picks=True, **hm_kw)
    q, k, v = (_assemble(a, b, layout.text_off, layout.total)
               for a, b in ((pq, qt), (pk, kt), (pv, vt)))
    del pq, pk, pv
    out = _flash(q, k, v, layout, act, _bias(text_mask, layout, groups.pooled_length), scale,
                 qk_int8=jcfg.video.qk_int8)
    pooled_out, text_out = _split(out, layout, groups.pooled_length, jcfg.text_len)
    video_out = unpool(pooled_out, qv, groups, picks=picks, **hm_kw)
    if active is not None:  # the head-map unpool leaves the other heads' rows uninitialized
        video_out = torch.where(act[None, :, None, None], video_out,
                                torch.zeros((), dtype=video_out.dtype, device=video_out.device))
    return video_out, text_out


def joint_sta_kernel(jcfg: JointConfig, d: int, itemsize: int) -> str:
    """The STA kernel the JAX package runs for this joint geometry (its
    gates): "sta_batched" unless tiles are window-dense with at least 192
    tokens and the text length is a multiple of 8, else "sta_pipe",
    "sta_row" or "sta_window" as for the routed dispatch, the text tail's
    keys counted."""
    cfg = jcfg.video
    if not (prefer_window_dense(cfg.latent_shape, cfg.sta_tile) and jcfg.text_len % 8 == 0):
        return "sta_batched"
    return routed_sta_kernel(cfg, d, itemsize, text_len=jcfg.text_len)


def joint_sta_attention(qv, kv_, vv, qt, kt, vt, text_mask, jcfg: JointConfig,
                        active=None, scale: Optional[float] = None):
    """Sliding-tile joint attention through the kernel the JAX package runs
    here: sta_batched over the tiled layout, or its window-dense branch, the
    video rows through sta_pipe / sta_row / sta_window with the text tail
    and the text rows densely over [raster video | text] through
    flash_manual."""
    cfg = jcfg.video
    act = _active(active, qv.shape[1], qv.device)
    kernel = joint_sta_kernel(jcfg, qv.shape[-1], qv.element_size())
    if kernel == "sta_batched":
        return _joint_sta_batched(qv, kv_, vv, qt, kt, vt, text_mask, jcfg, act, scale)
    video_out = sta_dispatch(kernel, qv, kv_, vv, act.to(torch.int32), cfg, scale, text_k=kt,
                             text_v=vt, text_bias=_text_bias(text_mask).to(qv.device))
    sv, lt = cfg.seq_len, jcfg.text_len
    layout = joint_layouts(jcfg)["sta_text_rows"]
    k, v = (_assemble(a, b, sv, layout.total) for a, b in ((kv_, kt), (vv, vt)))
    q = qt.new_zeros(qt.shape[:2] + (layout.block_q * cdiv(lt, layout.block_q), qt.shape[3]))
    q[:, :, :lt] = qt
    out_t = _flash(q, k, v, layout, act, _bias(text_mask, layout, sv), scale,
                   kv_valid_len=sv + lt)
    return video_out, out_t[:, :, :lt]


@functools.lru_cache(maxsize=16)
def _joint_sta_tables(jcfg: JointConfig) -> PairBitTables:
    """sta_batched's tables and pair bits over the tiled-video-plus-text
    layout (the JAX package's): video q blocks visit their tiles' windows
    and every text block; text q blocks every real video tile and every
    text block; text blocks carry all 32 bits (the bias masks their
    padding)."""
    layout = joint_layouts(jcfg)["sta"]
    tpt = jcfg.video.tokens_per_tile
    return pair_bit_tables(_joint_sta_subtile_mask(jcfg)[0], layout.block_q // tpt,
                           layout.block_kv // tpt, all_ones_from=layout.text_off // layout.block_kv)


def _joint_sta_batched(qv, kv_, vv, qt, kt, vt, text_mask, jcfg: JointConfig, act, scale):
    """One sta_batched launch over the tiled video and the text of the STA
    layout, text query rows included."""
    cfg = jcfg.video
    layout = joint_layouts(jcfg)["sta"]
    shape, tile = cfg.latent_shape, cfg.sta_tile
    q, k, v = (_assemble(tile_sequence(a, shape, tile), b, layout.text_off, layout.total)
               for a, b in ((qv, qt), (kv_, kt), (vv, vt)))
    kv_index, kv_count, pair_bits = _joint_sta_tables(jcfg).on(q.device)
    out = sta_flash_headbatched(
        q, k, v, kv_index, kv_count, act.to(torch.int32), pair_bits=pair_bits,
        tokens_per_tile=cfg.tokens_per_tile,
        kv_bias=_bias(text_mask, layout, cfg.seq_len).to(q.device),
        scale=scale, block_q=layout.block_q, block_kv=layout.block_kv, softmax="fast")
    tiled_out, text_out = _split(out, layout, cfg.seq_len, jcfg.text_len)
    return untile_sequence(tiled_out, shape, tile), text_out


# --- plain versions ----------------------------------------------------------------


def _chunked(q, k, v, block_mask, bias, block, scale, dtype):
    """The chunked plain attention in its recompute-backward form (the same
    forward, O(S * block) memory under autograd)."""
    with torch.profiler.record_function("joint_reference_attention"):
        out = attention_chunked_recompute(q, k, v, block_mask=block_mask, scale=scale,
                                          block_q=block, block_kv=block, kv_bias=bias)
    return out.to(dtype)


def joint_full_attention_ref(qv, kv_, vv, qt, kt, vt, text_mask, jcfg: JointConfig,
                             scale: Optional[float] = None):
    layout = joint_layouts(jcfg)["full"]
    q, k, v = (_assemble(a, b, layout.text_off, layout.total)
               for a, b in ((qv, qt), (kv_, kt), (vv, vt)))
    out = _chunked(q, k, v, None, _bias(text_mask, layout, jcfg.video.seq_len).to(q.device),
                   layout.block_q, scale, qv.dtype)
    return _split(out, layout, jcfg.video.seq_len, jcfg.text_len)


def joint_lowres_attention_ref(qv, kv_, vv, qt, kt, vt, text_mask, jcfg: JointConfig,
                               scale: Optional[float] = None):
    groups = lowres_groups_for(jcfg.video)
    layout = joint_layouts(jcfg)["lowres"]
    pq, q_match = pool_by_similarity(qv, groups)
    pk, k_match = pool_by_similarity(kv_, groups)
    pv, _ = pool_by_similarity(vv, groups, k_match)
    q, k, v = (_assemble(a, b, layout.text_off, layout.total)
               for a, b in ((pq, qt), (pk, kt), (pv, vt)))
    out = _chunked(q, k, v, None, _bias(text_mask, layout, groups.pooled_length).to(q.device),
                   layout.block_q, scale, qv.dtype)
    pooled_out, text_out = _split(out, layout, groups.pooled_length, jcfg.text_len)
    return unpool_by_similarity(pooled_out, groups, q_match).to(qv.dtype), text_out


@functools.lru_cache(maxsize=16)
def _joint_sta_subtile_mask(jcfg: JointConfig) -> np.ndarray:
    """(1, n_sub, n_sub) bool visibility of the tiled-video-plus-text STA
    layout at tile granularity (``_joint_sta_tables`` packs it): video
    tiles see their window and every text block; text rows see every real
    video tile and every text block (the bias masks the text padding)."""
    cfg = jcfg.video
    layout = joint_layouts(jcfg)["sta"]
    tpt = cfg.tokens_per_tile
    tile_mask = sta_tile_mask(cfg.latent_shape, cfg.sta_window, cfg.sta_tile)
    n_tiles = tile_mask.shape[0]
    n_sub = layout.total // tpt
    sub = np.arange(n_sub)
    text_col = sub * tpt >= layout.text_off
    video_vis = np.zeros((n_sub, n_sub), bool)
    video_vis[:n_tiles, :n_tiles] = tile_mask
    text_vis = np.broadcast_to(sub < n_tiles, (n_sub, n_sub))
    video_row = (sub * tpt < layout.text_off)[:, None]
    return np.where(video_row, video_vis, text_vis)[None] | text_col[None, None, :]


def joint_sta_attention_ref(qv, kv_, vv, qt, kt, vt, text_mask, jcfg: JointConfig,
                            scale: Optional[float] = None):
    cfg = jcfg.video
    layout = joint_layouts(jcfg)["sta"]
    shape, tile = cfg.latent_shape, cfg.sta_tile
    q, k, v = (_assemble(tile_sequence(a, shape, tile), b, layout.text_off, layout.total)
               for a, b in ((qv, qt), (kv_, kt), (vv, vt)))
    bm = torch.from_numpy(_joint_sta_subtile_mask(jcfg)).to(q.device)
    out = _chunked(q, k, v, bm, _bias(text_mask, layout, cfg.seq_len).to(q.device),
                   cfg.tokens_per_tile, scale, qv.dtype)
    tiled_out, text_out = _split(out, layout, cfg.seq_len, jcfg.text_len)
    return untile_sequence(tiled_out, shape, tile), text_out


# --- routing ---------------------------------------------------------------------


def routed_joint_attention(qv, kv_, vv, qt, kt, vt, scores: Optional[torch.Tensor],
                           text_mask: torch.Tensor, jcfg: JointConfig, mode: str = "soft",
                           scale: Optional[float] = None, expert_ids=None):
    """Returns (video (B, H, Sv, D), text (B, H, L, D)), the padded text rows
    zeroed.  Modes: "off" (full attention), "off_ref" (full attention
    through the plain version: the frozen teacher's pass in training, as in
    JAX, where it runs under grad tracing), "hard" (each head through its expert, the masked dispatch;
    ``expert_ids``: the routing already made, as (ids on the device, the
    same ids on the host), else made here from ``scores``), "soft" (the
    plain versions weighted by the scores)."""
    if mode == "off":
        video, text = joint_full_attention(qv, kv_, vv, qt, kt, vt, text_mask, jcfg,
                                           scale=scale)
    elif mode == "off_ref":
        video, text = joint_full_attention_ref(qv, kv_, vv, qt, kt, vt, text_mask, jcfg,
                                               scale=scale)
    elif mode == "hard":
        if expert_ids is None:
            ids = route_expert_ids(scores, jcfg.video.tau_sparse)
            expert_ids = (ids, ids.cpu().numpy())
        ids, ids_host = expert_ids
        ids = ids.to(qv.device)
        ids_host = np.asarray(ids_host).reshape(-1)
        routed = set(int(e) for e in ids_host)
        video = text = None
        for e, fn in ((STA, joint_sta_attention), (FULL, joint_full_attention),
                      (LOWRES, joint_lowres_attention)):
            if e in routed:
                # LOWRES sizes its head-map launch from the host's count
                kw = dict(num_active=int((ids_host == e).sum())) if e == LOWRES else {}
                ve, te = fn(qv, kv_, vv, qt, kt, vt, text_mask, jcfg, active=ids == e,
                            scale=scale, **kw)
                video = ve if video is None else video.add_(ve)
                text = te if text is None else text + te
        if video is None:
            video, text = torch.zeros_like(qv), torch.zeros_like(qt)
    elif mode == "soft":
        outs = [fn(qv, kv_, vv, qt, kt, vt, text_mask, jcfg, scale=scale)
                for fn in (joint_full_attention_ref, joint_lowres_attention_ref,
                           joint_sta_attention_ref)]
        w = scores.float()[:, :, :, None, None]  # (B, H, E, 1, 1)
        video = sum(w[:, :, e] * o[0].float() for e, o in enumerate(outs)).to(qv.dtype)
        text = sum(w[:, :, e] * o[1].float() for e, o in enumerate(outs)).to(qt.dtype)
    else:
        raise ValueError(f"unknown routing mode {mode!r}")
    return video, text * _text_ok(text_mask).to(text.device)[None, None, :, None].to(text.dtype)
