"""Plain attention in PyTorch: the small-shape oracle and the chunked
online-softmax version (counterpart of vorta_tpu/ops/attention_ref.py).

Both take an optional *block mask* with the semantics of the flash kernel's
block tables: visibility constant within (block_q x block_kv) tiles.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float(-1e30)


def attention_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q/k/v: (B, H, S, D); mask broadcastable to (B, H, Sq, Skv), True = attend."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def expand_block_mask(block_mask: torch.Tensor, block_q: int, block_kv: int) -> torch.Tensor:
    """(H, nq, nkv) bool -> (1, H, Sq, Skv) element mask (for the oracle)."""
    m = block_mask.repeat_interleave(block_q, dim=-2).repeat_interleave(block_kv, dim=-1)
    return m[None]


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_q: int = 256,
    block_kv: int = 256,
    kv_valid_len: Optional[int] = None,
    kv_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Online-softmax attention over kv chunks, O(S * block) memory.

    q: (B, H, Sq, D), k/v: (B, H, Skv, D); Sq % block_q == Skv % block_kv == 0.
    block_mask: optional (H, Sq // block_q, Skv // block_kv) bool.
    kv_valid_len: mask kv positions >= this logical length.
    kv_bias: optional (B or 1, Skv) additive logits bias (-1e30 masks a key).
    Fully masked q rows produce zeros.
    """
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sq % block_q or skv % block_kv:
        raise ValueError(f"seq lengths ({sq},{skv}) not divisible by blocks ({block_q},{block_kv})")
    if scale is None:
        scale = d**-0.5
    nq, nkv = sq // block_q, skv // block_kv
    if kv_valid_len is None:
        kv_valid_len = skv
    qf = (q.float() * scale).reshape(b, h, nq, block_q, d)
    col_valid = (torch.arange(skv, device=q.device) < kv_valid_len).reshape(nkv, block_kv)
    bias = (torch.zeros((1, skv), device=q.device) if kv_bias is None
            else kv_bias.float().reshape(-1, skv))
    m = torch.full((b, h, nq, block_q), NEG_INF, device=q.device)
    l = torch.zeros((b, h, nq, block_q), device=q.device)
    acc = torch.zeros((b, h, nq, block_q, d), device=q.device)
    for j in range(nkv):
        kj = k[:, :, j * block_kv:(j + 1) * block_kv].float()
        vj = v[:, :, j * block_kv:(j + 1) * block_kv].float()
        mj = (torch.ones((h, nq), dtype=torch.bool, device=q.device)
              if block_mask is None else block_mask[:, :, j])
        s = torch.einsum("bhnqd,bhkd->bhnqk", qf, kj)
        s = s + bias[:, None, None, None, j * block_kv:(j + 1) * block_kv]
        s = torch.where(mj[None, :, :, None, None], s, NEG_INF)
        s = torch.where(col_valid[j][None, None, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mj[None, :, :, None, None], p, 0.0)
        alpha = torch.exp(torch.where(m <= NEG_INF, NEG_INF, m - m_safe))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhnqk,bhkd->bhnqd", p, vj)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(b, h, sq, d).to(q.dtype)
