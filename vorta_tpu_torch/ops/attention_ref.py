"""Plain attention in PyTorch: the small-shape oracle and the chunked
online-softmax version (counterpart of vorta_tpu/ops/attention_ref.py),
with ``attention_chunked_recompute``, the chunked version's differentiable
form: FlashAttention's recompute backward in plain PyTorch, O(S x block)
memory (HunyuanVideo's soft joint experts train through it).

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


# on the CPU, exp below this is 0 here: from e^-87.3 on, f32 turns subnormal,
# where exp and the arithmetic after it are slow, and the masked scores
# (-1e30) would take exp's slow path every chunk; a CUDA exp takes them at
# full speed, so the card keeps the plain exp
EXP_FLOOR = -87.0


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x); on the CPU 0 where x < EXP_FLOOR (where exp would be < 1.7e-38)."""
    if x.is_cuda:
        return torch.exp(x)
    return torch.exp(x.clamp(min=EXP_FLOOR)).masked_fill(x < EXP_FLOOR, 0.0)


def _exp_(x: torch.Tensor) -> torch.Tensor:
    """``_exp``, in place."""
    if x.is_cuda:
        return x.exp_()
    under = x < EXP_FLOOR
    return x.clamp_(min=EXP_FLOOR).exp_().masked_fill_(under, 0.0)


def _chunk_mask(bias, block_mask, col_valid, j: int, block_kv: int) -> torch.Tensor:
    """(B or 1, H, nq, 1, block_kv) f32 added to kv chunk j's scores: its
    bias, and -1e30 where the block mask or the valid length hides a key.
    (JAX sets those scores to -1e30; added, they land at or below it, which
    the loop takes alike: exp gives 0, and a row that sees no key yet keeps
    its running max at or below -1e30.)"""
    sl = slice(j * block_kv, (j + 1) * block_kv)
    vis = block_mask[None, :, :, j, None, None] & col_valid[j][None, None, None, None, :]
    return bias[:, None, None, None, sl] + torch.where(vis, 0.0, NEG_INF)


def _scores(qf, kj, mask, nq: int, inplace: bool) -> torch.Tensor:
    """The scaled q (B, H, Sq, D) against kv chunk j's keys, its mask added:
    (B, H, Sq, block_kv) f32."""
    b, h, sq, _ = qf.shape
    s = torch.matmul(qf, kj.transpose(-1, -2))
    if inplace:
        s.view(b, h, nq, sq // nq, -1).add_(mask)
        return s
    return (s.view(b, h, nq, sq // nq, -1) + mask).view(b, h, sq, -1)


def _chunked_setup(q, k, block_mask, scale, block_q, block_kv, kv_valid_len, kv_bias):
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sq % block_q or skv % block_kv:
        raise ValueError(f"seq lengths ({sq},{skv}) not divisible by blocks ({block_q},{block_kv})")
    if scale is None:
        scale = d**-0.5
    nq, nkv = sq // block_q, skv // block_kv
    if kv_valid_len is None:
        kv_valid_len = skv
    qf = q.float() * scale
    col_valid = (torch.arange(skv, device=q.device) < kv_valid_len).reshape(nkv, block_kv)
    bias = (torch.zeros((1, skv), device=q.device) if kv_bias is None
            else kv_bias.float().reshape(-1, skv))
    if block_mask is None:
        block_mask = torch.ones((h, nq, nkv), dtype=torch.bool, device=q.device)
    return scale, qf, nq, col_valid, bias, block_mask


def _chunks(k, v, bias, block_mask, col_valid, block_kv):
    """Per kv chunk j: (j, its rows, k_j and v_j in f32, its additive mask)."""
    for j in range(col_valid.shape[0]):
        sl = slice(j * block_kv, (j + 1) * block_kv)
        yield (j, sl, k[:, :, sl].float(), v[:, :, sl].float(),
               _chunk_mask(bias, block_mask, col_valid, j, block_kv))


def _chunked_forward(q, k, v, block_mask, scale, block_q, block_kv, kv_valid_len, kv_bias):
    """(out (B, H, Sq, D) f32, running max m, normaliser l).  Without grad
    mode the chunk's scores are updated in place (the same arithmetic)."""
    b, h, sq, d = q.shape
    scale, qf, nq, col_valid, bias, block_mask = _chunked_setup(
        q, k, block_mask, scale, block_q, block_kv, kv_valid_len, kv_bias)
    inplace = not torch.is_grad_enabled()
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for _, _, kj, vj, mask in _chunks(k, v, bias, block_mask, col_valid, block_kv):
        s = _scores(qf, kj, mask, nq, inplace)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
        # a masked score is at most -1e30, so its exp is 0
        p = _exp_(s.sub_(m_safe[..., None])) if inplace else _exp(s - m_safe[..., None])
        alpha = _exp(torch.where(m <= NEG_INF, NEG_INF, m - m_safe))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vj)
        m = m_new
    return acc / torch.where(l == 0.0, 1.0, l)[..., None], m, l


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
    Fully masked q rows produce zeros.  Autograd through this loop saves
    every chunk's scores: ``attention_chunked_recompute`` is the same
    function with a backward in O(S * block) memory.
    """
    out, _, _ = _chunked_forward(q, k, v, block_mask, scale, block_q, block_kv, kv_valid_len,
                                 kv_bias)
    return out.to(q.dtype)


class _ChunkedAttention(torch.autograd.Function):
    """attention_chunked with FlashAttention's backward: the forward keeps
    q, k, v, the f32 output and each row's log-sum-exp; the backward walks
    the kv chunks again, recomputing each chunk's probabilities from the
    log-sum-exp, in O(S * block) memory.  kv_bias takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, block_mask, scale, block_q, block_kv, kv_valid_len, kv_bias):
        out, m, l = _chunked_forward(q, k, v, block_mask, scale, block_q, block_kv,
                                     kv_valid_len, kv_bias)
        m_safe = torch.where(m <= NEG_INF, 0.0, m)
        # a row that sees no key: +inf, so every recomputed probability is 0
        lse = torch.where(l > 0.0, m_safe + torch.log(torch.where(l > 0.0, l, 1.0)),
                          float("inf"))
        ctx.save_for_backward(q, k, v, out, lse, block_mask, kv_bias)
        ctx.cfg = (scale, block_q, block_kv, kv_valid_len)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        # the name cli/profile_forward.py reads this backward's device time by
        with torch.profiler.record_function("joint_reference_attention_backward"):
            return _ChunkedAttention._backward(ctx, grad)

    @staticmethod
    def _backward(ctx, grad):
        q, k, v, out, lse, block_mask, kv_bias = ctx.saved_tensors
        scale, block_q, block_kv, kv_valid_len = ctx.cfg
        scale, qf, nq, col_valid, bias, block_mask = _chunked_setup(
            q, k, block_mask, scale, block_q, block_kv, kv_valid_len, kv_bias)
        g = grad.float()
        delta = (g * out).sum(dim=-1)
        dq = torch.zeros_like(qf)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for _, sl, kj, vj, mask in _chunks(k, v, bias, block_mask, col_valid, block_kv):
            # the chunk's probabilities again, from the log-sum-exp
            p = _exp_(_scores(qf, kj, mask, nq, True).sub_(lse[..., None]))
            dv[:, :, sl] = torch.matmul(p.transpose(-1, -2), g)
            ds = torch.matmul(g, vj.transpose(-1, -2)).sub_(delta[..., None]).mul_(p)
            dq += torch.matmul(ds, kj)
            dk[:, :, sl] = torch.matmul(ds.transpose(-1, -2), qf)
        return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None,
                None, None, None)


def attention_chunked_recompute(
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
    """``attention_chunked``, the same forward, differentiable in O(S * block)
    memory: the backward recomputes each kv chunk's scores from the saved
    log-sum-exp (FlashAttention's backward, in plain PyTorch) where autograd
    through the loop would save every chunk's.  In JAX this is XLA's
    autodiff of the chunk scan under ``jax.checkpoint``."""
    return _ChunkedAttention.apply(q, k, v, block_mask, scale, block_q, block_kv,
                                   kv_valid_len, kv_bias)
