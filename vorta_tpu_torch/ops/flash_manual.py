"""Block-sparse flash attention that loops over exactly each row's kv blocks
(counterpart of vorta_tpu/ops/flash_manual.py), forward only: on CUDA it
raises where grad mode is on and an input requires grad.

For q block ``i`` of head ``h`` the kernel visits
``kv_index[th, i, :kv_count[tc, i]]`` (``th``/``tc`` are 0 when the index
table / the counts are shared by all heads), so a row whose count is 0
costs nothing and writes zeros: the routed experts give each head its own
counts and share one index table.  Softmax is the "fast" form of the TPU
kernel: q is pre-scaled by ``scale * log2(e)`` in q's dtype (as the JAX
wrapper does, so the rounding matches), ``p = exp2(q.k)`` with no running
max (safe for qk-normed DiT tensors, see ops/sta_pipe.py), P is cast to
v's dtype before the PV product, and rows with ``l == 0`` give 0.
``kv_valid_len`` masks the tail as the TPU kernel does: only block
``kv_valid_len // block_kv`` is cut.  ``kv_bias``, a (1, Skv) f32 additive
logits bias shared by every batch row and head (the joint experts'
text-padding mask: -1e30 on padded keys), is added to the pre-scaled
scores in the log2 domain, with no ``log2(e)`` factor, as the TPU kernel
adds it: ``p = exp2(q.k + bias)``.

On CUDA tensors ``sparse_flash_attention_manual`` launches
``csrc/flash_manual.cu``; on CPU tensors it runs the plain version,
``sparse_flash_attention_manual_ref``.  The TPU wrapper's other options
belong to later slices and raise NotImplementedError.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .flash import LOG2E, _kv_column_limit


def _check(q, k, v, kv_index, kv_count, block_q, block_kv):
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if sq % block_q or skv % block_kv:
        raise ValueError(f"seq lens ({sq},{skv}) not divisible by blocks ({block_q},{block_kv})")
    if kv_index.shape[0] not in (1, h) or kv_index.shape[1] != sq // block_q:
        raise ValueError(f"tables {tuple(kv_index.shape)} for {h} heads, {sq // block_q} q blocks")
    if kv_count.shape[0] not in (1, h) or kv_count.shape[1] != sq // block_q:
        raise ValueError(f"counts {tuple(kv_count.shape)} for {h} heads, {sq // block_q} q blocks")


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * (scale * log2 e), the factor and the product in q's dtype."""
    return q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)


def _bias_row(kv_bias: torch.Tensor, skv: int) -> torch.Tensor:
    """(1, Skv) or (Skv,) bias -> (Skv,) f32."""
    if kv_bias.numel() != skv or (kv_bias.ndim == 2 and kv_bias.shape[0] != 1):
        raise ValueError(f"kv_bias {tuple(kv_bias.shape)} for {skv} keys")
    return kv_bias.reshape(skv).float()


def sparse_flash_attention_manual_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_index,
    kv_count,
    *,
    block_q: int,
    block_kv: int,
    scale: Optional[float] = None,
    kv_valid_len: Optional[int] = None,
    kv_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, one q block at a time."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    kv_valid_len = skv if kv_valid_len is None else kv_valid_len
    scale = d**-0.5 if scale is None else scale
    nkv = skv // block_kv
    kv_index = torch.as_tensor(kv_index, device=q.device).long()
    kv_count = torch.as_tensor(kv_count, device=q.device).long()
    _check(q, k, v, kv_index, kv_count, block_q, block_kv)
    width = kv_index.shape[2]
    active = torch.arange(width, device=q.device) < kv_count[..., None]  # (Hc, nq, W)
    onehot = torch.nn.functional.one_hot(kv_index, nkv).bool() & active[..., None]
    block_mask = onehot.any(dim=2)  # (max(Hi, Hc), nq, nkv)
    col_ok = _kv_column_limit(skv, block_kv, kv_valid_len, q.device)
    bias = 0.0 if kv_bias is None else _bias_row(kv_bias, skv).to(q.device)
    qs = _prescale(q, scale)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    for i in range(sq // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        vis = block_mask[:, i].repeat_interleave(block_kv, dim=-1) & col_ok  # (Hm, Skv)
        s = torch.einsum("bhqd,bhkd->bhqk", qs[:, :, rows].float(), kf) + bias
        p = torch.where(vis[None, :, None, :], torch.exp2(s), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        if v.dtype != torch.float32:
            p = p.to(v.dtype).float()
        o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        out[:, :, rows] = (o / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
    return out


def _flash_manual_fn():
    fn = _build.load("flash_manual").vorta_flash_manual_fwd_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p] + [i] * 12 + [p]
        fn.restype = ctypes.c_int
    return fn


def sparse_flash_attention_manual(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_index,
    kv_count,
    *,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    kv_valid_len: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
    pair_bits: Optional[torch.Tensor] = None,
    tokens_per_tile: Optional[int] = None,
    kv_bias: Optional[torch.Tensor] = None,
    cast_p_to_v_dtype: bool = True,
    softmax: str = "fast",
    qk_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, H, Skv, D).  kv_index: (1 or H, Sq//block_q,
    W) and kv_count: (1 or H, Sq//block_q) int32 tensors (or numpy);
    kv_bias: (1, Skv) f32 or None.  On CUDA: bf16 q/k/v, D 64 or 128,
    block_q a multiple of 16.  Only the fast
    softmax is served (the JAX wrapper defaults to the stable one; every
    routed caller passes "fast")."""
    unported = (
        (kv_valid is not None, "per-head kv_valid belongs to the Hunyuan joint-attention slice"),
        (pair_bits is not None or tokens_per_tile is not None,
         "pair_bits belong to the sta_batched fallback and the joint experts (Hunyuan slice)"),
        (qk_scale is not None, "int8 QK (qk_scale) belongs to the quantized serving slice"),
        (softmax != "fast", f"softmax={softmax!r}: the stable softmax of this kernel belongs "
                            "to a later slice (ops/flash.py serves it)"),
        (not cast_p_to_v_dtype, "P is always cast to v's dtype here"),
    )
    for bad, why in unported:
        if bad:
            raise NotImplementedError(why)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    kv_valid_len = skv if kv_valid_len is None else int(kv_valid_len)
    scale = d**-0.5 if scale is None else scale
    if q.device.type == "cpu":
        return sparse_flash_attention_manual_ref(
            q, k, v, kv_index, kv_count, block_q=block_q, block_kv=block_kv, scale=scale,
            kv_valid_len=kv_valid_len, kv_bias=kv_bias)

    _build.forward_only("sparse_flash_attention_manual", q, k, v)
    dev = _build.require_cuda(q, k, v)
    _check(q, k, v, kv_index, kv_count, block_q, block_kv)
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"the CUDA flash_manual kernel takes bf16, got {q.dtype}")
    if d not in (64, 128) or block_q % 16:
        raise NotImplementedError(f"the CUDA flash_manual kernel takes D 64/128 and "
                                  f"block_q % 16 == 0, got D={d}, block_q={block_q}")
    kv_index = torch.as_tensor(kv_index, dtype=torch.int32, device=dev).contiguous()
    kv_count = torch.as_tensor(kv_count, dtype=torch.int32, device=dev).contiguous()
    bias = None if kv_bias is None else _bias_row(kv_bias, skv).contiguous()
    _build.require_cuda(q, bias)
    qs = _prescale(q, scale).contiguous()
    k, v = k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    err = _flash_manual_fn()(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_index.data_ptr(), kv_count.data_ptr(), _build.ptr(bias), b, h, sq, skv, d,
        kv_index.shape[0], kv_count.shape[0], kv_index.shape[1], kv_index.shape[2],
        block_q, block_kv, kv_valid_len, _build.stream_ptr(dev))
    _build.check(err, "flash_manual")
    _build.launches["flash_manual"] += 1
    return out
