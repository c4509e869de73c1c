"""Block-sparse flash attention that loops over exactly each row's kv blocks
(counterpart of vorta_tpu/ops/flash_manual.py), forward only: on CUDA it
raises where grad mode is on and an input requires grad.

For q block ``i`` of head ``h`` the kernel visits
``kv_index[th, i, :kv_count[tc, i]]`` (``th``/``tc`` are 0 when the index
table / the counts are shared by all heads), so a row whose count is 0
costs nothing and writes zeros: the routed experts give each head its own
counts and share one index table.  Softmax "fast" is the TPU kernel's fast
form, the one every routed and joint caller passes: q is pre-scaled by
``scale * log2(e)`` in q's dtype (as the JAX wrapper does, so the rounding
matches), ``p = exp2(q.k)`` with no running max (safe for qk-normed DiT
tensors, see ops/sta_pipe.py), P is cast to v's dtype before the PV
product, and rows with ``l == 0`` give 0.
``kv_valid_len`` masks the tail as the TPU kernel does: only block
``kv_valid_len // block_kv`` is cut.  ``kv_bias``, a (1, Skv) f32 additive
logits bias shared by every batch row and head (the joint experts'
text-padding mask: -1e30 on padded keys), is added to the pre-scaled
scores in the log2 domain, with no ``log2(e)`` factor, as the TPU kernel
adds it: ``p = exp2(q.k + bias)``.

The int8 QK mode (``qk_scale``, the JAX package's quantized serving): q and
k arrive as int8 (symmetric per-head quantization, ops/routed_fused.py
``quantize_per_head``), q not pre-scaled, with an (H,) f32 ``qk_scale`` =
q_scale * k_scale.  The scores are the int32 sums q.k turned into f32 by one
multiply with ``qk_scale[h] * scale * log2(e)`` (the factor in f32, as the
JAX wrapper forms it); the bias, the tail rule, the fast softmax and the
bf16 PV product follow unchanged, and the output has v's dtype.  The plain
version's f32 einsum of the int8 values is exact (|q.k| <= 127^2 * 128 <
2^24), so it gives the kernel's int32 sums.

``softmax="stable"`` (the default, the JAX wrapper's; every routed and
joint caller passes "fast"): q is not pre-scaled, the
f32 scores ``q.k`` are scaled by ``scale * log2(e)``, then ``kv_bias`` is
added and the masked columns set to -1e30, with a running max per row (0
while it is still -1e30, the TPU kernel's ``m_safe``); it combines with
``kv_valid_len``, shared or per-head counts and the count-0 rows.

On CUDA tensors ``sparse_flash_attention_manual`` launches
``csrc/flash_manual.cu``: the Hopper path (``csrc/attn_sm90.cuh``: wgmma, a
TMA-fed K/V ring, warp specialisation; counted as ``flash_manual_wgmma``
too) where ``manual_wgmma_path`` says so (the fast softmax, bf16 or int8 q /
k, the shapes of ``ops/flash.py:wgmma_path``: every served geometry), else
its mma.sync kernel (D = 64, other blocks, the stable softmax); f32 q / k
/ v take the f32 mode, its own branch (either softmax, kv_bias, the tail
rule, the count-0 rows; q pre-scaled in f32 for the fast softmax; P kept in
f32; counted as ``flash_manual_f32`` too): the tensor-core core of
``csrc/attn_f32_tc.cuh`` (3xTF32 on wgmma, counted as
``flash_manual_f32_tc`` too) where ``ops/flash.py:f32_tc_path`` holds (D =
128, blocks multiples of 128: every f32 call of the 1.3B / 13B paths), else
``csrc/attn_f32.cuh``'s FFMA core (``sparse_flash_attention_manual_ffma``
runs it at any shape, the yardstick); int8 q / k with ``qk_scale`` and an
f32 v its int8 mode (counted as ``flash_manual_f32`` and
``flash_manual_int8``): where ``f32_tc_path`` holds (every served call)
``csrc/attn_int8_tc.cuh`` (the scores exact int32 sums of wgmma s8, the PV
product 3xTF32 on wgmma; counted as ``flash_manual_int8_tc`` too), else the
FFMA core (exact int32 sums by dp4a, FFMA PV; the tiny models, and the
yardstick at any shape); on CPU tensors it runs the plain version,
``sparse_flash_attention_manual_ref``.  The TPU wrapper's other options
(ROADMAP section 1 item 11) raise NotImplementedError.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .flash import (
    LOG2E,
    NEG_INF,
    _kv_column_limit,
    f32_tc_path,
    f32_tc_work,
    refuse_unported,
    wgmma_path,
)

NEG = -1e30
SOFTMAXES = ("fast", "stable")


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


def qk_factor(qk_scale: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """(H,) f32 ``qk_scale * (scale * log2 e)``: the int8 mode's one
    dequantization factor per head."""
    qk_scale = torch.as_tensor(qk_scale)
    if qk_scale.numel() != heads:
        raise ValueError(f"qk_scale {tuple(qk_scale.shape)} for {heads} heads")
    return qk_scale.reshape(heads).float() * (scale * LOG2E)


def check_int8_qk(q, k, softmax: str = "fast") -> None:
    """The int8 mode's preconditions, the JAX wrapper's."""
    if softmax != "fast":
        raise ValueError("qk_scale (int8 QK) requires softmax='fast'")
    if q.dtype != torch.int8 or k.dtype != torch.int8:
        raise ValueError(f"qk_scale requires int8 q and k, got {q.dtype}, {k.dtype}")


def scores_log2(q: torch.Tensor, k: torch.Tensor, scale: float, qkc) -> torch.Tensor:
    """f32 scores in the log2 domain: q pre-scaled in q's dtype then q.k, or,
    with ``qkc`` ((H,) f32, the int8 mode), the exact int8 sums times qkc.
    q: (B, H, ..., Sq, D), k: (B, H, ..., Skv, D)."""
    if qkc is None:
        return torch.einsum("bh...qd,bh...kd->bh...qk", _prescale(q, scale).float(), k.float())
    s = torch.einsum("bh...qd,bh...kd->bh...qk", q.float(), k.float())
    return s * qkc.to(s.device).reshape((1, -1) + (1,) * (s.ndim - 2))


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
    qk_scale: Optional[torch.Tensor] = None,
    softmax: str = "stable",
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, one q block at a time."""
    if softmax not in SOFTMAXES:
        raise ValueError(f"softmax {softmax!r} not in {SOFTMAXES}")
    if qk_scale is not None:
        check_int8_qk(q, k, softmax)
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
    qkc = None if qk_scale is None else qk_factor(qk_scale, scale, h)
    vf = v.float()
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    for i in range(sq // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        vis = block_mask[:, i].repeat_interleave(block_kv, dim=-1) & col_ok  # (Hm, Skv)
        if softmax == "stable":  # q not pre-scaled: the f32 scores are scaled
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows].float(), k.float())
            s = torch.where(vis[None, :, None, :], s * (scale * LOG2E) + bias, NEG)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp2(s - torch.where(m <= NEG, 0.0, m))
        else:
            s = scores_log2(q[:, :, rows], k, scale, qkc) + bias
            p = torch.where(vis[None, :, None, :], torch.exp2(s), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        if v.dtype != torch.float32:
            p = p.to(v.dtype).float()
        o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        # a row that sees no key is 0, whatever v holds (the kernel reads no v
        # for it: the uninitialized rows of a head-map pool stay out)
        out[:, :, rows] = torch.where(l == 0.0, 0.0, o / torch.where(l == 0.0, 1.0, l)).to(v.dtype)
    return out


def int8_tc_work(b: int, h: int, skv: int, device) -> torch.Tensor:
    """The int8 mode's scratch on the tensor cores for one call: the big and
    small TF32 halves of V^T (``skv`` keys, head dim 128), which its split
    pre-pass writes and its TMA copies read; q and k are exact int8."""
    return torch.empty(2 * b * h * skv * 128, dtype=torch.float32, device=device)


def manual_wgmma_path(d: int, block_q: int, block_kv: int, *, stable: bool = False) -> bool:
    """The Hopper path's rule for this kernel: the fast softmax (bf16 q / k,
    or int8 in the qk_scale mode) at the shapes of ``ops/flash.py:wgmma_path``.
    The stable softmax stays on the mma.sync kernel."""
    return not stable and wgmma_path(d, block_q, block_kv)


def _flash_manual_fn():
    fn = _build.load("flash_manual").vorta_flash_manual_fwd_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 13 + [ctypes.c_float, p, p]
        fn.restype = ctypes.c_int
    return fn


def _flash_manual_f32_fn():
    fn = _build.load("flash_manual").vorta_flash_manual_fwd_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 13 + [ctypes.c_float, p, p]
        fn.restype = ctypes.c_int
    return fn


def sparse_flash_attention_manual_ffma(q, k, v, kv_index, kv_count, *,
                                       scale: Optional[float] = None, block_q: int = 512,
                                       block_kv: int = 512, kv_valid_len: Optional[int] = None,
                                       kv_bias: Optional[torch.Tensor] = None,
                                       softmax: str = "stable",
                                       qk_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sparse_flash_attention_manual`` with an f32 v on the FFMA core
    whatever ``f32_tc_path`` says: f32 q / k, or int8 q / k with
    ``qk_scale`` (dp4a scores); the card's yardstick beside the tensor-core
    kernels at the same call (``chip_smoke.py`` times both), counted in
    ``flash_manual`` / ``flash_manual_f32`` (and ``flash_manual_int8``)
    only.  CUDA tensors."""
    dev = _build.require_cuda(q, k, v)
    if v.dtype != torch.float32 or softmax not in SOFTMAXES:
        raise ValueError(f"the FFMA yardstick takes an f32 v and a softmax of {SOFTMAXES}")
    if qk_scale is not None:
        check_int8_qk(q, k, softmax)
    _build.forward_only("sparse_flash_attention_manual_ffma", q, k, v)
    _check(q, k, v, kv_index, kv_count, block_q, block_kv)
    d, skv = q.shape[-1], k.shape[2]
    return _manual_f32(q, k, v, kv_index, kv_count, dev, scale=d**-0.5 if scale is None else scale,
                       block_q=block_q, block_kv=block_kv,
                       kv_valid_len=skv if kv_valid_len is None else int(kv_valid_len),
                       kv_bias=kv_bias, qk_scale=qk_scale, softmax=softmax, tc_ok=False)


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
    softmax: str = "stable",
    qk_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, H, Skv, D).  kv_index: (1 or H, Sq//block_q,
    W) and kv_count: (1 or H, Sq//block_q) int32 tensors (or numpy);
    kv_bias: (1, Skv) f32 or None; qk_scale: (H,) f32 with int8 q / k, or
    None.  On CUDA: bf16 v (and q / k unless int8), D 64 or 128, block_q a
    multiple of 16; or f32 v (and q / k unless int8), blocks multiples of
    8.  softmax
    "stable" (the default, the JAX wrapper's) or "fast" (what every routed
    and joint caller passes; int8 QK needs it)."""
    if qk_scale is not None:
        check_int8_qk(q, k, softmax)
    if softmax not in SOFTMAXES:
        raise ValueError(f"softmax {softmax!r} not in {SOFTMAXES}")
    refuse_unported(kv_valid, pair_bits, tokens_per_tile, cast_p_to_v_dtype)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    kv_valid_len = skv if kv_valid_len is None else int(kv_valid_len)
    scale = d**-0.5 if scale is None else scale
    if q.device.type == "cpu":
        return sparse_flash_attention_manual_ref(
            q, k, v, kv_index, kv_count, block_q=block_q, block_kv=block_kv, scale=scale,
            kv_valid_len=kv_valid_len, kv_bias=kv_bias, qk_scale=qk_scale, softmax=softmax)

    _build.forward_only("sparse_flash_attention_manual", q, k, v)
    dev = _build.require_cuda(q, k, v)
    _check(q, k, v, kv_index, kv_count, block_q, block_kv)
    if v.dtype == torch.float32:
        return _manual_f32(q, k, v, kv_index, kv_count, dev, scale=scale, block_q=block_q,
                           block_kv=block_kv, kv_valid_len=kv_valid_len, kv_bias=kv_bias,
                           qk_scale=qk_scale, softmax=softmax)
    qk_dtype = torch.bfloat16 if qk_scale is None else torch.int8
    if v.dtype != torch.bfloat16 or q.dtype != qk_dtype or k.dtype != qk_dtype:
        raise NotImplementedError(f"the CUDA flash_manual kernel takes bf16 (q / k int8 with "
                                  f"qk_scale) or f32 q / k / v, got {q.dtype}, {k.dtype}, "
                                  f"{v.dtype}")
    if d not in (64, 128) or block_q % 16:
        raise NotImplementedError(f"the CUDA flash_manual kernel takes D 64/128 and "
                                  f"block_q % 16 == 0, got D={d}, block_q={block_q}")
    kv_index = torch.as_tensor(kv_index, dtype=torch.int32, device=dev).contiguous()
    kv_count = torch.as_tensor(kv_count, dtype=torch.int32, device=dev).contiguous()
    bias = None if kv_bias is None else _bias_row(kv_bias, skv).contiguous()
    qkc = None if qk_scale is None else qk_factor(qk_scale, scale, h).contiguous()
    _build.require_cuda(q, bias, qkc)
    stable = softmax == "stable"
    hopper = manual_wgmma_path(d, block_q, block_kv, stable=stable)
    qs = (_prescale(q, scale) if qkc is None and not stable else q).contiguous()
    qs, k, v, bias = (_build.aligned16(t) for t in (qs, k.contiguous(), v.contiguous(), bias))
    out = torch.empty(q.shape, dtype=v.dtype, device=dev)
    err = _flash_manual_fn()(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_index.data_ptr(), kv_count.data_ptr(), _build.ptr(bias), _build.ptr(qkc),
        b, h, sq, skv, d, kv_index.shape[0], kv_count.shape[0], kv_index.shape[1],
        kv_index.shape[2], block_q, block_kv, kv_valid_len, int(stable), float(scale * LOG2E),
        int(hopper), _build.stream_ptr(dev))
    _build.check(err, "flash_manual")
    _build.launches["flash_manual"] += 1
    if hopper:
        _build.launches["flash_manual_wgmma"] += 1
    if qkc is not None:
        _build.launches["flash_manual_int8"] += 1
    if stable:
        _build.launches["flash_manual_stable"] += 1
    return out


def _manual_f32(q, k, v, kv_index, kv_count, dev, *, scale: float, block_q: int, block_kv: int,
                kv_valid_len: int, kv_bias, qk_scale, softmax: str,
                tc_ok: bool = True) -> torch.Tensor:
    """The f32 mode on CUDA: f32 q / k / v, either softmax, or int8 q / k
    with ``qk_scale`` (the fast softmax, q not pre-scaled), on the tensor
    cores where ``f32_tc_path`` holds (``csrc/attn_f32_tc.cuh``; the int8
    mode ``csrc/attn_int8_tc.cuh``), else on the FFMA core of
    ``csrc/attn_f32.cuh``."""
    qk_dtype = torch.float32 if qk_scale is None else torch.int8
    if q.dtype != qk_dtype or k.dtype != qk_dtype:
        raise NotImplementedError(f"the CUDA flash_manual f32 mode takes f32 q / k / v, or int8 "
                                  f"q / k with qk_scale and an f32 v, got {q.dtype}, {k.dtype}, "
                                  f"{v.dtype}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d not in (64, 128) or block_q % 8 or block_kv % 8:
        raise NotImplementedError(f"the CUDA flash_manual f32 mode takes D 64/128 and blocks "
                                  f"that are multiples of 8, got D={d}, blocks "
                                  f"{block_q}/{block_kv}")
    kv_index = torch.as_tensor(kv_index, dtype=torch.int32, device=dev).contiguous()
    kv_count = torch.as_tensor(kv_count, dtype=torch.int32, device=dev).contiguous()
    bias = None if kv_bias is None else _bias_row(kv_bias, skv).contiguous()
    qkc = None if qk_scale is None else qk_factor(qk_scale, scale, h).contiguous()
    _build.require_cuda(q, bias, qkc)
    stable = softmax == "stable"
    tc = tc_ok and f32_tc_path(d, block_q, block_kv)
    qs = q if stable or qkc is not None else _prescale(q, scale)
    qs, k, v = (_build.aligned16(t.contiguous()) for t in (qs, k, v))
    bias = _build.aligned16(bias)  # the int8 mode's bulk copies read it in 256-byte slices
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    work = None
    if tc:  # the split halves the kernel reads: V^T's alone in the int8 mode
        work = f32_tc_work(b, h, sq, skv, dev) if qkc is None else int8_tc_work(b, h, skv, dev)
    err = _flash_manual_f32_fn()(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kv_index.data_ptr(),
        kv_count.data_ptr(), _build.ptr(bias), _build.ptr(qkc), b, h, sq, skv, d,
        kv_index.shape[0], kv_count.shape[0], kv_index.shape[1], kv_index.shape[2], block_q,
        block_kv, kv_valid_len, int(stable), float(scale * LOG2E), _build.ptr(work),
        _build.stream_ptr(dev))
    _build.check(err, "flash_manual (f32)")
    _build.launches["flash_manual"] += 1
    _build.launches["flash_manual_f32"] += 1
    if qkc is not None:
        _build.launches["flash_manual_int8"] += 1
        _build.launches["flash_manual_int8_tc"] += tc
    else:
        _build.launches["flash_manual_f32_tc"] += tc
    if stable:
        _build.launches["flash_manual_stable"] += 1
    return out
