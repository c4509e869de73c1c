"""Fused attention prologue: qk-RMSNorm + half-RoPE + head split in one pass
(counterpart of vorta_tpu/ops/prologue.py).

Reads q/k/v rows (B, S, D) once and writes q/k/v head-major (B, H, S, d).
RMS over the row (``norm_scope="row"``, Wan) or per head (``"head"``), in
f32, times the gain, rounded through the input dtype (so the result equals
the unfused RMSNorm -> split -> ``apply_rope_half`` path), then the rotation
of contiguous halves.  On CUDA tensors ``fused_qk_prologue`` launches
``csrc/prologue.cu`` (bf16, or f32 on the f32 serving path, counted as
``prologue_f32`` too; any S, any even d; other dtypes raise): the
warp-per-row kernel where ``prologue_layout`` gives (dim, heads, itemsize)
a layout (d = 128 and every served width; counted as ``prologue_rows``
too), else
the block-per-row kernel, which ``fused_qk_prologue_block`` runs at any
shape (the card's yardstick beside the new kernel).  On CPU tensors it runs
the plain version ``_prologue_ref``.  Inference only, as in the JAX
package: on CUDA it raises where grad mode is on and an input requires grad
(the plain version on the CPU stays differentiable).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from . import _build

# Read once at import, as in the JAX package: "off" selects the unfused ops
# so the two paths can be compared.
_PROLOGUE_MODE = os.environ.get("VORTA_PROLOGUE", "fused")


def set_prologue_mode(mode: str) -> None:
    """Override the fused-prologue gate ('fused' | 'off') for the calls that
    follow."""
    global _PROLOGUE_MODE
    _PROLOGUE_MODE = mode


def supports_prologue(s: int, dim: int, num_heads: int) -> bool:
    """Shapes the CUDA kernel takes (any S; its row stats in 48 KB of shared
    memory, at most 64 heads, an even head dim)."""
    d = dim // num_heads
    return dim == num_heads * d and d % 2 == 0 and num_heads <= 64 and 2 * dim * 4 <= 48 * 1024


ROW_CHUNKS = 6  # 16-byte chunks of q, k and v a lane holds at most (csrc/prologue.cu)


def prologue_layout(dim: int, num_heads: int, itemsize: int = 2) -> Optional[Tuple[int, int]]:
    """(warps a row, 16-byte chunks a lane) of the warp-per-row kernel:
    head dim 128 and dim = 32 * (16 / itemsize) * warps * chunks, with the
    fewest warps (1, 2 or 4; in f32 also 8) that keep the chunks at most
    ``ROW_CHUNKS``; None (the block-per-row kernel) for any other shape.  In
    bf16 Wan-1.3B's 1,536 gives (1, 6), HunyuanVideo's 3,072 (2, 6),
    Wan-14B's 5,120 (4, 5); in f32 (chunks of 4 columns, a lane holding as
    many bytes) (2, 6), (4, 6) and (8, 5).  The same rule on both sides: the
    C entry refuses a layout that differs from its own."""
    lane_cols = 32 * 16 // itemsize
    if num_heads < 1 or dim != num_heads * 128 or dim % lane_cols:
        return None
    chunks = dim // lane_cols
    for wpr in ((1, 2, 4, 8) if itemsize == 4 else (1, 2, 4)):
        if chunks % wpr == 0 and chunks // wpr <= ROW_CHUNKS:
            return wpr, chunks // wpr
    return None


def use_fused_prologue(routing_mode: str, s: int, dim: int, num_heads: int) -> bool:
    """The gate of every call site, as in the JAX package: soft routing (the
    training formulation) keeps the unfused ops, as do shapes the kernel
    does not take and ``VORTA_PROLOGUE=off``."""
    return (routing_mode != "soft" and _PROLOGUE_MODE == "fused"
            and supports_prologue(s, dim, num_heads))


def _prologue_ref(q, k, v, gain_q, gain_k, cos, sin, *, num_heads, eps, qk_norm, norm_scope):
    """Plain PyTorch version of the kernel."""
    b, s, dim = q.shape
    d = dim // num_heads

    def heads(x):
        return x.reshape(b, s, num_heads, d).transpose(1, 2)

    def norm(x, g):
        xf = heads(x).float()  # (B, H, S, d)
        if not qk_norm:
            return xf
        if norm_scope == "row":
            ms = (xf * xf).sum(dim=(1, 3), keepdim=True) / dim
        else:
            ms = (xf * xf).mean(dim=-1, keepdim=True)
        gh = g.float().reshape(num_heads, 1, d)
        return (xf * torch.rsqrt(ms + eps) * gh).to(x.dtype).float()

    def rotate(xf):
        x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    qo = rotate(norm(q, gain_q)).to(q.dtype)
    ko = rotate(norm(k, gain_k)).to(k.dtype)
    return qo, ko, heads(v).contiguous()


def _prologue_fn():
    fn = _build.load("prologue").vorta_qk_prologue
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ll, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _rows(x: torch.Tensor, aligned: bool):
    """(x, row stride): a (B, S, D) view with unit column stride and evenly
    spaced rows, such as a column slice of the fused qkv product, is read in
    place (for the warp-per-row kernel, ``aligned``, also 16-byte aligned
    rows); anything else is copied first."""
    b, s, _ = x.shape
    if (x.stride(2) != 1 or (b > 1 and x.stride(0) != s * x.stride(1))
            or (aligned and (x.stride(1) * x.element_size()) % 16)):
        x = x.contiguous()
    if aligned:
        x = _build.aligned16(x)
    return x, x.stride(1)


def fused_qk_prologue(
    q: torch.Tensor,  # (B, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
    gain_q: Optional[torch.Tensor],  # (D,) f32 or None
    gain_k: Optional[torch.Tensor],
    cos: torch.Tensor,  # (S, d//2) f32
    sin: torch.Tensor,
    *,
    num_heads: int,
    eps: float = 1e-6,
    qk_norm: bool = True,
    norm_scope: str = "row",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _prologue(q, k, v, gain_q, gain_k, cos, sin, num_heads=num_heads, eps=eps,
                     qk_norm=qk_norm, norm_scope=norm_scope, rows_ok=True)


def fused_qk_prologue_block(q, k, v, gain_q, gain_k, cos, sin, **kw):
    """``fused_qk_prologue`` on the block-per-row kernel whatever
    ``prologue_layout`` says: the card's yardstick beside the warp-per-row
    kernel at the same call (``chip_smoke.py`` times both), counted in
    ``prologue`` only."""
    return _prologue(q, k, v, gain_q, gain_k, cos, sin, rows_ok=False, **kw)


def _prologue(q, k, v, gain_q, gain_k, cos, sin, *, num_heads: int, eps: float = 1e-6,
              qk_norm: bool = True, norm_scope: str = "row", rows_ok: bool = True):
    b, s, dim = q.shape
    d = dim // num_heads
    if k.shape != q.shape or v.shape != q.shape or dim != num_heads * d or d % 2:
        raise ValueError(f"q/k/v {tuple(q.shape)} with {num_heads} heads")
    if cos.shape != (s, d // 2) or sin.shape != cos.shape:
        raise ValueError(f"cos/sin {tuple(cos.shape)} != {(s, d // 2)}")
    if norm_scope not in ("row", "head"):
        raise ValueError(f"norm_scope {norm_scope!r}")
    if qk_norm and gain_q is None:
        gain_q = torch.ones(dim, dtype=torch.float32, device=q.device)
        gain_k = gain_q
    if q.device.type == "cpu":
        return _prologue_ref(q, k, v, gain_q, gain_k, cos.float(), sin.float(),
                             num_heads=num_heads, eps=eps, qk_norm=qk_norm,
                             norm_scope=norm_scope)

    _build.forward_only("fused_qk_prologue", q, k, v, gain_q, gain_k)
    dev = _build.require_cuda(q, k, v, cos, sin)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"prologue kernel: bf16 or f32 q / k / v of one dtype, got "
                                  f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not supports_prologue(s, dim, num_heads):
        raise NotImplementedError(f"prologue kernel: {num_heads} heads, dim {dim}")
    x_f32 = q.dtype == torch.float32
    layout = prologue_layout(dim, num_heads, q.element_size()) if rows_ok else None
    (q, q_row), (k, k_row), (v, v_row) = (_rows(x, layout is not None) for x in (q, k, v))
    # f32 and contiguous already at every call site (no copy), aligned by
    # their allocations
    gq = _build.aligned16(gain_q.float().contiguous()) if qk_norm else None
    gk = _build.aligned16(gain_k.float().contiguous()) if qk_norm else None
    cos, sin = (_build.aligned16(x.float().contiguous()) for x in (cos, sin))
    qo = torch.empty((b, num_heads, s, d), dtype=q.dtype, device=dev)
    ko, vo = torch.empty_like(qo), torch.empty_like(qo)
    err = _prologue_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_row, k_row, v_row,
        _build.ptr(gq), _build.ptr(gk), cos.data_ptr(), sin.data_ptr(),
        qo.data_ptr(), ko.data_ptr(), vo.data_ptr(), b, s, num_heads, d,
        int(qk_norm), int(norm_scope == "head"), float(eps),
        0 if layout is None else layout[0], int(x_f32), _build.stream_ptr(dev))
    _build.check(err, "prologue")
    _build.launches["prologue"] += 1
    _build.launches["prologue_f32"] += x_f32
    if layout is not None:
        _build.launches["prologue_rows"] += 1
    return qo, ko, vo
