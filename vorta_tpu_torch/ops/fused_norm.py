"""Fused LayerNorm / RMSNorm (+ AdaLN modulation), and the residual update
fused with the LayerNorm after it, counterpart of vorta_tpu/ops/fused_norm.py.

f32 statistics regardless of the activation dtype (diffusers FP32LayerNorm
semantics), optional affine gamma/beta, optional AdaLN
``norm(x) * (1 + scale) + shift``, output in x's dtype or f32.  On CUDA
tensors ``fused_norm`` launches ``csrc/fused_norm.cu`` (bf16 x, or f32 x
on the f32 serving path, counted as ``fused_norm_f32`` too and written in
f32; other dtypes raise): the warp-per-row kernel where
``norm_layout`` gives dim a layout (every served width), else the
block-per-row kernel; both read AdaLN's scale / shift in place (strided
column slices of the modulation, f32 or bf16).  Both take x and an
optional ``out`` as (B, S, dim) views whose rows are dense and whose
batches may lie further apart, e.g. a range of rows of a longer sequence
(HunyuanVideo's token-replace norm runs two such ranges, each with its own
modulation, into one output); such a launch also counts as
``fused_norm_range``.  On CPU tensors it runs the plain version
``_norm_ref``.  Router training differentiates through the
norms, so ``fused_norm`` is a ``torch.autograd.Function`` on both devices:
its backward, ``_norm_bwd``, recomputes the f32 statistics in plain
PyTorch, the port of the JAX package's ``_fused_norm_bwd`` (XLA there, not
Pallas).

``fused_residual_norm`` returns ``(x_new, y)``: ``x_new = x + delta * gate``
rounded to x's dtype, and ``y`` the LayerNorm of that rounded ``x_new``
(the statistics on the rounded values, as the unfused code computes them)
with the same optional affine and AdaLN terms, in x's dtype.  On CUDA it
launches the second entry of ``csrc/fused_norm.cu`` under ``fused_norm``'s
rule (bf16, dim up to 12,288; the rest raises, f32 naming ROADMAP section 2
A6), on the CPU it runs
``_res_norm_ref``; its backward, ``_res_norm_bwd``, is plain PyTorch, as the
JAX package's ``_frn_bwd`` is plain XLA.  No model calls it, as in the JAX
package (its blocks keep the residual adds apart).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build


def _norm_ref(x, scale, shift, gamma, beta, *, rms, eps, out_f32):
    """Plain PyTorch version of the kernel."""
    xf = x.float()
    if rms:
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        xc = xf - mean
        y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    if gamma is not None:
        y = y * gamma.float()[None, None, :]
        if beta is not None:
            y = y + beta.float()[None, None, :]
    if scale is not None:
        y = y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return y if out_f32 else y.to(x.dtype)


def _norm_fn():
    fn = _build.load("fused_norm").vorta_fused_norm
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, ll, i, i, ll, ll, i, p]
        fn.restype = ctypes.c_int
    return fn


NORM_CHUNKS = 12  # 16-byte chunks of 8 bf16 a lane holds at most (96 f32 registers)


def norm_layout(dim: int) -> Optional[Tuple[int, int]]:
    """(warps per row, chunks per lane) of the warp-per-row norm kernel: dim
    = 256 * warps * chunks with the fewest warps (1, 2 or 4) that keep the
    chunks at most ``NORM_CHUNKS``; None (the block-per-row kernel) for any
    other dim.  The same rule on both sides: the C entry refuses a layout
    that differs from its own."""
    for wpr in (1, 2, 4):
        if dim % (256 * wpr) == 0 and dim // (256 * wpr) <= NORM_CHUNKS:
            return wpr, dim // (256 * wpr)
    return None


def _modulation(scale, shift, b: int, dim: int):
    """(scale, shift, row stride, is bf16) as the kernels read them: in place
    where both are (B, dim) f32 or bf16 views with unit column stride, one
    row stride and 16-byte aligned rows (AdaLN's ``mod[:, i]``), else
    contiguous f32 copies; (None, None, 0, 0) without modulation."""
    if scale is None:
        return None, None, 0, 0
    for t in (scale, shift):
        if tuple(t.shape) != (b, dim):
            raise ValueError(f"expected {(b, dim)}, got {tuple(t.shape)}")
    row = scale.stride(0) if b > 1 else dim
    in_place = (scale.dtype == shift.dtype and scale.dtype in (torch.float32, torch.bfloat16)
                and scale.stride(1) == shift.stride(1) == 1
                and (b == 1 or shift.stride(0) == row)
                and (row * scale.element_size()) % 16 == 0
                and scale.data_ptr() % 16 == 0 and shift.data_ptr() % 16 == 0)
    if not in_place:
        scale, shift, row = scale.float().contiguous(), shift.float().contiguous(), dim
    return scale, shift, row, int(scale.dtype == torch.bfloat16)


def _f32_vec(t: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    if t is None:
        return None
    t = t.float().contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected {tuple(shape)}, got {tuple(t.shape)}")
    return t


def _check_kernel_rule(what: str, x: torch.Tensor, dtypes=(torch.bfloat16,),
                       refusal: str = "") -> None:
    """The shapes the norm kernels take: ``dtypes``, a row of f32 in 48 KiB
    of shared memory."""
    if x.dtype not in dtypes:
        raise NotImplementedError(f"{what} kernel: dtype {x.dtype} (takes "
                                  f"{', '.join(map(str, dtypes))}){refusal}")
    if x.shape[-1] * 4 > 48 * 1024:
        raise NotImplementedError(f"{what} kernel: dim {x.shape[-1]} > 12288")


def _rows_view(t: torch.Tensor) -> bool:
    """(B, S, dim) with dense rows, 16-byte aligned rows and batches: what
    the kernels read and write in place."""
    b, s, dim = t.shape
    return (t.stride(2) == 1 and (s == 1 or t.stride(1) == dim)
            and (b == 1 or (t.stride(0) >= s * dim
                            and (t.stride(0) * t.element_size()) % 16 == 0))
            and (dim * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0)


def _norm_fwd(x, scale, shift, gamma, beta, rms, eps, out_f32, out=None):
    odtype = torch.float32 if out_f32 else x.dtype
    if out is not None and (tuple(out.shape) != tuple(x.shape) or out.dtype != odtype):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype}: expected {tuple(x.shape)} {odtype}")
    if x.device.type == "cpu":
        y = _norm_ref(x, scale, shift, gamma, beta, rms=rms, eps=eps, out_f32=out_f32)
        return y if out is None else out.copy_(y)

    b, s, dim = x.shape
    dev = _build.require_cuda(x, scale, shift, gamma, beta, out)
    _check_kernel_rule("fused_norm", x, (torch.bfloat16, torch.float32))
    x_f32 = x.dtype == torch.float32
    scale, shift, mod_stride, mod_bf16 = _modulation(scale, shift, b, dim)
    gamma, beta = (_build.aligned16(_f32_vec(t, (dim,))) for t in (gamma, beta))
    ranged = out is not None
    if out is None:
        out = torch.empty(x.shape, dtype=odtype, device=dev)
    elif not _rows_view(out):
        raise ValueError(f"fused_norm kernel: out strides {out.stride()} (dense 16-byte "
                         "aligned rows)")
    if not _rows_view(x):
        if ranged:
            raise ValueError(f"fused_norm kernel: x strides {x.stride()} (dense 16-byte "
                             "aligned rows)")
        x = _build.aligned16(x.contiguous())
    layout = norm_layout(dim)
    err = _norm_fn()(
        x.data_ptr(), out.data_ptr(), _build.ptr(scale), _build.ptr(shift),
        _build.ptr(gamma), _build.ptr(beta), b, s, dim,
        int(out_f32), int(rms), float(eps), mod_stride, mod_bf16,
        0 if layout is None else layout[0], x.stride(0), out.stride(0), int(x_f32),
        _build.stream_ptr(dev))
    _build.check(err, "fused_norm")
    _build.launches["fused_norm"] += 1
    _build.launches["fused_norm_f32"] += x_f32
    _build.launches["fused_norm_range"] += ranged
    return out


def _norm_bwd(g, x, scale, shift, gamma, beta, rms, eps):
    """Gradients of ``_norm_ref`` in f32, cast to each input's dtype: the
    standard LayerNorm / RMSNorm backward through the affine and AdaLN
    terms, exactly the JAX package's ``_fused_norm_bwd``."""
    xf, gf = x.float(), g.float()
    if rms:
        inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        xhat = xf * inv
    else:
        xc = xf - xf.mean(dim=-1, keepdim=True)
        inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
        xhat = xc * inv
    # out = (xhat * gamma + beta) * (1 + scale) + shift
    gmod, d_scale, d_shift = gf, None, None
    if scale is not None:
        affed = xhat if gamma is None else xhat * gamma.float()[None, None, :]
        if beta is not None:
            affed = affed + beta.float()[None, None, :]
        d_scale = (gf * affed).sum(dim=1).to(scale.dtype)
        d_shift = gf.sum(dim=1).to(shift.dtype)
        gmod = gf * (1.0 + scale.float()[:, None, :])
    ghat, d_gamma, d_beta = gmod, None, None
    if gamma is not None:
        d_gamma = (gmod * xhat).sum(dim=(0, 1)).to(gamma.dtype)
        if beta is not None:
            d_beta = gmod.sum(dim=(0, 1)).to(beta.dtype)
        ghat = gmod * gamma.float()[None, None, :]
    dot = (ghat * xhat).mean(dim=-1, keepdim=True)
    if rms:
        dx = (ghat - xhat * dot) * inv
    else:
        dx = (ghat - ghat.mean(dim=-1, keepdim=True) - xhat * dot) * inv
    return dx.to(x.dtype), d_scale, d_shift, d_gamma, d_beta


class _FusedNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, gamma, beta, rms, eps, out_f32):
        ctx.save_for_backward(x, scale, shift, gamma, beta)
        ctx.rms, ctx.eps = rms, eps
        return _norm_fwd(x, scale, shift, gamma, beta, rms, eps, out_f32)

    @staticmethod
    def backward(ctx, g):
        x, scale, shift, gamma, beta = ctx.saved_tensors
        grads = _norm_bwd(g, x, scale, shift, gamma, beta, ctx.rms, ctx.eps)
        return (*grads, None, None, None)


def fused_norm(x: torch.Tensor, scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
               gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor], rms: bool,
               eps: float, out_f32: bool, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, dim); scale/shift: (B, dim) or None; gamma/beta: (dim,) or None.
    Differentiable in every tensor input.  ``out``: a (B, S, dim) view the
    result is written into (forward only; on CUDA, rows dense and 16-byte
    aligned, as x's must then be too, else it raises)."""
    if x.ndim != 3:
        raise ValueError(f"fused_norm takes (B, S, dim), got {tuple(x.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if out is not None:
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in (x, scale, shift, gamma, beta)):
            raise ValueError("fused_norm: out= is forward-only")
        return _norm_fwd(x, scale, shift, gamma, beta, rms, eps, out_f32, out)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, scale, shift, gamma, beta)):
        return _FusedNorm.apply(x, scale, shift, gamma, beta, rms, eps, out_f32)
    # no graph to record: the forward alone, without the Function's host cost
    return _norm_fwd(x, scale, shift, gamma, beta, rms, eps, out_f32)


def layernorm_fp32(x, eps=1e-6, gamma=None, beta=None, out_f32=False):
    """LayerNorm with f32 statistics, optional affine."""
    return fused_norm(x, None, None, gamma, beta, False, eps, out_f32)


def adaln_layernorm(x, scale, shift, eps=1e-6, gamma=None, beta=None):
    """norm(x) * (1 + scale) + shift, output in x.dtype.  scale/shift (B, dim)."""
    return fused_norm(x, scale, shift, gamma, beta, False, eps, False)


def rmsnorm(x, weight, eps=1e-6):
    return fused_norm(x, None, None, weight, None, True, eps, False)


# ---- residual + norm fusion ---------------------------------------------------

def _res_norm_ref(x, delta, gate, scale, shift, gamma, beta, eps):
    """Plain PyTorch version of the residual kernel: (x_new, y)."""
    df = delta.float()
    if gate is not None:
        df = df * gate.float()[:, None, :]
    x_new = (x.float() + df).to(x.dtype)
    return x_new, _norm_ref(x_new, scale, shift, gamma, beta, rms=False, eps=eps, out_f32=False)


def _res_norm_fn():
    fn = _build.load("fused_norm").vorta_fused_residual_norm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _res_norm_fwd(x, delta, gate, scale, shift, gamma, beta, eps):
    if x.device.type == "cpu":
        return _res_norm_ref(x, delta, gate, scale, shift, gamma, beta, eps)

    b, s, dim = x.shape
    dev = _build.require_cuda(x, delta, gate, scale, shift, gamma, beta)
    _check_kernel_rule("fused_residual_norm", x,
                       refusal="; f32 is ROADMAP section 2 A6 (fused_residual_norm in f32)")
    if delta.dtype != x.dtype:
        raise NotImplementedError(f"fused_residual_norm kernel: delta {delta.dtype}, x {x.dtype}")
    gate, scale, shift = (_f32_vec(t, (b, dim)) for t in (gate, scale, shift))
    gamma, beta = _f32_vec(gamma, (dim,)), _f32_vec(beta, (dim,))
    x, delta = x.contiguous(), delta.contiguous()
    x_new, y = torch.empty_like(x), torch.empty_like(x)
    err = _res_norm_fn()(
        x.data_ptr(), delta.data_ptr(), x_new.data_ptr(), y.data_ptr(), _build.ptr(gate),
        _build.ptr(scale), _build.ptr(shift), _build.ptr(gamma), _build.ptr(beta), b, s, dim,
        float(eps), _build.stream_ptr(dev))
    _build.check(err, "fused_residual_norm")
    _build.launches["fused_residual_norm"] += 1
    return x_new, y


def _res_norm_bwd(g_xnew, g_y, x, delta, gate, scale, shift, gamma, beta, eps):
    """Gradients of ``_res_norm_ref``: the LayerNorm backward at the rounded
    x_new, then through the residual, exactly the JAX package's
    ``_frn_bwd``."""
    df = delta.float()
    gatef = None if gate is None else gate.float()[:, None, :]
    xn = (x.float() + (df if gatef is None else df * gatef)).to(x.dtype)  # forward rounding
    d_x, d_scale, d_shift, d_gamma, d_beta = _norm_bwd(g_y, xn, scale, shift, gamma, beta,
                                                       False, eps)
    d_xnew = g_xnew.float() + d_x.float()
    d_delta = d_xnew if gatef is None else d_xnew * gatef
    d_gate = None if gate is None else (d_xnew * df).sum(dim=1).to(gate.dtype)
    return (d_xnew.to(x.dtype), d_delta.to(delta.dtype), d_gate, d_scale, d_shift, d_gamma,
            d_beta)


class _FusedResidualNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, gate, scale, shift, gamma, beta, eps):
        ctx.save_for_backward(x, delta, gate, scale, shift, gamma, beta)
        ctx.eps = eps
        return _res_norm_fwd(x, delta, gate, scale, shift, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g_xnew, g_y):
        grads = _res_norm_bwd(g_xnew, g_y, *ctx.saved_tensors, ctx.eps)
        return (*grads, None)


def fused_residual_norm(x: torch.Tensor, delta: torch.Tensor, gate: Optional[torch.Tensor],
                        scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                        gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
                        eps: float):
    """(x + delta * gate, LayerNorm(x + delta * gate) modulated), both in x's
    dtype.  x / delta: (B, S, dim); gate / scale / shift: (B, dim) or None;
    gamma / beta: (dim,) or None.  Differentiable in every tensor input."""
    if x.ndim != 3 or delta.shape != x.shape:
        raise ValueError(f"fused_residual_norm takes x and delta (B, S, dim), got "
                         f"{tuple(x.shape)} and {tuple(delta.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    return _FusedResidualNorm.apply(x, delta, gate, scale, shift, gamma, beta, eps)
