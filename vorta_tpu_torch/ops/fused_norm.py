"""Fused LayerNorm / RMSNorm (+ AdaLN modulation), counterpart of
vorta_tpu/ops/fused_norm.py.

f32 statistics regardless of the activation dtype (diffusers FP32LayerNorm
semantics), optional affine gamma/beta, optional AdaLN
``norm(x) * (1 + scale) + shift``, output in x's dtype or f32.  On CUDA
tensors ``fused_norm`` launches ``csrc/fused_norm.cu`` (bf16 x, as the
model runs on the card; other dtypes raise); on CPU tensors it runs the
plain version ``_norm_ref``.  Router training differentiates through the
norms, so ``fused_norm`` is a ``torch.autograd.Function`` on both devices:
its backward, ``_norm_bwd``, recomputes the f32 statistics in plain
PyTorch, the port of the JAX package's ``_fused_norm_bwd`` (XLA there, not
Pallas).
"""

from __future__ import annotations

import ctypes
from typing import Optional

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
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _f32_vec(t: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    if t is None:
        return None
    t = t.float().contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected {tuple(shape)}, got {tuple(t.shape)}")
    return t


def _norm_fwd(x, scale, shift, gamma, beta, rms, eps, out_f32):
    if x.device.type == "cpu":
        return _norm_ref(x, scale, shift, gamma, beta, rms=rms, eps=eps, out_f32=out_f32)

    b, s, dim = x.shape
    dev = _build.require_cuda(x, scale, shift, gamma, beta)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"fused_norm kernel: dtype {x.dtype}")
    if dim * 4 > 48 * 1024:
        raise NotImplementedError(f"fused_norm kernel: dim {dim} > 12288")
    scale, shift = _f32_vec(scale, (b, dim)), _f32_vec(shift, (b, dim))
    gamma, beta = _f32_vec(gamma, (dim,)), _f32_vec(beta, (dim,))
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32 if out_f32 else x.dtype, device=dev)
    err = _norm_fn()(
        x.data_ptr(), out.data_ptr(), _build.ptr(scale), _build.ptr(shift),
        _build.ptr(gamma), _build.ptr(beta), b, s, dim,
        int(out_f32), int(rms), float(eps), _build.stream_ptr(dev))
    _build.check(err, "fused_norm")
    _build.launches["fused_norm"] += 1
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
               eps: float, out_f32: bool) -> torch.Tensor:
    """x: (B, S, dim); scale/shift: (B, dim) or None; gamma/beta: (dim,) or None.
    Differentiable in every tensor input."""
    if x.ndim != 3:
        raise ValueError(f"fused_norm takes (B, S, dim), got {tuple(x.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    return _FusedNorm.apply(x, scale, shift, gamma, beta, rms, eps, out_f32)
