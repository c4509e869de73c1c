"""Window-dense sliding-tile attention with the stable softmax, one q tile
over its window box (counterpart of vorta_tpu/ops/sta_window.py), forward
only: on CUDA it raises where grad mode is on and an input requires grad.

Each query attends to every token of the ``prod(window)`` tiles of its
tile's window, the window center clamped so that it never hangs off the
grid (``geometry.window_starts``): the function of ops/sta_pipe.py, read
from the raster (B, H, S, D) tensors with no relayout, but with the TPU
kernel's stable softmax: scores ``q.k * (scale * log2(e))`` in f32 (q not
pre-scaled), a running max, P cast to v's dtype before the PV product.
Heads whose ``active`` entry is 0 write zeros.  The joint text tail
(HunyuanVideo): with ``text_k`` / ``text_v`` (B, H, Lt, D) every query of
an active head also attends to the Lt text keys, ``text_bias`` ((1, Lt)
f32, -1e30 on a padded text token; zeros when None) added after the scale.
The text queries are the caller's (ops/joint_experts.py).

The TPU kernel reads a tile_w that is not a multiple of 8 through an
8-aligned superset box whose slack columns a logits bias masks, with q
and out in the tile-major layout: VMEM layout details of the same
function.  ``supports_window_dense`` and ``prefer_window_dense`` are its
gates, which the routed and joint dispatches use to choose as the JAX
package does.

On CUDA tensors ``sta_window_attention`` launches ``csrc/sta_window.cu``
(bf16, D 64 or 128); on CPU tensors it runs the plain version
``sta_window_attention_ref``, which ops/sta_row.py shares.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .flash import LOG2E
from .layout import tile_sequence, untile_sequence
from .sta_pipe import _text_tail, _window_keys

Shape3 = Tuple[int, int, int]


def supports_window_dense(latent_shape: Shape3, tile: Shape3) -> bool:
    """The TPU kernel's condition: tiles divide the grid, and tile_w or the
    tile's size is a multiple of 8."""
    tt, th, tw = tile
    if any(latent_shape[a] % tile[a] for a in range(3)):
        return False
    return tw % 8 == 0 or (tt * th * tw) % 8 == 0


def prefer_window_dense(latent_shape: Shape3, tile: Shape3) -> bool:
    """The JAX package's choice of its window-dense STA kernels over the
    tiled pair-bits kernel (sta_batched): window-dense tiles of at least 192
    tokens."""
    tt, th, tw = tile
    return supports_window_dense(latent_shape, tile) and tt * th * tw >= 192


def check_window_dense(q, k, v, latent_shape: Shape3) -> None:
    s = q.shape[2]
    if s != latent_shape[0] * latent_shape[1] * latent_shape[2]:
        raise ValueError(f"seq len {s} != prod(latent_shape) {latent_shape}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")


def sta_window_attention_ref(q, k, v, active, *, latent_shape: Shape3, tile: Shape3,
                             window: Shape3 = (3, 3, 3), scale: Optional[float] = None,
                             text_k=None, text_v=None, text_bias=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (and of sta_row's), a few q tiles
    at a time, each over its whole window and text tail at once."""
    text_k, text_v, text_bias = _text_tail(text_k, text_v, text_bias, q)
    b, h, s, d = q.shape
    sl = (d**-0.5 if scale is None else scale) * LOG2E
    keys = torch.from_numpy(_window_keys(latent_shape, tile, window)).to(q.device)
    n_tiles, nk = keys.shape
    tpt = s // n_tiles
    tq = tile_sequence(q, latent_shape, tile).reshape(b, h, n_tiles, tpt, d)
    out = torch.empty((b, h, n_tiles, tpt, d), dtype=v.dtype, device=q.device)
    chunk = max(1, 2**28 // (b * h * tpt * nk))
    for c0 in range(0, n_tiles, chunk):
        idx = keys[c0:c0 + chunk]
        qc = tq[:, :, c0:c0 + chunk].float()
        s_w = torch.einsum("bhcqd,bhckd->bhcqk", qc, k[:, :, idx].float()) * sl
        m = s_w.amax(dim=-1, keepdim=True)
        if text_k is not None:
            s_t = torch.einsum("bhcqd,bhkd->bhcqk", qc, text_k.float()) * sl + text_bias
            m = torch.maximum(m, s_t.amax(dim=-1, keepdim=True))
        p = torch.exp2(s_w - m)
        l = p.sum(dim=-1, keepdim=True)
        if v.dtype != torch.float32:
            p = p.to(v.dtype).float()
        o = torch.einsum("bhcqk,bhckd->bhcqd", p, v[:, :, idx].float())
        if text_k is not None:
            pt = torch.exp2(s_t - m)
            l = l + pt.sum(dim=-1, keepdim=True)
            if v.dtype != torch.float32:
                pt = pt.to(v.dtype).float()
            o = o + torch.einsum("bhcqk,bhkd->bhcqd", pt, text_v.float())
        out[:, :, c0:c0 + chunk] = (o / l).to(v.dtype)
    out = untile_sequence(out.reshape(b, h, s, d), latent_shape, tile)
    a = torch.as_tensor(active, device=q.device).reshape(1, h, 1, 1) > 0
    return torch.where(a, out, torch.zeros((), dtype=out.dtype, device=out.device))


def launch_window_dense(kernel: str, q, k, v, active, *, latent_shape: Shape3, tile: Shape3,
                        window: Shape3, scale: float, text_k, text_v, text_bias) -> torch.Tensor:
    """Checks and launches ``csrc/<kernel>.cu`` (sta_window or sta_row, one C
    interface) on CUDA tensors."""
    _build.forward_only(f"{kernel}_attention", q, k, v, text_k, text_v)
    dev = _build.require_cuda(q, k, v, text_k, text_v, text_bias)
    if any(x is not None and x.dtype != torch.bfloat16 for x in (q, k, v, text_k, text_v)):
        raise NotImplementedError(f"the CUDA {kernel} kernel takes bf16 (f32: ROADMAP section 1 "
                                  f"item 12), got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, _, d = q.shape
    if d not in (64, 128):
        raise NotImplementedError(f"the CUDA {kernel} kernel takes D 64/128, got {d}")
    active = torch.as_tensor(active, device=dev).to(torch.int32).contiguous()
    if active.shape != (h,):
        raise ValueError(f"active {tuple(active.shape)} for {h} heads")
    lib = _build.load(kernel)
    fn = getattr(lib, f"vorta_{kernel}_fwd_bf16")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [ctypes.c_float] + [i] * 13 + [p]
        fn.restype = ctypes.c_int
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    text = [None if x is None else x.contiguous() for x in (text_k, text_v, text_bias)]
    out = torch.empty(q.shape, dtype=v.dtype, device=dev)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), active.data_ptr(),
             *(_build.ptr(x) for x in text), scale * LOG2E,
             0 if text_k is None else text_k.shape[2], b, h, *latent_shape, d, *tile, *window,
             _build.stream_ptr(dev))
    _build.check(err, kernel)
    _build.launches[kernel] += 1
    return out


def sta_window_attention(
    q: torch.Tensor,  # (B, H, S, D) raster
    k: torch.Tensor,
    v: torch.Tensor,
    active,  # (H,) int: heads routed to this expert
    *,
    latent_shape: Shape3,
    tile: Shape3,
    window: Shape3 = (3, 3, 3),
    scale: Optional[float] = None,
    text_k: Optional[torch.Tensor] = None,
    text_v: Optional[torch.Tensor] = None,
    text_bias: Optional[torch.Tensor] = None,
    cast_p_to_v_dtype: bool = True,
) -> torch.Tensor:
    """Window-dense STA with the stable softmax, with the joint text tail
    where ``text_k`` and ``text_v`` are given."""
    if not cast_p_to_v_dtype:
        raise NotImplementedError("cast_p_to_v_dtype=False (P kept in f32) is ROADMAP section 1 "
                                  "item 11: P is always cast to v's dtype here")
    check_window_dense(q, k, v, latent_shape)
    if not supports_window_dense(latent_shape, tile):
        raise ValueError(f"geometry (latent {latent_shape}, tile {tile}) unsupported: tiles "
                         "must divide the latent grid")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    text_k, text_v, text_bias = _text_tail(text_k, text_v, text_bias, q)
    kw = dict(latent_shape=latent_shape, tile=tile, window=window, scale=scale, text_k=text_k,
              text_v=text_v, text_bias=text_bias)
    if q.device.type == "cpu":
        return sta_window_attention_ref(q, k, v, active, **kw)
    return launch_window_dense("sta_window", q, k, v, active, **kw)
