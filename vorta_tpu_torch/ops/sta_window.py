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
(bf16 or f32, D 64 or 128): in bf16 the Hopper path
(``csrc/attn_sm90.cuh``'s mainloop with its online softmax over sta_pipe's
window source: wgmma, the window's runs loaded by TMA into 128-key slots;
counted as ``sta_window_wgmma`` too) where ``window_wgmma_path`` says so
(D = 128, bf16, a window box that lands, padded where the runs cannot:
every served geometry, with or without the text tail), with the slot table
of ``ops/sta_pipe.py:window_walk`` over ``window_box``; else its mma.sync
kernel (D = 64, the other windows).  f32 q / k / v (and text) take the f32
mode, its own kernel (``csrc/attn_f32.cuh``'s FFMA core over
``csrc/window_walk_f32.cuh``'s window walk: every key staged through its
own row pointer, so a run of any width needs no padding; the stable
softmax, q unscaled, P kept in f32; counted as ``sta_window_f32`` too,
never as the Hopper path).  On CPU tensors it runs the plain version
``sta_window_attention_ref``, which ops/sta_row.py shares.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..geometry import window_starts  # noqa: F401  (public here, as in the JAX package)
from . import _build
from .flash import LOG2E, NEG_INF  # noqa: F401  (NEG_INF public here, as in JAX)
from .layout import tile_sequence, untile_sequence
from .sta_pipe import (
    WALK_BN,
    WALK_MAX_SLOTS,
    _extent,
    _text_tail,
    _walk_on,
    _window_keys,
    walk_box,
    window_walk,
)

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


# 8-column blocks of a padded run that the Hopper kernel is built for
# (csrc/sta_window.cu: sta_window_sm90_kernel<RB>): runs of 25 to 31 tokens,
# the served (4, 9, 10) tile's 30
PAD_RUN_BLOCKS = (4,)


@functools.lru_cache(maxsize=64)
def window_box(latent_shape: Shape3, tile: Shape3,
               window: Shape3 = (3, 3, 3)) -> Optional[Tuple[int, int]]:
    """(box_w, box_h) of the Hopper path's TMA box: sta_pipe's ``walk_box``
    where one lands; else the window's runs of bw tokens padded to box_w =
    bw rounded up to a multiple of 8 (the padded columns masked), box_h of
    them a box (dividing the window's rows, box_w * box_h at most
    ``WALK_BN``): of those, the box whose slots hold the most window keys,
    then the taller.  None where neither fits (box_w / 8 not in
    ``PAD_RUN_BLOCKS``: the kernel is built for the served padding only)."""
    box = walk_box(latent_shape, tile, window)
    if box is not None:
        return box
    _, bh, bw = _extent(latent_shape, tile, window)
    pw = -(-bw // 8) * 8
    if pw // 8 not in PAD_RUN_BLOCKS:
        return None
    best = max(((WALK_BN // (pw * hb)) * hb * bw, hb) for hb in range(1, bh + 1)
               if bh % hb == 0 and pw * hb <= WALK_BN)
    return pw, best[1]


def window_wgmma_path(d: int, latent_shape: Shape3, tile: Shape3, window: Shape3 = (3, 3, 3), *,
                      dtype: torch.dtype = torch.bfloat16, text_len: int = 0) -> bool:
    """The rule of sta_window's Hopper path: head dim 128, bf16, a window
    box (``window_box``), a text tail of a multiple of 8 keys, and a slot
    table of at most ``WALK_MAX_SLOTS`` rows, which the kernel keeps in
    shared memory.  The same rule on both sides: the C entry refuses the
    Hopper path for anything else."""
    shape3, tile3, window3 = tuple(latent_shape), tuple(tile), tuple(window)
    box = window_box(shape3, tile3, window3)
    return (d == 128 and dtype == torch.bfloat16 and box is not None and text_len % 8 == 0
            and window_walk(shape3, tile3, window3, text_len, box).shape[0] <= WALK_MAX_SLOTS)


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
                        window: Shape3, scale: float, text_k, text_v, text_bias,
                        box: Optional[Tuple[int, int]]) -> torch.Tensor:
    """Checks and launches ``csrc/<kernel>.cu`` (sta_window or sta_row, one C
    interface) on CUDA tensors: f32 inputs its f32 mode; bf16 ones its
    Hopper path over the walk of ``box`` where the caller's rule gave one,
    else its mma.sync kernel."""
    _build.forward_only(f"{kernel}_attention", q, k, v, text_k, text_v)
    dev = _build.require_cuda(q, k, v, text_k, text_v, text_bias)
    dtype = q.dtype if q.dtype in (torch.bfloat16, torch.float32) else None
    if dtype is None or any(x is not None and x.dtype != dtype for x in (k, v, text_k, text_v)):
        raise NotImplementedError(f"the CUDA {kernel} kernel takes bf16 or f32 q / k / v and "
                                  f"text of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, _, d = q.shape
    if d not in (64, 128):
        raise NotImplementedError(f"the CUDA {kernel} kernel takes D 64/128, got {d}")
    active = torch.as_tensor(active, device=dev).to(torch.int32).contiguous()
    if active.shape != (h,):
        raise ValueError(f"active {tuple(active.shape)} for {h} heads")
    if dtype == torch.float32:
        return _launch_f32(kernel, q, k, v, active, dev, latent_shape=latent_shape, tile=tile,
                           window=window, scale=scale, text=(text_k, text_v, text_bias))
    fn = getattr(_build.load(kernel), f"vorta_{kernel}_fwd_bf16")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [ctypes.c_float] + [i] * 13 + [p] + [i] * 5 + [p]
        fn.restype = ctypes.c_int
    lt = 0 if text_k is None else text_k.shape[2]
    shape3, tile3, window3 = tuple(latent_shape), tuple(tile), tuple(window)
    walk = None if box is None else _walk_on(shape3, tile3, window3, lt, dev, box)
    q, k, v = (_build.aligned16(x.contiguous()) for x in (q, k, v))
    text = [None if x is None else _build.aligned16(x.contiguous())
            for x in (text_k, text_v, text_bias)]
    out = torch.empty(q.shape, dtype=v.dtype, device=dev)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), active.data_ptr(),
             *(_build.ptr(x) for x in text), scale * LOG2E, lt, b, h, *latent_shape, d, *tile,
             *window, _build.ptr(walk), 0 if walk is None else walk.shape[0],
             *(box or (0, 0)), _extent(shape3, tile3, window3)[2], int(box is not None),
             _build.stream_ptr(dev))
    _build.check(err, kernel)
    _build.launches[kernel] += 1
    if box is not None:
        _build.launches[f"{kernel}_wgmma"] += 1
    return out


def _launch_f32(kernel: str, q, k, v, active, dev, *, latent_shape: Shape3, tile: Shape3,
                window: Shape3, scale: float, text) -> torch.Tensor:
    """The f32 mode of ``csrc/<kernel>.cu`` (``csrc/attn_f32.cuh``'s FFMA core
    over ``csrc/window_walk_f32.cuh``'s window walk, the stable softmax, q
    not pre-scaled, P kept in f32), counted as ``<kernel>`` and
    ``<kernel>_f32``, never as its Hopper path."""
    fn = getattr(_build.load(kernel), f"vorta_{kernel}_fwd_f32")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [ctypes.c_float] + [i] * 13 + [p]
        fn.restype = ctypes.c_int
    b, h, _, d = q.shape
    text_k, text_v, text_bias = (None if x is None else _build.aligned16(x.contiguous())
                                 for x in text)
    lt = 0 if text_k is None else text_k.shape[2]
    q, k, v = (_build.aligned16(x.contiguous()) for x in (q, k, v))
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), active.data_ptr(),
             *(_build.ptr(x) for x in (text_k, text_v, text_bias)), scale * LOG2E, lt, b, h,
             *latent_shape, d, *tile, *window, _build.stream_ptr(dev))
    _build.check(err, f"{kernel} (f32)")
    _build.launches[kernel] += 1
    _build.launches[f"{kernel}_f32"] += 1
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
    return _sta_window(q, k, v, active, latent_shape=latent_shape, tile=tile, window=window,
                       scale=scale, text_k=text_k, text_v=text_v, text_bias=text_bias,
                       cast_p_to_v_dtype=cast_p_to_v_dtype, hopper_ok=True)


def sta_window_attention_mma_sync(q, k, v, active, **kw) -> torch.Tensor:
    """``sta_window_attention`` on the mma.sync kernel whatever the rule
    says: the card's yardstick beside the Hopper path at the same call
    (``chip_smoke.py`` times both), counted in ``sta_window`` only."""
    return _sta_window(q, k, v, active, hopper_ok=False, **kw)


def _sta_window(q, k, v, active, *, latent_shape: Shape3, tile: Shape3,
                window: Shape3 = (3, 3, 3), scale: Optional[float] = None, text_k=None,
                text_v=None, text_bias=None, cast_p_to_v_dtype: bool = True,
                hopper_ok: bool = True) -> torch.Tensor:
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
    lt = 0 if text_k is None else text_k.shape[2]
    hopper = hopper_ok and window_wgmma_path(q.shape[-1], latent_shape, tile, window,
                                             dtype=q.dtype, text_len=lt)
    box = window_box(tuple(latent_shape), tuple(tile), tuple(window)) if hopper else None
    return launch_window_dense("sta_window", q, k, v, active, box=box, **kw)
