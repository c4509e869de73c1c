"""Window-dense sliding-tile attention by rows of q tiles (counterpart of
vorta_tpu/ops/sta_row.py), forward only: on CUDA it raises where grad mode
is on and an input requires grad.

The same function as ops/sta_window.py (stable softmax, inactive heads
zero, the optional joint text tail with ``text_bias`` added after the
scale), computed another way: the q tiles of one (t, h) row share their
(t, h) window, so they share one slab of K/V lines across the latent's
width, and each tile takes its own w window of every line.  The kernel
needs tile_w to be a multiple of 8; ``supports_row_dense`` is the TPU
kernel's eligibility test (that condition and its VMEM budget), which the
routed and joint dispatches use to choose as the JAX package does.

On CUDA tensors ``sta_row_attention`` launches ``csrc/sta_row.cu`` (bf16
or f32, D 64 or 128): in bf16 the Hopper path where ``row_wgmma_path``
says so (D = 128, bf16, a window box, a text tail of a multiple of 8 keys,
a slot table that fits; counted as ``sta_row_wgmma`` too), which is
sta_window's Hopper kernel (``csrc/sta_window_src.cuh``:
``sta_window_sm90_kernel``) over the same walk
(``ops/sta_pipe.py:window_walk``) and by the same rule, since the function
is the same: the row-dense sharing of K / V lines becomes that kernel's
launch order, the q tiles of one (t, h) row at adjacent CTAs reading the
row's lines from L2.  Else its mma.sync kernel (D = 64, windows with no
box), which ``sta_row_attention_mma_sync`` runs at any shape (the card's
yardstick).  f32 q / k / v (and text) take its f32 mode, sta_window's f32
kernel instantiated in ``csrc/sta_row.cu`` over the same window walk
(counted as ``sta_row_f32`` too).  On CPU tensors it runs the plain version
``sta_row_attention_ref``, sta_window's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash import LOG2E, NEG_INF  # noqa: F401  (public here, as in the JAX package)
from .sta_pipe import _text_tail
from .sta_window import (
    check_window_dense,
    launch_window_dense,
    sta_window_attention_ref,
    window_box,
    window_wgmma_path,
)

Shape3 = Tuple[int, int, int]


def supports_row_dense(latent_shape: Shape3, tile: Shape3, d: int, itemsize: int = 2,
                       text_len: int = 0, window: Shape3 = (3, 3, 3)) -> bool:
    """The TPU kernel's eligibility test: tiles divide the grid, tile_w is a
    multiple of 8, and its slabs and softmax states fit 40 MiB of VMEM."""
    t, hh, w = latent_shape
    tt, th, tw = tile
    if t % tt or hh % th or w % tw or tw % 8:
        return False
    nw = w // tw
    tpt = tt * th * tw
    slab = tt * th * w * d * itemsize
    bw = min(window[2], nw) * tw
    est = (2 * 2 * slab + 2 * 2 * slab + nw * tpt * (d + 2) * 4
           + 3 * tpt * tt * th * bw * 4 + 2 * text_len * d * itemsize)
    return est < 40 * 2**20


def row_wgmma_path(d: int, latent_shape: Shape3, tile: Shape3, window: Shape3 = (3, 3, 3), *,
                   dtype: torch.dtype = torch.bfloat16, text_len: int = 0) -> bool:
    """The rule of sta_row's Hopper path, for the geometries
    ``supports_row_dense`` admits: sta_window's (``window_wgmma_path``),
    whose kernel it runs.  Their tile_w % 8 == 0 makes every window run a
    multiple of 8 tokens, so the box is sta_pipe's ``walk_box``, never
    padded (the C entry refuses a padded one)."""
    return window_wgmma_path(d, latent_shape, tile, window, dtype=dtype, text_len=text_len)


def sta_row_attention_ref(q, k, v, active, *, latent_shape: Shape3, tile: Shape3,
                          window: Shape3 = (3, 3, 3), scale: Optional[float] = None,
                          text_k=None, text_v=None, text_bias=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: sta_window's, the same function."""
    return sta_window_attention_ref(q, k, v, active, latent_shape=latent_shape, tile=tile,
                                    window=window, scale=scale, text_k=text_k, text_v=text_v,
                                    text_bias=text_bias)


def sta_row_attention(
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
    """Row-dense STA: the contract of sta_window_attention, for the
    geometries ``supports_row_dense`` admits."""
    return _sta_row(q, k, v, active, latent_shape=latent_shape, tile=tile, window=window,
                    scale=scale, text_k=text_k, text_v=text_v, text_bias=text_bias,
                    cast_p_to_v_dtype=cast_p_to_v_dtype, hopper_ok=True)


def sta_row_attention_mma_sync(q, k, v, active, **kw) -> torch.Tensor:
    """``sta_row_attention`` on the mma.sync kernel whatever the rule says:
    the card's yardstick beside the Hopper path at the same call
    (``chip_smoke.py`` times both), counted in ``sta_row`` only."""
    return _sta_row(q, k, v, active, hopper_ok=False, **kw)


def _sta_row(q, k, v, active, *, latent_shape: Shape3, tile: Shape3,
             window: Shape3 = (3, 3, 3), scale: Optional[float] = None, text_k=None,
             text_v=None, text_bias=None, cast_p_to_v_dtype: bool = True,
             hopper_ok: bool = True) -> torch.Tensor:
    if not cast_p_to_v_dtype:
        raise NotImplementedError("cast_p_to_v_dtype=False (P kept in f32) is ROADMAP section 1 "
                                  "item 11: P is always cast to v's dtype here")
    check_window_dense(q, k, v, latent_shape)
    lt = 0 if text_k is None else text_k.shape[2]
    if not supports_row_dense(latent_shape, tile, q.shape[-1], q.element_size(), lt,
                              window=window):
        raise ValueError(f"geometry (latent {latent_shape}, tile {tile}) not eligible for the "
                         "row-dense kernel")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    text_k, text_v, text_bias = _text_tail(text_k, text_v, text_bias, q)
    kw = dict(latent_shape=latent_shape, tile=tile, window=window, scale=scale, text_k=text_k,
              text_v=text_v, text_bias=text_bias)
    if q.device.type == "cpu":
        return sta_row_attention_ref(q, k, v, active, **kw)
    hopper = hopper_ok and row_wgmma_path(q.shape[-1], latent_shape, tile, window,
                                          dtype=q.dtype, text_len=lt)
    box = window_box(tuple(latent_shape), tuple(tile), tuple(window)) if hopper else None
    return launch_window_dense("sta_row", q, k, v, active, box=box, **kw)
