"""Sliding-tile attention on the raster layout (counterpart of
vorta_tpu/ops/sta_pipe.py), forward only: on CUDA it raises where grad mode
is on and an input requires grad.

Each query attends to every token of the ``prod(window)`` tiles of its
tile's window, the window center clamped so it never hangs off the grid
(``geometry.window_starts``, the clamping of ``geometry.sta_tile_mask``).
The keys of one q tile form a box of ``win*tile`` tokens per axis, read
straight from the raster (B, H, S, D) tensors: no relayout.  Softmax is
the TPU kernel's fast form: q pre-scaled by ``scale * log2(e)`` in q's
dtype, ``p = exp2(q.k)`` with no running max (for qk-RMSNormed models
``|s| <= scale*log2e*d*g^2`` stays far inside f32's exp2 range), P cast to
v's dtype before the PV product.  Heads whose ``active`` entry is 0 write
zeros.  The joint text tail (HunyuanVideo): with ``text_k`` / ``text_v``
(B, H, Lt, D) every query of an active head also attends to the Lt text
keys, ``text_bias`` (1, Lt) f32 added to their scores (zeros when it is
None; -1e30 masks a padded text token), as one more online-softmax step
after its window's keys.

The int8 QK mode (``qk_scale``): q, k and ``text_k`` arrive as int8 with an
(H,) f32 ``qk_scale`` = q_scale * k_scale, q not pre-scaled; the scores are
the int32 sums times ``qk_scale[h] * scale * log2(e)``, as in
ops/flash_manual.py, the output in v's dtype.  No served call site passes it
(the routed and joint STA experts stay bf16 under ``qk_int8``, as in the JAX
package); the JAX package's int8 probe tool does.

``softmax="stable"`` keeps a running max per row (q still pre-scaled, as
the JAX wrapper pre-scales it; the text tail follows the same rule), and
``variant`` selects the TPU kernel's diagnostic bodies (sta_pipe.py:270-302):
``dots`` (``p = bf16(s * 1e-3)``, no max, no l), ``qk`` (``acc += rowsum(s)
* 1e-3`` on every column, no PV) and ``sT`` (the fast softmax on the
transposed scores: the fast ``full`` output).  As in the JAX kernel, a
variant runs only where ``tile_w`` is a multiple of 8: elsewhere the TPU
kernel's masked-width branch runs the softmax whatever the variant; the text
tail is always the softmax step, and a stable tail after a variant rescales
the variant's sums by ``exp2(-1e30 - m) = 0``.

The TPU kernel has per-w-tile, grouped-width and masked-width variants;
they are VMEM layouts of one function, so the port has one kernel for
every tile width: it needs only tiles that divide the grid.
``supports_pipe`` is the TPU kernel's own eligibility test (its VMEM
budget), kept for the routed dispatch, which chooses by it as the JAX
package does.

On CUDA tensors ``sta_pipe_attention`` launches ``csrc/sta_pipe.cu``: the
Hopper path (``csrc/attn_sm90.cuh``'s mainloop over the window: wgmma, the
window's runs loaded by TMA into a ring of 128-key slots; counted as
``sta_pipe_wgmma`` too) where ``sta_wgmma_path`` says so (D = 128, bf16,
the fast softmax, the full variant, a window whose runs can land on 8-row
multiples of a slot: every served geometry, with or without the text
tail), with the slot table of ``window_walk``; else its mma.sync kernel
(the int8 QK mode, the stable softmax, the variants, D = 64).  f32 q / k /
v (and text) take the f32 mode, its own branch: the fast or stable softmax
of the full variant, q pre-scaled in f32, P kept in f32 (counted as
``sta_pipe_f32`` too), on one of two cores chosen by the rule
``sta_f32_tc_path``: at head dim 128 with q tiles of a multiple of 8 tokens
(every f32 call of the 1.3B / 13B paths) the tensor-core walk of
``csrc/window_walk_f32_tc.cuh`` (3xTF32 products on wgmma: a split pre-pass
gathers q, k and V^T into tile-major order, where a window is runs of
consecutive tiles, into scratch the wrapper allocates, and the walk pairs
the runs' 32-key pieces into 64-key chunks, ``window_f32_tc_walk``; counted
as ``sta_pipe_f32_tc`` too), else ``csrc/attn_f32.cuh``'s FFMA core over
the window box and the text tail (``csrc/window_walk_f32.cuh``);
``sta_pipe_attention_ffma`` runs the FFMA core at any shape (the yardstick
``chip_smoke.py`` times beside the tensor cores); int8 q / k / text_k with
``qk_scale`` and an f32 v / text_v take the same kernel's int8 mode (the
scores exact int32 sums by dp4a times the head's factor, q not pre-scaled;
counted as ``sta_pipe_f32`` and ``sta_pipe_int8``); the diagnostic variants
in f32 raise (ROADMAP section 2 A7).  On CPU tensors it runs the plain
version ``sta_pipe_attention_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..geometry import row_starts, w_window_starts, window_starts
from . import _build
from .flash import LOG2E, NEG_INF, f32_tc_work  # noqa: F401  (NEG_INF public, as in JAX)
from .flash_manual import _prescale, check_int8_qk, qk_factor, scores_log2
from .layout import tile_sequence, untile_sequence

Shape3 = Tuple[int, int, int]


def _q_mult(latent_shape: Shape3, tile: Shape3, window: Shape3) -> int:
    """2 when consecutive t-tile rows share their clamped t window start
    (the TPU kernel then runs both rows in one grid cell)."""
    t, hh, _ = latent_shape
    nt, nh = t // tile[0], hh // tile[1]
    if nt % 2:
        return 1
    starts = row_starts(latent_shape, tile, window).reshape(nt, nh, 2)
    for r in range(0, nt, 2):
        if not (starts[r] == starts[r + 1]).all():
            return 1
    return 2


def _w_groups(latent_shape: Shape3, tile: Shape3, window: Shape3):
    """(w_pad, n_groups, bw8, los) of the TPU kernel's grouped-width variant:
    8-token w groups, each reading the union of its tiles' windows."""
    w = latent_shape[2]
    tw = tile[2]
    nw = w // tw
    bw_tok = min(window[2], nw) * tw
    starts = w_window_starts(latent_shape, tile, window)
    w_pad = ((w + 7) // 8) * 8
    n_groups = w_pad // 8
    spans = []
    for gi in range(n_groups):
        t0, t1 = (gi * 8) // tw, min(nw - 1, (gi * 8 + 7) // tw)
        ws = starts[t0:t1 + 1]
        spans.append(((min(ws) // 8) * 8, -(-(max(ws) + bw_tok) // 8) * 8))
    bw8 = min(max(hi - lo for lo, hi in spans), w_pad)
    los = tuple(max(0, min(lo, w_pad - bw8)) for lo, _ in spans)
    return w_pad, n_groups, bw8, los


def supports_pipe(latent_shape: Shape3, tile: Shape3, d: int, itemsize: int = 2,
                  text_len: int = 0, window: Shape3 = (3, 3, 3)) -> bool:
    """The TPU kernel's eligibility test: tiles divide the grid and its
    double-buffered slabs and softmax states fit 40 MiB of VMEM.  The CUDA
    kernel has no such limit; the routed dispatch keeps the test so that it
    chooses as the JAX package does."""
    t, hh, w = latent_shape
    tt, th, tw = tile
    if t % tt or hh % th or w % tw:
        return False
    nw = w // tw
    tpt = tt * th * tw
    slab = tt * th * w * d * itemsize
    bw = min(window[2], nw) * tw
    common = 2 * 2 * slab + 2 * 2 * slab + 2 * 2 * text_len * d * itemsize
    if tw % 8 and 8 % tw == 0:  # grouped-width variant
        qm = _q_mult(latent_shape, tile, window)
        w_pad, n_groups, bw8, _ = _w_groups(latent_shape, tile, window)
        slab_p = tt * th * w_pad * d * itemsize
        rows_g = qm * tt * th * 8
        est = (2 * 2 * slab_p + 2 * 2 * slab_p + 2 * 2 * text_len * d * itemsize
               + n_groups * rows_g * (d + 2) * 4 + n_groups * 8 * tt * th * bw8 * 4
               + 2 * rows_g * tt * th * bw8 * 4)
    elif tw % 8:  # masked-width variant
        rows = _q_mult(latent_shape, tile, window) * tt * th * w
        kv_len = tt * th * w
        est = common + rows * (d + 2) * 4 + rows * kv_len * 4 + 2 * rows * kv_len * 4
    else:
        est = common + nw * tpt * (d + 2) * 4 + 3 * tpt * tt * th * bw * 4
    return est < 40 * 2**20


def _extent(latent_shape: Shape3, tile: Shape3, window: Shape3) -> Shape3:
    """(bt, bh, bw): the window box's tokens per axis."""
    return tuple(min(window[a], latent_shape[a] // tile[a]) * tile[a] for a in range(3))


@functools.lru_cache(maxsize=16)
def _window_keys(latent_shape: Shape3, tile: Shape3, window: Shape3) -> np.ndarray:
    """(n_tiles, n_keys) raster indices of each q tile's window box, in the
    order the kernel visits them (t, then h, then w)."""
    t, hh, w = latent_shape
    ext = _extent(latent_shape, tile, window)
    box = (np.arange(ext[0])[:, None, None] * hh * w + np.arange(ext[1])[None, :, None] * w
           + np.arange(ext[2])[None, None, :]).reshape(-1)
    st = window_starts(latent_shape, tile, window).astype(np.int64)
    base = (st[:, 0] * hh + st[:, 1]) * w + st[:, 2]
    return base[:, None] + box[None, :]


WALK_BN = 128  # keys per ring slot of the Hopper path (csrc/attn_sm90.cuh: BN)
WALK_BOXES = 16  # boxes a slot can hold (8 tokens at least each)
WALK_COLS = 4 + 2 * WALK_BOXES  # a slot's row of the walk table (csrc/sta_pipe.cu)
# slots whose table fits the shared memory left past the mainloop's ring:
# (232,448 - SRC_OFF 164,992 - 1,024 alignment slack) // (WALK_COLS * 4)
WALK_MAX_SLOTS = 461


@functools.lru_cache(maxsize=64)
def walk_box(latent_shape: Shape3, tile: Shape3, window: Shape3) -> Optional[Tuple[int, int]]:
    """(box_w, box_h) of the Hopper path's TMA box: box_h of the window's
    runs of box_w = bw contiguous tokens, or None where no box fits.  A box
    fits where box_h divides the window's bh runs per plane, and box_w *
    box_h is a multiple of 8 (each box lands on a multiple of 8 slot rows,
    the 1,024 B atom of the 128-byte swizzle that the wgmma descriptors
    assume) and at most ``WALK_BN``.  Of those, the box whose copies fill
    most of a slot, then the taller (fewer copies)."""
    _, bh, bw = _extent(latent_shape, tile, window)
    best = None
    for hb in range(1, bh + 1):
        tokens = hb * bw
        if bh % hb or tokens % 8 or tokens > WALK_BN:
            continue
        key = ((WALK_BN // tokens) * tokens, hb)
        if best is None or key > best:
            best = key
    return None if best is None else (bw, best[1])


def sta_wgmma_path(d: int, latent_shape: Shape3, tile: Shape3, window: Shape3 = (3, 3, 3), *,
                   dtype: torch.dtype = torch.bfloat16, softmax: str = "fast",
                   variant: str = "full", qk_int8: bool = False, text_len: int = 0) -> bool:
    """The rule of sta_pipe's Hopper path (``csrc/attn_sm90.cuh`` over the
    window): head dim 128, bf16, the fast softmax, the full variant, no
    int8 QK, a window whose runs ``walk_box`` can land, and a slot table
    (text_len's slots too; text_len a multiple of 8, ``_text_tail``'s rule)
    of at most ``WALK_MAX_SLOTS`` rows, which the kernel keeps in shared
    memory.  The same rule on both sides: the C entry refuses the Hopper
    path for anything else."""
    shape3, tile3, window3 = tuple(latent_shape), tuple(tile), tuple(window)
    return (d == 128 and dtype == torch.bfloat16 and softmax == "fast" and variant == "full"
            and not qk_int8 and walk_box(shape3, tile3, window3) is not None
            and window_walk(shape3, tile3, window3, text_len).shape[0] <= WALK_MAX_SLOTS)


@functools.lru_cache(maxsize=64)
def window_walk(latent_shape: Shape3, tile: Shape3, window: Shape3 = (3, 3, 3),
                text_len: int = 0, box: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """The Hopper path's slot table, the same for every CTA of a call:
    (n_slots, ``WALK_COLS``) int32, one row per 128-key ring slot in the
    order the kernel visits them, [nvalid, first text key (-1: a window
    slot), boxes, 0, (dt, dh) of each box from the window origin, zeros].
    Window slots first: the window's bt x bh runs, box_h runs a box of
    box_w x box_h tokens (``box``, by default ``walk_box``: box_w = bw, the
    run; sta_window's padded boxes read box_w > bw tokens a run) in (t, h)
    order, ``WALK_BN // (box_w * box_h)`` boxes a slot, box i of a slot on
    rows i * box_w * box_h.. (nvalid counts the padding), so the slots hold
    the window's keys in ``_window_keys``' order; then the text tail's keys,
    128 a slot (the last cut at text_len % 128).  Read-only: it is cached."""
    box = walk_box(latent_shape, tile, window) if box is None else box
    if box is None:
        raise ValueError(f"no window box of tile {tile}, window {window} on {latent_shape} "
                         "lands on 8-row multiples of a slot")
    bw, hb = box
    bt, bh, _ = _extent(latent_shape, tile, window)
    boxes = [(dt, dh) for dt in range(bt) for dh in range(0, bh, hb)]
    per = WALK_BN // (bw * hb)
    rows = []
    for i in range(0, len(boxes), per):
        part = boxes[i:i + per]
        rows.append([len(part) * bw * hb, -1, len(part), 0] + [c for b in part for c in b])
    rows += [[min(WALK_BN, text_len - k0), k0, 0, 0] for k0 in range(0, text_len, WALK_BN)]
    out = np.zeros((len(rows), WALK_COLS), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=32)
def _walk_on(latent_shape: Shape3, tile: Shape3, window: Shape3, text_len: int,
             device: torch.device, box: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    walk = window_walk(latent_shape, tile, window, text_len, box)
    return torch.from_numpy(walk.copy()).to(device)


def _text_tail(text_k, text_v, text_bias, q: torch.Tensor):
    """Checks the joint text tail; returns (text_k, text_v, (Lt,) f32 bias) or Nones."""
    if text_k is None and text_v is None and text_bias is None:
        return None, None, None
    if text_k is None or text_v is None:
        raise ValueError("the text tail needs both text_k and text_v")
    b, h, _, d = q.shape
    lt = text_k.shape[2]
    if text_k.shape != (b, h, lt, d) or text_v.shape != text_k.shape:
        raise ValueError(f"text_k {tuple(text_k.shape)}, text_v {tuple(text_v.shape)} for "
                         f"q {tuple(q.shape)}")
    if lt % 8:
        raise ValueError(f"text_len {lt} must be a multiple of 8")
    if text_bias is None:
        text_bias = torch.zeros((1, lt), dtype=torch.float32, device=q.device)
    if text_bias.numel() != lt:
        raise ValueError(f"text_bias {tuple(text_bias.shape)} for {lt} text keys")
    return text_k, text_v, text_bias.reshape(lt).float()


def sta_f32_tc_path(d: int, latent_shape: Shape3, tile: Shape3, *,
                    dtype: torch.dtype = torch.float32, qk_int8: bool = False,
                    variant: str = "full", text_len: int = 0) -> bool:
    """The rule of the f32 mode's tensor-core walk (``csrc/window_walk_f32_tc.cuh``,
    3xTF32 on wgmma), sta_pipe's and sta_window's: head dim 128, f32 q / k
    / v, not the int8 QK mode, the full variant, tiles that divide the grid
    with a multiple of 8 tokens (so that every window run, a row of
    consecutive tiles in tile-major order, starts on V^T's permuted groups
    of 8 keys) and a text tail of a multiple of 8 keys or none: every f32
    call of the 1.3B / 13B paths ((4, 6, 4), (4, 9, 10), (5, 9, 8), (6, 9,
    8) tiles).  D 64 (the tiny models) and the int8 QK mode with an f32 v
    stay on the FFMA core.  The C entries refuse the tensor cores for
    anything else: an error, never a fallback."""
    tt, th, tw = tile
    return (d == 128 and dtype == torch.float32 and not qk_int8 and variant == "full"
            and not any(latent_shape[a] % tile[a] for a in range(3))
            and (tt * th * tw) % 8 == 0 and text_len % 8 == 0)


F32_TC_PIECE = 32  # keys of a piece of the tensor-core walk: two pieces a chunk


@functools.lru_cache(maxsize=16)
def window_f32_tc_walk(latent_shape: Shape3, tile: Shape3, window: Shape3 = (3, 3, 3),
                       text_len: int = 0) -> tuple:
    """Python mirror of the tensor-core walk (``csrc/window_walk_f32_tc.cuh:
    PieceWalk``): per q tile, in tile-major order (``tile_sequence``'s), its
    64-key chunks as ((first key, keys kept), (first key, keys kept)) pairs
    of 32-key pieces in the tile-major key space, where the (b, h)'s S window
    keys come first and its text keys after them (key S + n is text key n).
    The pieces cut the window's min(win_t, nt) x min(win_h, nh) runs of
    min(win_w, nw) consecutive tiles (in (t, h) order), then the text keys,
    32 keys at a time, the last of each run or of the text cut short; a
    chunk pairs two consecutive pieces, joining one run's end to the next
    run's start, and a lone last piece pairs with itself at 0 keys kept.
    Read-only: it is cached."""
    t, hh, w = latent_shape
    nt, nh, nw = (latent_shape[a] // tile[a] for a in range(3))
    tpt = tile[0] * tile[1] * tile[2]
    s = t * hh * w
    wt, wh, ww = (min(window[a], latent_shape[a] // tile[a]) for a in range(3))
    starts = window_starts(latent_shape, tile, window) // np.asarray(tile)
    out = []
    for t0, h0, w0 in starts.tolist():
        runs = [((((t0 + dt) * nh + h0 + dh) * nw + w0) * tpt, ww * tpt)
                for dt in range(wt) for dh in range(wh)]
        runs.append((s, text_len))
        pieces = [(k0 + off, min(F32_TC_PIECE, n - off)) for k0, n in runs
                  for off in range(0, n, F32_TC_PIECE)]
        if len(pieces) % 2:
            pieces.append((pieces[-1][0], 0))
        out.append(tuple(zip(pieces[0::2], pieces[1::2])))
    return tuple(out)


SOFTMAXES = ("fast", "stable")
VARIANTS = ("full", "dots", "qk", "sT")
NEG = -1e30
MODES = ("fast", "stable", "dots", "qk", "sT")  # the kernel's mode numbers


def _modes(softmax: str, variant: str, tile: Shape3) -> str:
    """The window's mode: the variant where tile_w is a multiple of 8 (the
    TPU kernel's per-w-tile branch), else the softmax (its masked-width and
    grouped-width branches run only the softmax)."""
    if softmax not in SOFTMAXES:
        raise ValueError(f"softmax {softmax!r} not in {SOFTMAXES}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    return variant if variant != "full" and tile[2] % 8 == 0 else softmax


def sta_pipe_attention_ref(q, k, v, active, *, latent_shape: Shape3, tile: Shape3,
                           window: Shape3 = (3, 3, 3), scale: Optional[float] = None,
                           text_k=None, text_v=None, text_bias=None, qk_scale=None,
                           softmax: str = "fast", variant: str = "full"):
    """Plain PyTorch version of the kernel, a few q tiles at a time."""
    mode = _modes(softmax, variant, tile)
    text_k, text_v, text_bias = _text_tail(text_k, text_v, text_bias, q)
    b, h, s, d = q.shape
    scale = d**-0.5 if scale is None else scale
    qkc = None if qk_scale is None else qk_factor(qk_scale, scale, h).to(q.device)
    keys = torch.from_numpy(_window_keys(latent_shape, tile, window)).to(q.device)
    n_tiles, nk = keys.shape
    tpt = s // n_tiles
    tq = tile_sequence(q, latent_shape, tile).reshape(b, h, n_tiles, tpt, d)
    out = torch.empty((b, h, n_tiles, tpt, d), dtype=v.dtype, device=q.device)
    cast = v.dtype != torch.float32
    chunk = max(1, 2**28 // (b * h * tpt * nk))
    for c0 in range(0, n_tiles, chunk):
        idx = keys[c0:c0 + chunk]
        vc = v[:, :, idx].float()  # (B, H, c, nk, D)
        qc = tq[:, :, c0:c0 + chunk]
        sc = scores_log2(qc, k[:, :, idx], scale, qkc)
        m = torch.full(sc.shape[:-1] + (1,), NEG, device=q.device)  # a variant keeps no max
        l = torch.zeros_like(m)
        if mode == "qk":
            o = (sc.sum(dim=-1, keepdim=True) * 1e-3).expand(-1, -1, -1, -1, d)
        else:
            if mode == "dots":
                p = sc * 1e-3
            else:
                if mode == "stable":
                    m = sc.amax(dim=-1, keepdim=True)
                p = torch.exp2(sc - m) if mode == "stable" else torch.exp2(sc)
                l = p.sum(dim=-1, keepdim=True)
            if cast:
                p = p.to(v.dtype).float()
            o = torch.einsum("bhcqk,bhckd->bhcqd", p, vc)
        if text_k is not None:
            tk = text_k[:, :, None].expand(-1, -1, qc.shape[2], -1, -1)
            st = scores_log2(qc, tk, scale, qkc) + text_bias
            if softmax == "stable":  # one more online step after the window's keys
                m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                pt = torch.exp2(st - m_new)
                l, o = l * alpha, o * alpha
            else:
                pt = torch.exp2(st)
            l = l + pt.sum(dim=-1, keepdim=True)
            if cast:
                pt = pt.to(v.dtype).float()
            o = o + torch.einsum("bhcqk,bhkd->bhcqd", pt, text_v.float())
        out[:, :, c0:c0 + chunk] = (o / torch.where(l == 0.0, 1.0, l)).to(v.dtype)
    out = untile_sequence(out.reshape(b, h, s, d), latent_shape, tile)
    a = torch.as_tensor(active, device=q.device).reshape(1, h, 1, 1) > 0
    return torch.where(a, out, torch.zeros((), dtype=out.dtype, device=out.device))


def _sta_fn():
    fn = _build.load("sta_pipe").vorta_sta_fwd_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 15 + [p] + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


F32_TOOLS = "ROADMAP section 2 A7 (the tools' kernels in f32)"


def _sta_f32_fn():
    fn = _build.load("sta_pipe").vorta_sta_fwd_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 14 + [p, p]
        fn.restype = ctypes.c_int
    return fn


def sta_pipe_attention(
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
    softmax: str = "fast",
    variant: str = "full",
    qk_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sliding-tile attention, with the joint text tail where ``text_k`` and
    ``text_v`` are given; on CUDA bf16 q/k/v (and text) with D 64 or 128,
    q / k / text_k int8 with ``qk_scale`` (fast full only) and a bf16 or
    f32 v / text_v, or f32 q/k/v (and text; the full variant)."""
    return _sta_pipe(q, k, v, active, latent_shape=latent_shape, tile=tile, window=window,
                     scale=scale, text_k=text_k, text_v=text_v, text_bias=text_bias,
                     cast_p_to_v_dtype=cast_p_to_v_dtype, softmax=softmax, variant=variant,
                     qk_scale=qk_scale, hopper_ok=True)


def sta_pipe_attention_mma_sync(q, k, v, active, **kw) -> torch.Tensor:
    """``sta_pipe_attention`` on the mma.sync kernel whatever the rule says:
    the card's yardstick beside the Hopper path at the same call
    (``chip_smoke.py`` times both), counted in ``sta_pipe`` only."""
    return _sta_pipe(q, k, v, active, hopper_ok=False, **kw)


def sta_pipe_attention_ffma(q, k, v, active, **kw) -> torch.Tensor:
    """``sta_pipe_attention`` at f32 on the FFMA core whatever
    ``sta_f32_tc_path`` says: the card's yardstick beside the tensor-core
    walk at the same call (``chip_smoke.py`` times both), counted in
    ``sta_pipe`` / ``sta_pipe_f32`` only."""
    return _sta_pipe(q, k, v, active, tc_ok=False, **kw)


def _sta_pipe(q, k, v, active, *, latent_shape: Shape3, tile: Shape3,
              window: Shape3 = (3, 3, 3), scale: Optional[float] = None, text_k=None,
              text_v=None, text_bias=None, cast_p_to_v_dtype: bool = True,
              softmax: str = "fast", variant: str = "full", qk_scale=None,
              hopper_ok: bool = True, tc_ok: bool = True) -> torch.Tensor:
    if qk_scale is not None:
        if variant != "full":
            raise ValueError("qk_scale requires softmax='fast', variant='full'")
        check_int8_qk(q, k, softmax)
        if text_k is not None and text_k.dtype != torch.int8:
            raise ValueError(f"qk_scale requires int8 text_k, got {text_k.dtype}")
    mode = _modes(softmax, variant, tile)
    if not cast_p_to_v_dtype:
        raise NotImplementedError("cast_p_to_v_dtype=False (P kept in f32) is ROADMAP section 1 "
                                  "item 11: P is always cast to v's dtype here")
    b, h, s, d = q.shape
    t, hh, w = latent_shape
    if s != t * hh * w:
        raise ValueError(f"seq len {s} != prod(latent_shape) {latent_shape}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if any(latent_shape[a] % tile[a] for a in range(3)):
        raise ValueError(f"tile {tile} does not divide the latent grid {latent_shape}")
    scale = d**-0.5 if scale is None else scale
    text_k, text_v, text_bias = _text_tail(text_k, text_v, text_bias, q)
    if q.device.type == "cpu":
        return sta_pipe_attention_ref(q, k, v, active, latent_shape=latent_shape, tile=tile,
                                      window=window, scale=scale, text_k=text_k,
                                      text_v=text_v, text_bias=text_bias, qk_scale=qk_scale,
                                      softmax=softmax, variant=variant)

    _build.forward_only("sta_pipe_attention", q, k, v, text_k, text_v)
    dev = _build.require_cuda(q, k, v, text_k, text_v, text_bias)
    if v.dtype == torch.float32:
        return _sta_pipe_f32(q, k, v, active, dev, mode=mode, latent_shape=latent_shape,
                             tile=tile, window=window, scale=scale, text=(text_k, text_v,
                                                                          text_bias),
                             qk_scale=qk_scale, tc_ok=tc_ok)
    qk_dtype = torch.bfloat16 if qk_scale is None else torch.int8
    if (any(x is not None and x.dtype != qk_dtype for x in (q, k, text_k))
            or any(x is not None and x.dtype != torch.bfloat16 for x in (v, text_v))):
        raise NotImplementedError(f"the CUDA sta_pipe kernel takes bf16 (q / k / text_k int8 "
                                  f"with qk_scale) or f32 q / k / v and text, got "
                                  f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in (64, 128):
        raise NotImplementedError(f"the CUDA sta_pipe kernel takes D 64/128, got {d}")
    active = torch.as_tensor(active, device=dev).to(torch.int32).contiguous()
    if active.shape != (h,):
        raise ValueError(f"active {tuple(active.shape)} for {h} heads")
    qkc = None if qk_scale is None else qk_factor(qk_scale, scale, h).contiguous()
    _build.require_cuda(q, qkc)
    shape3, tile3, window3 = tuple(latent_shape), tuple(tile), tuple(window)
    lt = 0 if text_k is None else text_k.shape[2]
    hopper = hopper_ok and sta_wgmma_path(d, shape3, tile3, window3, dtype=q.dtype,
                                          softmax=softmax, variant=variant,
                                          qk_int8=qkc is not None, text_len=lt)
    walk = _walk_on(shape3, tile3, window3, lt, dev) if hopper else None
    box_w, box_h = walk_box(shape3, tile3, window3) if hopper else (0, 0)
    qs = (_prescale(q, scale) if qkc is None else q).contiguous()
    k, v = (_build.aligned16(x.contiguous()) for x in (k, v))
    text = [None if x is None else _build.aligned16(x.contiguous())
            for x in (text_k, text_v, text_bias)]
    out = torch.empty(q.shape, dtype=v.dtype, device=dev)
    err = _sta_fn()(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), active.data_ptr(),
        *(_build.ptr(x) for x in text), _build.ptr(qkc), lt, b, h, t, hh, w, d, *tile, *window,
        MODES.index(mode), int(softmax == "stable"), _build.ptr(walk),
        0 if walk is None else walk.shape[0], box_w, box_h, int(hopper), _build.stream_ptr(dev))
    _build.check(err, "sta_pipe")
    _build.launches["sta_pipe"] += 1
    if hopper:
        _build.launches["sta_pipe_wgmma"] += 1
    if qkc is not None:
        _build.launches["sta_pipe_int8"] += 1
    if softmax == "stable":
        _build.launches["sta_pipe_stable"] += 1
    if mode not in SOFTMAXES:  # a diagnostic variant ran
        _build.launches[f"sta_pipe_{mode}"] += 1
    return out


def _sta_pipe_f32(q, k, v, active, dev, *, mode: str, latent_shape: Shape3, tile: Shape3,
                  window: Shape3, scale: float, text, qk_scale, tc_ok: bool) -> torch.Tensor:
    """The f32 mode on CUDA: f32 q / k / v and text, the full variant's fast
    or stable softmax, on the tensor-core walk where ``sta_f32_tc_path``
    holds (and ``tc_ok``), else on ``csrc/attn_f32.cuh``'s FFMA core."""
    text_k, text_v, text_bias = text
    if mode not in SOFTMAXES:
        raise NotImplementedError(f"sta_pipe's diagnostic variant {mode!r} in f32 is {F32_TOOLS}")
    qk_dtype = torch.float32 if qk_scale is None else torch.int8
    if (any(x is not None and x.dtype != qk_dtype for x in (q, k, text_k))
            or (text_v is not None and text_v.dtype != torch.float32)):
        raise NotImplementedError(f"the CUDA sta_pipe f32 mode takes f32 q / k / v and text, or "
                                  f"int8 q / k / text_k with qk_scale and an f32 v / text_v, got "
                                  f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, h, _, d = q.shape
    if d not in (64, 128):
        raise NotImplementedError(f"the CUDA sta_pipe f32 mode takes D 64/128, got {d}")
    active = torch.as_tensor(active, device=dev).to(torch.int32).contiguous()
    if active.shape != (h,):
        raise ValueError(f"active {tuple(active.shape)} for {h} heads")
    t, hh, w = latent_shape
    lt = 0 if text_k is None else text_k.shape[2]
    qkc = None if qk_scale is None else qk_factor(qk_scale, scale, h).contiguous()
    _build.require_cuda(q, qkc)
    tc = tc_ok and sta_f32_tc_path(d, latent_shape, tile, qk_int8=qkc is not None,
                                   text_len=lt)
    qs = q if qkc is not None else _prescale(q, scale)
    qs, k, v = (_build.aligned16(x.contiguous()) for x in (qs, k, v))
    text = [None if x is None else _build.aligned16(x.contiguous())
            for x in (text_k, text_v, text_bias)]
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    work = f32_tc_work(b, h, t * hh * w, t * hh * w + lt, dev) if tc else None
    err = _sta_f32_fn()(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), active.data_ptr(),
        *(_build.ptr(x) for x in text), _build.ptr(qkc), lt, b, h, t, hh, w, d, *tile, *window,
        int(mode == "stable"), _build.ptr(work), _build.stream_ptr(dev))
    _build.check(err, "sta_pipe (f32)")
    _build.launches["sta_pipe"] += 1
    _build.launches["sta_pipe_f32"] += 1
    _build.launches["sta_pipe_f32_tc"] += tc
    if qkc is not None:
        _build.launches["sta_pipe_int8"] += 1
    if mode == "stable":
        _build.launches["sta_pipe_stable"] += 1
    return out
