"""Bottleneck bisection of the window-dense STA kernel at Wan 720p
(counterpart of tools/sta_diag.py).

Variants (the JAX tool's names), each a launch of ``csrc/sta_diag.cu``:

  full         the real kernel loop: both products, the stable online
               softmax in two chains (even / odd chunks), the copies
  full_unroll  the same, the chunk loop unrolled at compile time
  dots_only    both products per chunk, the softmax replaced by a scalar scale
  dma_only     the copies and their waits only, no compute (output 0)
  no_dma       the compute of ``full`` with the copies issued and their waits
               skipped (an undefined output: timed, never compared)

Comparing these splits the kernel's time into its matrix products, its
softmax and its data movement.  A chunk is one (dt, dh) tile row of a q
tile's window box (tt x th x bw keys), as in the JAX tool.  The output is
the JAX kernel's: ``(acc_0 + acc_1) / (l_0 + l_1)``, its two chains summed
without a common max.

On the card the variants run on the served window kernels' Hopper mainloop
(``csrc/attn_sm90.cuh`` over ``csrc/sta_window_src.cuh``'s window source:
TMA boxes into a ring of 128-key slots, wgmma, a producer warp and two
consumer warpgroups), so that they bisect the kernels users run:
``dma_only`` times their producer and ring, ``dots_only`` their products.
``diag_wgmma_path`` is the rule (head dim 128, bf16, a box of a chunk's runs
that lands on 8-row multiples of a slot, a table that fits shared memory
beside the stash: the tool's default geometry and every Wan / HunyuanVideo
tile), counted as ``sta_diag_wgmma`` too; the walk is ``diag_walk``,
chunk-aligned and chain-major, and chain 0's finished output waits in
shared memory as bf16 while chain 1 runs (the kernel's header).  Elsewhere
(D = 64, no box) the first design runs: mma.sync over 64-key sub-tiles
through a cp.async ring, which ``sta_diag_attention_mma_sync`` runs at any
shape, the yardstick beside the Hopper path.

``run`` takes the JAX tool's arguments and defaults (latent (20, 45, 80),
tile (5, 9, 8), window (3, 3, 3), 12 heads x 128) and returns seconds per
call: ``iters`` calls after a warm-up of as many, q perturbed per call
(q * (1 + 0.001 i)) and each output reduced to its mean, as the JAX tool's
scan does.  On the card, bf16 and CUDA events; with ``--device cpu`` the
plain version in f32 on the host's clock, a check that the tool runs (use a
small ``--latent``), not a measurement of the card.

  python -m vorta_tpu_torch.tools.sta_diag [variants...]
  python -m vorta_tpu_torch.tools.sta_diag --device cpu --latent 4 6 16 --tile 2 3 8
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _build
from ..ops.flash import LOG2E
from ..ops.layout import tile_sequence, untile_sequence
from ..ops.sta_pipe import WALK_BN, WALK_COLS, _extent, _window_keys

Shape3 = Tuple[int, int, int]
VARIANTS = ("full", "full_unroll", "dots_only", "dma_only", "no_dma")
DEFAULT_VARIANTS = ("full", "full_unroll", "dots_only", "dma_only")  # the JAX tool's default
MAX_UNROLLED_CHUNKS = 9  # the kernel's compile-time bound of full_unroll
# the Hopper path's stash of chain 0's output: 2 consumer warpgroups x 128
# threads x 64 values as bf16 (csrc/sta_diag.cu: STASH_BYTES)
DIAG_STASH_BYTES = 32768
# walk rows that fit the shared memory left past the mainloop's ring and the
# stash: (232,448 - SRC_OFF 164,992 - 1,024 alignment slack - the stash) //
# (WALK_COLS * 4)
DIAG_MAX_SLOTS = 233


def _geometry(latent_shape: Shape3, tile: Shape3, window: Shape3):
    """(win_eff, n_chunks, chunk keys) of the window box."""
    if any(latent_shape[a] % tile[a] for a in range(3)):
        raise ValueError(f"tile {tile} does not divide the latent grid {latent_shape}")
    win = tuple(min(window[a], latent_shape[a] // tile[a]) for a in range(3))
    return win, win[0] * win[1], tile[0] * tile[1] * win[2] * tile[2]


def sta_diag_ref(q, k, v, *, latent_shape: Shape3, tile: Shape3, window: Shape3 = (3, 3, 3),
                 variant: str = "full", scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, a few q tiles at a time.  ``no_dma``
    computes what ``full`` does (its kernel output is undefined)."""
    b, h, s, d = q.shape
    scale = d**-0.5 if scale is None else scale
    win, n_chunks, ck = _geometry(latent_shape, tile, window)
    if variant == "dma_only":
        return torch.zeros(q.shape, dtype=v.dtype, device=q.device)
    keys = torch.from_numpy(_window_keys(latent_shape, tile, window)).to(q.device)
    n_tiles = keys.shape[0]
    tt, th, tw = tile
    # box order (t, h, w) -> chunk-major: chunk j = dt * win_h + dh
    keys = (keys.reshape(n_tiles, win[0], tt, win[1], th, win[2] * tw)
            .permute(0, 1, 3, 2, 4, 5).reshape(n_tiles, n_chunks, ck))
    tpt = s // n_tiles
    tq = tile_sequence(q, latent_shape, tile).reshape(b, h, n_tiles, tpt, d).float()
    out = torch.empty((b, h, n_tiles, tpt, d), dtype=v.dtype, device=q.device)
    cast = v.dtype != torch.float32
    step = max(1, 2**28 // (b * h * tpt * n_chunks * ck))
    for c0 in range(0, n_tiles, step):
        idx = keys[c0:c0 + step]  # (c, n_chunks, ck)
        qc = tq[:, :, c0:c0 + step]
        s_ = torch.einsum("bhcqd,bhcjkd->bhcqjk", qc, k[:, :, idx].float()) * (scale * LOG2E)
        vc = v[:, :, idx].float()  # (B, H, c, n_chunks, ck, D)
        if variant == "dots_only":
            p = s_ * 1e-3
            if cast:
                p = p.to(v.dtype).float()
            o = torch.einsum("bhcqjk,bhcjkd->bhcqd", p, vc)
        else:  # full, full_unroll, no_dma: two chains, summed without a common max
            o = torch.zeros(qc.shape, device=q.device)
            l = torch.zeros(qc.shape[:-1] + (1,), device=q.device)
            for chain in (0, 1):
                sc = s_[:, :, :, :, chain::2]
                if sc.shape[4] == 0:
                    continue
                m = sc.amax(dim=(-2, -1), keepdim=True)
                p = torch.exp2(sc - m)
                l = l + p.sum(dim=(-2, -1))[..., None]
                if cast:
                    p = p.to(v.dtype).float()
                o = o + torch.einsum("bhcqjk,bhcjkd->bhcqd", p, vc[:, :, :, chain::2])
            o = o / torch.where(l == 0.0, 1.0, l)
        out[:, :, c0:c0 + step] = o.to(v.dtype)
    return untile_sequence(out.reshape(b, h, s, d), latent_shape, tile)


@functools.lru_cache(maxsize=64)
def diag_box(latent_shape: Shape3, tile: Shape3, window: Shape3) -> Optional[Tuple[int, int]]:
    """(box_w, box_h) of the Hopper path's TMA box: box_h of a chunk's runs
    of box_w = bw tokens (the window's w extent), or None where none fits.
    A box fits where box_h divides the tile's th (so that no box leaves its
    chunk), and box_w * box_h is a multiple of 8 (each box lands on a
    multiple of 8 slot rows) and at most ``WALK_BN``.  Of those, the box
    whose copies fill most of a slot, then the taller."""
    _, _, bw = _extent(latent_shape, tile, window)
    th = tile[1]
    best = None
    for hb in range(1, th + 1):
        tokens = hb * bw
        if th % hb or tokens % 8 or tokens > WALK_BN:
            continue
        key = ((WALK_BN // tokens) * tokens, hb)
        if best is None or key > best:
            best = key
    return None if best is None else (bw, best[1])


@functools.lru_cache(maxsize=64)
def diag_walk(latent_shape: Shape3, tile: Shape3, window: Shape3 = (3, 3, 3)) -> np.ndarray:
    """The Hopper path's slot table, the same for every CTA of a call:
    (n_slots, ``WALK_COLS``) int32 in ``ops/sta_pipe.py:window_walk``'s
    layout, [nvalid, -1, boxes, chain, (dt, dh) of each box from the window
    origin, zeros].  Every slot holds runs of one chunk only (chunk j = dt *
    win_h + dh: tt x th runs of bw tokens, in (t, h) order, box_h runs a
    ``diag_box``), ``WALK_BN // (box_w * box_h)`` boxes a slot, the chunk's
    last slot partly filled where the count does not divide; chain-major:
    the even chunks (chain 0) in order, then the odd ones (chain 1), the
    chain in the fourth column.  Read-only: it is cached."""
    box = diag_box(latent_shape, tile, window)
    if box is None:
        raise ValueError(f"no box of a chunk's runs of tile {tile}, window {window} on "
                         f"{latent_shape} lands on 8-row multiples of a slot")
    bw, hb = box
    win, n_chunks, _ = _geometry(latent_shape, tile, window)
    tt, th, _ = tile
    per = WALK_BN // (bw * hb)
    rows = []
    for j in [*range(0, n_chunks, 2), *range(1, n_chunks, 2)]:
        ct, ch = divmod(j, win[1])
        boxes = [(ct * tt + i, ch * th + r) for i in range(tt) for r in range(0, th, hb)]
        for b0 in range(0, len(boxes), per):
            part = boxes[b0:b0 + per]
            rows.append([len(part) * bw * hb, -1, len(part), j % 2]
                        + [c for bx in part for c in bx])
    out = np.zeros((len(rows), WALK_COLS), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    out.flags.writeable = False
    return out


def diag_wgmma_path(d: int, latent_shape: Shape3, tile: Shape3, window: Shape3 = (3, 3, 3), *,
                    dtype: torch.dtype = torch.bfloat16) -> bool:
    """The rule of the Hopper path: head dim 128, bf16, a ``diag_box``, and
    a ``diag_walk`` of at most ``DIAG_MAX_SLOTS`` rows, which the kernel
    keeps in shared memory beside the stash.  The same rule on both sides:
    the C entry refuses the Hopper path for anything else."""
    shape3, tile3, window3 = tuple(latent_shape), tuple(tile), tuple(window)
    return (d == 128 and dtype == torch.bfloat16 and diag_box(shape3, tile3, window3) is not None
            and diag_walk(shape3, tile3, window3).shape[0] <= DIAG_MAX_SLOTS)


@functools.lru_cache(maxsize=16)
def _walk_on(latent_shape: Shape3, tile: Shape3, window: Shape3,
             device: torch.device) -> torch.Tensor:
    return torch.from_numpy(diag_walk(latent_shape, tile, window).copy()).to(device)


def _diag_fn():
    fn = _build.load("sta_diag").vorta_sta_diag_fwd_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [ctypes.c_float] + [i] * 13 + [p] + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


def sta_diag_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       latent_shape: Shape3, tile: Shape3, window: Shape3 = (3, 3, 3),
                       variant: str = "full", scale: Optional[float] = None) -> torch.Tensor:
    """One bisection variant on raster (B, H, S, D) q / k / v (q not
    pre-scaled); on CUDA bf16, D 64 or 128: the Hopper path where
    ``diag_wgmma_path`` holds, else the mma.sync kernel."""
    return _sta_diag(q, k, v, latent_shape=latent_shape, tile=tile, window=window,
                     variant=variant, scale=scale, hopper_ok=True)


def sta_diag_attention_mma_sync(q, k, v, **kw) -> torch.Tensor:
    """``sta_diag_attention`` on the mma.sync kernel whatever the rule says:
    the card's yardstick beside the Hopper path at the same call
    (``chip_smoke.py`` times both), counted in ``sta_diag`` only."""
    return _sta_diag(q, k, v, hopper_ok=False, **kw)


def _sta_diag(q, k, v, *, latent_shape: Shape3, tile: Shape3, window: Shape3 = (3, 3, 3),
              variant: str = "full", scale: Optional[float] = None,
              hopper_ok: bool = True) -> torch.Tensor:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    b, h, s, d = q.shape
    t, hh, w = latent_shape
    if s != t * hh * w:
        raise ValueError(f"seq len {s} != prod(latent_shape) {latent_shape}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    _, n_chunks, _ = _geometry(latent_shape, tile, window)
    scale = d**-0.5 if scale is None else scale
    if q.device.type == "cpu":
        return sta_diag_ref(q, k, v, latent_shape=latent_shape, tile=tile, window=window,
                            variant=variant, scale=scale)

    _build.forward_only("sta_diag_attention", q, k, v)
    dev = _build.require_cuda(q, k, v)
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)) or d not in (64, 128):
        raise NotImplementedError(f"the CUDA sta_diag kernel takes bf16 (f32: ROADMAP section 2 "
                                  f"A7, the tools' kernels in f32) and D 64/128, got "
                                  f"{q.dtype}, D={d}")
    if variant == "full_unroll" and n_chunks > MAX_UNROLLED_CHUNKS:
        raise NotImplementedError(f"full_unroll unrolls at most {MAX_UNROLLED_CHUNKS} chunks, "
                                  f"the window has {n_chunks}")
    shape3, tile3, window3 = tuple(latent_shape), tuple(tile), tuple(window)
    hopper = hopper_ok and diag_wgmma_path(d, shape3, tile3, window3, dtype=q.dtype)
    walk = _walk_on(shape3, tile3, window3, dev) if hopper else None
    box_w, box_h = diag_box(shape3, tile3, window3) if hopper else (0, 0)
    q, k, v = (_build.aligned16(x.contiguous()) for x in (q, k, v))
    out = torch.empty_like(q)
    err = _diag_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     float(scale * LOG2E), VARIANTS.index(variant), b, h, t, hh, w, d, *tile,
                     *window, _build.ptr(walk), 0 if walk is None else walk.shape[0], box_w,
                     box_h, int(hopper), _build.stream_ptr(dev))
    _build.check(err, "sta_diag")
    _build.launches["sta_diag"] += 1
    if hopper:
        _build.launches["sta_diag_wgmma"] += 1
    return out


def run(variant: str, latent: Shape3 = (20, 45, 80), tile: Shape3 = (5, 9, 8),
        window: Shape3 = (3, 3, 3), h: int = 12, d: int = 128, iters: int = 4,
        device=None) -> float:
    """Seconds per call of one variant (see the module docstring)."""
    dev = resolve_device(device)
    s = latent[0] * latent[1] * latent[2]
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    q, k, v = (torch.randn((1, h, s, d), generator=torch.Generator(device=dev).manual_seed(i),
                           device=dev).to(dtype) for i in range(3))

    def timed():
        acc = torch.zeros((), device=dev)
        for i in range(iters):
            qi = q * torch.tensor(1 + 0.001 * i, dtype=dtype, device=dev)
            out = sta_diag_attention(qi, k, v, latent_shape=latent, tile=tile, window=window,
                                     variant=variant)
            acc = acc + out.float().mean()
        return acc

    with torch.inference_mode():
        float(timed())  # warm-up
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            acc = timed()
            end.record()
            float(acc)
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        float(timed())
        return (time.perf_counter() - t0) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)}; default: "
                    f"{' '.join(DEFAULT_VARIANTS)}")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--latent", type=int, nargs=3, default=(20, 45, 80))
    ap.add_argument("--tile", type=int, nargs=3, default=(5, 9, 8))
    ap.add_argument("--window", type=int, nargs=3, default=(3, 3, 3))
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--head_dim", type=int, default=128)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    times = {}
    for variant in args.variants or DEFAULT_VARIANTS:
        try:
            sec = run(variant, tuple(args.latent), tuple(args.tile), tuple(args.window),
                      args.heads, args.head_dim, args.iters, dev)
            times[variant] = sec * 1e3
            print(f"{variant:10s} {sec * 1e3:8.2f} ms", flush=True)
        except Exception as e:  # the JAX tool's report: one line per variant
            print(f"{variant:10s} FAIL {str(e)[:100]}", flush=True)
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
