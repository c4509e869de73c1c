"""Block-sparse flash attention backward: dq and dk/dv (counterpart of
vorta_tpu/ops/flash_bwd.py).

The standard flash backward over the forward's static, head-shared block
tables:

  forward   saves out and the base-2 row log-sum-exp lse2 = m + log2(l) in
            the scale * log2(e) domain (ops/flash.py, ``return_lse``)
  backward  delta = rowsum(dout * out), f32, plain PyTorch as in JAX
            dq  : over each q block's kv list (the forward's tables)
                  p = 2^(s2 - lse2); ds = p (dp - delta); dq += ds k
            dkv : over each kv block's q list (``transpose_tables``)
                  dv += p^T dout;  dk += ds^T q

with ``ds`` rounded to the inputs' dtype before ``ds k`` and ``ds^T q``,
``p`` before ``p^T dout``, and ``scale`` applied to dq and dk at the end.
Masked logits are -1e30 under the forward's tail rule, so padded kv rows
get zero dk and dv; an empty row's lse sentinel 1e30 gives p = 0.

On CUDA tensors ``flash_backward`` launches the two kernels of
``csrc/flash_bwd.cu`` (bf16 or f32, D 64 or 128, blocks multiples of 8); on
CPU tensors it runs ``flash_backward_ref``, which repeats their arithmetic.
f32 inputs (the f32 training path, ``cli.train --dtype fp32``) take the f32
mode, its own branch with ds and p kept in f32 as the plain version keeps
them there, counted as ``flash_dq_f32`` / ``flash_dkv_f32`` too: where
flash's rule ``ops/flash.py:flash_f32_tc_path`` holds, the forward's (head
dim 128, blocks multiples of 8: every f32 backward call of the 1.3B trainer, FULL, LOWRES, cross-attention and the
96-, 360- and 24-token STA tiles) the tensor-core kernels of
``csrc/attn_f32_tc_bwd.cuh`` (3xTF32 on wgmma, after a split pre-pass into
scratch the wrapper allocates, ``f32_tc_bwd_work``; counted as
``flash_dq_f32_tc`` / ``flash_dkv_f32_tc`` too), at D 64 (the tiny models)
the FFMA kernels of ``csrc/attn_f32_bwd.cuh``; ``flash_backward_ffma`` runs
the FFMA kernels at any shape, the card's yardstick.  The Hopper rule below
is bf16's only.
Which bf16 design runs on CUDA is a pure-Python shape rule, ``bwd_wgmma_path``
(the forward's): head dim 128 with blocks that 128 divides (the trainer's
FULL, LOWRES and cross-attention) take the Hopper kernels (wgmma, TMA,
warp specialisation; counted as ``flash_dq_wgmma`` / ``flash_dkv_wgmma``
too), D = 64 and the 96-, 360- and 24-token STA tiles the mma.sync
kernels.  Neither falls back to the other; ``flash_backward_mma_sync``
runs the mma.sync kernels at any shape, the card's yardstick.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build
from .flash import (F32_TC_ROWS, WGMMA_TILE, _tail, f32_tc_fwd_walk, flash_f32_tc_path,
                    wgmma_path)

NEG_INF = float(-1e30)
POS_BIG = float(1e30)  # the lse of a row that sees no key (ops/flash.py)
LOG2E = 1.4426950408889634


def transpose_tables(kv_index: np.ndarray, kv_count: np.ndarray,
                     n_kv_blocks: int) -> Tuple[np.ndarray, np.ndarray]:
    """(1, nq, W) kv tables -> (1, nkv, WT) q tables: which q blocks visit
    each kv block, in increasing order."""
    if kv_index.shape[0] != 1:
        raise ValueError("the backward takes head-shared tables")
    nq = kv_index.shape[1]
    lists = [[] for _ in range(n_kv_blocks)]
    for i in range(nq):
        for j in range(int(kv_count[0, i])):
            lists[int(kv_index[0, i, j])].append(i)
    wt = max(1, max(len(lst) for lst in lists))
    q_index = np.zeros((1, n_kv_blocks, wt), np.int32)
    q_count = np.zeros((1, n_kv_blocks), np.int32)
    for j, lst in enumerate(lists):
        q_count[0, j] = len(lst)
        q_index[0, j, :len(lst)] = lst
    return q_index, q_count


def visible_blocks(kv_index, kv_count, n_kv_blocks: int) -> torch.Tensor:
    """(nq, nkv) bool: the kv blocks each q block's head-shared list visits."""
    kv_index = torch.as_tensor(kv_index).long().cpu()
    kv_count = torch.as_tensor(kv_count).long().cpu()
    active = torch.arange(kv_index.shape[2]) < kv_count[..., None]
    return (torch.nn.functional.one_hot(kv_index, n_kv_blocks).bool()
            & active[..., None]).any(dim=2)[0]


def flash_backward_ref(q, k, v, out, lse2, dout, kv_index, kv_count, *, scale: float,
                       block_q: int, block_kv: int, kv_valid_len: int,
                       need_dq: bool = True, need_dkv: bool = True):
    """Plain PyTorch version of both kernels, one q block at a time against
    every kv column, the invisible ones masked as the forward masks them."""
    from .flash import _kv_column_limit

    b, h, sq, d = q.shape
    skv = k.shape[2]
    nkv = skv // block_kv
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    block_mask = visible_blocks(kv_index, kv_count, nkv).to(q.device)  # (nq, nkv)
    col_ok = _kv_column_limit(skv, block_kv, kv_valid_len, q.device)
    kf, vf = k.float(), v.float()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for i in range(sq // block_q):
        if not block_mask[i].any():
            continue  # a q block with no kv block contributes nothing
        rows = slice(i * block_q, (i + 1) * block_q)
        qi, doi = q[:, :, rows].float(), dout[:, :, rows].float()
        vis = block_mask[i].repeat_interleave(block_kv) & col_ok  # (Skv,)
        s2 = torch.einsum("bhqd,bhkd->bhqk", qi, kf) * (scale * LOG2E)
        s2 = torch.where(vis, s2, NEG_INF)
        p = torch.exp2(s2 - lse2[:, :, rows])
        dp = torch.einsum("bhqd,bhkd->bhqk", doi, vf)
        ds = (p * (dp - delta[:, :, rows])).to(q.dtype).float()
        if need_dq:
            dq[:, :, rows] = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
        if need_dkv:
            dv += torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(), doi)
            dk += torch.einsum("bhqk,bhqd->bhkd", ds, qi)
    return ((dq * scale).to(q.dtype) if need_dq else None,
            (dk * scale).to(k.dtype) if need_dkv else None,
            dv.to(v.dtype) if need_dkv else None)


def bwd_wgmma_path(d: int, block_q: int, block_kv: int) -> bool:
    """The shape rule of the backward's Hopper kernels: head dim 128, q
    blocks that the dq kernel's 128-row CTAs tile and kv blocks that its
    128-key ring slots (and the dk/dv kernel's 128-row CTAs) tile.  The
    dk/dv kernel walks q tiles of 64 rows and would take blocks of 64 q
    rows; the rule is one for both kernels, and the same shapes as the bf16
    forward's (``ops/flash.py:wgmma_path``).  The C entry refuses the Hopper
    path for anything else."""
    return wgmma_path(d, block_q, block_kv)


def f32_tc_bwd_work(b: int, h: int, sq: int, skv: int, device) -> torch.Tensor:
    """The tensor-core backward's scratch for one call: the big and small
    TF32 halves of q, dout, q^T and dout^T (``sq`` rows each) and of k, v
    and k^T (``skv`` each), f32 at head dim 128, which its split pre-pass
    writes once for both kernels and their TMA copies read.  It takes
    nothing from the forward but out and lse, whichever design ran it."""
    return torch.empty(2 * b * h * (4 * sq + 3 * skv) * 128, dtype=torch.float32, device=device)


DKV_Q_TILE = 64  # q rows per ring slot of the dk/dv kernel


def dq_walk(kv_index: np.ndarray, kv_count: np.ndarray, *, sq: int, block_q: int,
            block_kv: int, kv_valid_len: int) -> list:
    """Python mirror of ``flash_dq_sm90_kernel``'s walk: for each 128-row
    CTA, its ring slots as (first key, valid keys), the 128-key sub-tiles of
    its q block's kv blocks up to the tail rule's limit (``TileWalk``: a
    sub-tile the rule masks completely is skipped, a cut one masks its
    columns past the valid keys).  An empty list: the CTA writes zero dq."""
    last, in_last = _tail(block_kv, kv_valid_len)
    walks = []
    for row0 in range(0, sq, WGMMA_TILE):
        qi = row0 // block_q
        slots = []
        for kvb in kv_index[0, qi, :kv_count[0, qi]]:
            limit = in_last if kvb == last else block_kv
            slots += [(int(kvb) * block_kv + n0, min(WGMMA_TILE, limit - n0))
                      for n0 in range(0, limit, WGMMA_TILE)]
        walks.append(slots)
    return walks


def dkv_walk(q_index: np.ndarray, q_count: np.ndarray, *, skv: int, block_q: int,
             block_kv: int, kv_valid_len: int) -> list:
    """Python mirror of ``flash_dkv_sm90_kernel``'s walk: for each 128-row kv
    CTA, (its rows the tail rule leaves visible, the first q row of each
    64-row q tile of its ring, in the order the transposed tables list the q
    blocks), or None where the CTA writes zero dk and dv before touching a
    barrier (no q block visits its kv block, or every row lies past the
    tail)."""
    last, in_last = _tail(block_kv, kv_valid_len)
    walks = []
    for row0 in range(0, skv, WGMMA_TILE):
        kvb, local0 = divmod(row0, block_kv)
        limit = in_last if kvb == last else block_kv
        count = int(q_count[0, kvb])
        if count == 0 or local0 >= limit:
            walks.append(None)
            continue
        tiles = [int(qb) * block_q + m0 for qb in q_index[0, kvb, :count]
                 for m0 in range(0, block_q, DKV_Q_TILE)]
        walks.append((min(WGMMA_TILE, limit - local0), tiles))
    return walks


F32_TC_CHUNK = 32  # a walked chunk's rows (F32_TC_ROWS: a tensor-core CTA's resident rows)


def f32_tc_dq_walk(kv_index: np.ndarray, kv_count: np.ndarray, *, sq: int, block_q: int,
                   block_kv: int, kv_valid_len: int) -> list:
    """Python mirror of ``flash_dq_f32_tc_kernel``'s walk: the forward's
    (``ops/flash.py:f32_tc_fwd_walk``) with 32-key chunks (``ChunkWalk<32>``):
    per CTA, in grid order, (its first q row, the rows of its q block that
    it owns and stores, its chunks as (first key, keys not masked)).  No
    chunks: the CTA writes zero dq."""
    return f32_tc_fwd_walk(kv_index, kv_count, sq=sq, block_q=block_q, block_kv=block_kv,
                           kv_valid_len=kv_valid_len, chunk=F32_TC_CHUNK)


def f32_tc_dkv_walk(q_index: np.ndarray, q_count: np.ndarray, *, skv: int, block_q: int,
                    block_kv: int, kv_valid_len: int) -> list:
    """Python mirror of ``flash_dkv_f32_tc_kernel``'s walk: per CTA, in grid
    order, (its first kv row, the rows of its kv block that it owns and
    stores, how many of them the tail rule leaves visible (the rest get p =
    0: zero dk and dv), its chunks as (first q row, q rows of their block)).
    A kv block takes ceil(block_kv / 64) CTAs; the last one's rows past its
    block are masked and never stored.  Its chunks are 32 q rows of each q
    block that visits its kv block, in the transposed tables' order, the
    block's last chunk partial (its columns past the block masked).  Chunks
    None: the CTA writes zero dk and dv before touching a barrier (no q
    block visits, or every row lies past the tail)."""
    last, in_last = _tail(block_kv, kv_valid_len)
    walks = []
    for kvb in range(skv // block_kv):
        limit = in_last if kvb == last else block_kv
        count = int(q_count[0, kvb])
        for local0 in range(0, block_kv, F32_TC_ROWS):
            rows = min(F32_TC_ROWS, block_kv - local0)
            if count == 0 or local0 >= limit:
                walks.append((kvb * block_kv + local0, rows, 0, None))
                continue
            chunks = [(int(qb) * block_q + m0, min(F32_TC_CHUNK, block_q - m0))
                      for qb in q_index[0, kvb, :count] for m0 in range(0, block_q, F32_TC_CHUNK)]
            walks.append((kvb * block_kv + local0, rows, min(rows, limit - local0), chunks))
    return walks


def _fn(name: str, n_ptr: int, n_int: int):
    """A C entry of ``csrc/flash_bwd.cu``: n_ptr pointers, n_int ints, the
    scale, then the hopper flag (bf16 entries) or the tensor-core scratch
    pointer (f32 entries), then the stream."""
    fn = getattr(_build.load("flash_bwd"), name)
    if fn.argtypes is None:
        tail = ctypes.c_void_p if name.endswith("_f32") else ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, tail, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _split_fn():
    fn = _build.load("flash_bwd").vorta_flash_bwd_f32_tc_split
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_backward(q, k, v, out, lse2, dout, kv_index, kv_count, q_index, q_count, *,
                   scale: float, block_q: int, block_kv: int, kv_valid_len: int,
                   need_dq: bool = True, need_dkv: bool = True):
    """(dq, dk, dv) of the block-sparse attention, each None where not asked.

    q, out, dout: (B, H, Sq, D); k, v: (B, H, Skv, D); lse2: (B, H, Sq, 1)
    f32 from the forward.  kv_index / kv_count: the forward's (1, nq, W) /
    (1, nq) tables; q_index / q_count: ``transpose_tables`` of them (read
    only by the dk/dv kernel).  ``need_dq`` / ``need_dkv`` skip a kernel
    whose gradients no input needs.
    """
    return _flash_backward(q, k, v, out, lse2, dout, kv_index, kv_count, q_index, q_count,
                           scale=scale, block_q=block_q, block_kv=block_kv,
                           kv_valid_len=kv_valid_len, need_dq=need_dq, need_dkv=need_dkv,
                           hopper_ok=True)


def flash_backward_mma_sync(q, k, v, out, lse2, dout, kv_index, kv_count, q_index, q_count,
                            **kw):
    """``flash_backward`` on the mma.sync kernels whatever the rule says: the
    card's yardstick beside the Hopper kernels at the same call
    (``chip_smoke.py`` times both), counted in ``flash_dq`` / ``flash_dkv``
    only."""
    return _flash_backward(q, k, v, out, lse2, dout, kv_index, kv_count, q_index, q_count,
                           hopper_ok=False, **kw)


def flash_backward_ffma(q, k, v, out, lse2, dout, kv_index, kv_count, q_index, q_count, **kw):
    """``flash_backward`` at f32 on the FFMA kernels whatever
    ``flash_f32_tc_path`` says: the card's yardstick beside the tensor-core
    kernels at the same call (``chip_smoke.py`` times both), counted in
    ``flash_dq`` / ``flash_dkv`` and their ``_f32`` counters only."""
    return _flash_backward(q, k, v, out, lse2, dout, kv_index, kv_count, q_index, q_count,
                           tc_ok=False, **kw)


def _flash_backward(q, k, v, out, lse2, dout, kv_index, kv_count, q_index, q_count, *,
                    scale: float, block_q: int, block_kv: int, kv_valid_len: int,
                    need_dq: bool = True, need_dkv: bool = True, hopper_ok: bool = True,
                    tc_ok: bool = True):
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape or out.shape != q.shape \
            or dout.shape != q.shape or lse2.shape != (b, h, sq, 1):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"out {tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse2.shape)}")
    if sq % block_q or skv % block_kv:
        raise ValueError(f"seq lens ({sq},{skv}) not divisible by blocks ({block_q},{block_kv})")
    if kv_index.shape[0] != 1 or kv_index.shape[1] != sq // block_q \
            or q_index.shape[0] != 1 or q_index.shape[1] != skv // block_kv:
        raise ValueError(f"head-shared tables {tuple(kv_index.shape)}, transposed "
                         f"{tuple(q_index.shape)} for {sq // block_q} q / "
                         f"{skv // block_kv} kv blocks")
    if q.device.type == "cpu":
        return flash_backward_ref(q, k, v, out, lse2, dout, kv_index, kv_count, scale=scale,
                                  block_q=block_q, block_kv=block_kv,
                                  kv_valid_len=kv_valid_len, need_dq=need_dq,
                                  need_dkv=need_dkv)

    dev = _build.require_cuda(q, k, v, out, lse2, dout)
    dtypes = {t.dtype for t in (q, k, v, out, dout)}
    if dtypes not in ({torch.bfloat16}, {torch.float32}):
        raise NotImplementedError(f"the CUDA flash backward takes bf16 or f32 q / k / v / out / "
                                  f"dout of one dtype, got {sorted(map(str, dtypes))}")
    if d not in (64, 128) or block_q % 8 or block_kv % 8:
        raise NotImplementedError(f"the CUDA flash backward takes D 64/128 and blocks that are "
                                  f"multiples of 8, got D={d}, blocks ({block_q}, {block_kv})")
    f32 = q.dtype == torch.float32  # the f32 mode: its own kernels, no Hopper rule
    hopper = hopper_ok and not f32 and bwd_wgmma_path(d, block_q, block_kv)
    tc = f32 and tc_ok and flash_f32_tc_path(d, block_q, block_kv)
    mode = "f32" if f32 else "bf16"
    # TMA and the bulk copies of the Hopper path and of the tensor-core
    # kernels, and the FFMA kernels' 16-byte loads, read from 16-byte boundaries
    q, k, v, dout = (_build.aligned16(t.contiguous()) for t in (q, k, v, dout))
    lse2 = _build.aligned16(lse2.float().contiguous())
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    common = (b, h, sq, skv, d)
    work = None
    if tc:  # one split pre-pass serves both kernels
        work = f32_tc_bwd_work(b, h, sq, skv, dev)
        _build.check(_split_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                 work.data_ptr(), *common, block_q, block_kv, int(kv_valid_len),
                                 int(need_dq), int(need_dkv), _build.stream_ptr(dev)),
                     "flash backward f32 split")
    flags = (_build.ptr(work),) if f32 else (int(hopper),)
    dq = dk = dv = None
    if need_dq:
        kv_index = torch.as_tensor(kv_index, dtype=torch.int32, device=dev).contiguous()
        kv_count = torch.as_tensor(kv_count, dtype=torch.int32, device=dev).contiguous()
        dq = torch.empty_like(q)
        err = _fn(f"vorta_flash_bwd_dq_{mode}", 9, 9)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), kv_index.data_ptr(), kv_count.data_ptr(),
            *common, kv_index.shape[2], block_q, block_kv, int(kv_valid_len), float(scale),
            *flags, _build.stream_ptr(dev))
        _build.check(err, f"flash_dq ({mode})")
        _build.launches["flash_dq"] += 1
        _build.launches["flash_dq_f32"] += f32
        _build.launches["flash_dq_f32_tc"] += tc
        _build.launches["flash_dq_wgmma"] += hopper
    if need_dkv:
        q_index = torch.as_tensor(q_index, dtype=torch.int32, device=dev).contiguous()
        q_count = torch.as_tensor(q_count, dtype=torch.int32, device=dev).contiguous()
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = _fn(f"vorta_flash_bwd_dkv_{mode}", 10, 9)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse2.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), q_index.data_ptr(),
            q_count.data_ptr(), *common, q_index.shape[2], block_q, block_kv,
            int(kv_valid_len), float(scale), *flags, _build.stream_ptr(dev))
        _build.check(err, f"flash_dkv ({mode})")
        _build.launches["flash_dkv"] += 1
        _build.launches["flash_dkv_f32"] += f32
        _build.launches["flash_dkv_f32_tc"] += tc
        _build.launches["flash_dkv_wgmma"] += hopper
    return dq, dk, dv
