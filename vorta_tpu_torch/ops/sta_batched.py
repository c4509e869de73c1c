"""Tile-major block-sparse sliding-tile attention with sub-tile pair bits
(counterpart of vorta_tpu/ops/sta_batched.py), forward only: on CUDA it
raises where grad mode is on and an input requires grad.

q, k and v are in the tile-major layout (ops/layout.py), padded to the
blocks.  q block ``i`` visits the kv blocks ``kv_index[0, i, :kv_count[0,
i]]``; the tables are shared by all heads.  Inside a visited block, query
row ``r`` sees key column ``c`` where bit ``(r // tpt) * k_sub + c // tpt``
of that entry's ``pair_bits`` word is set (``tpt`` = ``tokens_per_tile``,
``k_sub = block_kv // tpt``): the words are uint32 stored as int32, read
with logical shifts, and a bit index of 32 or more sees nothing.
``kv_bias`` ((1, Skv) f32, shared by every batch row and head) is added to
the scores.  The routed STA expert's geometries that the JAX package gives
neither of its window-dense kernels, and the joint STA expert's small tiles
or text lengths not a multiple of 8, run here (ops/routed_fused.py,
ops/joint_experts.py).

Softmax ``"fast"`` is the TPU kernel's fast form, the one its callers pass:
q pre-scaled by ``scale * log2(e)`` in q's dtype, ``p = exp2(q.k + bias)``
with no running max and no ``log2(e)`` on the bias, a masked entry exactly
0, P cast to v's dtype before the PV product, ``l == 0`` rows (a q block
with count 0, a row that sees nothing) giving 0.  ``"stable"`` (the
default, the JAX wrapper's): q not pre-scaled, the f32 scores scaled by
``scale * log2(e)``, the bias added, hidden pairs -1e30, and a running max
per row with the TPU kernel's ``m_safe``.  Heads whose ``active``
entry is 0 write zeros: the TPU wrapper's callers pack the routed heads
first so that whole head groups skip; the port launches over all heads with
the mask, and each head's output is the same.

On CUDA tensors ``sta_flash_headbatched`` launches ``csrc/sta_batched.cu``
(bf16, D 64 or 128, blocks any multiple of 8): the Hopper path
(``csrc/attn_sm90.cuh``'s mainloop with the fast softmax and the kv_bias
slot over the pair-bit tables: wgmma, TMA; counted as ``sta_batched_wgmma``
too) where ``batched_wgmma_path`` says so (the fast softmax, D = 128, tiles
of at least 128 tokens: every served geometry), else its mma.sync kernel
(the stable softmax, D = 64, smaller tiles such as hunyuan-tiny's).  f32
q / k / v take the f32 mode, its own branch: ``csrc/attn_f32.cuh``'s FFMA
core over the same tables with the pair bits, either softmax, kv_bias and
blocks down to 8 rows, P kept in f32 (counted as ``sta_batched_f32``
too).  On CPU tensors it runs the plain version
``sta_flash_headbatched_ref``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _build
from .flash import LOG2E, NEG_INF, BlockTables  # noqa: F401  (NEG_INF public, as in JAX)
from .flash_manual import _bias_row, _prescale

NEG = -1e30
WGMMA_TILE = 128  # q rows per CTA and keys per ring slot of the Hopper path
# the slot list a CTA of the Hopper path keeps in shared memory, 8 bytes a
# slot (csrc/sta_batched.cu: LIST_MAX = (232,448 - LIST_OFF 165,008 - 1,024
# alignment slack) // 8)
LIST_MAX_SLOTS = 8302


@dataclasses.dataclass(frozen=True, eq=False)
class PairBitTables(BlockTables):
    """Head-shared tables of this kernel: ``kv_index`` (1, nq, W),
    ``kv_count`` (1, nq) and ``pair_bits`` (1, nq, W), int32 views of the
    uint32 words."""

    pair_bits: np.ndarray

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "pair_bits", np.ascontiguousarray(self.pair_bits, np.int32))

    def on(self, device: torch.device):
        """(kv_index, kv_count, pair_bits) as int32 tensors on ``device``,
        copied once."""
        kv_index, kv_count = super().on(device)
        key = f"bits {device}"
        if key not in self._on_device:
            self._on_device[key] = torch.tensor(self.pair_bits, device=device)
        return kv_index, kv_count, self._on_device[key]


def pair_bit_tables(vis: np.ndarray, m_sub: int, k_sub: int,
                    all_ones_from: Optional[int] = None) -> PairBitTables:
    """Tables from a sub-tile visibility matrix ``vis`` ((nq * m_sub, nkv *
    k_sub) bool: q sub-tile sees kv sub-tile): per q block, the kv blocks
    with a visible pair in ascending order (padded by repeating the last),
    their count, and their words (bit mi * k_sub + ki).  kv blocks from
    ``all_ones_from`` on are visited by every q block with all 32 bits set
    (the joint layout's text blocks, which the bias masks instead)."""
    nq, nkv = vis.shape[0] // m_sub, vis.shape[1] // k_sub
    shift = (np.arange(m_sub)[:, None] * k_sub + np.arange(k_sub)[None, :]).astype(np.uint64)
    v4 = vis.reshape(nq, m_sub, nkv, k_sub).transpose(0, 2, 1, 3).astype(np.uint64)
    words = (v4 << shift).sum(axis=(2, 3))  # (nq, nkv): distinct bits, so the sum is the OR
    if all_ones_from is not None:
        words[:, all_ones_from:] = 0xFFFFFFFF
    seen = words != 0
    cnt = seen.sum(axis=1)
    width = max(1, int(cnt.max()))
    idx = np.zeros((1, nq, width), np.int32)
    bits = np.zeros((1, nq, width), np.int32)
    for qi in range(nq):
        cols = np.flatnonzero(seen[qi])
        if cols.size:
            idx[0, qi, :cols.size] = cols
            idx[0, qi, cols.size:] = cols[-1]
            bits[0, qi, :cols.size] = words[qi, cols].astype(np.uint32).view(np.int32)
    return PairBitTables(idx, cnt[None], bits)


def _subtile(pair_bits, tokens_per_tile, block_q: int, block_kv: int):
    """(tpt, m_sub, k_sub) of the pair bits, or None without them."""
    if pair_bits is None:
        return None
    if not tokens_per_tile:
        raise ValueError("pair_bits need tokens_per_tile")
    m_sub, k_sub = block_q // tokens_per_tile, block_kv // tokens_per_tile
    if m_sub * k_sub > 32:
        raise ValueError(f"subtile pairs {m_sub}x{k_sub} exceed 32 bits")
    return tokens_per_tile, m_sub, k_sub


def _check(q, k, v, kv_index, kv_count, active, pair_bits, block_q: int, block_kv: int):
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if sq % block_q or skv % block_kv:
        raise ValueError(f"seq lens ({sq},{skv}) not divisible by blocks ({block_q},{block_kv})")
    nq = sq // block_q
    if tuple(kv_index.shape[:2]) != (1, nq) or tuple(kv_count.shape) != (1, nq):
        raise ValueError(f"tables {tuple(kv_index.shape)}, counts {tuple(kv_count.shape)} for "
                         f"{nq} q blocks (head-shared)")
    if pair_bits is not None and tuple(pair_bits.shape) != tuple(kv_index.shape):
        raise ValueError(f"pair_bits {tuple(pair_bits.shape)} for tables "
                         f"{tuple(kv_index.shape)}")
    if torch.as_tensor(active).numel() != h:
        raise ValueError(f"active {tuple(torch.as_tensor(active).shape)} for {h} heads")


def _check_options(softmax: str, cast_p_to_v_dtype: bool) -> None:
    if softmax not in ("fast", "stable"):
        raise ValueError(f"softmax {softmax!r} not in ('fast', 'stable')")
    if not cast_p_to_v_dtype:
        raise NotImplementedError("cast_p_to_v_dtype=False (P kept in f32) is ROADMAP section 1 "
                                  "item 11: P is always cast to v's dtype here")


def sta_flash_headbatched_ref(q, k, v, kv_index, kv_count, active, *, pair_bits=None,
                              tokens_per_tile: Optional[int] = None, kv_bias=None,
                              scale: Optional[float] = None, block_q: int = 384,
                              block_kv: int = 384, cast_p_to_v_dtype: bool = True,
                              softmax: str = "stable") -> torch.Tensor:
    """Plain PyTorch version of the kernel, one q block at a time over the
    kv blocks it visits."""
    _check_options(softmax, cast_p_to_v_dtype)
    dev = q.device
    kv_index, kv_count = (torch.as_tensor(x, device=dev).long() for x in (kv_index, kv_count))
    if pair_bits is not None:
        pair_bits = torch.as_tensor(pair_bits, device=dev)
    _check(q, k, v, kv_index, kv_count, active, pair_bits, block_q, block_kv)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    scale = d**-0.5 if scale is None else scale
    sub = _subtile(pair_bits, tokens_per_tile, block_q, block_kv)
    stable = softmax == "stable"
    qs = q.float() if stable else _prescale(q, scale).float()
    kb = k.float().reshape(b, h, skv // block_kv, block_kv, d)
    vb = v.float().reshape(b, h, skv // block_kv, block_kv, d)
    bias = None if kv_bias is None else _bias_row(kv_bias, skv).to(dev).reshape(-1, block_kv)
    if sub is not None:
        tpt, _, k_sub = sub
        shift = ((torch.arange(block_q, device=dev) // tpt * k_sub)[:, None, None]
                 + (torch.arange(block_kv, device=dev) // tpt)[None, None, :])  # (bq, 1, bkv)
        words = pair_bits.reshape(pair_bits.shape[1:]).long() & 0xFFFFFFFF  # uint32 values
    out = torch.zeros(q.shape, dtype=v.dtype, device=dev)
    for i in range(sq // block_q):
        c = int(kv_count[0, i])
        if c == 0:
            continue
        blocks = kv_index[0, i, :c]
        rows = slice(i * block_q, (i + 1) * block_q)
        s = torch.einsum("bhqd,bhkd->bhqk", qs[:, :, rows],
                         kb[:, :, blocks].reshape(b, h, c * block_kv, d))
        if stable:  # q not pre-scaled: the f32 scores are scaled
            s = s * (scale * LOG2E)
        if bias is not None:
            s = s + bias[blocks].reshape(-1)
        if sub is not None:
            w = words[i, :c][None, :, None]  # (1, c, 1)
            vis = torch.where(shift < 32, (w >> shift.clamp(max=31)) & 1, 0).bool()
            s = torch.where(vis.reshape(block_q, c * block_kv), s, NEG)
        if stable:
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp2(s - torch.where(m <= NEG, 0.0, m))
        else:
            p = torch.exp2(s)
        l = p.sum(dim=-1, keepdim=True)
        if v.dtype != torch.float32:
            p = p.to(v.dtype).float()
        o = torch.einsum("bhqk,bhkd->bhqd", p, vb[:, :, blocks].reshape(b, h, c * block_kv, d))
        out[:, :, rows] = (o / torch.where(l == 0.0, 1.0, l)).to(v.dtype)
    a = torch.as_tensor(active, device=dev).reshape(1, h, 1, 1) > 0
    return torch.where(a, out, torch.zeros((), dtype=out.dtype, device=dev))


def batched_wgmma_path(d: int, block_q: int, block_kv: int, tokens_per_tile: Optional[int],
                       width: int, *, pair_bits: bool = True,
                       dtype: torch.dtype = torch.bfloat16, softmax: str = "fast") -> bool:
    """The rule of sta_batched's Hopper path (``csrc/attn_sm90.cuh`` over the
    pair-bit tables): the fast softmax, bf16, head dim 128, pair bits over
    tiles of at least 128 tokens and a multiple of 8 (so that a 128-row CTA
    and a 128-key slot each cross at most one tile boundary, the key split
    on a multiple of 8) or no pair bits, at most 32 slots of 128 keys per kv
    block, and a slot list of ``width`` kv blocks within ``LIST_MAX_SLOTS``.
    The same rule on both sides: the C entry refuses the Hopper path for
    anything else."""
    spb = -(-block_kv // WGMMA_TILE)
    return (softmax == "fast" and dtype == torch.bfloat16 and d == 128
            and (not pair_bits or (tokens_per_tile >= WGMMA_TILE and tokens_per_tile % 8 == 0))
            and spb <= 32 and width * spb <= LIST_MAX_SLOTS)


LIVE_BIAS = -1e20  # a bias at or below it masks its key exactly (csrc/sta_batched.cu)


def pair_bit_walk(kv_index, kv_count, pair_bits, kv_bias, *, block_q: int, block_kv: int,
                  tokens_per_tile: Optional[int]) -> list:
    """The Hopper path's slot lists, as its CTAs build them before their
    rings start (``PairBitSource::prepare``): one list per CTA of a head
    (q block ``i``'s CTAs ``i * cpb ..``, ``cpb = ceil(block_q / 128)``),
    each a list of (first key, nvalid, key split, vis4, full): the 128-key
    slots of the visited kv blocks in order, those with no pair bit linking
    the CTA's rows to their keys, or whose keys the bias leaves none of
    (bias <= ``LIVE_BIAS``), left out.  nvalid counts the slot's keys inside
    its block; columns below the split are in the slot's first key tile;
    bit 2 * b + c of vis4 says whether the CTA's row tile b (0: its first,
    1: its last) sees key tile c; full: every pair of the slot visible.
    Tables as numpy (1, nq, W) / (1, nq); kv_bias (Skv,) or None."""
    kv_index = np.asarray(kv_index).reshape(np.asarray(kv_index).shape[-2:])
    kv_count = np.asarray(kv_count).reshape(-1)
    words = None if pair_bits is None else (
        np.asarray(pair_bits).reshape(kv_index.shape).astype(np.int64) & 0xFFFFFFFF)
    tpt = tokens_per_tile if words is not None else 1 << 30
    k_sub = block_kv // tpt if words is not None else 1
    cpb, spb = -(-block_q // WGMMA_TILE), -(-block_kv // WGMMA_TILE)
    bias = None if kv_bias is None else np.asarray(kv_bias, np.float32).reshape(-1)

    def bit(word, rt, kt):
        idx = rt * k_sub + kt
        return bool(idx < 32 and (int(word) >> idx) & 1)

    lists = []
    for qi in range(kv_count.shape[0]):
        for chunk in range(cpb):
            r0 = chunk * WGMMA_TILE
            rows = min(WGMMA_TILE, block_q - r0)
            ra, rb = r0 // tpt, (r0 + rows - 1) // tpt
            slots = []
            for j in range(int(kv_count[qi])):
                kvb = int(kv_index[qi, j])
                for si in range(spb):
                    n0 = si * WGMMA_TILE
                    nvalid = min(WGMMA_TILE, block_kv - n0)
                    kt0 = n0 // tpt
                    split = min((kt0 + 1) * tpt - n0, nvalid)
                    vis4, full = 0xF, nvalid == WGMMA_TILE
                    if words is not None:
                        w, two = words[qi, j], split < nvalid
                        a0, b0 = bit(w, ra, kt0), bit(w, rb, kt0)
                        a1, b1 = two and bit(w, ra, kt0 + 1), two and bit(w, rb, kt0 + 1)
                        vis4 = a0 | a1 << 1 | b0 << 2 | b1 << 3
                        full = full and a0 and b0 and (not two or (a1 and b1))
                    key0 = kvb * block_kv + n0
                    if vis4 and (bias is None or (bias[key0:key0 + nvalid] > LIVE_BIAS).any()):
                        slots.append((key0, nvalid, split, vis4, full))
            lists.append(slots)
    return lists


def _sta_batched_fn():
    fn = _build.load("sta_batched").vorta_sta_batched_fwd_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 12 + [ctypes.c_float, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _sta_batched_f32_fn():
    fn = _build.load("sta_batched").vorta_sta_batched_fwd_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 12 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def sta_flash_headbatched(
    q: torch.Tensor,  # (B, H, Sq, D) tile-major
    k: torch.Tensor,
    v: torch.Tensor,
    kv_index,  # (1, nq, W) int32
    kv_count,  # (1, nq) int32
    active,  # (H,) int: heads routed to this expert
    *,
    pair_bits=None,  # (1, nq, W) int32 views of uint32 words
    tokens_per_tile: Optional[int] = None,
    kv_bias: Optional[torch.Tensor] = None,  # (1, Skv) f32
    scale: Optional[float] = None,
    block_q: int = 384,
    block_kv: int = 384,
    cast_p_to_v_dtype: bool = True,
    softmax: str = "stable",
) -> torch.Tensor:
    """Block-sparse STA over head-shared tables with sub-tile pair bits; on
    CUDA bf16 or f32 q/k/v (one dtype), D 64 or 128, blocks multiples of 8."""
    return _sta_batched(q, k, v, kv_index, kv_count, active, pair_bits=pair_bits,
                        tokens_per_tile=tokens_per_tile, kv_bias=kv_bias, scale=scale,
                        block_q=block_q, block_kv=block_kv,
                        cast_p_to_v_dtype=cast_p_to_v_dtype, softmax=softmax, hopper_ok=True)


def sta_flash_headbatched_mma_sync(q, k, v, kv_index, kv_count, active, **kw) -> torch.Tensor:
    """``sta_flash_headbatched`` on the mma.sync kernel whatever the rule
    says: the card's yardstick beside the Hopper path at the same call
    (``chip_smoke.py`` times both), counted in ``sta_batched`` only."""
    return _sta_batched(q, k, v, kv_index, kv_count, active, hopper_ok=False, **kw)


def _sta_batched(q, k, v, kv_index, kv_count, active, *, pair_bits=None,
                 tokens_per_tile: Optional[int] = None, kv_bias=None,
                 scale: Optional[float] = None, block_q: int = 384, block_kv: int = 384,
                 cast_p_to_v_dtype: bool = True, softmax: str = "stable",
                 hopper_ok: bool = True) -> torch.Tensor:
    _check_options(softmax, cast_p_to_v_dtype)
    if q.device.type == "cpu":
        return sta_flash_headbatched_ref(
            q, k, v, kv_index, kv_count, active, pair_bits=pair_bits,
            tokens_per_tile=tokens_per_tile, kv_bias=kv_bias, scale=scale, block_q=block_q,
            block_kv=block_kv, softmax=softmax)

    _build.forward_only("sta_flash_headbatched", q, k, v)
    dev = _build.require_cuda(q, k, v)
    kv_index, kv_count, active = (torch.as_tensor(x, device=dev).to(torch.int32).contiguous()
                                  for x in (kv_index, kv_count, active))
    if pair_bits is not None:
        pair_bits = torch.as_tensor(pair_bits, device=dev).to(torch.int32).contiguous()
    _check(q, k, v, kv_index, kv_count, active, pair_bits, block_q, block_kv)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    sub = _subtile(pair_bits, tokens_per_tile, block_q, block_kv)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"the CUDA sta_batched kernel takes bf16 or f32 q / k / v of "
                                  f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in (64, 128) or block_q % 8 or block_kv % 8:
        raise NotImplementedError(f"the CUDA sta_batched kernel takes D 64/128 and blocks that "
                                  f"are multiples of 8, got D={d}, blocks {block_q}/{block_kv}")
    scale = d**-0.5 if scale is None else scale
    bias = None if kv_bias is None else _bias_row(kv_bias, skv).contiguous()
    _build.require_cuda(q, bias)
    stable = softmax == "stable"
    tpt, _, k_sub = sub if sub is not None else (0, 0, 0)
    width = kv_index.shape[2]
    if q.dtype == torch.float32:  # the f32 mode: its own kernel, no Hopper rule
        qs = q if stable else _prescale(q, scale)
        qs, k, v = (_build.aligned16(x.contiguous()) for x in (qs, k, v))
        out = torch.empty(q.shape, dtype=torch.float32, device=dev)
        err = _sta_batched_f32_fn()(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kv_index.data_ptr(),
            kv_count.data_ptr(), _build.ptr(pair_bits), _build.ptr(bias), active.data_ptr(),
            b, h, sq, skv, d, sq // block_q, width, block_q, block_kv, tpt, k_sub,
            int(stable), float(scale * LOG2E), _build.stream_ptr(dev))
        _build.check(err, "sta_batched (f32)")
        _build.launches["sta_batched"] += 1
        _build.launches["sta_batched_f32"] += 1
        if stable:
            _build.launches["sta_batched_stable"] += 1
        return out
    hopper = hopper_ok and batched_wgmma_path(d, block_q, block_kv, tpt, width,
                                              pair_bits=sub is not None, dtype=q.dtype,
                                              softmax=softmax)
    qs = (q if stable else _prescale(q, scale)).contiguous()
    qs, k, v, bias = (_build.aligned16(x) for x in (qs, k.contiguous(), v.contiguous(), bias))
    out = torch.empty(q.shape, dtype=v.dtype, device=dev)
    live = (torch.empty((skv // block_kv,), dtype=torch.int32, device=dev)
            if hopper and bias is not None else None)
    err = _sta_batched_fn()(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kv_index.data_ptr(),
        kv_count.data_ptr(), _build.ptr(pair_bits), _build.ptr(bias), active.data_ptr(),
        b, h, sq, skv, d, sq // block_q, width, block_q, block_kv, tpt, k_sub,
        int(stable), float(scale * LOG2E), int(hopper), _build.ptr(live), _build.stream_ptr(dev))
    _build.check(err, "sta_batched")
    _build.launches["sta_batched"] += 1
    if hopper:
        _build.launches["sta_batched_wgmma"] += 1
    if stable:
        _build.launches["sta_batched_stable"] += 1
    return out
