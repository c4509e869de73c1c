"""Block-sparse flash attention forward (counterpart of vorta_tpu/ops/flash.py).

For q block ``i`` of head ``h``, ``kv_index[th, i, :kv_count[th, i]]`` names
the kv blocks it attends to (``th`` is 0 when the tables are shared by all
heads).  Dense tables give full attention; ``kv_valid_len`` masks the padded
kv tail.  On CUDA tensors ``sparse_flash_attention_raw`` launches the
hand-written kernel in ``csrc/flash.cu``; on CPU tensors it runs the plain
version, ``sparse_flash_attention_ref``, which repeats the kernel's
arithmetic: base-2 softmax of ``(q.k) * scale * log2(e)`` in f32, masked
entries -1e30, P cast to v's dtype before the PV product, rows with no
visible key give 0.  ``return_lse`` also returns each row's base-2
log-sum-exp ``m + log2(l)`` (B, H, Sq, 1) f32, 1e30 for a row with no
visible key, which the backward reads.

Which kernel runs on CUDA is a pure-Python shape rule, ``wgmma_path``: head
dim 128 with ``block_q`` and ``block_kv`` multiples of 128 (every served
geometry, and training's FULL / LOWRES / cross-attention) take the Hopper
path of ``csrc/flash.cu`` (``csrc/attn_sm90.cuh``: wgmma, a TMA-fed K/V ring,
warp specialisation; counted as ``flash_wgmma`` too); D = 64 and blocks 128
does not divide (the 96- and 360-token STA tiles of training, 24-token
tiles) take its mma.sync kernel.  The rule alone decides: neither path
falls back to the other.  f32 q / k / v (the f32 serving path: the tiny
models, ``cli.sample --dtype fp32``, and the forward of f32 training,
``cli.train --dtype fp32``) take the f32 mode, its own branch (counted as
``flash_f32`` too), P kept in f32 as the plain version keeps it, the lse
written by the same core where ``return_lse`` asks for it.  Two f32 cores,
chosen by the rule ``flash_f32_tc_path`` (the backward's too,
``ops/flash_bwd.py``): at head dim 128 with blocks that are
multiples of 8 (every f32 call of the 1.3B / 13B paths: self- and
cross-attention, training's FULL / LOWRES / cross and the STA expert's 96-,
360- and 24-token tiles) the tensor-core core of ``csrc/attn_f32_tc.cuh``
(3xTF32 products on wgmma: a split pre-pass writes the TF32 halves of q, k
and V^T into scratch the wrapper allocates, ``f32_tc_work``, and TMA feeds
them to the products; ragged 64-row CTAs and 64-key chunks where 64 does
not divide a block, ``f32_tc_fwd_walk``; counted as ``flash_f32_tc`` too);
at D = 64 (the tiny models) ``csrc/attn_f32.cuh``'s FFMA core.  A call's
forward and backward take one design and share the lse.
``sparse_flash_attention_ffma`` runs the FFMA core at any shape (the
yardstick ``chip_smoke.py`` times beside the tensor-core core).

``sparse_flash_attention_raw`` is forward only, as in the JAX package: on
CUDA it raises where grad mode is on and an input requires grad.
Differentiable attention is ``make_sparse_attention``: a
``torch.autograd.Function`` whose forward saves the lse and whose backward
is ``ops/flash_bwd.py:flash_backward`` (head-shared tables), or, with
``xla_bwd=True`` or per-head tables, autograd through
``ops/attention_ref.py:attention_chunked``, the oracle.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

NEG_INF = float(-1e30)
LOG2E = 1.4426950408889634


@dataclasses.dataclass(frozen=True, eq=False)
class BlockTables:
    """Per-(head, q-block) kv-block visitation lists.

    kv_index: (H_tab, n_q_blocks, W) int32, padded by repeating the last
        active entry.  H_tab is 1 when all heads share the pattern.
    kv_count: (H_tab, n_q_blocks) int32, number of active entries.
    """

    kv_index: np.ndarray
    kv_count: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "kv_index", np.ascontiguousarray(self.kv_index, np.int32))
        object.__setattr__(self, "kv_count", np.ascontiguousarray(self.kv_count, np.int32))
        if self.kv_index.ndim != 3 or self.kv_count.ndim != 2:
            raise ValueError("kv_index must be (H, nq, W); kv_count (H, nq)")
        object.__setattr__(self, "_on_device", {})

    def block_mask(self, n_kv_blocks: int) -> np.ndarray:
        """Densify to (H_tab, nq, n_kv_blocks) bool."""
        h, nq, _ = self.kv_index.shape
        mask = np.zeros((h, nq, n_kv_blocks), dtype=bool)
        for hi in range(h):
            for qi in range(nq):
                c = self.kv_count[hi, qi]
                mask[hi, qi, self.kv_index[hi, qi, :c]] = True
        return mask

    def on(self, device: torch.device):
        """(kv_index, kv_count) as int32 tensors on ``device``, copied once."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = (
                torch.tensor(self.kv_index, device=device),
                torch.tensor(self.kv_count, device=device),
            )
        return self._on_device[key]


def dense_tables(n_q_blocks: int, n_kv_blocks: int) -> BlockTables:
    kv_index = np.broadcast_to(
        np.arange(n_kv_blocks, dtype=np.int32), (1, n_q_blocks, n_kv_blocks)
    )
    kv_count = np.full((1, n_q_blocks), n_kv_blocks, dtype=np.int32)
    return BlockTables(kv_index=kv_index, kv_count=kv_count)


def tables_from_block_mask(block_mask: np.ndarray, pad_to: Optional[int] = None) -> BlockTables:
    """block_mask: (nq, nkv) or (H, nq, nkv) bool; ``pad_to``: the tables'
    width (default: the most kv blocks a q block sees)."""
    from ..geometry import block_mask_to_tables

    if block_mask.ndim == 2:
        block_mask = block_mask[None]
    width = pad_to if pad_to is not None else max(1, int(block_mask.sum(axis=-1).max()))
    idx_list, cnt_list = [], []
    for hm in block_mask:
        idx, cnt = block_mask_to_tables(hm, pad_to=width)
        idx_list.append(idx)
        cnt_list.append(cnt)
    return BlockTables(kv_index=np.stack(idx_list), kv_count=np.stack(cnt_list))


def _kv_column_limit(skv: int, block_kv: int, kv_valid_len: int, device) -> torch.Tensor:
    """(Skv,) bool: kv columns left unmasked by the tail rule.  As in the TPU
    kernel, only block ``kv_valid_len // block_kv`` is cut, and only when
    ``kv_valid_len`` is not a multiple of ``block_kv``."""
    col = torch.arange(skv, device=device)
    if kv_valid_len % block_kv == 0:
        return torch.ones(skv, dtype=torch.bool, device=device)
    last = kv_valid_len // block_kv
    return (col // block_kv != last) | (col % block_kv < kv_valid_len % block_kv)


def sparse_flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_index: torch.Tensor,
    kv_count: torch.Tensor,
    *,
    block_q: int,
    block_kv: int,
    scale: Optional[float] = None,
    kv_valid_len: Optional[int] = None,
    return_lse: bool = False,
):
    """Plain PyTorch version of the flash kernel, one q block at a time.
    With ``return_lse``: ``(out, lse)``, lse (B, H, Sq, 1) f32."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if kv_valid_len is None:
        kv_valid_len = skv
    if scale is None:
        scale = d**-0.5
    nkv = skv // block_kv
    kv_index = torch.as_tensor(kv_index, device=q.device).long()
    kv_count = torch.as_tensor(kv_count, device=q.device).long()
    width = kv_index.shape[2]
    active = torch.arange(width, device=q.device) < kv_count[..., None]  # (Ht, nq, W)
    onehot = torch.nn.functional.one_hot(kv_index, nkv).bool() & active[..., None]
    block_mask = onehot.any(dim=2)  # (Ht, nq, nkv)
    col_ok = _kv_column_limit(skv, block_kv, kv_valid_len, q.device)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    for i in range(sq // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        vis = block_mask[:, i].repeat_interleave(block_kv, dim=-1) & col_ok  # (Ht, Skv)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows].float(), kf)
        s = s * (scale * LOG2E)
        s = torch.where(vis[None, :, None, :], s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        m_safe = torch.where(m <= NEG_INF, 0.0, m)
        p = torch.exp2(s - m_safe)
        l = p.sum(dim=-1, keepdim=True)
        if v.dtype != torch.float32:
            p = p.to(v.dtype).float()
        o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        out[:, :, rows] = (o / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
        lse[:, :, rows] = torch.where(l == 0.0, 1e30, m + torch.log2(torch.where(l == 0.0, 1.0, l)))
    return (out, lse) if return_lse else out


WGMMA_TILE = 128  # q rows per CTA and keys per ring slot of the Hopper path


def wgmma_path(d: int, block_q: int, block_kv: int) -> bool:
    """The shape rule of the Hopper path (``csrc/attn_sm90.cuh``): head dim
    128, q blocks that its 128-row CTAs tile and kv blocks that its 128-key
    ring slots tile.  The same rule on both sides: the C entry refuses the
    Hopper path for anything else."""
    return d == 128 and block_q % WGMMA_TILE == 0 and block_kv % WGMMA_TILE == 0


def f32_tc_path(d: int, block_q: int, block_kv: int) -> bool:
    """flash_manual's shape rule for the f32 mode's tensor-core core
    (``csrc/attn_f32_tc.cuh``, 3xTF32 on wgmma) and its int8 QK mode's
    (``csrc/attn_int8_tc.cuh``): ``wgmma_path``'s shapes, head dim 128 with
    q and kv blocks that are multiples of 128.  No full-width caller runs
    flash_manual at other blocks (the tiny models' 8 / 16 at D 64 and 128).
    The C entry refuses the tensor cores for anything else; elsewhere the
    FFMA core of ``csrc/attn_f32.cuh`` runs."""
    return wgmma_path(d, block_q, block_kv)


def flash_f32_tc_path(d: int, block_q: int, block_kv: int) -> bool:
    """flash's shape rule for the f32 mode's tensor cores, forward
    (``csrc/attn_f32_tc.cuh``) and backward (``csrc/attn_f32_tc_bwd.cuh``,
    ``ops/flash_bwd.py``): head dim 128 with q and kv blocks that are
    multiples of 8, so that a call's forward and backward take one design
    and share one lse (``m + log2(l)``, the sentinel 1e30).  The kernels'
    64-row CTAs and 64-key (forward) or 32-row (backward) chunks mask a
    block's ragged edge (``f32_tc_fwd_walk``, ``ops/flash_bwd.py:
    f32_tc_dq_walk`` / ``f32_tc_dkv_walk``): the STA training tiles of 96,
    360 and 24 tokens take them, as do FULL, LOWRES and cross-attention.
    Other multiples of 8 (kv blocks of 64, blocks of 8 or 16 at D 128, only
    in tests) take them too, as timed on an H100 (700 W) beside the FFMA
    kernels at the same dense calls, 12 heads, in turns: the forward + lse
    (``tools/bench_f32_fwd --ffma --dense``) at 4096 x 4096 at blocks of
    16 18.08 ms against 45.59, at blocks of 8 70.45 against 181.45; dq +
    dk/dv (``tools/bench_f32_bwd --ffma --dense``) at 8192 x 8192 at blocks
    1024 x 64 21.6 ms against 46.7, 4096 x 4096 at blocks of 16 41.3
    against 174.3, at blocks of 8 158.8 against 691.4 (the FFMA kernels'
    small CTAs lose more than the tensor cores' padding).  D 64 (the tiny
    models) stays on the FFMA kernels.  The C entries refuse the tensor
    cores for anything else: an error, never a fallback."""
    return d == 128 and block_q % 8 == 0 and block_kv % 8 == 0


F32_TC_ROWS = 64  # q rows of a tensor-core CTA (forward and backward)


def _tail(block_kv: int, kv_valid_len: int) -> Tuple[int, int]:
    """(last_block, valid_in_block) of the tail rule: only block
    kv_valid_len // block_kv is cut, and only when block_kv does not divide
    kv_valid_len (last_block -1: nothing is cut)."""
    cut = kv_valid_len % block_kv
    return (kv_valid_len // block_kv if cut else -1), cut


def f32_tc_fwd_walk(kv_index: np.ndarray, kv_count: np.ndarray, *, sq: int, block_q: int,
                    block_kv: int, kv_valid_len: int, chunk: int = 64) -> list:
    """Python mirror of ``flash_f32_tc_kernel``'s walk over head-shared
    tables: per CTA, in grid order, (its first q row, the rows of its q
    block that it owns and stores, its chunks as (first key, keys not
    masked)).  A q block takes ceil(block_q / 64)
    CTAs of a 64-row tile each; the last one's rows past its block are
    computed and never stored (neither out nor lse).  Its chunks are
    ``chunk`` keys of its q block's kv blocks up to the tail rule's limit
    (``ChunkWalk``: a chunk the rule masks completely is skipped; a block's
    last chunk, or a cut one, masks its keys past the valid count).  No
    chunks: the CTA writes zero rows and the lse sentinel.  The backward's
    dq walks the same with 32-key chunks (``ops/flash_bwd.py:
    f32_tc_dq_walk``)."""
    last, in_last = _tail(block_kv, kv_valid_len)
    walks = []
    for qi in range(sq // block_q):
        chunks = []
        for kvb in kv_index[0, qi, :kv_count[0, qi]]:
            limit = in_last if kvb == last else block_kv
            chunks += [(int(kvb) * block_kv + n0, min(chunk, limit - n0))
                       for n0 in range(0, limit, chunk)]
        walks += [(qi * block_q + local0, min(F32_TC_ROWS, block_q - local0), chunks)
                  for local0 in range(0, block_q, F32_TC_ROWS)]
    return walks


def refuse_unported(kv_valid, pair_bits, tokens_per_tile, cast_p_to_v_dtype: bool) -> None:
    """The TPU wrappers' options that flash and flash_manual do not port
    (ROADMAP section 1 item 11) raise NotImplementedError."""
    unported = (
        (kv_valid is not None, "per-head kv_valid is ROADMAP section 1 item 11: no JAX "
                               "call site passes it"),
        (pair_bits is not None or tokens_per_tile is not None,
         "pair_bits of this kernel are ROADMAP section 1 item 11: no JAX call site passes "
         "them (the STA pair bits run in ops/sta_batched.py)"),
        (not cast_p_to_v_dtype, "cast_p_to_v_dtype=False (P kept in f32) is ROADMAP section 1 "
                                "item 11: P is always cast to v's dtype here"),
    )
    for bad, why in unported:
        if bad:
            raise NotImplementedError(why)


def _flash_f32_fn():
    fn = _build.load("flash").vorta_flash_fwd_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 11 + [ctypes.c_float, p, p]
        fn.restype = ctypes.c_int
    return fn


def f32_tc_work(b: int, h: int, sq: int, skv: int, device) -> torch.Tensor:
    """The tensor-core core's scratch for one call: the big and small TF32
    halves of q (its ``sq`` rows), of k and of V^T (``skv`` each), f32 at
    head dim 128, which its split pre-pass writes and its TMA copies read."""
    return torch.empty(2 * b * h * (sq + 2 * skv) * 128, dtype=torch.float32, device=device)


def f32_tc_transposed(x: torch.Tensor, block: int, kv_valid_len: int) -> torch.Tensor:
    """Python mirror of the layout the tensor-core kernels' pre-pass
    (``f32_tc_split_t_kernel``) writes for a transposed operand, before its
    split: (B, H, S, 128) -> (B, H, 128, S) with the rows permuted within
    each group of 8 (column p holds row 8 (p // 8) + 2 (p % 4) + (p % 8) //
    4: the accumulator's columns 2t and 2t + 1 at a k step's columns t and
    t + 4, the A fragment's order) and the tail rule's cut rows (block
    ``kv_valid_len // block`` at or past ``kv_valid_len % block``) zero.
    The forward's V^T, the backward's K^T (cut as V^T), Q^T and dO^T (no
    tail: ``kv_valid_len`` = S)."""
    s = x.shape[2]
    p = torch.arange(s, device=x.device)
    rows = 8 * (p // 8) + 2 * (p % 4) + (p % 8) // 4
    tail = kv_valid_len % block
    cut = (rows // block == kv_valid_len // block) & (rows % block >= tail) & (tail > 0)
    return torch.where(cut, 0.0, x.transpose(-1, -2)[..., rows].float())


def _flash_fn():
    fn = _build.load("flash").vorta_flash_fwd_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p] + [i] * 11 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def sm90_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Test-only: the Hopper path's pieces on one (128, 128) bf16 tile each
    of q, k, v on the card (``vorta_attn_sm90_probe``).  Returns f32 (s, o):
    s = q k^T from the shared-memory wgmma, o = bf16(s) v from the
    register-A wgmma with v MN-major."""
    dev = _build.require_cuda(q, k, v)
    for t in (q, k, v):
        if t.shape != (128, 128) or t.dtype != torch.bfloat16:
            raise ValueError(f"sm90_probe takes (128, 128) bf16 tiles, got {tuple(t.shape)}")
    q, k, v = (_build.aligned16(t.contiguous()) for t in (q, k, v))
    s, o = (torch.empty((128, 128), dtype=torch.float32, device=dev) for _ in range(2))
    fn = _build.load("flash").vorta_attn_sm90_probe
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 6, ctypes.c_int
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(),
                    _build.stream_ptr(dev)), "sm90_probe")
    return s, o


def f32_tc_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Test-only: the f32 tensor-core core's pieces on one (64, 128) f32
    tile each of q, k, v on the card (``vorta_f32_tc_probe``: the split
    pre-pass, then the halves copied into the swizzled tiles).  Returns f32
    (s, o): s = q k^T (64, 64) and o = s v (64, 128), each from three TF32
    products on wgmma, P from the S registers against V^T's permuted keys."""
    dev = _build.require_cuda(q, k, v)
    for t in (q, k, v):
        if t.shape != (64, 128) or t.dtype != torch.float32:
            raise ValueError(f"f32_tc_probe takes (64, 128) f32 tiles, got {tuple(t.shape)}")
    q, k, v = (_build.aligned16(t.contiguous()) for t in (q, k, v))
    s = torch.empty((64, 64), dtype=torch.float32, device=dev)
    o = torch.empty((64, 128), dtype=torch.float32, device=dev)
    work = f32_tc_work(1, 1, 64, 64, dev)
    fn = _build.load("flash").vorta_f32_tc_probe
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 7, ctypes.c_int
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), work.data_ptr(), s.data_ptr(),
                    o.data_ptr(), _build.stream_ptr(dev)), "f32_tc_probe")
    return s, o


def sparse_flash_attention_raw(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_index,
    kv_count,
    *,
    scale: Optional[float] = None,
    block_q: int = 256,
    block_kv: int = 256,
    kv_valid_len: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
    pair_bits: Optional[torch.Tensor] = None,
    tokens_per_tile: Optional[int] = None,
    cast_p_to_v_dtype: bool = True,
    return_lse: bool = False,
):
    """Block-sparse flash attention forward; ``(out, lse)`` with ``return_lse``.

    q: (B, H, Sq, D); k/v: (B, H, Skv, D).  kv_index: (H_tab, Sq//block_q, W)
    and kv_count: (H_tab, Sq//block_q), int32 tensors (or numpy) with H_tab
    1 or H.  On CUDA: bf16 or f32 q/k/v (one dtype), D 64 or 128, block_q
    and block_kv multiples of 8 (the TPU kernel's rule).
    ``kv_valid`` (per-head valid lengths), ``pair_bits`` with
    ``tokens_per_tile`` and ``cast_p_to_v_dtype=False`` raise
    NotImplementedError (ROADMAP section 1 item 11): no JAX call site passes
    them to this kernel.
    """
    return _flash(q, k, v, kv_index, kv_count, scale=scale, block_q=block_q, block_kv=block_kv,
                  kv_valid_len=kv_valid_len, kv_valid=kv_valid, pair_bits=pair_bits,
                  tokens_per_tile=tokens_per_tile, cast_p_to_v_dtype=cast_p_to_v_dtype,
                  return_lse=return_lse)


def sparse_flash_attention_ffma(q, k, v, kv_index, kv_count, **kw):
    """``sparse_flash_attention_raw`` at f32 on the FFMA core whatever
    ``flash_f32_tc_path`` says: the card's yardstick beside the tensor-core core
    at the same call (``chip_smoke.py`` times both), counted in ``flash`` /
    ``flash_f32`` only."""
    return _flash(q, k, v, kv_index, kv_count, tc_ok=False, **kw)


def _flash(q, k, v, kv_index, kv_count, *, scale: Optional[float] = None, block_q: int = 256,
           block_kv: int = 256, kv_valid_len: Optional[int] = None, kv_valid=None,
           pair_bits=None, tokens_per_tile: Optional[int] = None,
           cast_p_to_v_dtype: bool = True, return_lse: bool = False, tc_ok: bool = True):
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if sq % block_q or skv % block_kv:
        raise ValueError(f"seq lens ({sq},{skv}) not divisible by blocks ({block_q},{block_kv})")
    if kv_index.shape[0] not in (1, h) or kv_index.shape[1] != sq // block_q:
        raise ValueError(f"tables {tuple(kv_index.shape)} for {h} heads, {sq // block_q} q blocks")
    refuse_unported(kv_valid, pair_bits, tokens_per_tile, cast_p_to_v_dtype)
    if kv_valid_len is None:
        kv_valid_len = skv
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        return sparse_flash_attention_ref(
            q, k, v, kv_index, kv_count, scale=scale, block_q=block_q,
            block_kv=block_kv, kv_valid_len=kv_valid_len, return_lse=return_lse)

    _build.forward_only("sparse_flash_attention_raw (differentiable: make_sparse_attention)",
                        q, k, v)
    dev = _build.require_cuda(q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"the CUDA flash kernel takes bf16 or f32 q / k / v of one "
                                  f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in (64, 128) or block_q % 8 or block_kv % 8:
        raise NotImplementedError(f"the CUDA flash kernel takes D 64/128 and blocks that are "
                                  f"multiples of 8, got D={d}, blocks ({block_q}, {block_kv})")
    kv_index = torch.as_tensor(kv_index, dtype=torch.int32, device=dev).contiguous()
    kv_count = torch.as_tensor(kv_count, dtype=torch.int32, device=dev).contiguous()
    f32 = q.dtype == torch.float32  # the f32 mode: its own kernels, no Hopper rule
    hopper = not f32 and wgmma_path(d, block_q, block_kv)
    tc = f32 and tc_ok and flash_f32_tc_path(d, block_q, block_kv)
    q, k, v = (_build.aligned16(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=dev) if return_lse else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.ptr(lse),
            kv_index.data_ptr(), kv_count.data_ptr(), b, h, sq, skv, d,
            kv_index.shape[0], kv_index.shape[1], kv_index.shape[2],
            block_q, block_kv, int(kv_valid_len), float(scale * LOG2E))
    if f32:
        work = f32_tc_work(b, h, sq, skv, dev) if tc else None
        err = _flash_f32_fn()(*args, _build.ptr(work), _build.stream_ptr(dev))
    else:
        err = _flash_fn()(*args, int(hopper), _build.stream_ptr(dev))
    _build.check(err, "flash (f32)" if f32 else "flash")
    _build.launches["flash"] += 1
    _build.launches["flash_f32"] += f32
    _build.launches["flash_f32_tc"] += tc
    _build.launches["flash_wgmma"] += hopper
    if return_lse:
        _build.launches["flash_lse"] += 1
        return out, lse
    return out


class SparseAttention:
    """Differentiable block-sparse attention over static tables: the value
    ``make_sparse_attention`` returns, called as ``attn(q, k, v)``.

    Where grad mode is on and q, k or v requires grad, the call goes through
    ``_FlashFunction``: the forward kernel with ``return_lse`` saves (q, k,
    v, out, lse), and the backward computes only the gradients its inputs
    need (``ctx.needs_input_grad``): dq through the dq kernel, dk and dv
    through the dk/dv kernel, each skipped where no input asks for it.
    Otherwise the call is the plain forward, without the lse.
    """

    def __init__(self, tables: BlockTables, *, n_kv_blocks: int, scale: Optional[float],
                 block_q: int, block_kv: int, kv_valid_len: Optional[int], xla_bwd: bool):
        self.tables = tables
        self.n_kv_blocks = n_kv_blocks
        self.scale = scale
        self.block_q, self.block_kv = block_q, block_kv
        self.kv_valid_len = kv_valid_len
        self.kernel_bwd = not xla_bwd and tables.kv_index.shape[0] == 1
        self._mask = {}
        if self.kernel_bwd:
            from .flash_bwd import transpose_tables

            q_index, q_count = transpose_tables(tables.kv_index, tables.kv_count, n_kv_blocks)
            self.q_tables = BlockTables(kv_index=q_index, kv_count=q_count)

    def forward(self, q, k, v, return_lse: bool = False):
        kv_index, kv_count = self.tables.on(q.device)
        return sparse_flash_attention_raw(
            q, k, v, kv_index, kv_count, scale=self.scale, block_q=self.block_q,
            block_kv=self.block_kv, kv_valid_len=self.kv_valid_len, return_lse=return_lse)

    def reference(self, q, k, v):
        """``attention_chunked`` over the densified block mask: the oracle."""
        from .attention_ref import attention_chunked

        key = str(q.device)
        if key not in self._mask:
            self._mask[key] = torch.from_numpy(self.tables.block_mask(self.n_kv_blocks)).to(q.device)
        mask = self._mask[key].expand(q.shape[1], -1, -1)
        return attention_chunked(q, k, v, block_mask=mask, scale=self.scale,
                                 block_q=self.block_q, block_kv=self.block_kv,
                                 kv_valid_len=self.kv_valid_len)

    def __call__(self, q, k, v):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return _FlashFunction.apply(q, k, v, self)
        return self.forward(q, k, v)


class _FlashFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, attn: SparseAttention):
        ctx.attn = attn
        if attn.kernel_bwd:
            out, lse = attn.forward(q, k, v, return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = attn.forward(q, k, v)
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, dout):
        attn = ctx.attn
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        if not attn.kernel_bwd:  # the oracle: autograd through attention_chunked
            q, k, v = (t.detach().requires_grad_(n) for t, n in
                       zip(ctx.saved_tensors, (need_q, need_k, need_v)))
            with torch.enable_grad():
                out = attn.reference(q, k, v)
                wrt = [t for t in (q, k, v) if t.requires_grad]
                got = iter(torch.autograd.grad(out, wrt, dout))
            return (*(next(got) if t.requires_grad else None for t in (q, k, v)), None)
        from .flash_bwd import flash_backward

        q, k, v, out, lse = ctx.saved_tensors
        kv_index, kv_count = attn.tables.on(q.device)
        q_index, q_count = attn.q_tables.on(q.device)
        d = q.shape[-1]
        dq, dk, dv = flash_backward(
            q, k, v, out, lse, dout, kv_index, kv_count, q_index, q_count,
            scale=float(attn.scale) if attn.scale is not None else d**-0.5,
            block_q=attn.block_q, block_kv=attn.block_kv,
            kv_valid_len=(attn.kv_valid_len if attn.kv_valid_len is not None
                          else attn.n_kv_blocks * attn.block_kv),
            need_dq=need_q, need_dkv=need_k or need_v)
        return dq, dk if need_k else None, dv if need_v else None, None


@functools.lru_cache(maxsize=64)
def make_sparse_attention(tables: BlockTables, *, n_kv_blocks: int, scale: Optional[float] = None,
                          block_q: int = 256, block_kv: int = 256,
                          kv_valid_len: Optional[int] = None,
                          xla_bwd: bool = False) -> SparseAttention:
    """Differentiable block-sparse attention with static tables (see
    ``SparseAttention``).  ``xla_bwd=True`` keeps the recompute backward
    through ``attention_chunked``, the oracle the kernel gradients are held
    to; per-head tables take it too, as in the JAX package.  Cached per
    tables object (``BlockTables`` hash by identity)."""
    return SparseAttention(tables, n_kv_blocks=n_kv_blocks, scale=scale, block_q=block_q,
                           block_kv=block_kv, kv_valid_len=kv_valid_len, xla_bwd=xla_bwd)
