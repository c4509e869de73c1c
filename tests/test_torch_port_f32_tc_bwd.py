"""The f32 backward's tensor-core kernels (``csrc/attn_f32_tc_bwd.cuh``:
3xTF32 on wgmma) on the CPU: their shape rule, flash's
``ops/flash.py:flash_f32_tc_path``, at every f32 backward call the trainer
makes at 480p x 77f and 720p x 37f (the tables and blocks from the experts
themselves, each call run forward and backward through
``make_sparse_attention`` on meta tensors: every one, forward and backward,
on the tensor cores), the calls that stay on the FFMA
kernels (D 64, the yardstick ``flash_backward_ffma``), the wrapper's
entries, scratch and counters on a fake card (meta tensors stand for CUDA
ones; the library's entries record their arguments and return success),
the split pre-pass's transposed, permuted layout mirrored in Python against
a plain transpose, the kernels' walks mirrored in Python at the STA blocks
(96, 360, 24: every visible pair computed once, one writer a row), and the
arithmetic of the split: an emulation of the kernels' 3xTF32 products
through a plain dq / dk / dv, against f64, and through the kernels' walk at
blocks of 96, against the plain version, reads within 1e-5 where single
TF32 products read 2e-4 or more (the kernels' gate is 1e-4).  Imports no
JAX: the plain backward's parity with JAX is held by the other port tests.
The card runs the kernels themselves: ``tests/test_torch_port_cuda.py``
and ``chip_smoke.py``'s phase s.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from vorta_tpu_torch.cli.sample import attention_config
from vorta_tpu_torch.ops import _build, experts
from vorta_tpu_torch.ops import flash as flash_ops
from vorta_tpu_torch.ops.flash import (
    _kv_column_limit,
    dense_tables,
    f32_tc_transposed,
    sparse_flash_attention_ref,
    tables_from_block_mask,
)
from vorta_tpu_torch.ops.flash_bwd import (
    LOG2E,
    f32_tc_bwd_work,
    f32_tc_dkv_walk,
    f32_tc_dq_walk,
    flash_backward,
    flash_backward_ffma,
    flash_backward_ref,
    transpose_tables,
    visible_blocks,
)

TRAIN = {"480p_77f": ((20, 30, 52), (4, 6, 4)), "720p_37f": ((10, 45, 80), (5, 9, 8))}
COUNTERS = ("flash_dq", "flash_dq_f32", "flash_dq_f32_tc", "flash_dq_wgmma", "flash_dkv",
            "flash_dkv_f32", "flash_dkv_f32_tc", "flash_dkv_wgmma")
SPLIT = "vorta_flash_bwd_f32_tc_split"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape):
    return torch.zeros(shape, dtype=torch.float32, device="meta")


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors take the CUDA branch of the wrappers; every library entry
    records (entry, args, argtypes) and returns 0 (a launch that succeeded), so the
    wrappers run to their counters.  A meta tensor's data pointer is 0, so
    a tensor the wrapper passes shows as 0 and an absent one as None."""
    calls = []

    class Library:
        def __init__(self, name):
            pass

        def __getattr__(self, entry):
            class Entry:
                argtypes = None

                def __call__(self, *args):
                    calls.append((entry, args, self.argtypes))
                    return 0

            return Entry()

    monkeypatch.setattr(_build, "require_cuda", lambda *tensors: tensors[0].device)
    monkeypatch.setattr(_build, "load", Library)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    _build.reset_launches()
    yield calls
    _build.reset_launches()


@pytest.fixture
def spy_attention(monkeypatch):
    """Record the tables and keywords of every make_sparse_attention call the
    experts make; the attention itself returns zeros of q's shape."""
    seen = []

    def fake(tables, **kw):
        seen.append((tables, kw))
        return lambda q, k, v: torch.zeros_like(q)

    monkeypatch.setattr(experts, "make_sparse_attention", fake)
    return seen


def _counted(**want):
    assert {c: _build.launches[c] for c in COUNTERS} == {**dict.fromkeys(COUNTERS, 0), **want}


def _trainer_calls(grid, tile, spy):
    """The student's attention calls at a training grid: FULL, LOWRES and the
    STA expert on the raster, the cross-attention to 512 text keys."""
    cfg = dataclasses.replace(attention_config("wan-1_3B", grid), sta_tile=tile)
    q = _meta(1, 1, cfg.seq_len, 128)
    experts.full_attention(q, q, q, cfg)
    experts.lowres_attention(q, q, q, cfg)
    experts.sta_attention(q, q, q, cfg)
    experts.padded_dense_attention(q, _meta(1, 1, 512, 128), _meta(1, 1, 512, 128))
    return dict(zip(("full", "lowres", "sta", "cross"), spy))


# ---- the rule at the trainer's calls ------------------------------------------------

@pytest.mark.parametrize("grid", sorted(TRAIN))
@pytest.mark.parametrize("expert", ["full", "lowres", "cross", "sta"])
def test_trainer_f32_backward_calls(grid, expert, spy_attention, fake_card):
    """cli.train --dtype fp32 at 480p x 77f and 720p x 37f: every
    expert's backward, the STA tiles' (96 / 360 tokens) too, takes the
    tensor-core kernels (one split pre-pass, both entries given its scratch,
    counted once each as _f32_tc), and its forward the tensor-core core (its
    scratch) by the same rule, the STA tiles' too; never _wgmma."""
    tables, kw = _trainer_calls(*TRAIN[grid], spy_attention)[expert]
    bq, bkv = kw["block_q"], kw["block_kv"]
    assert flash_ops.flash_f32_tc_path(128, bq, bkv)
    nq, nkv = tables.kv_index.shape[1], kw["n_kv_blocks"]
    q = _meta(1, 12, nq * bq, 128).requires_grad_()
    k, v = (_meta(1, 12, nkv * bkv, 128).requires_grad_() for _ in range(2))
    attn = flash_ops.make_sparse_attention(tables, **kw)
    attn(q, k, v).sum().backward()
    entries = [e for e, _, _ in fake_card]
    assert entries == ["vorta_flash_fwd_f32", SPLIT, "vorta_flash_bwd_dq_f32",
                       "vorta_flash_bwd_dkv_f32"]
    # the scratch of the forward's core and of the backward's kernels
    assert [fake_card[i][1][-2] is not None for i in (0, 2, 3)] == [True, True, True]
    _counted(flash_dq=1, flash_dq_f32=1, flash_dkv=1, flash_dkv_f32=1, flash_dq_f32_tc=1,
             flash_dkv_f32_tc=1)


def _bwd(d, bq, bkv, nq=2, nkv=2, fn=flash_backward, valid=None, **kw):
    sq, skv = nq * bq, nkv * bkv
    q, k = _meta(1, 2, sq, d), _meta(1, 2, skv, d)
    ki, kc = dense_tables(nq, nkv).on("meta")
    qi, qc = transpose_tables(*(np.broadcast_to(np.arange(nkv, dtype=np.int32), (1, nq, nkv)),
                                np.full((1, nq), nkv, np.int32)), nkv)
    return fn(q, k, k, q, _meta(1, 2, sq, 1), q, ki, kc, torch.from_numpy(qi),
              torch.from_numpy(qc), scale=d**-0.5, block_q=bq, block_kv=bkv,
              kv_valid_len=valid or skv, **kw)


@pytest.mark.parametrize("d,bq,bkv", [
    (64, 128, 128),    # the tiny models' head dim
    (64, 16, 16),      # wan-tiny's blocks
    (64, 8, 8),
])
def test_other_f32_backward_calls_stay_on_the_ffma_kernels(d, bq, bkv, fake_card):
    assert not flash_ops.flash_f32_tc_path(d, bq, bkv)
    _bwd(d, bq, bkv)
    assert [(e, a[-2]) for e, a, _ in fake_card] == [("vorta_flash_bwd_dq_f32", None),
                                                     ("vorta_flash_bwd_dkv_f32", None)]
    _counted(flash_dq=1, flash_dq_f32=1, flash_dkv=1, flash_dkv_f32=1)


@pytest.mark.parametrize("bq,bkv", [
    (96, 96),      # the f32 STA training tiles
    (360, 360),
    (24, 24),
    (1024, 64),    # a kv block 128 does not divide
    (24, 360),     # q and kv blocks of two sizes
    (16, 16),      # blocks of 16 and 8 at D 128 (tests only)
    (8, 8),
])
def test_f32_backward_at_blocks_128_does_not_divide_takes_the_tensor_cores(bq, bkv, fake_card):
    """D 128 at blocks that are multiples of 8 but not of 128: one split
    pre-pass with the blocks and the tail, both entries given its scratch,
    counted once each as _f32_tc; flash's forward takes them by the same
    rule, flash_manual's (blocks of 128) refuses them."""
    assert flash_ops.flash_f32_tc_path(128, bq, bkv)
    assert not flash_ops.f32_tc_path(128, bq, bkv)
    _bwd(128, bq, bkv, nq=3, nkv=2, valid=2 * bkv - 3)
    (split, args, _), *kernels = fake_card
    assert split == SPLIT and args[5:15] == (1, 2, 3 * bq, 2 * bkv, 128, bq, bkv, 2 * bkv - 3, 1, 1)
    assert [(e, a[-2]) for e, a, _ in kernels] == [("vorta_flash_bwd_dq_f32", 0),
                                                   ("vorta_flash_bwd_dkv_f32", 0)]
    _counted(flash_dq=1, flash_dq_f32=1, flash_dq_f32_tc=1, flash_dkv=1, flash_dkv_f32=1,
             flash_dkv_f32_tc=1)


@pytest.mark.parametrize("need", ["both", "dq", "dkv"])
def test_split_entry_and_scratch(need, fake_card, monkeypatch):
    """The split pre-pass runs once before the kernels it serves, told which
    transposed halves to write (need_dq: K^T, need_dkv: Q^T and dO^T), into
    scratch of 2 B H (4 Sq + 3 Skv) 128 f32 that both entries receive."""
    sizes = []

    def work(b, h, sq, skv, device):
        sizes.append((b, h, sq, skv))
        return f32_tc_bwd_work(b, h, sq, skv, device)

    monkeypatch.setattr("vorta_tpu_torch.ops.flash_bwd.f32_tc_bwd_work", work)
    need_dq, need_dkv = need != "dkv", need != "dq"
    dq, dk, dv = _bwd(128, 2048, 512, nq=2, nkv=1, valid=500, need_dq=need_dq,
                      need_dkv=need_dkv)
    assert (dq is None, dk is None, dv is None) == (not need_dq, not need_dkv, not need_dkv)
    split, *kernels = fake_card
    assert split[0] == SPLIT and len(split[1]) == 16
    assert split[1][5:15] == (1, 2, 4096, 512, 128, 2048, 512, 500, int(need_dq), int(need_dkv))
    assert [e for e, _, _ in kernels] == (["vorta_flash_bwd_dq_f32"] * need_dq
                                          + ["vorta_flash_bwd_dkv_f32"] * need_dkv)
    assert all(a[-2] == split[1][4] == 0 for _, a, _ in kernels)  # the same scratch
    assert sizes == [(1, 2, 4096, 512)]
    assert f32_tc_bwd_work(1, 2, 4096, 512, "meta").numel() == 2 * 2 * (4 * 4096 + 3 * 512) * 128
    _counted(**({"flash_dq": 1, "flash_dq_f32": 1, "flash_dq_f32_tc": 1} if need_dq else {}),
             **({"flash_dkv": 1, "flash_dkv_f32": 1, "flash_dkv_f32_tc": 1} if need_dkv else {}))


def test_split_entry_argtypes(fake_card):
    """The C signatures: the split entry five pointers, ten ints and the
    stream; the f32 kernel entries their pointers, nine ints, the scale, the
    scratch and the stream."""
    _bwd(128, 128, 128)
    types = {e: t for e, _, t in fake_card}
    assert types[SPLIT] == [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    for entry, n_ptr in (("vorta_flash_bwd_dq_f32", 9), ("vorta_flash_bwd_dkv_f32", 10)):
        assert types[entry] == ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9
                                + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])


def test_ffma_yardstick_at_the_tensor_core_shapes(fake_card):
    """flash_backward_ffma at FULL's blocks: no split, no scratch, counted
    in flash_dq / flash_dkv and _f32 only."""
    assert flash_ops.flash_f32_tc_path(128, 1024, 1024)
    _bwd(128, 1024, 1024, fn=flash_backward_ffma)
    assert [(e, a[-2]) for e, a, _ in fake_card] == [("vorta_flash_bwd_dq_f32", None),
                                                     ("vorta_flash_bwd_dkv_f32", None)]
    _counted(flash_dq=1, flash_dq_f32=1, flash_dkv=1, flash_dkv_f32=1)


@pytest.mark.parametrize("d,block_q,block_kv,want,forward", [
    (128, 1024, 1024, True, True), (128, 2048, 512, True, True), (128, 128, 256, True, True),
    (64, 1024, 1024, False, False), (128, 64, 64, True, False), (128, 96, 96, True, False),
    (128, 360, 360, True, False), (128, 24, 24, True, False), (128, 16, 16, True, False),
    (128, 8, 8, True, False), (128, 1024, 64, True, False), (128, 24, 360, True, False),
    (64, 96, 96, False, False), (64, 8, 8, False, False), (128, 12, 12, False, False),
    (128, 100, 96, False, False), (96, 128, 128, False, False),
])
def test_shape_rule_is_the_forwards(d, block_q, block_kv, want, forward):
    """The backward takes flash's forward's rule (``flash_f32_tc_path``: D
    128, blocks multiples of 8) at every shape, the STA tiles too;
    flash_manual's f32 rule (``forward``: D 128, blocks multiples of 128)
    holds only where it does."""
    assert flash_ops.flash_f32_tc_path(d, block_q, block_kv) is want
    assert flash_ops.f32_tc_path(d, block_q, block_kv) is forward


# ---- the pre-pass's transposed layout ----------------------------------------------

@pytest.mark.parametrize("s,block,valid", [
    (256, 128, 256), (512, 256, 300), (128, 128, 100),
    (384, 96, 344), (1080, 360, 1000), (120, 24, 115),  # the STA blocks, each with a kv tail
])
def test_transposed_layout_is_a_permuted_transpose(s, block, valid):
    """f32_tc_transposed (the Python mirror of f32_tc_split_t_kernel's
    layout) is x^T with its rows permuted within groups of 8 (column p
    holds row 8 (p // 8) + 2 (p % 4) + (p % 8) // 4), the tail rule's cut rows
    0: un-permuted it is the plain transpose; and column t of a k step holds
    the accumulator's column 2t, column t + 4 its column 2t + 1, so that the
    accumulator's registers 4kk + {0, 2, 1, 3} are the A fragment unmoved."""
    x = torch.arange(2 * 3 * s * 128, dtype=torch.float32).reshape(2, 3, s, 128) + 1
    got = f32_tc_transposed(x, block, valid)
    assert got.shape == (2, 3, 128, s)
    p = torch.arange(s)
    rows = 8 * (p // 8) + 2 * (p % 4) + (p % 8) // 4
    want = x.transpose(-1, -2).clone()
    cut = (torch.arange(s) // block == valid // block) & (torch.arange(s) % block >= valid % block)
    if valid % block:
        want[..., cut] = 0
    assert torch.equal(got[..., torch.argsort(rows)], want)
    for kk in range(s // 8):
        for t in range(4):  # the A fragment's columns t, t + 4 of k step kk
            assert rows[8 * kk + t] == 8 * kk + 2 * t
            assert rows[8 * kk + t + 4] == 8 * kk + 2 * t + 1


# ---- the split's arithmetic ---------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero
    (the kernels' cvt.rna), in integer ops."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32).double()


def _three(a, b):
    """3xTF32: small x big + big x small + big x big, each product of TF32
    values exact in f64."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a.float() - ab.float()), _tf32(b.float() - bb.float())
    return as_ @ bb + ab @ bs + ab @ bb


def _one(a, b):
    return _tf32(a) @ _tf32(b)


def _backward(q, k, v, dout, lse, delta, mm, scale, hold=lambda x: x.float()):
    """dq, dk, dv through the products ``mm``, p and ds held in f32 as the
    kernels hold them (``hold``; lse and delta given)."""
    s2 = mm(q, k.transpose(-1, -2)) * (scale * LOG2E)
    p = hold(torch.exp2(s2 - lse))
    ds = hold(p.double() * (mm(dout, v.transpose(-1, -2)) - delta))
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), dout))


@pytest.mark.parametrize("std", [1.0, 3.0])
def test_3xtf32_backward_holds_the_gate_where_one_tf32_product_cannot(std):
    """At (1, 2, 256, 128), normal inputs: the kernels' split products
    through a plain dq / dk / dv read within 1e-5 of f64 (worst |diff| /
    max(|f64|, RMS) over the three), single TF32 products 2e-4 or more, so
    the kernels' 1e-4 gate tells the two apart."""
    rng = np.random.default_rng(23)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, 2, 256, 128)) * std).float()
                     for _ in range(4))
    scale = 128**-0.5
    qd, kd, vd, dd = (x.double() for x in (q, k, v, dout))
    s2 = qd @ kd.transpose(-1, -2) * (scale * LOG2E)
    lse = torch.logsumexp(s2 / LOG2E, dim=-1, keepdim=True) * LOG2E
    delta = (dd * (torch.exp2(s2 - lse) @ vd)).sum(-1, keepdim=True)
    want = _backward(qd, kd, vd, dd, lse, delta, torch.matmul, scale, hold=lambda x: x)

    def worst(mm):
        got = _backward(q, k, v, dout, lse, delta, mm, scale)
        return max(((g - w).abs() / torch.maximum(w.abs(), w.pow(2).mean().sqrt())).max().item()
                   for g, w in zip(got, want))

    assert worst(_three) <= 1e-5
    assert worst(_one) >= 2e-4




# ---- the kernels' walks at the STA blocks ---------------------------------------------

WALKS = {  # block: (blocks a side, kv_valid_len: a tail inside the last block)
    96: (4, 4 * 96 - 40),      # the last block's second chunk cut at 24 keys
    360: (3, 3 * 360 - 100),   # 260 keys of the last block: its 5th CTA keeps 4 rows
    24: (5, 5 * 24 - 5),       # 19 keys: not a multiple of 8
}


def _walk_case(block, seed=25):
    """Tables of n x n blocks, q block 0 with count 0, the tail block
    visited, others at random; the plain version's visible (q, kv) pairs."""
    n, valid = WALKS[block]
    rng = np.random.default_rng(seed + block)
    mask = rng.random((1, n, n)) < 0.6
    mask[:, 0] = False
    mask[:, 1:, n - 1] = True
    tab = tables_from_block_mask(mask)
    s = n * block
    pairs = (visible_blocks(tab.kv_index, tab.kv_count, n).repeat_interleave(block, 0)
             .repeat_interleave(block, 1) & _kv_column_limit(s, block, valid, "cpu")[None])
    return tab, s, valid, pairs


@pytest.mark.parametrize("block", sorted(WALKS))
def test_tensor_core_walks_cover_each_visible_pair_once(block):
    """f32_tc_dq_walk / f32_tc_dkv_walk (the kernels' grids, tiles and
    chunks) at blocks of 96, 360 and 24 with a kv tail and a count-0 q
    block: ceil(block / 64) CTAs a block; each CTA stores only rows of its
    own block (the rest of its 64-row tile is masked), each output row has
    exactly one writer, each chunk lies in one block, and every visible (q,
    kv) pair is computed by exactly one CTA, no invisible one by any."""
    tab, s, valid, pairs = _walk_case(block)
    kw = dict(block_q=block, block_kv=block, kv_valid_len=valid)
    parts = -(-block // 64)
    qi, qc = transpose_tables(tab.kv_index, tab.kv_count, s // block)

    def one_block(first, n):
        return 0 < n and first // block == (first + n - 1) // block

    for walk, width in ((f32_tc_dq_walk(tab.kv_index, tab.kv_count, sq=s, **kw), 3),
                        (f32_tc_dkv_walk(qi, qc, skv=s, **kw), 4)):
        assert len(walk) == s // block * parts
        writers, seen = torch.zeros(s, dtype=torch.int64), torch.zeros(s, s, dtype=torch.int64)
        for cta in walk:
            row0, rows, chunks = cta[0], cta[1], cta[-1]
            assert len(cta) == width and (row0 % block) % 64 == 0 and rows <= 64
            assert one_block(row0, rows)  # rows past the block are never stored
            writers[row0:row0 + rows] += 1
            if width == 3:  # dq: q rows x the chunk's keys not masked
                for key0, nvalid in chunks:
                    assert nvalid <= 32 and one_block(key0, nvalid)
                    seen[row0:row0 + rows, key0:key0 + nvalid] += 1
            elif chunks is None:  # dk/dv: zeros written, no pair of its rows is visible
                assert not pairs[:, row0:row0 + rows].any()
            else:  # dk/dv: the chunk's q rows x the kv rows the tail leaves visible
                visible = cta[2]
                assert 0 < visible <= rows and not pairs[:, row0 + visible:row0 + rows].any()
                for m, nq in chunks:
                    assert nq <= 32 and one_block(m, nq)
                    seen[m:m + nq, row0:row0 + visible] += 1
        assert writers.eq(1).all()
        assert torch.equal(seen, pairs.long())
    assert not f32_tc_dq_walk(tab.kv_index, tab.kv_count, sq=s, **kw)[0][2]  # count 0: zeros


def _emulate(q, k, v, dout, lse, delta, tab, *, block, valid, scale, mm):
    """dq, dk, dv as the tensor-core kernels compute them: their walks, their
    64-row tiles (rows past the block read from the next block, past the
    tensor TMA's zeros), masks by select, each chunk's products ``mm`` in a
    fresh f32 accumulator joined in f32; K^T's cut keys 0."""
    h, s, d = q.shape[1], q.shape[2], q.shape[3]
    pad = lambda x: torch.cat([x, torch.zeros(1, h, 64, x.shape[-1])], 2)  # noqa: E731
    keys = torch.arange(s)
    cut = (keys // block == valid // block) & (keys % block >= valid % block)
    qp, kp, vp, op, ktp = (pad(x) for x in (q, k, v, dout, torch.where(cut[:, None], 0.0, k)))
    lp, dp = pad(lse), pad(delta)
    mul, t = scale * LOG2E, lambda x: x.transpose(-1, -2)  # noqa: E731
    dq, dk, dv = (torch.zeros(1, h, s, d) for _ in range(3))
    kw = dict(block_q=block, block_kv=block, kv_valid_len=valid)
    for row0, rows, chunks in f32_tc_dq_walk(tab.kv_index, tab.kv_count, sq=s, **kw):
        ok = (torch.arange(64) < rows)[:, None]
        ls = torch.where(ok, lp[:, :, row0:row0 + 64], 1e30)
        dl = torch.where(ok, dp[:, :, row0:row0 + 64], 0.0)
        qt, ot, acc = qp[:, :, row0:row0 + 64], op[:, :, row0:row0 + 64], torch.zeros(1, h, 64, d)
        for key0, nvalid in chunks:
            c = slice(key0, key0 + 32)
            col = torch.arange(32) < nvalid
            p = torch.where(col, torch.exp2(mm(qt, t(kp[:, :, c])).float() * mul - ls), 0.0)
            ds = torch.where(col, p * (mm(ot, t(vp[:, :, c])).float() - dl), 0.0)
            acc += mm(ds, ktp[:, :, c]).float()
        dq[:, :, row0:row0 + rows] = (acc * scale)[:, :, :rows]
    qi, qc = transpose_tables(tab.kv_index, tab.kv_count, s // block)
    for row0, rows, visible, chunks in f32_tc_dkv_walk(qi, qc, skv=s, **kw):
        r = slice(row0, row0 + 64)
        acc_k, acc_v = torch.zeros(1, h, 64, d), torch.zeros(1, h, 64, d)
        for m, nq in chunks or ():
            c = slice(m, m + 32)
            col = torch.arange(32) < nq
            ok = (torch.arange(64) < visible)[:, None] & col
            ls = torch.where(col, t(lp[:, :, c]), 0.0)
            dl = torch.where(col, t(dp[:, :, c]), 0.0)
            pt = torch.where(ok, torch.exp2(mm(kp[:, :, r], t(qp[:, :, c])).float() * mul - ls), 0.0)
            dst = torch.where(ok, pt * (mm(vp[:, :, r], t(op[:, :, c])).float() - dl), 0.0)
            acc_v += mm(pt, op[:, :, c]).float()
            acc_k += mm(dst, qp[:, :, c]).float()
        dk[:, :, row0:row0 + rows] = (acc_k * scale)[:, :, :rows]
        dv[:, :, row0:row0 + rows] = acc_v[:, :, :rows]
    return dq, dk, dv


def test_3xtf32_through_the_walk_at_blocks_of_96_holds_the_gate():
    """The kernels' arithmetic through their walk at the STA 96-token blocks
    (1, 2, 384, 128), a kv tail inside a chunk, q block 0 with count 0:
    3xTF32 reads within 1e-5 of flash_backward_ref (worst |diff| /
    max(|plain|, RMS) over dq, dk, dv), single TF32 products 2e-4 or more;
    zero dq for the count-0 block and zero dk, dv past the tail, exactly."""
    tab, s, valid, _ = _walk_case(96)
    rng = np.random.default_rng(96)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, 2, s, 128))).float()
                     for _ in range(4))
    kw = dict(scale=128**-0.5, block_q=96, block_kv=96)
    out, lse = sparse_flash_attention_ref(q, k, v, tab.kv_index, tab.kv_count,
                                          kv_valid_len=valid, return_lse=True, **kw)
    delta = (dout * out).sum(-1, keepdim=True)
    want = flash_backward_ref(q, k, v, out, lse, dout, tab.kv_index, tab.kv_count,
                              kv_valid_len=valid, **kw)

    def worst(mm):
        got = _emulate(q, k, v, dout, lse, delta, tab, block=96, valid=valid,
                       scale=kw["scale"], mm=mm)
        assert not got[0][:, :, :96].any() and not got[1][:, :, valid:].any() \
            and not got[2][:, :, valid:].any()
        return max(((g - w).abs() / torch.maximum(w.abs(), w.pow(2).mean().sqrt())).max().item()
                   for g, w in zip(got, want))

    assert worst(_three) <= 1e-5
    assert worst(_one) >= 2e-4


def test_bench_tool_runs_on_the_cpu():
    """tools/bench_f32_bwd at a tiny grid on the CPU (the plain versions):
    FULL, LOWRES, cross, two STA calls (blocks of 96 and 24 on a (4, 6, 8)
    grid) and a dense call, each gradient against the plain version, dq and
    dk/dv alone timed; on the card it times the kernels."""
    from vorta_tpu_torch.tools import bench_f32_bwd

    out = bench_f32_bwd.main(["--device", "cpu", "--grid", "2", "6", "8", "--heads", "2",
                              "--iters", "1", "--ffma", "--sta", "4", "6", "8", "4", "6", "4",
                              "--sta", "4", "6", "8", "2", "3", "4",
                              "--dense", "64", "128", "16", "64"])
    assert out["device"] == "cpu" and "card" not in out
    for name in ("full", "lowres", "cross", "sta96_4x6x8", "sta24_4x6x8",
                 "dense_64x128_blocks16x64"):
        assert out[name]["worst_ratio"] == 0.0  # the CPU runs the plain version itself
        assert all(out[name][k] > 0 for k in ("dq_ms", "dkv_ms", "ffma_dq_ms", "ffma_dkv_ms"))
