"""The f32 modes' tensor-core core (``csrc/attn_f32_tc.cuh``: 3xTF32 on
wgmma) on the CPU: its shape rules, ``ops/flash.py:flash_f32_tc_path``
(flash: D 128, blocks multiples of 8) and ``f32_tc_path`` (flash_manual:
blocks multiples of 128), at every f32 call of flash and flash_manual that
the 1.3B / 13B paths make (the shapes from the port's own table builders on
meta tensors; the STA training tiles of 96, 360 and 24 tokens on the tensor
cores), the calls that stay on the FFMA core (D 64, flash_manual's 16- and
96-row blocks, the int8 QK mode at D 64, the FFMA yardsticks), the
wrappers' entry, core argument and counters on a fake card (meta tensors
stand for CUDA ones; the library's entries record their arguments and
return success), the kernel's walk mirrored in Python at the STA blocks
(every visible pair once, one writer a row, the V^T split's keys), and the
arithmetic of the split: an emulation of the kernel's 3xTF32 products
through a plain attention, against f64, and through the kernel's walk at
blocks of 96, against the plain version, reads within 1e-5 where single
TF32 products read 2e-4 or more (the kernels' gate is 1e-4).  Imports no
JAX: the plain versions' parity with JAX is held by the other port tests.
The card runs the core itself: ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vorta_tpu_torch.cli.sample import attention_config
from vorta_tpu_torch.ops import _build, experts
from vorta_tpu_torch.ops.flash import (
    LOG2E,
    _kv_column_limit,
    dense_tables,
    f32_tc_fwd_walk,
    f32_tc_path,
    flash_f32_tc_path,
    sparse_flash_attention_ffma,
    sparse_flash_attention_raw,
    sparse_flash_attention_ref,
    tables_from_block_mask,
)
from vorta_tpu_torch.ops.flash_bwd import visible_blocks
from vorta_tpu_torch.ops.flash_manual import (
    sparse_flash_attention_manual,
    sparse_flash_attention_manual_ffma,
)
from vorta_tpu_torch.ops.joint_experts import JointConfig, joint_layouts
from vorta_tpu_torch.ops.routed_fused import routed_geometry

WAN_ROUTED = {  # the f32 serving paths' routed geometries: (grid, STA tile)
    "480p_77f": ((20, 30, 52), (4, 6, 4)),
    "720p_29f_4910": ((8, 45, 80), (4, 9, 10)),
    "720p_77f": ((20, 45, 80), (5, 9, 8)),
}
WAN_OFF = {"480p_21f": (6, 30, 52), "480p_77f": (20, 30, 52)}
TRAIN = {"480p_77f": (20, 30, 52), "720p_37f": (10, 45, 80)}
HY_GRIDS = {"45f": (12, 45, 80), "117f": (30, 45, 80)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.fixture
def spy_blocks(monkeypatch):
    """Record the (block_q, block_kv) of every make_sparse_attention call the
    experts make; the attention itself returns zeros of q's shape."""
    seen = []

    def fake(tables, *, n_kv_blocks, scale=None, block_q, block_kv, kv_valid_len=None,
             xla_bwd=False):
        seen.append((block_q, block_kv))
        return lambda q, k, v: torch.zeros_like(q)

    monkeypatch.setattr(experts, "make_sparse_attention", fake)
    return seen


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors take the CUDA branch of the wrappers; every library entry
    records (library, entry, args) and returns 0 (a launch that succeeded),
    so the wrappers run to their counters.  Returns the record."""
    calls = []

    class Library:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            lib = self.name

            class Entry:
                argtypes = None

                def __call__(self, *args):
                    calls.append((lib, entry, args))
                    return 0

            return Entry()

    monkeypatch.setattr(_build, "require_cuda", lambda *tensors: tensors[0].device)
    monkeypatch.setattr(_build, "load", Library)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    _build.reset_launches()
    yield calls
    _build.reset_launches()


COUNTERS = ("flash", "flash_f32", "flash_f32_tc", "flash_wgmma", "flash_manual",
            "flash_manual_f32", "flash_manual_f32_tc", "flash_manual_wgmma", "flash_manual_int8",
            "flash_manual_int8_tc")


def _took(calls, entry: str, tc: int, **counts):
    """One launch through ``entry``, given the tensor-core core's scratch
    (the f32 entries' next-to-last argument: a pointer, 0 on the meta
    device) where ``tc`` and None otherwise, and exactly ``counts`` on the
    counters."""
    assert [(e, a[-2] is not None) for _, e, a in calls] == [(entry, bool(tc))]
    assert {c: _build.launches[c] for c in COUNTERS} == {**dict.fromkeys(COUNTERS, 0), **counts}


# ---- the rule at the paths' calls -----------------------------------------------------

@pytest.mark.parametrize("name", sorted(WAN_ROUTED))
@pytest.mark.parametrize("expert", ["full", "lowres"])
def test_routed_wan_f32_calls_take_the_tensor_cores(name, expert, fake_card):
    """cli.sample --dtype fp32 routed: FULL and LOWRES (fast softmax, per-head
    counts) at 480p x 77f, at the (4, 9, 10) path's 720p x 29f and at 720p x
    77f go to the tensor-core entry, counted once."""
    grid, tile = WAN_ROUTED[name]
    cfg = dataclasses.replace(attention_config("wan-1_3B", grid), sta_tile=tile)
    call = getattr(routed_geometry(cfg), expert)
    assert f32_tc_path(128, call.block_q, call.block_kv)
    q = _meta(1, 12, call.q_pad, 128)
    ki, kc = call.tables.on("meta")
    sparse_flash_attention_manual(q, q, q, ki, kc.expand(12, -1), block_q=call.block_q,
                                  block_kv=call.block_kv, kv_valid_len=call.valid_len,
                                  softmax="fast")
    _took(fake_card, "vorta_flash_manual_fwd_f32", 1, flash_manual=1, flash_manual_f32=1,
          flash_manual_f32_tc=1)


@pytest.mark.parametrize("name", sorted(HY_GRIDS))
@pytest.mark.parametrize("layout", ["full", "lowres", "sta_text_rows"])
def test_hunyuan_joint_f32_layouts_take_the_tensor_cores(name, layout, fake_card):
    """The 13B's joint FULL / LOWRES and the STA text rows, with kv_bias."""
    cfg = attention_config("hunyuan-13B", HY_GRIDS[name])
    lay = joint_layouts(JointConfig(cfg, 256))[layout]
    assert f32_tc_path(128, lay.block_q, lay.block_kv), (lay.block_q, lay.block_kv)
    sq, skv = lay.block_q * 2, lay.block_kv * 2
    q, k = _meta(1, 2, sq, 128), _meta(1, 2, skv, 128)
    ki, kc = dense_tables(2, 2).on("meta")
    sparse_flash_attention_manual(q, k, k, ki, kc, block_q=lay.block_q, block_kv=lay.block_kv,
                                  kv_bias=_meta(1, skv), softmax="fast")
    _took(fake_card, "vorta_flash_manual_fwd_f32", 1, flash_manual=1, flash_manual_f32=1,
          flash_manual_f32_tc=1)


@pytest.mark.parametrize("name", sorted(WAN_OFF))
def test_wan_f32_self_and_cross_attention_take_the_tensor_cores(name, spy_blocks, fake_card):
    """Routing off: full_attention and padded_dense_attention's blocks, then
    flash at those blocks in f32 (self-attention padded, cross-attention to
    512 text keys) through the tensor-core entry."""
    cfg = attention_config("wan-1_3B", WAN_OFF[name])
    q = _meta(1, 1, cfg.seq_len, 128)
    experts.full_attention(q, q, q, cfg)
    experts.padded_dense_attention(q, _meta(1, 1, 512, 128), _meta(1, 1, 512, 128))
    assert len(spy_blocks) == 2 and all(f32_tc_path(128, *b) for b in spy_blocks), spy_blocks
    for bq, bkv in spy_blocks:
        fake_card.clear()
        _build.reset_launches()
        sq, skv = -(-cfg.seq_len // bq) * bq, 2 * bkv
        ki, kc = dense_tables(sq // bq, skv // bkv).on("meta")
        sparse_flash_attention_raw(_meta(1, 12, sq, 128), _meta(1, 12, skv, 128),
                                   _meta(1, 12, skv, 128), ki, kc, block_q=bq, block_kv=bkv)
        _took(fake_card, "vorta_flash_fwd_f32", 1, flash=1, flash_f32=1, flash_f32_tc=1)


@pytest.mark.parametrize("grid", sorted(TRAIN))
def test_f32_training_forward_takes_the_tensor_cores(grid, spy_blocks, fake_card):
    """cli.train --dtype fp32: the student experts FULL and LOWRES and the
    cross-attention, with the lse the backward reads."""
    cfg = attention_config("wan-1_3B", TRAIN[grid])
    q = _meta(1, 1, cfg.seq_len, 128)
    experts.full_attention(q, q, q, cfg)
    experts.lowres_attention(q, q, q, cfg)
    experts.padded_dense_attention(q, _meta(1, 1, 512, 128), _meta(1, 1, 512, 128))
    assert len(spy_blocks) == 3 and all(flash_f32_tc_path(128, *b) for b in spy_blocks), spy_blocks
    bq, bkv = spy_blocks[0]
    ki, kc = dense_tables(2, 2).on("meta")
    sparse_flash_attention_raw(_meta(1, 12, 2 * bq, 128), _meta(1, 12, 2 * bkv, 128),
                               _meta(1, 12, 2 * bkv, 128), ki, kc, block_q=bq, block_kv=bkv,
                               kv_valid_len=2 * bkv - 100, return_lse=True)
    _took(fake_card, "vorta_flash_fwd_f32", 1, flash=1, flash_f32=1, flash_f32_tc=1)


@pytest.mark.parametrize("grid,tile,tokens", [
    ((20, 30, 52), (4, 6, 4), 96),    # the JAX trainer's STA tiles
    ((10, 45, 80), (5, 9, 8), 360),   # the bench router's
    ((8, 30, 52), (2, 3, 4), 24),     # 24-token tiles
])
def test_f32_sta_training_tiles_stay_on_the_ffma_core(grid, tile, tokens, spy_blocks,
                                                      fake_card):
    """Checks that the f32 STA training tiles take the tensor cores; the
    name is what the test checked while those tiles ran the FFMA core, kept
    so that its history reads as one test.  A failure here means an STA
    tile left the tensor cores.  The STA expert's blocks take flash's
    tensor-core rule (its scratch, counted as flash_f32_tc, with the lse
    the backward reads), as the backward's do; flash_manual's rule (blocks
    of 128) still refuses them."""
    cfg = dataclasses.replace(attention_config("wan-1_3B", grid), sta_tile=tile)
    experts.sta_attention(*(_meta(1, 1, cfg.seq_len, 128),) * 3, cfg)
    assert spy_blocks == [(tokens, tokens)]
    assert flash_f32_tc_path(128, tokens, tokens) and not f32_tc_path(128, tokens, tokens)
    ki, kc = dense_tables(3, 3).on("meta")
    q = _meta(1, 12, 3 * tokens, 128)
    sparse_flash_attention_raw(q, q, q, ki, kc, block_q=tokens, block_kv=tokens,
                               kv_valid_len=3 * tokens - 5, return_lse=True)
    _took(fake_card, "vorta_flash_fwd_f32", 1, flash=1, flash_f32=1, flash_f32_tc=1)


def _ffma_calls():
    """f32 calls that stay on the FFMA core: (kernel, call)."""
    def flash(d, bq, bkv, ffma=False):
        q = _meta(1, 2, 2 * bq, d)
        k = _meta(1, 2, 2 * bkv, d)
        ki, kc = dense_tables(2, 2).on("meta")
        fn = sparse_flash_attention_ffma if ffma else sparse_flash_attention_raw
        return "flash", lambda: fn(q, k, k, ki, kc, block_q=bq, block_kv=bkv)

    def manual(d, bq, bkv, int8=False, ffma=False):
        q = _meta(1, 2, 2 * bq, d, dtype=torch.int8 if int8 else torch.float32)
        v = _meta(1, 2, 2 * bkv, d)
        k = _meta(1, 2, 2 * bkv, d, dtype=q.dtype)
        ki, kc = dense_tables(2, 2).on("meta")
        fn = sparse_flash_attention_manual_ffma if ffma else sparse_flash_attention_manual
        extra = dict(qk_scale=torch.ones(2)) if int8 else {}
        return "flash_manual", lambda: fn(q, k, v, ki, kc, block_q=bq, block_kv=bkv,
                                          softmax="fast", **extra)

    return {
        "flash_d64": flash(64, 128, 128),            # the tiny models' head dim
        "flash_d64_sta96": flash(64, 96, 96),
        "flash_ffma_yardstick": flash(128, 1024, 1024, ffma=True),
        "flash_ffma_yardstick_sta96": flash(128, 96, 96, ffma=True),
        "manual_d64": manual(64, 256, 256),
        "manual_blocks16": manual(128, 16, 16),      # flash_manual's rule: blocks of 128
        "manual_sta96": manual(128, 96, 96),
        "manual_int8_f32_v": manual(64, 1024, 1024, int8=True),  # D 64: the tiny models
        "manual_ffma_yardstick": manual(128, 1024, 1024, ffma=True),
    }


def _flash_tc_calls():
    """flash's f32 calls at blocks 128 does not divide that take the
    tensor-core core by its rule: name -> (block_q, block_kv)."""
    return {
        "flash_blocks16": (16, 16),                  # wan-tiny's blocks at D 128
        "flash_blocks8": (8, 8),
        "flash_sta96": (96, 96),                     # the f32 STA training tiles
        "flash_sta360": (360, 360),
        "flash_sta24": (24, 24),
        "flash_kv64": (1024, 64),
    }


@pytest.mark.parametrize("case", sorted(_ffma_calls()))
def test_other_f32_calls_stay_on_the_ffma_core(case, fake_card):
    """D 64 (in f32 and in the int8 QK mode), flash_manual's blocks 128 does
    not divide and the FFMA yardsticks: the f32 entry with no scratch (the
    FFMA core), counted in the f32 counters and never as ``*_f32_tc`` or
    ``*_wgmma``."""
    kernel, call = _ffma_calls()[case]
    call()
    n = dict(flash_manual_int8=1) if case == "manual_int8_f32_v" else {}
    entry = "vorta_flash_fwd_f32" if kernel == "flash" else "vorta_flash_manual_fwd_f32"
    _took(fake_card, entry, 0, **{kernel: 1, f"{kernel}_f32": 1, **n})


@pytest.mark.parametrize("case", sorted(_flash_tc_calls()))
def test_flash_f32_at_blocks_128_does_not_divide_takes_the_tensor_cores(case, fake_card):
    """flash at D 128 with blocks that are multiples of 8 (the STA tiles,
    blocks of 16 and 8, kv blocks of 64): the f32 entry with the scratch,
    the lse slot filled, counted once as flash_f32_tc."""
    bq, bkv = _flash_tc_calls()[case]
    assert flash_f32_tc_path(128, bq, bkv) and not f32_tc_path(128, bq, bkv)
    ki, kc = dense_tables(2, 2).on("meta")
    sparse_flash_attention_raw(_meta(1, 2, 2 * bq, 128), _meta(1, 2, 2 * bkv, 128),
                               _meta(1, 2, 2 * bkv, 128), ki, kc, block_q=bq, block_kv=bkv,
                               return_lse=True)
    assert fake_card[0][2][4] is not None  # the lse slot
    _took(fake_card, "vorta_flash_fwd_f32", 1, flash=1, flash_f32=1, flash_f32_tc=1)


def test_bf16_calls_count_no_f32_core(fake_card):
    """bf16 at the tensor-core shapes stays on the bf16 entry (its Hopper
    path): no f32 counter moves."""
    q = _meta(1, 2, 256, 128, dtype=torch.bfloat16)
    ki, kc = dense_tables(2, 2).on("meta")
    sparse_flash_attention_raw(q, q, q, ki, kc, block_q=128, block_kv=128)
    assert [e for _, e, _ in fake_card] == ["vorta_flash_fwd_bf16"]
    assert (_build.launches["flash_f32_tc"], _build.launches["flash_wgmma"]) == (0, 1)


FLASH_ONLY = {(128, 64, 64), (128, 1024, 64), (128, 96, 96), (128, 360, 360), (128, 16, 16),
              (128, 24, 24), (128, 8, 8), (128, 24, 360)}  # flash's rule, not flash_manual's


@pytest.mark.parametrize("d,block_q,block_kv,want", [
    (128, 1024, 1024, True), (128, 2048, 512, True), (128, 256, 1024, True),
    (128, 128, 128, True), (64, 1024, 1024, False), (128, 64, 64, False),
    (128, 1024, 64, False), (128, 96, 96, False), (128, 360, 360, False), (128, 16, 16, False),
    (128, 24, 24, False), (128, 8, 8, False), (128, 24, 360, False), (64, 96, 96, False),
    (128, 12, 12, False), (128, 100, 96, False),
])
def test_shape_rule(d, block_q, block_kv, want):
    """flash_manual's rule (``want``: D 128, blocks multiples of 128) and
    flash's (D 128, blocks multiples of 8: every shape of ``want`` and the
    STA tiles, blocks of 64, 16 and 8 beside it)."""
    assert f32_tc_path(d, block_q, block_kv) is want
    assert flash_f32_tc_path(d, block_q, block_kv) is (want or (d, block_q, block_kv) in FLASH_ONLY)


# ---- the split's arithmetic ---------------------------------------------------------------

def _tf32(x: torch.Tensor, ties_even: bool) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits) in integer ops: to nearest, ties
    away from zero (the kernel's cvt.rna) or to even."""
    b = x.float().contiguous().view(torch.int32)
    half = 0xFFF + ((b >> 13) & 1) if ties_even else 0x1000
    return ((b + half) & ~0x1FFF).view(torch.float32).double()


def _split(x):
    big = _tf32(x, False)
    return big, _tf32((x.float() - big.float()), False)


def _attention(q, k, v, qk, pv):
    """Softmax attention in f64 with the two products given: s = qk(q, k^T)
    in the log2 domain, the stable softmax, o = pv(p, v) / l (the
    emulations take p as the kernel holds it, in f32)."""
    s = qk(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5 / np.log(2))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return pv(p, v) / p.sum(dim=-1, keepdim=True)


def _three(a, b):
    """3xTF32: small x big + big x small + big x big, each product of TF32
    values exact in f64."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _one(a, b):
    return _tf32(a, False) @ _tf32(b, False)


@pytest.mark.parametrize("std", [1.0, 3.0])
def test_3xtf32_split_holds_the_gate_where_one_tf32_product_cannot(std):
    """At (1, 2, 256, 128), normal inputs: the kernel's split through a plain
    attention reads within 1e-5 of f64 (worst |diff| / max(|f64|, RMS)),
    single TF32 products 2e-4 or more, so the kernels' 1e-4 gate tells the
    two apart."""
    rng = np.random.default_rng(22)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 256, 128)) * std).float()
               for _ in range(3))
    want = _attention(q.double(), k.double(), v.double(), torch.matmul, torch.matmul)

    def worst(got):
        rms = want.pow(2).mean().sqrt()
        return ((got - want).abs() / torch.maximum(want.abs(), rms)).max().item()

    assert worst(_attention(q, k, v, _three, _three)) <= 1e-5
    assert worst(_attention(q, k, v, _one, _one)) >= 2e-4


# ---- the kernel's walk at the STA blocks ----------------------------------------------

WALKS = {  # block: (blocks a side, kv_valid_len: a tail inside the last block)
    96: (4, 4 * 96 - 40),      # the last block's second chunk cut at 24 keys
    360: (3, 3 * 360 - 100),   # 260 keys of the last block: its 5th chunk keeps 4 keys
    24: (5, 5 * 24 - 5),       # 19 keys: not a multiple of 8
}


def _walk_case(block, seed=26):
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
def test_forward_walk_covers_each_visible_pair_once(block):
    """f32_tc_fwd_walk (the kernel's grid, tiles and chunks) at blocks of 96,
    360 and 24 with a kv tail and a count-0 q block: ceil(block / 64) CTAs a
    block, each storing only rows of its own block (the count-0 block's
    CTAs too: out and lse), each q row stored by exactly one CTA; every
    chunk lies in one block; every visible (row, key) pair
    computed by exactly one CTA, no invisible one by any."""
    tab, s, valid, pairs = _walk_case(block)
    walk = f32_tc_fwd_walk(tab.kv_index, tab.kv_count, sq=s, block_q=block, block_kv=block,
                           kv_valid_len=valid)
    assert len(walk) == s // block * -(-block // 64)
    writers, seen = torch.zeros(s, dtype=torch.int64), torch.zeros(s, s, dtype=torch.int64)
    for row0, rows, chunks in walk:
        assert (row0 % block) % 64 == 0 and 0 < rows <= 64
        assert row0 // block == (row0 + rows - 1) // block  # rows past the block: never stored
        writers[row0:row0 + rows] += 1
        for key0, nvalid in chunks:
            assert 0 < nvalid <= 64 and key0 // block == (key0 + nvalid - 1) // block
            assert key0 % 8 == 0  # V^T's permuted groups of 8 keys start on the chunk
            seen[row0:row0 + rows, key0:key0 + nvalid] += 1
    assert writers.eq(1).all()
    assert torch.equal(seen, pairs.long())
    assert not any(chunks for row0, _, chunks in walk if row0 < block)  # q block 0: count 0


def _emulate_forward(q, k, v, tab, *, block, valid, scale, mm):
    """out and lse as the tensor-core core computes them: its walk, 64-row
    tiles (rows past the block read from the next block, past the tensor
    TMA's zeros), 64-key chunks (keys past the block from the next block or
    zeros, masked by select), S = mm(q, k^T) per chunk, the stable online
    softmax in f32, each chunk's P V product mm(p, v) in a fresh
    accumulator joined by O = O alpha + PV; V^T's cut keys 0."""
    h, s, d = q.shape[1], q.shape[2], q.shape[3]
    pad = lambda x: torch.cat([x, torch.zeros(1, h, 64, x.shape[-1])], 2)  # noqa: E731
    keys = torch.arange(s)
    cut = (keys // block == valid // block) & (keys % block >= valid % block)
    qp, kp, vp = pad(q), pad(k), pad(torch.where(cut[:, None], 0.0, v))
    mul = scale * LOG2E
    out, lse = torch.zeros(1, h, s, d), torch.zeros(1, h, s, 1)
    for row0, rows, chunks in f32_tc_fwd_walk(tab.kv_index, tab.kv_count, sq=s, block_q=block,
                                              block_kv=block, kv_valid_len=valid):
        qt = qp[:, :, row0:row0 + 64]
        m = torch.full((1, h, 64, 1), -1e30)
        l, o = torch.zeros(1, h, 64, 1), torch.zeros(1, h, 64, d)
        for key0, nvalid in chunks:
            c = slice(key0, key0 + 64)
            col = torch.arange(64) < nvalid
            x = torch.where(col, mm(qt, kp[:, :, c].transpose(-1, -2)).float() * mul, -1e30)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.where(m <= -1e30, 0.0, torch.exp2(m - m_new))
            p = torch.exp2(x - torch.where(m_new <= -1e30, 0.0, m_new))
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + mm(p, vp[:, :, c]).float()
            m = m_new
        out[:, :, row0:row0 + rows] = torch.where(l == 0, 0.0, o / l)[:, :, :rows]
        lse[:, :, row0:row0 + rows] = torch.where(
            l == 0, 1e30, m + torch.log2(torch.where(l == 0, 1.0, l)))[:, :, :rows]
    return out, lse


def test_3xtf32_through_the_forward_walk_at_blocks_of_96_holds_the_gate():
    """The core's arithmetic through its walk at the STA 96-token blocks
    (1, 2, 384, 128), a kv tail inside a chunk, q block 0 with count 0:
    3xTF32 reads within 1e-5 of sparse_flash_attention_ref (worst |diff| /
    max(|plain|, RMS)), its lse within 1e-4 + 1e-5 x |plain|, single TF32
    products 2e-4 or more (their lse outside that gate too); the count-0
    block's rows exact zeros with the lse sentinel."""
    tab, s, valid, _ = _walk_case(96)
    rng = np.random.default_rng(96)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, s, 128))).float() for _ in range(3))
    scale = 128**-0.5
    want, want_lse = sparse_flash_attention_ref(q, k, v, tab.kv_index, tab.kv_count,
                                                scale=scale, block_q=96, block_kv=96,
                                                kv_valid_len=valid, return_lse=True)

    def worst(mm):
        out, lse = _emulate_forward(q, k, v, tab, block=96, valid=valid, scale=scale, mm=mm)
        assert not out[:, :, :96].any() and (lse[:, :, :96] == 1e30).all()
        rms = want.pow(2).mean().sqrt()
        lse_ok = bool(((lse - want_lse).abs() <= 1e-4 + 1e-5 * want_lse.abs()).all())
        return ((out - want).abs() / torch.maximum(want.abs(), rms)).max().item(), lse_ok

    three, one = worst(_three), worst(_one)
    assert three[0] <= 1e-5 and three[1]
    assert one[0] >= 2e-4 and not one[1]


def test_forward_bench_tool_runs_on_the_cpu():
    """tools/bench_f32_fwd at a tiny grid on the CPU (the plain versions):
    FULL, LOWRES, cross, an STA call and a dense call, each against the
    plain version and timed in turns with the FFMA arm; on the card it times
    the cores."""
    from vorta_tpu_torch.tools import bench_f32_fwd

    out = bench_f32_fwd.main(["--device", "cpu", "--grid", "2", "6", "8", "--heads", "2",
                              "--iters", "1", "--ffma", "--sta", "4", "6", "8", "4", "6", "4",
                              "--dense", "64", "128", "16", "64"])
    assert out["device"] == "cpu" and "card" not in out
    for name in ("full", "lowres", "cross", "sta96_4x6x8", "dense_64x128_blocks16x64"):
        assert out[name]["worst_ratio"] == out[name]["ffma_worst_ratio"] == 0.0
        assert len(out[name]["ms_turns"]) == len(out[name]["ffma_ms_turns"]) == 2
