"""The flash backward's Hopper kernels on the CPU: their shape rule
(``ops/flash_bwd.py:bwd_wgmma_path``) held against every attention call
the trainer makes (the experts' ``make_sparse_attention`` spied, as
``tests/test_torch_port_wgmma_rule.py`` does): FULL, LOWRES and the
cross-attention take the Hopper kernels, D = 64 and the 96-, 360- and
24-token STA tiles stay on the mma.sync kernels.  And the Python mirrors
of the two kernels' walks (``dq_walk``: each 128-row CTA's 128-key ring
slots; ``dkv_walk``: each 128-row kv CTA's 64-row q tiles from the
transposed tables, the tail rule's masked rows and the CTAs that write
zeros), expanded to a dense (q, kv) visibility and held equal to the one
``flash_backward_ref`` computes (``visible_blocks`` and the tail rule's
``col_ok``): every visible pair exactly once, nothing else.  The card tests
(``tests/test_torch_port_cuda.py``) hold the kernels to the plain
version."""

import dataclasses

import numpy as np
import pytest
import torch

from vorta_tpu_torch.cli.sample import attention_config
from vorta_tpu_torch.ops import experts
from vorta_tpu_torch.ops.flash import (
    WGMMA_TILE,
    _kv_column_limit,
    dense_tables,
    tables_from_block_mask,
)
from vorta_tpu_torch.ops.flash_bwd import (
    DKV_Q_TILE,
    bwd_wgmma_path,
    dkv_walk,
    dq_walk,
    transpose_tables,
    visible_blocks,
)

TRAIN_GRIDS = [(20, 30, 52), (10, 45, 80)]  # the JAX trainer's default, the bench router's


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def spy_calls(monkeypatch):
    """Record the head dim, block_q and block_kv of every
    make_sparse_attention call the experts make; the attention itself
    returns zeros of q's shape."""
    seen = []

    def fake(tables, *, n_kv_blocks, scale=None, block_q, block_kv, kv_valid_len=None,
             xla_bwd=False):
        def attn(q, k, v):
            seen.append(dict(d=q.shape[-1], bq=block_q, bkv=block_kv))
            return torch.zeros_like(q)
        return attn

    monkeypatch.setattr(experts, "make_sparse_attention", fake)
    return seen


def _trainer_calls(grid, d=128):
    """The calls of one student block: FULL, LOWRES, cross-attention."""
    cfg = attention_config("wan-1_3B", grid)
    q = torch.zeros((1, 1, cfg.seq_len, d))
    experts.full_attention(q, q, q, cfg)
    experts.lowres_attention(q, q, q, cfg)
    text = torch.zeros((1, 1, 512, d))
    experts.padded_dense_attention(q, text, text)


@pytest.mark.parametrize("grid", TRAIN_GRIDS)
def test_trainer_full_lowres_and_cross_take_the_hopper_kernels(grid, spy_calls):
    _trainer_calls(grid)
    assert len(spy_calls) == 3
    for c in spy_calls:
        assert bwd_wgmma_path(c["d"], c["bq"], c["bkv"]), (c["bq"], c["bkv"])
    full, lowres, cross = spy_calls
    assert (full["bq"], full["bkv"], lowres["bq"], lowres["bkv"]) == (1024,) * 4
    assert (cross["bq"], cross["bkv"]) == (2048, 512)


@pytest.mark.parametrize("grid,tile,tokens", [
    ((20, 30, 52), (4, 6, 4), 96),    # the JAX trainer's STA tiles
    ((10, 45, 80), (5, 9, 8), 360),   # the bench router's
    ((8, 30, 52), (2, 3, 4), 24),     # 24-token tiles
])
def test_sta_tiles_stay_on_mma_sync(grid, tile, tokens, spy_calls):
    cfg = dataclasses.replace(attention_config("wan-1_3B", grid), sta_tile=tile)
    q = torch.zeros((1, 1, cfg.seq_len, 128))
    experts.sta_attention(q, q, q, cfg)
    assert [(c["bq"], c["bkv"]) for c in spy_calls] == [(tokens, tokens)]
    assert not bwd_wgmma_path(128, tokens, tokens)


def test_head_dim_64_stays_on_mma_sync(spy_calls):
    _trainer_calls(TRAIN_GRIDS[0], d=64)
    assert len(spy_calls) == 3
    assert not any(bwd_wgmma_path(c["d"], c["bq"], c["bkv"]) for c in spy_calls)


@pytest.mark.parametrize("d,block_q,block_kv,want", [
    (128, 1024, 1024, True),
    (128, 2048, 512, True),
    (128, 128, 128, True),
    (128, 256, 1024, True),
    (64, 1024, 1024, False),
    (128, 64, 64, False),      # dk/dv's 64-row q tiles alone would take it; dq's CTAs do not
    (128, 1024, 64, False),
    (128, 96, 96, False),
    (128, 360, 360, False),
    (128, 24, 24, False),
])
def test_shape_rule(d, block_q, block_kv, want):
    assert bwd_wgmma_path(d, block_q, block_kv) is want


# --- the walks, expanded to dense visibility ----------------------------------------

def _plain_visibility(tables, sq, skv, bq, bkv, valid):
    """(Sq / 64, Skv) bool: the pairs flash_backward_ref leaves visible, per
    64-row q tile (a q block is a whole number of tiles)."""
    mask = visible_blocks(tables.kv_index, tables.kv_count, skv // bkv).numpy()
    col_ok = _kv_column_limit(skv, bkv, valid, "cpu").numpy()
    rows = np.arange(sq // DKV_Q_TILE) * DKV_Q_TILE // bq
    return mask[rows][:, np.arange(skv) // bkv] & col_ok[None]


def _dq_visibility(walks, sq, skv):
    cnt = np.zeros((sq // DKV_Q_TILE, skv), np.int32)
    per_cta = WGMMA_TILE // DKV_Q_TILE
    for c, slots in enumerate(walks):
        for key0, nvalid in slots:
            assert 0 < nvalid <= WGMMA_TILE
            cnt[c * per_cta:(c + 1) * per_cta, key0:key0 + nvalid] += 1
    return cnt


def _dkv_visibility(walks, sq, skv):
    cnt = np.zeros((sq // DKV_Q_TILE, skv), np.int32)
    for c, walk in enumerate(walks):
        if walk is None:
            continue
        rows, tiles = walk
        assert 0 < rows <= WGMMA_TILE and tiles
        for q0 in tiles:
            cnt[q0 // DKV_Q_TILE, c * WGMMA_TILE:c * WGMMA_TILE + rows] += 1
    return cnt


def _synthetic():
    """4 q blocks of 256, 5 kv blocks of 384: q block 0 sees nothing, kv
    block 2 is visited by no q block, the tail (4 x 384 + 200) cuts kv block
    4 inside its second 128-row tile and leaves its third wholly past."""
    mask = np.array([[0, 0, 0, 0, 0],
                     [1, 1, 0, 0, 1],
                     [0, 1, 0, 1, 1],
                     [1, 0, 0, 1, 0]], bool)
    return dict(tables=tables_from_block_mask(mask[None]), sq=1024, skv=1920, bq=256, bkv=384,
                valid=4 * 384 + 200)


def _training(name):
    cfg = attention_config("wan-1_3B", TRAIN_GRIDS[0])
    if name == "full":
        tab, sq, skv = experts._full_tables(cfg)
        return dict(tables=tab, sq=sq, skv=skv, bq=1024, bkv=1024, valid=cfg.seq_len)
    if name == "lowres":
        tab, sq, skv = experts._lowres_tables(cfg)
        pooled = experts.lowres_groups_for(cfg).pooled_length
        return dict(tables=tab, sq=sq, skv=skv, bq=1024, bkv=1024, valid=pooled)
    return dict(tables=dense_tables(16, 1), sq=16 * 2048, skv=512, bq=2048, bkv=512, valid=512)


CASES = {"full_31200": lambda: _training("full"), "lowres_15600": lambda: _training("lowres"),
         "cross_31200x512": lambda: _training("cross"), "synthetic": _synthetic,
         "cross_text_tail": lambda: dict(_training("cross"), valid=300)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_walks_expand_to_the_plain_visibility(name):
    c = CASES[name]()
    tab, sq, skv, bq, bkv, valid = (c[k] for k in ("tables", "sq", "skv", "bq", "bkv", "valid"))
    assert bwd_wgmma_path(128, bq, bkv)
    want = _plain_visibility(tab, sq, skv, bq, bkv, valid).astype(np.int32)
    dq = dq_walk(tab.kv_index, tab.kv_count, sq=sq, block_q=bq, block_kv=bkv,
                 kv_valid_len=valid)
    assert len(dq) == sq // WGMMA_TILE
    assert (_dq_visibility(dq, sq, skv) == want).all()
    qi, qc = transpose_tables(tab.kv_index, tab.kv_count, skv // bkv)
    dkv = dkv_walk(qi, qc, skv=skv, block_q=bq, block_kv=bkv, kv_valid_len=valid)
    assert len(dkv) == skv // WGMMA_TILE
    assert (_dkv_visibility(dkv, sq, skv) == want).all()
    # the CTAs that write zeros are exactly those whose rows see no q row
    sees = want.any(axis=0).reshape(-1, WGMMA_TILE).any(axis=1)
    assert [w is not None for w in dkv] == list(sees)
    assert [bool(w) for w in dq] == list(want.any(axis=1).reshape(-1, 2).any(axis=1))


def test_synthetic_walk_covers_each_zero_writing_case():
    c = _synthetic()
    tab = c["tables"]
    dq = dq_walk(tab.kv_index, tab.kv_count, sq=c["sq"], block_q=c["bq"], block_kv=c["bkv"],
                 kv_valid_len=c["valid"])
    assert dq[0] == dq[1] == []  # q block 0 sees nothing: two CTAs write zero dq
    # q block 1 visits kv blocks 0, 1 and 4; block 4's tail: 128 + 72 keys
    assert dq[2] == [(0, 128), (128, 128), (256, 128), (384, 128), (512, 128), (640, 128),
                     (1536, 128), (1664, 72)]
    qi, qc = transpose_tables(tab.kv_index, tab.kv_count, c["skv"] // c["bkv"])
    dkv = dkv_walk(qi, qc, skv=c["skv"], block_q=c["bq"], block_kv=c["bkv"],
                   kv_valid_len=c["valid"])
    assert dkv[6:9] == [None] * 3                     # kv block 2: no q block visits
    assert dkv[12][0] == 128 and dkv[13][0] == 72     # kv block 4: whole, then cut
    assert dkv[14] is None                            # wholly past the tail
    assert dkv[12][1] == [256, 320, 384, 448, 512, 576, 640, 704]  # q blocks 1, 2 in order
