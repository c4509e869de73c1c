"""sta_window's and sta_batched's Hopper paths on the CPU: their rules
(``ops/sta_window.py:window_wgmma_path`` with its box rule ``window_box``,
``ops/sta_batched.py:batched_wgmma_path``) and their slot walks
(``ops/sta_pipe.py:window_walk`` over a padded box, ``ops/sta_batched.py:
pair_bit_walk``, the lists the kernel's CTAs build), all pure Python.  The
served geometries take the new paths (Wan 720p x 77f at tile (4, 9, 10)
through the routed dispatch, HunyuanVideo 45f at (2, 9, 8) through the joint
STA expert: spied, the calls' arguments meet the rules), while D = 64,
hunyuan-tiny's (2, 2, 2) tile, windows with no box and sta_batched's stable
softmax stay on the mma.sync kernels.  Each walk, expanded to a dense
(query, key) visibility with the kernel's column masks, is exactly the
plain version's visibility: for sta_window its window keys, each once, the
padded columns masked; for sta_batched kv_index / kv_count / pair_bits as
the JAX package builds them, with the bias's live keys.  The card tests
(``tests/test_torch_port_cuda.py``) hold the kernels to their plain
versions."""

import dataclasses

import numpy as np
import pytest
import torch

from vorta_tpu_torch.cli.sample import attention_config
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.ops import joint_experts, routed_fused
from vorta_tpu_torch.ops.experts import STA
from vorta_tpu_torch.ops.joint_experts import JointConfig, joint_sta_attention, joint_sta_kernel
from vorta_tpu_torch.ops.routed_fused import routed_sta_kernel
from vorta_tpu_torch.ops.sta_batched import (
    LIST_MAX_SLOTS,
    LIVE_BIAS,
    batched_wgmma_path,
    pair_bit_walk,
)
from vorta_tpu_torch.ops.sta_pipe import WALK_BN, WALK_MAX_SLOTS, _extent, _window_keys, window_walk
from vorta_tpu_torch.ops.sta_window import window_box, window_wgmma_path

W3 = (3, 3, 3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- sta_window: the rule and the padded box ----------------------------------------------

@pytest.mark.parametrize("grid,tile,window,box", [
    ((20, 45, 80), (4, 9, 10), W3, (32, 1)),   # Wan 720p: runs of 30, 27 a plane: padded
    ((12, 45, 80), (4, 9, 10), W3, (32, 1)),   # HunyuanVideo 45f at the same tile
    ((4, 18, 80), (4, 9, 10), W3, (32, 2)),    # chip_smoke's model check: 18 runs a plane
    ((6, 4, 30), (2, 2, 10), W3, (30, 4)),     # runs of 30, 4 a box land unpadded
    ((4, 8, 45), (2, 4, 9), W3, (32, 4)),      # runs of 27 (odd) over 8 rows: padded to 32
    ((8, 6, 30), (2, 3, 6), W3, None),         # runs of 18: padding to 24 is not built
    ((20, 45, 80), (5, 9, 8), W3, (24, 1)),    # sta_pipe's box where one lands
    ((4, 8, 8), (2, 2, 2), (3, 3, 1), None),   # runs of 6: one 8-column block, not built
    ((4, 6, 192), (2, 3, 64), W3, None),       # runs of 192: longer than a slot
])
def test_the_window_box_rule(grid, tile, window, box):
    assert window_box(grid, tile, window) == box
    assert window_wgmma_path(128, grid, tile, window) is (box is not None)
    if box is not None:
        bw = _extent(grid, tile, window)[2]
        box_w, box_h = box
        assert (box_w * box_h) % 8 == 0 and box_w * box_h <= WALK_BN
        assert box_w == bw or (box_w % 8 == 0 and box_w - 8 < bw < box_w)


@pytest.mark.parametrize("change", [dict(d=64), dict(dtype=torch.float32), dict(text_len=20)])
def test_each_condition_of_the_window_rule_sends_the_call_to_mma_sync(change):
    kw = dict(d=128, dtype=torch.bfloat16, text_len=256)
    assert window_wgmma_path(kw["d"], (12, 45, 80), (4, 9, 10), W3, dtype=kw["dtype"],
                             text_len=kw["text_len"])
    kw.update(change)
    assert not window_wgmma_path(kw["d"], (12, 45, 80), (4, 9, 10), W3, dtype=kw["dtype"],
                                 text_len=kw["text_len"])


def test_a_window_table_past_the_shared_memory_stays_on_mma_sync():
    """Tiles of 2,048 tokens: a 55,296-key window in 576 slots, more than the
    kernel's shared memory holds."""
    grid, tile = (24, 48, 48), (8, 16, 16)
    assert window_box(grid, tile, W3) == (48, 2)
    assert window_walk(grid, tile, W3, 0, (48, 2)).shape[0] == 576 > WALK_MAX_SLOTS
    assert not window_wgmma_path(128, grid, tile, W3)


def _walk_keys(grid, tile, q_tile, text_len=0):
    """The keys the sta_window kernel attends for q tile ``q_tile``: each
    window slot's boxes, run by run, with the columns at or past the run
    width masked (checked to be the neighbouring tile's tokens, or past the
    grid's edge, where TMA reads zeros); then the text keys."""
    _, hh, w = grid
    box_w, box_h = window_box(grid, tile, W3)
    bw = _extent(grid, tile, W3)[2]
    walk = window_walk(grid, tile, W3, text_len, (box_w, box_h))
    origin = _window_keys(grid, tile, W3)[q_tile, 0]
    w0 = origin % w
    keys, text, padded = [], [], 0
    for row in walk:
        if row[1] >= 0:  # a text slot
            text.extend(range(row[1], row[1] + row[0]))
            continue
        assert row[0] == row[2] * box_w * box_h and row[0] <= WALK_BN
        for i in range(row[2]):
            dt, dh = int(row[4 + 2 * i]), int(row[5 + 2 * i])
            for hr in range(box_h):
                run = origin + (dt * hh + dh + hr) * w
                keys.extend(run + np.arange(bw))
                padded += box_w - bw
                assert w0 + bw <= w  # the run itself lies in the grid
    return np.asarray(keys), text, padded


@pytest.mark.parametrize("grid,tile", [
    ((20, 45, 80), (4, 9, 10)), ((4, 18, 80), (4, 9, 10)), ((4, 8, 45), (2, 4, 9)),
])
def test_padded_window_walk_covers_each_window_key_once(grid, tile):
    """At the grid's corners and edges (windows clamped) and inside, where
    the padded columns are real tokens of the next tile, the unmasked keys
    are the plain version's window keys, each once, in its order."""
    want = _window_keys(grid, tile, W3)
    n = want.shape[0]
    nh, nw = grid[1] // tile[1], grid[2] // tile[2]
    bw = _extent(grid, tile, W3)[2]
    box_w = window_box(grid, tile, W3)[0]
    for q_tile in sorted({0, n - 1, nw - 1, (nh - 1) * nw, n // 2, nw // 2}):
        got, _, padded = _walk_keys(grid, tile, q_tile)
        assert len(np.unique(got)) == len(got) == want.shape[1]
        assert (got == want[q_tile]).all(), q_tile
        assert padded == (box_w - bw) * len(got) // bw
    # inside the grid the padding columns hold the next tile's tokens: masked, not absent
    if nw > 3:
        inner = nw // 2
        w0 = _window_keys(grid, tile, W3)[inner, 0] % grid[2]
        assert w0 + box_w <= grid[2]


def test_padded_walk_with_the_text_tail():
    """HunyuanVideo 45f at (4, 9, 10) with 256 text keys: 81 window slots of
    4 padded runs, then two text slots of 128."""
    walk = window_walk((12, 45, 80), (4, 9, 10), W3, 256, (32, 1))
    assert walk.shape[0] == 83
    assert (walk[:81, 1] < 0).all() and list(walk[81:, 1]) == [0, 128]
    assert (walk[:81, 0] == 128).all() and (walk[:81, 2] == 4).all()
    _, text, _ = _walk_keys((12, 45, 80), (4, 9, 10), 7, 256)
    assert text == list(range(256))


# --- sta_batched: the rule and the slot walk ------------------------------------------------

def _hy_joint(latent, tile, text_len, valid):
    cfg = dataclasses.replace(attention_config("hunyuan-13B", (12, 45, 80)),
                              latent_shape=latent, sta_tile=tile)
    jcfg = JointConfig(cfg, text_len)
    lay = joint_experts.joint_layouts(jcfg)["sta"]
    tables = joint_experts._joint_sta_tables(jcfg)
    mask = (torch.arange(text_len) < valid)[None]
    bias = joint_experts._bias(mask, lay, cfg.seq_len)[0].numpy()
    return cfg, jcfg, lay, tables, bias


def test_served_hunyuan_geometry_takes_the_batched_hopper_path():
    """HunyuanVideo 720p x 45f at (2, 9, 8): blocks 432 / 1008 over 144-token
    tiles, 46 kv blocks at most per q block, 8 slots each."""
    cfg, jcfg, lay, tables, bias = _hy_joint((12, 45, 80), (2, 9, 8), 256, 83)
    assert joint_sta_kernel(jcfg, 128, 2) == "sta_batched"
    assert (lay.block_q, lay.block_kv, cfg.tokens_per_tile) == (432, 1008, 144)
    width = tables.kv_index.shape[2]
    assert batched_wgmma_path(128, lay.block_q, lay.block_kv, 144, width)
    assert width * 8 <= LIST_MAX_SLOTS


@pytest.mark.parametrize("change", [
    dict(d=64), dict(dtype=torch.float32), dict(softmax="stable"), dict(tokens_per_tile=8),
    dict(tokens_per_tile=120), dict(block_kv=128 * 33), dict(width=LIST_MAX_SLOTS // 8 + 1),
])
def test_each_condition_of_the_batched_rule_sends_the_call_to_mma_sync(change):
    kw = dict(d=128, block_q=432, block_kv=1008, tokens_per_tile=144, width=46)
    args = lambda kw: (kw["d"], kw["block_q"], kw["block_kv"], kw["tokens_per_tile"],  # noqa
                       kw["width"])
    assert batched_wgmma_path(*args(kw))
    kw.update(change)
    opts = {k: kw[k] for k in ("dtype", "softmax") if k in kw}
    assert not batched_wgmma_path(*args(kw), **opts)


def test_without_pair_bits_any_tile_takes_the_batched_hopper_path():
    assert batched_wgmma_path(128, 40, 48, 0, 3, pair_bits=False)


@pytest.mark.parametrize("latent,tile,text_len", [
    ((4, 6, 16), (2, 2, 2), 24),   # hunyuan-tiny's tile: 8-token tiles
    ((4, 6, 16), (2, 2, 2), 13),   # an odd text length there
])
def test_small_tiles_stay_on_mma_sync(latent, tile, text_len):
    cfg, jcfg, lay, tables, _ = _hy_joint(latent, tile, text_len, text_len)
    assert joint_sta_kernel(jcfg, 128, 2) == "sta_batched"
    assert not batched_wgmma_path(128, lay.block_q, lay.block_kv, cfg.tokens_per_tile,
                                  tables.kv_index.shape[2])


def test_an_odd_text_length_at_a_large_tile_takes_the_batched_hopper_path():
    """An odd text length sends the joint expert to sta_batched (the JAX
    gate); at a tile of 144 tokens its bias masks the text, whatever its
    length, so the Hopper path runs it."""
    cfg, jcfg, lay, tables, _ = _hy_joint((4, 18, 16), (2, 9, 8), 13, 13)
    assert joint_sta_kernel(jcfg, 128, 2) == "sta_batched"
    assert batched_wgmma_path(128, lay.block_q, lay.block_kv, cfg.tokens_per_tile,
                              tables.kv_index.shape[2])


def _plain_visibility(tables, bias, lay, tpt):
    """(S, S) bool: the plain version's visible pairs (kv_index / kv_count /
    pair bits), keys the bias masks excluded."""
    s = lay.total
    ki, kc = tables.kv_index[0], tables.kv_count[0]
    words = tables.pair_bits[0].astype(np.int64) & 0xFFFFFFFF
    k_sub = lay.block_kv // tpt
    vis = np.zeros((s, s), bool)
    rt = np.arange(lay.block_q) // tpt
    ct = np.arange(lay.block_kv) // tpt
    idx = rt[:, None] * k_sub + ct[None, :]
    for qi in range(ki.shape[0]):
        for j in range(kc[qi]):
            kvb = ki[qi, j]
            seen = (idx < 32) & ((words[qi, j] >> np.minimum(idx, 31)) & 1).astype(bool)
            vis[qi * lay.block_q:(qi + 1) * lay.block_q,
                kvb * lay.block_kv:(kvb + 1) * lay.block_kv] |= seen
    return vis & (bias > LIVE_BIAS)[None, :]


def _walk_visibility(lists, bias, lay, tpt):
    """(S, S) bool from the Hopper path's slot lists with its column masks:
    per CTA row and slot column, the 2 x 2 bits split at the CTA's row tile
    boundary and the slot's key split, columns past nvalid hidden; each pair
    in at most one slot."""
    s = lay.total
    cpb = -(-lay.block_q // 128)
    vis = np.zeros((s, s), np.int8)
    for cta, slots in enumerate(lists):
        qi, chunk = divmod(cta, cpb)
        r0 = chunk * 128
        rows = min(128, lay.block_q - r0)
        row_tiles = (r0 + np.arange(rows)) // tpt
        second = row_tiles != row_tiles[0]
        q0 = qi * lay.block_q + r0
        for key0, nvalid, split, vis4, full in slots:
            cols = np.arange(nvalid)
            m = np.zeros((rows, nvalid), bool)
            for b in (0, 1):
                sel = second == bool(b)
                m[sel] = ((cols < split) & bool(vis4 >> (2 * b) & 1)
                          | (cols >= split) & bool(vis4 >> (2 * b + 1) & 1))[None]
            if full:
                assert m.all() and nvalid == 128
            vis[q0:q0 + rows, key0:key0 + nvalid] += m
    assert vis.max() <= 1  # no pair in two slots
    return vis.astype(bool) & (bias > LIVE_BIAS)[None, :]


@pytest.mark.parametrize("latent,tile,text_len,valid", [
    ((4, 18, 16), (2, 9, 8), 24, 17),    # the card tests' joint case, blocks 432 / 1008
    ((6, 18, 32), (2, 9, 8), 256, 83),   # chip_smoke's Hunyuan model check at (2, 9, 8)
])
def test_pair_bit_walk_expands_to_the_plain_visibility(latent, tile, text_len, valid):
    cfg, jcfg, lay, tables, bias = _hy_joint(latent, tile, text_len, valid)
    tpt = cfg.tokens_per_tile
    lists = pair_bit_walk(tables.kv_index, tables.kv_count, tables.pair_bits, bias,
                          block_q=lay.block_q, block_kv=lay.block_kv, tokens_per_tile=tpt)
    assert len(lists) == (lay.total // lay.block_q) * -(-lay.block_q // 128)
    want = _plain_visibility(tables, bias, lay, tpt)
    got = _walk_visibility(lists, bias, lay, tpt)
    assert (got == want).all()
    # every listed slot holds a live, visible pair; the bias leaves out whole slots
    kept = sum(len(x) for x in lists)
    unbiased = sum(len(x) for x in pair_bit_walk(
        tables.kv_index, tables.kv_count, tables.pair_bits, None, block_q=lay.block_q,
        block_kv=lay.block_kv, tokens_per_tile=tpt))
    assert 0 < kept < unbiased


def test_pair_bit_walk_without_bits_lists_every_slot_of_each_block():
    kv_index = np.asarray([[[0, 1], [1, 1]]], np.int32)
    kv_count = np.asarray([[2, 1]], np.int32)
    lists = pair_bit_walk(kv_index, kv_count, None, None, block_q=200, block_kv=200,
                          tokens_per_tile=None)
    assert len(lists) == 4  # two CTAs per q block
    assert [s[0] for s in lists[0]] == [0, 128, 200, 328] and lists[0] == lists[1]
    assert [s[1] for s in lists[0]] == [128, 72, 128, 72]
    assert [s[0] for s in lists[2]] == [200, 328]
    assert all(s[4] == (s[1] == 128) for x in lists for s in x)


# --- the served dispatches ask for the new paths ------------------------------------------

def test_routed_wan_dispatch_at_4910_asks_for_the_window_hopper_path(monkeypatch):
    """One head routed to STA through fused_routed_attention at Wan 720p x
    77f, tile (4, 9, 10): sta_window, and the rule holds for its call."""
    seen = []

    def fake(q, k, v, active, **kw):
        seen.append(dict(d=q.shape[-1], dtype=q.dtype, **kw))
        return torch.zeros_like(q)

    monkeypatch.setitem(routed_fused.WINDOW_DENSE, "sta_window", fake)
    cfg = dataclasses.replace(attention_config("wan-1_3B", (20, 45, 80)), sta_tile=(4, 9, 10))
    assert routed_sta_kernel(cfg, 128, 2) == "sta_window"
    q = torch.zeros((1, 1, cfg.seq_len, 128), dtype=torch.bfloat16)
    ids = torch.tensor([STA])
    routed_fused.fused_routed_attention(q, q, q, ids, cfg, expert_ids_host=ids.numpy())
    assert len(seen) == 1
    call = seen[0]
    assert window_wgmma_path(call["d"], call["latent_shape"], call["tile"], call["window"],
                             dtype=call["dtype"], text_len=0)


def test_hunyuan_joint_sta_expert_at_298_asks_for_the_batched_hopper_path(monkeypatch):
    """The joint STA expert at 720p x 45f, tile (2, 9, 8): one sta_batched
    call over the joint layout with the fast softmax, and the rule holds."""
    seen = []

    def fake(q, k, v, kv_index, kv_count, active, **kw):
        seen.append(dict(d=q.shape[-1], dtype=q.dtype, width=kv_index.shape[2],
                         bits=kw.get("pair_bits") is not None, **kw))
        return torch.zeros_like(q)

    monkeypatch.setattr(joint_experts, "sta_flash_headbatched", fake)
    cfg = dataclasses.replace(attention_config("hunyuan-13B", (12, 45, 80)), sta_tile=(2, 9, 8))
    jcfg = JointConfig(cfg, 256)
    qv = torch.zeros((1, 1, cfg.seq_len, 128), dtype=torch.bfloat16)
    qt = torch.zeros((1, 1, 256, 128), dtype=torch.bfloat16)
    mask = (torch.arange(256) < 83)[None]
    joint_sta_attention(qv, qv, qv, qt, qt, qt, mask, jcfg, torch.ones(1))
    assert len(seen) == 1
    call = seen[0]
    assert call["softmax"] == "fast" and call["bits"]
    assert batched_wgmma_path(call["d"], call["block_q"], call["block_kv"],
                              call["tokens_per_tile"], call["width"], dtype=call["dtype"],
                              softmax=call["softmax"])


def test_routed_wan_sta_batched_passes_the_fast_softmax(monkeypatch):
    """The routed dispatch's sta_batched heads (a tile no window-dense kernel
    takes once sta_pipe's VMEM gate is off) pass softmax="fast" as the JAX
    package's dispatch does."""
    seen = []

    def fake(q, k, v, kv_index, kv_count, active, **kw):
        seen.append(kw)
        return torch.zeros_like(q)

    monkeypatch.setattr(routed_fused, "sta_flash_headbatched", fake)
    monkeypatch.setattr(routed_fused, "supports_pipe", lambda *a, **k: False)  # the VMEM gate
    cfg = AttentionConfig(latent_shape=(4, 4, 8), sta_tile=(2, 2, 2), lowres_window=(2, 2, 2),
                          block_q=16, block_kv=16)
    assert routed_sta_kernel(cfg, 16, 4) == "sta_batched"
    q = torch.zeros((1, 1, cfg.seq_len, 16))
    ids = torch.tensor([STA])
    routed_fused.fused_routed_attention(q, q, q, ids, cfg, expert_ids_host=ids.numpy())
    assert len(seen) == 1 and seen[0]["softmax"] == "fast"
