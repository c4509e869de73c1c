"""sta_pipe's Hopper path on the CPU: its rule (``ops/sta_pipe.py:
sta_wgmma_path``), its slot table (``window_walk``, ``walk_box``) and the
norm kernel's layout rule (``ops/fused_norm.py:norm_layout``), all pure
Python.  The served geometries take the new path (Wan 480p x 77f at tile
(4, 6, 4), Wan 720p at (5, 9, 8), HunyuanVideo 45f at (6, 9, 8) with its
256-key text tail), through the routed Wan dispatch and the Hunyuan joint
STA expert (spied: the calls' arguments meet the rule), while the int8 QK
mode, the stable softmax, the variants, D = 64 and windows whose runs
cannot land on 8-row multiples stay on the mma.sync kernel.  The table
covers every window key exactly once, in the plain version's order, each
box on a multiple of 8 slot rows, with the text slots last.  The card tests
(``tests/test_torch_port_cuda.py``) hold the kernels to their plain
versions."""

import dataclasses

import numpy as np
import pytest
import torch

from vorta_tpu_torch.cli.sample import attention_config
from vorta_tpu_torch.ops import joint_experts, routed_fused
from vorta_tpu_torch.ops.experts import STA
from vorta_tpu_torch.ops.fused_norm import norm_layout
from vorta_tpu_torch.ops.joint_experts import JointConfig, joint_sta_attention, joint_sta_kernel
from vorta_tpu_torch.ops.sta_pipe import (
    WALK_BN,
    WALK_COLS,
    WALK_MAX_SLOTS,
    _window_keys,
    sta_wgmma_path,
    walk_box,
    window_walk,
)

W3 = (3, 3, 3)
SERVED = {  # name: (grid, tile, text_len, slots)
    "wan_480p_77f": ((20, 30, 52), (4, 6, 4), 0, 22),
    "wan_720p_77f": ((20, 45, 80), (5, 9, 8), 0, 81),
    "hunyuan_45f": ((12, 45, 80), (6, 9, 8), 256, 65 + 2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the rule -----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SERVED))
def test_served_geometries_take_the_hopper_path(name):
    grid, tile, _, _ = SERVED[name]
    assert sta_wgmma_path(128, grid, tile, W3)


@pytest.mark.parametrize("change", [
    dict(d=64), dict(dtype=torch.float32), dict(softmax="stable"), dict(variant="dots"),
    dict(variant="qk"), dict(variant="sT"), dict(qk_int8=True),
])
def test_each_condition_of_the_rule_sends_the_call_to_mma_sync(change):
    """The 720p call meets every condition; each one broken alone leaves it."""
    kw = dict(d=128, dtype=torch.bfloat16, softmax="fast", variant="full", qk_int8=False)
    kw.update(change)
    d = kw.pop("d")
    assert sta_wgmma_path(128, (20, 45, 80), (5, 9, 8), W3)
    assert not sta_wgmma_path(d, (20, 45, 80), (5, 9, 8), W3, **kw)


@pytest.mark.parametrize("grid,tile,window,box", [
    ((20, 45, 80), (5, 9, 8), W3, (24, 1)),     # runs of 24: one a box, 5 a slot
    ((20, 30, 52), (4, 6, 4), W3, (12, 2)),     # runs of 12: two a box
    ((4, 6, 16), (2, 3, 8), W3, (16, 2)),       # the window spans t and h whole
    ((4, 6, 16), (4, 6, 8), W3, (16, 2)),       # the joint card tests' geometry
    ((8, 6, 20), (2, 3, 4), W3, (12, 2)),
    ((6, 9, 16), (6, 9, 8), W3, (16, 1)),       # chip_smoke's Hunyuan model check
    ((8, 6, 30), (2, 3, 6), W3, None),          # runs of 18 over 6 rows: no box lands
    ((4, 8, 8), (2, 2, 2), (3, 3, 1), None),    # wan-tiny: runs of 2 over 6 rows
    ((4, 4, 4), (2, 2, 2), (3, 3, 1), (2, 4)),  # runs of 2, 4 a box
    ((4, 6, 192), (2, 3, 64), W3, None),        # runs of 192: longer than a slot
])
def test_the_box_rule(grid, tile, window, box):
    assert walk_box(grid, tile, window) == box
    assert sta_wgmma_path(128, grid, tile, window) is (box is not None)
    if box is None:
        with pytest.raises(ValueError, match="8-row"):
            window_walk(grid, tile, window)


def test_a_table_past_the_shared_memory_stays_on_mma_sync():
    """Tiles of 2,048 tokens: a 55,296-key window in 576 slots of 96 keys,
    more than the kernel's shared memory holds (``WALK_MAX_SLOTS``); a text
    tail's slots count too."""
    grid, tile = (24, 48, 48), (8, 16, 16)
    assert walk_box(grid, tile, W3) == (48, 2)
    assert window_walk(grid, tile, W3).shape[0] == 576 > WALK_MAX_SLOTS
    assert not sta_wgmma_path(128, grid, tile, W3)
    small = (12, 45, 80), (6, 9, 8)  # 65 window slots
    assert sta_wgmma_path(128, *small, W3, text_len=256)
    assert not sta_wgmma_path(128, *small, W3, text_len=128 * (WALK_MAX_SLOTS - 64))


# --- the walk table ----------------------------------------------------------------

def _tile_keys(grid, tile, window, q_tile):
    """The raster keys the table gives q tile ``q_tile`` (window slots in
    order, without the masked rows), from its clamped window origin."""
    _, hh, w = grid
    bw, hb = walk_box(grid, tile, window)
    origin = _window_keys(grid, tile, window)[q_tile, 0]  # the box's first raster key
    keys = []
    for row in window_walk(grid, tile, window):
        if row[1] >= 0:
            continue
        n = row[2]
        assert row[0] == n * bw * hb
        for i in range(n):
            dt, dh = int(row[4 + 2 * i]), int(row[5 + 2 * i])
            for hr in range(hb):
                keys.extend(origin + (dt * hh + dh + hr) * w + np.arange(bw))
    return np.asarray(keys)


@pytest.mark.parametrize("name", sorted(SERVED))
def test_walk_table_at_the_served_geometries(name):
    grid, tile, text_len, slots = SERVED[name]
    walk = window_walk(grid, tile, W3, text_len)
    assert walk.shape == (slots, WALK_COLS) and walk.dtype == np.int32
    bw, hb = walk_box(grid, tile, W3)
    tokens = bw * hb
    window = walk[walk[:, 1] < 0]
    text = walk[walk[:, 1] >= 0]
    # text slots come last, 128 keys each, the last cut at text_len % 128
    assert (walk[:len(window), 1] < 0).all() and (walk[len(window):, 1] >= 0).all()
    assert list(text[:, 1]) == list(range(0, text_len, WALK_BN))
    assert text[:, 0].sum() == text_len and (text[:, 2] == 0).all()
    # every box on a multiple of 8 slot rows, and the slots within 128 keys
    assert tokens % 8 == 0 and (window[:, 0] <= WALK_BN).all()
    assert (window[:, 2] * tokens == window[:, 0]).all()
    assert window[:, 0].sum() == int(np.prod([min(3, grid[a] // tile[a]) * tile[a]
                                              for a in range(3)]))
    # unused box entries are zero
    for row in window:
        assert not row[4 + 2 * row[2]:].any()


@pytest.mark.parametrize("grid,tile", [
    ((20, 30, 52), (4, 6, 4)), ((20, 45, 80), (5, 9, 8)), ((12, 45, 80), (6, 9, 8)),
    ((4, 6, 16), (2, 3, 8)),
])
def test_walk_covers_each_window_key_once_at_clamped_edges(grid, tile):
    """At the first, last and corner q tiles (windows clamped at the grid's
    edges) and one inside, the table's keys are the plain version's window
    keys, each once, in its order."""
    want = _window_keys(grid, tile, W3)
    n = want.shape[0]
    nh, nw = grid[1] // tile[1], grid[2] // tile[2]
    for q_tile in sorted({0, n - 1, nw - 1, (nh - 1) * nw, n // 2}):
        got = _tile_keys(grid, tile, W3, q_tile)
        assert len(np.unique(got)) == len(got) == want.shape[1]
        assert (got == want[q_tile]).all(), q_tile


def test_walk_table_is_cached_and_read_only():
    a = window_walk((20, 45, 80), (5, 9, 8), W3)
    assert a is window_walk((20, 45, 80), (5, 9, 8), W3)
    with pytest.raises(ValueError):
        a[0, 0] = 1


# --- the served dispatches ask for the new path -------------------------------------

@pytest.fixture
def spy_sta(monkeypatch):
    """Record the arguments of every sta_pipe call the dispatches make; the
    attention itself returns zeros of q's shape."""
    seen = []

    def fake(q, k, v, active, **kw):
        seen.append(dict(d=q.shape[-1], dtype=q.dtype, **kw))
        return torch.zeros_like(q)

    monkeypatch.setitem(routed_fused.WINDOW_DENSE, "sta_pipe", fake)
    return seen


def _rule(call):
    text_k = call.get("text_k")
    return sta_wgmma_path(call["d"], call["latent_shape"], call["tile"], call["window"],
                          dtype=call["dtype"], softmax=call.get("softmax", "fast"),
                          variant=call.get("variant", "full"),
                          qk_int8=call.get("qk_scale") is not None,
                          text_len=0 if text_k is None else text_k.shape[2])


@pytest.mark.parametrize("name,grid,tile", [
    ("480p_77f", (20, 30, 52), (4, 6, 4)), ("720p_77f", (20, 45, 80), (5, 9, 8)),
])
@pytest.mark.parametrize("qk_int8", [False, True])
def test_routed_wan_dispatch_asks_for_the_hopper_path(name, grid, tile, qk_int8, spy_sta):
    """One head routed to STA through fused_routed_attention (bf16 q, as the
    model runs on the card); under qk_int8 the STA heads stay bf16, as in
    the JAX package, so they take the new path too."""
    cfg = dataclasses.replace(attention_config("wan-1_3B", grid), sta_tile=tile, qk_int8=qk_int8)
    q = torch.zeros((1, 1, cfg.seq_len, 128), dtype=torch.bfloat16)
    ids = torch.tensor([STA])
    routed_fused.fused_routed_attention(q, q, q, ids, cfg, expert_ids_host=ids.numpy())
    assert len(spy_sta) == 1 and _rule(spy_sta[0]), spy_sta


def test_hunyuan_joint_sta_expert_asks_for_the_hopper_path(spy_sta, monkeypatch):
    """The joint STA expert at 720p x 45f: sta_pipe with the 256-key text
    tail (its text rows go to flash_manual, spied off here)."""
    monkeypatch.setattr(joint_experts, "_flash", lambda q, *a, **kw: torch.zeros_like(q))
    cfg = attention_config("hunyuan-13B", (12, 45, 80))
    jcfg = JointConfig(cfg, 256)
    assert joint_sta_kernel(jcfg, 128, 2) == "sta_pipe"
    qv = torch.zeros((1, 1, cfg.seq_len, 128), dtype=torch.bfloat16)
    qt = torch.zeros((1, 1, 256, 128), dtype=torch.bfloat16)
    mask = (torch.arange(256) < 83)[None]
    joint_sta_attention(qv, qv, qv, qt, qt, qt, mask, jcfg, torch.ones(1))
    assert len(spy_sta) == 1 and spy_sta[0]["text_k"].shape[2] == 256
    assert _rule(spy_sta[0])
    assert window_walk(cfg.latent_shape, cfg.sta_tile, cfg.sta_window, 256).shape[0] == 67


@pytest.mark.parametrize("extra", [
    dict(qk_scale=torch.ones(12)), dict(softmax="stable"), dict(variant="dots"),
    dict(variant="qk"), dict(variant="sT"),
])
def test_int8_stable_and_variant_calls_stay_on_mma_sync(extra):
    call = dict(d=128, dtype=torch.int8 if "qk_scale" in extra else torch.bfloat16,
                latent_shape=(20, 45, 80), tile=(5, 9, 8), window=W3, **extra)
    assert not _rule(call)


# --- the norm kernel's layout --------------------------------------------------------

@pytest.mark.parametrize("dim,layout", [
    (1536, (1, 6)),     # Wan-1.3B: one warp a row, 6 chunks of 8 a lane
    (3072, (1, 12)),    # HunyuanVideo-13B
    (5120, (2, 10)),    # Wan-14B: 160 f32 a lane on one warp, so two warps
    (2304, (1, 9)),
    (6144, (2, 12)),
    (7168, (4, 7)),
    (12288, (4, 12)),
    (1000, None),       # not a multiple of 256: the block-per-row kernel
    (128, None),        # the tiny test models
    (64, None),
    (3328, None),       # 13 chunks, and 2 or 4 warps do not divide it
])
def test_norm_layout_rule(dim, layout):
    assert norm_layout(dim) == layout
    if layout is not None:
        wpr, ch = layout
        assert dim == 256 * wpr * ch and ch <= 12
