"""sta_row's Hopper path on the CPU: its rule (``ops/sta_row.py:
row_wgmma_path``), the slot walk it shares with sta_window
(``ops/sta_pipe.py:window_walk`` over ``walk_box``: tile_w % 8 == 0 makes
every run a multiple of 8 tokens, so its boxes are never padded) expanded
to each q tile's window keys, the launch order that makes the q tiles of
one (t, h) row adjacent CTAs, the wrapper's choice spied on meta tensors,
and the JAX package's gates pinned over the served geometries: wherever
sta_row's row-dense gate admits a geometry, sta_pipe's does too, so no
served path reaches sta_row.  All pure Python; the card tests
(``tests/test_torch_port_cuda.py``) hold the kernel to its plain version
and its mma.sync kernel."""

import collections

import numpy as np
import pytest
import torch

from vorta_tpu.ops import sta_pipe as jsta_pipe
from vorta_tpu.ops.sta_row import supports_row_dense as jax_supports_row_dense
from vorta_tpu.ops.sta_window import prefer_window_dense as jax_prefer_window_dense
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.ops import sta_row
from vorta_tpu_torch.ops.routed_fused import routed_sta_kernel
from vorta_tpu_torch.ops.sta_pipe import (
    WALK_BN,
    WALK_MAX_SLOTS,
    _extent,
    _window_keys,
    supports_pipe,
    walk_box,
    window_walk,
)
from vorta_tpu_torch.ops.sta_row import row_wgmma_path, supports_row_dense

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


# --- the rule -------------------------------------------------------------------------------

@pytest.mark.parametrize("grid,tile,window,text_len,box", [
    ((20, 45, 80), (5, 9, 8), W3, 0, (24, 1)),      # Wan 720p x 77f: runs of 24, 5 a slot
    ((12, 45, 80), (6, 9, 8), W3, 256, (24, 1)),    # HunyuanVideo 45f + its text tail
    ((20, 30, 52), (4, 6, 8), W3, 0, None),         # 52 / 8 does not divide: no row-dense tile
    ((8, 6, 48), (2, 3, 16), W3, 0, (48, 2)),       # runs of 48, two a box
    ((4, 6, 32), (2, 3, 8), W3, 24, (24, 1)),
])
def test_the_row_rule_at_served_and_test_geometries(grid, tile, window, text_len, box):
    if box is None:
        assert not supports_row_dense(grid, tile, 128)
        return
    assert walk_box(grid, tile, window) == box
    assert row_wgmma_path(128, grid, tile, window, text_len=text_len)


@pytest.mark.parametrize("change", ["d64", "f32", "text83", "wide_run", "many_slots"])
def test_each_condition_of_the_row_rule_sends_the_call_to_mma_sync(change):
    """D = 64 (``ROADMAP.md`` section 2 B item 4), f32, a text tail that is
    not a multiple of 8 keys, runs of 3 x 48 = 144 tokens (past one
    128-key slot: no box), a slot table past the shared memory."""
    grid, tile, window, kw, d = (20, 45, 80), (5, 9, 8), W3, {}, 128
    if change == "d64":
        d = 64
    elif change == "f32":
        kw = dict(dtype=torch.float32)
    elif change == "text83":
        kw = dict(text_len=83)
    elif change == "wide_run":
        grid, tile = (8, 6, 144), (2, 3, 48)
        assert walk_box(grid, tile, window) is None
    else:
        grid, tile, window = (50, 75, 16), (10, 15, 8), (5, 5, 3)
        assert window_walk(grid, tile, window, 0, walk_box(grid, tile, window)).shape[0] > \
            WALK_MAX_SLOTS
    assert row_wgmma_path(128, (20, 45, 80), (5, 9, 8))
    assert not row_wgmma_path(d, grid, tile, window, **kw)


# --- the walk and the launch order -------------------------------------------------------------

def _walk_keys(grid, tile, q_tile, text_len=0):
    """The keys sta_row's Hopper path attends for q tile ``q_tile``: each
    window slot's boxes, run by run (no padding), then the text keys."""
    _, hh, w = grid
    box_w, box_h = walk_box(grid, tile, W3)
    assert box_w == _extent(grid, tile, W3)[2] and box_w % 8 == 0
    walk = window_walk(grid, tile, W3, text_len, (box_w, box_h))
    origin = _window_keys(grid, tile, W3)[q_tile, 0]
    keys, text = [], []
    for row in walk:
        if row[1] >= 0:  # a text slot
            text.extend(range(row[1], row[1] + row[0]))
            continue
        assert row[0] == row[2] * box_w * box_h and row[0] <= WALK_BN
        for i in range(row[2]):
            dt, dh = int(row[4 + 2 * i]), int(row[5 + 2 * i])
            for hr in range(box_h):
                keys.extend(origin + (dt * hh + dh + hr) * w + np.arange(box_w))
    return np.asarray(keys), text


@pytest.mark.parametrize("grid,tile,text_len", [
    ((20, 45, 80), (5, 9, 8), 0), ((12, 45, 80), (6, 9, 8), 256), ((10, 18, 32), (5, 9, 8), 0),
    ((8, 6, 48), (2, 3, 16), 24),
])
def test_row_walk_covers_each_window_key_once(grid, tile, text_len):
    """At the grid's corners and edges (windows clamped) and inside: each
    (q tile, window key) pair once, in the plain version's order, then
    every text key once."""
    want = _window_keys(grid, tile, W3)
    n = want.shape[0]
    nh, nw = grid[1] // tile[1], grid[2] // tile[2]
    for q_tile in sorted({0, n - 1, nw - 1, (nh - 1) * nw, n // 2, nw // 2}):
        got, text = _walk_keys(grid, tile, q_tile, text_len)
        assert len(np.unique(got)) == len(got) == want.shape[1]
        assert (got == want[q_tile]).all(), q_tile
        assert text == list(range(text_len))


@pytest.mark.parametrize("grid,tile", [((20, 45, 80), (5, 9, 8)), ((12, 45, 80), (6, 9, 8))])
def test_the_q_tiles_of_a_row_are_adjacent_ctas(grid, tile):
    """The TPU kernel's row-dense sharing as a launch order: the window
    kernel's CTA x (csrc/sta_window_src.cuh: ``WindowSource::tile`` /
    ``row0``, its grid in ``launch_window``) is (tile, 128-row chunk) with
    the tile's w index fastest, so each (t, h) row of q tiles holds one run
    of nw * chunks adjacent CTAs, and the row's K / V lines are read from
    L2 after its first CTAs."""
    nt, nh, nw = (grid[a] // tile[a] for a in range(3))
    chunks = -(-int(np.prod(tile)) // 128)
    x = np.arange(nt * nh * nw * chunks)
    tl = x // chunks
    row = (tl // (nh * nw)) * nh + (tl // nw) % nh
    assert (np.diff(row) >= 0).all()
    assert (np.bincount(row) == nw * chunks).all()


# --- the wrapper's choice, spied -----------------------------------------------------------------

@pytest.mark.parametrize("d,fn,hopper", [
    (128, "sta_row_attention", True),
    (128, "sta_row_attention_mma_sync", False),
    (64, "sta_row_attention", False),
])
def test_the_wrapper_passes_the_rules_box(monkeypatch, d, fn, hopper):
    """Meta tensors stand for CUDA ones: the wrapper hands the launcher
    ``walk_box``'s box where the rule holds, no box (its mma.sync kernel)
    for D = 64 and for the yardstick."""
    seen = []

    def spy(kernel, q, k, v, active, *, box, **kw):
        seen.append((kernel, box, kw["text_k"] is not None))
        return torch.empty_like(q)

    monkeypatch.setattr(sta_row, "launch_window_dense", spy)
    grid, tile = (12, 45, 80), (6, 9, 8)
    q = torch.empty((1, 2, int(np.prod(grid)), d), dtype=torch.bfloat16, device="meta")
    t = torch.empty((1, 2, 256, d), dtype=torch.bfloat16, device="meta")
    getattr(sta_row, fn)(q, q, q, torch.ones(2), latent_shape=grid, tile=tile, text_k=t,
                         text_v=t, text_bias=torch.zeros((1, 256), device="meta"))
    assert seen == [("sta_row", walk_box(grid, tile, W3) if hopper else None, True)]


# --- the gates over the served geometries -------------------------------------------------------

# latent grids: Wan 480p and 720p at 77 and 81 frames, HunyuanVideo 720p at 45,
# 117 and 129 frames; tiles t 1-10, h 1-15, w in {4, 8, 10, 16, 20, 40}; text
# tails of 0 and 256 keys
SERVED_GRIDS = ((20, 30, 52), (21, 30, 52), (20, 45, 80), (21, 45, 80), (12, 45, 80),
                (30, 45, 80), (33, 45, 80))
TILE_W = (4, 8, 10, 16, 20, 40)


def _jax_choice(shape, tile, text_len):
    """The JAX package's routed choice by its own gates, in its order."""
    if jsta_pipe.supports_pipe(shape, tile, 128, 2, text_len=text_len, window=W3):
        return "sta_pipe"
    if not jax_prefer_window_dense(shape, tile):
        return "sta_batched"
    if jax_supports_row_dense(shape, tile, 128, 2, text_len=text_len, window=W3):
        return "sta_row"
    return "sta_window"


def test_no_served_geometry_reaches_sta_row():
    """Over the scan the port's gates choose as the JAX package's, sta_pipe
    fits wherever sta_row does, and sta_row is never chosen; the counts of
    each choice are pinned, so a change to a gate shows."""
    counts = collections.Counter()
    row_dense = 0
    for grid in SERVED_GRIDS:
        for text_len in (0, 256):
            for tt in range(1, 11):
                for th in range(1, 16):
                    for tw in TILE_W:
                        tile = (tt, th, tw)
                        cfg = AttentionConfig(latent_shape=grid, sta_tile=tile, sta_window=W3,
                                              lowres_window=(2, 3, 2))
                        got = routed_sta_kernel(cfg, 128, 2, text_len=text_len)
                        assert got == _jax_choice(grid, tile, text_len), (grid, tile, text_len)
                        counts[got] += 1
                        if supports_row_dense(grid, tile, 128, 2, text_len=text_len):
                            row_dense += 1
                            assert supports_pipe(grid, tile, 128, 2, text_len=text_len)
    assert counts == {"sta_batched": 11332, "sta_pipe": 1124, "sta_window": 144}
    assert row_dense == 550
