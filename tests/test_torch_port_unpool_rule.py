"""unpool's batched 16-byte copy on the CPU (``csrc/coreset_pool.cu:
unpool_rows_kernel``): its rule (``ops/coreset_pallas.py:unpool_layout``)
and a mirror, in Python, of the kernel's lane map: each group's source-row
resolution (one pass of shuffles over the lane-held picks, the entries
listed kept rows first, then the unpicked slots by rank) and each lane's
16-byte pieces (a row is D / 8 lanes, 256 / D rows a warp instruction),
centre row read once a group.  The mirror must equal the plain version
``unpool_ref`` bit for bit: in active mode (inactive heads zero) and in
head-map mode (only the mapped heads written), for U = 0 (every slot the
centre's), U = group size - 1 and the served U, at D 64 and 128.  The plain
version is held to the JAX kernel by ``tests/test_torch_port_headmap.py``
and ``tests/test_torch_port_routed.py``; the card tests hold the kernel to
it (``tests/test_torch_port_cuda.py``).  Pure Python."""

import numpy as np
import pytest
import torch

from vorta_tpu_torch.geometry import build_lowres_groups
from vorta_tpu_torch.ops.coreset import geometry_of
from vorta_tpu_torch.ops.coreset_pallas import (
    UNPOOL_STORES,
    _picks_shape,
    head_map_for,
    unpool,
    unpool_layout,
    unpool_ref,
)


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

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("gs", range(1, 33))
def test_unpool_layout_takes_every_group_of_the_kernel(d, gs):
    for kept in range(gs):  # every U the pool can keep: 0 to gs - 1
        rows, stores, loads = unpool_layout(d, gs, kept)
        assert rows == 256 // d  # 16 bytes a lane: a row is d / 8 lanes
        assert stores in UNPOOL_STORES and stores * rows >= gs  # every slot stored
        smaller = [n for n in UNPOOL_STORES if n < stores]
        assert not smaller or smaller[-1] * rows < gs  # the smallest that holds the group
        assert loads in (stores // 2, stores) and loads * rows >= kept  # every kept row read
        assert loads == stores or -(-kept // rows) <= stores // 2


@pytest.mark.parametrize("d,gs,kept", [(32, 12, 5), (256, 12, 5), (128, 0, 0), (128, 33, 5),
                                       (64, 64, 5), (128, 12, 12), (128, 12, -1)])
def test_unpool_layout_refuses_what_the_kernel_does_not_take(d, gs, kept):
    assert unpool_layout(d, gs, kept) is None


def test_unpool_layout_at_the_served_windows():
    """Wan's and HunyuanVideo's low-res window (2, 3, 2): 12 slots, U = 5
    at the served rate; two rows a warp instruction at D = 128, six stores a
    lane in the 8-store kernel, three kept-row loads in its 4-load registers."""
    assert unpool_layout(128, 12, 5) == (2, 8, 4)
    assert unpool_layout(128, 12, 11) == (2, 8, 8)
    assert unpool_layout(64, 12, 5) == (4, 4, 2)


# --- the lane map ---------------------------------------------------------------------------

def _lane_map(pooled, picks, groups, heads, zero_heads=()):
    """The kernel's writes, lane by lane, as an int16 (B, H, S, D) array of
    bf16 bits (rows of unlisted heads left -1): per (batch, head, group) a
    warp resolves the picks, lists its entries and stores 16-byte pieces."""
    b, h, p, d = pooled.shape
    geom = geometry_of(groups)
    t, hh, w = geom.latent_shape
    wt, wh, ww = geom.window
    gs, u_all = groups.group_size, groups.num_kept_margins
    n_g = groups.num_groups
    rows, _, _ = unpool_layout(d, gs, u_all)
    lpr = d // 8
    src = pooled.contiguous().view(torch.int16).numpy().reshape(b, h, p, lpr, 8)
    pk = picks.reshape(b, h, n_g, u_all).numpy()
    out = np.full((b, h, t * hh * w, lpr, 8), -1, np.int16)
    lanes = np.arange(32)
    sub, piece = lanes // lpr, lanes % lpr
    for bi in range(b):
        for hi in heads:
            on = hi not in zero_heads
            u = u_all if on else 0
            for g in range(n_g):
                g2t, g2h, g2w = g // ((hh // wh) * (w // ww)), (g // (w // ww)) % (hh // wh), \
                    g % (w // ww)
                # resolution: lane s finds the kept row naming its slot
                my_pick = np.where(lanes < u, np.pad(pk[bi, hi, g, :u], (0, 32 - u)), -1)
                ki = np.full(32, -1)
                for i in range(u):
                    ki = np.where((my_pick[i] == lanes) & (lanes < gs), i, ki)
                won = np.zeros(32, bool)  # the kept entries that name a slot
                won[ki[ki >= 0]] = True
                unpicked = (lanes < gs) & (ki < 0)
                rank = np.cumsum(unpicked) - unpicked  # popc of the lower lanes' bits
                entry = np.where(ki >= 0, (np.cumsum(won) - won)[np.maximum(ki, 0)],
                                 won.sum() + rank)
                assert sorted(entry[:gs]) == list(range(gs))  # a permutation of the slots
                es = np.full(32, -1)
                es[entry[:gs]] = lanes[:gs]
                centre = src[bi, hi, g]  # one read a group
                for r in range(-(-gs // rows)):
                    e = r * rows + sub  # this instruction's entry of each lane
                    for lane in range(32):
                        if e[lane] >= gs:
                            continue
                        s = es[e[lane]]
                        tok = ((g2t * wt + s // (wh * ww)) * hh + g2h * wh + (s // ww) % wh) * w \
                            + g2w * ww + s % ww
                        if not on:
                            val = np.zeros(8, np.int16)
                        elif e[lane] < u:
                            val = src[bi, hi, n_g + g * u + e[lane], piece[lane]]
                        else:
                            val = centre[piece[lane]]
                        out[bi, hi, tok, piece[lane]] = val
    return out.reshape(b, h, t * hh * w, d)


def _picks(rng, groups, b, h):
    """Random picks: U distinct margin slots a group, as the pool's arg-min
    passes give them (never the centre)."""
    geom = geometry_of(groups)
    u, gs, cs = groups.num_kept_margins, groups.group_size, geom.center_slot
    margins = np.array([s for s in range(gs) if s != cs])
    out = np.stack([rng.permutation(margins)[:u] for _ in range(b * h * groups.num_groups)])
    return torch.from_numpy(out.astype(np.int32)).reshape(_picks_shape(groups, b, h))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rate,u", [(0.5, 5), (0.0, 11), (0.9, 0)])
@pytest.mark.parametrize("mode", ["active", "headmap"])
def test_lane_map_equals_the_plain_version_bitwise(d, rate, u, mode):
    """Window (2, 3, 2) (12 slots) on a (4, 6, 8) grid, 3 heads: U = 5 (the
    served rate), U = 11 (group size - 1) and U = 0 (every slot the centre's
    row, read once)."""
    groups = build_lowres_groups((4, 6, 8), (2, 3, 2), rate)
    assert groups.num_kept_margins == u
    b, h = 2, 3
    rng = np.random.default_rng(20 + u)
    pooled = torch.from_numpy(rng.standard_normal((b, h, groups.pooled_length, d))
                              .astype(np.float32)).to(torch.bfloat16)
    q = torch.zeros((b, h, groups.full_length, d), dtype=torch.bfloat16)
    picks = _picks(rng, groups, b, h)
    if mode == "active":
        active = torch.tensor([1, 0, 1], dtype=torch.int32)
        want = unpool(pooled, q, groups, active=active, picks=picks)
        got = _lane_map(pooled, picks, groups, range(h), zero_heads=(1,))
        heads = list(range(h))
    else:
        hm, n = head_map_for(torch.tensor([0, 1, 1]))
        want = unpool_ref(pooled, q, groups, head_map=hm, num_active=n, picks=picks)
        heads = hm[:n].tolist()
        got = _lane_map(pooled, picks, groups, heads)
        assert (got[:, 0] == -1).all()  # the unmapped head: not written
    want = want.view(torch.int16).numpy()
    assert np.array_equal(got[:, heads], want[:, heads])
    if mode == "active":
        assert not got[:, 1].any()  # the inactive head: zeros


@pytest.mark.parametrize("bad", ["repeated", "outside"])
def test_lane_map_writes_every_slot_once_whatever_the_picks(bad):
    """Picks that no pool writes (a slot named twice, a slot id past the
    group) give unspecified values, but every token of the head is still
    written once, from a row of its own group: no slot left unwritten, no
    write outside the group (the entries stay a permutation)."""
    groups = build_lowres_groups((4, 6, 8), (2, 3, 2), 0.5)
    rng = np.random.default_rng(23)
    pooled = torch.from_numpy(rng.standard_normal((1, 1, groups.pooled_length, 128))
                              .astype(np.float32)).to(torch.bfloat16)
    picks = _picks(rng, groups, 1, 1).reshape(-1, groups.num_kept_margins)
    picks[:, 1] = picks[:, 0] if bad == "repeated" else 40
    got = _lane_map(pooled, picks.reshape(_picks_shape(groups, 1, 1)), groups, [0])
    assert (got != -1).any(-1).all()  # every token written


def test_profiles_group_both_unpool_kernels():
    """``cli/profile_forward.py`` counts the batched copy and the first
    design's kernel in one "unpool" group (§5 of PERF.md reads it)."""
    from vorta_tpu_torch.cli.profile_forward import _group

    assert _group("void (anonymous namespace)::unpool_rows_kernel<128, 8>(...)") == "unpool"
    assert _group("void (anonymous namespace)::unpool_kernel<128>(...)") == "unpool"
    assert _group("void (anonymous namespace)::pool_kernel<128>(...)") == "pool_qkv"
