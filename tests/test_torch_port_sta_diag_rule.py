"""The STA bisection tool's Hopper path on the CPU (``vorta_tpu_torch/tools/
sta_diag.py``): its rule (``diag_wgmma_path``), its chunk-aligned walk
(``diag_walk``: every slot within one chunk, each chunk's keys once,
chain-major, each slot's chain its chunk's parity), and a mirror, in
Python, of the kernel's reduction over that walk: chain 0's slots then
chain 1's, an online softmax per chain over 128-key slots with P rounded to
bf16, chain 0's finished output stashed as bf16, the two chains summed
without a common max (``dots_only``: one sum of p = bf16(s * 1e-3)).  The
mirror must equal the plain version ``sta_diag_ref``: in f32 with no
rounding within 1e-5 of max(|plain|, RMS(plain)) per element (the two sum
in different orders), and on bf16 inputs with its roundings within the
card's gate, 2^-5 of the same floor (the two round P to bf16 against
different maxima, the running one and the chain's: up to 1.4% of the floor
at these shapes).  At a geometry whose chunks span several slots, the last
partly filled, it must also equal the JAX tool's kernel (``tools/
sta_diag.py:_kernel``, interpret mode, f32, no rounding in the mirror)
within rtol 1e-4 and 1e-4 x its max.  ``tests/test_torch_port_sta_diag.py``
holds the plain variants to the JAX kernel; the card tests
(``tests/test_torch_port_cuda.py``) hold the kernel to the plain version."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vorta_tpu.ops.sta_window import window_starts as jax_window_starts
from vorta_tpu_torch.geometry import window_starts
from vorta_tpu_torch.ops.flash import LOG2E
from vorta_tpu_torch.ops.layout import tile_sequence, untile_sequence
from vorta_tpu_torch.ops.sta_pipe import WALK_BN, WALK_MAX_SLOTS
from vorta_tpu_torch.tools.sta_diag import (
    DIAG_MAX_SLOTS,
    _geometry,
    diag_box,
    diag_walk,
    diag_wgmma_path,
    sta_diag_attention,
    sta_diag_ref,
)

W3 = (3, 3, 3)
DEFAULT = ((20, 45, 80), (5, 9, 8), W3)  # the tool's default: Wan 720p
MULTI = ((6, 6, 40), (2, 3, 8), W3)  # chunks of 6 runs of 24: a slot of 5, one of 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the walk -------------------------------------------------------------------------------

def _slot_keys(walk, latent, tile, window):
    """Each slot's keys as (dt, dh, w) offsets from the window origin, and
    the chunk of each slot (None where its boxes span two)."""
    bw, hb = diag_box(latent, tile, window)
    tt, th, _ = tile
    win, _, _ = _geometry(latent, tile, window)
    keys, chunks = [], []
    for row in walk:
        nvalid, text, n, chain = row[:4]
        assert text == -1 and nvalid == n * bw * hb <= WALK_BN
        boxes = row[4:4 + 2 * n].reshape(n, 2)
        keys.append([(dt, dh + r, x) for dt, dh in boxes for r in range(hb) for x in range(bw)])
        owners = {(dt // tt) * win[1] + (dh // th) for dt, dh in boxes}
        chunks.append(owners.pop() if len(owners) == 1 else None)
    return keys, chunks


@pytest.mark.parametrize("latent,tile,window", [
    DEFAULT, MULTI,
    ((4, 6, 16), (2, 3, 8), W3),      # one slot a chunk, whole-axis windows
    ((10, 18, 40), (5, 9, 8), W3),    # the tool's tile, clamped windows
    ((8, 12, 32), (4, 6, 8), (3, 1, 3)),  # one tile row a window: chain 1 is empty on a side
    ((8, 18, 48), (2, 9, 16), W3),    # runs of 48, two a slot
])
def test_diag_walk_covers_each_chunk_once_chain_major(latent, tile, window):
    walk = diag_walk(latent, tile, window)
    win, n_chunks, ck = _geometry(latent, tile, window)
    tt, th, tw = tile
    keys, chunks = _slot_keys(walk, latent, tile, window)
    assert None not in chunks  # no slot spans two chunks
    assert list(walk[:, 3]) == [j % 2 for j in chunks]  # each slot's chain: its chunk's parity
    # chain-major, chunks in order within a chain, a chunk's slots consecutive
    order = [j for i, j in enumerate(chunks) if i == 0 or chunks[i - 1] != j]
    assert order == [*range(0, n_chunks, 2), *range(1, n_chunks, 2)]
    for j in range(n_chunks):
        ct, ch = divmod(j, win[1])
        got = sorted(k for s, c in zip(keys, chunks) if c == j for k in s)
        want = sorted((ct * tt + a, ch * th + r, x) for a in range(tt) for r in range(th)
                      for x in range(win[2] * tw))
        assert got == want and len(got) == ck  # each of the chunk's keys exactly once


def test_diag_walk_at_the_tool_default():
    """81 slots of 120 keys (5 runs of 24 a slot, 9 slots a chunk of 45
    runs), as sta_pipe's walk has; chain 0 holds the 5 even chunks' 45 slots."""
    walk = diag_walk(*DEFAULT)
    assert diag_box(*DEFAULT) == (24, 1)
    assert walk.shape[0] == 81 and (walk[:, 0] == 120).all() and (walk[:, 2] == 5).all()
    assert list(walk[:, 3]) == [0] * 45 + [1] * 36


def test_diag_walk_where_a_chunk_spans_slots_the_last_partly_filled():
    walk = diag_walk(*MULTI)
    _, n_chunks, ck = _geometry(*MULTI)
    assert (n_chunks, ck) == (6, 144)
    assert list(walk[:, 0]) == [120, 24] * 6  # 6 runs a chunk: 5 in a slot, then 1
    assert list(walk[:, 3]) == [0] * 6 + [1] * 6


# --- the rule -------------------------------------------------------------------------------

@pytest.mark.parametrize("latent,tile,window", [
    DEFAULT, MULTI, ((4, 6, 16), (2, 3, 8), W3), ((10, 18, 40), (5, 9, 8), W3),
    ((12, 45, 80), (6, 9, 8), W3),  # HunyuanVideo 45f's tile
    ((20, 30, 52), (4, 6, 4), W3),  # Wan 480p's tile: runs of 12, two a box
])
def test_the_diag_rule_takes_the_tool_and_served_geometries(latent, tile, window):
    assert diag_wgmma_path(128, latent, tile, window)
    bw, hb = diag_box(latent, tile, window)
    assert tile[1] % hb == 0 and (bw * hb) % 8 == 0 and bw * hb <= WALK_BN


@pytest.mark.parametrize("change", ["d64", "f32", "no_box", "many_slots"])
def test_each_condition_of_the_diag_rule_sends_the_call_to_mma_sync(change):
    """D = 64 (``ROADMAP.md`` section 2 B), f32, runs of 9 tokens (no box
    of a chunk's runs lands on 8 rows), a walk past the shared memory left
    beside the stash (270 slots: within sta_pipe's ``WALK_MAX_SLOTS``)."""
    (latent, tile, window), kw, d = DEFAULT, {}, 128
    if change == "d64":
        d = 64
    elif change == "f32":
        kw = dict(dtype=torch.float32)
    elif change == "no_box":
        latent, tile = (4, 6, 9), (2, 3, 3)
        assert diag_box(latent, tile, window) is None
    else:
        latent, window = (30, 45, 80), (6, 5, 3)
        assert DIAG_MAX_SLOTS < diag_walk(latent, tile, window).shape[0] <= WALK_MAX_SLOTS
    assert not diag_wgmma_path(d, latent, tile, window, **kw)


# --- the reduction ----------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _mirror(q, k, v, latent, tile, window, variant, rounding=True):
    """The kernel's reduction over ``diag_walk`` (``rounding``: P and the
    stash rounded to bf16, as on the card), f32 arithmetic, all q tiles and
    heads at once; its output in f32."""
    b, h, s, d = q.shape
    walk = diag_walk(latent, tile, window)
    bw, hb = diag_box(latent, tile, window)
    t_, hh, w = latent
    st = window_starts(latent, tile, window).astype(np.int64)  # (n_tiles, 3) token starts
    n_tiles = st.shape[0]
    sl = d**-0.5 * LOG2E
    rnd = _bf16 if rounding else (lambda x: x)
    tq = tile_sequence(q, latent, tile).reshape(b, h, n_tiles, -1, d).float()
    acc = torch.zeros(tq.shape)
    m = torch.full(tq.shape[:-1] + (1,), -1e30)
    l = torch.zeros(m.shape)
    stash = l_stash = None
    for row in walk:
        nvalid, _, n, chain = row[:4]
        boxes = row[4:4 + 2 * n].reshape(n, 2)
        off = np.array([((dt * hh + dh + r) * w + x) for dt, dh in boxes for r in range(hb)
                        for x in range(bw)])
        idx = torch.from_numpy((st[:, 0] * hh + st[:, 1]) * w + st[:, 2])[:, None] + \
            torch.from_numpy(off)[None]
        kc, vc = k[:, :, idx].float(), v[:, :, idx].float()  # (B, H, n_tiles, nvalid, D)
        sc = torch.einsum("bhcqd,bhckd->bhcqk", tq, kc) * sl
        if variant == "dots_only":
            acc = acc + torch.einsum("bhcqk,bhckd->bhcqd", rnd(sc * 1e-3), vc)
            continue
        if chain == 1 and stash is None:  # chain 1 starts: chain 0's O to the stash
            stash, l_stash = rnd(acc), l
            acc, m, l = torch.zeros(acc.shape), torch.full(m.shape, -1e30), torch.zeros(l.shape)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhcqk,bhckd->bhcqd", rnd(p), vc)
        m = m_new
    if stash is not None:
        acc, l = acc + stash, l + l_stash
    out = acc / torch.where(l == 0, 1.0, l) if variant != "dots_only" else acc
    return untile_sequence(out.reshape(b, h, s, d), latent, tile)


def _rel(got, want):
    floor = torch.maximum(want.abs(), want.pow(2).mean().sqrt())
    return ((got - want).abs() / floor).max().item()


@pytest.mark.parametrize("latent,tile,window", [MULTI, ((10, 18, 40), (5, 9, 8), W3)])
@pytest.mark.parametrize("variant", ["full", "dots_only"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-5)])
def test_the_reduction_over_the_walk_equals_the_plain_version(latent, tile, window, variant,
                                                              dtype, tol):
    rng = np.random.default_rng(31)
    s = int(np.prod(latent))
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, s, 128)).astype(np.float32))
               .to(dtype) for _ in range(3))
    want = sta_diag_ref(q, k, v, latent_shape=latent, tile=tile, window=window,
                        variant=variant).float()
    got = _mirror(q, k, v, latent, tile, window, variant, rounding=dtype == torch.bfloat16)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= tol
    # the wrapper on CPU tensors is the plain version, whatever the rule says
    assert torch.equal(sta_diag_attention(q, k, v, latent_shape=latent, tile=tile,
                                          window=window, variant=variant).float(), want)


def _jax_full(latent, tile, window, q, k, v):
    """tools/sta_diag.py:run's ``call`` of the ``full`` variant, in interpret mode."""
    path = Path(__file__).resolve().parent.parent / "tools" / "sta_diag.py"
    spec = importlib.util.spec_from_file_location("jax_sta_diag_rule", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    t, hh, w = latent
    tt, th, tw = tile
    nt, nh, nw = t // tt, hh // th, w // tw
    win_eff = (min(window[0], nt), min(window[1], nh), min(window[2], nw))
    bw, tpt = win_eff[2] * tw, tt * th * tw
    b, h, _, d = q.shape
    starts = jnp.asarray(jax_window_starts(latent, tile, window))
    kernel = functools.partial(tool._kernel, tile=tile, win_eff=win_eff, variant="full",
                               scale=d**-0.5)

    def q_map(bb, gg, ii, *r):
        ti = ii // (nh * nw)
        rem = ii - ti * (nh * nw)
        return (bb, gg, ti, rem // nw, rem - (rem // nw) * nw, 0)

    shape6 = (b, h, t, hh, w, d)
    out6 = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(b, h, nt * nh * nw),
            in_specs=[pl.BlockSpec((1, 1, tt, th, tw, d), q_map),
                      pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((1, 1, tt, th, tw, d), q_map),
            scratch_shapes=[
                pltpu.VMEM((2, tpt, 1), jnp.float32), pltpu.VMEM((2, tpt, 1), jnp.float32),
                pltpu.VMEM((2, tpt, d), jnp.float32),
                pltpu.VMEM((4, tt, th, bw, d), k.dtype), pltpu.VMEM((4, tt, th, bw, d), v.dtype),
                pltpu.SemaphoreType.DMA((4, 2)),
            ]),
        out_shape=jax.ShapeDtypeStruct(shape6, q.dtype),
        interpret=True,
    )(starts, *(x.reshape(shape6) for x in (q, k, v)))
    return np.asarray(out6.reshape(q.shape))


def test_the_reduction_over_a_multi_slot_walk_equals_the_jax_kernel():
    latent, tile, window = MULTI
    rng = np.random.default_rng(32)
    s = int(np.prod(latent))
    q, k, v = (rng.standard_normal((1, 1, s, 64)).astype(np.float32) for _ in range(3))
    want = _jax_full(latent, tile, window, *(jnp.asarray(x) for x in (q, k, v)))
    got = _mirror(*map(torch.from_numpy, (q, k, v)), latent, tile, window, "full",
                  rounding=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
