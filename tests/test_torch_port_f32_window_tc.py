"""The f32 window walks on the tensor cores (``csrc/window_walk_f32_tc.cuh``:
3xTF32 on wgmma over q, k and V^T gathered into tile-major order) on the
CPU: the rule ``ops/sta_pipe.py:sta_f32_tc_path`` (sta_pipe's and
sta_window's) at every f32 window call of the served
paths (the routed 480p x 77f STA call at tile (4, 6, 4), the --resume_dir
(4, 9, 10) calls at 720p x 29f and 77f, HunyuanVideo's (6, 9, 8) text tail
and (4, 9, 10) with 256 text keys, on meta tensors); on a fake card (meta
tensors stand for CUDA ones; the library's entries record their arguments
and return success) the wrappers' entry, scratch pointer and counters, and
the calls that stay on the FFMA core (D 64, sta_pipe's int8 QK mode with an
f32 v, sta_row's f32 mode, sta_pipe's tiles of a token count 8 does not
divide, the FFMA yardsticks); the kernel's walk mirrored in Python
(``window_f32_tc_walk``: every q row sees exactly its window's keys and the
text keys, each once, with clamped edges and nt < win_t); and the
arithmetic: an emulation of the kernel's 3xTF32 products through that walk
against the plain versions (the stable softmax of sta_window, the fast and
stable ones of sta_pipe, a text tail with padded keys, a head routed away)
reads within 1e-5 where single TF32 products read 2e-4 or more (the
kernels' gate is 1e-4).  Imports no JAX: the plain versions' parity with
JAX is held by the other port tests.  The card runs the kernels:
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

from vorta_tpu_torch.ops import _build
from vorta_tpu_torch.ops.flash import LOG2E
from vorta_tpu_torch.ops.flash_manual import _prescale
from vorta_tpu_torch.ops.layout import tile_sequence
from vorta_tpu_torch.ops.sta_pipe import (
    _window_keys,
    sta_f32_tc_path,
    sta_pipe_attention,
    sta_pipe_attention_ffma,
    sta_pipe_attention_ref,
    window_f32_tc_walk,
)
from vorta_tpu_torch.ops.sta_row import sta_row_attention
from vorta_tpu_torch.ops.sta_window import (
    sta_window_attention,
    sta_window_attention_ffma,
    sta_window_attention_ref,
)

# the f32 window calls of the served paths: (kernel, grid, tile, heads, text keys)
SERVED = {
    "sta_pipe_480p_77f_464": ("sta_pipe", (20, 30, 52), (4, 6, 4), 12, 0),
    "sta_window_720p_29f_4910": ("sta_window", (8, 45, 80), (4, 9, 10), 12, 0),
    "sta_window_720p_77f_4910": ("sta_window", (20, 45, 80), (4, 9, 10), 12, 0),
    "sta_pipe_hunyuan_45f_698_text": ("sta_pipe", (12, 45, 80), (6, 9, 8), 24, 256),
    "sta_window_hunyuan_45f_4910_text": ("sta_window", (12, 45, 80), (4, 9, 10), 24, 256),
}
COUNTERS = ("sta_pipe", "sta_pipe_f32", "sta_pipe_f32_tc", "sta_pipe_wgmma", "sta_pipe_int8",
            "sta_window", "sta_window_f32", "sta_window_f32_tc", "sta_window_wgmma",
            "sta_row", "sta_row_f32", "sta_row_wgmma")


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


def _took(calls, entry: str, tc: bool, **counts):
    """One launch through ``entry``, given the tensor-core walk's scratch
    (the f32 entries' next-to-last argument: a pointer, 0 on the meta
    device) where ``tc`` and None otherwise, and exactly ``counts`` on the
    counters."""
    assert [(e, a[-2] is not None) for _, e, a in calls] == [(entry, tc)]
    assert {c: _build.launches[c] for c in COUNTERS} == {**dict.fromkeys(COUNTERS, 0), **counts}


def _call(kernel, grid, tile, heads, lt, d=128, fn=None, **kw):
    q = _meta(1, heads, math.prod(grid), d)
    if lt:
        kw.update(text_k=_meta(1, heads, lt, d), text_v=_meta(1, heads, lt, d),
                  text_bias=torch.zeros((1, lt), device="meta"))
    fn = fn or {"sta_pipe": sta_pipe_attention, "sta_window": sta_window_attention,
                "sta_row": sta_row_attention}[kernel]
    act = torch.tensor([i % 3 != 1 for i in range(heads)], dtype=torch.int32)
    return fn(q, q, q, act, latent_shape=grid, tile=tile, window=(3, 3, 3), **kw)


# ---- the rule at the paths' calls -----------------------------------------------------

@pytest.mark.parametrize("name", sorted(SERVED))
def test_served_window_calls_take_the_tensor_cores(name, fake_card):
    """Every f32 window call of the served paths (the rule holds at their
    tiles of 96, 360 and 432 tokens, with and without 256 text keys) goes to
    its f32 entry with the scratch, counted once as <kernel>_f32_tc."""
    kernel, grid, tile, heads, lt = SERVED[name]
    assert sta_f32_tc_path(128, grid, tile, text_len=lt)
    _call(kernel, grid, tile, heads, lt)
    entry = {"sta_pipe": "vorta_sta_fwd_f32", "sta_window": "vorta_sta_window_fwd_f32"}[kernel]
    _took(fake_card, entry, True, **{kernel: 1, f"{kernel}_f32": 1, f"{kernel}_f32_tc": 1})


def _ffma_calls():
    """Calls that stay on the FFMA core: (kernel, grid, tile, heads, text,
    D, extra kwargs, wrapper)."""
    q8 = dict(qk_scale=torch.ones(12))
    return {
        "sta_pipe_d64_tiny": ("sta_pipe", (4, 4, 4), (2, 2, 2), 2, 0, 64, {}, None),
        "sta_window_d64_text24": ("sta_window", (4, 9, 80), (4, 9, 10), 3, 24, 64, {}, None),
        "sta_pipe_int8_qk_f32_v": ("sta_pipe", (20, 30, 52), (4, 6, 4), 12, 0, 128, q8, None),
        "sta_row_720p_598": ("sta_row", (20, 45, 80), (5, 9, 8), 12, 0, 128, {}, None),
        "sta_pipe_tile_of_12": ("sta_pipe", (4, 6, 8), (1, 3, 4), 2, 0, 128, {}, None),
        "sta_window_d64_tile_of_48": ("sta_window", (4, 6, 16), (2, 3, 8), 3, 0, 64, {}, None),
        "sta_pipe_ffma_yardstick": ("sta_pipe", (20, 30, 52), (4, 6, 4), 12, 0, 128, {},
                                    sta_pipe_attention_ffma),
        "sta_window_ffma_yardstick": ("sta_window", (8, 45, 80), (4, 9, 10), 12, 0, 128, {},
                                      sta_window_attention_ffma),
    }


@pytest.mark.parametrize("name", sorted(_ffma_calls()))
def test_other_f32_window_calls_stay_on_the_ffma_core(name, fake_card):
    """D 64 (the tiny models), sta_pipe's int8 QK mode with an f32 v, sta_row's
    f32 mode (even at a tile the rule takes), sta_pipe's 12-token tiles
    (sta_window's geometries always hold a multiple of 8 tokens a tile:
    ``supports_window_dense``) and the FFMA yardsticks: the f32 entry
    without the scratch, never on _f32_tc."""
    kernel, grid, tile, heads, lt, d, kw, fn = _ffma_calls()[name]
    int8 = "qk_scale" in kw
    if int8:
        q = _meta(1, heads, math.prod(grid), d, dtype=torch.int8)
        fn = lambda *a, **k: sta_pipe_attention(  # noqa: E731
            q, q, _meta(1, heads, math.prod(grid), d), a[3], **k)
    _call(kernel, grid, tile, heads, lt, d, fn, **kw)
    entry = {"sta_pipe": "vorta_sta_fwd_f32", "sta_window": "vorta_sta_window_fwd_f32",
             "sta_row": "vorta_sta_row_fwd_f32"}[kernel]
    counts = {kernel: 1, f"{kernel}_f32": 1, **({"sta_pipe_int8": 1} if int8 else {})}
    _took(fake_card, entry, False, **counts)


@pytest.mark.parametrize("d,tile,lt,kw,want", [
    (128, (4, 6, 4), 0, {}, True),
    (128, (4, 9, 10), 256, {}, True),
    (128, (6, 9, 8), 256, {}, True),
    (64, (4, 6, 4), 0, {}, False),
    (128, (1, 3, 4), 0, {}, False),              # 12 tokens a tile
    (128, (4, 6, 4), 0, {"qk_int8": True}, False),
    (128, (4, 6, 4), 0, {"variant": "dots"}, False),
    (128, (4, 6, 4), 0, {"dtype": torch.bfloat16}, False),
])
def test_shape_rule(d, tile, lt, kw, want):
    """The rule: D 128, f32, not the int8 QK mode, the full variant, tiles
    of a multiple of 8 tokens (text keys always come in multiples of 8)."""
    assert sta_f32_tc_path(d, (12, 36, 80), tile, text_len=lt, **kw) is want


# ---- the kernel's walk ----------------------------------------------------------------

WALKS = {  # grid, tile, text keys: the served tiles, clamped edges, nt < win_t
    "480p_77f_464": ((20, 30, 52), (4, 6, 4), 0),
    "720p_29f_4910": ((8, 45, 80), (4, 9, 10), 0),
    "hunyuan_45f_698_text": ((12, 45, 80), (6, 9, 8), 256),
    "small_2x2x2_tiles_text24": ((4, 6, 16), (2, 3, 8), 24),
    "one_w_tile": ((8, 6, 8), (2, 3, 8), 0),
}


def _tile_major_tokens(grid, tile) -> np.ndarray:
    """Raster token of each row of the tile-major order."""
    s = math.prod(grid)
    ids = torch.arange(s, dtype=torch.float64).reshape(1, 1, s, 1)
    return tile_sequence(ids, grid, tile).reshape(-1).long().numpy()


@pytest.mark.parametrize("name", sorted(WALKS))
def test_walk_covers_each_window_and_text_key_once(name):
    """window_f32_tc_walk (the kernel's PieceWalk): per q tile, its pieces of
    at most 32 keys, each on a multiple of 8 (V^T's permuted groups), each
    inside one run of consecutive tiles or the text; its chunks pair
    consecutive pieces (a lone last one with itself at 0 keys); mapped back
    to the raster, exactly the tile's window keys (``_window_keys``) and
    every text key, each once."""
    grid, tile, lt = WALKS[name]
    s, tpt = math.prod(grid), math.prod(tile)
    raster = _tile_major_tokens(grid, tile)
    keys = _window_keys(grid, tile, (3, 3, 3))
    walk = window_f32_tc_walk(grid, tile, (3, 3, 3), lt)
    assert len(walk) == keys.shape[0]
    run = min(3, grid[2] // tile[2]) * tpt  # keys of a run: a window row's w tiles
    n_pieces = keys.shape[1] // run * -(-run // 32) + -(-lt // 32)
    for i, chunks in enumerate(walk):
        pieces = [pc for ch in chunks for pc in ch]
        assert len(chunks) == -(-n_pieces // 2)
        assert sum(n > 0 for _, n in pieces) == n_pieces
        seen = []
        for k0, n in pieces:
            assert k0 % 8 == 0 and 0 <= n <= 32
            assert k0 + n <= s or k0 >= s  # a piece of the window or of the text
            seen += range(k0, k0 + n)
        seen = np.asarray(seen)
        win, text = seen[seen < s], seen[seen >= s]
        assert np.array_equal(np.sort(raster[win]), np.sort(keys[i]))
        assert np.array_equal(np.sort(text), s + np.arange(lt))


# ---- the split's arithmetic through the walk -------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
    (the kernel's cvt.rna), in integer ops."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32).double()


def _three(a, b):
    """3xTF32: small x big + big x small + big x big, each product exact in f64."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a.float() - ab.float()), _tf32(b.float() - bb.float())
    return as_ @ bb + ab @ bs + ab @ bb


def _one(a, b):
    return _tf32(a) @ _tf32(b)


def _emulate(q, k, v, act, *, grid, tile, text, mul, stable, mm):
    """The kernel's output: q, k, v gathered into tile-major order (text keys
    after each (b, h)'s window keys), per q tile of 64-row parts its chunks
    of two 32-key pieces (keys past a piece masked), S = mm(q, k^T) * mul +
    the text bias, the online (stable) or fast softmax in f32, each chunk's
    PV product mm(p, v) in a fresh accumulator joined by O = O alpha + PV;
    the rows scattered back to their raster tokens; a head routed away
    zeros."""
    tk, tv, tb = text
    b, h, s, d = q.shape
    tpt = math.prod(tile)
    raster = torch.from_numpy(_tile_major_tokens(grid, tile))
    lt = 0 if tk is None else tk.shape[2]
    kg, vg = k[:, :, raster], v[:, :, raster]
    if lt:
        kg, vg = torch.cat([kg, tk], 2), torch.cat([vg, tv], 2)
    bias = torch.cat([torch.zeros(s), tb.reshape(-1) if lt else torch.zeros(0)])
    qg = q[:, :, raster]
    out = torch.zeros(b, h, s, d)
    for i, chunks in enumerate(window_f32_tc_walk(grid, tile, (3, 3, 3), lt)):
        for part in range(0, tpt, 64):
            rows = slice(i * tpt + part, i * tpt + min(part + 64, tpt))
            qt = qg[:, :, rows]
            m = torch.full(qt.shape[:3] + (1,), -1e30)
            l, o = torch.zeros_like(m), torch.zeros(qt.shape)
            for (ka, na), (kb, nb) in chunks:
                idx = torch.cat([torch.arange(ka, ka + 32), torch.arange(kb, kb + 32)])
                on = torch.cat([torch.arange(32) < na, torch.arange(32) < nb])
                idx = idx.clamp(max=s + lt - 1)
                x = mm(qt, kg[:, :, idx].transpose(-1, -2)).float() * mul + bias[idx]
                x = torch.where(on, x, -1e30)
                if stable:
                    m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                    alpha = torch.where(m <= -1e30, 0.0, torch.exp2(m - m_new))
                    p = torch.exp2(x - torch.where(m_new <= -1e30, 0.0, m_new))
                    m = m_new
                else:
                    alpha, p = torch.ones_like(m), torch.exp2(x)
                l = l * alpha + p.sum(-1, keepdim=True)
                o = o * alpha + mm(p, torch.where(on[:, None], vg[:, :, idx], 0.0)).float()
            out[:, :, raster[rows]] = torch.where(l == 0, 0.0, o / l)
    return torch.where(torch.as_tensor(act).reshape(1, h, 1, 1) > 0, out, 0.0)


@pytest.mark.parametrize("kernel,softmax", [("sta_window", "stable"), ("sta_pipe", "fast"),
                                            ("sta_pipe", "stable")])
def test_3xtf32_through_the_window_walk_holds_the_gate(kernel, softmax):
    """The kernel's arithmetic through its walk at (1, 2, 384, 128), tile (2,
    3, 8) on a (4, 6, 16) grid (clamped windows, nt = 2 < 3), 24 text keys
    of which 5 padded (-1e30), head 1 routed away: 3xTF32 reads within 1e-5
    of the plain version (worst |diff| / max(|plain|, RMS)) on the active
    head, single TF32 products 2e-4 or more; the routed-away head exact
    zeros either way."""
    grid, tile, lt = (4, 6, 16), (2, 3, 8), 24
    rng = np.random.default_rng(27)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 384, 128))).float()
               for _ in range(3))
    tk, tv = (torch.from_numpy(rng.standard_normal((1, 2, lt, 128))).float() for _ in range(2))
    tb = torch.where(torch.arange(lt) < lt - 5, 0.0, -1e30)[None]
    act = torch.tensor([1, 0])
    scale = 128**-0.5
    kw = dict(latent_shape=grid, tile=tile, window=(3, 3, 3), scale=scale, text_k=tk,
              text_v=tv, text_bias=tb)
    if kernel == "sta_window":
        want = sta_window_attention_ref(q, k, v, act, **kw)
        qe, mul = q, scale * LOG2E  # q unscaled, the scores times scale * log2(e)
    else:
        want = sta_pipe_attention_ref(q, k, v, act, softmax=softmax, **kw)
        qe, mul = _prescale(q, scale), 1.0  # q pre-scaled in f32

    def worst(mm):
        got = _emulate(qe, k, v, act, grid=grid, tile=tile, text=(tk, tv, tb), mul=mul,
                       stable=softmax == "stable", mm=mm)
        assert not got[:, 1].any()
        g, w = got[:, 0], want[:, 0]
        rms = w.pow(2).mean().sqrt()
        return ((g - w).abs() / torch.maximum(w.abs(), rms)).max().item()

    assert worst(_three) <= 1e-5
    assert worst(_one) >= 2e-4


def test_window_bench_tool_runs_on_the_cpu():
    """tools/bench_f32_window at tiny grids on the CPU (the plain versions):
    a sta_window and a sta_pipe call, each against the plain version and
    timed in turns with the FFMA arm; on the card it times the kernels."""
    from vorta_tpu_torch.tools import bench_f32_window

    out = bench_f32_window.main(["--device", "cpu", "--heads", "3", "--iters", "1", "--ffma",
                                 "--window", "sta_window", "4", "6", "16", "2", "3", "8",
                                 "--window", "sta_pipe", "4", "6", "16", "2", "3", "8"])
    assert out["device"] == "cpu" and "card" not in out
    for name in ("sta_window_4x6x16_2x3x8", "sta_pipe_4x6x16_2x3x8"):
        row = out[name]
        assert row["worst_ratio"] == row["ffma_worst_ratio"] == 0.0
        assert len(row["ms_turns"]) == len(row["ffma_ms_turns"]) == 2
        assert row["window_keys"] == 384 and row["active_heads"] == 2
