"""flash_manual's int8 QK mode with an f32 v on the tensor cores
(``csrc/attn_int8_tc.cuh``: wgmma s8 scores, 3xTF32 PV) on the CPU: the
wrapper's rule at every int8 call with an f32 v that the 1.3B / 13B paths
serve (Wan's routed FULL and LOWRES, HunyuanVideo's joint FULL / LOWRES with
``kv_bias``: the entry with V^T's scratch, counted as
``flash_manual_int8_tc``), the calls that stay on the dp4a / FFMA int8 mode
(D 64, 16-row blocks, the FFMA yardstick), and the kernel's arithmetic: a
PyTorch emulation (exact int32 sums, the unfused multiply by the head's
factor, P and V split into TF32 halves, small products first, each chunk's
PV joined to O in f32) agrees with the plain version within the card's
1e-4 gate where one TF32 PV product reads 2e-4 or more.  Imports no JAX: the
int8 plain version is held against Pallas by
``tests/test_torch_port_f32_window_int8.py``.  The card runs the kernel
itself: ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vorta_tpu_torch.cli.sample import attention_config
from vorta_tpu_torch.ops import _build
from vorta_tpu_torch.ops import flash_manual as fm
from vorta_tpu_torch.ops.flash import LOG2E, dense_tables, f32_tc_path
from vorta_tpu_torch.ops.joint_experts import JointConfig, joint_layouts
from vorta_tpu_torch.ops.routed_fused import quantize_qk, routed_geometry

WAN_ROUTED = {  # the --qk_int8 f32 paths' routed geometries: (grid, STA tile)
    "480p_77f": ((20, 30, 52), (4, 6, 4)),
    "720p_77f": ((20, 45, 80), (5, 9, 8)),
}
HY_GRIDS = {"45f": (12, 45, 80), "117f": (30, 45, 80)}
COUNTERS = ("flash_manual", "flash_manual_f32", "flash_manual_int8", "flash_manual_int8_tc",
            "flash_manual_f32_tc", "flash_manual_wgmma")


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
    """Meta tensors take the CUDA branch of the wrapper; every library entry
    records (entry, args) and returns 0 (a launch that succeeded), and each
    scratch the wrapper asks for is recorded as (kind, its arguments).
    Returns (calls, scratch)."""
    calls, scratch = [], []

    class Library:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            class Entry:
                argtypes = None

                def __call__(self, *args):
                    calls.append((entry, args))
                    return 0

            return Entry()

    def spy(kind, fn):
        def wrapped(*args):
            scratch.append((kind, args[:-1]))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(_build, "require_cuda", lambda *tensors: tensors[0].device)
    monkeypatch.setattr(_build, "load", Library)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(fm, "int8_tc_work", spy("int8", fm.int8_tc_work))
    monkeypatch.setattr(fm, "f32_tc_work", spy("f32", fm.f32_tc_work))
    _build.reset_launches()
    yield calls, scratch
    _build.reset_launches()


def _int8_call(h, sq, skv, d, block_q, block_kv, *, counts=None, ffma=False, **kw):
    """One int8 q / k, f32 v call of flash_manual on meta tensors."""
    q8, k8 = _meta(1, h, sq, d, dtype=torch.int8), _meta(1, h, skv, d, dtype=torch.int8)
    ki, kc = dense_tables(sq // block_q, skv // block_kv).on("meta")
    fn = fm.sparse_flash_attention_manual_ffma if ffma else fm.sparse_flash_attention_manual
    fn(q8, k8, _meta(1, h, skv, d), ki, kc.expand(h, -1) if counts is None else counts,
       block_q=block_q, block_kv=block_kv, softmax="fast", qk_scale=torch.ones(h), **kw)


def _took(fake, tc: bool, b: int, h: int, skv: int):
    """One launch of the f32 entry, with V^T's scratch (2 B H Skv 128 f32,
    asked for once) where ``tc`` and none otherwise; the int8 counters."""
    calls, scratch = fake
    assert [e for e, _ in calls] == ["vorta_flash_manual_fwd_f32"]
    assert (calls[0][1][-2] is not None) is tc
    assert scratch == ([("int8", (b, h, skv))] if tc else [])
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_manual=1, flash_manual_f32=1, flash_manual_int8=1,
                flash_manual_int8_tc=int(tc))
    assert {c: _build.launches[c] for c in COUNTERS} == want


# ---- the rule at the paths' calls -----------------------------------------------------

@pytest.mark.parametrize("name", sorted(WAN_ROUTED))
@pytest.mark.parametrize("expert", ["full", "lowres"])
def test_routed_wan_int8_calls_take_the_tensor_cores(name, expert, fake_card):
    """cli.sample --dtype fp32 --qk_int8 routed: FULL and LOWRES (per-head
    counts, a kv tail) go to the tensor-core int8 kernel, counted once."""
    grid, tile = WAN_ROUTED[name]
    cfg = dataclasses.replace(attention_config("wan-1_3B", grid), sta_tile=tile, qk_int8=True)
    call = getattr(routed_geometry(cfg), expert)
    assert f32_tc_path(128, call.block_q, call.block_kv)
    ki, kc = call.tables.on("meta")
    h, s = 12, call.q_pad
    q8 = _meta(1, h, s, 128, dtype=torch.int8)
    fm.sparse_flash_attention_manual(q8, q8, _meta(1, h, s, 128), ki, kc.expand(h, -1),
                                     block_q=call.block_q, block_kv=call.block_kv,
                                     kv_valid_len=call.valid_len, softmax="fast",
                                     qk_scale=torch.ones(h))
    _took(fake_card, True, 1, h, s)


@pytest.mark.parametrize("name", sorted(HY_GRIDS))
@pytest.mark.parametrize("layout", ["full", "lowres"])
def test_hunyuan_joint_int8_layouts_take_the_tensor_cores(name, layout, fake_card):
    """The 13B's joint FULL / LOWRES under qk_int8, with kv_bias and a kv
    tail."""
    cfg = attention_config("hunyuan-13B", HY_GRIDS[name])
    lay = joint_layouts(JointConfig(cfg, 256))[layout]
    assert f32_tc_path(128, lay.block_q, lay.block_kv), (lay.block_q, lay.block_kv)
    sq, skv = 2 * lay.block_q, 2 * lay.block_kv
    _int8_call(2, sq, skv, 128, lay.block_q, lay.block_kv, kv_bias=_meta(1, skv),
               kv_valid_len=skv - 100)
    _took(fake_card, True, 1, 2, skv)


@pytest.mark.parametrize("case", ["d64", "blocks16", "blocks96", "ffma_yardstick"])
def test_other_int8_calls_stay_on_dp4a(case, fake_card):
    """D 64 (the tiny models), blocks 128 does not divide and the FFMA
    yardstick at a served shape: the entry with no scratch (dp4a scores,
    FFMA PV), never counted as ``flash_manual_int8_tc``."""
    d, block, ffma = {"d64": (64, 1024, False), "blocks16": (128, 16, False),
                      "blocks96": (128, 96, False), "ffma_yardstick": (128, 1024, True)}[case]
    _int8_call(2, 2 * block, 2 * block, d, block, block, ffma=ffma)
    _took(fake_card, False, 1, 2, 2 * block)


def test_f32_calls_keep_their_core_and_scratch(fake_card):
    """f32 q / k at the same shape: the f32 tensor-core core, its own scratch
    (q, k and V^T halves), no int8 counter."""
    calls, scratch = fake_card
    q = _meta(1, 2, 256, 128)
    ki, kc = dense_tables(2, 2).on("meta")
    fm.sparse_flash_attention_manual(q, q, q, ki, kc, block_q=128, block_kv=128, softmax="fast")
    assert scratch == [("f32", (1, 2, 256, 256))] and calls[0][1][-2] is not None
    assert (_build.launches["flash_manual_f32_tc"], _build.launches["flash_manual_int8"],
            _build.launches["flash_manual_int8_tc"]) == (1, 0, 0)


def test_ffma_yardstick_checks_its_int8_operands():
    """The yardstick's int8 mode takes int8 q / k and the fast softmax only,
    as the wrapper does."""
    q = _meta(1, 2, 256, 128)
    ki, kc = dense_tables(2, 2).on("meta")
    with pytest.raises(ValueError):
        fm.sparse_flash_attention_manual_ffma(q, q, q, ki, kc, block_q=128, block_kv=128,
                                              softmax="fast", qk_scale=torch.ones(2))
    q8 = _meta(1, 2, 256, 128, dtype=torch.int8)
    with pytest.raises(ValueError):
        fm.sparse_flash_attention_manual_ffma(q8, q8, q, ki, kc, block_q=128, block_kv=128,
                                              softmax="stable", qk_scale=torch.ones(2))


def test_bench_tool_times_the_served_calls():
    """``tools/bench_int8_tc``'s three default calls are the served shapes on
    the tensor-core rule: Wan FULL / LOWRES (1,12,31744 / 16384,128), 8 of
    12 heads, and HunyuanVideo's joint FULL (1,24,45056,128), 8 of 24, with
    kv_bias."""
    from vorta_tpu_torch.tools.bench_int8_tc import calls

    got = calls((20, 30, 52), (12, 45, 80))
    assert {n: (c[0], c[1], sum(c[6]), c[7] is not None) for n, c in got.items()} == {
        "full": (12, 31744, 8, False), "lowres": (12, 16384, 8, False),
        "hunyuan_joint_full_kv_bias": (24, 45056, 8, True)}
    assert all(f32_tc_path(128, c[2], c[3]) for c in got.values())


def test_profile_forward_takes_fp32_qk_int8(monkeypatch):
    """cli.profile_forward --dtype fp32 --qk_int8 (the f32 int8 path's
    profile) parses and stops at the device check without a card; the other
    quantized flags stay refused in f32."""
    from vorta_tpu_torch.cli import profile_forward

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_forward.main(["--num_frames", "77", "--routing", "hard", "--dtype", "fp32",
                              "--qk_int8"])
    for extra in (["--qk_int8", "--mm", "int8"], ["--quantize_blocks", "int4"]):
        with pytest.raises(SystemExit):
            profile_forward.main(["--dtype", "fp32", *extra])


def test_int8_scratch_holds_vt_halves_only():
    w = fm.int8_tc_work(2, 3, 256, "cpu")
    assert w.dtype == torch.float32 and w.numel() == 2 * 2 * 3 * 256 * 128


# ---- the kernel's arithmetic ----------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 as the kernel's cvt.rna: to nearest, ties
    away from zero, low 13 bits zero; f64 out (TF32 products are exact in
    f64)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32).double()


def _split(x: torch.Tensor):
    big = _tf32(x)
    return big, _tf32(x.float() - big.float())


def _three(p, v):
    """Ps Vb + Pb Vs + Pb Vb, small products first."""
    (pb, ps), (vb, vs) = _split(p), _split(v)
    return ps @ vb + pb @ vs + pb @ vb


def _one(p, v):
    return _tf32(p) @ _tf32(v)


def _emulate(q8, k8, v, kv_index, kv_count, *, block_q, block_kv, kv_valid_len, kv_bias,
             qk_scale, scale, pv, chunk=64):
    """The kernel's arithmetic in PyTorch, walked as its CTAs walk: for each
    (head, q block) with a nonzero count, 64-key chunks of the listed kv
    blocks up to the tail rule's limit; s = f32(int32 sum) * qkc[h] (one
    f32 multiply) + bias, p = exp2(s) or 0 past the limit, l summed in f32,
    each chunk's PV product ``pv(p, v)`` (f64, cut keys' v zero) rounded to
    f32 and added to O in f32; out = O * (1 / l), 0 where l = 0."""
    b, h, sq, d = q8.shape
    qkc = fm.qk_factor(qk_scale, scale, h)
    bias = torch.zeros(k8.shape[2]) if kv_bias is None else kv_bias.reshape(-1).float()
    last, tail = kv_valid_len // block_kv, kv_valid_len % block_kv
    out = torch.zeros(q8.shape, dtype=torch.float32)
    for hh in range(h):
        for i in range(sq // block_q):
            rows = slice(i * block_q, (i + 1) * block_q)
            cnt = int(kv_count[hh if kv_count.shape[0] > 1 else 0, i])
            o = torch.zeros((b, block_q, d), dtype=torch.float32)
            l = torch.zeros((b, block_q), dtype=torch.float32)
            for j in range(cnt):
                kvb = int(kv_index[hh if kv_index.shape[0] > 1 else 0, i, j])
                limit = tail if (kvb == last and tail) else block_kv
                for n0 in range(0, limit, chunk):
                    keys = slice(kvb * block_kv + n0, kvb * block_kv + n0 + chunk)
                    nvalid = min(chunk, limit - n0)
                    si = q8[:, hh, rows].long() @ k8[:, hh, keys].long().transpose(-1, -2)
                    s = si.float() * qkc[hh] + bias[keys]
                    ok = torch.arange(chunk) < nvalid
                    p = torch.where(ok, torch.exp2(s), 0.0)
                    l = l + p.sum(-1)
                    vc = torch.where(ok[:, None], v[:, hh, keys], 0.0)
                    o = o + pv(p, vc).float()
            inv = torch.where(l == 0, 0.0, 1.0 / torch.where(l == 0, 1.0, l))
            out[:, hh, rows] = o * inv[..., None]
    return out


def _worst(got, want):
    rms = want.pow(2).mean().sqrt()
    return ((got - want).abs() / torch.maximum(want.abs(), rms)).max().item()


@pytest.mark.parametrize("with_bias", [False, True])
def test_split_pv_holds_the_gate_where_one_tf32_product_cannot(with_bias):
    """(1, 3, 384, 128) int8 q / k (unit normals quantized per head), f32 v,
    blocks 128, a tail cutting the last kv block at 100 keys, head 1 routed
    away, kv_bias (-1e30 on a third of the keys) or none: the emulated
    kernel reads within 1e-4 of the plain version (worst |diff| /
    max(|plain|, RMS)), one TF32 PV product 2e-4 or more, and the routed-away
    head is exact zeros."""
    rng = np.random.default_rng(24)
    h, s, blk, valid = 3, 384, 128, 356
    qf, kf, v = (torch.from_numpy(rng.standard_normal((1, h, s, 128))).float() for _ in range(3))
    q8, k8, qk_scale = quantize_qk(qf, kf)
    ki, kc = dense_tables(s // blk, s // blk).on("cpu")
    counts = kc.expand(h, -1).clone()
    counts[1] = 0
    bias = None
    if with_bias:
        bias = torch.from_numpy(np.where(rng.random((1, s)) < 1 / 3, -1e30, 0.0)).float()
    kw = dict(block_q=blk, block_kv=blk, kv_valid_len=valid, kv_bias=bias, qk_scale=qk_scale,
              scale=128**-0.5)
    want = fm.sparse_flash_attention_manual_ref(q8, k8, v, ki, counts, softmax="fast", **kw)
    got = _emulate(q8, k8, v, ki, counts, pv=_three, **kw)
    one = _emulate(q8, k8, v, ki, counts, pv=_one, **kw)
    assert not got[:, 1].any() and not want[:, 1].any()
    assert _worst(got, want) <= 1e-4
    assert _worst(one, want) >= 2e-4


def test_scores_are_exact_int32_sums_times_the_factor():
    """The int32 sums of int8 rows of 128 are exact in f32 (|q.k| <= 127^2 x
    128 < 2^24), so the plain version's f32 einsum gives the kernel's sums;
    its factor is qk_scale * scale * log2(e) in f32."""
    q8 = torch.full((1, 1, 1, 128), 127, dtype=torch.int8)
    k8 = torch.full((1, 1, 1, 128), -127, dtype=torch.int8)
    exact = (q8.long() * k8.long()).sum()
    assert abs(int(exact)) < 2**24
    assert fm.scores_log2(q8, k8, 0.5, torch.ones(1))[0, 0, 0, 0].item() == float(exact)
    assert torch.equal(fm.qk_factor(torch.tensor([2.0]), 0.5, 1),
                       torch.tensor([2.0]) * (0.5 * LOG2E))
