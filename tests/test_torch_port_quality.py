"""The port's io/quality.py and io/profiling.py, on the CPU.

io/quality against the JAX package's vorta_tpu/io/quality.py on arrays
drawn with numpy from a seed: every function and branch (ssim's latent
layout, where 16 channels stay last as in JAX, its channels-first move
below 8 channels and its small-image window; temporal_consistency's
degenerate profiles; routing_mix's tau fallback; lpips returning None), and
the same numbers from CPU tensors.  Both sides are float64 numpy, so the
agreement is within 1e-12 relative (the dict metrics, rounded alike, are
equal).

io/profiling on the CPU: a function with a known op sequence traced with
``device_trace``, its ops' names and counts from ``op_durations(...,
kinds=("cpu_op",))`` read from the newest trace of the dir; the default
(device) kinds find nothing on the CPU; ``profile_call``; the kernel-symbol
map and ``range_device_ms`` on a synthetic trace with CUDA events.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import vorta_tpu.io.quality as jq
from vorta_tpu_torch.io import profiling
from vorta_tpu_torch.io import quality as q


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(shape, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    return a, (a + noise * rng.standard_normal(shape)).astype(np.float32)


def _same(got, want):
    if isinstance(want, dict):
        assert got == want
    elif want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


SHAPES = {
    "latents_16ch": (1, 3, 10, 12, 16),  # channels stay last: (W, C) planes, as in JAX
    "frames_3ch": (4, 12, 10, 3),  # channels < 8 moved first
    "small_window": (2, 5, 6),  # planes smaller than the 7x7 window
    "plane": (9, 11),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_pair_metrics_match_jax(name):
    a, b = _pair(SHAPES[name], seed=len(name))
    for fn in ("psnr", "ssim", "highfreq_energy_ratio"):
        if fn == "highfreq_energy_ratio" and len(SHAPES[name]) < 3:
            continue
        _same(getattr(q, fn)(a, b), getattr(jq, fn)(a, b))
    if len(SHAPES[name]) >= 4:
        for fn in ("temporal_consistency", "weightfree_video_metrics"):
            _same(getattr(q, fn)(b, a), getattr(jq, fn)(b, a))
        _same(q.temporal_flicker(a), jq.temporal_flicker(a))
    # tensors (bf16 ones as f32) give the numbers of their numpy values
    _same(q.ssim(torch.from_numpy(a), torch.from_numpy(b)), jq.ssim(a, b))
    a16 = torch.from_numpy(a).bfloat16()
    _same(q.psnr(a16, torch.from_numpy(b)), jq.psnr(a16.float().numpy(), b))


def test_psnr_and_ssim_edge_cases_match_jax():
    a, _ = _pair((2, 8, 9), seed=3)
    assert q.psnr(a, a) == jq.psnr(a, a) == float("inf")
    _same(q.ssim(a, a), jq.ssim(a, a))
    _same(q.ssim(a, a, win=3), jq.ssim(a, a, win=3))
    with pytest.raises(ValueError, match="shape mismatch"):
        q.ssim(a, a[:1])


@pytest.mark.parametrize("case", ["one_step", "both_flat", "one_flat", "moving"])
def test_temporal_consistency_degenerate_profiles_match_jax(case):
    rng = np.random.default_rng(5)
    moving = rng.standard_normal((1, 5, 4, 4, 2))
    flat = np.ones((1, 5, 4, 4, 2))
    a, b = {"one_step": (moving[:, :1], moving[:, :1]), "both_flat": (flat, 2 * flat),
            "one_flat": (moving, flat), "moving": (moving, moving[:, ::-1])}[case]
    _same(q.temporal_consistency(a, b), jq.temporal_consistency(a, b))
    if case != "moving":
        assert q.temporal_consistency(a, b) == {"one_step": 1.0, "both_flat": 1.0,
                                                "one_flat": 0.0}[case]


@pytest.mark.parametrize("tau", [0.0, 0.4, 0.6, 1.1])
def test_routing_mix_matches_jax(tau):
    """(steps, layers, B, H, 3) softmax scores; tau moves heads whose top
    score is under it to full attention (everything at 1.1)."""
    rng = np.random.default_rng(7)
    logits = 2.0 * rng.standard_normal((3, 4, 2, 6, 3))
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    got = q.routing_mix(torch.from_numpy(scores), tau)
    assert got == jq.routing_mix(scores, tau)
    assert sum(got.values()) == pytest.approx(1.0, abs=2e-4)
    if tau > 1.0:
        assert got == {"full": 1.0, "lowres": 0.0, "sta": 0.0}


def test_lpips_without_weights_or_package_is_none(tmp_path, monkeypatch):
    a, b = _pair((2, 8, 8, 3), seed=9)
    assert q.lpips(a, b) is None and jq.lpips(a, b) is None
    monkeypatch.setitem(sys.modules, "lpips", None)  # the package not installed
    assert q.lpips(a, b, str(tmp_path / "w.pth")) is None
    assert jq.lpips(a, b, str(tmp_path / "w.pth")) is None
    assert q.vbench_scaffold() == jq.vbench_scaffold()
    assert set(q.vbench_scaffold().values()) == {None}


# --- io/profiling -----------------------------------------------------------------


def _known_ops(x):
    y = x @ x  # aten::matmul -> aten::mm
    for _ in range(3):
        y = torch.relu(y)  # three aten::relu
    return y.sum()


def test_device_trace_and_op_durations_on_the_cpu(tmp_path):
    x = torch.randn(32, 32)
    with profiling.device_trace(str(tmp_path)) as d:
        _known_ops(x)
    assert d == str(tmp_path)
    first = profiling.newest_trace(d)
    time.sleep(0.01)
    with profiling.device_trace(str(tmp_path)):  # a second trace: the newest is read
        _known_ops(x)
        torch.tanh(x)
    newest = profiling.newest_trace(d)
    assert newest != first and newest.endswith(".pt.trace.json")
    rows = profiling.op_durations(d, top=None, kinds=("cpu_op",))
    counts = {name: n for name, _, n in rows}
    assert counts["aten::relu"] == 3 and counts["aten::mm"] == 1
    assert counts["aten::matmul"] == 1 and counts["aten::tanh"] == 1
    assert all(ms >= 0 for _, ms, _ in rows)
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    assert len(profiling.op_durations(d, top=2, kinds=("cpu_op",))) == 2
    assert profiling.op_durations(d) == []  # no device events on the CPU
    assert profiling.op_durations(str(tmp_path / "empty")) == []


def test_profile_call_warms_up_and_traces_once():
    calls = []

    def fn(x):
        calls.append(1)
        return _known_ops(x)

    rows = profiling.profile_call(fn, torch.randn(16, 16), top=None, kinds=("cpu_op",))
    assert len(calls) == 2
    assert {name: n for name, _, n in rows}["aten::relu"] == 3
    rows = profiling.profile_call(fn, torch.randn(16, 16), warmup=False, kinds=("cpu_op",))
    assert len(calls) == 3 and rows


def test_kernel_symbols_and_ranges_on_a_synthetic_device_trace(tmp_path):
    """Kernel names as the CUDA trace gives them map to the launch counters;
    a range's device time is that of the kernels launched inside it on its
    thread (correlation ids), nested ranges each counting theirs."""
    names = {1: "void flash_manual_sm90_kernel<128, 2>(FlashParams)",
             2: "void unpool_rows_kernel<8, 4>(float const*, int)",
             3: "void at::native::vectorized_elementwise_kernel<4, float>(int)",
             4: "void sta_kernel<64>(StaParams)"}
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "outer", "pid": 1, "tid": 7, "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "inner", "pid": 1, "tid": 7, "ts": 10,
         "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "inner", "pid": 1, "tid": 8, "ts": 0,
         "dur": 500},
    ]
    for corr, ts in ((1, 15), (2, 50), (3, 150), (4, 5)):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                       "tid": 7, "ts": ts, "dur": 2, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": names[corr], "pid": 0, "tid": 7,
                       "ts": 1000 + ts, "dur": 1000.0 * corr, "args": {"correlation": corr}})
    events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 7,
                   "ts": 2000, "dur": 500.0, "args": {}})
    (tmp_path / "0.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    rows = profiling.op_durations(str(tmp_path), top=None)
    assert {n: (ms, c) for n, ms, c in rows}["Memcpy HtoD"] == (0.5, 1)
    assert profiling.kernel_counts(rows) == {"flash_manual": 1, "unpool": 1, "sta_pipe": 1}
    assert profiling.kernel_symbol(names[3]) is None
    ranges = profiling.range_device_ms(str(tmp_path), ["outer", "inner", "absent"])
    assert ranges == {"outer": 1.0 + 2.0 + 4.0, "inner": 1.0}
    os.remove(tmp_path / "0.pt.trace.json")
    assert profiling.range_device_ms(str(tmp_path), ["outer"]) == {}
