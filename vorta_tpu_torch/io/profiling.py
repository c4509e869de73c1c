"""Profiling helpers (counterpart of vorta_tpu/io/profiling.py) on
``torch.profiler``.

``device_trace`` records the CPU and, where there is a card, the CUDA
activity of its body and writes a Chrome trace into a directory;
``op_durations`` aggregates the newest trace there into ``(name, total_ms,
count)`` rows, largest first; ``profile_call`` runs a function once to warm
up, then once under a trace, and returns those rows.

A torch trace holds host events too ("X" events of category ``cpu_op``,
``cuda_runtime``, ``user_annotation``...), where a TPU trace holds device
ops, so ``op_durations`` keeps only the device's categories by default
(``DEVICE_KINDS``: kernels, copies and sets); ``kinds`` chooses others.
``kernel_counts`` maps the port's CUDA kernels, named in the trace by their
symbols, to the launch counters of ops/_build.py, and ``range_device_ms``
sums the device time of the kernels launched inside named host ranges
(``torch.profiler.record_function``).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")

# each CUDA kernel symbol of csrc/ -> the launch counter its wrapper adds to
# (ops/_build.py); sta_row's Hopper path runs sta_window's kernel, and
# sta_batched's Hopper path launches its live-slot pass before its kernel
SYMBOL_COUNTERS = {
    "flash_fwd_kernel": "flash", "flash_sm90_kernel": "flash",
    "flash_manual_kernel": "flash_manual", "flash_manual_sm90_kernel": "flash_manual",
    "sta_kernel": "sta_pipe", "sta_pipe_sm90_kernel": "sta_pipe",
    "sta_window_kernel": "sta_window", "sta_window_sm90_kernel": "sta_window",
    "sta_row_kernel": "sta_row",
    "sta_batched_kernel": "sta_batched", "sta_batched_sm90_kernel": "sta_batched",
    "sta_batched_live_kernel": "sta_batched",
    "pool_kernel": "pool_qkv", "unpool_kernel": "unpool", "unpool_rows_kernel": "unpool",
    "fused_norm_kernel": "fused_norm", "fused_norm_rows_kernel": "fused_norm",
    "prologue_kernel": "prologue", "prologue_rows_kernel": "prologue",
    "flash_dq_kernel": "flash_dq", "flash_dq_sm90_kernel": "flash_dq",
    "flash_dkv_kernel": "flash_dkv", "flash_dkv_sm90_kernel": "flash_dkv",
    "copy_probe_kernel": "copy_probe", "fused_residual_norm_kernel": "fused_residual_norm",
    "sta_diag_kernel": "sta_diag", "sta_diag_sm90_kernel": "sta_diag",
    # the f32 modes (csrc/attn_f32.cuh, csrc/attn_f32_bwd.cuh)
    "flash_f32_kernel": "flash", "flash_manual_f32_kernel": "flash_manual",
    "sta_pipe_f32_kernel": "sta_pipe", "sta_batched_f32_kernel": "sta_batched",
    "flash_dq_f32_kernel": "flash_dq", "flash_dkv_f32_kernel": "flash_dkv",
    "sta_window_f32_kernel": "sta_window", "sta_row_f32_kernel": "sta_row",
    # the f32 modes' tensor-core kernels (csrc/attn_f32_tc.cuh, csrc/attn_f32_tc_bwd.cuh)
    "flash_f32_tc_kernel": "flash", "flash_manual_f32_tc_kernel": "flash_manual",
    "flash_dq_f32_tc_kernel": "flash_dq", "flash_dkv_f32_tc_kernel": "flash_dkv",
    # the int8 QK mode with an f32 v on the tensor cores (csrc/attn_int8_tc.cuh)
    "flash_manual_int8_tc_kernel": "flash_manual",
}
_SYMBOL = re.compile(r"\b([A-Za-z0-9_]+_kernel)\b")


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """Trace the body (CPU ops, and the card's kernels where there is one);
    yields the trace dir (a new temporary one by default), where a Chrome
    trace ``<ns>.pt.trace.json`` is written when the body ends."""
    from torch.profiler import profile

    trace_dir = str(trace_dir or tempfile.mkdtemp(prefix="vorta_trace_"))
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield trace_dir
    prof.export_chrome_trace(os.path.join(trace_dir, f"{time.time_ns():020d}.pt.trace.json"))


def newest_trace(trace_dir: str) -> Optional[str]:
    """The newest ``*.trace.json`` / ``*.trace.json.gz`` under ``trace_dir``."""
    files = [f for pat in ("*.trace.json", "*.trace.json.gz")
             for f in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    if not files:
        return None
    return max(files, key=lambda f: (os.path.getmtime(f), f))


def trace_events(trace_dir: str) -> list:
    """The newest trace's events ([] without a trace)."""
    path = newest_trace(trace_dir)
    if path is None:
        return []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh).get("traceEvents", [])


def op_durations(trace_dir: str, top: Optional[int] = 25,
                 kinds: Iterable[str] = DEVICE_KINDS) -> List[Tuple[str, float, int]]:
    """(name, total_ms, count) of the newest trace's complete events of the
    categories ``kinds``, largest total first; the first ``top`` (all with
    None)."""
    kinds = set(kinds)
    agg: Dict[str, List[float]] = {}
    for e in trace_events(trace_dir):
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in kinds:
            cur = agg.setdefault(e.get("name", ""), [0.0, 0])
            cur[0] += e["dur"] / 1e3
            cur[1] += 1
    rows = sorted(((k, v[0], v[1]) for k, v in agg.items()), key=lambda r: -r[1])
    return rows if top is None else rows[:top]


def kernel_symbol(name: str) -> Optional[str]:
    """The port kernel's symbol in a trace's kernel name, or None."""
    for sym in _SYMBOL.findall(name):
        if sym in SYMBOL_COUNTERS:
            return sym
    return None


def kernel_counts(rows) -> Dict[str, int]:
    """{launch counter: device events} of ``op_durations`` rows, for the
    port's kernels (``SYMBOL_COUNTERS``); other kernels are left out."""
    out: Dict[str, int] = {}
    for name, _, n in rows:
        sym = kernel_symbol(name)
        if sym is not None:
            out[SYMBOL_COUNTERS[sym]] = out.get(SYMBOL_COUNTERS[sym], 0) + n
    return out


def range_device_ms(trace_dir: str, names: Iterable[str]) -> Dict[str, float]:
    """{range name: ms} of device time of the kernels (``DEVICE_KINDS``)
    launched on a host thread while a ``record_function`` range of that name
    was open on it, matched through the trace's correlation ids; nested
    ranges each count their kernels."""
    names = set(names)
    events = trace_events(trace_dir)
    spans: Dict[tuple, list] = {}
    launches, device = {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, corr = e.get("cat"), e.get("args", {}).get("correlation")
        if cat == "user_annotation" and e.get("name") in names:
            spans.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = e
        elif cat in DEVICE_KINDS and corr is not None:
            device.append(e)
    out = dict.fromkeys(sorted(names & {n for v in spans.values() for *_, n in v}), 0.0)
    for k in device:
        host = launches.get(k["args"]["correlation"])
        if host is None:
            continue
        for t0, t1, name in spans.get((host["pid"], host["tid"]), ()):
            if t0 <= host["ts"] <= t1:
                out[name] += k["dur"] / 1e3
    return out


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_call(fn, *args, top: Optional[int] = 25, warmup: bool = True,
                 kinds: Iterable[str] = DEVICE_KINDS):
    """Run ``fn(*args)`` once to warm up (``warmup``), then once under a
    trace, the card synchronized before the trace ends; returns that run's
    ``op_durations`` rows."""
    if warmup:
        fn(*args)
        _sync()
    with device_trace() as d:
        fn(*args)
        _sync()
    return op_durations(d, top=top, kinds=kinds)

