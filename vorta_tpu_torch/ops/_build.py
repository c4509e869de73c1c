"""Build and load the port's CUDA kernels (``vorta_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds.  All sources build at first use, one
``nvcc`` each, started together, into ``vorta_tpu_torch/_build/<hash>/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags so an
edited kernel is rebuilt.  Nothing builds when a module is imported.

``launches`` counts kernel launches per kernel (``coreset_pool.cu`` holds
three, ``pool_qkv``, ``unpool`` and ``copy_probe``, the copy probe of
``tools/bench_pool.py``; ``flash_bwd.cu`` two, ``flash_dq`` and
``flash_dkv``); each wrapper adds one where it launches its kernel, and
nowhere else.  ``flash_lse`` counts the flash launches that also write the
row log-sum-exp (a subset of ``flash``), ``flash_manual_int8`` and
``sta_pipe_int8`` the launches in the int8 QK mode (subsets of
``flash_manual`` and ``sta_pipe``).  ``pool_qkv_headmap`` and
``unpool_headmap`` count the pool's head-map launches, apart from its
plain / active ones (``pool_qkv``, ``unpool``).  ``fused_norm.cu`` holds
``fused_norm`` and ``fused_residual_norm``; ``sta_diag.cu`` the bisection
kernel of ``tools/sta_diag.py``.  The softmax modes count apart too, as
subsets of their kernel: ``flash_manual_stable``, ``sta_batched_stable``,
``sta_pipe_stable`` (the stable softmax) and ``sta_pipe_dots``,
``sta_pipe_qk``, ``sta_pipe_sT`` (sta_pipe's diagnostic variants).
``flash_wgmma``, ``flash_manual_wgmma``, ``sta_pipe_wgmma``,
``sta_window_wgmma``, ``sta_row_wgmma``, ``sta_batched_wgmma``,
``flash_dq_wgmma`` and ``flash_dkv_wgmma`` count the launches that took
the Hopper path (``csrc/attn_sm90.cuh`` and its pieces: wgmma, TMA, warp
specialisation), as subsets of ``flash``, ``flash_manual``, ``sta_pipe``,
``sta_window``, ``sta_row``, ``sta_batched``, ``flash_dq`` and
``flash_dkv``; the wrappers choose it by a rule (``ops/flash.py:
wgmma_path``, ``ops/sta_pipe.py:sta_wgmma_path``, ``ops/sta_window.py:
window_wgmma_path``, ``ops/sta_row.py:row_wgmma_path``,
``ops/sta_batched.py:batched_wgmma_path``, ``ops/flash_bwd.py:
bwd_wgmma_path``).  ``prologue_rows`` counts the prologue's launches of
its warp-per-row kernel (a subset of ``prologue``, by
``ops/prologue.py:prologue_layout``), ``unpool_rows`` unpool's launches of
its batched 16-byte copy in either mode (a subset of ``unpool`` +
``unpool_headmap``, by ``ops/coreset_pallas.py:unpool_layout``) and
``sta_diag_wgmma`` the bisection kernel's launches on the Hopper path (a
subset of ``sta_diag``, by ``tools/sta_diag.py:diag_wgmma_path``);
``fused_norm_range`` the norm's launches into a caller's ``out`` view (a
subset of ``fused_norm``: HunyuanVideo's token-replace row ranges).
The f32 modes of the f32 serving path count apart too, as subsets of
their kernel: ``flash_f32``, ``flash_manual_f32``, ``sta_pipe_f32`` and
``sta_batched_f32``, ``sta_window_f32`` and ``sta_row_f32``
(``csrc/attn_f32.cuh``'s FFMA core), ``fused_norm_f32``, ``prologue_f32``,
``pool_qkv_f32`` (of ``pool_qkv`` + ``pool_qkv_headmap``) and ``unpool_f32``
(of ``unpool`` + ``unpool_headmap``); those of the f32 training path's
backward, ``flash_dq_f32`` and ``flash_dkv_f32`` (``csrc/attn_f32_bwd.cuh``),
of ``flash_dq`` and ``flash_dkv``.  ``flash_f32_tc`` and
``flash_manual_f32_tc`` count the f32 launches on the tensor-core core
(``csrc/attn_f32_tc.cuh``: 3xTF32 on wgmma, by ``ops/flash.py:flash_f32_tc_path``
and ``f32_tc_path``),
subsets of ``flash_f32`` and ``flash_manual_f32``; they never count as
``*_wgmma``.  ``sta_pipe_f32_tc`` and ``sta_window_f32_tc`` count the
window walks' f32 launches on the tensor cores
(``csrc/window_walk_f32_tc.cuh``, by ``ops/sta_pipe.py:sta_f32_tc_path``),
subsets of ``sta_pipe_f32`` and ``sta_window_f32``, never of ``*_wgmma``.  The int8 QK mode with an f32 v counts in
both its modes' counters: ``flash_manual_f32`` and ``flash_manual_int8``,
``sta_pipe_f32`` and ``sta_pipe_int8``; ``flash_manual_int8_tc`` counts its
launches on the tensor cores (``csrc/attn_int8_tc.cuh``, by the same
``f32_tc_path``), a subset of ``flash_manual_int8``, never of
``flash_manual_f32_tc`` or ``*_wgmma``.
Headers (``*.cuh``) are part of the hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash", "fused_norm", "prologue", "flash_manual", "sta_pipe", "coreset_pool",
           "flash_bwd", "sta_batched", "sta_window", "sta_row", "sta_diag")
KERNELS = ("flash", "fused_norm", "prologue", "flash_manual", "sta_pipe", "pool_qkv", "unpool",
           "flash_lse", "flash_dq", "flash_dkv", "flash_manual_int8", "sta_pipe_int8",
           "sta_batched", "sta_window", "sta_row", "pool_qkv_headmap", "unpool_headmap",
           "copy_probe", "fused_residual_norm", "sta_diag", "flash_manual_stable",
           "sta_batched_stable", "sta_pipe_stable", "sta_pipe_dots", "sta_pipe_qk",
           "sta_pipe_sT", "flash_wgmma", "flash_manual_wgmma", "sta_pipe_wgmma",
           "sta_window_wgmma", "sta_batched_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma",
           "sta_row_wgmma", "prologue_rows", "sta_diag_wgmma", "unpool_rows",
           "fused_norm_range", "flash_f32", "flash_manual_f32", "sta_pipe_f32",
           "sta_batched_f32", "fused_norm_f32", "prologue_f32", "pool_qkv_f32", "unpool_f32",
           "flash_dq_f32", "flash_dkv_f32", "sta_window_f32", "sta_row_f32", "flash_f32_tc",
           "flash_manual_f32_tc", "flash_dq_f32_tc", "flash_dkv_f32_tc",
           "flash_manual_int8_tc", "sta_pipe_f32_tc", "sta_window_f32_tc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = {name: 0 for name in KERNELS}
ptxas_logs: dict = {}  # source -> nvcc's register / smem report (kept beside its library)
_libs: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every missing library in parallel; returns {name: path}."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    procs = {}
    for name, so in paths.items():
        if so.exists():
            report = so.with_suffix(".ptxas.txt")
            if name not in ptxas_logs and report.exists():
                ptxas_logs[name] = report.read_text()
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, err = proc.communicate()
        ptxas_logs[name] = (out + err).strip()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{err}")
            continue
        so.with_suffix(".ptxas.txt").write_text(ptxas_logs[name])
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all at first use."""
    if name not in _libs:
        paths = build_all()
        for n, p in paths.items():
            _libs.setdefault(n, ctypes.CDLL(str(p)))
    return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an int: the raw handle, as
    PyTorch's own kernel launchers read it, without building a Stream object
    (whose host time per call is of the order of a short kernel's run, and
    every wrapper pays it)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def aligned16(t):
    """``t`` itself where its data starts on a 16-byte boundary (what TMA and
    the bulk copies of the Hopper path need), else a copy; None stays None."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def forward_only(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would be asked for one: grad
    mode is on and an input requires grad.  Called only for tensors off the
    CPU (the plain versions are differentiable), so the graph is never cut
    silently."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward; call it under torch.no_grad() or "
            "detach its inputs")


def require_cuda(*tensors) -> torch.device:
    """All tensors on one CUDA device; returns it."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {dev}")
    return dev
