"""The f32 window walks alone at their served calls: sta_pipe's f32 mode and
sta_window's (no JAX counterpart: a timing tool for the port's kernels).

The calls (``--only`` keeps those whose names start with one of its words):
sta_pipe at Wan-1.3B 480p x 77f, tile (4, 6, 4), the fast softmax (the
routed f32 path's STA call); sta_window at 720p x 29f and 720p x 77f, tile
(4, 9, 10) (the ``--resume_dir`` f32 path's; 77f its reference shape); each
with ``--heads`` heads of which the routed pattern's 8 of 12 are active.
``--window KERNEL T H W tT tH tW`` replaces them with calls of its own
(repeatable).  f32 q / k / v are drawn from ``--seed``.  Per call, the
wrapper on the design its rule picks (``ops/sta_pipe.py:sta_f32_tc_path``)
and, with ``--ffma``, ``sta_pipe_attention_ffma`` / ``sta_window_attention_ffma``
at the same call, timed in turns (design, FFMA, design, FFMA); first each
against the plain version (worst |diff| / max(|plain|, RMS)).  Beside the
times: the 3xTF32 bound (3 x 4 x S x keys x 128 FLOP a head at 495 TFLOP/s
TF32) and the FFMA-rated one (67 TFLOP/s f32), and the launches each arm
counted.  Times are CUDA events around ``--iters`` calls after a warm-up,
ms per call, with the card's name and power limit; with ``--device cpu``
(the plain versions, at a small ``--window``) the host's clock, a check
that the tool runs and not a measurement of the card.  One JSON line.

  python -m vorta_tpu_torch.tools.bench_f32_window --ffma
  python -m vorta_tpu_torch.tools.bench_f32_window --ffma --only sta_pipe --iters 5
  python -m vorta_tpu_torch.tools.bench_f32_window --device cpu --heads 3 --iters 1 \\
      --window sta_window 4 6 16 2 3 8
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from ..device import full_f32, resolve_device
from ..ops import _build
from ..ops.sta_pipe import sta_pipe_attention, sta_pipe_attention_ffma, sta_pipe_attention_ref
from ..ops.sta_window import (sta_window_attention, sta_window_attention_ffma,
                              sta_window_attention_ref)
from .bench_f32_bwd import _ms, _worst

CALLS = {  # name: (kernel, latent grid, tile)
    "sta_pipe_480p_77f": ("sta_pipe", (20, 30, 52), (4, 6, 4)),
    "sta_window_720p_29f": ("sta_window", (8, 45, 80), (4, 9, 10)),
    "sta_window_720p_77f": ("sta_window", (20, 45, 80), (4, 9, 10)),
}
ARMS = {"sta_pipe": (sta_pipe_attention, sta_pipe_attention_ffma, sta_pipe_attention_ref),
        "sta_window": (sta_window_attention, sta_window_attention_ffma,
                       sta_window_attention_ref)}
ACTIVE = (1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 0)  # the routed pattern: 8 of 12 heads
PEAK_TF32, PEAK_F32 = 495e12, 67e12


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ffma", action="store_true",
                    help="time the FFMA core beside each call, in turns")
    ap.add_argument("--window", nargs=7, action="append",
                    metavar=("KERNEL", "T", "H", "W", "tT", "tH", "tW"),
                    help="a call of sta_pipe or sta_window (repeatable; replaces the defaults)")
    ap.add_argument("--only", nargs="+", default=None, help="keep calls whose names start so")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_f32(dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    todo = dict(CALLS)
    if args.window:
        todo = {}
        for kernel, *dims in args.window:
            if kernel not in ARMS:
                raise SystemExit(f"--window: kernel {kernel!r} not in {sorted(ARMS)}")
            shape, tile = tuple(map(int, dims[:3])), tuple(map(int, dims[3:]))
            todo[f"{kernel}_{'x'.join(map(str, shape))}_{'x'.join(map(str, tile))}"] = (
                kernel, shape, tile)
    if args.only is not None:
        todo = {n: c for n, c in todo.items() if any(n.startswith(o) for o in args.only)}
    act = torch.tensor([ACTIVE[i % len(ACTIVE)] for i in range(args.heads)], device=dev)
    n_act = int(act.sum().item())
    for name, (kernel, shape, tile) in todo.items():
        s = math.prod(shape)
        keys = math.prod(min(3, shape[a] // tile[a]) * tile[a] for a in range(3))
        q, k, v = (torch.randn((1, args.heads, s, 128), generator=g, device=dev)
                   for _ in range(3))
        kw = dict(latent_shape=shape, tile=tile, window=(3, 3, 3), scale=128**-0.5)
        fn, ffma, plain = ARMS[kernel]
        arms = (("", fn),) + ((("ffma_", ffma),) if args.ffma else ())
        want = plain(q, k, v, act, **kw)
        flops = 4.0 * s * keys * 128 * n_act
        row = {"kernel": kernel, "latent_shape": shape, "tile": tile, "heads": args.heads,
               "active_heads": n_act, "window_keys": keys,
               "bound_ms": 3 * flops / PEAK_TF32 * 1e3, "ffma_bound_ms": flops / PEAK_F32 * 1e3}
        for prefix, arm in arms:
            _build.reset_launches()
            got = arm(q, k, v, act, **kw)
            row[prefix + "worst_ratio"] = _worst(got, want)
            row[prefix + "launches"] = {c: _build.launches[c] for c in
                                        (kernel, f"{kernel}_f32", f"{kernel}_f32_tc")}
            del got
        del want
        times = {prefix: [] for prefix, _ in arms}
        for _ in range(2):
            for prefix, arm in arms:
                times[prefix].append(_ms(lambda: arm(q, k, v, act, **kw), dev, args.iters))
        for prefix, ms in times.items():
            row[prefix + "ms"] = sum(ms) / len(ms)
            row[prefix + "ms_turns"] = ms
            row[prefix + "bound_share"] = row[prefix + "bound_ms"] / row[prefix + "ms"]
        out[name] = row
        print(f"{name}: {row}", flush=True)
        del q, k, v
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
