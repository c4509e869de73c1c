"""The f32 flash forward with its lse alone at the trainer's calls (no JAX
counterpart: a timing tool for the port's kernels).

The calls of ``tools/bench_f32_bwd`` (``--grid``, ``--sta``, ``--dense``;
``--only`` keeps the named ones): FULL, LOWRES, cross, the STA expert's
tiles and dense tables.  f32 q / k / v are drawn from ``--seed``.  Per call,
``sparse_flash_attention_raw`` with ``return_lse`` on the design its rule
picks (``ops/flash.py:flash_f32_tc_path``) and, with ``--ffma``,
``sparse_flash_attention_ffma`` at the same call, timed in turns (design,
FFMA, design, FFMA); first each against ``sparse_flash_attention_ref``
(worst |diff| / max(|plain|, RMS) of out, max |diff| of the lse).  Times are
CUDA events around ``--iters`` calls after a warm-up, ms per call, with the
card's name and power limit; with ``--device cpu`` (the plain versions, at a
small ``--grid`` and ``--heads``) the host's clock, a check that the tool
runs and not a measurement of the card.  One JSON line.

  python -m vorta_tpu_torch.tools.bench_f32_fwd --ffma
  python -m vorta_tpu_torch.tools.bench_f32_fwd --ffma --only full --iters 5
  python -m vorta_tpu_torch.tools.bench_f32_fwd --ffma --only - --dense 4096 4096 16 16
  python -m vorta_tpu_torch.tools.bench_f32_fwd --device cpu --grid 2 6 8 --heads 2 --iters 1 \\
      --sta 4 6 8 4 6 4
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..device import full_f32, resolve_device
from ..ops.flash import (sparse_flash_attention_ffma, sparse_flash_attention_raw,
                         sparse_flash_attention_ref)
from .bench_f32_bwd import STA_CALLS, _ms, _worst, calls


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None)
    ap.add_argument("--grid", type=int, nargs=3, default=(20, 30, 52))
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ffma", action="store_true",
                    help="time sparse_flash_attention_ffma beside each call, in turns")
    ap.add_argument("--sta", type=int, nargs=6, action="append",
                    metavar=("T", "H", "W", "tT", "tH", "tW"),
                    help="an STA call: latent grid and tile (repeatable; default the "
                         "three training tiles)")
    ap.add_argument("--dense", type=int, nargs=4, action="append", default=[],
                    metavar=("SQ", "SKV", "BQ", "BKV"), help="a dense-table call (repeatable)")
    ap.add_argument("--only", nargs="+", default=None,
                    help="keep these calls (names or prefixes: full, lowres, cross, sta96, ...) "
                         "and every --dense call; '-' keeps the --dense calls alone")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_f32(dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    todo = calls(args.grid, args.heads, args.sta or STA_CALLS, args.dense)
    if args.only is not None:
        todo = {n: c for n, c in todo.items()
                if n.startswith("dense_") or any(n.startswith(o) for o in args.only)}
    for name, (tab, sq, skv, kvv, bq, bkv, h) in todo.items():
        q = torch.randn((1, h, sq, 128), generator=g, device=dev)
        k, v = (torch.randn((1, h, skv, 128), generator=g, device=dev) for _ in range(2))
        ki, kc = tab.on(dev)
        kw = dict(scale=128**-0.5, block_q=bq, block_kv=bkv, return_lse=True,
                  kv_valid_len=kvv if kvv != skv else None)
        arms = (("", sparse_flash_attention_raw),) + (
            (("ffma_", sparse_flash_attention_ffma),) if args.ffma else ())
        want, want_lse = sparse_flash_attention_ref(q, k, v, ki, kc, **kw)
        row = {}
        for prefix, fn in arms:
            got, lse = fn(q, k, v, ki, kc, **kw)
            row[prefix + "worst_ratio"] = _worst(got, want)
            row[prefix + "lse_max_err"] = (lse - want_lse).abs().max().item()
            del got, lse
        del want, want_lse
        times = {prefix: [] for prefix, _ in arms}
        for _ in range(2):
            for prefix, fn in arms:
                times[prefix].append(_ms(lambda: fn(q, k, v, ki, kc, **kw), dev, args.iters))
        for prefix, ms in times.items():
            row[prefix + "ms"] = sum(ms) / len(ms)
            row[prefix + "ms_turns"] = ms
        out[name] = row
        print(f"{name}: {row}", flush=True)
        del q, k, v
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
