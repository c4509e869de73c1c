"""The f32 flash backward's dq and dk/dv alone at the trainer's calls (no
JAX counterpart: a timing tool for the port's kernels).

Calls, as the Wan-1.3B trainer makes them at a latent grid (``--grid``,
default 480p x 77f = (20, 30, 52)): FULL (the full expert's tables), LOWRES
(the lowres expert's, over the pooled sequence) and cross (31,200 queries
against 512 text keys, blocks 2048 x 512); the STA expert's at each
``--sta T H W tT tH tW`` (a latent grid and its tile; default the three
training tiles: 96 tokens at 480p x 77f, 360 at the bench router's 720p
grid (10, 45, 80), 24 at (8, 30, 52)); and dense tables at each ``--dense
SQ SKV BQ BKV`` (none by default).  f32 q / k / v / dO are drawn from
``--seed``, the forward's out and lse from ``sparse_flash_attention_raw``.
Per call, ``flash_backward`` with ``need_dkv=False`` (dq alone) and with
``need_dq=False`` (dk/dv alone) on the design its rule picks, and
``flash_backward_ffma`` beside it with ``--ffma``; first each gradient
against ``flash_backward_ref`` (worst |diff| / max(|plain|, RMS)).  Times
are CUDA events around ``--iters`` calls after a warm-up, ms per call, with
the card's name and power limit; with ``--device cpu`` (the plain versions,
at a small ``--grid`` and ``--heads``) the host's clock, a check that the
tool runs and not a measurement of the card.  One JSON line.

  python -m vorta_tpu_torch.tools.bench_f32_bwd --ffma
  python -m vorta_tpu_torch.tools.bench_f32_bwd --device cpu --grid 2 6 8 --heads 2 --iters 1 \
      --sta 4 6 8 4 6 4 --sta 4 6 8 2 3 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from ..cli.sample import attention_config
from ..device import full_f32, resolve_device
from ..ops.experts import (_dense_tables_cached, _full_tables, _lowres_tables, _sta_tables,
                           lowres_groups_for)
from ..ops.flash import dense_tables, sparse_flash_attention_raw
from ..ops.flash_bwd import (flash_backward, flash_backward_ffma, flash_backward_ref,
                             transpose_tables)

TEXT_LEN, CROSS_BLOCK_Q = 512, 2048
STA_CALLS = ((20, 30, 52, 4, 6, 4), (10, 45, 80, 5, 9, 8), (8, 30, 52, 2, 3, 4))


def calls(grid, heads: int, sta=STA_CALLS, dense=()) -> dict:
    """name -> (tables, sq, skv, valid kv, block_q, block_kv, heads)."""
    cfg = attention_config("wan-1_3B", tuple(grid))
    s, p = cfg.seq_len, lowres_groups_for(cfg).pooled_length
    full, full_q, full_kv = _full_tables(cfg)
    low, low_q, low_kv = _lowres_tables(cfg)
    nq = -(-s // CROSS_BLOCK_Q)
    out = {"full": (full, full_q, full_kv, s, cfg.block_q, cfg.block_kv, heads),
           "lowres": (low, low_q, low_kv, p, cfg.block_q, cfg.block_kv, heads),
           "cross": (_dense_tables_cached(nq, 1), nq * CROSS_BLOCK_Q, TEXT_LEN, TEXT_LEN,
                     CROSS_BLOCK_Q, TEXT_LEN, heads)}
    for *g, th, tw, tt in sta:  # the STA expert's raster tables: no tail, every block busy
        c = dataclasses.replace(attention_config("wan-1_3B", tuple(g)), sta_tile=(th, tw, tt))
        n, b = c.seq_len, c.tokens_per_tile
        out[f"sta{b}_{'x'.join(map(str, g))}"] = (_sta_tables(c), n, n, n, b, b, heads)
    for sq, skv, bq, bkv in dense:
        out[f"dense_{sq}x{skv}_blocks{bq}x{bkv}"] = (dense_tables(sq // bq, skv // bkv), sq, skv,
                                                     skv, bq, bkv, heads)
    return out


def _ms(fn, dev, iters: int) -> float:
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _worst(got, want) -> float:
    rms = want.pow(2).mean().sqrt()
    return ((got - want).abs() / torch.maximum(want.abs(), rms)).max().item()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None)
    ap.add_argument("--grid", type=int, nargs=3, default=(20, 30, 52))
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ffma", action="store_true",
                    help="time flash_backward_ffma beside each call")
    ap.add_argument("--sta", type=int, nargs=6, action="append",
                    metavar=("T", "H", "W", "tT", "tH", "tW"),
                    help="an STA call: latent grid and tile (repeatable; default the "
                         "three training tiles)")
    ap.add_argument("--dense", type=int, nargs=4, action="append", default=[],
                    metavar=("SQ", "SKV", "BQ", "BKV"), help="a dense-table call (repeatable)")
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
    for name, (tab, sq, skv, kvv, bq, bkv, h) in todo.items():
        q, dout = (torch.randn((1, h, sq, 128), generator=g, device=dev) for _ in range(2))
        k, v = (torch.randn((1, h, skv, 128), generator=g, device=dev) for _ in range(2))
        ki, kc = tab.on(dev)
        qi, qc = (torch.from_numpy(a).to(dev)
                  for a in transpose_tables(tab.kv_index, tab.kv_count, skv // bkv))
        kw = dict(scale=128**-0.5, block_q=bq, block_kv=bkv)
        fwd, lse = sparse_flash_attention_raw(q, k, v, ki, kc, return_lse=True,
                                              kv_valid_len=kvv if kvv != skv else None, **kw)
        args_bwd = (q, k, v, fwd, lse, dout, ki, kc, qi, qc)
        kw["kv_valid_len"] = kvv
        want = flash_backward_ref(q, k, v, fwd, lse, dout, ki, kc, **kw)
        got = flash_backward(*args_bwd, **kw)
        row = {"worst_ratio": max(_worst(a, w) for a, w in zip(got, want))}
        del want, got
        arms = (("", flash_backward),) + ((("ffma_", flash_backward_ffma),) if args.ffma else ())
        for prefix, fn in arms:
            for kind, alone in (("dq", "need_dkv"), ("dkv", "need_dq")):
                row[prefix + kind + "_ms"] = _ms(
                    lambda: fn(*args_bwd, **kw, **{alone: False}), dev, args.iters)
        out[name] = row
        print(f"{name}: {row}", flush=True)
        del q, k, v, dout, fwd, lse, args_bwd
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
