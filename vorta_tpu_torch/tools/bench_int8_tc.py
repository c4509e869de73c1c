"""flash_manual's int8 QK mode with an f32 v alone at the three calls the
``--dtype fp32 --qk_int8`` paths serve (no JAX counterpart: a timing tool
for the port's kernel).

Calls: Wan-1.3B's routed FULL and LOWRES at a latent grid (``--grid``,
default 480p x 77f = (20, 30, 52)), 12 heads with 8 routed to the expert,
and HunyuanVideo-13B's joint FULL layout at ``--hy_grid`` (default 720p x
45f = (12, 45, 80)) with the text padding's ``kv_bias`` (83 of 256 text
tokens valid), 24 heads with 8 routed; q, k, v f32 drawn from ``--seed``, q
and k quantized per head (``ops/routed_fused.py:quantize_qk``) as the
routed dispatch does.  Per call, ``sparse_flash_attention_manual`` on the
design its rule picks (the tensor-core kernel, ``csrc/attn_int8_tc.cuh``,
at these shapes), first against ``sparse_flash_attention_manual_ref``
(worst |diff| / max(|plain|, RMS)), then timed, and with ``--ffma`` the
dp4a / FFMA mode (``sparse_flash_attention_manual_ffma``) timed beside it
in turns.  Times are CUDA events around ``--iters`` calls after a warm-up,
ms per call, with the card's name and power limit; with ``--device cpu``
(the plain version, at a small ``--grid`` / ``--hy_grid``) the host's
clock, a check that the tool runs and not a measurement of the card.  One
JSON line.

  python -m vorta_tpu_torch.tools.bench_int8_tc --ffma
  python -m vorta_tpu_torch.tools.bench_int8_tc --device cpu --grid 4 6 8 --hy_grid 6 9 8 --iters 1
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..cli.sample import attention_config
from ..device import full_f32, resolve_device
from ..ops.flash import dense_tables
from ..ops.flash_manual import (sparse_flash_attention_manual, sparse_flash_attention_manual_ffma,
                                sparse_flash_attention_manual_ref)
from ..ops.joint_experts import JointConfig, _bias, joint_layouts
from ..ops.routed_fused import quantize_qk, routed_geometry
from .bench_f32_bwd import _ms, _worst

HY_TEXT, HY_VALID = 256, 83


def calls(grid, hy_grid) -> dict:
    """name -> (heads, seq, block_q, block_kv, kv_valid_len, tables, routed heads mask,
    kv_bias or None as a function of the device)."""
    geo = routed_geometry(attention_config("wan-1_3B", tuple(grid)))
    wan_act = [int(i % 3 != 2) for i in range(12)]
    hcfg = attention_config("hunyuan-13B", tuple(hy_grid))
    lay = joint_layouts(JointConfig(hcfg, HY_TEXT))["full"]

    def hy_bias(dev):
        return _bias((torch.arange(HY_TEXT, device=dev) < HY_VALID)[None], lay, hcfg.seq_len)

    return {
        "full": (12, geo.full.q_pad, geo.full.block_q, geo.full.block_kv, geo.full.valid_len,
                 geo.full.tables, wan_act, None),
        "lowres": (12, geo.lowres.q_pad, geo.lowres.block_q, geo.lowres.block_kv,
                   geo.lowres.valid_len, geo.lowres.tables, wan_act, None),
        "hunyuan_joint_full_kv_bias": (
            24, lay.total, lay.block_q, lay.block_kv, None,
            dense_tables(lay.total // lay.block_q, lay.total // lay.block_kv),
            [int(i % 3 == 0) for i in range(24)], hy_bias),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None)
    ap.add_argument("--grid", type=int, nargs=3, default=(20, 30, 52))
    ap.add_argument("--hy_grid", type=int, nargs=3, default=(12, 45, 80))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=24)
    ap.add_argument("--ffma", action="store_true",
                    help="time the dp4a / FFMA mode beside each call")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_f32(dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for name, (h, s, bq, bkv, valid, tab, act, bias) in calls(args.grid, args.hy_grid).items():
        q8, k8, qk_scale = quantize_qk(*(torch.randn((1, h, s, 128), generator=g, device=dev)
                                         for _ in range(2)))
        v = torch.randn((1, h, s, 128), generator=g, device=dev)
        ki, kc = tab.on(dev)
        cnt = torch.where(torch.tensor(act, device=dev)[:, None] > 0, kc, 0).to(torch.int32)
        kw = dict(scale=128**-0.5, block_q=bq, block_kv=bkv, kv_valid_len=valid,
                  kv_bias=None if bias is None else bias(dev), softmax="fast",
                  qk_scale=qk_scale)
        rows = slice(0, valid or s)
        want = sparse_flash_attention_manual_ref(q8, k8, v, ki, cnt, **kw)[:, :, rows]
        row = {"worst_ratio": _worst(sparse_flash_attention_manual(q8, k8, v, ki, cnt, **kw)
                                     [:, :, rows], want)}
        del want
        arms = (("", sparse_flash_attention_manual),) + (
            (("ffma_", sparse_flash_attention_manual_ffma),) if args.ffma and dev.type == "cuda"
            else ())
        for _ in range(2):  # in turns: kernel, yardstick, kernel, yardstick
            for prefix, fn in arms:
                ms = _ms(lambda: fn(q8, k8, v, ki, cnt, **kw), dev, args.iters)
                row[f"{prefix}ms"] = row.get(f"{prefix}ms", 0.0) + ms / 2
        out[name] = row
        print(f"{name}: {row}", flush=True)
        del q8, k8, v
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
