"""Where one Wan or HunyuanVideo forward's device time goes, on the GPU.

Runs the model (random weights from a seed) once to warm up, then once
under ``torch.profiler``, and prints the device time per kernel group (the
port's kernels, matmuls, the rest), the top kernels by device time, and the
device's idle share over the profiled forward (traced and aggregated by
io/profiling.py), and the ops that fill the "other" group by name.  ``--routing hard`` routes
each head with the CLI's attention geometry (``--sta_tile`` overrides the
tile) and random routers, or the routers of ``--router`` (an npz of the JAX
package's router training, io/from_jax.load_router_npz).  Those routers
were trained against the JAX benchmark model (``nnx.Rngs(0)``) and read its
timestep embedding, so ``--router`` also loads that model's time embedder
(``port_assets/``, io/from_jax.load_jax_params).  ``--train`` profiles one
router-training micro-step instead (training/step.py: soft routing with the
teacher interleaved, per-block recompute, the backward to the routers),
at the trainer's geometry (``--sta_tile`` overrides its tile), after one
warm-up micro-step; with ``--model hunyuan-13B`` HunyuanVideo's
(make_hunyuan_router_train_step, the teacher in "off_ref", guidance 1000)
at its trainer's geometry (tile (6, 9, 8)), and the device time inside the
joint experts' plain attention (the soft student's and the teacher's,
forward and recompute backward) is reported apart (``ranges``).  ``--model
hunyuan-13B`` profiles HunyuanVideo-13B (60 blocks, random weights and
routers, random text states with 83 of 256 tokens valid, embedded guidance
6.0) at the CLI's attention geometry, routing off or hard.  The sample
CLI's quantized serving flags apply as there: ``--qk_int8``, ``--mm int8``,
``--act_scales x.npz`` and ``--quantize_blocks int4|int8`` (with ``--model
wan-14B`` too).  ``--vae wan|hunyuan`` profiles one decode of that VAE
(full width, random bf16 weights) at the video's latent shape instead,
whole-clip or, with ``--vae_tiling``, in tiles (models/vae_tiling.py).
``--dtype fp32`` builds the DiT in f32 (every kernel in its f32 mode, TF32
off, as ``cli.train --dtype fp32`` / ``cli.sample --dtype fp32`` run it),
e.g. to split an f32 training micro-step's device time by op; of the
quantized flags it takes ``--qk_int8`` (int8 q / k with an f32 v, as
``cli.sample --dtype fp32 --qk_int8`` serves).

  python -m vorta_tpu_torch.cli.profile_forward --num_frames 21 --height 480 --width 832
  python -m vorta_tpu_torch.cli.profile_forward --num_frames 77 --routing hard
  python -m vorta_tpu_torch.cli.profile_forward --num_frames 77 --height 720 --width 1280 \
      --routing hard --sta_tile 5 9 8 --t 500 \
      --router assets/bench_router_wan1_3b_720p_half.npz
  python -m vorta_tpu_torch.cli.profile_forward --num_frames 77 --train
  python -m vorta_tpu_torch.cli.profile_forward --num_frames 77 --train --dtype fp32
  python -m vorta_tpu_torch.cli.profile_forward --num_frames 77 --routing hard --dtype fp32 --qk_int8
  python -m vorta_tpu_torch.cli.profile_forward --num_frames 37 --height 720 --width 1280 \
      --train --sta_tile 5 9 8   # the bench router's training geometry
  python -m vorta_tpu_torch.cli.profile_forward --model hunyuan-13B --num_frames 45 \
      --height 720 --width 1280 --routing hard
  python -m vorta_tpu_torch.cli.profile_forward --model hunyuan-13B --num_frames 45 \
      --height 720 --width 1280 --t 500 --qk_int8 --mm int8
  python -m vorta_tpu_torch.cli.profile_forward --model hunyuan-13B --num_frames 21 \
      --height 432 --width 768 --train   # HunyuanVideo router training, (6, 27, 48)
  python -m vorta_tpu_torch.cli.profile_forward --num_frames 77 --height 720 --width 1280 \
      --routing hard --sta_tile 4 9 10 --t 500   # the STA heads through sta_window
  python -m vorta_tpu_torch.cli.profile_forward --model hunyuan-13B --num_frames 45 \
      --height 720 --width 1280 --routing hard --sta_tile 2 9 8 --t 500   # sta_batched
  python -m vorta_tpu_torch.cli.profile_forward --vae wan --num_frames 77
  python -m vorta_tpu_torch.cli.profile_forward --vae hunyuan --num_frames 45 \
      --height 720 --width 1280 --vae_tiling
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from ..config import WAN_1_3B, WAN_14B, AttentionConfig
from ..device import full_f32, resolve_device
from ..geometry import HUNYUAN_GEOMETRY, WAN_GEOMETRY
from ..io import profiling
from ..io.from_jax import load_act_scales, load_trained_router
from ..io.quant_serving import build_quantized_hunyuan, build_quantized_wan
from ..models.hunyuan import HUNYUAN_13B, HunyuanModel
from ..models.wan import WanModel
from .sample import attention_config

# text tokens the HunyuanVideo profile marks valid: not a multiple of 8 or 16,
# so the kernels' text-padding bias really masks (PERF.md's profiles)
TEXT_VALID = 83

# named ranges (torch.profiler.record_function) whose device time is reported
RANGES = ("joint_reference_attention", "joint_reference_attention_backward")

GROUPS = (  # first match wins: "unpool_kernel" contains "pool_kernel"
    ("flash", ("flash_fwd_kernel", "flash_sm90_kernel", "flash_f32_kernel",
               "flash_f32_tc_kernel")),
    ("flash_dq", ("flash_dq_kernel", "flash_dq_sm90_kernel", "flash_dq_f32_kernel",
                  "flash_dq_f32_tc_kernel")),
    ("flash_dkv", ("flash_dkv_kernel", "flash_dkv_sm90_kernel", "flash_dkv_f32_kernel",
                   "flash_dkv_f32_tc_kernel")),
    # the tensor-core f32 kernels' split pre-passes (forward and backward)
    ("f32_tc_split", ("f32_tc_split_rows_kernel", "f32_tc_split_t_kernel")),
    ("flash_manual", ("flash_manual_kernel", "flash_manual_sm90_kernel",
                      "flash_manual_f32_kernel", "flash_manual_f32_tc_kernel",
                      "flash_manual_int8_tc_kernel")),
    ("sta_pipe", ("sta_kernel", "sta_pipe_sm90_kernel", "sta_pipe_f32_kernel")),
    # sta_row's Hopper path is sta_window_sm90_kernel too (one kernel, two
    # wrappers): no served geometry reaches sta_row
    ("sta_window", ("sta_window_kernel", "sta_window_sm90_kernel", "sta_window_f32_kernel")),
    ("sta_row", ("sta_row_kernel", "sta_row_f32_kernel")),
    ("sta_batched", ("sta_batched_kernel", "sta_batched_sm90_kernel", "sta_batched_live_kernel",
                     "sta_batched_f32_kernel")),
    ("unpool", ("unpool_kernel", "unpool_rows_kernel")),
    ("pool_qkv", ("pool_kernel",)),
    ("fused_norm", ("fused_norm_kernel", "fused_norm_rows_kernel")),
    ("qk_prologue", ("prologue_kernel", "prologue_rows_kernel")),
    ("matmul", ("gemm", "sm90_xmma", "cutlass", "nvjet", "cublas", "conv")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="wan-1_3B", choices=["wan-1_3B", "wan-14B", "hunyuan-13B"])
    p.add_argument("--num_frames", type=int, default=21)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--routing", default="off", choices=["off", "hard"])
    p.add_argument("--sta_tile", type=int, nargs=3, default=None)
    p.add_argument("--router", default=None, help="router npz (routing hard)")
    p.add_argument("--t", type=float, default=900.0, help="timestep")
    p.add_argument("--train", action="store_true",
                   help="profile one router-training micro-step instead of a forward")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                   help="the DiT's dtype; fp32: every kernel in its f32 mode, TF32 off")
    p.add_argument("--mm", default="bf16", choices=["bf16", "int8"])
    p.add_argument("--qk_int8", action="store_true")
    p.add_argument("--act_scales", default=None, help="npz {site: (L,)} static int8 scales")
    p.add_argument("--quantize_blocks", default=None, choices=["int4", "int8"])
    p.add_argument("--vae", default=None, choices=["wan", "hunyuan"],
                   help="profile one decode of this VAE instead of a forward")
    p.add_argument("--vae_tiling", action="store_true", help="with --vae: a tiled decode")
    args = p.parse_args(argv)
    if args.router and args.model != "wan-1_3B":
        p.error("--router profiles Wan-1.3B only")
    if args.train and args.model == "wan-14B":
        p.error("--train profiles Wan-1.3B or HunyuanVideo-13B")
    quant = args.mm != "bf16" or args.qk_int8 or args.act_scales or args.quantize_blocks
    if args.train and quant:
        p.error("the quantized serving flags profile forwards, not training")
    if args.dtype == "fp32" and (args.mm != "bf16" or args.act_scales or args.quantize_blocks
                                 or args.vae):
        p.error("--dtype fp32 profiles the DiT unquantized but for --qk_int8 (as cli.sample "
                "--dtype fp32 serves it)")

    device = resolve_device("cuda")
    dtype = torch.float32 if args.dtype == "fp32" else torch.bfloat16
    if dtype == torch.float32:
        full_f32(device)
    serve = dict(mm_precision=args.mm,
                 act_scales=load_act_scales(args.act_scales) if args.act_scales else None)
    bits = int(args.quantize_blocks[3:]) if args.quantize_blocks else None
    if args.vae:
        latent, run = _vae_decode(args, device)
        args.model = f"{args.vae} VAE{' tiled' if args.vae_tiling else ''}"
        return _profile(args, 0, latent, None, run, device)
    if args.model == "hunyuan-13B":
        grid, attn, run = _hunyuan_forward(args, device, serve, bits, dtype)
        return _profile(args, HUNYUAN_13B.dual_layers + HUNYUAN_13B.single_layers, grid, attn,
                        run, device)
    cfg = WAN_14B if args.model == "wan-14B" else WAN_1_3B
    grid = WAN_GEOMETRY.tokens((args.num_frames, args.height, args.width))
    if bits:
        model, serve["quantized_blocks"] = build_quantized_wan(cfg, bits, seed=0,
                                                               device=device)
    else:
        model = WanModel(cfg, dtype=dtype, device=device, seed=0)
    g = torch.Generator(device=device).manual_seed(1)
    lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], cfg.in_channels), generator=g,
                      device=device)
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g, device=device)
    t = torch.tensor([args.t], device=device)
    attn = AttentionConfig(latent_shape=grid, qk_int8=args.qk_int8)
    if args.routing == "hard":
        attn = dataclasses.replace(attention_config("wan-1_3B", grid), qk_int8=args.qk_int8)
        if args.sta_tile:
            attn = dataclasses.replace(attn, sta_tile=tuple(args.sta_tile))
        if args.router:
            load_trained_router(model, args.router)
    if args.train:
        attn = attention_config("wan-1_3B", grid)
        if args.sta_tile:
            attn = dataclasses.replace(attn, sta_tile=tuple(args.sta_tile))
        run = _train_micro_step(model, attn, lat, ctx, t)
    else:
        def run():
            with torch.inference_mode():
                return model(lat, t, ctx, attn_cfg=attn, routing_mode=args.routing, **serve)
    return _profile(args, cfg.num_layers, grid, attn, run, device)


def _hunyuan_forward(args, device, serve: dict, bits, dtype):
    """(grid, attention config, closure of one HunyuanVideo-13B forward) at
    the CLI's geometry."""
    cfg = HUNYUAN_13B
    grid = HUNYUAN_GEOMETRY.tokens((args.num_frames, args.height, args.width))
    attn = dataclasses.replace(attention_config("hunyuan-13B", grid), qk_int8=args.qk_int8)
    if args.sta_tile:
        attn = dataclasses.replace(attn, sta_tile=tuple(args.sta_tile))
    if args.train:
        return grid, attn, _hunyuan_train_micro_step(args, attn, grid, device, dtype)
    if bits:
        model, serve["quantized_blocks"] = build_quantized_hunyuan(cfg, bits, seed=0,
                                                                   device=device)
    else:
        model = HunyuanModel(cfg, dtype=dtype, device=device, seed=0)
    g = torch.Generator(device=device).manual_seed(1)
    lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], cfg.in_channels), generator=g,
                      device=device)
    text = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g, device=device)
    pooled = torch.randn((1, cfg.pooled_dim), generator=g, device=device)
    mask = (torch.arange(cfg.text_len, device=device) < TEXT_VALID)[None]
    t = torch.tensor([args.t], device=device)
    guidance = torch.tensor([6000.0], device=device)

    def run():
        with torch.inference_mode():
            return model(lat, t, text, mask, pooled, guidance=guidance, attn_cfg=attn,
                         routing_mode=args.routing, **serve)
    return grid, attn, run


def _hunyuan_train_micro_step(args, attn, grid, device, dtype):
    """One HunyuanVideo-13B router-training micro-step at timestep ``t``:
    loss, then the router gradients (as ``_train_micro_step``)."""
    from ..schedulers.flow_match import train_sigmas
    from ..training.step import LossWeights, make_hunyuan_router_train_step, router_partition

    cfg = HUNYUAN_13B
    model = HunyuanModel(cfg, dtype=dtype, device=device, seed=0)
    routers = list(router_partition(model).values())
    g = torch.Generator(device=device).manual_seed(1)
    lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], cfg.in_channels), generator=g,
                      device=device)
    text = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g, device=device)
    pooled = torch.randn((1, cfg.pooled_dim), generator=g, device=device)
    mask = (torch.arange(cfg.text_len, device=device) < TEXT_VALID)[None]
    eps = torch.randn(lat.shape, generator=g, device=device)
    sig = train_sigmas(5.0)
    t = torch.tensor([args.t], device=device)
    sigma = torch.tensor([float(sig[int((1000.0 - args.t))])], device=device)
    step = make_hunyuan_router_train_step(attn, LossWeights(), timestep_table=sig * 1000.0,
                                          sigma_table=sig)

    def run():
        loss, _ = step.loss(model, lat, text, mask, pooled, t, sigma, eps)
        return torch.autograd.grad(loss, routers)

    return run


def _vae_decode(args, device):
    """(latent grid, closure of one decode): the VAE at full width, random
    bf16 weights from a seed, latents of the requested video."""
    from ..models.hunyuan_vae import HUNYUAN_VAE, HunyuanVAE
    from ..models.vae_tiling import tiled_decode
    from ..models.wan_vae import WAN_VAE, WanVAE

    vae = (WanVAE(WAN_VAE, dtype=torch.bfloat16, device=device) if args.vae == "wan"
           else HunyuanVAE(HUNYUAN_VAE, dtype=torch.bfloat16, device=device))
    latent = ((args.num_frames - 1) // 4 + 1, args.height // 8, args.width // 8)
    z = torch.randn((1, *latent, 16), generator=torch.Generator(device=device).manual_seed(1),
                    device=device)

    def run():
        with torch.inference_mode():
            if args.vae_tiling:
                return tiled_decode(lambda zz: vae.decode(zz, denormalize=False), z)
            return vae.decode(z, denormalize=False)
    return latent, run


def _profile(args, layers: int, grid, attn, run, device) -> dict:
    run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory(prefix="vorta_trace_") as tmp:
        with profiling.device_trace(tmp) as trace_dir:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the device's kernels, copies and sets by name; the device time of
        # the kernels launched inside each named range
        kernels = {name: [ms, n] for name, ms, n in profiling.op_durations(trace_dir, top=None)}
        ranges = profiling.range_device_ms(trace_dir, RANGES)
    device_ms = sum(v[0] for v in kernels.values())
    groups: dict = {}
    for name, (ms, n) in kernels.items():
        gname = _group(name)
        acc = groups.setdefault(gname, [0.0, 0])
        acc[0] += ms
        acc[1] += n
    heads = None
    if args.routing == "hard" and not args.train:
        heads = dict(zip(("full", "lowres", "sta"),
                         np.bincount(out.expert_ids.reshape(-1), minlength=3).tolist()))
    result = {
        "model": args.model, "dtype": args.dtype, "tokens": grid[0] * grid[1] * grid[2],
        "layers": layers,
        "quantization": {"mm": args.mm, "qk_int8": args.qk_int8,
                         "act_scales": args.act_scales, "quantize_blocks": args.quantize_blocks},
        "routing": "soft (train micro-step)" if args.train else args.routing, "t": args.t,
        "sta_tile": attn.sta_tile if heads or args.train else None,
        "max_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30,
        "heads_per_expert": heads,
        "wall_ms": wall_ms, "device_ms": device_ms,
        "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "groups": {k: {"ms": v[0], "launches": v[1], "share": v[0] / device_ms}
                   for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0])},
        "ranges": {k: {"ms": v, "share": v / device_ms} for k, v in ranges.items()},
        "top": [{"kernel": name[:90], "ms": ms, "launches": n}
                for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])
                [:12]],
        # what fills the "other" group, by op name (long enough to show the functor)
        "other_top": [{"kernel": name[:240], "ms": ms, "launches": n}
                      for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])
                      if _group(name) == "other"][:15],
        "device": torch.cuda.get_device_name(device),
    }
    print(json.dumps(result, indent=1))
    return result


def _train_micro_step(model, attn, lat, ctx, t):
    """One micro-step of the trainer at timestep ``t``: loss, then the
    router gradients (the optimizer's update is a few hundred elementwise
    launches over 0.1% of the parameters, left out)."""
    from ..schedulers.flow_match import train_sigmas
    from ..training.step import LossWeights, make_router_train_step, router_partition

    routers = list(router_partition(model).values())
    sig = train_sigmas(5.0)
    step = make_router_train_step(attn, LossWeights(), timestep_table=sig * 1000.0,
                                  sigma_table=sig)
    sigma = torch.tensor([float(sig[int((1000.0 - t.item()))])], device=t.device)
    eps = torch.randn(lat.shape, generator=torch.Generator(lat.device).manual_seed(2),
                      device=lat.device)

    def run():
        loss, _ = step.loss(model, lat, ctx, t, sigma, eps)
        return torch.autograd.grad(loss, routers)

    return run


if __name__ == "__main__":
    main()
