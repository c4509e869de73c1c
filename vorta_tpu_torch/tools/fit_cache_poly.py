"""Fit the step cache's rescale polynomial (counterpart of the JAX package's
tools/fit_cache_poly.py, the TeaCache recipe), on the GPU.

The cache's skip indicator is the rel-L1 distance between adjacent steps'
timestep modulations (temb6); what it should bound is the rel-L1 change of
the block stack's output delta.  A short flow-match Euler trajectory
records per step

  x = rel_l1(ind_t, ind_{t-1})        (the cheap indicator)
  y = rel_l1(resid_t, resid_{t-1})    (the expensive truth)

of the conditional forward (the model's ``return_hidden_delta`` probe) and
fits y ~ poly(x) of degree ``--degree``.  With ``--guidance_scale > 1`` an
unconditional forward (zero text) steers the trajectory by CFG; the
recorded pairs stay the conditional arm's.  Writes an npz of
``coefficients`` (highest degree first), ``indicator`` and ``residual``
that ``cli.sample --cache_poly`` reads, and prints a last JSON line with
the fit's r2.

Weights are random from ``--seed`` unless ``--torch_checkpoint`` names a
diffusers checkpoint; ``--router`` loads the JAX package's trained routers
(with the time embedder they were trained against, at Wan-1.3B's width and
without a checkpoint).  ``wan-tiny`` runs in f32, as the JAX tool builds
it (on the card through the kernels' f32 modes, TF32 off).

  python -m vorta_tpu_torch.tools.fit_cache_poly --model wan-1_3B --num_frames 77 \\
      --height 480 --width 832 --steps 8 --guidance_scale 5 \\
      --router assets/bench_router_wan1_3b.npz --out results/port/cache_poly.npz
  python -m vorta_tpu_torch.tools.fit_cache_poly --device cpu --steps 8 --out results/port/cache_poly_tiny.npz
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..cli.sample import random_embeds
from ..config import WAN_1_3B, WAN_14B, WAN_TINY, AttentionConfig
from ..device import full_f32, resolve_device
from ..geometry import WAN_GEOMETRY
from ..io.from_jax import load_trained_router
from ..io.torch_import import load_wan_torch_weights
from ..models.wan import WanModel
from ..ops.stepcache import rel_l1
from ..pipelines.wan_t2v import WanT2VPipeline
from ..schedulers.flow_match import FlowMatchEulerSchedule

MODELS = {"wan-tiny": WAN_TINY, "wan-1_3B": WAN_1_3B, "wan-14B": WAN_14B}


def probe_attention_config(model: str, grid) -> AttentionConfig:
    """The JAX tool's geometry: the tiny one, or tile (5, 9, 8) where it
    divides the grid's height and width, else (4, 6, 4)."""
    if model == "wan-tiny":
        return AttentionConfig(latent_shape=grid, sta_window=(3, 3, 1), sta_tile=(2, 2, 2),
                               lowres_window=(2, 2, 2), block_q=16, block_kv=16,
                               sta_block_q=8, sta_block_kv=8)
    tile = (5, 9, 8) if grid[1] % 9 == 0 and grid[2] % 8 == 0 else (4, 6, 4)
    return AttentionConfig(latent_shape=grid, sta_window=(3, 3, 3), sta_tile=tile,
                           lowres_window=(2, 3, 2))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="wan-tiny", choices=sorted(MODELS))
    p.add_argument("--torch_checkpoint", default=None)
    p.add_argument("--router", default=None,
                   help="trained-router npz (e.g. assets/bench_router_wan1_3b.npz), so the "
                        "probed trajectory routes as served")
    p.add_argument("--num_frames", type=int, default=13)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--flow_shift", type=float, default=5.0,
                   help="the serving scheduler's shift (cli.sample --flow_shift)")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="> 1: the trajectory steered by CFG; the cond arm's pairs recorded")
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="results/cache_poly.npz")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Writes ``--out``; returns the last line's record, with the points."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = MODELS[args.model]
    grid = WAN_GEOMETRY.tokens((args.num_frames, args.height, args.width))
    attn = probe_attention_config(args.model, grid)
    dtype = torch.float32 if args.model == "wan-tiny" else torch.bfloat16
    if dtype == torch.float32:
        full_f32(device)
    model = WanModel(cfg, dtype=dtype, device=device, seed=args.seed)
    if args.torch_checkpoint:
        load_wan_torch_weights(model, args.torch_checkpoint)
    if args.router:
        load_trained_router(model, args.router, time_embedder=not args.torch_checkpoint)

    pipe = WanT2VPipeline(model, attn_cfg=attn)
    gen = torch.Generator(device=device)
    lat = pipe.prepare_latents(gen.manual_seed(args.seed), 1, args.num_frames, args.height,
                               args.width)
    pe = random_embeds(gen, args.seed + 1, (1, cfg.text_len, cfg.text_dim), device)
    neg_pe = torch.zeros_like(pe)
    schedule = FlowMatchEulerSchedule.create(args.steps, shift=args.flow_shift)
    sigmas = np.asarray(schedule.sigmas)
    timesteps = np.asarray(schedule.timesteps)

    def fwd(lat, t, context, probe):
        out = model(lat.to(dtype), t, context, attn_cfg=attn, routing_mode="hard",
                    return_hidden_delta=probe)
        return out.sample.float(), out.hidden_delta, out.temb_indicator

    xs, ys = [], []
    prev_ind = prev_resid = None
    g = args.guidance_scale
    with torch.inference_mode():
        for i in range(args.steps):
            t = torch.full((1,), float(timesteps[i]), device=device)
            v, resid, ind = fwd(lat, t, pe, True)
            if g > 1.0:
                # CFG steers the latents; the recorded pairs stay the cond arm's,
                # which is what each arm's serving cache sees
                v_u = fwd(lat, t, neg_pe, False)[0]
                v = v_u + g * (v - v_u)
            if prev_ind is not None:
                xs.append(float(rel_l1(ind, prev_ind)))
                ys.append(float(rel_l1(resid.float(), prev_resid.float())))
            prev_ind, prev_resid = ind, resid
            lat = lat + float(sigmas[i + 1] - sigmas[i]) * v
            print(f"step {i}: ind_dist={xs[-1] if xs else None} "
                  f"resid_dist={ys[-1] if ys else None}", flush=True)

    coeffs = np.polyfit(np.asarray(xs), np.asarray(ys), args.degree)
    pred = np.polyval(coeffs, np.asarray(xs))
    r2 = 1.0 - np.sum((pred - ys) ** 2) / max(np.sum((ys - np.mean(ys)) ** 2), 1e-12)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, coefficients=coeffs, indicator=np.asarray(xs), residual=np.asarray(ys))
    record = {"coefficients": [float(c) for c in coeffs], "r2": round(float(r2), 4),
              "points": len(xs), "out": args.out}
    print(json.dumps(record), flush=True)
    return {**record, "r2_exact": float(r2), "indicator": xs, "residual": ys}


if __name__ == "__main__":
    main()
