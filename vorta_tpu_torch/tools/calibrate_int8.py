"""Calibrate static int8 activation scales (counterpart of the JAX package's
tools/calibrate_int8.py), on the GPU.

Runs Wan-1.3B forwards with ``calibrate_mm=True`` (every W8A8 site of
ops/qmm.py records its per-layer max |x|) at a few denoise timesteps,
max-reduces over those points and writes ``{site: (num_layers,) f32 scale}``
(amax / 127) to an npz that ``cli.sample --act_scales`` reads.  The
forwards run the default bf16 products, as the JAX tool's do.

The model's weights are random from a seed, as the JAX tool's are; with
``--routing hard`` and an existing ``--router`` npz the routers are the
JAX package's trained ones, with the time embedder they were trained
against (io/from_jax.load_trained_router).  Latents and text states are
drawn from torch generators with fixed seeds.

  python -m vorta_tpu_torch.tools.calibrate_int8 --geom 720p --out results/port/act_scales.npz
  python -m vorta_tpu_torch.tools.calibrate_int8 --geom 480p --timesteps 400,700 \\
      --out results/port/act_scales_480p.npz
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import WAN_1_3B, AttentionConfig
from ..device import resolve_device
from ..io.from_jax import load_trained_router
from ..models.wan import WanModel


def bench_attn_cfg(geom: str) -> AttentionConfig:
    """bench.py's attention geometry at ``geom`` (720p or 480p)."""
    if geom == "720p":
        return AttentionConfig(
            latent_shape=(20, 45, 80), sta_window=(3, 3, 3), sta_tile=(5, 9, 8),
            lowres_window=(2, 3, 2), block_q=1024, block_kv=1024, tau_sparse=0.3,
        )
    return AttentionConfig(
        latent_shape=(20, 30, 52), sta_window=(3, 3, 3), sta_tile=(4, 6, 4),
        lowres_window=(2, 3, 2), block_q=1024, block_kv=1024,
        sta_block_q=480, sta_block_kv=576, tau_sparse=0.3,
    )


def calibrate_wan(model_call, points) -> dict:
    """Max-reduce the calibration over (latents, timestep, context) points:
    ``model_call(lat, t, ctx) -> {site: (L,) amax}`` (tensors or arrays);
    returns {site: (L,) f32 numpy}."""
    amax = None
    for lat, t, ctx in points:
        a = {k: _numpy(v) for k, v in model_call(lat, t, ctx).items()}
        amax = a if amax is None else {k: np.maximum(amax[k], a[k]) for k in amax}
    return amax


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def calibration_points(timesteps, geom: str, text_len: int, text_dim: int, channels: int,
                       device, batch: int = 1) -> list:
    """[(latents, t, context)]: one bf16 latent draw per timestep (generator
    seeded 1000 + i), one bf16 context shared by all (seed 1)."""
    px = {"720p": (90, 160), "480p": (60, 104)}[geom]
    ctx = torch.randn((batch, text_len, text_dim), device=device,
                      generator=torch.Generator(device=device).manual_seed(1)).bfloat16()
    points = []
    for i, ts in enumerate(timesteps):
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        lat = torch.randn((batch, 20, px[0], px[1], channels), generator=gen,
                          device=device).bfloat16()
        points.append((lat, torch.full((batch,), float(ts), device=device), ctx))
    return points


def main(argv=None) -> dict:
    """Writes ``--out`` and returns its {site: (L,) f32} scales."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--geom", default="720p", choices=["720p", "480p"])
    ap.add_argument("--routing", default="hard", choices=["hard", "off"],
                    help="calibrate under the serving routing mode")
    ap.add_argument("--router", default="assets/bench_router_wan1_3b.npz",
                    help="trained-router npz (used where the file exists)")
    ap.add_argument("--timesteps", default="100,400,700,950",
                    help="denoise timesteps to sample activations at")
    ap.add_argument("--out", default="assets/act_scales_wan1_3b.npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    attn = bench_attn_cfg(args.geom)
    model = WanModel(WAN_1_3B, dtype=torch.bfloat16, device=device, seed=0)
    if args.routing == "hard" and os.path.exists(args.router):
        load_trained_router(model, args.router)

    def model_call(lat, t, ctx):
        with torch.inference_mode():
            return model(lat, t, ctx, attn_cfg=attn, routing_mode=args.routing,
                         calibrate_mm=True).mm_calibration

    points = calibration_points([float(x) for x in args.timesteps.split(",")], args.geom,
                                WAN_1_3B.text_len, WAN_1_3B.text_dim, WAN_1_3B.in_channels,
                                device)
    t0 = time.time()
    amax = calibrate_wan(model_call, points)
    scales = {k: (v / 127.0).astype(np.float32) for k, v in amax.items()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **scales)
    print(f"calibrated {len(scales)} sites x {len(next(iter(scales.values())))} "
          f"layers over {len(points)} points in {time.time() - t0:.1f}s -> {args.out}",
          flush=True)
    for k in sorted(scales):
        v = scales[k]
        print(f"  {k}: scale range [{v.min():.4g}, {v.max():.4g}]", flush=True)
    return scales


if __name__ == "__main__":
    main()
