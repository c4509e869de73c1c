"""Baseline-vs-routed comparison on the GPU (counterpart of cli/bench_compare.py;
the reference's protocol, its README.md:36-69).

Samples latents with full attention (the ``baseline`` arm, routing off)
and with routed sparse attention (``vorta``, routing hard) from the same
noise and conditioning, and, with ``--cache_threshold > 0``, routed with
the step cache (``vorta_cached``).  Each arm runs twice: first from the
``--seed`` noise, whose latents are kept (``<output_dir>/<arm>/latents.npy``)
and compared, which also builds the kernels and warms the allocator; then,
timed, from other noise (a generator seeded ``--seed + 2``, so runs
repeat), the card synchronized before the clock is read.  The summary
(``<output_dir>/summary.json``, the JAX CLI's keys) holds each arm's
seconds and seconds per step, the speed-ups, PSNR and SSIM of the routed
arms' latents against the baseline's, the weight-free video metrics, LPIPS
(null without ``--lpips_weights``), the VBench schema and the routed arm's
expert mix (from the pipeline's ``return_scores``).

Options as the JAX CLI's: ``--mm int8`` runs the routed arms' block
projections in W8A8, ``--mm int8_static`` with static scales calibrated
first (tools/calibrate_int8.calibrate_wan at t = 200, 500, 800, the default
bf16 products); ``--tau_sweep`` adds a routed sample, its timing, quality
and mix per threshold, ``--frontier_tau`` x ``--frontier_cache`` the grid of
threshold and step-cache cells; ``--stepwise`` drives each arm through the
pipeline's ``make_stepper`` in chunks of ``--steps_per_dispatch`` steps (one
value, or ``baseline,vorta,cached``).  Weights are random from ``--seed``
(as cli.sample's) unless ``--torch_checkpoint`` names a diffusers
checkpoint; ``--router_checkpoint`` takes a step dir of cli.train or a
reference router file, ``--router_npz`` the JAX package's trained routers
(with the time embedder they were trained against, at Wan-1.3B's width
without a checkpoint: io/from_jax.load_trained_router), ``--resume_dir``
its ``config.json``'s attention geometry.  HunyuanVideo runs the same
protocol with its joint attention (embedded guidance; the JAX CLI's
HunyuanVideo branch, which has no tau sweep or frontier).  The tiny models
run in f32, as the JAX CLI builds them, so only with ``--device cpu``.

With random DiT weights the PSNR and SSIM prove the protocol, not the
quality: LPIPS and VBench need weights that are not in the repository.

  python -m vorta_tpu_torch.cli.bench_compare --model wan-1_3B \\
      --router_npz assets/bench_router_wan1_3b_720p_half.npz --cache_threshold 0.75 \\
      --cache_poly assets/cache_poly_wan1_3b_720p.npz --output_dir results/port/compare
  python -m vorta_tpu_torch.cli.bench_compare --model hunyuan-13B --num_frames 45 \\
      --num_inference_steps 1 --output_dir results/port/compare_hy
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import WAN_1_3B, WAN_14B, WAN_TINY, AttentionConfig
from ..device import resolve_device
from ..geometry import HUNYUAN_GEOMETRY, WAN_GEOMETRY
from ..io.checkpoint import apply_router_state, load_router_checkpoint
from ..io.from_jax import load_trained_router
from ..io.quality import (lpips, psnr, routing_mix, ssim, vbench_scaffold,
                          weightfree_video_metrics)
from ..io.torch_import import (hunyuan_router_state, load_hunyuan_torch_weights,
                               load_wan_torch_weights, wan_router_state)
from ..models.hunyuan import HUNYUAN_13B, HUNYUAN_TINY, HunyuanModel
from ..models.wan import WanModel
from ..ops import _build
from ..pipelines.hunyuan_t2v import HunyuanSamplingConfig, HunyuanT2VPipeline
from ..pipelines.wan_t2v import SamplingConfig, WanT2VPipeline
from ..tools.calibrate_int8 import calibrate_wan
from .sample import is_router_file, load_cache_poly, random_embeds

MODELS = {"wan-1_3B": WAN_1_3B, "wan-14B": WAN_14B, "wan-tiny": WAN_TINY,
          "hunyuan-13B": HUNYUAN_13B, "hunyuan-tiny": HUNYUAN_TINY}
# the tiny models run in f32, as the JAX CLIs and tools build them
TINY_ON_CUDA = ("{model} runs in f32, as the JAX package builds it; the CUDA kernels take "
                "bf16 only (ROADMAP section 2 A3): pass --device cpu, or --model {big}")
CALIBRATION_T = (200.0, 500.0, 800.0)


@dataclasses.dataclass
class Comparison:
    summary: dict  # what summary.json holds
    latents: dict  # {arm: the --seed run's final latents (f32, on the device)}
    routing: dict  # {arm: [(layers, H) expert ids per hard-routed forward]}, both runs
    cache_log: dict  # {arm: [(step, stream, skipped)]}, both runs
    launches: dict  # {arm: kernel launches of its two runs (ops/_build.py's counters)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="wan-1_3B", choices=list(MODELS))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--torch_checkpoint", default=None)
    p.add_argument("--router_checkpoint", default=None,
                   help="a step dir of cli.train, or a reference router .pt / .bin / "
                        ".safetensors")
    p.add_argument("--router_npz", default=None,
                   help="router npz of the JAX package's router training (Wan)")
    p.add_argument("--resume_dir", default=None)
    p.add_argument("--num_frames", type=int, default=77)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--num_inference_steps", type=int, default=10)
    p.add_argument("--guidance_scale", type=float, default=5.0)
    p.add_argument("--flow_shift", type=float, default=5.0)
    p.add_argument("--tau_sparse", type=float, default=0.3)
    p.add_argument("--cfg_batch", action="store_true",
                   help="CFG cond + uncond as one batch-2 forward (every arm)")
    p.add_argument("--mm", default="bf16", choices=["bf16", "int8", "int8_static"],
                   help="matmul precision of the routed arms (the baseline stays bf16); "
                        "int8_static calibrates static activation scales first")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--output_dir", default="results/compare")
    p.add_argument("--cache_threshold", type=float, default=0.0,
                   help="> 0 adds the vorta_cached arm: routed with the step cache")
    p.add_argument("--cache_warmup", type=int, default=2)
    p.add_argument("--cache_poly", default=None,
                   help="npz of tools/fit_cache_poly: its coefficients rescale the indicator")
    p.add_argument("--tau_sweep", default=None,
                   help="comma list of tau_sparse values: a routed sample, its quality and "
                        "its expert mix per value (Wan)")
    p.add_argument("--frontier_tau", default=None,
                   help="comma list of tau_sparse values of the tau x cache frontier (Wan)")
    p.add_argument("--frontier_cache", default=None,
                   help="comma list of cache thresholds (0 = off) of the frontier")
    p.add_argument("--stepwise", action="store_true",
                   help="drive each arm through the pipeline's make_stepper")
    p.add_argument("--steps_per_dispatch", default="1",
                   help="steps per stepper call (must divide num_inference_steps): one int, "
                        "or 'baseline,vorta,cached'")
    p.add_argument("--lpips_weights", default=None,
                   help="LPIPS net weights (lpips is null without them)")
    args = p.parse_args(argv)
    if args.model.endswith("tiny") and args.device != "cpu":
        big = "hunyuan-13B" if args.model.startswith("hunyuan") else "wan-1_3B"
        p.error(TINY_ON_CUDA.format(model=args.model, big=big))
    return args


def _arm_chunk(args, name: str) -> int:
    """Per-arm steps_per_dispatch: one int for all arms, or a
    'baseline,vorta,cached' comma list."""
    parts = [int(x) for x in str(args.steps_per_dispatch).split(",")]
    if len(parts) == 1:
        return parts[0]
    idx = {"baseline": 0, "vorta": 1, "vorta_cached": 2}.get(name, 1)
    return parts[min(idx, len(parts) - 1)]


def _steps_per_call(args, name: str) -> int:
    """The steps each stepper call of the arm runs: its chunk with
    ``--stepwise``, else the whole trajectory."""
    if not args.stepwise:
        return args.num_inference_steps
    return min(_arm_chunk(args, name), args.num_inference_steps)


def wan_attention_config(args, grid) -> AttentionConfig:
    """The JAX CLI's Wan geometry: ``--resume_dir``'s config.json as it is;
    the tiny one; else tile (5, 9, 8) where it divides the grid's height
    and width (the reference's 720p tile), else (4, 6, 4)."""
    if args.resume_dir and (Path(args.resume_dir) / "config.json").exists():
        return AttentionConfig.load(Path(args.resume_dir) / "config.json")
    if args.model == "wan-tiny":
        return AttentionConfig(latent_shape=grid, sta_window=(3, 3, 1), sta_tile=(2, 2, 2),
                               lowres_window=(2, 2, 2), block_q=16, block_kv=16,
                               sta_block_q=8, sta_block_kv=8, tau_sparse=args.tau_sparse)
    tile = (5, 9, 8) if grid[1] % 9 == 0 and grid[2] % 8 == 0 else (4, 6, 4)
    return AttentionConfig(latent_shape=grid, sta_window=(3, 3, 3), sta_tile=tile,
                           lowres_window=(2, 3, 2), tau_sparse=args.tau_sparse)


def hunyuan_attention_config(args, grid) -> AttentionConfig:
    """The JAX CLI's HunyuanVideo geometry: ``--resume_dir``'s config.json;
    the tiny one; else tile (6, 9, 8) where it divides the grid, else
    (2, 3, 2)."""
    if args.resume_dir and (Path(args.resume_dir) / "config.json").exists():
        return AttentionConfig.load(Path(args.resume_dir) / "config.json")
    if args.model == "hunyuan-tiny":
        return AttentionConfig(latent_shape=grid, sta_window=(3, 3, 1), sta_tile=(2, 2, 2),
                               lowres_window=(2, 2, 2), block_q=16, block_kv=16,
                               sta_block_q=8, sta_block_kv=8, tau_sparse=args.tau_sparse)
    fits = grid[0] % 6 == 0 and grid[1] % 9 == 0 and grid[2] % 8 == 0
    return AttentionConfig(latent_shape=grid, sta_window=(3, 3, 3),
                           sta_tile=(6, 9, 8) if fits else (2, 3, 2),
                           lowres_window=(2, 3, 2), tau_sparse=args.tau_sparse)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrated_scales(call, noise, timesteps=CALIBRATION_T) -> dict:
    """Static int8 scales {site: (L,) f32 tensor} (amax / 127) of
    ``call(latents, t)``'s calibration max-reduced over ``timesteps``."""
    amax = calibrate_wan(lambda lat, t, _: call(lat, t),
                         [(noise, torch.full((noise.shape[0],), ts, device=noise.device), None)
                          for ts in timesteps])
    return {k: torch.from_numpy(v / 127.0) for k, v in amax.items()}


class _Arms:
    """Runs arms of one comparison: the ``--seed`` run, then the timed run
    on the next noise of the timing generator; keeps latents, routing,
    cache logs and launches per arm."""

    def __init__(self, args, device, noise, conditioning, prepare):
        self.args, self.device, self.noise = args, device, noise
        self.conditioning = conditioning
        self.prepare = prepare  # generator -> fresh noise of the clip's shape
        self.timing = torch.Generator(device=device).manual_seed(args.seed + 2)
        self.out = Comparison({}, {}, {}, {}, {})

    def run(self, pipe, sampling, noise_in, name):
        """(latents, scores or None, routing ids, cache log) of one arm's run:
        the pipeline's loop, or its stepper with ``--stepwise``."""
        routing, cache_log = [], []
        scores = [] if getattr(sampling, "return_scores", False) else None
        extra = {} if scores is None else {"scores": scores}
        chunk = _steps_per_call(self.args, name)
        init, step_fn, n_steps = pipe.make_stepper(sampling, chunk=chunk)
        carry = init(noise_in)
        for i in range(0, n_steps, chunk):
            carry = step_fn(carry, i, *self.conditioning, routing=routing, cache_log=cache_log,
                            **extra)
        return carry[0], (torch.stack(scores) if scores else None), routing, cache_log

    def arm(self, pipe, sampling, name, save: bool = True):
        """The arm's two runs: (the --seed run's latents and scores, the
        timed run's seconds)."""
        args = self.args
        before = dict(_build.launches)
        lat, scores, routing, cache_log = self.run(pipe, sampling, self.noise, name)
        _sync(self.device)
        if save:
            (Path(args.output_dir) / name).mkdir(parents=True, exist_ok=True)
            np.save(Path(args.output_dir) / name / "latents.npy", lat.cpu().numpy())
        fresh = self.prepare(self.timing)
        _sync(self.device)
        t0 = time.time()
        _, _, routing_t, cache_t = self.run(pipe, sampling, fresh, name)
        _sync(self.device)
        dt = time.time() - t0
        self.out.latents[name] = lat
        self.out.routing[name] = routing + routing_t
        self.out.cache_log[name] = cache_log + cache_t
        self.out.launches[name] = {k: _build.launches[k] - before.get(k, 0)
                                   for k in _build.launches}
        return lat, scores, dt

    def record(self, results: dict, name: str, dt: float) -> None:
        args = self.args
        results[name] = {"seconds": round(dt, 2),
                         "s_per_step": round(dt / args.num_inference_steps, 3),
                         "steps_per_dispatch": _steps_per_call(args, name)}
        print(f"[{name}] {dt:.2f}s ({dt / args.num_inference_steps:.2f}s/step)", flush=True)


def _compare(args, results: dict) -> None:
    """PSNR, SSIM, LPIPS, the weight-free metrics, VBench's schema and the
    speed-ups of the routed arms against the baseline, from the saved
    latents."""
    out_dir = Path(args.output_dir)
    a = np.load(out_dir / "baseline" / "latents.npy")
    b = np.load(out_dir / "vorta" / "latents.npy")
    results["psnr_vorta_vs_baseline_db"] = round(psnr(a, b), 2)
    results["ssim_vorta_vs_baseline"] = round(ssim(a, b), 4)
    results["lpips_vorta_vs_baseline"] = lpips(a, b, args.lpips_weights)
    results["weightfree_vorta"] = weightfree_video_metrics(b, a)
    results["vbench"] = vbench_scaffold()
    results["speedup"] = round(results["baseline"]["seconds"] / results["vorta"]["seconds"], 3)
    if "vorta_cached" in results:
        c = np.load(out_dir / "vorta_cached" / "latents.npy")
        results["psnr_cached_vs_baseline_db"] = round(psnr(a, c), 2)
        results["ssim_cached_vs_baseline"] = round(ssim(a, c), 4)
        results["weightfree_cached"] = weightfree_video_metrics(c, a)
        results["speedup_cached"] = round(
            results["baseline"]["seconds"] / results["vorta_cached"]["seconds"], 3)


def _finish(args, arms: _Arms, results: dict) -> Comparison:
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "summary.json").write_text(json.dumps(results, indent=2))
    print(json.dumps(results), flush=True)
    arms.out.summary = results
    return arms.out


def main(argv=None) -> Comparison:
    """Runs the comparison, writes the latents and summary.json; returns
    them with each arm's routing, cache log and launches."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    with torch.inference_mode():
        if args.model.startswith("hunyuan"):
            return _main_hunyuan(args, device)
        return _main_wan(args, device)


def _load_routers(args, model, state_of) -> None:
    if args.router_checkpoint:
        rp = Path(args.router_checkpoint)
        apply_router_state(model, state_of(rp) if is_router_file(rp)
                           else load_router_checkpoint(rp)[0])


def _main_wan(args, device) -> Comparison:
    model_cfg = MODELS[args.model]
    grid = WAN_GEOMETRY.tokens((args.num_frames, args.height, args.width))
    attn_cfg = wan_attention_config(args, grid)
    dtype = torch.float32 if args.model == "wan-tiny" else torch.bfloat16
    model = WanModel(model_cfg, dtype=dtype, device=device, seed=args.seed)
    if args.torch_checkpoint:
        load_wan_torch_weights(model, args.torch_checkpoint)
    _load_routers(args, model, lambda rp: wan_router_state(rp, model_cfg.num_layers))
    if args.router_npz:
        load_trained_router(model, args.router_npz, time_embedder=not args.torch_checkpoint)

    gen = torch.Generator(device=device)
    pe = random_embeds(gen, args.seed + 1, (1, model_cfg.text_len, model_cfg.text_dim), device)
    ne = torch.zeros_like(pe)
    shape = (1, args.num_frames, args.height, args.width)
    probe = WanT2VPipeline(model, attn_cfg=attn_cfg)
    noise = probe.prepare_latents(gen.manual_seed(args.seed), *shape)

    act_scales = None
    routed_mm = "bf16" if args.mm == "bf16" else "int8"
    if args.mm == "int8_static":
        # static scales calibrated under the routed serving mode, the
        # default bf16 products (as the JAX CLI and tools/calibrate_int8)
        act_scales = calibrated_scales(lambda lat, t: model(
            lat, t, pe, attn_cfg=attn_cfg, routing_mode="hard",
            calibrate_mm=True).mm_calibration, noise)
    pipe = WanT2VPipeline(model, attn_cfg=attn_cfg, act_scales=act_scales)
    arms = _Arms(args, device, noise, (pe, ne), lambda g: pipe.prepare_latents(g, *shape))
    cache_poly = load_cache_poly(args)

    def sampling_for(mode, **kw):
        return SamplingConfig(num_inference_steps=args.num_inference_steps,
                              guidance_scale=args.guidance_scale, flow_shift=args.flow_shift,
                              routing_mode=mode, cfg_batch=args.cfg_batch,
                              mm_precision=routed_mm if mode == "hard" else "bf16", **kw)

    results = {"mm_routed": args.mm, "stepwise": bool(args.stepwise)}
    names = [("baseline", "off"), ("vorta", "hard")]
    if args.cache_threshold > 0.0:
        names.append(("vorta_cached", "hard"))
    for name, mode in names:
        cached = name == "vorta_cached"
        sampling = sampling_for(
            mode, return_scores=mode == "hard" and not cached,
            cache_threshold=args.cache_threshold if cached else 0.0,
            cache_warmup=args.cache_warmup, cache_coefficients=cache_poly if cached else None)
        _, scores, dt = arms.arm(pipe, sampling, name)
        if scores is not None:
            results["routing_mix"] = routing_mix(scores, args.tau_sparse)
        arms.record(results, name, dt)
    _compare(args, results)
    a = np.load(Path(args.output_dir) / "baseline" / "latents.npy")

    if args.tau_sweep:
        # quality against speed as tau_sparse sends routed heads back to
        # full attention (reference fallback: wan.py:398-399)
        sweep = []
        for tau in (float(t) for t in args.tau_sweep.split(",")):
            pipe_t = WanT2VPipeline(model, attn_cfg=dataclasses.replace(attn_cfg, tau_sparse=tau),
                                    act_scales=act_scales)
            lat_t, scores_t, dt = arms.arm(pipe_t, sampling_for("hard", return_scores=True),
                                           f"tau_{tau}", save=False)
            lat_np = lat_t.cpu().numpy()
            row = {"tau": tau, "seconds": round(dt, 2),
                   "speedup": round(results["baseline"]["seconds"] / dt, 3),
                   "psnr_db": round(psnr(a, lat_np), 2), "ssim": round(ssim(a, lat_np), 4),
                   "mix": routing_mix(scores_t, tau), **weightfree_video_metrics(lat_np, a)}
            sweep.append(row)
            print(f"[tau={tau}] {json.dumps(row)}", flush=True)
        results["tau_sweep"] = sweep

    if args.frontier_tau and args.frontier_cache:
        # the joint tau_sparse x cache_threshold frontier: routing moves heads
        # to cheaper experts, caching skips whole steps
        frontier = []
        for tau in (float(t) for t in args.frontier_tau.split(",")):
            pipe_t = WanT2VPipeline(model, attn_cfg=dataclasses.replace(attn_cfg, tau_sparse=tau),
                                    act_scales=act_scales)
            for thr in (float(t) for t in args.frontier_cache.split(",")):
                sampling = sampling_for("hard", cache_threshold=thr,
                                        cache_warmup=args.cache_warmup,
                                        cache_coefficients=cache_poly if thr > 0 else None)
                lat_t, _, dt = arms.arm(pipe_t, sampling, f"frontier_{tau}_{thr}", save=False)
                lat_np = lat_t.cpu().numpy()
                row = {"tau": tau, "cache_threshold": thr, "seconds": round(dt, 2),
                       "speedup": round(results["baseline"]["seconds"] / dt, 3),
                       "psnr_db": round(psnr(a, lat_np), 2), "ssim": round(ssim(a, lat_np), 4),
                       **weightfree_video_metrics(lat_np, a)}
                frontier.append(row)
                print(f"[frontier tau={tau} thr={thr}] {json.dumps(row)}", flush=True)
        results["frontier"] = frontier
    return _finish(args, arms, results)


def _main_hunyuan(args, device) -> Comparison:
    """HunyuanVideo's comparison: the same protocol, joint attention."""
    model_cfg = MODELS[args.model]
    grid = HUNYUAN_GEOMETRY.tokens((args.num_frames, args.height, args.width))
    attn_cfg = hunyuan_attention_config(args, grid)
    dtype = torch.float32 if args.model == "hunyuan-tiny" else torch.bfloat16
    model = HunyuanModel(model_cfg, dtype=dtype, device=device, seed=args.seed)
    if args.torch_checkpoint:
        load_hunyuan_torch_weights(model, args.torch_checkpoint)
    _load_routers(args, model, lambda rp: hunyuan_router_state(
        rp, model_cfg.dual_layers, model_cfg.single_layers))

    # conditioning as cli.sample --random_embeds makes it: every token valid
    gen = torch.Generator(device=device)
    text = random_embeds(gen, args.seed + 1, (1, model_cfg.text_len, model_cfg.text_dim),
                         device)
    pooled = torch.randn((1, model_cfg.pooled_dim), generator=gen, device=device)
    mask = torch.ones((1, model_cfg.text_len), dtype=torch.bool, device=device)
    shape = (1, args.num_frames, args.height, args.width)
    probe = HunyuanT2VPipeline(model, attn_cfg=attn_cfg)
    noise = probe.prepare_latents(gen.manual_seed(args.seed), *shape)

    act_scales = None
    routed_mm = "bf16" if args.mm == "bf16" else "int8"
    if args.mm == "int8_static":
        guidance = torch.full((1,), args.guidance_scale * 1000.0, device=device)
        act_scales = calibrated_scales(lambda lat, t: model(
            lat, t, text, mask, pooled, guidance=guidance, attn_cfg=attn_cfg,
            routing_mode="hard", calibrate_mm=True).mm_calibration, noise)
    pipe = HunyuanT2VPipeline(model, attn_cfg=attn_cfg, act_scales=act_scales)
    arms = _Arms(args, device, noise, (text, mask, pooled),
                 lambda g: pipe.prepare_latents(g, *shape))
    cache_poly = load_cache_poly(args)

    results = {"mm_routed": args.mm, "stepwise": bool(args.stepwise)}
    names = [("baseline", "off"), ("vorta", "hard")]
    if args.cache_threshold > 0.0:
        names.append(("vorta_cached", "hard"))
    for name, mode in names:
        cached = name == "vorta_cached"
        sampling = HunyuanSamplingConfig(
            num_inference_steps=args.num_inference_steps, guidance_scale=args.guidance_scale,
            flow_shift=args.flow_shift, routing_mode=mode,
            mm_precision=routed_mm if mode == "hard" else "bf16",
            cache_threshold=args.cache_threshold if cached else 0.0,
            cache_warmup=args.cache_warmup, cache_coefficients=cache_poly if cached else None)
        _, _, dt = arms.arm(pipe, sampling, name)
        arms.record(results, name, dt)
    _compare(args, results)
    return _finish(args, arms, results)


if __name__ == "__main__":
    main()
