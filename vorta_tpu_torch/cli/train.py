"""Router-distillation trainer (counterpart of cli/train.py).

The JAX trainer's recipe and arguments: a frozen DiT with trainable f32
routers, flow-match distillation against the frozen full-attention teacher
(interleaved per block, each student block recomputed in the backward),
the interval curriculum, AdamW with global-norm clipping and gradient
accumulation, router-only checkpoints under ``<output_dir>/ckpt`` and the
attention geometry persisted to ``<output_dir>/config.json``.  SIGTERM or
SIGINT saves a checkpoint at the next optimizer step and exits.  Weights
are random, drawn from ``--seed``, unless ``--torch_checkpoint`` names a
diffusers checkpoint (io/torch_import.py), which then sets the student's
and the frozen teacher's weights alike; ``--synthetic_data`` (or no
``--data_json_path``) draws latents and text embeddings from it too (for
HunyuanVideo also the CLIP pooled embedding, and a text mask with the
second half padded, as the JAX trainer draws them).  Runs on CUDA unless
``--device cpu``.  ``--dtype fp32`` trains in f32 on either device: on
the card every attention kernel runs its f32 mode (FFMA on the CUDA cores:
the flash forward with its lse and the flash backward's dq and dk/dv) and
PyTorch's own products and convolutions run with TF32 off
(device.full_f32).

``--model hunyuan-13B | hunyuan-tiny`` trains HunyuanVideo's routers
(training/step.py ``make_hunyuan_router_train_step``; the 13B at the
reference's STA tile (6, 9, 8), which must divide the latent grid).

Under torchrun, ``--sp_size`` shards each clip's latent frames over
sequence-parallel groups of that many ranks (Ulysses, parallel/), the
other factor of the world size (``--dp_size``) data-parallel replicas, each
with its own slice of the global batch of ``--train_batch_size`` x dp;
``--shard_frozen`` layer-shards the frozen blocks over dp
(parallel/fsdp.py).  NCCL on CUDA, gloo with ``--device cpu``.  Rank 0
writes the checkpoints, the metrics and the geometry.

  python -m vorta_tpu_torch.cli.train --model wan-1_3B --synthetic_data \\
      --max_train_steps 2 --gradient_accumulation_steps 2 --output_dir out/exp
  python -m vorta_tpu_torch.cli.train --model wan-tiny --device cpu --dtype fp32 \\
      --synthetic_data --max_train_steps 2 --output_dir /tmp/exp
  python -m vorta_tpu_torch.cli.train --dtype fp32 --synthetic_data --num_latent_t 8 \\
      --max_train_steps 2 --gradient_accumulation_steps 1 --output_dir out/f32
  torchrun --nproc_per_node 4 -m vorta_tpu_torch.cli.train --model hunyuan-13B \\
      --synthetic_data --num_latent_t 12 --video_height 720 --video_width 1280 \\
      --sp_size 4 --output_dir out/hy
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config import WAN_1_3B, WAN_14B, WAN_TINY, AttentionConfig
from ..device import full_f32, resolve_device
from ..geometry import WAN_GEOMETRY
from ..io.checkpoint import (
    apply_router_state,
    latest_checkpoint,
    load_router_checkpoint,
    save_router_checkpoint,
)
from ..io.metrics import MetricsLogger
from ..io.torch_import import load_hunyuan_torch_weights, load_wan_torch_weights
from ..models.hunyuan import HUNYUAN_13B, HUNYUAN_TINY, HunyuanModel
from ..models.wan import WanModel
from ..parallel.fsdp import shard_frozen_blocks
from ..parallel.mesh import make_mesh_for
from ..schedulers.flow_match import train_sigmas
from ..training.data import LatentDataset, epoch_iterator
from ..training.step import (
    LossWeights,
    MultiSteps,
    STACKED,
    make_hunyuan_router_train_step,
    make_optimizer,
    make_router_train_step,
    router_partition,
)

MODELS = {"wan-1_3B": WAN_1_3B, "wan-14B": WAN_14B, "wan-tiny": WAN_TINY,
          "hunyuan-13B": HUNYUAN_13B, "hunyuan-tiny": HUNYUAN_TINY}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # model
    p.add_argument("--model", default="wan-1_3B", choices=sorted(MODELS))
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                   help="the frozen DiT's dtype (the routers are f32 either way); fp32 on "
                        "the card: every kernel in its f32 mode (FFMA attention), TF32 off")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--torch_checkpoint", default=None,
                   help="path to torch/safetensors DiT weights to import")
    # data
    p.add_argument("--data_json_path", default=None)
    p.add_argument("--synthetic_data", action="store_true",
                   help="random latents/embeds (smoke testing)")
    p.add_argument("--num_latent_t", type=int, default=20)
    p.add_argument("--video_height", type=int, default=480)
    p.add_argument("--video_width", type=int, default=832)
    p.add_argument("--cfg_rate", type=float, default=0.1)
    # attention geometry (persisted to config.json)
    p.add_argument("--sta_window", type=int, nargs=3, default=[3, 3, 3])
    p.add_argument("--sta_tile", type=int, nargs=3, default=[4, 6, 4])
    p.add_argument("--lowres_window", type=int, nargs=3, default=[2, 3, 2])
    p.add_argument("--lowres_reduction_rate", type=float, default=0.5)
    p.add_argument("--tau_sparse", type=float, default=0.3)
    # parallelism
    p.add_argument("--sp_size", type=int, default=1,
                   help="ranks per sequence-parallel group (under torchrun)")
    p.add_argument("--shard_frozen", action="store_true",
                   help="layer-shard the frozen DiT over the dp groups")
    p.add_argument("--dp_size", type=int, default=None,
                   help="data-parallel replicas (default: the world size over --sp_size)")
    # optimization (reference defaults: train.sh)
    p.add_argument("--train_batch_size", type=int, default=1,
                   help="per-step global batch (before grad accumulation)")
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--max_train_steps", type=int, default=100)
    p.add_argument("--learning_rate", type=float, default=1e-2)
    p.add_argument("--lr_scheduler", default="constant", choices=["constant", "linear", "cosine"])
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--flow_shift", type=float, default=5.0)
    p.add_argument("--precondition_outputs", action="store_true")
    # losses (reference train.sh)
    p.add_argument("--diffusion_loss_weight", type=float, default=1.0)
    p.add_argument("--reg_loss_weight", type=float, default=0.02)
    p.add_argument("--last_layer_distill_loss_weight", type=float, default=20.0)
    p.add_argument("--hidden_layer_distill_loss_weight", type=float, default=0.0)
    # run management
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpointing_steps", type=int, default=100)
    p.add_argument("--report_interval", type=int, default=1)
    p.add_argument("--resume_from_checkpoint", default=None,
                   help="'latest' or a step dir path")
    return p.parse_args(argv)


def attention_config(args) -> AttentionConfig:
    """The JAX trainer's geometry for ``args.model``; a tile or low-res window
    that does not divide the latent grid raises here, before any model is
    built."""
    cfg = _attention_config(args)
    for what, part in (("sta_tile", cfg.sta_tile), ("lowres_window", cfg.lowres_window)):
        if any(n % k for n, k in zip(cfg.latent_shape, part)):
            raise ValueError(f"{what} {part} must divide the latent grid {cfg.latent_shape}")
    return cfg


def _attention_config(args) -> AttentionConfig:
    if args.model == "hunyuan-tiny":
        return AttentionConfig(latent_shape=(4, 4, 8), sta_window=(3, 3, 3), sta_tile=(2, 2, 2),
                               lowres_window=(2, 2, 2), block_q=32, block_kv=32,
                               sta_block_q=8, sta_block_kv=8, tau_sparse=args.tau_sparse)
    if args.model == "wan-tiny":
        return AttentionConfig(latent_shape=(4, 4, 4), sta_window=(3, 3, 1), sta_tile=(2, 2, 2),
                               lowres_window=(2, 2, 2), block_q=16, block_kv=16,
                               sta_block_q=8, sta_block_kv=8, tau_sparse=args.tau_sparse)
    _, lh, lw = WAN_GEOMETRY.tokens((1, args.video_height, args.video_width))
    # HunyuanVideo-13B: the reference's train.sh tile, whatever --sta_tile says
    tile = (6, 9, 8) if args.model == "hunyuan-13B" else tuple(args.sta_tile)
    return AttentionConfig(latent_shape=(args.num_latent_t, lh, lw),
                           sta_window=tuple(args.sta_window), sta_tile=tile,
                           lowres_window=tuple(args.lowres_window),
                           lowres_reduction=args.lowres_reduction_rate,
                           tau_sparse=args.tau_sparse)


@dataclasses.dataclass
class TrainResult:
    init_step: int  # the optimizer step the run started from (resumed or 0)
    final_step: int
    metrics: list  # one dict of floats per reported optimizer step
    micro_s: list  # seconds per micro-step, synchronised
    step_s: list  # seconds per optimizer step, synchronised
    max_memory_bytes: int  # torch.cuda.max_memory_allocated (0 on the CPU)
    checkpoints: list  # step dirs written
    router_init: dict  # the routers when the loop started, on the CPU
    router_final: dict


def _batches(args, model_cfg, latent_shape, batch: int, hunyuan: bool):
    """Global batches: (latents, text) for Wan, (latents, text, mask, pooled)
    for HunyuanVideo, numpy f32 (the mask bool)."""
    if args.synthetic_data or args.data_json_path is None:
        t, lh, lw = latent_shape
        pt, ph, pw = model_cfg.patch_size
        rng = np.random.default_rng(args.seed)
        while True:
            latents = rng.standard_normal(
                (batch, t * pt, lh * ph, lw * pw, model_cfg.in_channels), np.float32)
            text = rng.standard_normal((batch, model_cfg.text_len, model_cfg.text_dim),
                                       np.float32)
            if not hunyuan:
                yield latents, text
                continue
            mask = np.ones((batch, model_cfg.text_len), bool)
            mask[:, model_cfg.text_len // 2:] = False
            yield latents, text, mask, rng.standard_normal((batch, model_cfg.pooled_dim),
                                                           np.float32)
    ds = LatentDataset(args.data_json_path, args.num_latent_t, args.cfg_rate, args.seed)
    for latents, embeds, mask in epoch_iterator(ds, batch, seed=args.seed):
        if not hunyuan:
            yield latents, embeds
            continue
        # the reference's pooled projection is the first row of the prompt
        # embed (scripts/hunyuan/train_one_step.py:90-92)
        m = mask if mask is not None else np.ones(embeds.shape[:2], bool)
        yield (latents, embeds[:, :model_cfg.text_len], m[:, :model_cfg.text_len].astype(bool),
               embeds[:, 0, :model_cfg.pooled_dim])


def _local(batch: tuple, mesh, device) -> list:
    """This rank's part of a global batch on ``device``: its dp slice of the
    batch, and of the latents its sp slice of the frames."""
    out = []
    for i, arr in enumerate(batch):
        if mesh is not None:
            n = arr.shape[0] // mesh.dp_size
            arr = arr[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]
            if i == 0:
                t = arr.shape[1] // mesh.sp_size
                arr = arr[:, mesh.sp_rank * t:(mesh.sp_rank + 1) * t]
        out.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device))
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model_cfg = MODELS[args.model]
    hunyuan = args.model.startswith("hunyuan")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if dtype == torch.float32:
        full_f32(device)
    attn_cfg = attention_config(args)
    joined = dist.is_initialized()
    mesh = make_mesh_for(args.sp_size, args.dp_size, device, force=args.shard_frozen)
    if mesh is not None:
        device = mesh.device
        if attn_cfg.latent_shape[0] % mesh.sp_size:
            raise ValueError(f"{attn_cfg.latent_shape[0]} latent frames not divisible by "
                             f"sp_size {mesh.sp_size}")
    lead = mesh is None or dist.get_rank() == 0
    out_dir = Path(args.output_dir)
    if lead:
        out_dir.mkdir(parents=True, exist_ok=True)
        # the geometry contract: persisted at train time, re-read at inference
        attn_cfg.save(out_dir / "config.json")
        (out_dir / "args.json").write_text(json.dumps(vars(args), indent=2, default=str))
        print(f"[train] model={args.model} latent={attn_cfg.latent_shape} device={device}"
              + (f" mesh=(dp={mesh.dp_size}, sp={mesh.sp_size})" if mesh else ""), flush=True)
    try:
        return _train(args, device, model_cfg, hunyuan, dtype, attn_cfg, mesh, lead, out_dir)
    finally:
        if dist.is_initialized() and not joined:  # the group this call joined
            dist.destroy_process_group()


def _train(args, device, model_cfg, hunyuan: bool, dtype, attn_cfg, mesh, lead: bool,
           out_dir: Path) -> TrainResult:
    if mesh is not None and not mesh.in_mesh:
        return TrainResult(0, 0, [], [], [], 0, [], {}, {})  # a rank past dp * sp
    model = (HunyuanModel if hunyuan else WanModel)(model_cfg, dtype=dtype, device=device,
                                                    seed=args.seed)
    if args.torch_checkpoint:
        # the student and the frozen teacher are one model (the teacher runs
        # its blocks with routing off), so both take the checkpoint's weights
        load = load_hunyuan_torch_weights if hunyuan else load_wan_torch_weights
        applied, missing = load(model, args.torch_checkpoint)
        if lead:
            print(f"[train] imported {len(applied)} tensors ({len(missing)} missing) from "
                  f"{args.torch_checkpoint}", flush=True)
    frozen_sharded = None
    if mesh is not None and args.shard_frozen:
        frozen_sharded = mesh.dp_group
        for name in STACKED:
            if hasattr(model, name):
                shard_frozen_blocks(getattr(model, name), frozen_sharded)
    routers = router_partition(model)  # f32, the only trainable parameters
    optimizer = MultiSteps(
        make_optimizer(routers, lr=args.learning_rate, weight_decay=args.weight_decay,
                       max_grad_norm=args.max_grad_norm, warmup_steps=args.lr_warmup_steps,
                       total_steps=args.max_train_steps, schedule=args.lr_scheduler),
        args.gradient_accumulation_steps)

    init_step = 0
    if args.resume_from_checkpoint:
        path = (latest_checkpoint(out_dir / "ckpt") if args.resume_from_checkpoint == "latest"
                else Path(args.resume_from_checkpoint))
        if path is not None and path.exists():
            router_state, opt_state = load_router_checkpoint(path)
            apply_router_state(model, router_state)
            if opt_state is not None:
                optimizer.load_state_dict(opt_state)
            init_step = int(path.name.split("-")[1])
            if lead:
                print(f"[train] resumed from {path} at step {init_step}", flush=True)

    sigmas = train_sigmas(shift=args.flow_shift)
    weights = LossWeights(
        diffusion=args.diffusion_loss_weight, reg=args.reg_loss_weight,
        last_layer_distill=args.last_layer_distill_loss_weight,
        hidden_layer_distill=args.hidden_layer_distill_loss_weight,
        precondition_outputs=args.precondition_outputs)
    make_step = make_hunyuan_router_train_step if hunyuan else make_router_train_step
    step_fn = make_step(attn_cfg, weights, timestep_table=sigmas * 1000.0, sigma_table=sigmas,
                        sp_group=mesh.sp_group if mesh and mesh.sp_size > 1 else None,
                        dp_group=mesh.dp_group if mesh and mesh.dp_size > 1 else None,
                        frozen_sharded=frozen_sharded)
    data = _batches(args, model_cfg, attn_cfg.latent_shape,
                    args.train_batch_size * (mesh.dp_size if mesh else 1), hunyuan)
    # the same draws on every rank, as the JAX trainer's replicated key
    generator = torch.Generator(device=device).manual_seed(args.seed)
    logger = MetricsLogger(out_dir) if lead else None

    # SIGTERM / SIGINT ask for a checkpoint at the next optimizer step
    # boundary instead of dying mid-step, so --resume_from_checkpoint latest
    # always finds a consistent state
    stop = {"flag": False}

    def _request_stop(signum, frame):
        stop["flag"] = True
        if lead:
            print(f"[train] signal {signum}: checkpoint + exit at step boundary", flush=True)

    prev = {s: signal.signal(s, _request_stop) for s in (signal.SIGTERM, signal.SIGINT)}
    res = TrainResult(init_step, init_step, [], [], [], 0, [],
                      {k: v.detach().cpu().clone() for k, v in routers.items()}, {})
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        for step in range(init_step, args.max_train_steps):
            t_step = time.time()
            for _ in range(args.gradient_accumulation_steps):
                t_micro = time.time()
                metrics = step_fn(model, optimizer, *_local(next(data), mesh, device),
                                  generator)
                _sync(device)
                res.micro_s.append(time.time() - t_micro)
            res.step_s.append(time.time() - t_step)
            res.final_step = step + 1
            if (step + 1) % args.report_interval == 0:
                values = {k: float(v) for k, v in metrics.items()}
                res.metrics.append({"step": step + 1, **values})
            if (step + 1) % args.report_interval == 0 and lead:
                line = logger.log(step + 1, values)
                print(f"[train] {line} ({res.step_s[-1]:.2f}s/step, "
                      f"{res.step_s[-1] / args.gradient_accumulation_steps:.2f}s/micro-step)",
                      flush=True)
            if ((step + 1) % args.checkpointing_steps == 0 or step + 1 == args.max_train_steps
                    or stop["flag"]):
                if lead:  # the routers and the optimizer are replicated
                    path = save_router_checkpoint(out_dir / "ckpt", step + 1, routers,
                                                  optimizer.state_dict())
                    res.checkpoints.append(path)
                    print(f"[train] {'preempted: ' if stop['flag'] else ''}checkpoint -> "
                          f"{path}", flush=True)
            if stop["flag"]:
                break
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        if logger is not None:
            logger.close()
    if device.type == "cuda":
        res.max_memory_bytes = torch.cuda.max_memory_allocated(device)
    res.router_final = {k: v.detach().cpu().clone() for k, v in routers.items()}
    if lead:
        print(f"[train] done: steps {init_step}..{res.final_step}, peak memory "
          f"{res.max_memory_bytes / 2**30:.2f} GiB", flush=True)
    return res


if __name__ == "__main__":
    main()
