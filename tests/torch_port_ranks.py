"""Rank functions of tests/test_torch_port_parallel.py (an importable module,
so ``torch.multiprocessing.spawn`` can start them).

``spawn(out_dir, setup)`` starts 4 CPU processes that meet through a
``file://`` store under ``out_dir`` (no TCP port: pytest-xdist workers run
side by side), join a gloo group and run ``rank_checks``; each rank writes
what it computed to ``out_dir/rank<r>.pt``, which ``spawn`` returns, one
dict per rank.  ``setup`` (a file the parent wrote) holds the models'
states, the inputs and the draws, so every rank and the parent's
single-process runs see the same numbers.

The models are tiny with 4 heads (so 2 and 4 ranks divide them):
``WAN4`` / ``HY4``.  The ranks run the world as one sp group of 4 ("sp4"),
then the (dp 2, sp 2) mesh's sp groups each on the whole batch ("sp2") and
on their replica's half of it, then the blocks' frozen parameters
layer-sharded over the mesh's dp groups, then cli.train and cli.sample
with ``--sp_size 2 --dp_size 1`` (ranks 2 and 3 idle).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from vorta_tpu_torch.config import WAN_TINY, AttentionConfig
from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanModel
from vorta_tpu_torch.models.wan import WanModel
from vorta_tpu_torch.parallel import (
    all_to_all_heads_to_seq,
    all_to_all_seq_to_heads,
    gather_sequence,
    make_mesh,
    slice_local,
)
from vorta_tpu_torch.parallel.fsdp import shard_frozen_blocks
from vorta_tpu_torch.pipelines.hunyuan_t2v import HunyuanSamplingConfig, HunyuanT2VPipeline
from vorta_tpu_torch.pipelines.wan_t2v import SamplingConfig, WanT2VPipeline
from vorta_tpu_torch.schedulers.flow_match import train_sigmas
from vorta_tpu_torch.training.step import (
    LossWeights,
    make_hunyuan_router_train_step,
    make_router_train_step,
    router_partition,
)

WAN4 = dataclasses.replace(WAN_TINY, num_heads=4, head_dim=32)
HY4 = dataclasses.replace(HUNYUAN_TINY, num_heads=4, head_dim=32, rope_axes=(8, 12, 12))
WAN_ATTN = AttentionConfig(latent_shape=(4, 4, 4), sta_window=(3, 3, 1), sta_tile=(2, 2, 2),
                           lowres_window=(2, 2, 2), block_q=16, block_kv=16, sta_block_q=8,
                           sta_block_kv=8)
HY_ATTN = AttentionConfig(latent_shape=(4, 6, 16), sta_window=(3, 3, 3), sta_tile=(2, 2, 2),
                          lowres_window=(2, 2, 2), block_q=32, block_kv=32)
WAN_LATENT = (1, 4, 8, 8, 16)
HY_LATENT = (1, 4, 12, 32, 16)
HY_VALID = 17  # valid text tokens of 24
# per head: the expert hard routing sends it to (one-hot router biases)
HARD = {"blocks": [0, 1, 2, 2], "dual_blocks": [0, 2, 1, 2], "single_blocks": [1, 2, 2, 0]}
MODES = ("off", "hard", "soft")


def make_setup(path, wan_state=None, hy_state=None) -> dict:
    """The shared states, inputs and draws, written to ``path``."""
    rng = np.random.default_rng(5)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if wan_state is None:
        wan_state = WanModel(WAN4, device="cpu", seed=3).state_dict()
    if hy_state is None:
        hy_state = HunyuanModel(HY4, device="cpu", seed=4).state_dict()
    wan_state, hy_state = hard_routers(wan_state), hard_routers(hy_state)
    sig = train_sigmas(5.0)
    setup = dict(
        wan_state=wan_state, hy_state=hy_state,
        wan_latents=randn(*WAN_LATENT), wan_text=randn(1, WAN4.text_len, WAN4.text_dim),
        hy_latents=randn(*HY_LATENT), hy_text=randn(1, HY4.text_len, HY4.text_dim),
        hy_pooled=randn(1, HY4.pooled_dim),
        hy_mask=(torch.arange(HY4.text_len) < HY_VALID)[None],
        # train draws for a batch of 2: (t, sigma) each, and the noise
        t=torch.tensor([float(sig[300] * 1000.0)] * 2), s=torch.tensor([float(sig[300])] * 2),
        wan_batch=randn(2, *WAN_LATENT[1:]), wan_batch_text=randn(2, WAN4.text_len, WAN4.text_dim),
        wan_eps=randn(2, *WAN_LATENT[1:]), hy_batch=randn(2, *HY_LATENT[1:]),
        hy_eps=randn(2, *HY_LATENT[1:]))
    torch.save(setup, path)
    return setup


def hard_routers(state: dict) -> dict:
    """``state`` with one-hot router biases (HARD): hard routing sends the
    heads to all three experts."""
    out = dict(state)
    for stack, experts in HARD.items():
        for name in list(out):
            if name.startswith(stack + ".") and name.endswith("router.linear.bias"):
                out[name] = 6.0 * torch.eye(3)[experts].reshape(-1)
    return out


def models(setup: dict):
    """(Wan, HunyuanVideo) on the CPU, f32, with the setup's weights."""
    wan = WanModel(WAN4, device="cpu", seed=0)
    wan.load_state_dict(setup["wan_state"])
    hy = HunyuanModel(HY4, device="cpu", seed=0)
    hy.load_state_dict(setup["hy_state"])
    return wan, hy


def frames(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous frames of (B, T, ...)."""
    if group is None:
        return x
    p, r = dist.get_world_size(group), dist.get_rank(group)
    t = x.shape[1] // p
    return x[:, r * t:(r + 1) * t]


def gather(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else gather_sequence(x, 1, group)


def forwards(wan, hy, setup: dict, group, frozen_sharded=None) -> dict:
    """Both models' forwards, routing off, hard and soft, gathered."""
    out = {}
    with torch.no_grad():
        for mode in MODES:
            kw = dict(routing_mode=mode, sp_group=group, frozen_sharded=frozen_sharded)
            out[f"wan_{mode}"] = gather(wan(
                frames(setup["wan_latents"], group), torch.tensor([500.0]), setup["wan_text"],
                attn_cfg=WAN_ATTN, **kw).sample, group)
            out[f"hy_{mode}"] = gather(hy(
                frames(setup["hy_latents"], group), torch.tensor([500.0]), setup["hy_text"],
                setup["hy_mask"], setup["hy_pooled"], guidance=torch.tensor([6000.0]),
                attn_cfg=HY_ATTN, **kw).sample, group)
    return out


def train_grads(wan, hy, setup: dict, sp_group, dp_group=None, dp_rank=0, dp_size=1,
                frozen_sharded=None) -> dict:
    """Each model's train-step metrics and reduced router gradients at the
    setup's draws: this dp replica's share of the batch of 2, its frames."""
    sig = train_sigmas(5.0)
    out = {}
    b = 2 // dp_size
    rows = slice(dp_rank * b, (dp_rank + 1) * b)
    for name, model, make in (("wan", wan, make_router_train_step),
                              ("hy", hy, make_hunyuan_router_train_step)):
        step = make(WAN_ATTN if name == "wan" else HY_ATTN, LossWeights(hidden_layer_distill=1.0),
                    timestep_table=sig * 1000.0, sigma_table=sig, sp_group=sp_group,
                    dp_group=dp_group, frozen_sharded=frozen_sharded)
        routers = router_partition(model)
        lat = frames(setup[f"{name}_batch"][rows], sp_group)
        eps = frames(setup[f"{name}_eps"][rows], sp_group)
        draws = (setup["t"][rows], setup["s"][rows], eps)
        if name == "wan":
            share, metrics = step.loss(model, lat, setup["wan_batch_text"][rows], *draws)
        else:
            cond = (setup["hy_text"].expand(b, -1, -1), setup["hy_mask"].expand(b, -1),
                    setup["hy_pooled"].expand(b, -1))
            share, metrics = step.loss(model, lat, *cond, *draws)
        grads = torch.autograd.grad(share, list(routers.values()))
        grads, metrics = step.reduce(list(grads), metrics)
        out[f"{name}_grads"] = torch.cat([g.flatten() for g in grads])
        out[f"{name}_metrics"] = torch.stack([metrics[k].float() for k in
                                              ("loss", "l_fm", "l_reg", "l_last", "l_hidden")])
    return out


def sampling(wan, hy, setup: dict, group) -> dict:
    """Wan: 3 UniPC steps, CFG batched, the step cache on, routed hard;
    HunyuanVideo: 2 Euler steps with a batched true-CFG pair, routed hard."""
    wpipe = WanT2VPipeline(wan, attn_cfg=WAN_ATTN, sp_group=group)
    ws = SamplingConfig(num_inference_steps=3, guidance_scale=5.0, routing_mode="hard",
                        cfg_batch=True, cache_threshold=1e9, cache_warmup=1)
    hpipe = HunyuanT2VPipeline(hy, attn_cfg=HY_ATTN, sp_group=group)
    hs = HunyuanSamplingConfig(num_inference_steps=2, true_cfg_scale=3.0, cfg_batch=True,
                               routing_mode="hard")
    log = []
    wan_out = wpipe(setup["wan_latents"], setup["wan_text"], sampling=ws, cache_log=log)
    hy_out = hpipe(setup["hy_latents"], setup["hy_text"], setup["hy_mask"], setup["hy_pooled"],
                   sampling=hs)
    return {"wan_sample": wan_out, "hy_sample": hy_out,
            "wan_cache_skips": torch.tensor([s for *_, s in log])}


TRAIN_ARGV = ["--model", "hunyuan-tiny", "--device", "cpu", "--dtype", "fp32", "--synthetic_data",
              "--max_train_steps", "1", "--gradient_accumulation_steps", "1", "--seed", "3"]
SAMPLE_ARGV = ["--model", "hunyuan-tiny", "--device", "cpu", "--dtype", "fp32", "--random_embeds",
               "--num_frames", "13", "--height", "96", "--width", "256",
               "--num_inference_steps", "2"]


def entry_points(out_dir: str) -> dict:
    """cli.train (1 step) and cli.sample (2 routed steps), HunyuanVideo-tiny,
    on an sp group of ranks 0 and 1."""
    from vorta_tpu_torch.cli import sample, train

    sp = ["--sp_size", "2", "--dp_size", "1"]
    res = train.main(TRAIN_ARGV + sp + ["--output_dir", f"{out_dir}/train"])
    out = sample.main(SAMPLE_ARGV + sp + ["--output", f"{out_dir}/sample.npy"])
    if out is None:  # a rank past dp x sp: it joined the groups, and idles
        return {}
    return {"cli_train_routers": torch.cat([v.flatten() for v in res.router_final.values()]),
            "cli_train_loss": torch.tensor(res.metrics[0]["loss"]),
            "cli_sample": out.latents}


def run_sp(wan, hy, setup: dict, group) -> dict:
    out = forwards(wan, hy, setup, group)
    out.update(train_grads(wan, hy, setup, group))
    out.update(sampling(wan, hy, setup, group))
    return out


def rank_checks(rank: int, world: int, setup_path: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world)
    torch.set_num_threads(1)
    setup = torch.load(setup_path, weights_only=False)
    group = dist.new_group(list(range(world)))
    mesh = make_mesh(sp_size=2, device="cpu")
    res = {"mesh": torch.tensor([mesh.dp_size, mesh.sp_size, mesh.dp_rank, mesh.sp_rank,
                                 dist.get_world_size(mesh.sp_group),
                                 dist.get_world_size(mesh.dp_group)])}
    refusals = []
    for kw in (dict(sp_size=3, device="cpu"), dict(sp_size=2, dp_size=world, device="cpu"),
               dict(sp_size=1, device="cuda")):
        try:
            make_mesh(**kw)
            refusals.append("")
        except (ValueError, RuntimeError) as e:
            refusals.append(str(e))
    res["refusals"] = refusals
    for name, g in (("sp4", group), ("sp2", mesh.sp_group)):
        # the reshard: rank r's rows of x = arange over (B, H, S, D), S = 4 P
        p = dist.get_world_size(g)
        x = torch.arange(2 * 4 * 4 * p * 3, dtype=torch.float32).reshape(2, 4, 4 * p, 3)
        local = frames(x.transpose(1, 2), g).transpose(1, 2).contiguous()
        hs = all_to_all_heads_to_seq(local, g)
        res[f"{name}_heads_to_seq"] = hs
        res[f"{name}_round_trip"] = all_to_all_seq_to_heads(hs, g)
        res[f"{name}_local_rows"] = local
        res[f"{name}_slice_local"] = slice_local(x, 1, g)
        res[f"{name}_gather"] = gather_sequence(local, 2, g)

    wan, hy = models(setup)
    for name, g in (("sp4", group), ("sp2", mesh.sp_group)):
        res.update({f"{name}_{k}": v for k, v in run_sp(wan, hy, setup, g).items()})
    # the (dp 2, sp 2) mesh: each replica its half of the batch
    res.update({f"mesh_{k}": v for k, v in train_grads(
        wan, hy, setup, mesh.sp_group, mesh.dp_group, mesh.dp_rank, 2).items()})
    # the frozen blocks layer-sharded over a dp group of 2, no sp
    for name in ("blocks", "dual_blocks", "single_blocks"):
        shard_frozen_blocks(getattr(wan if name == "blocks" else hy, name), mesh.dp_group)
    res["held_frozen"] = torch.tensor([sum(p.numel() for p in wan.blocks.parameters()),
                                       sum(p.numel() for p in hy.dual_blocks.parameters())])
    res.update({f"sharded_{k}": v for k, v in forwards(wan, hy, setup, None,
                                                       mesh.dp_group).items()})
    res.update({f"sharded_{k}": v for k, v in train_grads(
        wan, hy, setup, None, frozen_sharded=mesh.dp_group).items()})
    res.update(entry_points(out_dir))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn(out_dir, setup_path, world: int = 4) -> list:
    """Run ``rank_checks`` on ``world`` gloo ranks; one result dict per rank."""
    import torch.multiprocessing as mp

    mp.spawn(rank_checks, args=(world, str(setup_path), str(out_dir)), nprocs=world)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
