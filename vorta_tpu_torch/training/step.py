"""Router-distillation training step (counterpart of vorta_tpu/training/step.py).

One step = rectified-flow corruption, the student (soft-routed) and frozen
teacher (routing off) forwards interleaved per block, the composite loss,
and an AdamW update of the router parameters only
(scripts/wan/train_one_step.py, scripts/wan/train.py:250-259).  The DiT
stays frozen: gradients flow through it to the routers, and nothing else
is updated.

Loss = w_fm * MSE(v_pred, eps - x0)        [or x0-preconditioned]
     + w_reg * sum_l mean(score_full^2)    [L2 on full-attention routing]
     + w_last * MSE(last-layer student vs teacher)
     + w_hidden * MSE(per-block hidden student vs teacher)

The optimizer is the JAX trainer's ``optax.chain(clip_by_global_norm,
adamw(schedule))``, here ``ClippedAdamW`` over ``torch.optim.AdamW``
(decoupled decay, eps outside the square root, as optax's), wrapped for
gradient accumulation in ``MultiSteps`` with ``optax.MultiSteps``'
semantics: the micro-step gradients are averaged (not summed), and the
inner optimizer, whose schedule counts its own steps, steps on every k-th.

``make_hunyuan_router_train_step`` is HunyuanVideo's: a batch of (latents,
text states, text mask, pooled text) and the constant guidance 1000 of the
reference (scripts/hunyuan/train_one_step.py).

Parallelism (``sp_group`` / ``dp_group`` / ``frozen_sharded``,
``torch.distributed`` groups): under sequence parallelism each rank holds
its contiguous latent-frame shard; the timesteps are the same on every
rank, and the noise is this rank's frames of one draw of the whole clip
(each shard its own noise, the noise a single card would draw, where JAX
folds the rank into the key).  The JAX step differentiates losses
averaged over sp (``pmean`` of the flow-matching, last-layer and hidden
losses; ``reg`` comes from the replicated router scores).  Here each rank
differentiates its share, (dw fm_r + w_last last_r + w_hidden hidden_r +
w_reg reg) / P, whose sum over the group is that loss; the collectives'
backwards are exact adjoints (parallel/ulysses.py), so the router
gradients summed over sp are the loss's, and are then averaged over dp.
The metrics are the averaged losses (and averaged over dp).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..config import AttentionConfig
from .sampling import rebalance_loss_weights, sample_timesteps


@dataclasses.dataclass(frozen=True)
class LossWeights:
    diffusion: float = 1.0
    reg: float = 0.02
    last_layer_distill: float = 20.0
    hidden_layer_distill: float = 0.0
    precondition_outputs: bool = False
    n_intervals: int = 5


def router_partition(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """Make the router parameters the only trainable ones; returns them by
    name.  Every other parameter gets ``requires_grad_(False)``.  The
    routers are f32 whatever the model's dtype (models/router.py)."""
    params = {}
    for name, p in model.named_parameters():
        is_router = "router" in name.split(".")
        p.requires_grad_(is_router)
        if is_router:
            if p.dtype != torch.float32:
                raise ValueError(f"router parameter {name} is {p.dtype}, not f32")
            params[name] = p
    if not params:
        raise ValueError("the model has no router parameters")
    return params


STACKED = ("blocks", "dual_blocks", "single_blocks")


def frozen_sharding_specs(model: torch.nn.Module) -> Dict[str, bool]:
    """{name: layer-sharded} over the frozen (non-router) parameters: the
    stacked block containers' (Wan's ``blocks``, Hunyuan's ``dual_blocks`` /
    ``single_blocks``) shard by layer under ``--shard_frozen``
    (parallel/fsdp.py ``shard_frozen_blocks``); the embedders, the head and
    the token refiner stay replicated, as in the JAX package's
    ``frozen_sharding_specs``."""
    out = {}
    for name, _ in model.named_parameters():
        segs = name.split(".")
        if "router" in segs:
            continue
        out[name] = "context_embedder" not in segs and segs[0] in STACKED
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def lr_schedule(lr: float, warmup_steps: int = 0, total_steps: Optional[int] = None,
                schedule: str = "constant") -> Callable[[int], float]:
    """The learning rate at each optimizer step count (0 for the first step),
    as the JAX trainer's optax schedules give it."""

    def linear(init, end, steps):
        if steps <= 0:
            return lambda count: init
        return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end

    def join(first, second, boundary):
        return lambda count: first(count) if count < boundary else second(count - boundary)

    if schedule == "constant":
        return linear(0.0, lr, warmup_steps) if warmup_steps else (lambda count: lr)
    if total_steps is None:
        raise ValueError(f"{schedule} schedule needs total_steps")
    if schedule == "linear":
        return join(linear(0.0, lr, max(warmup_steps, 1)),
                    linear(lr, 0.0, max(total_steps - warmup_steps, 1)), warmup_steps)
    if schedule == "cosine":
        decay = total_steps - warmup_steps
        if decay <= 0:
            raise ValueError(f"cosine schedule needs total_steps > warmup_steps, got {decay}")

        def cosine(count):
            return lr * 0.5 * (1 + math.cos(math.pi * min(count, decay) / decay))

        return join(linear(0.0, lr, warmup_steps), cosine, warmup_steps)
    raise ValueError(f"unknown schedule {schedule!r}")


class ClippedAdamW:
    """Global-norm clipping, then AdamW at the scheduled learning rate, over a
    {name: parameter} dict updated in place: ``optax.chain(
    clip_by_global_norm(max_grad_norm), adamw(schedule, b1, b2, eps,
    weight_decay))``."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], schedule: Callable[[int], float],
                 *, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-4,
                 max_grad_norm: float = 1.0):
        self.params = params
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0  # optimizer steps taken: the schedule's input
        self.adamw = torch.optim.AdamW(list(params.values()), lr=schedule(0), betas=betas,
                                       eps=eps, weight_decay=weight_decay, foreach=False)

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        norm = global_norm(grads.values())
        clip = norm >= self.max_grad_norm
        for name, p in self.params.items():
            g = grads[name].to(p.dtype)
            p.grad = torch.where(clip, g / norm * self.max_grad_norm, g)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])


class MultiSteps:
    """Gradient accumulation with ``optax.MultiSteps(opt, every_k)``'s
    semantics: ``step`` folds each micro-step's gradients into a running
    mean (``acc + (g - acc) / (n + 1)``) and steps the inner optimizer with
    it on every ``every_k``-th call, returning whether it did."""

    def __init__(self, opt: ClippedAdamW, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k {every_k} < 1")
        self.opt = opt
        self.every_k = every_k
        self.mini_step = 0
        self.acc = {name: torch.zeros_like(p) for name, p in opt.params.items()}

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return self.opt.params

    def step(self, grads: Dict[str, torch.Tensor]) -> bool:
        n = self.mini_step
        for name, acc in self.acc.items():
            acc.add_((grads[name].to(acc.dtype) - acc) / (n + 1))
        if n < self.every_k - 1:
            self.mini_step += 1
            return False
        self.opt.step(self.acc)
        for acc in self.acc.values():
            acc.zero_()
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "acc": {k: v.cpu() for k, v in self.acc.items()},
                "inner": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.mini_step = int(state["mini_step"])
        for name, acc in self.acc.items():
            acc.copy_(state["acc"][name])
        self.opt.load_state_dict(state["inner"])


def make_optimizer(params: Dict[str, torch.nn.Parameter], lr: float = 1e-2,
                   weight_decay: float = 1e-4, betas=(0.9, 0.999), eps: float = 1e-8,
                   max_grad_norm: float = 1.0, warmup_steps: int = 0,
                   total_steps: Optional[int] = None, schedule: str = "constant") -> ClippedAdamW:
    """AdamW + global-norm clipping + LR schedule (reference train.py:250-272)."""
    return ClippedAdamW(params, lr_schedule(lr, warmup_steps, total_steps, schedule),
                        betas=betas, eps=eps, weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm)


def _sp(group):
    return (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))


class RouterTrainStep:
    """The train step: ``step(model, optimizer, latents, prompt_embeds,
    generator) -> metrics``.  ``loss`` takes explicit (timesteps, sigmas,
    eps), so a caller can feed draws made elsewhere; ``draw`` makes them
    from ``generator``.  Under sequence parallelism ``latents`` and ``eps``
    are the rank's frames (see the module's docstring)."""

    guidance_value = None  # HunyuanVideo's constant training guidance

    def __init__(self, attn_cfg: AttentionConfig, weights: LossWeights,
                 timestep_table, sigma_table, remat_blocks: bool = True, sp_group=None,
                 dp_group=None, frozen_sharded=None):
        self.attn_cfg = attn_cfg
        self.weights = weights
        self.timestep_table = torch.as_tensor(timestep_table, dtype=torch.float32)
        self.sigma_table = torch.as_tensor(sigma_table, dtype=torch.float32)
        self.remat_blocks = remat_blocks
        self.sp_group = sp_group
        self.dp_group = dp_group
        self.frozen_sharded = frozen_sharded

    def draw(self, generator: torch.Generator, latents: torch.Tensor):
        """(timesteps (B,), sigmas (B,), eps like latents in f32): under
        sequence parallelism eps is this rank's frames of one draw over the
        whole clip, so every shard has its own noise."""
        dev = latents.device
        timesteps, sigmas = sample_timesteps(
            generator, latents.shape[0], self.timestep_table.to(dev), self.sigma_table.to(dev),
            n_intervals=self.weights.n_intervals)
        p, r = _sp(self.sp_group)
        t = latents.shape[1]
        shape = (latents.shape[0], p * t) + tuple(latents.shape[2:])
        eps = torch.randn(shape, generator=generator, dtype=torch.float32,
                          device=generator.device)[:, r * t:(r + 1) * t].to(dev)
        return timesteps, sigmas, eps

    def _forward(self, model, noisy, timesteps, cond):
        (prompt_embeds,) = cond
        return model(noisy.to(model.dtype), timesteps, prompt_embeds, **self._model_kw())

    def _model_kw(self) -> dict:
        return dict(attn_cfg=self.attn_cfg, routing_mode="soft", return_losses=True,
                    remat_blocks=self.remat_blocks, sp_group=self.sp_group,
                    frozen_sharded=self.frozen_sharded)

    def _loss(self, model, latents, cond, timesteps, sigmas, eps):
        w = self.weights
        x0 = latents.float()
        sig = sigmas.float()[:, None, None, None, None]
        noisy = (1.0 - sig) * x0 + sig * eps
        out = self._forward(model, noisy, timesteps, cond)
        pred = out.sample.float()
        if w.precondition_outputs:
            fm = ((noisy - pred * sig) - x0).square().mean()
        else:
            fm = (pred - (eps - x0)).square().mean()
        dw, (w_reg, w_last, w_hidden) = rebalance_loss_weights(
            w.diffusion, (w.reg, w.last_layer_distill, w.hidden_layer_distill), timesteps,
            n_intervals=w.n_intervals)
        reg, last, hidden = (out.reg_loss, out.last_layer_distill_loss,
                             out.hidden_layer_distill_loss)
        p, _ = _sp(self.sp_group)
        # this rank's share: its sum over the sp group is the loss
        share = (dw * fm + w_reg * reg + w_last * last + w_hidden * hidden) / p
        avg = {"l_fm": fm.detach(), "l_last": last.detach(), "l_hidden": hidden.detach()}
        if self.sp_group is not None:  # JAX's pmean over sp
            stacked = torch.stack(list(avg.values()))
            dist.all_reduce(stacked, group=self.sp_group)
            avg = dict(zip(avg, stacked / p))
        loss = dw * avg["l_fm"] + w_reg * reg.detach() + w_last * avg["l_last"] \
            + w_hidden * avg["l_hidden"]
        metrics = {"loss": loss, "l_fm": avg["l_fm"], "l_reg": reg.detach(),
                   "l_last": avg["l_last"], "l_hidden": avg["l_hidden"],
                   "timestep": timesteps[0].detach()}
        return share, metrics

    def loss(self, model, latents, prompt_embeds, timesteps, sigmas, eps):
        """(this rank's share of the loss, metrics) of one micro-step at the
        given draws; without sequence parallelism the share is the loss."""
        return self._loss(model, latents, (prompt_embeds,), timesteps, sigmas, eps)

    def __call__(self, model, optimizer: MultiSteps, latents, prompt_embeds,
                 generator: torch.Generator) -> dict:
        return self.step_with(model, optimizer, latents, prompt_embeds,
                              *self.draw(generator, latents))

    def step_with(self, model, optimizer: MultiSteps, latents, prompt_embeds,
                  timesteps, sigmas, eps) -> dict:
        """One micro-step at the given draws: loss, router gradients, the
        accumulating optimizer.  ``grad_norm`` is this micro-step's own."""
        return self._step(model, optimizer, self.loss(model, latents, prompt_embeds, timesteps,
                                                      sigmas, eps))

    def _step(self, model, optimizer: MultiSteps, loss_metrics) -> dict:
        share, metrics = loss_metrics
        names = list(optimizer.params)
        grads = list(torch.autograd.grad(share, [optimizer.params[n] for n in names]))
        grads, metrics = self.reduce(grads, metrics)
        metrics["grad_norm"] = global_norm(grads)
        optimizer.step(dict(zip(names, grads)))
        return metrics

    def reduce(self, grads: list, metrics: dict):
        """The router gradients summed over sp and averaged over dp, the
        metrics averaged over dp (JAX's pmean over its dp axis)."""
        if self.sp_group is not None:
            flat = torch.cat([g.flatten() for g in grads])
            dist.all_reduce(flat, group=self.sp_group)
            grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
        if self.dp_group is not None:
            n = dist.get_world_size(self.dp_group)
            flat = torch.cat([g.flatten() for g in grads]
                             + [torch.stack([m.float() for m in metrics.values()])])
            dist.all_reduce(flat, group=self.dp_group)
            flat = flat / n
            sizes = [g.numel() for g in grads] + [len(metrics)]
            parts = flat.split(sizes)
            grads = [f.view_as(g) for f, g in zip(parts, grads)]
            metrics = dict(zip(metrics, parts[-1]))
        return grads, metrics


class HunyuanRouterTrainStep(RouterTrainStep):
    """HunyuanVideo's train step: ``step(model, optimizer, latents, text,
    mask, pooled, generator) -> metrics``, the guidance embedder fed the
    constant ``guidance_value`` (the reference trains at 1000)."""

    def __init__(self, *args, guidance_value: float = 1000.0, **kw):
        super().__init__(*args, **kw)
        self.guidance_value = guidance_value

    def _forward(self, model, noisy, timesteps, cond):
        text, mask, pooled = cond
        guidance = torch.full((noisy.shape[0],), self.guidance_value, device=noisy.device)
        return model(noisy.to(model.dtype), timesteps, text, mask, pooled, guidance=guidance,
                     **self._model_kw())

    def loss(self, model, latents, text, mask, pooled, timesteps, sigmas, eps):
        return self._loss(model, latents, (text, mask, pooled), timesteps, sigmas, eps)

    def __call__(self, model, optimizer: MultiSteps, latents, text, mask, pooled,
                 generator: torch.Generator) -> dict:
        return self.step_with(model, optimizer, latents, text, mask, pooled,
                              *self.draw(generator, latents))

    def step_with(self, model, optimizer: MultiSteps, latents, text, mask, pooled,
                  timesteps, sigmas, eps) -> dict:
        return self._step(model, optimizer, self.loss(model, latents, text, mask, pooled,
                                                      timesteps, sigmas, eps))


def make_router_train_step(attn_cfg: AttentionConfig, weights: LossWeights = LossWeights(),
                           timestep_table=None, sigma_table=None,
                           remat_blocks: bool = True, sp_group=None, dp_group=None,
                           frozen_sharded=None) -> RouterTrainStep:
    """The train step over (model, optimizer, latents, prompt_embeds,
    generator), the JAX trainer's ``make_router_train_step``; the groups
    stand for its ``sp_axis`` / ``dp_axis`` / ``frozen_sharded_axis``."""
    if timestep_table is None or sigma_table is None:
        raise ValueError("the train step needs the scheduler's timestep and sigma tables")
    return RouterTrainStep(attn_cfg, weights, timestep_table, sigma_table, remat_blocks,
                           sp_group, dp_group, frozen_sharded)


def make_hunyuan_router_train_step(attn_cfg: AttentionConfig,
                                   weights: LossWeights = LossWeights(),
                                   timestep_table=None, sigma_table=None,
                                   guidance_value: float = 1000.0, remat_blocks: bool = True,
                                   sp_group=None, dp_group=None,
                                   frozen_sharded=None) -> HunyuanRouterTrainStep:
    """HunyuanVideo's train step over (model, optimizer, latents, text, mask,
    pooled, generator), the JAX trainer's ``make_hunyuan_router_train_step``
    (text, mask and pooled replicated under sequence parallelism)."""
    if timestep_table is None or sigma_table is None:
        raise ValueError("the train step needs the scheduler's timestep and sigma tables")
    return HunyuanRouterTrainStep(attn_cfg, weights, timestep_table, sigma_table, remat_blocks,
                                  sp_group, dp_group, frozen_sharded,
                                  guidance_value=guidance_value)
