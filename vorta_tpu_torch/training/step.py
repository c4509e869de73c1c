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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

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


class RouterTrainStep:
    """The train step: ``step(model, optimizer, latents, prompt_embeds,
    generator) -> metrics``.  ``loss`` takes explicit (timesteps, sigmas,
    eps), so a caller can feed draws made elsewhere; ``draw`` makes them
    from ``generator``."""

    def __init__(self, attn_cfg: AttentionConfig, weights: LossWeights,
                 timestep_table, sigma_table, remat_blocks: bool = True):
        self.attn_cfg = attn_cfg
        self.weights = weights
        self.timestep_table = torch.as_tensor(timestep_table, dtype=torch.float32)
        self.sigma_table = torch.as_tensor(sigma_table, dtype=torch.float32)
        self.remat_blocks = remat_blocks

    def draw(self, generator: torch.Generator, latents: torch.Tensor):
        """(timesteps (B,), sigmas (B,), eps like latents in f32)."""
        dev = latents.device
        timesteps, sigmas = sample_timesteps(
            generator, latents.shape[0], self.timestep_table.to(dev), self.sigma_table.to(dev),
            n_intervals=self.weights.n_intervals)
        eps = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                          device=generator.device).to(dev)
        return timesteps, sigmas, eps

    def loss(self, model, latents, prompt_embeds, timesteps, sigmas, eps):
        """(loss, metrics) of one micro-step at the given draws."""
        w = self.weights
        x0 = latents.float()
        sig = sigmas.float()[:, None, None, None, None]
        noisy = (1.0 - sig) * x0 + sig * eps
        out = model(noisy.to(model.dtype), timesteps, prompt_embeds, attn_cfg=self.attn_cfg,
                    routing_mode="soft", return_losses=True, remat_blocks=self.remat_blocks)
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
        loss = dw * fm + w_reg * reg + w_last * last + w_hidden * hidden
        metrics = {"loss": loss, "l_fm": fm, "l_reg": reg, "l_last": last, "l_hidden": hidden,
                   "timestep": timesteps[0]}
        return loss, {k: v.detach() for k, v in metrics.items()}

    def __call__(self, model, optimizer: MultiSteps, latents, prompt_embeds,
                 generator: torch.Generator) -> dict:
        return self.step_with(model, optimizer, latents, prompt_embeds,
                              *self.draw(generator, latents))

    def step_with(self, model, optimizer: MultiSteps, latents, prompt_embeds,
                  timesteps, sigmas, eps) -> dict:
        """One micro-step at the given draws: loss, router gradients, the
        accumulating optimizer.  ``grad_norm`` is this micro-step's own."""
        names = list(optimizer.params)
        loss, metrics = self.loss(model, latents, prompt_embeds, timesteps, sigmas, eps)
        grads = torch.autograd.grad(loss, [optimizer.params[n] for n in names])
        metrics["grad_norm"] = global_norm(grads)
        optimizer.step(dict(zip(names, grads)))
        return metrics


def make_router_train_step(attn_cfg: AttentionConfig, weights: LossWeights = LossWeights(),
                           timestep_table=None, sigma_table=None,
                           remat_blocks: bool = True) -> RouterTrainStep:
    """The train step over (model, optimizer, latents, prompt_embeds,
    generator), the JAX trainer's ``make_router_train_step`` on one card."""
    if timestep_table is None or sigma_table is None:
        raise ValueError("the train step needs the scheduler's timestep and sigma tables")
    return RouterTrainStep(attn_cfg, weights, timestep_table, sigma_table, remat_blocks)
