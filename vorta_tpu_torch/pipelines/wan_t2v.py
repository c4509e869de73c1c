"""Wan text-to-video sampling pipeline in latent space (counterpart of
vorta_tpu/pipelines/wan_t2v.py).

Classifier-free guidance with two transformer evaluations per step (or one
batch-2B evaluation with ``cfg_batch``), UniPC or flow-match Euler
integration.  Latents are carried in f32 and cast to the model's dtype for
each forward; the guided velocity is ``vu + g * (vc - vu)``.  A Python loop
drives the steps (the JAX version scans under one jit); ``make_stepper``
gives the host one call per ``chunk`` steps.  ``routing_mode`` ("off", or
"hard" to route each head per block and step) goes to every forward; with
CFG both passes route alike, since routing reads only the timestep.  A
caller that passes a ``routing`` list gets each hard-routed forward's
(num_layers, H) expert ids appended to it.  The quantized serving options
(``SamplingConfig.mm_precision``, the pipeline's ``act_scales`` and
``quantized_blocks``) go to every forward too.

Step cache (ops/stepcache.py): with ``cache_threshold > 0`` each DiT
evaluation stream keeps its own cache (one at batch 2B under
``cfg_batch``, else one per CFG arm); the first ``cache_warmup`` steps and
the last always compute.  A ``cache_log`` list gets ``(step, arm,
skipped)`` for each cached forward.  I2V: ``image_embeds`` (B, 257,
image_dim) go to every forward, the unconditional one too.

Sequence parallelism (``sp_group``, a ``torch.distributed`` group; JAX's
``mesh``): the scheduler state stays replicated; each step the model runs
on this rank's contiguous latent frames (the Ulysses reshard inside it,
models/wan.py) and its velocity is gathered over the group before the
scheduler step, so every rank carries the same latents.  CFG batching and
the step cache work as without it (each rank's cache holds its own rows;
the skip decision reads the replicated modulation, so the ranks agree).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..config import AttentionConfig
from ..models.wan import WanModel
from ..ops.stepcache import init_step_cache
from ..parallel.ulysses import gather_sequence
from ..schedulers.flow_match import FlowMatchEulerSchedule
from ..schedulers.unipc import UniPCSchedule, unipc_sample_step


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    num_inference_steps: int = 50
    guidance_scale: float = 5.0
    flow_shift: float = 5.0
    routing_mode: str = "off"  # off | hard (hard_ref / soft: the CPU oracles)
    scheduler: str = "unipc"  # unipc (reference inference default) | euler
    # run the CFG cond+uncond passes as ONE batch-2B forward
    cfg_batch: bool = False
    mm_precision: str = "bf16"  # bf16 | int8 (W8A8 block projections, ops/qmm.py)
    # step-residual caching: skip the block stack while the accumulated
    # temb6 distance since the last computed step stays under this; 0 = off
    cache_threshold: float = 0.0
    cache_warmup: int = 1  # steps at the start that always compute
    # fitted polynomial (highest degree first) rescaling the raw distance
    cache_coefficients: Optional[tuple] = None


def make_schedule(sampling):
    if sampling.scheduler == "unipc":
        return UniPCSchedule.create(sampling.num_inference_steps, sampling.flow_shift)
    if sampling.scheduler == "euler":
        return FlowMatchEulerSchedule.create(sampling.num_inference_steps, sampling.flow_shift)
    raise ValueError(f"unknown scheduler {sampling.scheduler!r}")


def integrate(schedule, sampling, carry: tuple, v: torch.Tensor, i: int) -> tuple:
    """One scheduler step of the carry (x, m_prev, m_prev2, x_prev, caches)."""
    x, m_prev, m_prev2, x_prev, caches = carry
    if sampling.scheduler == "unipc":
        x_next, m_i, x_hist = unipc_sample_step(x, v, i, schedule.sigmas, m_prev, x_prev,
                                                schedule.num_steps, m_prev2=m_prev2)
        return x_next, m_i, m_prev, x_hist, caches
    return schedule.step(x, v, i), m_prev, m_prev2, x_prev, caches


def sp_frames(x: torch.Tensor, sp_group) -> torch.Tensor:
    """This rank's contiguous latent frames of (B, T, H, W, C) ``x``."""
    if sp_group is None:
        return x
    p, r = dist.get_world_size(sp_group), dist.get_rank(sp_group)
    if x.shape[1] % p:
        raise ValueError(f"{x.shape[1]} latent frames not divisible by the sp group's {p} ranks")
    t = x.shape[1] // p
    return x[:, r * t:(r + 1) * t]


def sp_gather(v: torch.Tensor, sp_group) -> torch.Tensor:
    """The whole clip's frames of a rank-local (B, T/P, H, W, C) ``v``."""
    return v if sp_group is None else gather_sequence(v, 1, sp_group)


def init_caches(model, x: torch.Tensor, sampling, do_cfg: bool, width: int, sp_group):
    """One step cache per DiT evaluation stream (one at batch 2B under
    ``cfg_batch``), each over this rank's rows."""
    if sampling.cache_threshold <= 0.0:
        return ()
    cfg = model.cfg
    b, t_px, h_px, w_px, _ = sp_frames(x, sp_group).shape
    pt, ph, pw = cfg.patch_size
    seq = (t_px // pt) * (h_px // ph) * (w_px // pw)
    arms = [2 * b] if (do_cfg and sampling.cfg_batch) else [b] * (2 if do_cfg else 1)
    return tuple(init_step_cache(n, seq, cfg.dim, width, model.dtype, x.device) for n in arms)


def stepper(pipe, sampling, chunk: int, step_once):
    """``(init_carry, step_fn, n_steps)`` around ``step_once(carry, i,
    *conditioning)``: ``step_fn`` runs ``chunk`` steps from step ``i``."""
    n_steps = make_schedule(sampling).num_steps
    if n_steps % chunk != 0:
        raise ValueError(f"chunk {chunk} must divide num_inference_steps {n_steps}")

    def step_fn(carry, i, *conditioning, **kw):
        for j in range(int(i), int(i) + chunk):
            carry = step_once(carry, j, *conditioning, **kw)
        return carry

    return pipe.init_carry, step_fn, n_steps


class WanT2VPipeline:
    """Latent-space T2V sampler on the model's device."""

    def __init__(self, model: WanModel, attn_cfg: Optional[AttentionConfig] = None,
                 act_scales: Optional[dict] = None, quantized_blocks=None, sp_group=None):
        """``act_scales``: {site: (L,)} static int8 activation scales;
        ``quantized_blocks``: the quantized stack the blocks run from
        (io/quant_serving.py), with ``model`` its depth-1 model;
        ``sp_group``: the sequence-parallel group (``attn_cfg`` is then
        needed: the global grid)."""
        self.model = model
        self.attn_cfg = attn_cfg
        self.act_scales = act_scales
        self.quantized_blocks = quantized_blocks
        self.sp_group = sp_group

    def prepare_latents(self, generator: torch.Generator, batch: int, frames: int,
                        height: int, width: int) -> torch.Tensor:
        """Initial noise in latent space, channels-last (B, T, H/8, W/8, C), f32."""
        cfg = self.model.cfg
        t = (frames - 1) // 4 + 1
        shape = (batch, t, height // 8, width // 8, cfg.in_channels)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.model.device)

    def init_carry(self, latents: torch.Tensor, sampling: SamplingConfig = SamplingConfig()):
        """(x, m_prev, m_prev2, x_prev, caches): f32 latents and the step
        caches, one per DiT evaluation stream (none without the cache)."""
        x = latents.float()
        caches = init_caches(self.model, x, sampling, sampling.guidance_scale > 1.0,
                             6 * self.model.cfg.dim, self.sp_group)
        return x, torch.zeros_like(x), torch.zeros_like(x), x, caches

    def _velocity(self, x, t, pe, ne, image_embeds, sampling: SamplingConfig, caches, force,
                  i, routing, cache_log):
        model, dtype = self.model, self.model.dtype
        kw = dict(attn_cfg=self.attn_cfg, routing_mode=sampling.routing_mode,
                  mm_precision=sampling.mm_precision, act_scales=self.act_scales,
                  quantized_blocks=self.quantized_blocks, sp_group=self.sp_group)
        if caches:
            kw.update(cache_threshold=sampling.cache_threshold, cache_force_compute=force,
                      cache_coefficients=sampling.cache_coefficients)
        new_caches = []
        x = sp_frames(x, self.sp_group)

        def forward(*args, img):
            arm = len(new_caches)
            out = model(*args, image_context=img,
                        step_cache=caches[arm] if caches else None, **kw)
            if routing is not None and out.expert_ids is not None:
                routing.append(out.expert_ids)
            if caches:
                new_caches.append(out.step_cache)
                if cache_log is not None:
                    cache_log.append((i, arm, out.cache_skipped))
            return sp_gather(out.sample.float(), self.sp_group)

        g = float(sampling.guidance_scale)
        do_cfg = sampling.guidance_scale > 1.0
        if do_cfg and sampling.cfg_batch:
            img2 = None if image_embeds is None else torch.cat([image_embeds, image_embeds])
            out = forward(torch.cat([x, x]).to(dtype), torch.cat([t, t]), torch.cat([pe, ne]),
                          img=img2)
            vc, vu = out[: x.shape[0]], out[x.shape[0]:]
            return vu + g * (vc - vu), tuple(new_caches)
        v = forward(x.to(dtype), t, pe, img=image_embeds)
        if do_cfg:  # the image tokens stay on for the unconditional pass
            vu = forward(x.to(dtype), t, ne, img=image_embeds)
            v = vu + g * (v - vu)
        return v, tuple(new_caches)

    @torch.no_grad()
    def step(self, carry: tuple, i: int, prompt_embeds: torch.Tensor,
             negative_prompt_embeds: torch.Tensor, image_embeds: Optional[torch.Tensor] = None,
             sampling: SamplingConfig = SamplingConfig(), routing: Optional[list] = None,
             cache_log: Optional[list] = None) -> tuple:
        """Denoise step ``i`` of the carry."""
        schedule = make_schedule(sampling)
        n = schedule.num_steps
        x, caches = carry[0], carry[4]
        t = torch.full((x.shape[0],), float(schedule.timesteps[i]), device=x.device)
        force = i < sampling.cache_warmup or i == n - 1
        v, caches = self._velocity(x, t, prompt_embeds, negative_prompt_embeds, image_embeds,
                                   sampling, caches, force, i, routing, cache_log)
        return integrate(schedule, sampling, carry[:4] + (caches,), v, i)

    def make_stepper(self, sampling: SamplingConfig, chunk: int = 1):
        """Host-driven serving loop: ``(init_carry, step_fn, n_steps)``;
        ``step_fn(carry, i, pe, ne, image_embeds=None)`` runs ``chunk``
        steps from step ``i`` (a chunk must divide the step count)."""
        def step_once(carry, j, pe, ne, image_embeds=None, **kw):
            return self.step(carry, j, pe, ne, image_embeds, sampling=sampling, **kw)

        init, step_fn, n_steps = stepper(self, sampling, chunk, step_once)
        return (lambda latents: init(latents, sampling)), step_fn, n_steps

    @torch.no_grad()
    def __call__(self, latents: torch.Tensor, prompt_embeds: torch.Tensor,
                 negative_prompt_embeds: Optional[torch.Tensor] = None,
                 sampling: SamplingConfig = SamplingConfig(),
                 routing: Optional[list] = None,
                 image_embeds: Optional[torch.Tensor] = None,
                 cache_log: Optional[list] = None) -> torch.Tensor:
        """latents (B, T, H, W, C) initial noise; prompt embeds (B, L, text_dim);
        ``image_embeds`` (B, 257, image_dim) CLIP image tokens for I2V (the
        model needs ``image_dim``).  Returns the final latents, f32."""
        if negative_prompt_embeds is None:
            negative_prompt_embeds = torch.zeros_like(prompt_embeds)
        init, step_fn, n = self.make_stepper(sampling)
        carry = init(latents)
        for i in range(n):
            carry = step_fn(carry, i, prompt_embeds, negative_prompt_embeds, image_embeds,
                            routing=routing, cache_log=cache_log)
        return carry[0]
