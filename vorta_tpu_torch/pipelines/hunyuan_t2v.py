"""HunyuanVideo text-to-video sampling in latent space (counterpart of
vorta_tpu/pipelines/hunyuan_t2v.py).

Flow-match integration (Euler by default, or UniPC) with the model's
embedded guidance: ``guidance_scale * 1000`` goes to the guidance embedder
and one DiT forward makes a step.  ``true_cfg_scale > 1`` adds a real CFG
pair against a negative embedding (zeros by default), as two sequential
forwards or, with ``cfg_batch``, one batch-2B forward; the guided velocity
is ``vu + s * (vc - vu)``.  The text mask goes to every forward.  Latents
are carried in f32 and cast to the model's dtype for each forward.  A
Python loop drives the steps (the JAX version scans under one jit);
``make_stepper`` gives the host one call per ``chunk`` steps.  A caller
that passes a ``routing`` list gets each hard-routed forward's (layers, H)
expert ids appended to it.  The quantized serving options
(``mm_precision``, ``act_scales``, ``quantized_blocks``) go to every
forward, as in pipelines/wan_t2v.py, and so does the step cache
(``cache_threshold``, ``cache_warmup``, ``cache_coefficients``: one cache
per DiT evaluation stream, indicator temb; ``cache_log`` as there).
Returns latents; ``decode`` turns them into pixels through the attached
VAE (models/hunyuan_vae.py), whole-clip or tiled (models/vae_tiling.py).
Sequence parallelism (``sp_group``) as in pipelines/wan_t2v.py: the
scheduler state replicated, the model on this rank's frames (the joint
attention's Ulysses reshard inside it), its velocity gathered.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import AttentionConfig
from ..models.hunyuan import HunyuanModel
from .wan_t2v import init_caches, integrate, make_schedule, sp_frames, sp_gather, stepper


@dataclasses.dataclass(frozen=True)
class HunyuanSamplingConfig:
    num_inference_steps: int = 50
    guidance_scale: float = 6.0  # embedded guidance (x1000), not CFG
    true_cfg_scale: float = 1.0  # > 1 adds a real CFG pair
    flow_shift: float = 7.0
    routing_mode: str = "off"  # off | hard (soft: the CPU oracle)
    scheduler: str = "euler"  # euler (reference Hunyuan default) | unipc
    # run the true-CFG cond + uncond passes as ONE batch-2B forward
    cfg_batch: bool = False
    mm_precision: str = "bf16"  # bf16 | int8 (W8A8 block projections, ops/qmm.py)
    # step-residual caching (see pipelines/wan_t2v.py); 0 = off
    cache_threshold: float = 0.0
    cache_warmup: int = 1
    cache_coefficients: Optional[tuple] = None


class HunyuanT2VPipeline:
    """Latent-space T2V sampler on the model's device."""

    def __init__(self, model: HunyuanModel, attn_cfg: Optional[AttentionConfig] = None,
                 vae=None, act_scales: Optional[dict] = None, quantized_blocks=None,
                 sp_group=None):
        """``vae``: the HunyuanVAE ``decode`` runs; ``act_scales``: {site:
        (L,)} static int8 activation scales; ``quantized_blocks``: the
        quantized stack the blocks run from (io/quant_serving.py), with
        ``model`` its depth-1 model; ``sp_group``: the sequence-parallel
        group (``attn_cfg`` then gives the global grid)."""
        self.model = model
        self.attn_cfg = attn_cfg
        self.vae = vae
        self.act_scales = act_scales
        self.quantized_blocks = quantized_blocks
        self.sp_group = sp_group

    def prepare_latents(self, generator: torch.Generator, batch: int, frames: int,
                        height: int, width: int) -> torch.Tensor:
        """Initial noise in latent space, channels-last (B, T, H/8, W/8, C), f32."""
        t = (frames - 1) // 4 + 1
        shape = (batch, t, height // 8, width // 8, self.model.cfg.in_channels)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.model.device)

    def decode(self, latents: torch.Tensor, tiled: bool = False,
               tile_latent=(16, 32, 32), overlap_latent=(4, 8, 8)) -> torch.Tensor:
        """Latents (B, T, H/8, W/8, C) -> pixels (B, 4(T-1)+1, H, W, 3) through
        the attached VAE, whole-clip or in blended tiles."""
        if self.vae is None:
            raise ValueError("pipeline constructed without a VAE")
        z = self.vae.denormalize_latents(latents)
        if tiled:
            from ..models.vae_tiling import tiled_decode

            return tiled_decode(lambda zz: self.vae.decode(zz, denormalize=False), z,
                                tile_latent=tile_latent, overlap_latent=overlap_latent)
        return self.vae.decode(z, denormalize=False)

    def init_carry(self, latents: torch.Tensor,
                   sampling: HunyuanSamplingConfig = HunyuanSamplingConfig()):
        """(x, m_prev, m_prev2, x_prev, caches), as in pipelines/wan_t2v.py."""
        x = latents.float()
        caches = init_caches(self.model, x, sampling, sampling.true_cfg_scale > 1.0,
                             self.model.cfg.dim, self.sp_group)
        return x, torch.zeros_like(x), torch.zeros_like(x), x, caches

    def _velocity(self, x, t, text, mask, pooled, neg_text, neg_pooled, guidance,
                  sampling: HunyuanSamplingConfig, caches, force, i, routing, cache_log):
        model, dtype = self.model, self.model.dtype
        kw = dict(attn_cfg=self.attn_cfg, routing_mode=sampling.routing_mode,
                  mm_precision=sampling.mm_precision, act_scales=self.act_scales,
                  quantized_blocks=self.quantized_blocks, sp_group=self.sp_group)
        if caches:
            kw.update(cache_threshold=sampling.cache_threshold, cache_force_compute=force,
                      cache_coefficients=sampling.cache_coefficients)
        new_caches = []
        x = sp_frames(x, self.sp_group)

        def forward(*args, g):
            arm = len(new_caches)
            out = model(*args, guidance=g, step_cache=caches[arm] if caches else None, **kw)
            if routing is not None and out.expert_ids is not None:
                routing.append(out.expert_ids)
            if caches:
                new_caches.append(out.step_cache)
                if cache_log is not None:
                    cache_log.append((i, arm, out.cache_skipped))
            return sp_gather(out.sample.float(), self.sp_group)

        s = float(sampling.true_cfg_scale)
        do_cfg = s > 1.0
        if do_cfg and sampling.cfg_batch:
            out = forward(torch.cat([x, x]).to(dtype), torch.cat([t, t]),
                          torch.cat([text, neg_text]), torch.cat([mask, mask]),
                          torch.cat([pooled, neg_pooled]), g=torch.cat([guidance, guidance]))
            vc, vu = out[: x.shape[0]], out[x.shape[0]:]
            return vu + s * (vc - vu), tuple(new_caches)
        v = forward(x.to(dtype), t, text, mask, pooled, g=guidance)
        if do_cfg:
            vu = forward(x.to(dtype), t, neg_text, mask, neg_pooled, g=guidance)
            v = vu + s * (v - vu)
        return v, tuple(new_caches)

    @torch.no_grad()
    def step(self, carry: tuple, i: int, text_states: torch.Tensor, text_mask: torch.Tensor,
             pooled_text: torch.Tensor, negative_text_states: Optional[torch.Tensor] = None,
             negative_pooled_text: Optional[torch.Tensor] = None,
             sampling: HunyuanSamplingConfig = HunyuanSamplingConfig(),
             routing: Optional[list] = None, cache_log: Optional[list] = None) -> tuple:
        """Denoise step ``i`` of the carry."""
        schedule = make_schedule(sampling)
        n = schedule.num_steps
        if negative_text_states is None:
            negative_text_states = torch.zeros_like(text_states)
        if negative_pooled_text is None:
            negative_pooled_text = torch.zeros_like(pooled_text)
        x, caches = carry[0], carry[4]
        b = x.shape[0]
        t = torch.full((b,), float(schedule.timesteps[i]), device=x.device)
        guidance = torch.full((b,), float(sampling.guidance_scale) * 1000.0, device=x.device)
        force = i < sampling.cache_warmup or i == n - 1
        v, caches = self._velocity(x, t, text_states, text_mask, pooled_text,
                                   negative_text_states, negative_pooled_text, guidance,
                                   sampling, caches, force, i, routing, cache_log)
        return integrate(schedule, sampling, carry[:4] + (caches,), v, i)

    def make_stepper(self, sampling: HunyuanSamplingConfig, chunk: int = 1):
        """Host-driven serving loop: ``(init_carry, step_fn, n_steps)``;
        ``step_fn(carry, i, text, mask, pooled, neg_text=None,
        neg_pooled=None)`` runs ``chunk`` steps from step ``i``."""
        def step_once(carry, j, *conditioning, **kw):
            return self.step(carry, j, *conditioning, sampling=sampling, **kw)

        init, step_fn, n_steps = stepper(self, sampling, chunk, step_once)
        return (lambda latents: init(latents, sampling)), step_fn, n_steps

    @torch.no_grad()
    def __call__(self, latents: torch.Tensor, text_states: torch.Tensor,
                 text_mask: torch.Tensor, pooled_text: torch.Tensor,
                 negative_text_states: Optional[torch.Tensor] = None,
                 negative_pooled_text: Optional[torch.Tensor] = None,
                 sampling: HunyuanSamplingConfig = HunyuanSamplingConfig(),
                 routing: Optional[list] = None,
                 cache_log: Optional[list] = None) -> torch.Tensor:
        """latents (B, T, H, W, C) initial noise; text states (B, L, text_dim),
        text mask (B, L) bool, pooled (B, pooled_dim).  Returns the final
        latents, f32."""
        init, step_fn, n = self.make_stepper(sampling)
        carry = init(latents)
        for i in range(n):
            carry = step_fn(carry, i, text_states, text_mask, pooled_text, negative_text_states,
                            negative_pooled_text, routing=routing, cache_log=cache_log)
        return carry[0]
