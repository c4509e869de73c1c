"""Wan text-to-video sampling pipeline in latent space (counterpart of
vorta_tpu/pipelines/wan_t2v.py).

Classifier-free guidance with two transformer evaluations per step (or one
batch-2B evaluation with ``cfg_batch``), UniPC or flow-match Euler
integration.  Latents are carried in f32 and cast to the model's dtype for
each forward; the guided velocity is ``vu + g * (vc - vu)``.  A Python loop
drives the steps (the JAX version scans under one jit).  ``routing_mode``
("off", or "hard" to route each head per block and step) goes to every
forward; with CFG both passes route alike, since routing reads only the
timestep.  A caller that passes a ``routing`` list gets each hard-routed
forward's (num_layers, H) expert ids appended to it.  The quantized
serving options (``SamplingConfig.mm_precision``, the pipeline's
``act_scales`` and ``quantized_blocks``) go to every forward too.  No mesh
or step cache in this slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import AttentionConfig
from ..models.wan import WanModel
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


class WanT2VPipeline:
    """Latent-space T2V sampler on the model's device."""

    def __init__(self, model: WanModel, attn_cfg: Optional[AttentionConfig] = None,
                 act_scales: Optional[dict] = None, quantized_blocks=None):
        """``act_scales``: {site: (L,)} static int8 activation scales;
        ``quantized_blocks``: the quantized stack the blocks run from
        (io/quant_serving.py), with ``model`` its depth-1 model."""
        self.model = model
        self.attn_cfg = attn_cfg
        self.act_scales = act_scales
        self.quantized_blocks = quantized_blocks

    def prepare_latents(self, generator: torch.Generator, batch: int, frames: int,
                        height: int, width: int) -> torch.Tensor:
        """Initial noise in latent space, channels-last (B, T, H/8, W/8, C), f32."""
        cfg = self.model.cfg
        t = (frames - 1) // 4 + 1
        shape = (batch, t, height // 8, width // 8, cfg.in_channels)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.model.device)

    def _velocity(self, x, t, pe, ne, sampling: SamplingConfig, routing) -> torch.Tensor:
        model, dtype = self.model, self.model.dtype
        kw = dict(attn_cfg=self.attn_cfg, routing_mode=sampling.routing_mode,
                  mm_precision=sampling.mm_precision, act_scales=self.act_scales,
                  quantized_blocks=self.quantized_blocks)

        def forward(*args):
            out = model(*args, **kw)
            if routing is not None and out.expert_ids is not None:
                routing.append(out.expert_ids)
            return out.sample.float()

        g = float(sampling.guidance_scale)
        do_cfg = sampling.guidance_scale > 1.0
        if do_cfg and sampling.cfg_batch:
            out = forward(torch.cat([x, x]).to(dtype), torch.cat([t, t]), torch.cat([pe, ne]))
            vc, vu = out[: x.shape[0]], out[x.shape[0]:]
            return vu + g * (vc - vu)
        v = forward(x.to(dtype), t, pe)
        if do_cfg:
            vu = forward(x.to(dtype), t, ne)
            v = vu + g * (v - vu)
        return v

    @torch.no_grad()
    def __call__(self, latents: torch.Tensor, prompt_embeds: torch.Tensor,
                 negative_prompt_embeds: Optional[torch.Tensor] = None,
                 sampling: SamplingConfig = SamplingConfig(),
                 routing: Optional[list] = None) -> torch.Tensor:
        """latents (B, T, H, W, C) initial noise; prompt embeds (B, L, text_dim).
        Returns the final latents, f32."""
        if sampling.scheduler == "unipc":
            schedule = UniPCSchedule.create(sampling.num_inference_steps, sampling.flow_shift)
        elif sampling.scheduler == "euler":
            schedule = FlowMatchEulerSchedule.create(sampling.num_inference_steps,
                                                     sampling.flow_shift)
        else:
            raise ValueError(f"unknown scheduler {sampling.scheduler!r}")
        if negative_prompt_embeds is None:
            negative_prompt_embeds = torch.zeros_like(prompt_embeds)
        n = schedule.num_steps
        x = latents.float()
        m_prev, m_prev2, x_prev = torch.zeros_like(x), torch.zeros_like(x), x
        for i in range(n):
            t = torch.full((x.shape[0],), float(schedule.timesteps[i]), device=x.device)
            v = self._velocity(x, t, prompt_embeds, negative_prompt_embeds, sampling, routing)
            if sampling.scheduler == "unipc":
                x_next, m_i, x_hist = unipc_sample_step(
                    x, v, i, schedule.sigmas, m_prev, x_prev, n, m_prev2=m_prev2)
                x, m_prev, m_prev2, x_prev = x_next, m_i, m_prev, x_hist
            else:
                x = schedule.step(x, v, i)
        return x
