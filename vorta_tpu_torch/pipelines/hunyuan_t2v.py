"""HunyuanVideo text-to-video sampling in latent space (counterpart of
vorta_tpu/pipelines/hunyuan_t2v.py).

Flow-match integration (Euler by default, or UniPC) with the model's
embedded guidance: ``guidance_scale * 1000`` goes to the guidance embedder
and one DiT forward makes a step.  ``true_cfg_scale > 1`` adds a real CFG
pair against a negative embedding (zeros by default), as two sequential
forwards or, with ``cfg_batch``, one batch-2B forward; the guided velocity
is ``vu + s * (vc - vu)``.  The text mask goes to every forward.  Latents
are carried in f32 and cast to the model's dtype for each forward.  A
Python loop drives the steps (the JAX version scans under one jit).  A
caller that passes a ``routing`` list gets each hard-routed forward's
(layers, H) expert ids appended to it.  The quantized serving options
(``mm_precision``, ``act_scales``, ``quantized_blocks``) go to every
forward, as in pipelines/wan_t2v.py.  Returns latents: the VAE decode,
the step cache and the mesh belong to later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import AttentionConfig
from ..models.hunyuan import HunyuanModel
from ..schedulers.flow_match import FlowMatchEulerSchedule
from ..schedulers.unipc import UniPCSchedule, unipc_sample_step


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


class HunyuanT2VPipeline:
    """Latent-space T2V sampler on the model's device."""

    def __init__(self, model: HunyuanModel, attn_cfg: Optional[AttentionConfig] = None,
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
        t = (frames - 1) // 4 + 1
        shape = (batch, t, height // 8, width // 8, self.model.cfg.in_channels)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.model.device)

    def _velocity(self, x, t, text, mask, pooled, neg_text, neg_pooled, guidance,
                  sampling: HunyuanSamplingConfig, routing) -> torch.Tensor:
        model, dtype = self.model, self.model.dtype
        kw = dict(attn_cfg=self.attn_cfg, routing_mode=sampling.routing_mode,
                  mm_precision=sampling.mm_precision, act_scales=self.act_scales,
                  quantized_blocks=self.quantized_blocks)

        def forward(*args, g):
            out = model(*args, guidance=g, **kw)
            if routing is not None and out.expert_ids is not None:
                routing.append(out.expert_ids)
            return out.sample.float()

        s = float(sampling.true_cfg_scale)
        do_cfg = s > 1.0
        if do_cfg and sampling.cfg_batch:
            out = forward(torch.cat([x, x]).to(dtype), torch.cat([t, t]),
                          torch.cat([text, neg_text]), torch.cat([mask, mask]),
                          torch.cat([pooled, neg_pooled]), g=torch.cat([guidance, guidance]))
            vc, vu = out[: x.shape[0]], out[x.shape[0]:]
            return vu + s * (vc - vu)
        v = forward(x.to(dtype), t, text, mask, pooled, g=guidance)
        if do_cfg:
            vu = forward(x.to(dtype), t, neg_text, mask, neg_pooled, g=guidance)
            v = vu + s * (v - vu)
        return v

    @torch.no_grad()
    def __call__(self, latents: torch.Tensor, text_states: torch.Tensor,
                 text_mask: torch.Tensor, pooled_text: torch.Tensor,
                 negative_text_states: Optional[torch.Tensor] = None,
                 negative_pooled_text: Optional[torch.Tensor] = None,
                 sampling: HunyuanSamplingConfig = HunyuanSamplingConfig(),
                 routing: Optional[list] = None) -> torch.Tensor:
        """latents (B, T, H, W, C) initial noise; text states (B, L, text_dim),
        text mask (B, L) bool, pooled (B, pooled_dim).  Returns the final
        latents, f32."""
        if sampling.scheduler == "unipc":
            schedule = UniPCSchedule.create(sampling.num_inference_steps, sampling.flow_shift)
        elif sampling.scheduler == "euler":
            schedule = FlowMatchEulerSchedule.create(sampling.num_inference_steps,
                                                     sampling.flow_shift)
        else:
            raise ValueError(f"unknown scheduler {sampling.scheduler!r}")
        if negative_text_states is None:
            negative_text_states = torch.zeros_like(text_states)
        if negative_pooled_text is None:
            negative_pooled_text = torch.zeros_like(pooled_text)
        n = schedule.num_steps
        x = latents.float()
        b = x.shape[0]
        guidance = torch.full((b,), float(sampling.guidance_scale) * 1000.0, device=x.device)
        m_prev, m_prev2, x_prev = torch.zeros_like(x), torch.zeros_like(x), x
        for i in range(n):
            t = torch.full((b,), float(schedule.timesteps[i]), device=x.device)
            v = self._velocity(x, t, text_states, text_mask, pooled_text, negative_text_states,
                               negative_pooled_text, guidance, sampling, routing)
            if sampling.scheduler == "unipc":
                x_next, m_i, x_hist = unipc_sample_step(
                    x, v, i, schedule.sigmas, m_prev, x_prev, n, m_prev2=m_prev2)
                x, m_prev, m_prev2, x_prev = x_next, m_i, m_prev, x_hist
            else:
                x = schedule.step(x, v, i)
        return x
