"""Wan 2.1 video Diffusion Transformer in PyTorch (counterpart of
vorta_tpu/models/wan.py), serving and router-distillation training.

Channels-last latents (B, T, H, W, C) in, the same layout out.  The 30
blocks are an ``nn.ModuleList`` walked by a Python loop (the JAX model
stacks them and scans).  Self-attention runs full attention
(``routing_mode="off"``) or routes each head to an expert
(``"hard"``, the serving path; ``"hard_ref"`` and ``"soft"``, the oracles,
and ``"soft"`` the training formulation).
Every block's router reads only the timestep embedding, so all blocks'
routing is made at the start of the forward and brought to the host once
per forward: each block then launches only the experts that have heads.

Training (``return_losses``, soft routing): the frozen teacher stream runs
each block with routing off under ``torch.no_grad``, interleaved with the
student block by block as the JAX scan body does, and the forward returns
the distillation losses: ``reg_loss`` = sum over blocks of
mean(score_full^2), ``hidden_layer_distill_loss`` = sum over blocks of the
MSE between the two streams, ``last_layer_distill_loss`` = the MSE of the
two streams through the output head.  ``remat_blocks`` recomputes each
student block in the backward (``torch.utils.checkpoint``, non-reentrant,
early stop off, so every block reruns whole).  The routers' parameters are
f32 whatever the model's dtype, as the JAX trainer casts them.

Quantized serving: ``mm_precision="int8"`` runs the block projections the
JAX model runs in W8A8 (ops/qmm.py: attn1 q / k / v / out, attn2 q / out,
the FFN; attn2's text k / v and the embedders stay in the model's dtype),
with ``act_scales`` ({site: (L,)}) giving each layer its static activation
scales, and ``calibrate_mm`` returning each site's per-layer max |x|
(``mm_calibration``).  ``quantized_blocks`` (ops/quant.py ``BlockStack``)
serves the blocks from a quantized stack: each layer is dequantized into the
model's one block (a depth-1 model) just before it runs.

Step cache (ops/stepcache.py): with ``step_cache`` the forward decides from
temb6 whether to run the block stack or add the cached block residual;
the decision is read to the host in one device-to-host copy (with the
routing ids where routing is hard), and a skipped forward runs
no block, so launches no block kernel.  It returns the new cache in
``WanOutput.step_cache``.

Image to video (``WanModelConfig.image_dim``): ``image_context`` (B, 257,
image_dim) CLIP image tokens go through ``WanImageEmbedding`` and every
block's cross-attention attends to them with its own key / value
projections (``add_k_proj`` / ``add_v_proj``, RMS-normed keys), a second
``padded_dense_attention`` summed into the text one.

Sequence parallelism (``sp_group``, a ``torch.distributed`` group):
``latents`` hold this rank's contiguous latent-frame chunk and
``attn_cfg.latent_shape`` is the global grid; the conditioning is
replicated.  Self-attention reshards q / k / v to the full sequence of the
rank's heads (parallel/ulysses.py), the router scores and the hard routing
sliced to those heads, and its output back; RoPE takes the rank's rows of
the global tables; cross-attention needs no collective.  The output is the
rank's frame chunk.  ``frozen_sharded`` (a group) runs the blocks from
layer-sharded frozen parameters (parallel/fsdp.py), as models/hunyuan.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..config import AttentionConfig, WanModelConfig
from ..device import resolve_device
from ..ops.experts import full_attention, padded_dense_attention, routed_attention
from ..ops.prologue import fused_qk_prologue, use_fused_prologue
from ..ops import qmm, stepcache
from ..ops.qmm import FusedLinear, QLinear
from ..ops.routed_fused import route_expert_ids
from ..ops.rope import apply_rope_half, rope_cos_sin
from ..parallel.fsdp import sharded_block_fetcher
from ..parallel.ulysses import (
    all_to_all_heads_to_seq,
    all_to_all_seq_to_heads,
    local_expert_ids,
    slice_local,
)
from .common import (
    FP32LayerNorm,
    GELUFeedForward,
    RMSNorm,
    TextProjection,
    TimestepEmbedding,
    init_flax_defaults,
    sinusoidal_timestep_embedding,
)
from .router import Router

ROUTING_MODES = ("off", "hard", "hard_ref", "soft")


@dataclasses.dataclass
class WanOutput:
    sample: torch.Tensor  # (B, T, H, W, C) latent-space prediction
    # (num_layers, B, H, E) router scores with return_scores (zeros when
    # routing is off, as in the JAX model)
    routing_scores: Optional[torch.Tensor] = None
    # (num_layers, H) expert ids of a hard-routed forward, on the host
    expert_ids: Optional[np.ndarray] = None
    # training losses (return_losses), f32 scalars
    reg_loss: Optional[torch.Tensor] = None
    last_layer_distill_loss: Optional[torch.Tensor] = None
    hidden_layer_distill_loss: Optional[torch.Tensor] = None
    # {site: (num_layers,) f32 max |x|} with calibrate_mm
    mm_calibration: Optional[dict] = None
    step_cache: Optional[object] = None  # ops.stepcache.StepCache (serving)
    hidden_delta: Optional[torch.Tensor] = None  # block-stack out - in (B, S, D)
    temb_indicator: Optional[torch.Tensor] = None  # (B, 6 * dim) f32 cache indicator
    # with step_cache: whether this forward skipped the block stack (host bool)
    cache_skipped: Optional[bool] = None


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, -1).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class WanSelfAttention(nn.Module):
    def __init__(self, cfg: WanModelConfig, *, dtype, device):
        super().__init__()
        dim = cfg.dim
        kw = dict(dtype=dtype, device=device)
        self.num_heads = cfg.num_heads
        # to_q | to_k | to_v of the JAX model, concatenated
        self.qkv = FusedLinear(dim, (dim, dim, dim),
                               sites=("attn1.to_q", "attn1.to_k", "attn1.to_v"), **kw)
        self.to_out = QLinear(dim, dim, site="attn1.to_out", **kw)
        self.norm_q = RMSNorm(dim, cfg.eps, device=device) if cfg.qk_norm else None
        self.norm_k = RMSNorm(dim, cfg.eps, device=device) if cfg.qk_norm else None

    def forward(self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor],
                attn_cfg: AttentionConfig, scores: Optional[torch.Tensor] = None,
                routing_mode: str = "off", expert_ids=None, sp_group=None) -> torch.Tensor:
        # one qkv product; q/k columns and gains are stored in the
        # half-permuted RoPE layout (ops/rope.py permute_qk_to_half)
        q, k, v = self.qkv(x)
        cos, sin = rope
        if use_fused_prologue(routing_mode, x.shape[1], x.shape[2], self.num_heads):
            q, k, v = fused_qk_prologue(
                q, k, v,
                self.norm_q.weight if self.norm_q is not None else None,
                self.norm_k.weight if self.norm_k is not None else None,
                cos, sin, num_heads=self.num_heads,
                eps=self.norm_q.eps if self.norm_q is not None else 1e-6,
                qk_norm=self.norm_q is not None,
            )
        else:
            if self.norm_q is not None:
                q, k = self.norm_q(q), self.norm_k(k)
            q = apply_rope_half(_split_heads(q, self.num_heads), cos, sin)
            k = apply_rope_half(_split_heads(k, self.num_heads), cos, sin)
            v = _split_heads(v, self.num_heads)
        if sp_group is not None:
            # Ulysses reshard: the full sequence, 1/P of the heads per rank
            q, k, v = (all_to_all_heads_to_seq(a, sp_group) for a in (q, k, v))
            if scores is not None:
                scores = slice_local(scores, 1, sp_group)
            expert_ids = local_expert_ids(expert_ids, sp_group)
        if routing_mode == "off":
            out = full_attention(q, k, v, attn_cfg)
        else:
            out = routed_attention(q, k, v, scores, attn_cfg, mode=routing_mode,
                                   expert_ids=expert_ids)
        if sp_group is not None:
            out = all_to_all_seq_to_heads(out, sp_group)
        return self.to_out(_merge_heads(out))


class WanCrossAttention(nn.Module):
    """Cross-attention to the projected text sequence; with ``image_dim``
    set, also to the embedded image tokens through their own key / value
    projections, the two outputs summed (diffusers' I2V attn2)."""

    def __init__(self, cfg: WanModelConfig, *, dtype, device):
        super().__init__()
        dim = cfg.dim
        kw = dict(dtype=dtype, device=device)
        self.num_heads = cfg.num_heads
        # the video-length q / out obey the int8 switch; the text k / v stay
        self.to_q = QLinear(dim, dim, site="attn2.to_q", **kw)
        self.to_k = nn.Linear(dim, dim, **kw)
        self.to_v = nn.Linear(dim, dim, **kw)
        self.to_out = QLinear(dim, dim, site="attn2.to_out", **kw)
        self.norm_q = RMSNorm(dim, cfg.eps, device=device) if cfg.qk_norm else None
        self.norm_k = RMSNorm(dim, cfg.eps, device=device) if cfg.qk_norm else None
        self.add_k_proj = self.add_v_proj = self.norm_added_k = None
        if cfg.image_dim is not None:
            self.add_k_proj = nn.Linear(dim, dim, **kw)
            self.add_v_proj = nn.Linear(dim, dim, **kw)
            self.norm_added_k = RMSNorm(dim, cfg.eps, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                image_context: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.num_heads
        q = self.to_q(x)
        if self.norm_q is not None:
            q = self.norm_q(q)
        k = self.to_k(context)
        if self.norm_k is not None:
            k = self.norm_k(k)
        v = self.to_v(context)
        qh = _split_heads(q, h)
        out = padded_dense_attention(qh, _split_heads(k, h), _split_heads(v, h))
        if image_context is not None and self.add_k_proj is not None:
            ki = self.norm_added_k(self.add_k_proj(image_context))
            vi = self.add_v_proj(image_context)
            out = out + padded_dense_attention(qh, _split_heads(ki, h), _split_heads(vi, h))
        return self.to_out(_merge_heads(out))


class WanBlock(nn.Module):
    """AdaLN-modulated DiT block."""

    def __init__(self, cfg: WanModelConfig, *, dtype, device):
        super().__init__()
        dim = cfg.dim
        self.norm1 = FP32LayerNorm(dim, cfg.eps, affine=False, device=device)
        self.attn1 = WanSelfAttention(cfg, dtype=dtype, device=device)
        self.attn2 = WanCrossAttention(cfg, dtype=dtype, device=device)
        self.norm2 = FP32LayerNorm(dim, cfg.eps, affine=cfg.cross_attn_norm, device=device)
        self.norm3 = FP32LayerNorm(dim, cfg.eps, affine=False, device=device)
        self.ffn = GELUFeedForward(dim, cfg.ffn_dim, dtype=dtype, device=device,
                                   site_prefix="ffn")
        self.scale_shift_table = nn.Parameter(
            torch.empty((1, 6, dim), dtype=torch.float32, device=device))
        self.router = Router(dim, cfg.num_heads, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor, temb6: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor], attn_cfg: AttentionConfig,
                scores: Optional[torch.Tensor] = None, routing_mode: str = "off",
                expert_ids=None, image_context: Optional[torch.Tensor] = None,
                sp_group=None) -> torch.Tensor:
        """``scores``: this block's (B, H, E) router scores; ``expert_ids``:
        its hard routing as (ids on the device, the same ids on the host);
        ``image_context``: the embedded image tokens (I2V); ``sp_group``: the
        sequence-parallel group (x holds the rank's rows)."""
        mod = self.scale_shift_table + temb6.float()  # (B, 6, dim) f32
        gate_msa, c_gate = mod[:, 2][:, None, :], mod[:, 5][:, None, :]
        norm_x = self.norm1.modulated(x, mod[:, 1], mod[:, 0])
        attn_out = self.attn1(norm_x, rope, attn_cfg, scores, routing_mode, expert_ids, sp_group)
        # self-attention and FFN residuals add in f32, then cast
        x = (x.float() + attn_out.float() * gate_msa).to(x.dtype)
        # the cross-attention residual adds in x's dtype
        x = x + self.attn2(self.norm2(x), context, image_context)
        norm_x = self.norm3.modulated(x, mod[:, 4], mod[:, 3])
        ff_out = self.ffn(norm_x)
        return (x.float() + ff_out.float() * c_gate).to(x.dtype)


class WanImageEmbedding(nn.Module):
    """CLIP image-token projection for I2V (diffusers WanImageEmbedding):
    FP32LayerNorm(in) -> Linear(in, in) -> exact GELU -> Linear(in, dim) ->
    FP32LayerNorm(dim), both norms affine at torch's default eps 1e-5."""

    def __init__(self, in_dim: int, dim: int, *, dtype, device):
        super().__init__()
        self.norm1 = FP32LayerNorm(in_dim, 1e-5, affine=True, device=device)
        self.proj_in = nn.Linear(in_dim, in_dim, dtype=dtype, device=device)
        self.proj_out = nn.Linear(in_dim, dim, dtype=dtype, device=device)
        self.norm2 = FP32LayerNorm(dim, 1e-5, affine=True, device=device)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        h = self.norm1(image_embeds)
        return self.norm2(self.proj_out(F.gelu(self.proj_in(h))))


class WanConditionEmbedder(nn.Module):
    """Timestep + text (+ image) conditioning (diffusers WanTimeTextImageEmbedding)."""

    def __init__(self, cfg: WanModelConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.freq_dim = cfg.freq_dim
        self.time_embedder = TimestepEmbedding(cfg.freq_dim, cfg.dim, **kw)
        self.time_proj = nn.Linear(cfg.dim, cfg.dim * 6, **kw)
        self.text_embedder = TextProjection(cfg.text_dim, cfg.dim, **kw)
        self.image_embedder = (WanImageEmbedding(cfg.image_dim, cfg.dim, **kw)
                               if cfg.image_dim is not None else None)

    def forward(self, timestep: torch.Tensor, context: torch.Tensor,
                image_embeds: Optional[torch.Tensor] = None):
        dtype = self.time_proj.weight.dtype
        sin_emb = sinusoidal_timestep_embedding(timestep, self.freq_dim)
        temb = self.time_embedder(sin_emb.to(dtype))  # (B, dim)
        temb6 = self.time_proj(F.silu(temb)).reshape(temb.shape[0], 6, -1)
        img = None
        if image_embeds is not None and self.image_embedder is not None:
            img = self.image_embedder(image_embeds.to(dtype))
        return temb, temb6, self.text_embedder(context), img


class WanModel(nn.Module):
    """WanTransformer3DModel, channels-last.

    ``device`` defaults to CUDA and raises without it.  Weights are random,
    drawn from ``seed`` with Flax's default initialisers (so a random model
    has the JAX model's scale); ``io/from_jax.py`` carries real ones across.
    """

    def __init__(self, cfg: WanModelConfig, *, dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embedding = nn.Conv3d(
            cfg.in_channels, cfg.dim, kernel_size=cfg.patch_size, stride=cfg.patch_size,
            dtype=dtype, device=device)
        self.condition_embedder = WanConditionEmbedder(cfg, dtype=dtype, device=device)
        self.blocks = nn.ModuleList(
            WanBlock(cfg, dtype=dtype, device=device) for _ in range(cfg.num_layers))
        self.norm_out = FP32LayerNorm(cfg.dim, cfg.eps, affine=False, device=device)
        self.proj_out = nn.Linear(cfg.dim, cfg.out_channels * int(np.prod(cfg.patch_size)),
                                  dtype=dtype, device=device)
        self.scale_shift_table = nn.Parameter(
            torch.empty((1, 2, cfg.dim), dtype=torch.float32, device=device))
        self._rope_cache: dict = {}
        if device.type != "meta":
            self.init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_flax_defaults(self, generator)
        dim = self.cfg.dim
        for table in [self.scale_shift_table] + [b.scale_shift_table for b in self.blocks]:
            table.copy_(torch.randn(table.shape, generator=generator, device=table.device,
                                    dtype=torch.float32) / dim**0.5)

    @property
    def device(self) -> torch.device:
        return self.scale_shift_table.device

    def _rope(self, grid: Tuple[int, int, int], rows: Optional[Tuple[int, int]] = None):
        """(cos, sin) of the rows ``rows`` = (start, count) of the global grid
        (all of them by default), on the model's device."""
        rows = rows or (0, int(np.prod(grid)))
        key = (grid, rows)
        if key not in self._rope_cache:
            cos, sin = (np.ascontiguousarray(a[rows[0]:rows[0] + rows[1]]) for a in
                        rope_cos_sin(grid, self.cfg.head_dim, self.cfg.rope_theta))
            self._rope_cache[key] = (torch.from_numpy(cos).to(self.device),
                                     torch.from_numpy(sin).to(self.device))
        return self._rope_cache[key]

    def forward(self, *args, mm_precision: str = "bf16", **kwargs) -> WanOutput:
        """See ``_forward``; ``mm_precision="int8"`` runs the block
        projections in W8A8 (ops/qmm.py) for this call."""
        with qmm.mm_precision(mm_precision):
            return self._forward(*args, **kwargs)

    def _forward(self, latents: torch.Tensor, timestep: torch.Tensor, context: torch.Tensor,
                 attn_cfg: Optional[AttentionConfig] = None, routing_mode: str = "off",
                 image_context: Optional[torch.Tensor] = None,
                 return_scores: bool = False, return_losses: bool = False,
                 remat_blocks: bool = False, act_scales: Optional[dict] = None,
                 calibrate_mm: bool = False, quantized_blocks=None, step_cache=None,
                 cache_threshold: float = 0.0, cache_force_compute=None,
                 cache_coefficients=None, return_hidden_delta: bool = False,
                 sp_group=None, frozen_sharded=None) -> WanOutput:
        """latents (B, T, H, W, C_in), timestep (B,), context (B, L, text_dim);
        ``image_context`` (B, 257, image_dim) CLIP image tokens (I2V).
        ``act_scales``: {site: (num_layers,)} static int8 activation scales;
        ``quantized_blocks``: a ``BlockStack`` the blocks run from.
        ``step_cache``: the previous step's ``StepCache`` (ops/stepcache.py);
        the block stack runs unless the accumulated temb6 distance stays
        under ``cache_threshold`` and ``cache_force_compute`` (a bool, or a
        () bool tensor) is not set.  ``return_hidden_delta``: the block
        stack's out - in and the cache's indicator (the probe the JAX
        package's tools/fit_cache_poly.py reads).  ``sp_group``: the
        sequence-parallel group, latents the rank's frames and ``attn_cfg``
        the global grid; ``frozen_sharded``: the group the blocks' frozen
        parameters are layer-sharded over."""
        if routing_mode not in ROUTING_MODES:
            raise ValueError(f"unknown routing mode {routing_mode!r}")
        if return_losses and routing_mode == "off":
            raise ValueError("return_losses requires routed attention")
        if step_cache is not None and (return_losses or calibrate_mm):
            raise ValueError("step caching is a serving mode: incompatible with "
                             "return_losses / calibrate_mm")
        serving_only = (quantized_blocks is not None or act_scales or calibrate_mm
                        or qmm.current_mm_precision() != "bf16")
        if serving_only and (return_losses or remat_blocks):
            raise NotImplementedError("the int8, calibration and quantized-block modes serve; "
                                      "router training (return_losses, remat) runs bf16")
        if frozen_sharded is not None and quantized_blocks is not None:
            raise ValueError("frozen_sharded shards the model's own blocks; quantized_blocks "
                             "serve a stack")
        cfg = self.cfg
        b, t_px, h_px, w_px, _ = latents.shape
        pt, ph, pw = cfg.patch_size
        sp, sp_rank = ((1, 0) if sp_group is None
                       else (dist.get_world_size(sp_group), dist.get_rank(sp_group)))
        grid = (sp * (t_px // pt), h_px // ph, w_px // pw)
        if attn_cfg is None:
            attn_cfg = AttentionConfig(latent_shape=grid, sta_tile=grid)
        elif attn_cfg.latent_shape != grid:
            raise ValueError(
                f"attention config latent_shape {attn_cfg.latent_shape} != token grid {grid}")

        # NDHWC VALID conv with stride = patch, as a Conv3d on NCDHW
        x = self.patch_embedding(latents.to(self.dtype).permute(0, 4, 1, 2, 3))
        x = x.flatten(2).transpose(1, 2).contiguous()  # (B, S, dim), raster order

        temb, temb6, ctx, img = self.condition_embedder(timestep, context.to(self.dtype),
                                                        image_context)
        s_local = x.shape[1]
        rope = self._rope(grid, (sp_rank * s_local, s_local))
        n_layers = len(self.blocks) if quantized_blocks is None else quantized_blocks.num_layers
        fetch = (None if frozen_sharded is None
                 else sharded_block_fetcher(self.blocks, n_layers, frozen_sharded))

        def block_at(i: int, prefix: str = "") -> WanBlock:
            if quantized_blocks is None:
                return self.blocks[i]
            return quantized_blocks.load(i, self.blocks[0], prefix)

        scores = None  # (num_layers, B, H, E): every router reads only temb
        if routing_mode != "off":
            scores = torch.stack([block_at(i, "router.").router(temb) for i in range(n_layers)])
        ids, ids_dev, ids_host = [None] * n_layers, None, None
        if routing_mode == "hard":
            ids_dev = torch.stack([route_expert_ids(sc, attn_cfg.tau_sparse) for sc in scores])
        skip, ind, acc_skip = False, None, None
        if step_cache is not None:
            ind = temb6.reshape(b, -1).float()
            skip, acc_skip = stepcache.cache_decision(step_cache, ind, cache_threshold,
                                                      cache_force_compute, cache_coefficients)
            # the skip flag rides the routing ids' copy to the host: the cache adds no sync
            skip, ids_host = stepcache.read_decision(skip, cache_force_compute, ids_dev)
        elif ids_dev is not None:
            ids_host = ids_dev.cpu().numpy()
        if ids_dev is not None and not skip:
            ids = list(zip(ids_dev, ids_host))
        remat = remat_blocks and torch.is_grad_enabled()
        x_in, x_t, reg, hid = x, x, None, None
        if return_losses:
            reg = hid = torch.zeros((), dtype=torch.float32, device=x.device)
        scales = qmm.layer_scale_table(act_scales, x.device)
        calib = []
        for i in range(0 if skip else n_layers):
            block = block_at(i)
            # block i's frozen parameters broadcast from their owner, or the block
            run = block if fetch is None else fetch(i)
            args = (x, ctx, temb6, rope, attn_cfg, scores[i] if scores is not None else None,
                    routing_mode, ids[i], img, sp_group)
            if remat:
                # the recompute in the backward fetches the sharded block again
                once = [run]

                def student(*a, once=once, i=i):
                    return (once.pop() if once else self.blocks[i] if fetch is None
                            else fetch(i))(*a)

                with torch.utils.checkpoint.set_checkpoint_early_stop(False):
                    x = torch.utils.checkpoint.checkpoint(student, *args, use_reentrant=False,
                                                          preserve_rng_state=False)
            else:
                with qmm.layer_act_scales(scales(i)), qmm.calibration(calibrate_mm) as sink:
                    x = run(*args)
                calib.append(sink)
            if return_losses:
                with torch.no_grad():  # the frozen teacher: routing off
                    x_t = run(x_t, ctx, temb6, rope, attn_cfg, image_context=img,
                              sp_group=sp_group)
                # L2 on the full-attention routing weight, and the per-block
                # distance between the streams
                reg = reg + scores[i][:, :, 0].square().mean()
                hid = hid + (x_t.float() - x.float()).square().mean()
        new_cache = None
        if step_cache is not None:
            if skip:  # the cached block delta; no block ran, so no routing
                x = x_in + step_cache.residual.to(x_in.dtype)
                new_cache = stepcache.skipped(step_cache, ind, acc_skip)
                # no router ran a block: zero scores, as in the JAX package
                scores = None if scores is None else torch.zeros_like(scores)
                ids_host = None
            else:
                new_cache = stepcache.computed(ind, x_in, x)

        out = self._head(x, temb)
        last = None
        if return_losses:
            with torch.no_grad():
                out_t = self._head(x_t, temb)
            last = (out_t.float() - out.float()).square().mean()
        if return_scores and scores is None:
            scores = torch.zeros((n_layers, b, cfg.num_heads, attn_cfg.num_experts),
                                 device=x.device)
        return WanOutput(sample=self._unpatchify(out, b, (grid[0] // sp,) + grid[1:]),
                         routing_scores=scores if return_scores else None, expert_ids=ids_host,
                         reg_loss=reg, last_layer_distill_loss=last,
                         hidden_layer_distill_loss=hid,
                         mm_calibration=qmm.stack_calibration(calib) if calibrate_mm else None,
                         step_cache=new_cache,
                         hidden_delta=(x - x_in) if return_hidden_delta else None,
                         temb_indicator=(temb6.reshape(b, -1).float()
                                         if return_hidden_delta else None),
                         cache_skipped=skip if step_cache is not None else None)

    def _head(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        mod = self.scale_shift_table + temb.float()[:, None, :]
        return self.proj_out(self.norm_out.modulated(x, mod[:, 1], mod[:, 0]))

    def _unpatchify(self, out: torch.Tensor, b: int, grid: Tuple[int, int, int]) -> torch.Tensor:
        t, h, w = grid
        pt, ph, pw = self.cfg.patch_size
        c = self.cfg.out_channels
        out = out.reshape(b, t, h, w, pt, ph, pw, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
        return out.reshape(b, t * pt, h * ph, w * pw, c)
