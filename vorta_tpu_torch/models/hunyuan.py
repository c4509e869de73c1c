"""HunyuanVideo MMDiT in PyTorch (counterpart of vorta_tpu/models/hunyuan.py),
serving and router-distillation training.

20 dual-stream blocks (separate video and text streams, joint attention)
then 40 single-stream blocks (the concatenated sequence, attention and MLP
in parallel from one norm), the llama text states refined by a
timestep-conditioned token refiner, the CLIP pooled and guidance embeddings
added to the timestep conditioning, per-head RMS qk-norm, and (16, 56, 56)
axis-split RoPE at theta 256 on the video tokens only.  Channels-last
latents (B, T, H, W, C) in, the same layout out.  The blocks are
``nn.ModuleList``s walked by a Python loop (the JAX model stacks and scans
them).

Attention runs through ops/joint_experts.py: full attention over
[video | text] (``routing_mode="off"``), each head routed to its expert
(``"hard"``, the serving path) or the experts' plain versions weighted by
the router scores (``"soft"``).  Every block's router reads only the
timestep embedding, so all 60 blocks' routing is made at the start of the
forward and brought to the host once.  The text padding mask rides the
kernels as an additive kv bias.

Concatenated projections: the dual block's video q / k / v (``attn.qkv``)
and text q / k / v (``attn.add_qkv``) are one product each; the single
block's q / k / v and MLP input one product (``qkv_mlp``).  The qk prologue
(per-head RMSNorm + half-RoPE + head split) runs as one kernel with
``norm_scope="head"``; in the single block over the whole joint stream,
with the identity rotation on the text rows.

Quantized serving, as in models/wan.py: ``mm_precision="int8"`` runs the
projections the JAX model runs in W8A8 (the dual block's video q / k / v /
out and its FFN, the text stream's FFN and the token refiner's FFN, both
unnamed so with dynamic scales, the single block's q / k / v + MLP input
and its output; the text q / k / v / out projections, the modulations and
the embedders stay in the model's dtype), ``act_scales`` the static scales
("dual." / "single." sites, one table across both stacks),
``calibrate_mm`` the per-layer max |x|, and ``quantized_blocks`` a pair of
``BlockStack`` (dual, single) served through a depth-(1, 1) model.

Step cache (ops/stepcache.py), as in models/wan.py: the indicator is
temb, only the video stream's block delta is cached (the text stream is
dropped after the stacks, as in JAX), and a skipped forward runs no block.

Token-replace image to video (``image_condition_type="token_replace"``):
the first latent frame's video rows, ``(h / ph) * (w / pw)`` of them,
take their AdaLN shift, scale and gates from ``tr_emb`` (the timestep
embedder at t = 0 plus the pooled text, no guidance), the other rows and
the text from temb.  The norm kernel runs over the two row ranges, each
with its own modulation, into one output (the norm is per row, so this
equals JAX's select between two full passes).

Training (``return_losses``, soft routing): the frozen teacher stream,
its own video and text streams, runs each block in ``"off_ref"`` (full
attention through the plain version) under ``torch.no_grad``, interleaved
with the student block by block as the JAX scan body does; ``reg_loss`` =
sum over blocks of mean(score_full^2), ``hidden_layer_distill_loss`` = sum
over blocks of the MSE between the two video streams,
``last_layer_distill_loss`` = the MSE of the two through the output head.
``remat_blocks`` recomputes each student block in the backward
(``torch.utils.checkpoint``, non-reentrant, early stop off).

Sequence parallelism (``sp_group``, a ``torch.distributed`` group):
``latents`` hold this rank's contiguous latent-frame chunk and
``attn_cfg.latent_shape`` is the global grid; the text conditioning is
replicated.  In each attention the video q / k / v go head-sharded over the
whole sequence (parallel/ulysses.py), the replicated text q / k / v, the
router scores and the hard routing slice to the rank's heads, and after it
the video comes back to the rank's rows and the text output is gathered
over the heads (JAX's ``_sp_joint_in`` / ``_sp_joint_out``); RoPE and token
replace's first-frame rows are the rank's rows of the global ones.  The
output is the rank's frame chunk.  ``frozen_sharded`` (a group) runs the
blocks from layer-sharded frozen parameters (parallel/fsdp.py: each block
broadcast from its owner for its turn, the routers replicated).
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

from ..config import AttentionConfig
from ..device import resolve_device
from ..ops.attention_ref import attention_dense
from ..ops.joint_experts import MODES, JointConfig, routed_joint_attention
from ..ops.prologue import fused_qk_prologue, use_fused_prologue
from ..ops import qmm, stepcache
from ..ops.qmm import FusedLinear, QLinear
from ..ops.rope import apply_rope_half
from ..ops.routed_fused import route_expert_ids
from ..parallel.fsdp import sharded_block_fetcher
from ..parallel.ulysses import (
    all_to_all_heads_to_seq,
    all_to_all_seq_to_heads,
    gather_sequence,
    local_expert_ids,
    slice_local,
)
from .common import (
    FP32LayerNorm,
    GELUFeedForward,
    TimestepEmbedding,
    init_flax_defaults,
    sinusoidal_timestep_embedding,
)
from .router import Router

Shape3 = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class HunyuanModelConfig:
    dim: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    dual_layers: int = 20
    single_layers: int = 40
    mlp_ratio: float = 4.0
    in_channels: int = 16
    out_channels: int = 16
    patch_size: Shape3 = (1, 2, 2)
    text_dim: int = 4096
    text_len: int = 256
    pooled_dim: int = 768
    rope_axes: Shape3 = (16, 56, 56)
    rope_theta: float = 256.0
    guidance_embeds: bool = True
    refiner_layers: int = 2
    freq_dim: int = 256
    eps: float = 1e-6
    # I2V token-replace variant: the first frame's tokens carry the clean
    # image and take t = 0 AdaLN conditioning
    image_condition_type: Optional[str] = None  # None | "token_replace"

    def __post_init__(self):
        if self.dim != self.num_heads * self.head_dim:
            raise ValueError("dim != num_heads * head_dim")
        if sum(self.rope_axes) != self.head_dim:
            raise ValueError("rope axes must sum to head_dim")

    @property
    def mlp_dim(self) -> int:
        return int(self.dim * self.mlp_ratio)


HUNYUAN_13B = HunyuanModelConfig()
HUNYUAN_TINY = HunyuanModelConfig(
    dim=128, num_heads=2, head_dim=64, dual_layers=2, single_layers=2,
    text_dim=48, text_len=24, pooled_dim=32, rope_axes=(16, 24, 24),
    freq_dim=32, refiner_layers=1,
)


@dataclasses.dataclass
class HunyuanOutput:
    sample: torch.Tensor  # (B, T, H, W, C) latent-space prediction
    # training losses (return_losses), f32 scalars
    reg_loss: Optional[torch.Tensor] = None
    last_layer_distill_loss: Optional[torch.Tensor] = None
    hidden_layer_distill_loss: Optional[torch.Tensor] = None
    # (dual + single layers, B, H, E) router scores with return_scores
    # (zeros when routing is off, as in the JAX model)
    routing_scores: Optional[torch.Tensor] = None
    # (dual + single layers, H) expert ids of a hard-routed forward, on the host
    expert_ids: Optional[np.ndarray] = None
    # {site: (layers of its stack,) f32 max |x|} with calibrate_mm
    mm_calibration: Optional[dict] = None
    step_cache: Optional[object] = None  # ops.stepcache.StepCache (serving)
    # with step_cache: whether this forward skipped the block stacks (host bool)
    cache_skipped: Optional[bool] = None


def hunyuan_rope_tables(grid: Shape3, cfg: HunyuanModelConfig):
    """Axis-split angles ((S, head_dim // 2) cos and sin, f32): ``rope_axes``
    give the real dims of each axis, half of them complex frequencies."""
    t, h, w = grid
    counts = [d // 2 for d in cfg.rope_axes]
    parts = []
    for ax, (n, c) in enumerate(zip(grid, counts)):
        inv = cfg.rope_theta ** (-np.arange(c, dtype=np.float64) / c)
        ang = np.outer(np.arange(n, dtype=np.float64), inv)
        shape = [1, 1, 1, c]
        shape[ax] = n
        parts.append(np.broadcast_to(ang.reshape(shape), (t, h, w, c)))
    angles = np.concatenate(parts, axis=-1).reshape(t * h * w, sum(counts))
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _gated(x: torch.Tensor, y: torch.Tensor, gate: torch.Tensor,
           tr_gate: Optional[torch.Tensor] = None, n: int = 0) -> torch.Tensor:
    """x + y * gate[:, None], added in f32 and cast back to x's dtype; with
    ``tr_gate`` the first ``n`` rows take it instead (token replace)."""
    out = (x.float() + y.float() * gate[:, None]).to(x.dtype)
    if tr_gate is not None:
        out[:, :n] = (x[:, :n].float() + y[:, :n].float() * tr_gate[:, None]).to(x.dtype)
    return out


def _modulated(norm, x: torch.Tensor, scale, shift, tr_scale=None, tr_shift=None,
               n: int = 0) -> torch.Tensor:
    """AdaLN ``norm`` of x (B, S, dim); with ``tr_scale`` / ``tr_shift`` the
    first ``n`` rows take that modulation: the norm kernel runs over the two
    row ranges, each with its own, into one output."""
    if tr_scale is None:
        return norm.modulated(x, scale, shift)
    out = torch.empty_like(x)
    norm.modulated(x[:, :n], tr_scale, tr_shift, out=out[:, :n])
    if n < x.shape[1]:
        norm.modulated(x[:, n:], scale, shift, out=out[:, n:])
    return out


class PerHeadRMSNorm(nn.Module):
    """RMSNorm over the head dim of (B, H, S, D), computed in f32."""

    def __init__(self, head_dim: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(head_dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        rms = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * rms * self.weight).to(x.dtype)


class AdaLNModulation(nn.Module):
    """SiLU -> Linear(dim, n * dim), split into n f32 (B, dim) chunks."""

    def __init__(self, dim: int, n: int, *, dtype, device):
        super().__init__()
        self.n = n
        self.linear = nn.Linear(dim, n * dim, dtype=dtype, device=device)

    def forward(self, temb: torch.Tensor):
        return self.linear(F.silu(temb)).float().chunk(self.n, dim=-1)


def _row_gains(attn, h: int):
    """The fused prologue's (dim,) f32 gains: each head's ``norm_q`` /
    ``norm_k`` gain repeated over the h heads.  Made once per module and
    kept while the weights stay (their version counters count in-place
    updates: optimizer steps, ``load_state_dict``), so a served forward
    copies no gain; made anew each call where the weights would take a
    gradient or are inference tensors (made under inference mode, they
    keep no version counter), and outside inference mode from a copy made
    inside it."""
    wq, wk = attn.norm_q.weight, attn.norm_k.weight
    if ((torch.is_grad_enabled() and (wq.requires_grad or wk.requires_grad))
            or wq.is_inference() or wk.is_inference()):
        return wq.repeat(h), wk.repeat(h)
    key = (wq._version, wk._version, wq.data_ptr(), wk.data_ptr(), h,
           torch.is_inference_mode_enabled())
    kept = getattr(attn, "_row_gains", None)
    if kept is None or kept[0] != key:
        with torch.no_grad():
            kept = (key, wq.float().repeat(h), wk.float().repeat(h))
        attn._row_gains = kept
    return kept[1], kept[2]


def _sp_joint_in(qv, kv_, vv, qt, kt, vt, scores, group):
    """Ulysses reshard for joint attention: the video q / k / v go from
    sequence-sharded to head-sharded (the full sequence on every rank), the
    replicated text q / k / v and routing scores slice to the rank's heads
    (reference choreography: vorta/attention/hunyuan.py:153-187)."""
    qv, kv_, vv = (all_to_all_heads_to_seq(a, group) for a in (qv, kv_, vv))
    qt, kt, vt = (slice_local(a, 1, group) for a in (qt, kt, vt))
    if scores is not None:
        scores = slice_local(scores, 1, group)
    return qv, kv_, vv, qt, kt, vt, scores


def _sp_joint_out(video, text, group):
    """The inverse reshard: the video back to all heads of the rank's rows,
    the text output gathered over the head axis so every rank holds the
    whole text stream (reference: vorta/attention/hunyuan.py:186-187)."""
    return all_to_all_seq_to_heads(video, group), gather_sequence(text, 1, group)


def _joint(qv, kv_, vv, qt, kt, vt, scores, text_mask, jcfg, routing_mode, expert_ids,
           sp_group):
    """routed_joint_attention over (B, H, S, D) q / k / v, through the
    Ulysses reshard under sequence parallelism."""
    if sp_group is not None:
        qv, kv_, vv, qt, kt, vt, scores = _sp_joint_in(qv, kv_, vv, qt, kt, vt, scores, sp_group)
        expert_ids = local_expert_ids(expert_ids, sp_group)
    video, text = routed_joint_attention(qv, kv_, vv, qt, kt, vt, scores, text_mask, jcfg,
                                         mode=routing_mode, expert_ids=expert_ids)
    if sp_group is not None:
        video, text = _sp_joint_out(video, text, sp_group)
    return video, text


def _qk_prologue(attn, qp, kp, vp, cos, sin, routing_mode: str):
    """Per-head qk RMSNorm + half-RoPE + head split of (B, S, dim) q / k / v:
    the fused kernel where the gate takes it, else the same ops unfused."""
    h = attn.num_heads
    if use_fused_prologue(routing_mode, qp.shape[1], qp.shape[2], h):
        return fused_qk_prologue(qp, kp, vp, *_row_gains(attn, h), cos, sin, num_heads=h,
                                 eps=attn.norm_q.eps, norm_scope="head")
    q = apply_rope_half(attn.norm_q(_split_heads(qp, h)), cos, sin)
    k = apply_rope_half(attn.norm_k(_split_heads(kp, h)), cos, sin)
    return q, k, _split_heads(vp, h)


class HunyuanJointAttention(nn.Module):
    """Dual-stream joint attention (separate text projections)."""

    def __init__(self, cfg: HunyuanModelConfig, *, dtype, device):
        super().__init__()
        dim = cfg.dim
        kw = dict(dtype=dtype, device=device)
        self.num_heads = cfg.num_heads
        # to_q | to_k | to_v obey the int8 switch; the text's add_{q,k,v}_proj stay
        self.qkv = FusedLinear(dim, (dim, dim, dim),
                               sites=("dual.attn.to_q", "dual.attn.to_k", "dual.attn.to_v"), **kw)
        self.add_qkv = FusedLinear(dim, (dim, dim, dim), **kw)
        self.norm_q = PerHeadRMSNorm(cfg.head_dim, cfg.eps, device=device)
        self.norm_k = PerHeadRMSNorm(cfg.head_dim, cfg.eps, device=device)
        self.norm_added_q = PerHeadRMSNorm(cfg.head_dim, cfg.eps, device=device)
        self.norm_added_k = PerHeadRMSNorm(cfg.head_dim, cfg.eps, device=device)
        self.to_out = QLinear(dim, dim, site="dual.attn.to_out", **kw)
        self.to_add_out = nn.Linear(dim, dim, **kw)

    def forward(self, x, ctx, rope, text_mask, jcfg, scores, routing_mode, expert_ids,
                sp_group=None):
        h = self.num_heads
        qv, kv_, vv = _qk_prologue(self, *self.qkv(x), *rope, routing_mode)
        qt, kt, vt = self.add_qkv(ctx)
        qt = self.norm_added_q(_split_heads(qt, h))
        kt = self.norm_added_k(_split_heads(kt, h))
        video, text = _joint(qv, kv_, vv, qt, kt, _split_heads(vt, h), scores, text_mask, jcfg,
                             routing_mode, expert_ids, sp_group)
        return self.to_out(_merge_heads(video)), self.to_add_out(_merge_heads(text))


class HunyuanSingleAttention(nn.Module):
    """Single-stream attention over [video | text]: its q / k / v come from
    the block's fused projection; it holds the qk norms."""

    def __init__(self, cfg: HunyuanModelConfig, *, device):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.norm_q = PerHeadRMSNorm(cfg.head_dim, cfg.eps, device=device)
        self.norm_k = PerHeadRMSNorm(cfg.head_dim, cfg.eps, device=device)

    def forward(self, qkv, video_len, rope_joint, text_mask, jcfg, scores, routing_mode,
                expert_ids, sp_group=None):
        # the RoPE tables cover the joint rows, the identity on the text
        q, k, v = _qk_prologue(self, *qkv, *rope_joint, routing_mode)
        video, text = _joint(
            q[:, :, :video_len], k[:, :, :video_len], v[:, :, :video_len],
            q[:, :, video_len:], k[:, :, video_len:], v[:, :, video_len:], scores, text_mask,
            jcfg, routing_mode, expert_ids, sp_group)
        return _merge_heads(torch.cat([video, text], dim=2))


class HunyuanDualBlock(nn.Module):
    def __init__(self, cfg: HunyuanModelConfig, *, dtype, device):
        super().__init__()
        dim = cfg.dim
        kw = dict(dtype=dtype, device=device)
        self.norm1_mod = AdaLNModulation(dim, 6, **kw)
        self.norm1 = FP32LayerNorm(dim, cfg.eps, affine=False, device=device)
        self.norm1_context_mod = AdaLNModulation(dim, 6, **kw)
        self.norm1_context = FP32LayerNorm(dim, cfg.eps, affine=False, device=device)
        self.attn = HunyuanJointAttention(cfg, **kw)
        self.norm2 = FP32LayerNorm(dim, cfg.eps, affine=False, device=device)
        self.norm2_context = FP32LayerNorm(dim, cfg.eps, affine=False, device=device)
        self.ff = GELUFeedForward(dim, cfg.mlp_dim, site_prefix="dual.ff", **kw)
        self.ff_context = GELUFeedForward(dim, cfg.mlp_dim, **kw)  # unnamed: dynamic scales
        self.router = Router(dim, cfg.num_heads, device=device)

    def forward(self, x, ctx, temb, rope, rope_joint, text_mask, jcfg, scores=None,
                routing_mode="off", expert_ids=None, tr=None, sp_group=None):
        """``tr``: (tr_emb, n) of token replace, the first n video rows
        conditioned by tr_emb (the same modulation projection), or None;
        ``sp_group``: the sequence-parallel group (x holds the rank's rows)."""
        sh, sc, gate, sh_mlp, sc_mlp, gate_mlp = self.norm1_mod(temb)
        csh, csc, cgate, csh_mlp, csc_mlp, cgate_mlp = self.norm1_context_mod(temb)
        t_sh = t_sc = t_gate = t_sh_mlp = t_sc_mlp = t_gate_mlp = None
        n = 0
        if tr is not None:
            t_sh, t_sc, t_gate, t_sh_mlp, t_sc_mlp, t_gate_mlp = self.norm1_mod(tr[0])
            n = tr[1]
        attn_x, attn_c = self.attn(_modulated(self.norm1, x, sc, sh, t_sc, t_sh, n),
                                   self.norm1_context.modulated(ctx, csc, csh), rope, text_mask,
                                   jcfg, scores, routing_mode, expert_ids, sp_group)
        x, ctx = _gated(x, attn_x, gate, t_gate, n), _gated(ctx, attn_c, cgate)
        x = _gated(x, self.ff(_modulated(self.norm2, x, sc_mlp, sh_mlp, t_sc_mlp, t_sh_mlp, n)),
                   gate_mlp, t_gate_mlp, n)
        ctx = _gated(ctx, self.ff_context(self.norm2_context.modulated(ctx, csc_mlp, csh_mlp)),
                     cgate_mlp)
        return x, ctx


class HunyuanSingleBlock(nn.Module):
    def __init__(self, cfg: HunyuanModelConfig, *, dtype, device):
        super().__init__()
        dim = cfg.dim
        kw = dict(dtype=dtype, device=device)
        self.norm_mod = AdaLNModulation(dim, 3, **kw)
        self.norm = FP32LayerNorm(dim, cfg.eps, affine=False, device=device)
        self.attn = HunyuanSingleAttention(cfg, device=device)
        # attn.to_q | attn.to_k | attn.to_v | proj_mlp of the JAX block: the
        # parallel attention and MLP read the same modulated norm
        self.qkv_mlp = FusedLinear(dim, (dim, dim, dim, cfg.mlp_dim),
                                   sites=("single.attn.to_q", "single.attn.to_k",
                                          "single.attn.to_v", "single.proj_mlp"), **kw)
        self.proj_out = QLinear(dim + cfg.mlp_dim, dim, site="single.proj_out", **kw)
        self.router = Router(dim, cfg.num_heads, device=device)

    def forward(self, x, ctx, temb, rope, rope_joint, text_mask, jcfg, scores=None,
                routing_mode="off", expert_ids=None, tr=None, sp_group=None):
        """``tr`` and ``sp_group``: as the dual block's; text rows never take
        tr_emb."""
        video_len = x.shape[1]
        joint = torch.cat([x, ctx], dim=1)
        sh, sc, gate = self.norm_mod(temb)
        t_sh = t_sc = t_gate = None
        n = 0
        if tr is not None:
            (t_sh, t_sc, t_gate), n = self.norm_mod(tr[0]), tr[1]
        qp, kp, vp, mlp_in = self.qkv_mlp(_modulated(self.norm, joint, sc, sh, t_sc, t_sh, n))
        mlp = F.gelu(mlp_in, approximate="tanh")
        del mlp_in
        attn = self.attn((qp, kp, vp), video_len, rope_joint, text_mask, jcfg, scores,
                         routing_mode, expert_ids, sp_group)
        del qp, kp, vp
        joint = _gated(joint, self.proj_out(torch.cat([attn, mlp], dim=2)), gate, t_gate, n)
        return joint[:, :video_len], joint[:, video_len:]


class TokenRefinerBlock(nn.Module):
    def __init__(self, cfg: HunyuanModelConfig, *, dtype, device):
        super().__init__()
        dim = cfg.dim
        kw = dict(dtype=dtype, device=device)
        self.num_heads = cfg.num_heads
        self.norm1 = FP32LayerNorm(dim, cfg.eps, affine=True, device=device)
        self.to_q = nn.Linear(dim, dim, **kw)
        self.to_k = nn.Linear(dim, dim, **kw)
        self.to_v = nn.Linear(dim, dim, **kw)
        self.to_out = nn.Linear(dim, dim, **kw)
        self.norm2 = FP32LayerNorm(dim, cfg.eps, affine=True, device=device)
        self.ff = GELUFeedForward(dim, cfg.mlp_dim, **kw)
        self.gates = AdaLNModulation(dim, 2, **kw)

    def forward(self, x, c, mask):
        gate_attn, gate_mlp = self.gates(c)
        norm_x = self.norm1(x)
        h = self.num_heads
        # plain masked attention over the (256) text tokens, as the JAX
        # package runs it outside its kernels
        attn = attention_dense(_split_heads(self.to_q(norm_x), h),
                               _split_heads(self.to_k(norm_x), h),
                               _split_heads(self.to_v(norm_x), h), mask=mask[:, None, None, :])
        x = _gated(x, self.to_out(_merge_heads(attn)), gate_attn)
        return _gated(x, self.ff(self.norm2(x)), gate_mlp)


class TokenRefiner(nn.Module):
    """Timestep-conditioned refinement of the llama text states
    (diffusers HunyuanVideoTokenRefiner)."""

    def __init__(self, cfg: HunyuanModelConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.freq_dim = cfg.freq_dim
        self.proj_in = nn.Linear(cfg.text_dim, cfg.dim, **kw)
        self.time_embedder = TimestepEmbedding(cfg.freq_dim, cfg.dim, **kw)
        self.text_pool_embedder = nn.Linear(cfg.text_dim, cfg.dim, **kw)
        self.text_pool_out = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.blocks = nn.ModuleList(TokenRefinerBlock(cfg, **kw)
                                    for _ in range(cfg.refiner_layers))

    def forward(self, text_states, timestep, mask):
        dtype = self.proj_in.weight.dtype
        t_emb = self.time_embedder(
            sinusoidal_timestep_embedding(timestep, self.freq_dim).to(dtype))
        m = mask.float()[:, :, None]
        pooled = (text_states.float() * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
        c = t_emb + self.text_pool_out(F.silu(self.text_pool_embedder(pooled.to(dtype))))
        x = self.proj_in(text_states)
        for block in self.blocks:
            x = block(x, c, mask)
        return x


class HunyuanCombinedEmbed(nn.Module):
    """Timestep + guidance + pooled-CLIP conditioning; also returns the bare
    timestep embedding, which the routers read."""

    def __init__(self, cfg: HunyuanModelConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.freq_dim = cfg.freq_dim
        self.timestep_embedder = TimestepEmbedding(cfg.freq_dim, cfg.dim, **kw)
        self.guidance_embedder = (TimestepEmbedding(cfg.freq_dim, cfg.dim, **kw)
                                  if cfg.guidance_embeds else None)
        self.text_embedder_1 = nn.Linear(cfg.pooled_dim, cfg.dim, **kw)
        self.text_embedder_2 = nn.Linear(cfg.dim, cfg.dim, **kw)

    def forward(self, timestep, pooled_text, guidance=None, token_replace: bool = False):
        """(temb, the bare timestep embedding, tr_emb or None): with
        ``token_replace``, tr_emb is the timestep embedding at t = 0 plus
        the pooled text, with no guidance."""
        dtype = self.text_embedder_1.weight.dtype

        def sinusoid(t):
            return sinusoidal_timestep_embedding(t, self.freq_dim).to(dtype)

        t_emb = self.timestep_embedder(sinusoid(timestep))
        pooled = self.text_embedder_2(F.silu(self.text_embedder_1(pooled_text)))
        temb = t_emb + pooled
        tr_emb = None
        if token_replace:
            tr_emb = self.timestep_embedder(sinusoid(torch.zeros_like(timestep))) + pooled
        if self.guidance_embedder is not None and guidance is not None:
            temb = temb + self.guidance_embedder(sinusoid(guidance))
        return temb, t_emb, tr_emb


class HunyuanModel(nn.Module):
    """HunyuanVideoTransformer3DModel, channels-last.

    ``device`` defaults to CUDA and raises without it.  Weights are random,
    drawn on ``device`` from ``seed`` with Flax's default initialisers (the
    13B is built in bf16 on the card: in f32 on the host it would take about
    50 GB); ``io/from_jax.py`` carries a JAX model's across.
    """

    def __init__(self, cfg: HunyuanModelConfig, *, dtype=torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        if cfg.image_condition_type not in (None, "token_replace"):
            raise ValueError(f"unknown image_condition_type {cfg.image_condition_type!r}")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.x_embedder = nn.Conv3d(cfg.in_channels, cfg.dim, kernel_size=cfg.patch_size,
                                    stride=cfg.patch_size, **kw)
        self.context_embedder = TokenRefiner(cfg, **kw)
        self.time_text_embed = HunyuanCombinedEmbed(cfg, **kw)
        self.dual_blocks = nn.ModuleList(HunyuanDualBlock(cfg, **kw)
                                         for _ in range(cfg.dual_layers))
        self.single_blocks = nn.ModuleList(HunyuanSingleBlock(cfg, **kw)
                                           for _ in range(cfg.single_layers))
        self.norm_out = FP32LayerNorm(cfg.dim, cfg.eps, affine=False, device=device)
        self.norm_out_mod = AdaLNModulation(cfg.dim, 2, **kw)
        self.proj_out = nn.Linear(cfg.dim, cfg.out_channels * int(np.prod(cfg.patch_size)),
                                  **kw)
        self._rope_cache: dict = {}
        if device.type != "meta":
            with torch.no_grad():
                init_flax_defaults(self, torch.Generator(device=device).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.proj_out.weight.device

    @property
    def blocks(self) -> list:
        """The dual blocks then the single blocks, in the order they run."""
        return list(self.dual_blocks) + list(self.single_blocks)

    def _rope(self, grid: Shape3, rows: Tuple[int, int]):
        """(cos, sin) of the video rows ``rows`` = (start, count) of the global
        grid (the rank's under sequence parallelism), and of those rows then
        the text rows with the identity rotation, on the model's device."""
        key = (grid, rows)
        if key not in self._rope_cache:
            cos, sin = (a[rows[0]:rows[0] + rows[1]] for a in hunyuan_rope_tables(grid, self.cfg))
            lt = self.cfg.text_len
            cos_j = np.concatenate([cos, np.ones((lt, cos.shape[1]), np.float32)])
            sin_j = np.concatenate([sin, np.zeros((lt, sin.shape[1]), np.float32)])
            self._rope_cache[key] = tuple(
                (torch.from_numpy(np.ascontiguousarray(c)).to(self.device),
                 torch.from_numpy(np.ascontiguousarray(s)).to(self.device))
                for c, s in ((cos, sin), (cos_j, sin_j)))
        return self._rope_cache[key]

    def forward(self, *args, mm_precision: str = "bf16", **kwargs) -> HunyuanOutput:
        """See ``_forward``; ``mm_precision="int8"`` runs the projections the
        JAX model runs in W8A8 (ops/qmm.py) for this call."""
        with qmm.mm_precision(mm_precision):
            return self._forward(*args, **kwargs)

    def _forward(self, latents: torch.Tensor, timestep: torch.Tensor, text_states: torch.Tensor,
                 text_mask: torch.Tensor, pooled_text: torch.Tensor,
                 guidance: Optional[torch.Tensor] = None,
                 attn_cfg: Optional[AttentionConfig] = None, routing_mode: str = "off",
                 return_scores: bool = False, return_losses: bool = False,
                 remat_blocks: bool = False, act_scales: Optional[dict] = None,
                 calibrate_mm: bool = False, quantized_blocks=None,
                 sp_group=None, frozen_sharded=None, step_cache=None,
                 cache_threshold: float = 0.0, cache_force_compute=None,
                 cache_coefficients=None) -> HunyuanOutput:
        """latents (B, T, H, W, C_in), timestep (B,), text_states (B, L,
        text_dim), text_mask (B, L) bool, pooled_text (B, pooled_dim),
        guidance (B,) = guidance scale x 1000.  ``act_scales``: {site:
        (layers,)} static int8 activation scales; ``quantized_blocks``: a
        (dual, single) pair of ``BlockStack`` the blocks run from.
        ``step_cache`` and the ``cache_*`` arguments: as models/wan.py's,
        with temb the indicator.  ``return_losses`` / ``remat_blocks``: the
        training forward (soft routing, the teacher in ``"off_ref"``);
        ``sp_group``: the sequence-parallel group, latents the rank's frames
        and ``attn_cfg`` the global grid; ``frozen_sharded``: the group the
        blocks' frozen parameters are layer-sharded over."""
        if routing_mode not in MODES:
            raise ValueError(f"unknown routing mode {routing_mode!r}")
        if return_losses and routing_mode in ("off", "off_ref"):
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
        if text_states.shape[1] != cfg.text_len:
            raise ValueError(f"text_states {tuple(text_states.shape)}: text_len {cfg.text_len}")
        jcfg = JointConfig(video=attn_cfg, text_len=cfg.text_len)
        text_mask = text_mask.bool()

        # NDHWC VALID conv with stride = patch, as a Conv3d on NCDHW
        x = self.x_embedder(latents.to(self.dtype).permute(0, 4, 1, 2, 3))
        x = x.flatten(2).transpose(1, 2).contiguous()  # (B, S, dim), raster order
        s_local = x.shape[1]
        temb, clean_temb, tr_emb = self.time_text_embed(
            timestep, pooled_text.to(self.dtype),
            None if guidance is None else guidance.to(timestep.device),
            token_replace=cfg.image_condition_type == "token_replace")
        # token replace: the first latent frame's rows take tr_emb's modulation
        # (this rank's share of them: ranks hold contiguous rows)
        n_first = min(max((h_px // ph) * (w_px // pw) - sp_rank * s_local, 0), s_local)
        tr = None if tr_emb is None or n_first == 0 else (tr_emb, n_first)
        ctx = self.context_embedder(text_states.to(self.dtype), timestep, text_mask)
        rope, rope_joint = self._rope(grid, (sp_rank * s_local, s_local))

        # (block list, its stack or None, its layers, its static scales, its fetch or None)
        stacks = []
        for name, stack, prefix in zip(("dual_blocks", "single_blocks"),
                                       quantized_blocks or (None, None), ("dual.", "single.")):
            blocks = getattr(self, name)
            n = len(blocks) if stack is None else stack.num_layers
            table = {k: v for k, v in (act_scales or {}).items() if k.startswith(prefix)}
            fetch = (None if frozen_sharded is None
                     else sharded_block_fetcher(blocks, n, frozen_sharded))
            stacks.append((blocks, stack, n, qmm.layer_scale_table(table, x.device), fetch))

        def blocks_in_order(prefix: str = ""):
            """(block, its static scales, its fetch: block i's frozen
            parameters broadcast from their owner, or None)."""
            for blocks, stack, n, scales, fetch in stacks:
                for i in range(n):
                    block = blocks[i] if stack is None else stack.load(i, blocks[0], prefix)
                    yield block, scales(i), (None if fetch is None
                                             else (lambda fetch=fetch, i=i: fetch(i)))

        scores = None  # (layers, B, H, E): every router reads only the timestep embedding
        if routing_mode not in ("off", "off_ref"):
            scores = torch.stack([block.router(clean_temb)
                                  for block, _, _ in blocks_in_order("router.")])
        n_layers = sum(n for _, _, n, _, _ in stacks)
        ids, ids_dev, ids_host = [None] * n_layers, None, None
        if routing_mode == "hard":
            ids_dev = torch.stack([route_expert_ids(sc, attn_cfg.tau_sparse) for sc in scores])
        skip, ind, acc_skip = False, None, None
        if step_cache is not None:
            ind = temb.float()
            skip, acc_skip = stepcache.cache_decision(step_cache, ind, cache_threshold,
                                                      cache_force_compute, cache_coefficients)
            # the skip flag rides the routing ids' copy to the host: the cache adds no sync
            skip, ids_host = stepcache.read_decision(skip, cache_force_compute, ids_dev)
        elif ids_dev is not None:
            ids_host = ids_dev.cpu().numpy()
        if ids_dev is not None and not skip:
            ids = list(zip(ids_dev, ids_host))
        calib = {"dual.": [], "single.": []}
        remat = remat_blocks and torch.is_grad_enabled()
        x_in, x_t, c_t, reg, hid = x, x, ctx, None, None
        if return_losses:
            reg = hid = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (block, scales, fetch) in enumerate(() if skip else blocks_in_order()):
            run = block if fetch is None else fetch()
            args = (x, ctx, temb, rope, rope_joint, text_mask, jcfg,
                    scores[i] if scores is not None else None, routing_mode, ids[i], tr, sp_group)
            if remat:
                # the recompute in the backward fetches the sharded block again
                once = [run]

                def student(*a, once=once, block=block, fetch=fetch):
                    return (once.pop() if once else block if fetch is None else fetch())(*a)

                with torch.utils.checkpoint.set_checkpoint_early_stop(False):
                    x, ctx = torch.utils.checkpoint.checkpoint(
                        student, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                with qmm.layer_act_scales(scales), qmm.calibration(calibrate_mm) as sink:
                    x, ctx = run(*args)
                calib["dual." if isinstance(block, HunyuanDualBlock) else "single."].append(sink)
            if return_losses:
                with torch.no_grad():  # the frozen teacher: full attention, plain version
                    x_t, c_t = run(x_t, c_t, temb, rope, rope_joint, text_mask, jcfg, None,
                                   "off_ref", None, tr, sp_group)
                # L2 on the full-attention routing weight, and the per-block
                # distance between the video streams
                reg = reg + scores[i][:, :, 0].square().mean()
                hid = hid + (x_t.float() - x.float()).square().mean()
            del run
        new_cache = None
        if step_cache is not None:  # only the video stream's delta: the head reads x alone
            if skip:
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
        t, h, w = grid[0] // sp, grid[1], grid[2]  # the rank's frames
        sample = out.reshape(b, t, h, w, pt, ph, pw, cfg.out_channels).permute(
            0, 1, 4, 2, 5, 3, 6, 7).reshape(b, t * pt, h * ph, w * pw, cfg.out_channels)
        mm_calibration = None
        if calibrate_mm:
            mm_calibration = {k: v for layers in calib.values() if layers
                              for k, v in qmm.stack_calibration(layers).items()}
        return HunyuanOutput(sample=sample, reg_loss=reg, last_layer_distill_loss=last,
                             hidden_layer_distill_loss=hid,
                             routing_scores=scores if return_scores else None,
                             expert_ids=ids_host, mm_calibration=mm_calibration,
                             step_cache=new_cache,
                             cache_skipped=skip if step_cache is not None else None)

    def _head(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        sc, sh = self.norm_out_mod(temb)  # AdaLayerNormContinuous: scale first
        return self.proj_out(self.norm_out.modulated(x, sc, sh))
