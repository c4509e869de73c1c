"""Import diffusers / reference PyTorch checkpoints into the port's models
(counterpart of vorta_tpu/io/torch_import.py: its DiT, router, text-encoder
and VAE maps).

The maps produce the port's own state dict from a diffusers
``WanTransformer3DModel`` or ``HunyuanVideoTransformer3DModel`` state dict:

  * torch Linear weights keep their (out, in) layout and the Conv3d patch
    embedding its (out, in, kt, kh, kw) one;
  * the port's fused projections are concatenated as io/from_jax.py fuses
    a JAX model's (Wan's self-attention q / k / v into ``attn1.qkv``;
    Hunyuan's dual-block q / k / v into ``attn.qkv`` and the text's
    add_q / add_k / add_v into ``attn.add_qkv``, the single block's q / k /
    v and MLP input into ``qkv_mlp``);
  * the self- and joint-attention q / k output rows, their biases and the
    qk-norm gains go from the interleaved-pair to the contiguous-half RoPE
    layout (ops/rope.py ``permute_qk_to_half``, which the models' half
    RoPE assumes); cross-attention and the token refiner stay as they are;
  * LayerNorm ``weight`` becomes the port's ``scale``, and diffusers'
    module paths the port's names (``ffn.net.0.proj`` -> ``ffn.proj_in``,
    ``transformer_blocks`` -> ``dual_blocks``, ...).

Reference router checkpoints (the reference's ``router.pt``: every key
holding "router", ``blocks.{i}.router.linear.*`` for Wan,
``transformer_blocks.{i}...`` / ``single_transformer_blocks.{i}...`` for
HunyuanVideo, a ``module.`` prefix stripped) load the same way.  Each
loader returns ``(applied, missing)``: the port parameters set, and the
mapped names the model does not have (an I2V checkpoint's image branch in a
T2V model, say), as the JAX loaders do; a shape that does not match raises.

The text encoders' maps (transformers UMT5 / Llama / CLIP state dicts) and
the VAEs' (diffusers AutoencoderKLWan / AutoencoderKLHunyuanVideo) rename
keys onto the port's modules, keeping nn.Linear's (out, in) layout; the
VAE loaders raise where a mapped key has no parameter, as JAX's do.

``load_state_dict`` reads one ``.safetensors`` or ``.pt`` / ``.bin`` file, or
a directory of diffusers shards, to torch tensors in their stored dtype.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import torch

from ..ops.rope import half_perm
from .from_jax import _fuse_hunyuan, _fuse_wan


def load_state_dict(path) -> Dict[str, torch.Tensor]:
    """{key: tensor} of one weight file, or of every ``*.safetensors`` (else
    ``*.bin``) shard of a directory, on the CPU."""
    path = Path(path)
    if path.is_dir():
        files = sorted(path.glob("*.safetensors")) or sorted(path.glob("*.bin"))
        if not files:
            raise FileNotFoundError(f"no weight files under {path}")
    else:
        files = [path]
    out: Dict[str, torch.Tensor] = {}
    for f in files:
        if f.suffix == ".safetensors":
            from safetensors.torch import load_file

            out.update(load_file(str(f)))
        else:
            sd = torch.load(f, map_location="cpu", weights_only=True)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
            out.update(sd)
    return out


def _linear(sd, prefix: str, name: str) -> dict:
    return {f"{name}.weight": sd[f"{prefix}.weight"], f"{name}.bias": sd[f"{prefix}.bias"]}


def _layernorm(sd, prefix: str, name: str) -> dict:
    return {f"{name}.scale": sd[f"{prefix}.weight"], f"{name}.bias": sd[f"{prefix}.bias"]}


def _stack(blocks, stack: str) -> dict:
    """A list of per-block {name: tensor} -> {f"{stack}.{i}.{name}": tensor}."""
    return {f"{stack}.{i}.{k}": v for i, blk in enumerate(blocks) for k, v in blk.items()}


def _perm_half(d: dict, head_dim: int) -> dict:
    """The interleaved-pair -> contiguous-half RoPE permutation of each
    head's output rows (weights, biases) or gains."""
    idx = torch.from_numpy(half_perm(head_dim))

    def perm(t):
        n = t.shape[0]
        if n % head_dim:
            raise ValueError(f"axis length {n} is not a multiple of head_dim {head_dim}")
        rows = (torch.arange(n // head_dim)[:, None] * head_dim + idx[None, :]).reshape(-1)
        return t.index_select(0, rows)

    return {k: perm(v) for k, v in d.items()}


def wan_state_dict_to_tree(sd: Dict[str, torch.Tensor], num_layers: int,
                           head_dim: int = 128) -> dict:
    """diffusers WanTransformer3DModel state dict -> the port's WanModel
    state dict (absent routers or I2V keys are simply absent)."""
    tree = {"patch_embedding.weight": sd["patch_embedding.weight"],
            "patch_embedding.bias": sd["patch_embedding.bias"]}
    ce = "condition_embedder"
    for name in ("time_embedder.linear_1", "time_embedder.linear_2", "time_proj",
                 "text_embedder.linear_1", "text_embedder.linear_2"):
        tree.update(_linear(sd, f"{ce}.{name}", f"{ce}.{name}"))
    if f"{ce}.image_embedder.norm1.weight" in sd:  # I2V variants
        ie = f"{ce}.image_embedder"
        tree.update(_layernorm(sd, f"{ie}.norm1", f"{ie}.norm1"))
        tree.update(_linear(sd, f"{ie}.ff.net.0.proj", f"{ie}.proj_in"))
        tree.update(_linear(sd, f"{ie}.ff.net.2", f"{ie}.proj_out"))
        tree.update(_layernorm(sd, f"{ie}.norm2", f"{ie}.norm2"))

    def attn(prefix: str, name: str, rope_half: bool) -> dict:
        # self-attention q / k (and their gains) take the half-RoPE rows;
        # cross-attention has no RoPE, q and k only need to agree
        perm = (lambda d: _perm_half(d, head_dim)) if rope_half else (lambda d: d)
        d = {**perm(_linear(sd, f"{prefix}.to_q", f"{name}.to_q")),
             **perm(_linear(sd, f"{prefix}.to_k", f"{name}.to_k")),
             **_linear(sd, f"{prefix}.to_v", f"{name}.to_v"),
             **_linear(sd, f"{prefix}.to_out.0", f"{name}.to_out")}
        if f"{prefix}.norm_q.weight" in sd:
            d.update(perm({f"{name}.norm_q.weight": sd[f"{prefix}.norm_q.weight"]}))
            d.update(perm({f"{name}.norm_k.weight": sd[f"{prefix}.norm_k.weight"]}))
        if not rope_half and f"{prefix}.add_k_proj.weight" in sd:
            d.update(_linear(sd, f"{prefix}.add_k_proj", f"{name}.add_k_proj"))
            d.update(_linear(sd, f"{prefix}.add_v_proj", f"{name}.add_v_proj"))
            d[f"{name}.norm_added_k.weight"] = sd[f"{prefix}.norm_added_k.weight"]
        return d

    blocks = []
    for i in range(num_layers):
        p = f"blocks.{i}"
        blk = {**attn(f"{p}.attn1", "attn1", True), **attn(f"{p}.attn2", "attn2", False),
               **_linear(sd, f"{p}.ffn.net.0.proj", "ffn.proj_in"),
               **_linear(sd, f"{p}.ffn.net.2", "ffn.proj_out"),
               "scale_shift_table": sd[f"{p}.scale_shift_table"]}
        if f"{p}.norm2.weight" in sd:
            blk.update(_layernorm(sd, f"{p}.norm2", "norm2"))
        if f"{p}.router.linear.weight" in sd:
            blk.update(_linear(sd, f"{p}.router.linear", "router.linear"))
        blocks.append(blk)
    tree.update(_stack(blocks, "blocks"))
    tree.update(_linear(sd, "proj_out", "proj_out"))
    tree["scale_shift_table"] = sd["scale_shift_table"]
    _fuse_wan(tree, num_layers)
    return tree


def apply_state(model: torch.nn.Module, state: dict) -> Tuple[list, list]:
    """Copy ``state`` into the model's parameters (cast to their dtype and
    device); ``(applied, missing)``: the names set and the names the model
    does not have.  A shape that does not match raises before anything is
    set."""
    params = model.state_dict()
    missing = sorted(k for k in state if k not in params)
    applied = [k for k in state if k in params]
    for k in applied:
        if tuple(state[k].shape) != tuple(params[k].shape):
            raise ValueError(f"shape mismatch at {k}: model {tuple(params[k].shape)} vs "
                             f"import {tuple(state[k].shape)}")
    with torch.no_grad():
        for k in applied:
            params[k].copy_(state[k])
    return applied, missing


def load_wan_torch_weights(model, path, strict_shapes: bool = True):
    """Import diffusers Wan weights (and router keys if present) into model."""
    cfg = model.cfg
    tree = wan_state_dict_to_tree(load_state_dict(path), len(model.blocks), cfg.head_dim)
    return apply_state(model, tree)


def hunyuan_state_dict_to_tree(sd: Dict[str, torch.Tensor], dual_layers: int,
                               single_layers: int, refiner_layers: int,
                               head_dim: int = 128) -> dict:
    """diffusers HunyuanVideoTransformer3DModel state dict -> the port's
    HunyuanModel state dict.  The joint attention's q / k rows and gains,
    video and text alike (the joint q.k dots need one channel order), take
    the half-RoPE permutation; the token refiner has no RoPE."""
    tree = {"x_embedder.weight": sd["x_embedder.proj.weight"],
            "x_embedder.bias": sd["x_embedder.proj.bias"]}
    tte = "time_text_embed"
    for src, name in (("timestep_embedder.linear_1", "timestep_embedder.linear_1"),
                      ("timestep_embedder.linear_2", "timestep_embedder.linear_2"),
                      ("text_embedder.linear_1", "text_embedder_1"),
                      ("text_embedder.linear_2", "text_embedder_2")):
        tree.update(_linear(sd, f"{tte}.{src}", f"{tte}.{name}"))
    if f"{tte}.guidance_embedder.linear_1.weight" in sd:
        for n in ("linear_1", "linear_2"):
            tree.update(_linear(sd, f"{tte}.guidance_embedder.{n}",
                                f"{tte}.guidance_embedder.{n}"))
    ce = "context_embedder"
    for src, name in (("proj_in", "proj_in"),
                      ("time_text_embed.timestep_embedder.linear_1", "time_embedder.linear_1"),
                      ("time_text_embed.timestep_embedder.linear_2", "time_embedder.linear_2"),
                      ("time_text_embed.text_embedder.linear_1", "text_pool_embedder"),
                      ("time_text_embed.text_embedder.linear_2", "text_pool_out")):
        tree.update(_linear(sd, f"{ce}.{src}", f"{ce}.{name}"))
    for i in range(refiner_layers):
        p, q = f"{ce}.token_refiner.refiner_blocks.{i}", f"{ce}.blocks.{i}"
        tree.update({**_layernorm(sd, f"{p}.norm1", f"{q}.norm1"),
                     **_linear(sd, f"{p}.attn.to_q", f"{q}.to_q"),
                     **_linear(sd, f"{p}.attn.to_k", f"{q}.to_k"),
                     **_linear(sd, f"{p}.attn.to_v", f"{q}.to_v"),
                     **_linear(sd, f"{p}.attn.to_out.0", f"{q}.to_out"),
                     **_layernorm(sd, f"{p}.norm2", f"{q}.norm2"),
                     **_linear(sd, f"{p}.ff.net.0.proj", f"{q}.ff.proj_in"),
                     **_linear(sd, f"{p}.ff.net.2", f"{q}.ff.proj_out"),
                     **_linear(sd, f"{p}.norm_out.linear", f"{q}.gates.linear")})

    def ph(d):
        return _perm_half(d, head_dim)

    def rms(prefix, name):
        return {f"{name}.weight": sd[f"{prefix}.weight"]}

    duals = []
    for i in range(dual_layers):
        p = f"transformer_blocks.{i}"
        blk = {**_linear(sd, f"{p}.norm1.linear", "norm1_mod.linear"),
               **_linear(sd, f"{p}.norm1_context.linear", "norm1_context_mod.linear"),
               **ph(_linear(sd, f"{p}.attn.to_q", "attn.to_q")),
               **ph(_linear(sd, f"{p}.attn.to_k", "attn.to_k")),
               **_linear(sd, f"{p}.attn.to_v", "attn.to_v"),
               **ph(_linear(sd, f"{p}.attn.add_q_proj", "attn.add_q_proj")),
               **ph(_linear(sd, f"{p}.attn.add_k_proj", "attn.add_k_proj")),
               **_linear(sd, f"{p}.attn.add_v_proj", "attn.add_v_proj"),
               **ph(rms(f"{p}.attn.norm_q", "attn.norm_q")),
               **ph(rms(f"{p}.attn.norm_k", "attn.norm_k")),
               **ph(rms(f"{p}.attn.norm_added_q", "attn.norm_added_q")),
               **ph(rms(f"{p}.attn.norm_added_k", "attn.norm_added_k")),
               **_linear(sd, f"{p}.attn.to_out.0", "attn.to_out"),
               **_linear(sd, f"{p}.attn.to_add_out", "attn.to_add_out"),
               **_linear(sd, f"{p}.ff.net.0.proj", "ff.proj_in"),
               **_linear(sd, f"{p}.ff.net.2", "ff.proj_out"),
               **_linear(sd, f"{p}.ff_context.net.0.proj", "ff_context.proj_in"),
               **_linear(sd, f"{p}.ff_context.net.2", "ff_context.proj_out")}
        if f"{p}.router.linear.weight" in sd:
            blk.update(_linear(sd, f"{p}.router.linear", "router.linear"))
        duals.append(blk)
    singles = []
    for i in range(single_layers):
        p = f"single_transformer_blocks.{i}"
        blk = {**_linear(sd, f"{p}.norm.linear", "norm_mod.linear"),
               **ph(_linear(sd, f"{p}.attn.to_q", "attn.to_q")),
               **ph(_linear(sd, f"{p}.attn.to_k", "attn.to_k")),
               **_linear(sd, f"{p}.attn.to_v", "attn.to_v"),
               **ph(rms(f"{p}.attn.norm_q", "attn.norm_q")),
               **ph(rms(f"{p}.attn.norm_k", "attn.norm_k")),
               **_linear(sd, f"{p}.proj_mlp", "proj_mlp"),
               **_linear(sd, f"{p}.proj_out", "proj_out")}
        if f"{p}.router.linear.weight" in sd:
            blk.update(_linear(sd, f"{p}.router.linear", "router.linear"))
        singles.append(blk)
    tree.update(_stack(duals, "dual_blocks"))
    tree.update(_stack(singles, "single_blocks"))
    tree.update(_linear(sd, "norm_out.linear", "norm_out_mod.linear"))
    tree.update(_linear(sd, "proj_out", "proj_out"))
    _fuse_hunyuan(tree, {"dual_blocks": dual_layers, "single_blocks": single_layers})
    return tree


def hunyuan_expected_keys(dual_layers: int, single_layers: int, refiner_layers: int,
                          guidance: bool = True, routers: bool = False) -> set:
    """The exact diffusers HunyuanVideoTransformer3DModel state-dict key set
    the importer consumes (the ``weight_map`` keys of a sharded checkpoint's
    ``diffusion_pytorch_model.safetensors.index.json``), so a real
    checkpoint can be validated key for key before import."""
    keys = set()

    def lin(prefix):
        keys.add(f"{prefix}.weight")
        keys.add(f"{prefix}.bias")

    lin("x_embedder.proj")
    for e in ("timestep_embedder", "text_embedder") + (("guidance_embedder",) if guidance
                                                       else ()):
        lin(f"time_text_embed.{e}.linear_1")
        lin(f"time_text_embed.{e}.linear_2")
    lin("context_embedder.proj_in")
    lin("context_embedder.time_text_embed.timestep_embedder.linear_1")
    lin("context_embedder.time_text_embed.timestep_embedder.linear_2")
    lin("context_embedder.time_text_embed.text_embedder.linear_1")
    lin("context_embedder.time_text_embed.text_embedder.linear_2")
    for i in range(refiner_layers):
        p = f"context_embedder.token_refiner.refiner_blocks.{i}"
        lin(f"{p}.norm1")
        lin(f"{p}.norm2")
        for a in ("to_q", "to_k", "to_v"):
            lin(f"{p}.attn.{a}")
        lin(f"{p}.attn.to_out.0")
        lin(f"{p}.ff.net.0.proj")
        lin(f"{p}.ff.net.2")
        lin(f"{p}.norm_out.linear")
    for i in range(dual_layers):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear")
        lin(f"{p}.norm1_context.linear")
        for a in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                  "to_add_out"):
            lin(f"{p}.attn.{a}")
        lin(f"{p}.attn.to_out.0")
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            keys.add(f"{p}.attn.{n}.weight")
        lin(f"{p}.ff.net.0.proj")
        lin(f"{p}.ff.net.2")
        lin(f"{p}.ff_context.net.0.proj")
        lin(f"{p}.ff_context.net.2")
        if routers:
            lin(f"{p}.router.linear")
    for i in range(single_layers):
        p = f"single_transformer_blocks.{i}"
        lin(f"{p}.norm.linear")
        for a in ("to_q", "to_k", "to_v"):
            lin(f"{p}.attn.{a}")
        keys.add(f"{p}.attn.norm_q.weight")
        keys.add(f"{p}.attn.norm_k.weight")
        lin(f"{p}.proj_mlp")
        lin(f"{p}.proj_out")
        if routers:
            lin(f"{p}.router.linear")
    lin("norm_out.linear")
    lin("proj_out")
    return keys


def wan_expected_shapes(cfg, routers: bool = False) -> dict:
    """{diffusers WanTransformer3DModel key: shape} for the port's
    ``WanModelConfig`` (the I2V keys where it has ``image_dim``): what
    ``wan_state_dict_to_tree`` consumes."""
    d, f = cfg.dim, cfg.ffn_dim
    shapes = {"patch_embedding.weight": (d, cfg.in_channels) + tuple(cfg.patch_size),
              "patch_embedding.bias": (d,), "scale_shift_table": (1, 2, d),
              "proj_out.weight": (cfg.out_channels * _prod(cfg.patch_size), d),
              "proj_out.bias": (cfg.out_channels * _prod(cfg.patch_size),)}

    def lin(prefix, out, inp):
        shapes[f"{prefix}.weight"], shapes[f"{prefix}.bias"] = (out, inp), (out,)

    ce = "condition_embedder"
    lin(f"{ce}.time_embedder.linear_1", d, cfg.freq_dim)
    lin(f"{ce}.time_embedder.linear_2", d, d)
    lin(f"{ce}.time_proj", 6 * d, d)
    lin(f"{ce}.text_embedder.linear_1", d, cfg.text_dim)
    lin(f"{ce}.text_embedder.linear_2", d, d)
    if cfg.image_dim is not None:
        ie, im = f"{ce}.image_embedder", cfg.image_dim
        shapes[f"{ie}.norm1.weight"] = shapes[f"{ie}.norm1.bias"] = (im,)
        shapes[f"{ie}.norm2.weight"] = shapes[f"{ie}.norm2.bias"] = (d,)
        lin(f"{ie}.ff.net.0.proj", im, im)
        lin(f"{ie}.ff.net.2", d, im)
    for i in range(cfg.num_layers):
        p = f"blocks.{i}"
        for a in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v", "to_out.0"):
                lin(f"{p}.{a}.{proj}", d, d)
            if cfg.qk_norm:
                shapes[f"{p}.{a}.norm_q.weight"] = shapes[f"{p}.{a}.norm_k.weight"] = (d,)
        if cfg.image_dim is not None:
            lin(f"{p}.attn2.add_k_proj", d, d)
            lin(f"{p}.attn2.add_v_proj", d, d)
            shapes[f"{p}.attn2.norm_added_k.weight"] = (d,)
        if cfg.cross_attn_norm:
            shapes[f"{p}.norm2.weight"] = shapes[f"{p}.norm2.bias"] = (d,)
        lin(f"{p}.ffn.net.0.proj", f, d)
        lin(f"{p}.ffn.net.2", d, f)
        shapes[f"{p}.scale_shift_table"] = (1, 6, d)
        if routers:
            lin(f"{p}.router.linear", 3 * cfg.num_heads, d)
    return shapes


def hunyuan_expected_shapes(cfg, guidance: bool = True, routers: bool = False) -> dict:
    """{key: shape} of ``hunyuan_expected_keys`` for the port's
    ``HunyuanModelConfig``."""
    d, m, hd = cfg.dim, cfg.mlp_dim, cfg.head_dim
    shapes = {"x_embedder.proj.weight": (d, cfg.in_channels) + tuple(cfg.patch_size),
              "x_embedder.proj.bias": (d,)}

    def lin(prefix, out, inp):
        shapes[f"{prefix}.weight"], shapes[f"{prefix}.bias"] = (out, inp), (out,)

    tte, ce = "time_text_embed", "context_embedder"
    for e in ("timestep_embedder",) + (("guidance_embedder",) if guidance else ()):
        lin(f"{tte}.{e}.linear_1", d, cfg.freq_dim)
        lin(f"{tte}.{e}.linear_2", d, d)
    lin(f"{tte}.text_embedder.linear_1", d, cfg.pooled_dim)
    lin(f"{tte}.text_embedder.linear_2", d, d)
    lin(f"{ce}.proj_in", d, cfg.text_dim)
    lin(f"{ce}.time_text_embed.timestep_embedder.linear_1", d, cfg.freq_dim)
    lin(f"{ce}.time_text_embed.timestep_embedder.linear_2", d, d)
    lin(f"{ce}.time_text_embed.text_embedder.linear_1", d, cfg.text_dim)
    lin(f"{ce}.time_text_embed.text_embedder.linear_2", d, d)
    for i in range(cfg.refiner_layers):
        p = f"{ce}.token_refiner.refiner_blocks.{i}"
        for n in ("norm1", "norm2"):
            shapes[f"{p}.{n}.weight"] = shapes[f"{p}.{n}.bias"] = (d,)
        for a in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(f"{p}.attn.{a}", d, d)
        lin(f"{p}.ff.net.0.proj", m, d)
        lin(f"{p}.ff.net.2", d, m)
        lin(f"{p}.norm_out.linear", 2 * d, d)
    for i in range(cfg.dual_layers):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear", 6 * d, d)
        lin(f"{p}.norm1_context.linear", 6 * d, d)
        for a in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                  "to_add_out", "to_out.0"):
            lin(f"{p}.attn.{a}", d, d)
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            shapes[f"{p}.attn.{n}.weight"] = (hd,)
        for f in ("ff", "ff_context"):
            lin(f"{p}.{f}.net.0.proj", m, d)
            lin(f"{p}.{f}.net.2", d, m)
        if routers:
            lin(f"{p}.router.linear", 3 * cfg.num_heads, d)
    for i in range(cfg.single_layers):
        p = f"single_transformer_blocks.{i}"
        lin(f"{p}.norm.linear", 3 * d, d)
        for a in ("to_q", "to_k", "to_v"):
            lin(f"{p}.attn.{a}", d, d)
        shapes[f"{p}.attn.norm_q.weight"] = shapes[f"{p}.attn.norm_k.weight"] = (hd,)
        lin(f"{p}.proj_mlp", m, d)
        lin(f"{p}.proj_out", d, d + m)
        if routers:
            lin(f"{p}.router.linear", 3 * cfg.num_heads, d)
    lin("norm_out.linear", 2 * d, d)
    lin("proj_out", cfg.out_channels * _prod(cfg.patch_size), d)
    return shapes


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def validate_hunyuan_checkpoint_keys(keys, dual_layers: int, single_layers: int,
                                     refiner_layers: int):
    """(missing, unexpected) sorted lists of a checkpoint's key set against
    what the importer expects; both empty for a conforming checkpoint."""
    keys = set(keys)
    guidance = any("guidance_embedder" in k for k in keys)
    routers = any(".router." in k for k in keys)
    expected = hunyuan_expected_keys(dual_layers, single_layers, refiner_layers,
                                     guidance=guidance, routers=routers)
    return sorted(expected - keys), sorted(keys - expected)


def load_hunyuan_torch_weights(model, path):
    """Import diffusers HunyuanVideo weights into models.hunyuan.HunyuanModel."""
    cfg = model.cfg
    tree = hunyuan_state_dict_to_tree(load_state_dict(path), len(model.dual_blocks),
                                      len(model.single_blocks), cfg.refiner_layers,
                                      cfg.head_dim)
    return apply_state(model, tree)


def _router_sd(path) -> dict:
    sd = {k.split("module.")[-1]: v for k, v in load_state_dict(path).items() if "router" in k}
    if not sd:
        raise ValueError(f"no router keys in {path}")
    return sd


def wan_router_state(path, num_layers: int) -> dict:
    """{f"blocks.{i}.router.linear.{weight,bias}": tensor} from a
    reference-style Wan router file."""
    sd = _router_sd(path)
    return _stack([_linear(sd, f"blocks.{i}.router.linear", "router.linear")
                   for i in range(num_layers)], "blocks")


def hunyuan_router_state(path, dual_layers: int, single_layers: int) -> dict:
    """The port's router state of both stacks from a reference-style
    HunyuanVideo router file (``transformer_blocks.{i}.router.linear.*``,
    ``single_transformer_blocks.{i}.router.linear.*``)."""
    sd = _router_sd(path)
    return {**_stack([_linear(sd, f"transformer_blocks.{i}.router.linear", "router.linear")
                      for i in range(dual_layers)], "dual_blocks"),
            **_stack([_linear(sd, f"single_transformer_blocks.{i}.router.linear",
                              "router.linear") for i in range(single_layers)], "single_blocks")}


def load_router_torch_checkpoint(model, path):
    """Import only the routers from a reference-style Wan router.pt."""
    return apply_state(model, wan_router_state(path, len(model.blocks)))


def load_hunyuan_router_torch_checkpoint(model, path):
    """Import only the routers from a reference-style HunyuanVideo router.pt
    (the reference saves every state-dict key holding "router" of its
    patched model: 20 dual and 40 single blocks)."""
    return apply_state(model, hunyuan_router_state(path, len(model.dual_blocks),
                                                   len(model.single_blocks)))


# --- text encoders (transformers UMT5EncoderModel, LlamaModel, CLIPTextModel) -----------


def _prefixed(sd, prefix: str) -> str:
    """``prefix`` where some key starts with it, else ''."""
    return prefix if any(k.startswith(prefix) for k in sd) else ""


def umt5_state_dict_to_tree(sd: Dict[str, torch.Tensor], num_layers: int) -> dict:
    """transformers UMT5EncoderModel state dict -> the port's UMT5Encoder's
    (T5 linears have no bias; the token table is ``shared.weight`` or the
    encoder's ``embed_tokens.weight``)."""
    pref = _prefixed(sd, "encoder.")
    emb = sd["shared.weight"] if "shared.weight" in sd else sd[f"{pref}embed_tokens.weight"]
    tree = {"embed.weight": emb, "final_norm.weight": sd[f"{pref}final_layer_norm.weight"]}
    for i in range(num_layers):
        p, q = f"{pref}block.{i}", f"blocks.{i}"
        att, ff = f"{p}.layer.0.SelfAttention", f"{p}.layer.1.DenseReluDense"
        tree.update({
            f"{q}.norm1.weight": sd[f"{p}.layer.0.layer_norm.weight"],
            **{f"{q}.attn.{n}.weight": sd[f"{att}.{n}.weight"] for n in "qkvo"},
            f"{q}.attn.rel_bias.weight": sd[f"{att}.relative_attention_bias.weight"],
            f"{q}.norm2.weight": sd[f"{p}.layer.1.layer_norm.weight"],
            **{f"{q}.ffn.{n}.weight": sd[f"{ff}.{n}.weight"] for n in ("wi_0", "wi_1", "wo")},
        })
    return tree


def load_umt5_torch_weights(model, path):
    return apply_state(model, umt5_state_dict_to_tree(load_state_dict(path),
                                                      model.cfg.num_layers))


def llama_state_dict_to_tree(sd: Dict[str, torch.Tensor], num_layers: int) -> dict:
    """transformers LlamaModel state dict -> the port's LlamaTextEncoder's."""
    pref = _prefixed(sd, "model.")
    tree = {"embed_tokens.weight": sd[f"{pref}embed_tokens.weight"],
            "norm.weight": sd[f"{pref}norm.weight"]}
    for i in range(num_layers):
        p, q = f"{pref}layers.{i}", f"layers.{i}"
        tree.update({
            f"{q}.input_layernorm.weight": sd[f"{p}.input_layernorm.weight"],
            **{f"{q}.{n}.weight": sd[f"{p}.self_attn.{n}.weight"]
               for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            f"{q}.post_attention_layernorm.weight": sd[f"{p}.post_attention_layernorm.weight"],
            **{f"{q}.{n}.weight": sd[f"{p}.mlp.{n}.weight"]
               for n in ("gate_proj", "up_proj", "down_proj")},
        })
    return tree


def load_llama_torch_weights(model, path):
    return apply_state(model, llama_state_dict_to_tree(load_state_dict(path),
                                                       model.cfg.num_layers))


def clip_text_state_dict_to_tree(sd: Dict[str, torch.Tensor], num_layers: int) -> dict:
    """transformers CLIPTextModel state dict -> the port's CLIPTextEncoder's."""
    pref = _prefixed(sd, "text_model.")
    tree = {"token_embedding.weight": sd[f"{pref}embeddings.token_embedding.weight"],
            "position_embedding": sd[f"{pref}embeddings.position_embedding.weight"],
            **_layernorm(sd, f"{pref}final_layer_norm", "final_layer_norm")}
    for i in range(num_layers):
        p, q = f"{pref}encoder.layers.{i}", f"blocks.{i}"
        tree.update({**_layernorm(sd, f"{p}.layer_norm1", f"{q}.layer_norm1"),
                     **_layernorm(sd, f"{p}.layer_norm2", f"{q}.layer_norm2"),
                     **_linear(sd, f"{p}.mlp.fc1", f"{q}.fc1"),
                     **_linear(sd, f"{p}.mlp.fc2", f"{q}.fc2")})
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            tree.update(_linear(sd, f"{p}.self_attn.{n}", f"{q}.{n}"))
    return tree


def load_clip_text_torch_weights(model, path):
    return apply_state(model, clip_text_state_dict_to_tree(load_state_dict(path),
                                                           model.cfg.num_layers))


# --- VAEs (diffusers AutoencoderKLWan, AutoencoderKLHunyuanVideo) ------------------------
#
# The key schema is the diffusers module layout as the JAX package documents it
# (its io/torch_import.py): flat up_blocks / down_blocks lists of residual blocks
# interleaved with resample modules for Wan, per-stage resnets / upsamplers for
# HunyuanVideo.  Conv3d weights keep their layout; the diffusers 2-D resample convs
# become 3-D with kt = 1, the 1x1 attention convs Linear weights.


def _conv3d(sd, prefix: str, name: str) -> dict:
    return {f"{name}.weight": sd[f"{prefix}.weight"], f"{name}.bias": sd[f"{prefix}.bias"]}


def _conv2d_as3d(sd, prefix: str, name: str) -> dict:
    """Conv2d (out, in, kh, kw) -> Conv3d (out, in, 1, kh, kw)."""
    return {f"{name}.weight": sd[f"{prefix}.weight"].unsqueeze(2),
            f"{name}.bias": sd[f"{prefix}.bias"]}


def _conv1x1_as_linear(sd, prefix: str, name: str) -> dict:
    """Conv2d 1x1 (out, in, 1, 1) -> Linear (out, in)."""
    return {f"{name}.weight": sd[f"{prefix}.weight"][:, :, 0, 0],
            f"{name}.bias": sd[f"{prefix}.bias"]}


def _wan_vae_resblock(sd, p: str, q: str) -> dict:
    blk = {f"{q}.norm1.gamma": sd[f"{p}.norm1.gamma"].reshape(-1),
           **_conv3d(sd, f"{p}.conv1", f"{q}.conv1.conv"),
           f"{q}.norm2.gamma": sd[f"{p}.norm2.gamma"].reshape(-1),
           **_conv3d(sd, f"{p}.conv2", f"{q}.conv2.conv")}
    if f"{p}.conv_shortcut.weight" in sd:
        blk.update(_conv3d(sd, f"{p}.conv_shortcut", f"{q}.shortcut.conv"))
    return blk


def _wan_vae_mid(sd, p: str, q: str) -> dict:
    att = f"{p}.mid_block.attentions.0"
    return {**_wan_vae_resblock(sd, f"{p}.mid_block.resnets.0", f"{q}.mid_block1"),
            f"{q}.mid_attn.norm.gamma": sd[f"{att}.norm.gamma"].reshape(-1),
            **_conv1x1_as_linear(sd, f"{att}.to_qkv", f"{q}.mid_attn.to_qkv"),
            **_conv1x1_as_linear(sd, f"{att}.proj", f"{q}.mid_attn.proj"),
            **_wan_vae_resblock(sd, f"{p}.mid_block.resnets.1", f"{q}.mid_block2"),
            **_conv3d(sd, f"{p}.conv_in", f"{q}.conv_in.conv"),
            **_conv3d(sd, f"{p}.conv_out", f"{q}.conv_out.conv"),
            f"{q}.norm_out.gamma": sd[f"{p}.norm_out.gamma"].reshape(-1)}


def wan_vae_state_dict_to_tree(sd: Dict[str, torch.Tensor], cfg) -> dict:
    """diffusers AutoencoderKLWan state dict -> the port's WanVAE's."""
    n_res, n_stages = cfg.num_res_blocks, len(cfg.dim_mult)
    tree = {**_wan_vae_mid(sd, "decoder", "decoder"), **_wan_vae_mid(sd, "encoder", "encoder")}
    # decoder: a flat up_blocks list, per stage [res x (n_res + 1)] then an upsampler
    k = 0
    rev_tdown = list(reversed(cfg.temporal_downsample))
    for i in range(n_stages):
        q = f"decoder.stages.{i}"
        for j in range(n_res + 1):
            tree.update(_wan_vae_resblock(sd, f"decoder.up_blocks.{k}", f"{q}.blocks.{j}"))
            k += 1
        t_up = rev_tdown[i] if i < len(rev_tdown) else False
        if t_up:
            tree.update(_conv3d(sd, f"decoder.up_blocks.{k}.time_conv", f"{q}.t_up.conv.conv"))
        if i != n_stages - 1:
            tree.update(_conv2d_as3d(sd, f"decoder.up_blocks.{k}.resample.1", f"{q}.s_up.conv"))
            k += 1
        elif t_up:
            k += 1
    # encoder: a flat down_blocks list, per stage [res x n_res] then a resample
    k = 0
    for i in range(n_stages):
        q = f"encoder.stages.{i}"
        for j in range(n_res):
            tree.update(_wan_vae_resblock(sd, f"encoder.down_blocks.{k}", f"{q}.blocks.{j}"))
            k += 1
        if i != n_stages - 1:
            tree.update(_conv2d_as3d(sd, f"encoder.down_blocks.{k}.resample.1",
                                     f"{q}.s_down.conv"))
            if cfg.temporal_downsample[i] and f"encoder.down_blocks.{k}.time_conv.weight" in sd:
                tree.update(_conv3d(sd, f"encoder.down_blocks.{k}.time_conv",
                                    f"{q}.t_down.conv.conv"))
            k += 1
    return tree


def _check_vae(name: str, applied_missing):
    applied, missing = applied_missing
    if missing:
        raise ValueError(f"{name} import: {len(missing)} keys did not match the model (first "
                         f"few: {missing[:8]}): the checkpoint layout differs from the "
                         "documented diffusers schema")
    return applied, missing


def load_wan_vae_torch_weights(model, path):
    """Import diffusers AutoencoderKLWan weights into models.wan_vae.WanVAE;
    a mapped key the model lacks raises."""
    tree = wan_vae_state_dict_to_tree(load_state_dict(path), model.cfg)
    return _check_vae("WanVAE", apply_state(model, tree))


def _hy_vae_resblock(sd, p: str, q: str) -> dict:
    blk = {**_layernorm(sd, f"{p}.norm1", f"{q}.norm1"),
           **_conv3d(sd, f"{p}.conv1", f"{q}.conv1.conv"),
           **_layernorm(sd, f"{p}.norm2", f"{q}.norm2"),
           **_conv3d(sd, f"{p}.conv2", f"{q}.conv2.conv")}
    if f"{p}.conv_shortcut.weight" in sd:
        blk.update(_conv3d(sd, f"{p}.conv_shortcut", f"{q}.shortcut.conv"))
    return blk


def _hy_vae_mid(sd, p: str, q: str) -> dict:
    att = f"{p}.mid_block.attentions.0"
    return {**_hy_vae_resblock(sd, f"{p}.mid_block.resnets.0", f"{q}.mid_block1"),
            **_layernorm(sd, f"{att}.group_norm", f"{q}.mid_attn.norm"),
            f"{q}.mid_attn.to_qkv.weight": torch.cat(
                [sd[f"{att}.to_{n}.weight"] for n in "qkv"]),
            f"{q}.mid_attn.to_qkv.bias": torch.cat([sd[f"{att}.to_{n}.bias"] for n in "qkv"]),
            **_linear(sd, f"{att}.to_out.0", f"{q}.mid_attn.proj"),
            **_hy_vae_resblock(sd, f"{p}.mid_block.resnets.1", f"{q}.mid_block2"),
            **_conv3d(sd, f"{p}.conv_in", f"{q}.conv_in.conv"),
            **_conv3d(sd, f"{p}.conv_out", f"{q}.conv_out.conv"),
            **_layernorm(sd, f"{p}.conv_norm_out", f"{q}.norm_out")}


def hunyuan_vae_state_dict_to_tree(sd: Dict[str, torch.Tensor], cfg) -> dict:
    """diffusers AutoencoderKLHunyuanVideo state dict -> the port's HunyuanVAE's."""
    tree = {**_hy_vae_mid(sd, "decoder", "decoder"), **_hy_vae_mid(sd, "encoder", "encoder")}
    sides = (("decoder", "up_blocks", cfg.layers_per_block + 1, "upsamplers", "up"),
             ("encoder", "down_blocks", cfg.layers_per_block, "downsamplers", "down"))
    for side, blocks, n_res, resample, name in sides:
        for i in range(len(cfg.base_dims)):
            p, q = f"{side}.{blocks}.{i}", f"{side}.stages.{i}"
            for j in range(n_res):
                tree.update(_hy_vae_resblock(sd, f"{p}.resnets.{j}", f"{q}.blocks.{j}"))
            if f"{p}.{resample}.0.conv.weight" in sd:
                tree.update(_conv3d(sd, f"{p}.{resample}.0.conv", f"{q}.{name}.conv.conv"))
    return tree


def load_hunyuan_vae_torch_weights(model, path):
    """Import diffusers AutoencoderKLHunyuanVideo weights into
    models.hunyuan_vae.HunyuanVAE; a mapped key the model lacks raises."""
    tree = hunyuan_vae_state_dict_to_tree(load_state_dict(path), model.cfg)
    return _check_vae("HunyuanVAE", apply_state(model, tree))
