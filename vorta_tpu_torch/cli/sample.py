"""Text-to-video latent sampling on the GPU (counterpart of cli/sample.py).

Each head of each block is routed per step to its expert (full, lowres or
sliding-tile attention; ``--tau_sparse`` is the confidence below which a
head falls back to full attention) unless ``--native_attention`` asks for
full attention everywhere, the baseline of routing's speed-up.
Conditioning comes from ``--prompt "..." --tokenizer_dir D`` (a
directory with a HuggingFace ``tokenizer.json``): the prompt is encoded on
the card by UMT5-XXL for Wan, by Llama-8B + CLIP-L for HunyuanVideo
(``--clip_tokenizer_dir``, default the same directory), tiny encoders for
the tiny models, sized as the JAX CLI sizes them; the encoders are freed
before the DiT is built.  Their weights come from
``--text_encoder_checkpoint`` (UMT5 / Llama) and ``--clip_checkpoint``
(transformers state dicts, io/torch_import.py), else they are random from
the seed (a warning says so).  Or from ``--prompt_embeds x.npy|x.pt`` (UMT5
or Llama states, (L, text_dim) or (1, L, text_dim)) or ``--random_embeds``;
``--negative_prompt_embeds`` (the same forms) replaces Wan's zero
unconditional embedding.  ``--prompt_embeds_dir D`` samples one video per
``.npy`` / ``.pt`` file of D, in sorted order, each from the same seed, into
``--output``'s directory (``--output`` itself where it has no suffix) under
the file's stem, the model and pipeline built once; ``--skip_existing``
skips a file whose output is there.  ``--cfg_batch`` runs the CFG pair as one
batch-2 forward.  Weights are
random, drawn from ``--seed``, unless ``--torch_checkpoint`` names a
diffusers checkpoint (one .safetensors / .pt / .bin file or a directory of
shards; io/torch_import.py); ``--router_checkpoint`` loads the routers
from a step dir that the port's trainer wrote (``<output_dir>/ckpt/
step-XXXXXX``, Wan or HunyuanVideo) or from a reference router file (``router.pt`` /
``.bin`` / ``.safetensors``), and ``--resume_dir`` reads that run's attention geometry
from its ``config.json`` (``cli.train --sta_tile T H W`` writes the tile
there): for Wan its grid must be the requested video's and
``--tau_sparse`` overrides its threshold; for HunyuanVideo it is taken as
it is, as the JAX CLI does.  Writes the final latents as .npy and prints
the heads routed to each expert.  ``--decode`` runs the model's VAE (Wan
2.1's for every Wan model, as the JAX CLI does; HunyuanVideo's, tiny for
``hunyuan-tiny``; ``--vae_checkpoint`` a diffusers state dict, else random
from the seed) whole-clip, or in blended tiles with ``--vae_tiling``, and
writes the video: ``--output`` ending in .mp4 (imageio with ffmpeg, else a
.gif beside it), .gif, or .npy (the (T, H, W, 3) frames in [-1, 1]).

Quantized serving, the JAX CLI's four flags: ``--qk_int8`` runs the full
and low-res experts' QK^T in int8 (flash_manual's int8 mode; sliding-tile
stays bf16), ``--mm int8`` the block projections in W8A8 (ops/qmm.py),
``--act_scales x.npz`` gives them static activation scales (the JAX
tool's ``{site: (L,)}`` table, tools/calibrate_int8.py), and
``--quantize_blocks int4|int8`` serves the blocks from a quantized stack
through a depth-1 model (io/quant_serving.py; the checkpoint's blocks, or
random ones from the seed).

Step cache (ops/stepcache.py, Wan and HunyuanVideo): ``--cache_threshold``
(0 = off) skips a forward's block stack while the accumulated distance of
the timestep modulation since the last computed step stays under it,
``--cache_warmup`` steps at the start always compute (and the last step),
``--cache_poly x.npz`` rescales the distance by its fitted ``coefficients``
(e.g. ``assets/cache_poly_wan1_3b_720p.npz``).  Image to video (Wan):
``--image_embeds x.npy|x.pt``, (257, image_dim) CLIP image tokens; the
model takes ``image_dim`` from the file.

Sequence-parallel sampling (the JAX CLI's ``--sp_size`` / ``--dp_size``):
under torchrun, each group of ``--sp_size`` ranks shares one clip, its
latent frames sharded over the group (Ulysses; pipelines/ and models/);
the other factor of the world size (``--dp_size``) is replicas, replica r
sampling from seed + r into ``<output>`` with ``_dp<r>`` added for r > 0.
Rank 0 of each group writes.  ``--dp_size`` given (1 too) samples through
the process group even on one rank.

Examples:
  python -m vorta_tpu_torch.cli.sample --model wan-1_3B --random_embeds \\
      --num_frames 77 --num_inference_steps 2 --output out.npy
  torchrun --nproc_per_node 4 -m vorta_tpu_torch.cli.sample --model hunyuan-13B \\
      --random_embeds --num_frames 45 --height 720 --width 1280 --sp_size 4
  python -m vorta_tpu_torch.cli.sample --prompt "a cat walking on grass" \\
      --tokenizer_dir umt5_tokenizer --decode --output video.mp4
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import WAN_1_3B, WAN_14B, WAN_TINY, AttentionConfig
from ..device import full_f32, resolve_device
from ..geometry import HUNYUAN_GEOMETRY, WAN_GEOMETRY
from ..io import text as text_io
from ..io.checkpoint import apply_router_state, load_router_checkpoint
from ..io.from_jax import load_act_scales
from ..io.quant_serving import build_quantized_hunyuan, build_quantized_wan
from ..io.torch_import import (hunyuan_router_state, load_clip_text_torch_weights,
                               load_hunyuan_torch_weights, load_hunyuan_vae_torch_weights,
                               load_llama_torch_weights, load_umt5_torch_weights,
                               load_wan_torch_weights, load_wan_vae_torch_weights,
                               wan_router_state)
from ..io.video import save_video
from ..models.hunyuan import HUNYUAN_13B, HUNYUAN_TINY, HunyuanModel
from ..models.hunyuan_vae import HUNYUAN_VAE, HUNYUAN_VAE_TINY, HunyuanVAE
from ..models.text_encoders import (CLIPTextConfig, CLIPTextEncoder, LlamaConfig,
                                    LlamaTextEncoder)
from ..models.umt5 import UMT5Config, UMT5Encoder
from ..models.vae_tiling import tiled_decode
from ..models.wan import WanModel
from ..models.wan_vae import WAN_VAE, WanVAE
from ..parallel.mesh import make_mesh_for
from ..pipelines.hunyuan_t2v import HunyuanSamplingConfig, HunyuanT2VPipeline
from ..pipelines.wan_t2v import SamplingConfig, WanT2VPipeline

NEED_CONDITIONING = ("need --prompt with --tokenizer_dir, --prompt_embeds, --prompt_embeds_dir "
                     "or --random_embeds")
MODELS = {"wan-1_3B": WAN_1_3B, "wan-14B": WAN_14B, "wan-tiny": WAN_TINY,
          "hunyuan-13B": HUNYUAN_13B, "hunyuan-tiny": HUNYUAN_TINY}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="wan-1_3B", choices=sorted(MODELS))
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                   help="fp32: weights, activations and every kernel in f32 (on the card the "
                        "kernels' f32 modes, P kept in f32, and TF32 off for cuBLAS and "
                        "cuDNN, so the products and the VAE decode's convs stay f32)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--resume_dir", default=None,
                   help="training output dir: reads config.json's attention geometry")
    p.add_argument("--torch_checkpoint", default=None,
                   help="DiT weights: diffusers .safetensors / .pt / .bin, or a dir of shards")
    p.add_argument("--router_checkpoint", default=None,
                   help="a step dir written by vorta_tpu_torch.cli.train, or a "
                        "reference router.pt / .bin / .safetensors")
    p.add_argument("--native_attention", action="store_true",
                   help="full 3D attention baseline (routing off)")
    p.add_argument("--tau_sparse", type=float, default=0.3)
    p.add_argument("--mm", default="bf16", choices=["bf16", "int8"],
                   help="int8: W8A8 block projections (ops/qmm.py)")
    p.add_argument("--qk_int8", action="store_true",
                   help="int8 QK^T in the full / low-res experts (sliding-tile stays bf16)")
    p.add_argument("--act_scales", default=None,
                   help="npz of static int8 activation scales {site: (L,)} for --mm int8")
    p.add_argument("--quantize_blocks", default=None, choices=["int4", "int8"],
                   help="serve the blocks from an int4 / int8 stack, one block dequantized "
                        "at a time (io/quant_serving.py)")
    p.add_argument("--cache_threshold", type=float, default=0.0,
                   help="step cache (ops/stepcache.py): skip the block stack while the "
                        "accumulated modulation distance stays under this (0 = off)")
    p.add_argument("--cache_warmup", type=int, default=1,
                   help="denoise steps at the start that always compute")
    p.add_argument("--cache_poly", default=None,
                   help="npz whose 'coefficients' (highest degree first) rescale the "
                        "cache distance")
    p.add_argument("--prompt", default=None,
                   help="text prompt; with --tokenizer_dir it is encoded on the card")
    p.add_argument("--tokenizer_dir", default=None,
                   help="dir with a HuggingFace fast tokenizer.json for the text encoder")
    p.add_argument("--text_encoder_checkpoint", default=None,
                   help="UMT5 (wan) / Llama (hunyuan) transformers weights")
    p.add_argument("--clip_tokenizer_dir", default=None,
                   help="CLIP's tokenizer.json dir (hunyuan; default --tokenizer_dir)")
    p.add_argument("--clip_checkpoint", default=None, help="CLIP-L transformers weights")
    p.add_argument("--prompt_embeds", default=None,
                   help=".npy / .pt text states (L, text_dim) or (1, L, text_dim)")
    p.add_argument("--negative_prompt_embeds", default=None,
                   help="Wan: the unconditional states (.npy / .pt; default zeros)")
    p.add_argument("--cfg_batch", action="store_true",
                   help="run CFG's conditional and unconditional passes as one batch-2 forward")
    p.add_argument("--image_embeds", default=None,
                   help="I2V (Wan): .npy / .pt CLIP image tokens (257, image_dim)")
    p.add_argument("--random_embeds", action="store_true")
    p.add_argument("--num_frames", type=int, default=77)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=5.0)
    p.add_argument("--flow_shift", type=float, default=5.0)
    p.add_argument("--scheduler", default=None, choices=["unipc", "euler"],
                   help="default: unipc for wan, euler for hunyuan")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--output", default="results/sample.npy",
                   help=".npy latents, or with --decode the video: .mp4 / .gif / .npy frames")
    p.add_argument("--decode", action="store_true", help="decode through the model's VAE")
    p.add_argument("--vae_tiling", action="store_true",
                   help="decode in blended tiles (models/vae_tiling.py)")
    p.add_argument("--vae_checkpoint", default=None,
                   help="diffusers AutoencoderKLWan / AutoencoderKLHunyuanVideo weights")
    # sequence-parallel sampling (reference: torchrun --nproc_per_node N + sp)
    p.add_argument("--sp_size", type=int, default=1,
                   help="shard the latent frames over groups of this many ranks (Ulysses)")
    p.add_argument("--dp_size", type=int, default=None,
                   help="replicas (default: the world size over --sp_size)")
    # batch inference over a directory of prompt embeddings (reference:
    # scripts/wan/inference.py:165-193, per-prompt seed and skip-existing)
    p.add_argument("--prompt_embeds_dir", default=None,
                   help="directory of .npy / .pt embeds: one video per file")
    p.add_argument("--skip_existing", action="store_true",
                   help="with --prompt_embeds_dir: skip a file whose output exists")
    return p.parse_args(argv)


def load_array(path) -> np.ndarray:
    """A .npy array, or a tensor saved with torch.save (read with
    ``weights_only``), as f32 numpy."""
    if str(path).endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    return torch.load(path, map_location="cpu", weights_only=True).float().numpy()


def load_embeds(path, cfg) -> np.ndarray:
    """(1, text_len, text_dim) f32 text states from a .npy / .pt of (L,
    text_dim) or (1, L, text_dim), zero-padded or cut to ``text_len``."""
    arr = load_array(path)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.shape[1] < cfg.text_len:
        arr = np.pad(arr, ((0, 0), (0, cfg.text_len - arr.shape[1]), (0, 0)))
    return arr[:, : cfg.text_len]


def load_cache_poly(args):
    """The fitted rescale polynomial of ``--cache_poly`` (the npz's
    ``coefficients``, highest degree first), or None."""
    if not args.cache_poly:
        return None
    return tuple(float(c) for c in np.load(args.cache_poly)["coefficients"])


def load_image_embeds(path) -> np.ndarray:
    """(1, N, image_dim) f32 from a .npy or a .pt of (N, image_dim) or
    (1, N, image_dim)."""
    arr = load_array(path)
    return arr[None] if arr.ndim == 2 else arr


def random_embeds(gen: torch.Generator, seed: int, shape, device) -> torch.Tensor:
    """Standard normal f32 of ``shape`` from ``gen`` seeded with ``seed``
    (``--random_embeds``: seed + 1)."""
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def embeds_files(directory) -> list:
    """The sorted .npy / .pt files of ``--prompt_embeds_dir``."""
    files = sorted(p for p in Path(directory).iterdir() if p.suffix in (".npy", ".pt"))
    if not files:
        raise SystemExit(f"no .npy/.pt embeds in {directory}")
    return files


def run_batch(args, generate, load_fn) -> list:
    """One video per embeddings file, each from the same seed, named after
    the file's stem in ``--output``'s directory (``--output`` itself where
    it has no suffix), skipping existing outputs with ``--skip_existing``;
    ``generate(embeds, output)``'s results, in file order."""
    out_base = Path(args.output)
    suffix = out_base.suffix or ".npy"
    out_dir = out_base.parent if out_base.suffix else out_base
    results = []
    for f in embeds_files(args.prompt_embeds_dir):
        out = out_dir / (f.stem + suffix)
        if args.skip_existing and (out.exists() or out.with_suffix(".npy").exists()):
            print(f"[sample] skip existing {out}", flush=True)
            continue
        results.append(generate(load_fn(f), out))
    return results


def is_router_file(path) -> bool:
    """A reference router file, not a step dir of the port's trainer."""
    return Path(path).suffix in (".pt", ".bin", ".safetensors")


def attention_config(model: str, grid, tau_sparse: float = 0.3) -> AttentionConfig:
    """The JAX CLI's attention geometry for a fresh run (no resume dir)."""
    if model == "hunyuan-tiny":
        return AttentionConfig(latent_shape=grid, sta_window=(3, 3, 3), sta_tile=(2, 2, 2),
                               lowres_window=(2, 2, 2), block_q=32, block_kv=32,
                               sta_block_q=8, sta_block_kv=8, tau_sparse=tau_sparse)
    if model == "hunyuan-13B":
        return AttentionConfig(latent_shape=grid, sta_window=(3, 3, 3), sta_tile=(6, 9, 8),
                               lowres_window=(2, 3, 2), tau_sparse=tau_sparse)
    if model == "wan-tiny":
        return AttentionConfig(latent_shape=grid, sta_tile=(2, 2, 2), sta_window=(3, 3, 1),
                               lowres_window=(2, 2, 2), block_q=16, block_kv=16,
                               sta_block_q=8, sta_block_kv=8, tau_sparse=tau_sparse)
    return AttentionConfig(latent_shape=grid, sta_tile=(4, 6, 4), sta_window=(3, 3, 3),
                           lowres_window=(2, 3, 2), tau_sparse=tau_sparse)


def resolve_attention_config(args, grid) -> AttentionConfig:
    """The run's attention geometry: ``--resume_dir``'s ``config.json`` where
    it has one, else the CLI's (``attention_config``); ``--qk_int8`` on top.
    For Wan the file's grid must be the requested video's and
    ``--tau_sparse`` overrides its threshold; the JAX CLI's Hunyuan branch
    takes the file as it is."""
    attn_cfg = attention_config(args.model, grid, args.tau_sparse)
    if args.resume_dir and (Path(args.resume_dir) / "config.json").exists():
        attn_cfg = AttentionConfig.load(Path(args.resume_dir) / "config.json")
        if not args.model.startswith("hunyuan"):
            if attn_cfg.latent_shape != grid:
                raise ValueError(f"config.json geometry {attn_cfg.latent_shape} != requested "
                                 f"video grid {grid}")
            attn_cfg = dataclasses.replace(attn_cfg, tau_sparse=args.tau_sparse)
    if args.qk_int8:
        attn_cfg = dataclasses.replace(attn_cfg, qk_int8=True)
    return attn_cfg


@dataclasses.dataclass
class SampleResult:
    latents: torch.Tensor  # final latents (B, T, H/8, W/8, C) f32
    build_s: float  # model, embeddings and noise made, synchronised
    denoise_s: float  # the sampling loop, synchronised
    steps: int
    # one (num_layers, H) table of expert ids per hard-routed forward
    routing: list = dataclasses.field(default_factory=list)
    # (step, arm, skipped) per forward with the step cache on
    cache_log: list = dataclasses.field(default_factory=list)
    encode_s: float = 0.0  # the prompt's encode (--prompt), synchronised
    decode_s: float = 0.0  # the VAE decode (--decode), synchronised
    video: Optional[Path] = None  # the file --decode wrote


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _timed_encode(device, fn):
    """(fn()'s result, its seconds), synchronised, under inference mode."""
    _sync(device)
    t0 = time.time()
    with torch.inference_mode():
        out = fn()
    _sync(device)
    dt = time.time() - t0
    print(f"[sample] prompt encoded in {dt:.3f}s", flush=True)
    return out, dt


def encode_wan_prompt(args, model_cfg, dtype, device):
    """(UMT5 states (1, text_len, text_dim), encode seconds): UMT5-XXL where
    the DiT takes 4096-wide text, else the JAX CLI's tiny encoder; the
    encoder is freed before returning."""
    if model_cfg.text_dim == 4096:
        cfg = UMT5Config()
    else:
        cfg = UMT5Config(vocab_size=512, d_model=model_cfg.text_dim, d_kv=16,
                         num_heads=max(1, model_cfg.text_dim // 16),
                         d_ff=2 * model_cfg.text_dim, num_layers=2)
    tok = text_io.load_tokenizer(args.tokenizer_dir)
    enc = UMT5Encoder(cfg, dtype=dtype, device=device, seed=args.seed)
    if args.text_encoder_checkpoint:
        load_umt5_torch_weights(enc, args.text_encoder_checkpoint)
    else:
        print("[sample] WARNING: encoding with random UMT5 weights "
              "(--text_encoder_checkpoint not given)", flush=True)
    pe, dt = _timed_encode(device, lambda: text_io.encode_prompt_wan(
        args.prompt, tok, enc, max_len=model_cfg.text_len))
    del enc
    _free(device)
    return pe, dt


def encode_hunyuan_prompt(args, model_cfg, dtype, device):
    """((Llama states, mask, CLIP pooled), encode seconds): Llama-8B + CLIP-L
    where the DiT takes 4096-wide text, else the JAX CLI's tiny encoders;
    both freed before returning."""
    if model_cfg.text_dim == 4096:
        lcfg, ccfg = LlamaConfig(), CLIPTextConfig()
    else:
        lcfg = LlamaConfig(vocab_size=512, dim=model_cfg.text_dim, num_layers=2, num_heads=2,
                           num_kv_heads=2, ffn_dim=2 * model_cfg.text_dim)
        ccfg = CLIPTextConfig(vocab_size=512, dim=model_cfg.pooled_dim, num_layers=2,
                              num_heads=2, ffn_dim=2 * model_cfg.pooled_dim, max_len=77)
    ltok = text_io.load_tokenizer(args.tokenizer_dir)
    ctok = text_io.load_tokenizer(args.clip_tokenizer_dir or args.tokenizer_dir)
    llama = LlamaTextEncoder(lcfg, dtype=dtype, device=device, seed=args.seed)
    clip = CLIPTextEncoder(ccfg, dtype=dtype, device=device, seed=args.seed + 1)
    if args.text_encoder_checkpoint:
        load_llama_torch_weights(llama, args.text_encoder_checkpoint)
    if args.clip_checkpoint:
        load_clip_text_torch_weights(clip, args.clip_checkpoint)
    if not (args.text_encoder_checkpoint and args.clip_checkpoint):
        print("[sample] WARNING: encoding with random text-encoder weights", flush=True)
    out, dt = _timed_encode(device, lambda: text_io.encode_prompt_hunyuan(
        args.prompt, ltok, llama, ctok, clip, max_len=model_cfg.text_len))
    del llama, clip
    _free(device)
    return out, dt


def _vae_note(applied) -> None:
    print(f"[sample] VAE imported ({len(applied)} tensors)", flush=True)


def wan_decoder(args, dtype, device):
    """latents -> pixels through Wan 2.1's VAE (every Wan model's, as the
    JAX CLI has it), whole-clip or tiled."""
    vae = WanVAE(WAN_VAE, dtype=dtype, device=device, seed=args.seed)
    if args.vae_checkpoint:
        _vae_note(load_wan_vae_torch_weights(vae, args.vae_checkpoint)[0])

    def decode(latents):
        z = vae.denormalize_latents(latents)
        if args.vae_tiling:
            return tiled_decode(lambda zz: vae.decode(zz, denormalize=False), z)
        return vae.decode(z, denormalize=False)

    return decode


def main(argv=None):
    """Runs the sampler and writes the final latents as .npy (under sequence
    parallelism, from rank 0 of each group; the others return the same
    result without writing); a ``SampleResult``, or with
    ``--prompt_embeds_dir`` a list of them, one per video sampled."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    joined = dist.is_initialized()
    mesh = make_mesh_for(args.sp_size, args.dp_size, device)
    try:
        if mesh is not None:
            if not mesh.in_mesh:
                return None  # a rank past dp * sp
            device = mesh.device
            args.seed += mesh.dp_rank
            if mesh.dp_rank:
                out = Path(args.output)
                args.output = str(out.with_name(f"{out.stem}_dp{mesh.dp_rank}{out.suffix}"))
        return _main(args, device, mesh)
    finally:
        if dist.is_initialized() and not joined:  # the group this call joined
            dist.destroy_process_group()


def _main(args, device, mesh) -> SampleResult:
    model_cfg = MODELS[args.model]
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if dtype == torch.float32:
        full_f32(device)
    hunyuan = args.model.startswith("hunyuan")
    geometry = HUNYUAN_GEOMETRY if hunyuan else WAN_GEOMETRY
    grid = geometry.tokens((args.num_frames, args.height, args.width))
    attn_cfg = resolve_attention_config(args, grid)
    routing_mode = "off" if args.native_attention else "hard"
    act_scales = None
    if args.act_scales:
        act_scales = load_act_scales(args.act_scales)
        print(f"[sample] static int8 scales: {len(act_scales)} sites from {args.act_scales}",
              flush=True)
    bits = int(args.quantize_blocks[3:]) if args.quantize_blocks else None
    sp_group = None if mesh is None else mesh.sp_group
    if sp_group is not None and grid[0] % mesh.sp_size:
        raise ValueError(f"{grid[0]} latent frames not divisible by sp_size {mesh.sp_size}")
    if hunyuan:
        return _main_hunyuan(args, device, model_cfg, dtype, grid, attn_cfg, routing_mode,
                             act_scales, bits, sp_group)
    image_embeds = None
    if args.image_embeds:
        image_embeds = load_image_embeds(args.image_embeds)
        if model_cfg.image_dim is None:
            model_cfg = dataclasses.replace(model_cfg, image_dim=int(image_embeds.shape[-1]))
    router_state = None
    if args.router_checkpoint:
        rp = Path(args.router_checkpoint)
        router_state = (wan_router_state(rp, model_cfg.num_layers) if is_router_file(rp)
                        else load_router_checkpoint(rp)[0])
    print(f"[sample] model={args.model} grid={grid} routing={routing_mode} device={device}"
          f"{_quant_note(args)}", flush=True)
    pe, encode_s = None, 0.0
    if args.prompt and args.tokenizer_dir:
        pe, encode_s = encode_wan_prompt(args, model_cfg, dtype, device)

    t0 = time.time()
    qblocks = None
    if bits:
        model, qblocks = build_quantized_wan(model_cfg, bits, checkpoint=args.torch_checkpoint,
                                             router_state=router_state, seed=args.seed,
                                             dtype=dtype, device=device)
    else:
        model = WanModel(model_cfg, dtype=dtype, device=device, seed=args.seed)
        if args.torch_checkpoint:
            applied, missing = load_wan_torch_weights(model, args.torch_checkpoint)
            print(f"[sample] imported {len(applied)} tensors ({len(missing)} missing) from "
                  f"{args.torch_checkpoint}", flush=True)
        if router_state is not None:
            apply_router_state(model, router_state)
    if router_state is not None:
        print(f"[sample] router loaded from {args.router_checkpoint}", flush=True)
    gen = torch.Generator(device=device)

    def embeds(path):
        return torch.from_numpy(load_embeds(path, model_cfg)).to(device)

    if pe is not None:  # encoded from --prompt above
        pass
    elif args.prompt_embeds:
        pe = embeds(args.prompt_embeds)
    elif args.random_embeds:
        pe = random_embeds(gen, args.seed + 1, (1, model_cfg.text_len, model_cfg.text_dim),
                           device)
    elif not args.prompt_embeds_dir:
        raise SystemExit(NEED_CONDITIONING)
    neg = embeds(args.negative_prompt_embeds) if args.negative_prompt_embeds else None
    pipe = WanT2VPipeline(model, attn_cfg=attn_cfg, act_scales=act_scales,
                          quantized_blocks=qblocks, sp_group=sp_group)
    img = None
    if image_embeds is not None:
        img = torch.from_numpy(image_embeds).to(device=device, dtype=dtype)
    _sync(device)
    build_s = time.time() - t0
    print(f"[sample] model built in {build_s:.1f}s", flush=True)

    sampling = SamplingConfig(
        num_inference_steps=args.num_inference_steps, guidance_scale=args.guidance_scale,
        flow_shift=args.flow_shift, scheduler=args.scheduler or "unipc",
        routing_mode=routing_mode, mm_precision=args.mm, cfg_batch=args.cfg_batch,
        **_cache_kw(args))
    decode = wan_decoder(args, dtype, device) if args.decode else None

    def generate(pe, output):
        # the unconditional prompt: --negative_prompt_embeds, else empty (zeros)
        ne = neg if neg is not None else torch.zeros_like(pe)
        latents = pipe.prepare_latents(gen.manual_seed(args.seed), 1, args.num_frames,
                                       args.height, args.width)
        routing, cache_log = [], []
        t0 = time.time()
        final = pipe(latents, pe, ne, sampling=sampling, routing=routing, image_embeds=img,
                     cache_log=cache_log)
        return _finish(args, device, final, build_s, t0, routing, cache_log, encode_s, decode,
                       sp_group, output)

    if args.prompt_embeds_dir:
        return run_batch(args, generate, embeds)
    return generate(pe, args.output)


def _cache_kw(args) -> dict:
    return dict(cache_threshold=args.cache_threshold, cache_warmup=args.cache_warmup,
                cache_coefficients=load_cache_poly(args))


def _quant_note(args) -> str:
    on = [f"mm={args.mm}"] if args.mm != "bf16" else []
    on += ["qk_int8"] if args.qk_int8 else []
    on += [f"act_scales={args.act_scales}"] if args.act_scales else []
    on += [f"quantize_blocks={args.quantize_blocks}"] if args.quantize_blocks else []
    on += [f"cache_threshold={args.cache_threshold}"] if args.cache_threshold > 0 else []
    return (" " + " ".join(on)) if on else ""


def _finish(args, device, final: torch.Tensor, build_s: float, t0: float,
            routing: list, cache_log: list, encode_s: float, decode=None,
            sp_group=None, output=None) -> SampleResult:
    """Synchronise, report the denoise time, the routing and the step
    cache's skips; write the latents to ``output`` (default ``--output``),
    or with ``decode`` (latents -> pixels) the video; under sequence
    parallelism only the group's rank 0 reports and writes."""
    output = args.output if output is None else output
    _sync(device)
    if sp_group is not None and dist.get_rank(sp_group) != 0:
        return SampleResult(final, build_s, time.time() - t0, args.num_inference_steps,
                            routing, cache_log, encode_s)
    dt = time.time() - t0
    print(f"[sample] denoised in {dt:.2f}s ({dt / args.num_inference_steps:.3f}s/step)",
          flush=True)
    if cache_log:
        skipped = sum(s for _, _, s in cache_log)
        print(f"[sample] step cache: {len(cache_log) - skipped} of {len(cache_log)} forwards "
              f"computed, {skipped} skipped", flush=True)
    if routing:
        heads = np.bincount(np.concatenate([r.reshape(-1) for r in routing]), minlength=3)
        print(f"[sample] heads routed over {len(routing)} forwards: full {heads[0]}, "
              f"lowres {heads[1]}, sta {heads[2]}", flush=True)
    res = SampleResult(final, build_s, dt, args.num_inference_steps, routing, cache_log,
                       encode_s)
    if decode is not None:
        t1 = time.time()
        with torch.inference_mode():
            video = decode(final)
        _sync(device)
        res.decode_s = time.time() - t1
        print(f"[sample] decoded {tuple(video.shape)} in {res.decode_s:.2f}s"
              f"{' (tiled)' if args.vae_tiling else ''}", flush=True)
        res.video = save_video(video[0].float().cpu().numpy(), output)
        print(f"[sample] wrote {res.video}", flush=True)
        return res
    out = Path(output).with_suffix(".npy")
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, final.cpu().numpy())
    print(f"[sample] wrote {out}", flush=True)
    return res


def _main_hunyuan(args, device, model_cfg, dtype, grid, attn_cfg, routing_mode: str,
                  act_scales, bits, sp_group=None) -> SampleResult:
    """HunyuanVideo sampling (the JAX CLI's _main_hunyuan, latents out)."""
    if args.image_embeds:
        raise ValueError("--image_embeds is Wan's image branch; HunyuanVideo's I2V is "
                         "token replace (HunyuanModelConfig.image_condition_type)")
    router_state = None
    if args.router_checkpoint:
        rp = Path(args.router_checkpoint)
        router_state = (hunyuan_router_state(rp, model_cfg.dual_layers, model_cfg.single_layers)
                        if is_router_file(rp) else load_router_checkpoint(rp)[0])
    print(f"[sample] model={args.model} grid={grid} routing={routing_mode} device={device}"
          f"{_quant_note(args)}", flush=True)
    text, encode_s = None, 0.0
    if args.prompt and args.tokenizer_dir:
        (text, mask, pooled), encode_s = encode_hunyuan_prompt(args, model_cfg, dtype, device)
    t0 = time.time()
    qblocks = None
    if bits:
        model, qblocks = build_quantized_hunyuan(model_cfg, bits,
                                                 checkpoint=args.torch_checkpoint,
                                                 router_state=router_state, seed=args.seed,
                                                 dtype=dtype, device=device)
    else:
        model = HunyuanModel(model_cfg, dtype=dtype, device=device, seed=args.seed)
        if args.torch_checkpoint:
            applied, missing = load_hunyuan_torch_weights(model, args.torch_checkpoint)
            print(f"[sample] imported {len(applied)} tensors ({len(missing)} missing) from "
                  f"{args.torch_checkpoint}", flush=True)
        if router_state is not None:
            apply_router_state(model, router_state)
    if router_state is not None:
        print(f"[sample] router loaded from {args.router_checkpoint}", flush=True)
    gen = torch.Generator(device=device)
    lt = model_cfg.text_len

    def from_file(path):
        """(states, mask, pooled) of an embeddings file, as the JAX CLI makes
        them: pooled from the first token, the mask from the nonzero rows."""
        states = torch.from_numpy(load_embeds(path, model_cfg)).to(device)
        return states, (states != 0).any(dim=-1), states[:, 0, :model_cfg.pooled_dim]

    if text is not None:  # encoded from --prompt above
        pass
    elif args.prompt_embeds:
        text, mask, pooled = from_file(args.prompt_embeds)
    elif args.random_embeds:
        text = random_embeds(gen, args.seed + 1, (1, lt, model_cfg.text_dim), device)
        pooled = torch.randn((1, model_cfg.pooled_dim), generator=gen, device=device)
        mask = torch.ones((1, lt), dtype=torch.bool, device=device)  # all valid, as in JAX
    elif not args.prompt_embeds_dir:
        raise SystemExit(NEED_CONDITIONING)
    vae = None
    if args.decode:
        vae = HunyuanVAE(HUNYUAN_VAE if args.model == "hunyuan-13B" else HUNYUAN_VAE_TINY,
                         dtype=dtype, device=device, seed=args.seed)
        if args.vae_checkpoint:
            _vae_note(load_hunyuan_vae_torch_weights(vae, args.vae_checkpoint)[0])
    pipe = HunyuanT2VPipeline(model, attn_cfg=attn_cfg, vae=vae, act_scales=act_scales,
                              quantized_blocks=qblocks, sp_group=sp_group)
    _sync(device)
    build_s = time.time() - t0
    valid = "" if text is None else f"; {int(mask.sum())} of {lt} text tokens valid"
    print(f"[sample] model built in {build_s:.1f}s{valid}", flush=True)
    sampling = HunyuanSamplingConfig(
        num_inference_steps=args.num_inference_steps, guidance_scale=args.guidance_scale,
        flow_shift=args.flow_shift, scheduler=args.scheduler or "euler",
        routing_mode=routing_mode, mm_precision=args.mm, cfg_batch=args.cfg_batch,
        **_cache_kw(args))
    decode = (lambda x: pipe.decode(x, tiled=args.vae_tiling)) if vae else None

    def generate(conditioning, output):
        text, mask, pooled = conditioning
        latents = pipe.prepare_latents(gen.manual_seed(args.seed), 1, args.num_frames,
                                       args.height, args.width)
        routing, cache_log = [], []
        t0 = time.time()
        final = pipe(latents, text, mask, pooled, sampling=sampling, routing=routing,
                     cache_log=cache_log)
        return _finish(args, device, final, build_s, t0, routing, cache_log, encode_s, decode,
                       sp_group, output)

    if args.prompt_embeds_dir:
        return run_batch(args, generate, from_file)
    return generate((text, mask, pooled), args.output)


if __name__ == "__main__":
    main()
