"""The port's image-to-video conditioning against the JAX package, on the
CPU, and the sampling CLI's new flags: Wan's image branch
(``WanModelConfig.image_dim``, ``WanImageEmbedding``, attn2's image keys and
values) through the model and the pipeline's ``image_embeds``;
HunyuanVideo's token replace (``image_condition_type="token_replace"``:
the first latent frame's rows take the t = 0 modulation, the norm run over
two row ranges); ``cli.sample``'s ``--image_embeds``, ``--cache_*``,
``--torch_checkpoint`` and reference ``--router_checkpoint`` files, and
``cli.train --torch_checkpoint``, spied.

Weights come from the JAX models through io/from_jax.py (or from a
synthetic diffusers state dict); inputs from numpy seeds.  f32 on both
sides, JAX's Pallas kernels in interpret mode: rtol 1e-4 and atol 1e-4 x
the output's scale, as the port's other model tests; the t = 0 identity
within 1e-5, as tests/test_token_replace.py holds JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.config import WanModelConfig as JaxWanModelConfig
from vorta_tpu.models import hunyuan as jhunyuan
from vorta_tpu.models.wan import WanModel as JaxWanModel
from vorta_tpu.pipelines.wan_t2v import SamplingConfig as JaxSamplingConfig
from vorta_tpu.pipelines.wan_t2v import WanT2VPipeline as JaxPipeline
from vorta_tpu_torch.config import AttentionConfig, WanModelConfig
from vorta_tpu_torch.io import torch_import as ti
from vorta_tpu_torch.io.from_jax import hunyuan_state_from_jax, wan_state_from_jax
from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanModel
from vorta_tpu_torch.models.wan import WanModel
from vorta_tpu_torch.pipelines.wan_t2v import SamplingConfig, WanT2VPipeline


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(dim=128, ffn_dim=256, num_heads=2, head_dim=64, num_layers=2, text_dim=32,
           text_len=16, freq_dim=32, image_dim=48)
ATTN = dict(latent_shape=(4, 4, 4), block_q=16, block_kv=16)
HY_ATTN = dict(latent_shape=(4, 4, 4), sta_window=(3, 3, 1), sta_tile=(2, 2, 2),
               lowres_window=(2, 2, 2), block_q=16, block_kv=16, sta_block_q=8, sta_block_kv=8)
TINY_CLI = ["--device", "cpu", "--dtype", "fp32", "--random_embeds", "--num_frames", "13",
            "--height", "64", "--width", "64", "--num_inference_steps", "2"]


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


def _flat(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


@pytest.fixture(scope="module")
def wan():
    jmodel = JaxWanModel(JaxWanModelConfig(**CFG), dtype=jnp.float32, rngs=nnx.Rngs(0))
    cfg = WanModelConfig(**CFG)
    tmodel = WanModel(cfg, dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(wan_state_from_jax(_flat(nnx.state(jmodel)), cfg))
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32)
    pe = rng.standard_normal((1, CFG["text_len"], CFG["text_dim"])).astype(np.float32)
    ne = rng.standard_normal((1, CFG["text_len"], CFG["text_dim"])).astype(np.float32)
    img = rng.standard_normal((1, 257, CFG["image_dim"])).astype(np.float32)
    return jmodel, tmodel, latents, pe, ne, img


def test_wan_image_branch_matches_jax(wan):
    """The image embedder (exact GELU, eps 1e-5 norms) and one forward with
    257 image tokens; the image tokens change the output, and a model
    without ``image_dim`` has no image parameters."""
    jmodel, tmodel, latents, pe, _, img = wan
    t = np.asarray([300.0], np.float32)
    want = jmodel.condition_embedder.image_embedder(jnp.asarray(img[0]))
    with torch.no_grad():
        got = tmodel.condition_embedder.image_embedder(torch.from_numpy(img[0]))
    _close(got, want)
    ref = jmodel(jnp.asarray(latents), jnp.asarray(t), jnp.asarray(pe),
                 attn_cfg=JaxAttentionConfig(**ATTN), image_context=jnp.asarray(img),
                 interpret=True).sample
    args = (torch.from_numpy(latents), torch.from_numpy(t), torch.from_numpy(pe))
    with torch.no_grad():
        out = tmodel(*args, attn_cfg=AttentionConfig(**ATTN),
                     image_context=torch.from_numpy(img)).sample
        text_only = tmodel(*args, attn_cfg=AttentionConfig(**ATTN)).sample
    _close(out, ref)
    assert (out - text_only).abs().max() > 1e-4
    t2v = WanModel(WanModelConfig(**{**CFG, "image_dim": None}), device="meta")
    assert not any("image" in k or "add_" in k for k in t2v.state_dict())


@pytest.mark.parametrize("cfg_batch", [False, True])
def test_wan_i2v_pipeline_matches_jax(wan, cfg_batch):
    """2 UniPC steps with CFG 5 and the image tokens on both arms."""
    jmodel, tmodel, latents, pe, ne, img = wan
    kw = dict(num_inference_steps=2, guidance_scale=5.0, cfg_batch=cfg_batch)
    ref, _ = JaxPipeline(jmodel, attn_cfg=JaxAttentionConfig(**ATTN), interpret=True)(
        jnp.asarray(latents), jnp.asarray(pe), jnp.asarray(ne),
        sampling=JaxSamplingConfig(**kw), image_embeds=jnp.asarray(img))
    got = WanT2VPipeline(tmodel, attn_cfg=AttentionConfig(**ATTN))(
        torch.from_numpy(latents), torch.from_numpy(pe), torch.from_numpy(ne),
        sampling=SamplingConfig(**kw), image_embeds=torch.from_numpy(img))
    _close(got, ref)


@pytest.fixture(scope="module")
def token_replace():
    cfg_tr = dataclasses.replace(jhunyuan.HUNYUAN_TINY, image_condition_type="token_replace",
                                 guidance_embeds=False)
    jmodel = jhunyuan.HunyuanModel(cfg_tr, rngs=nnx.Rngs(0))
    state = _flat(nnx.state(jmodel))
    port_cfg = dataclasses.replace(HUNYUAN_TINY, image_condition_type="token_replace",
                                   guidance_embeds=False)
    tr = HunyuanModel(port_cfg, dtype=torch.float32, device="cpu")
    tr.load_state_dict(hunyuan_state_from_jax(state, port_cfg))
    plain = HunyuanModel(dataclasses.replace(port_cfg, image_condition_type=None),
                         dtype=torch.float32, device="cpu")
    plain.load_state_dict(tr.state_dict())
    rng = np.random.default_rng(0)
    cfg = HUNYUAN_TINY
    inputs = (rng.standard_normal((1, 4, 8, 8, cfg.in_channels)).astype(np.float32),
              rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(np.float32),
              np.ones((1, cfg.text_len), bool),
              rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32))
    return jmodel, tr, plain, inputs


def _hy_args(inputs, t, jax_side=False):
    lat, text, mask, pooled = inputs
    conv = jnp.asarray if jax_side else torch.from_numpy
    return conv(lat), conv(np.asarray([t], np.float32)), conv(text), conv(mask), conv(pooled)


def test_token_replace_identity_at_t0_and_change_at_500(token_replace):
    """tests/test_token_replace.py's cases on the port: at t = 0 (no
    guidance) tr_emb is temb, so token replace is the plain model; at t =
    500 the first frame's rows change the output."""
    _, tr, plain, inputs = token_replace
    kw = dict(attn_cfg=AttentionConfig(**HY_ATTN), routing_mode="off")
    with torch.no_grad():
        a = tr(*_hy_args(inputs, 0.0), **kw).sample
        b = plain(*_hy_args(inputs, 0.0), **kw).sample
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        a = tr(*_hy_args(inputs, 500.0), **kw).sample
        b = plain(*_hy_args(inputs, 500.0), **kw).sample
    assert torch.isfinite(a).all() and (a - b).abs().max() > 1e-5


@pytest.mark.parametrize("routing", ["off", "hard"])
def test_token_replace_matches_jax(token_replace, routing, monkeypatch):
    """t = 500 against the JAX model (its jnp.where over two full norms);
    the port's norm runs its two row ranges into one output, counted."""
    from vorta_tpu_torch.ops import fused_norm as fn

    jmodel, tr, _, inputs = token_replace
    ref = jmodel(*_hy_args(inputs, 500.0, True), attn_cfg=JaxAttentionConfig(**HY_ATTN),
                 routing_mode=routing, interpret=True).sample
    ranges = []
    real = fn._norm_fwd

    def spy(x, *args):
        if len(args) > 7 and args[7] is not None:
            ranges.append(x.shape[1])
        return real(x, *args)

    monkeypatch.setattr(fn, "_norm_fwd", spy)
    with torch.no_grad():
        got = tr(*_hy_args(inputs, 500.0), attn_cfg=AttentionConfig(**HY_ATTN),
                 routing_mode=routing).sample
    _close(got, ref)
    # per dual block norm1 and norm2 over 16 first-frame rows and 48 others;
    # per single block its norm over 16 and 48 + 24 text rows
    assert ranges == [16, 48] * 4 + [16, 72] * 2


def _write_wan_checkpoint(path, cfg, seed=0):
    from safetensors.torch import save_file

    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy((rng.standard_normal(sh) * 0.05).astype(np.float32))
          for k, sh in ti.wan_expected_shapes(cfg).items()}
    save_file(sd, str(path))
    return sd


def test_cli_wan_flags(tmp_path, monkeypatch):
    """--torch_checkpoint (with and without --quantize_blocks), a reference
    --router_checkpoint file, --image_embeds (.npy and .pt, image_dim from
    the file) and --cache_threshold / --cache_warmup / --cache_poly reach
    the model and the pipeline."""
    from vorta_tpu_torch.cli import sample
    from vorta_tpu_torch.config import WAN_TINY

    ckpt = tmp_path / "wan.safetensors"
    sd = _write_wan_checkpoint(ckpt, WAN_TINY)
    routers = {f"blocks.{i}.router.linear.{p}": torch.full(sh, 0.01 * (i + 1))
               for i in range(2) for p, sh in (("weight", (6, 128)), ("bias", (6,)))}
    torch.save(routers, tmp_path / "router.pt")
    img = np.random.default_rng(1).standard_normal((257, 40)).astype(np.float32)
    np.save(tmp_path / "img.npy", img)
    torch.save(torch.from_numpy(img), tmp_path / "img.pt")
    seen = {}
    real_call = sample.WanT2VPipeline.__call__

    def spy_call(pipe, *args, **kw):
        seen.update(model=pipe.model, sampling=kw["sampling"], image=kw["image_embeds"])
        return real_call(pipe, *args, **kw)

    monkeypatch.setattr(sample.WanT2VPipeline, "__call__", spy_call)
    base = ["--model", "wan-tiny", *TINY_CLI, "--torch_checkpoint", str(ckpt),
            "--router_checkpoint", str(tmp_path / "router.pt")]
    res = sample.main(base + ["--output", str(tmp_path / "a.npy"), "--image_embeds",
                              str(tmp_path / "img.npy"), "--cache_threshold", "1e9",
                              "--cache_warmup", "1", "--cache_poly",
                              "assets/cache_poly_wan1_3b_720p.npz"])
    params = seen["model"].state_dict()
    want = ti.wan_state_dict_to_tree(sd, 2, 64)
    assert all(torch.equal(params[k], want[k]) for k in want)
    assert torch.equal(params["blocks.1.router.linear.bias"], torch.full((6,), 0.02))
    assert seen["model"].cfg.image_dim == 40
    assert torch.equal(seen["image"], torch.from_numpy(img)[None])
    s = seen["sampling"]
    assert s.cache_threshold == 1e9 and s.cache_warmup == 1 and len(s.cache_coefficients) == 5
    assert [k for *_, k in res.cache_log] == [False, False, False, False]  # 2 steps, both forced
    res_pt = sample.main(base + ["--output", str(tmp_path / "b.npy"), "--image_embeds",
                                 str(tmp_path / "img.pt")])
    torch.testing.assert_close(res_pt.latents, res.latents, rtol=0, atol=0)
    q = sample.main(base + ["--output", str(tmp_path / "q.npy"), "--quantize_blocks", "int8"])
    assert np.isfinite(q.latents.numpy()).all() and q.latents.shape == res.latents.shape


def test_cli_hunyuan_flags(tmp_path, monkeypatch):
    """HunyuanVideo-tiny: --torch_checkpoint (and --quantize_blocks), a
    reference router file, the cache flags; a step dir of the port's
    trainer loads (an empty dir is no step dir and raises), and
    --image_embeds (Wan's branch) raises."""
    from safetensors.torch import save_file

    from vorta_tpu_torch.cli import sample

    rng = np.random.default_rng(2)
    sd = {k: torch.from_numpy((rng.standard_normal(sh) * 0.05).astype(np.float32))
          for k, sh in ti.hunyuan_expected_shapes(HUNYUAN_TINY).items()}
    save_file(sd, str(tmp_path / "hy.safetensors"))
    routers = {f"module.{s}.{i}.router.linear.{p}": torch.full(sh, 0.5)
               for s in ("transformer_blocks", "single_transformer_blocks") for i in range(2)
               for p, sh in (("weight", (6, 128)), ("bias", (6,)))}
    torch.save(routers, tmp_path / "router.pt")
    seen = {}
    real_call = sample.HunyuanT2VPipeline.__call__

    def spy_call(pipe, *args, **kw):
        seen.update(model=pipe.model, sampling=kw["sampling"])
        return real_call(pipe, *args, **kw)

    monkeypatch.setattr(sample.HunyuanT2VPipeline, "__call__", spy_call)
    base = ["--model", "hunyuan-tiny", *TINY_CLI[:7], "--height", "96", "--width", "256",
            "--num_inference_steps", "3", "--native_attention", "--torch_checkpoint",
            str(tmp_path / "hy.safetensors")]
    res = sample.main(base + ["--router_checkpoint", str(tmp_path / "router.pt"),
                              "--cache_threshold", "1e9", "--output", str(tmp_path / "a.npy")])
    params = seen["model"].state_dict()
    want = ti.hunyuan_state_dict_to_tree(sd, 2, 2, 1, 64)
    assert all(torch.equal(params[k], want[k]) for k in want)
    assert torch.equal(params["single_blocks.1.router.linear.bias"], torch.full((6,), 0.5))
    assert seen["sampling"].cache_threshold == 1e9
    assert [k for *_, k in res.cache_log] == [False, True, False]
    q = sample.main(base + ["--quantize_blocks", "int4", "--output", str(tmp_path / "q.npy")])
    assert np.isfinite(q.latents.numpy()).all()
    (tmp_path / "step").mkdir()
    with pytest.raises(FileNotFoundError, match="not a router checkpoint step dir"):
        sample.main(base + ["--router_checkpoint", str(tmp_path / "step"),
                            "--output", str(tmp_path / "c.npy")])
    with pytest.raises(ValueError, match="token replace"):
        sample.main(base + ["--image_embeds", str(tmp_path / "x.npy"),
                            "--output", str(tmp_path / "d.npy")])


def test_train_cli_takes_torch_checkpoint(tmp_path, monkeypatch):
    """cli.train --torch_checkpoint sets the student's and the frozen
    teacher's weights (one model) before the routers train."""
    from vorta_tpu_torch.cli import train
    from vorta_tpu_torch.config import WAN_TINY

    ckpt = tmp_path / "wan.safetensors"
    sd = _write_wan_checkpoint(ckpt, WAN_TINY, seed=3)
    seen = {}
    real = train.router_partition

    def spy(model):
        seen["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        return real(model)

    monkeypatch.setattr(train, "router_partition", spy)
    res = train.main(["--model", "wan-tiny", "--device", "cpu", "--dtype", "fp32",
                      "--synthetic_data", "--max_train_steps", "1",
                      "--gradient_accumulation_steps", "1", "--torch_checkpoint", str(ckpt),
                      "--output_dir", str(tmp_path / "out")])
    want = ti.wan_state_dict_to_tree(sd, 2, 64)
    assert all(torch.equal(seen["state"][k], want[k]) for k in want)
    assert res.final_step == 1 and np.isfinite(res.metrics[-1]["loss"])
