"""The port's HunyuanVideo model, sampler and CLI against the JAX package, on
the CPU, routing off, hard and soft.

One HUNYUAN_TINY model (2 dual + 2 single blocks, dim 128, 2 heads x 64,
text 24 x 48) carries its weights to the port through io/from_jax.py.  Its
routers' biases are one-hot logits, so hard routing sends the heads to all
three experts: (FULL, STA) in the dual blocks, (LOWRES, STA) in the single
blocks.  The attention geometry is window-dense, as HunyuanVideo-13B's own
(latent (4, 6, 16), STA tile (4, 6, 8)); 17 of the 24 text tokens are
valid.  Inputs come from numpy and go to both sides; JAX runs its Pallas
kernels in interpret mode.  The 13B's parameter layout is held against the
JAX model's abstract shapes on the meta device, allocating nothing.

Tolerance: f32 on both sides, rtol 1e-4 and atol 1e-4 x the output's scale
(its max abs value).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.models import hunyuan as jhunyuan
from vorta_tpu.pipelines.hunyuan_t2v import HunyuanSamplingConfig as JaxSamplingConfig
from vorta_tpu.pipelines.hunyuan_t2v import HunyuanT2VPipeline as JaxPipeline
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.io.from_jax import hunyuan_state_from_jax, load_jax_params
from vorta_tpu_torch.models.hunyuan import (
    HUNYUAN_13B,
    HUNYUAN_TINY,
    HunyuanModel,
    hunyuan_rope_tables,
)
from vorta_tpu_torch.pipelines.hunyuan_t2v import HunyuanSamplingConfig, HunyuanT2VPipeline


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATTN = dict(latent_shape=(4, 6, 16), sta_window=(3, 3, 3), sta_tile=(4, 6, 8),
            lowres_window=(2, 2, 2), block_q=32, block_kv=32)
LATENT_SHAPE = (1, 4, 12, 32, 16)  # patch (1, 2, 2) -> token grid (4, 6, 16)
EXPERTS = {"dual_blocks": [0, 2], "single_blocks": [1, 2]}  # per head
EFF = 17  # valid text tokens of 24


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


def _flat(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat}


@pytest.fixture(scope="module")
def models():
    jmodel = jhunyuan.HunyuanModel(jhunyuan.HUNYUAN_TINY, rngs=nnx.Rngs(0))
    for stack, experts in EXPERTS.items():
        bias = 4.0 * np.eye(3, dtype=np.float32)[experts].reshape(-1)
        router = getattr(jmodel, stack).router.linear
        router.bias.value = jnp.asarray(np.tile(bias, (2, 1)))
    state = {k: np.asarray(v) for k, v in _flat(nnx.state(jmodel)).items()}
    tmodel = HunyuanModel(HUNYUAN_TINY, dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(hunyuan_state_from_jax(state, HUNYUAN_TINY))
    return jmodel, tmodel, state


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    cfg = HUNYUAN_TINY
    latents = rng.standard_normal(LATENT_SHAPE).astype(np.float32)
    text = rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32)
    mask = (np.arange(cfg.text_len) < EFF)[None]
    return latents, text, mask, pooled


def _args(inputs, t, jax_side: bool):
    latents, text, mask, pooled = inputs
    conv = jnp.asarray if jax_side else torch.from_numpy
    return (conv(latents), conv(np.asarray([t], np.float32)), conv(text), conv(mask),
            conv(pooled))


def test_config_and_rope_tables_match_jax():
    for ours, theirs in ((HUNYUAN_13B, jhunyuan.HUNYUAN_13B),
                         (HUNYUAN_TINY, jhunyuan.HUNYUAN_TINY)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for grid, cfg in (((4, 6, 16), HUNYUAN_TINY), ((12, 45, 80), HUNYUAN_13B)):
        for got, want in zip(hunyuan_rope_tables(grid, cfg),
                             jhunyuan.hunyuan_rope_tables(grid, cfg)):
            np.testing.assert_array_equal(got, np.asarray(want))


def test_13b_parameters_map_onto_the_jax_model():
    """HUNYUAN_13B's port parameters, names and shapes, one to one with the
    JAX 13B's (nnx.eval_shape: no weights made; zero-stride stand-ins map
    to meta tensors)."""
    abstract = nnx.eval_shape(lambda: jhunyuan.HunyuanModel(
        jhunyuan.HUNYUAN_13B, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16, rngs=nnx.Rngs(0)))
    flat = {k: np.broadcast_to(np.zeros((), np.float32), v.shape)
            for k, v in _flat(nnx.state(abstract)).items()}
    state = hunyuan_state_from_jax(flat, HUNYUAN_13B, meta=True)
    expected = HunyuanModel(HUNYUAN_13B, device="meta").state_dict()
    assert sorted(state) == sorted(expected)
    assert all(state[k].shape == expected[k].shape for k in expected)
    n_params = sum(t.numel() for t in expected.values())
    assert n_params == sum(int(np.prod(a.shape)) for a in flat.values())
    assert 12.5e9 < n_params < 13.5e9


def test_from_jax_rejects_missing_and_extra_keys(models):
    _, _, state = models
    some = next(iter(state))
    with pytest.raises(KeyError):
        hunyuan_state_from_jax({k: v for k, v in state.items() if k != some}, HUNYUAN_TINY)
    with pytest.raises(KeyError):
        hunyuan_state_from_jax({**state, "['extra']['kernel'].value": np.zeros((2, 2))},
                               HUNYUAN_TINY)


def test_load_jax_params_sets_a_subset(models):
    """A subset of the JAX paths (here the time embedders and a fused
    projection's three parts) sets those parameters and no others."""
    _, tmodel, state = models
    model = HunyuanModel(HUNYUAN_TINY, device="cpu", seed=7)
    keys = [k for k in state if "timestep_embedder" in k
            or any(k.startswith(f"['dual_blocks']['attn']['to_{n}']") for n in "qkv")]
    load_jax_params(model, {k: state[k] for k in keys})
    ref, got = tmodel.state_dict(), model.state_dict()
    set_names = [n for n in got if "timestep_embedder" in n or ".attn.qkv." in n]
    assert len(set_names) == 4 + 2 * 2
    assert all(torch.equal(got[n], ref[n]) for n in set_names)
    assert not any(torch.equal(got[n], ref[n]) for n in got
                   if n.endswith("weight") and n not in set_names and got[n].ndim > 1)
    with pytest.raises(KeyError, match="no parameter"):
        load_jax_params(model, {"['dual_blocks']['attn']['to_q']['bias'].value":
                                state["['dual_blocks']['attn']['to_q']['bias'].value"]})


@pytest.mark.parametrize("mode", ["off", "hard", "soft"])
def test_forward_matches_jax(models, inputs, mode):
    jmodel, tmodel, _ = models
    ref = jmodel(*_args(inputs, 500.0, True), guidance=jnp.asarray([6000.0]),
                 attn_cfg=JaxAttentionConfig(**ATTN), routing_mode=mode, return_scores=True,
                 interpret=True)
    with torch.no_grad():
        got = tmodel(*_args(inputs, 500.0, False), guidance=torch.tensor([6000.0]),
                     attn_cfg=AttentionConfig(**ATTN), routing_mode=mode, return_scores=True)
    _close(got.sample, ref.sample)
    _close(got.routing_scores, ref.routing_scores, atol_rel=1e-5)
    if mode == "hard":
        want = np.asarray([EXPERTS["dual_blocks"]] * 2 + [EXPERTS["single_blocks"]] * 2)
        np.testing.assert_array_equal(got.expert_ids, want)
    else:
        assert got.expert_ids is None


def test_forward_unfused_prologue_matches_fused(models, inputs, monkeypatch):
    from vorta_tpu_torch.ops import prologue

    _, tmodel, _ = models
    kw = dict(guidance=torch.tensor([3000.0]), attn_cfg=AttentionConfig(**ATTN))
    with torch.no_grad():
        fused = tmodel(*_args(inputs, 300.0, False), **kw).sample
        monkeypatch.setattr(prologue, "_PROLOGUE_MODE", "off")
        unfused = tmodel(*_args(inputs, 300.0, False), **kw).sample
    torch.testing.assert_close(fused, unfused, rtol=1e-5, atol=1e-5)


def test_unported_options_raise(models, inputs):
    """What the model refuses: training (served now, tests/
    test_torch_port_hunyuan_training.py) with routing off or with the step
    cache, and in the serving-only int8 mode, as JAX's; JAX's ``sp_axis``
    keyword, a ``sp_group`` here (tests/test_torch_port_parallel.py).  The
    step cache and token replace are served (test_torch_port_stepcache.py,
    test_torch_port_i2v.py); the tiny model's own STA tile (2, 2, 2), where
    the JAX package runs sta_batched, routes hard as the JAX model does."""
    jmodel, tmodel, _ = models
    args = _args(inputs, 500.0, False)
    kw = dict(attn_cfg=AttentionConfig(**ATTN))
    for bad, err in ((dict(return_losses=True), ValueError),
                     (dict(return_losses=True, routing_mode="off_ref"), ValueError),
                     (dict(return_losses=True, routing_mode="soft", step_cache=object()),
                      ValueError),
                     (dict(remat_blocks=True, routing_mode="soft", mm_precision="int8"),
                      NotImplementedError),
                     (dict(sp_axis="sp"), TypeError)):
        with pytest.raises(err):
            tmodel(*args, **kw, **bad)
    # W8A8 is served (tests/test_torch_port_quant_hunyuan.py holds it to JAX)
    with torch.no_grad():
        assert torch.isfinite(tmodel(*args, **kw, mm_precision="int8").sample).all()
    with pytest.raises(ValueError, match="routing mode"):
        tmodel(*args, **kw, routing_mode="hard_ref")
    with pytest.raises(ValueError, match="image_condition_type"):
        HunyuanModel(dataclasses.replace(HUNYUAN_TINY, image_condition_type="concat"),
                     device="meta")
    # the tiny model's own STA tile: sta_batched in both packages
    small = {**ATTN, "sta_tile": (2, 2, 2)}
    want = jmodel(*_args(inputs, 500.0, True), attn_cfg=JaxAttentionConfig(**small),
                  routing_mode="hard", interpret=True)
    with torch.no_grad():
        got = tmodel(*args, attn_cfg=AttentionConfig(**small), routing_mode="hard")
    _close(got.sample, want.sample)


def test_routed_sampling_matches_jax(models, inputs):
    """2 Euler steps with embedded guidance, routed hard in every forward."""
    jmodel, tmodel, _ = models
    latents, text, mask, pooled = inputs
    kw = dict(num_inference_steps=2, guidance_scale=6.0, flow_shift=7.0, routing_mode="hard")
    ref = JaxPipeline(jmodel, attn_cfg=JaxAttentionConfig(**ATTN), interpret=True)(
        jnp.asarray(latents), jnp.asarray(text), jnp.asarray(mask), jnp.asarray(pooled),
        sampling=JaxSamplingConfig(**kw))
    routing = []
    got = HunyuanT2VPipeline(tmodel, attn_cfg=AttentionConfig(**ATTN))(
        torch.from_numpy(latents), torch.from_numpy(text), torch.from_numpy(mask),
        torch.from_numpy(pooled), sampling=HunyuanSamplingConfig(**kw), routing=routing)
    _close(got, ref)
    assert len(routing) == 2  # one forward per step: embedded guidance


@pytest.mark.parametrize("scheduler", ["euler", "unipc"])
def test_true_cfg_batch_equals_sequential(models, inputs, scheduler):
    """true_cfg_scale > 1 adds the CFG pair; one batch-2 forward per step
    gives the sequential pair's result, 4 forwards' routing in 2 tables."""
    _, tmodel, _ = models
    latents, text, mask, pooled = (torch.from_numpy(x) for x in inputs)
    pipe = HunyuanT2VPipeline(tmodel, attn_cfg=AttentionConfig(**ATTN))
    outs, tables = [], []
    for cfg_batch in (False, True):
        routing = []
        kw = dict(num_inference_steps=2, true_cfg_scale=3.0, cfg_batch=cfg_batch,
                  routing_mode="hard", scheduler=scheduler)
        outs.append(pipe(latents, text, mask, pooled, negative_text_states=0.5 * text,
                         sampling=HunyuanSamplingConfig(**kw), routing=routing))
        tables.append(len(routing))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    assert tables == [4, 2]
    plain = pipe(latents, text, mask, pooled,
                 sampling=HunyuanSamplingConfig(num_inference_steps=2, routing_mode="hard",
                                                scheduler=scheduler))
    assert not torch.allclose(plain, outs[0])


def test_cli_samples_hunyuan_tiny_on_the_cpu(tmp_path, capsys):
    """--native_attention and hard routing (sta_batched) at the tiny model's
    own geometry, --random_embeds marking every text token valid as the JAX
    CLI does; hard routing at a window-dense geometry from --resume_dir's
    config.json."""
    from vorta_tpu_torch.cli.sample import main

    base = ["--model", "hunyuan-tiny", "--device", "cpu", "--random_embeds", "--dtype", "fp32",
            "--num_frames", "13", "--height", "96", "--width", "256",
            "--num_inference_steps", "2"]
    res = main(base + ["--native_attention", "--output", str(tmp_path / "off.npy")])
    assert res.routing == [] and np.load(tmp_path / "off.npy").shape == (1, 4, 12, 32, 16)
    printed = capsys.readouterr().out
    assert "routing=off" in printed and "24 of 24 text tokens valid" in printed
    res = main(base + ["--output", str(tmp_path / "own.npy")])
    assert len(res.routing) == 2 and np.isfinite(np.load(tmp_path / "own.npy")).all()

    (tmp_path / "config.json").write_text(json.dumps(ATTN))
    res = main(base + ["--resume_dir", str(tmp_path), "--output", str(tmp_path / "hard.npy")])
    arr = np.load(tmp_path / "hard.npy")
    assert arr.shape == (1, 4, 12, 32, 16) and np.isfinite(arr).all()
    assert len(res.routing) == 2 and all(r.shape == (4, 2) for r in res.routing)
    assert "routing=hard" in capsys.readouterr().out
