"""The port's Wan model, sampler and CLI against the JAX package, on the CPU,
routing off and routed (soft, hard_ref, hard).

One WanModel at `__graft_entry__._demo_model`'s config (dim 512, 4 heads x 128,
2 layers, text_len 16; head dim 128 makes the JAX side take its fused
prologue) carries its weights to the port through io/from_jax.py.  Its
routers' biases are one-hot logits, so hard routing sends the heads to all
three experts.  Latents, prompt embeddings and noise come from numpy and go
to both sides.  JAX runs its Pallas kernels in interpret mode.

Tolerance: f32 on both sides, rtol 1e-4 and atol 1e-4 x the output's scale
(its max abs value): XLA-CPU and PyTorch sum in different orders, and the
differences grow through 2 blocks and the sampler's steps.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.config import WanModelConfig as JaxWanModelConfig
from vorta_tpu.models.wan import WanModel as JaxWanModel
from vorta_tpu.ops import routed_fused as jrouted
from vorta_tpu.pipelines.wan_t2v import SamplingConfig as JaxSamplingConfig
from vorta_tpu.pipelines.wan_t2v import WanT2VPipeline as JaxPipeline
from vorta_tpu_torch.config import AttentionConfig, WanModelConfig
from vorta_tpu_torch.io.from_jax import wan_state_from_jax
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


CFG = dict(dim=512, ffn_dim=1024, num_heads=4, head_dim=128, num_layers=2,
           text_dim=64, text_len=16, freq_dim=64)
ATTN = dict(latent_shape=(4, 8, 8), block_q=64, block_kv=64)
# the JAX CLI's wan-tiny geometry: 8-token STA tiles, 2x2x2 lowres windows
ATTN_ROUTED = dict(latent_shape=(4, 8, 8), sta_tile=(2, 2, 2), sta_window=(3, 3, 1),
                   lowres_window=(2, 2, 2), block_q=16, block_kv=16, sta_block_q=8,
                   sta_block_kv=8)
EXPERTS = [0, 1, 2, 2]  # FULL, LOWRES, STA, STA: the hard routing of every block
LATENT_SHAPE = (1, 4, 16, 16, 16)  # patch (1, 2, 2) -> token grid (4, 8, 8)


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    jmodel = JaxWanModel(JaxWanModelConfig(**CFG), dtype=jnp.float32, rngs=nnx.Rngs(0))
    bias = 4.0 * np.eye(3, dtype=np.float32)[EXPERTS].reshape(-1)
    jmodel.blocks.router.linear.bias.value = jnp.asarray(np.tile(bias, (CFG["num_layers"], 1)))
    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(jmodel))
    state = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}
    cfg = WanModelConfig(**CFG)
    tmodel = WanModel(cfg, dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(wan_state_from_jax(state, cfg))
    return jmodel, tmodel


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    latents = rng.standard_normal(LATENT_SHAPE).astype(np.float32)
    pe = rng.standard_normal((1, CFG["text_len"], CFG["text_dim"])).astype(np.float32)
    ne = rng.standard_normal((1, CFG["text_len"], CFG["text_dim"])).astype(np.float32)
    return latents, pe, ne


def test_from_jax_rejects_missing_and_extra_keys(models):
    jmodel, _ = models
    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(jmodel))
    state = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}
    cfg = WanModelConfig(**CFG)
    some = next(iter(state))
    with pytest.raises(KeyError):
        wan_state_from_jax({k: v for k, v in state.items() if k != some}, cfg)
    with pytest.raises(KeyError):
        wan_state_from_jax({**state, "['extra']['kernel'].value": np.zeros((2, 2))}, cfg)


def test_forward_matches_jax(models, inputs):
    jmodel, tmodel = models
    latents, pe, _ = inputs
    t = np.asarray([700.0], np.float32)
    ref = jmodel(jnp.asarray(latents), jnp.asarray(t), jnp.asarray(pe),
                 attn_cfg=JaxAttentionConfig(**ATTN), routing_mode="off",
                 interpret=True).sample
    with torch.no_grad():
        got = tmodel(torch.from_numpy(latents), torch.from_numpy(t), torch.from_numpy(pe),
                     attn_cfg=AttentionConfig(**ATTN), routing_mode="off").sample
    _close(got, ref)


def test_forward_unfused_prologue_matches_fused(models, inputs, monkeypatch):
    from vorta_tpu_torch.ops import prologue

    _, tmodel = models
    latents, pe, _ = inputs
    args = (torch.from_numpy(latents), torch.tensor([300.0]), torch.from_numpy(pe))
    with torch.no_grad():
        fused = tmodel(*args, attn_cfg=AttentionConfig(**ATTN)).sample
        monkeypatch.setattr(prologue, "_PROLOGUE_MODE", "off")
        unfused = tmodel(*args, attn_cfg=AttentionConfig(**ATTN)).sample
    torch.testing.assert_close(fused, unfused, rtol=1e-5, atol=1e-5)


def test_routed_modes_raise(models, inputs):
    """An unknown routing mode raises, and hard routing raises the JAX
    package's ValueError where its STA tables refuse the tile (12 tokens, not
    a multiple of 8)."""
    _, tmodel = models
    latents, pe, _ = inputs
    args = (torch.from_numpy(latents), torch.tensor([1.0]), torch.from_numpy(pe))
    with pytest.raises(ValueError, match="routing mode"):
        tmodel(*args, attn_cfg=AttentionConfig(**ATTN_ROUTED), routing_mode="sparse")
    bad = {**ATTN_ROUTED, "sta_tile": (3, 2, 2)}
    with pytest.raises(ValueError, match="tokens_per_tile 12 must be a multiple of 8"):
        jrouted.routed_geometry(JaxAttentionConfig(**bad))
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="tokens_per_tile 12 must be a multiple of 8"):
        tmodel(*args, attn_cfg=AttentionConfig(**bad), routing_mode="hard")


@pytest.mark.parametrize("mode", ["soft", "hard_ref", "hard"])
def test_routed_forward_matches_jax(models, inputs, mode):
    jmodel, tmodel = models
    latents, pe, _ = inputs
    t = np.asarray([700.0], np.float32)
    ref = jmodel(jnp.asarray(latents), jnp.asarray(t), jnp.asarray(pe),
                 attn_cfg=JaxAttentionConfig(**ATTN_ROUTED), routing_mode=mode,
                 return_scores=True, interpret=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(latents), torch.from_numpy(t), torch.from_numpy(pe),
                     attn_cfg=AttentionConfig(**ATTN_ROUTED), routing_mode=mode,
                     return_scores=True)
    _close(got.routing_scores, ref.routing_scores)
    _close(got.sample, ref.sample)
    if mode == "hard":
        assert (got.expert_ids == np.asarray(EXPERTS)).all()
    else:
        assert got.expert_ids is None


def test_soft_routing_takes_the_unfused_prologue(models, inputs, monkeypatch):
    """Soft routing (the training formulation) keeps the unfused ops, as the
    JAX gate does; hard routing and routing off take the fused prologue."""
    from vorta_tpu_torch.models import wan as wan_module
    from vorta_tpu_torch.ops.prologue import use_fused_prologue

    assert not use_fused_prologue("soft", 256, 512, 4)
    assert use_fused_prologue("hard", 256, 512, 4) and use_fused_prologue("off", 256, 512, 4)
    _, tmodel = models
    latents, pe, _ = inputs
    calls = []
    real = wan_module.fused_qk_prologue
    monkeypatch.setattr(wan_module, "fused_qk_prologue",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    args = (torch.from_numpy(latents), torch.tensor([500.0]), torch.from_numpy(pe))
    with torch.no_grad():
        tmodel(*args, attn_cfg=AttentionConfig(**ATTN_ROUTED), routing_mode="soft")
        assert not calls
        tmodel(*args, attn_cfg=AttentionConfig(**ATTN_ROUTED), routing_mode="hard")
    assert len(calls) == CFG["num_layers"]


@pytest.mark.parametrize("cfg_batch", [False, True])
def test_routed_sampling_matches_jax(models, inputs, cfg_batch):
    """2 UniPC steps with CFG, routed hard in every forward."""
    jmodel, tmodel = models
    latents, pe, ne = inputs
    kw = dict(num_inference_steps=2, guidance_scale=5.0, scheduler="unipc",
              cfg_batch=cfg_batch, routing_mode="hard")
    ref, _ = JaxPipeline(jmodel, attn_cfg=JaxAttentionConfig(**ATTN_ROUTED), interpret=True)(
        jnp.asarray(latents), jnp.asarray(pe), jnp.asarray(ne),
        sampling=JaxSamplingConfig(**kw))
    routing = []
    got = WanT2VPipeline(tmodel, attn_cfg=AttentionConfig(**ATTN_ROUTED))(
        torch.from_numpy(latents), torch.from_numpy(pe), torch.from_numpy(ne),
        sampling=SamplingConfig(**kw), routing=routing)
    _close(got, ref)
    assert len(routing) == (2 if cfg_batch else 4)  # one table per forward
    assert all((r == np.asarray(EXPERTS)).all() for r in routing)


@pytest.mark.parametrize("cfg_batch", [False, True])
@pytest.mark.parametrize("scheduler", ["unipc", "euler"])
def test_sampling_matches_jax(models, inputs, scheduler, cfg_batch):
    jmodel, tmodel = models
    latents, pe, ne = inputs
    kw = dict(num_inference_steps=2, guidance_scale=5.0, scheduler=scheduler,
              cfg_batch=cfg_batch, routing_mode="off")
    ref, _ = JaxPipeline(jmodel, attn_cfg=JaxAttentionConfig(**ATTN), interpret=True)(
        jnp.asarray(latents), jnp.asarray(pe), jnp.asarray(ne),
        sampling=JaxSamplingConfig(**kw))
    got = WanT2VPipeline(tmodel, attn_cfg=AttentionConfig(**ATTN))(
        torch.from_numpy(latents), torch.from_numpy(pe), torch.from_numpy(ne),
        sampling=SamplingConfig(**kw))
    _close(got, ref)


def test_rope_tables_match_jax():
    from vorta_tpu.ops.rope import permute_qk_to_half as jax_perm
    from vorta_tpu.ops.rope import rope_cos_sin as jax_rope
    from vorta_tpu_torch.ops.rope import permute_qk_to_half, rope_cos_sin

    for grid, d in (((6, 30, 52), 128), ((4, 8, 8), 64)):
        for got, want in zip(rope_cos_sin(grid, d), jax_rope(grid, d)):
            np.testing.assert_array_equal(got, want)
    w = np.arange(2 * 256, dtype=np.float32).reshape(2, 256)
    np.testing.assert_array_equal(permute_qk_to_half(w, 128), jax_perm(w, 128))


def test_schedules_match_jax():
    from vorta_tpu.schedulers.flow_match import FlowMatchEulerSchedule as JaxEuler
    from vorta_tpu.schedulers.unipc import UniPCSchedule as JaxUniPC
    from vorta_tpu_torch.schedulers.flow_match import FlowMatchEulerSchedule
    from vorta_tpu_torch.schedulers.unipc import UniPCSchedule

    for n, shift in ((2, 5.0), (50, 5.0), (20, 7.0)):
        for ours, theirs in ((UniPCSchedule, JaxUniPC), (FlowMatchEulerSchedule, JaxEuler)):
            a, b = ours.create(n, shift), theirs.create(n, shift)
            np.testing.assert_array_equal(a.sigmas, b.sigmas)
            np.testing.assert_array_equal(a.timesteps, b.timesteps)


def test_unipc_step_matches_jax():
    """Several steps of the multistep update on arrays alone (order 1, order
    2 corrector and predictor, lower-order final)."""
    from vorta_tpu.schedulers.unipc import UniPCSchedule as JaxUniPC
    from vorta_tpu.schedulers.unipc import unipc_sample_step as jax_step
    from vorta_tpu_torch.schedulers.unipc import unipc_sample_step

    n = 5
    sig = JaxUniPC.create(n, 5.0).sigmas
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    vs = [rng.standard_normal((3, 8)).astype(np.float32) for _ in range(n)]
    jc = (jnp.asarray(x), jnp.zeros((3, 8)), jnp.zeros((3, 8)), jnp.asarray(x))
    tc = (torch.from_numpy(x), torch.zeros(3, 8), torch.zeros(3, 8), torch.from_numpy(x))
    for i in range(n):
        xj, mj, m2j, xpj = jc
        a, b, c = jax_step(xj, jnp.asarray(vs[i]), i, jnp.asarray(sig), mj, xpj, n, m_prev2=m2j)
        jc = (a, b, mj, c)
        xt, mt, m2t, xpt = tc
        a2, b2, c2 = unipc_sample_step(xt, torch.from_numpy(vs[i]), i, sig, mt, xpt, n,
                                       m_prev2=m2t)
        tc = (a2, b2, mt, c2)
        _close(tc[0], jc[0], rtol=1e-5, atol_rel=1e-5)


def test_cli_writes_latents_of_the_jax_shape(tmp_path):
    from vorta_tpu.config import WAN_TINY as JAX_TINY
    from vorta_tpu_torch.cli.sample import main

    out = tmp_path / "tiny.npy"
    res = main(["--model", "wan-tiny", "--native_attention", "--random_embeds", "--device",
                "cpu", "--num_frames", "13", "--height", "64", "--width", "64",
                "--num_inference_steps", "2", "--output", str(out)])
    assert res.routing == []  # routing off
    arr = np.load(out)
    # the JAX pipeline's own latent shape for the same request
    jax_pipe = types.SimpleNamespace(model=types.SimpleNamespace(cfg=JAX_TINY))
    want = JaxPipeline.prepare_latents(jax_pipe, jax.random.PRNGKey(0), 1, 13, 64, 64).shape
    assert arr.shape == want
    assert np.isfinite(arr).all()


def test_cli_requires_native_attention(tmp_path, capsys):
    """Routing is off only with --native_attention: without it the CLI
    routes every head of every block hard, per forward (2 steps x CFG)."""
    from vorta_tpu_torch.cli.sample import main

    out = tmp_path / "tiny_routed.npy"
    res = main(["--model", "wan-tiny", "--device", "cpu", "--random_embeds",
                "--num_frames", "13", "--height", "64", "--width", "64",
                "--num_inference_steps", "2", "--output", str(out)])
    assert np.load(out).shape == (1, 4, 8, 8, 16) and np.isfinite(np.load(out)).all()
    assert len(res.routing) == 4 and all(r.shape == (2, 2) for r in res.routing)
    printed = capsys.readouterr().out
    assert "routing=hard" in printed and "heads routed over 4 forwards" in printed


def test_cli_takes_fp32_on_both_devices(monkeypatch):
    """--dtype fp32 is taken on both devices since the kernels' f32 modes:
    the flags parse with the card's default device, and without a card the run stops at the device
    check, not at an f32 refusal."""
    from vorta_tpu_torch.cli.sample import main, parse_args

    args = ["--native_attention", "--random_embeds", "--dtype", "fp32"]
    assert parse_args(args).device == "cuda"
    assert parse_args(["--dtype", "fp32", "--device", "cpu"]).dtype == "fp32"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)


def test_router_loader_matches_jax_loader(tmp_path):
    """io/from_jax.load_router_npz against bench.py's load_router_npz on a
    synthetic npz at the test config; a missing key or block raises."""
    from bench import load_router_npz as jax_load_router_npz
    from vorta_tpu.training.step import router_partition
    from vorta_tpu_torch.io.from_jax import ROUTER_KEYS, load_router_npz

    n, heads = CFG["num_layers"], CFG["num_heads"]
    rng = np.random.default_rng(11)
    arrays = {ROUTER_KEYS["weight"]: rng.standard_normal((n, CFG["dim"], heads * 3)),
              ROUTER_KEYS["bias"]: rng.standard_normal((n, heads * 3))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    np.savez(tmp_path / "router.npz", **arrays)
    jmodel = JaxWanModel(JaxWanModelConfig(**CFG), dtype=jnp.float32, rngs=nnx.Rngs(1))
    _, router_state, _ = router_partition(jmodel)
    merged = jax_load_router_npz(router_state, str(tmp_path / "router.npz"))
    flat, _ = jax.tree_util.tree_flatten_with_path(merged)
    jax_arrays = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}
    tmodel = WanModel(WanModelConfig(**CFG), device="cpu")
    load_router_npz(tmodel, tmp_path / "router.npz")
    for i, block in enumerate(tmodel.blocks):
        np.testing.assert_array_equal(block.router.linear.weight.detach().numpy(),
                                      jax_arrays[ROUTER_KEYS["weight"]][i].T)
        np.testing.assert_array_equal(block.router.linear.bias.detach().numpy(),
                                      jax_arrays[ROUTER_KEYS["bias"]][i])
    with pytest.raises(KeyError):
        load_router_npz(tmodel, {ROUTER_KEYS["weight"]: arrays[ROUTER_KEYS["weight"]]})
    with pytest.raises(ValueError, match="shape"):  # one block short
        load_router_npz(tmodel, {k: v[:1] for k, v in arrays.items()})


def test_router_asset_fits_wan_1_3b():
    """The JAX package's trained 720p router: its keys and shapes, loaded
    into a Wan-1.3B built on the meta device (no weights on the CPU)."""
    from pathlib import Path

    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.io.from_jax import ROUTER_KEYS, load_router_npz

    path = Path(__file__).resolve().parent.parent / "assets/bench_router_wan1_3b_720p_half.npz"
    data = np.load(path)
    assert sorted(data.files) == sorted(ROUTER_KEYS.values())
    assert data[ROUTER_KEYS["weight"]].shape == (30, 1536, 36)
    assert data[ROUTER_KEYS["bias"]].shape == (30, 36)
    load_router_npz(WanModel(WAN_1_3B, device="meta"), data)


@pytest.mark.parametrize("seed", [0, 3])
def test_time_embedder_export_matches_whole_model(seed):
    """port_assets/export_time_embedder.py draws the time embedder without
    building the model; a whole JAX WanModel from the same seed has it."""
    from port_assets.export_time_embedder import PREFIX, time_embedder_params

    cfg = JaxWanModelConfig(**CFG)
    jmodel = JaxWanModel(cfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
                         rngs=nnx.Rngs(seed))
    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(jmodel))
    whole = {jax.tree_util.keystr(p): np.asarray(leaf, np.float32) for p, leaf in flat
             if jax.tree_util.keystr(p).startswith(PREFIX)}
    got = time_embedder_params(cfg, seed)
    assert sorted(got) == sorted(whole) and len(got) == 4
    for key in got:
        np.testing.assert_array_equal(got[key], whole[key])


def test_time_embedder_loader_matches_jax(models, inputs):
    """io/from_jax.load_jax_params sets the named parameters and no others:
    the port's timestep embedding then equals the JAX model's; an unknown
    path or a wrong shape raises."""
    from port_assets.export_time_embedder import PREFIX, time_embedder_params
    from vorta_tpu_torch.io.from_jax import load_jax_params

    jmodel, tmodel = models
    cfg = WanModelConfig(**CFG)
    params = time_embedder_params(JaxWanModelConfig(**CFG), seed=9)
    rng = np.random.default_rng(9)
    for key in params:  # the drawn biases are 0, as the model's own are
        if key.endswith("['bias'].value"):
            params[key] = rng.standard_normal(params[key].shape).astype(np.float32)
    model = WanModel(cfg, device="cpu", seed=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_jax_params(model, params)
    after = model.state_dict()
    changed = sorted(k for k in after if not torch.equal(after[k], before[k]))
    assert changed == sorted(f"condition_embedder.time_embedder.linear_{i}.{p}"
                             for i in (1, 2) for p in ("weight", "bias"))
    embedder = nnx.clone(jmodel.condition_embedder)  # the fixture stays as it is
    for name in ("linear_1", "linear_2"):
        lin = getattr(embedder.time_embedder, name)
        lin.kernel.value = jnp.asarray(params[f"{PREFIX}['{name}']['kernel'].value"])
        lin.bias.value = jnp.asarray(params[f"{PREFIX}['{name}']['bias'].value"])
    t = np.asarray([500.0], np.float32)
    want = embedder(jnp.asarray(t), jnp.asarray(inputs[1]))[0]
    with torch.no_grad():
        got = model.condition_embedder(torch.from_numpy(t), torch.from_numpy(inputs[1]))[0]
    _close(got, want)
    with pytest.raises(KeyError):
        load_jax_params(model, {"['condition_embedder']['nothing']['kernel'].value":
                                np.zeros((2, 2), np.float32)})
    key = f"{PREFIX}['linear_2']['bias'].value"
    with pytest.raises(ValueError, match="condition_embedder.time_embedder.linear_2.bias"):
        load_jax_params(model, {key: np.zeros(3, np.float32)})


def test_trained_router_routes_as_the_jax_bench():
    """The committed time embedder (bench.py's model, nnx.Rngs(0)) is a fresh
    export, and with it the trained 720p router sends the port's heads
    where the JAX package sends them at t = 500: 0 FULL, 164 LOWRES, 196
    STA, the mix bench.py recorded (BENCH_r05.json)."""
    from pathlib import Path

    from torch import nn

    from port_assets.export_time_embedder import OUT, routing_heads, time_embedder_params
    from vorta_tpu.config import WAN_1_3B as JAX_WAN_1_3B
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.io.from_jax import load_jax_params, load_router_npz
    from vorta_tpu_torch.models.common import TimestepEmbedding, sinusoidal_timestep_embedding
    from vorta_tpu_torch.models.router import Router
    from vorta_tpu_torch.ops.routed_fused import route_expert_ids

    router = Path(__file__).resolve().parent.parent / "assets/bench_router_wan1_3b_720p_half.npz"
    committed = dict(np.load(OUT))
    fresh = time_embedder_params(JAX_WAN_1_3B)
    assert sorted(committed) == sorted(fresh)
    for key in fresh:
        np.testing.assert_array_equal(committed[key], fresh[key])
    load_jax_params(WanModel(WAN_1_3B, device="meta"), committed)  # names and shapes fit

    # the parameters of WanModel that routing reads, without the 1.3B blocks
    stub = nn.Module()
    stub.cfg = WAN_1_3B
    stub.condition_embedder = nn.Module()
    stub.condition_embedder.time_embedder = TimestepEmbedding(
        WAN_1_3B.freq_dim, WAN_1_3B.dim, dtype=torch.bfloat16, device="cpu")
    stub.blocks = nn.ModuleList(nn.Module() for _ in range(WAN_1_3B.num_layers))
    for block in stub.blocks:
        block.router = Router(WAN_1_3B.dim, WAN_1_3B.num_heads, device="cpu")
    load_jax_params(stub, OUT)
    load_router_npz(stub, router)
    with torch.no_grad():
        sin = sinusoidal_timestep_embedding(torch.tensor([500.0]), WAN_1_3B.freq_dim)
        temb = stub.condition_embedder.time_embedder(sin.to(torch.bfloat16))
        ids = torch.stack([route_expert_ids(b.router(temb), 0.3) for b in stub.blocks])
    heads = np.bincount(ids.numpy().reshape(-1), minlength=3)
    np.testing.assert_array_equal(heads, routing_heads(committed, router, 500.0, JAX_WAN_1_3B))
    np.testing.assert_array_equal(heads, [0, 164, 196])


def test_attention_config_json_roundtrip(tmp_path):
    cfg = dataclasses.replace(AttentionConfig(latent_shape=(6, 30, 52)), block_q=512)
    cfg.save(tmp_path / "config.json")
    assert AttentionConfig.load(tmp_path / "config.json") == cfg
    assert JaxAttentionConfig.from_json(cfg.to_json()).to_json() == cfg.to_json()
