"""The port's step cache (ops/stepcache.py, the models' ``step_cache`` and
the pipelines' ``cache_*``) against the JAX package, on the CPU.

One Wan model at test_torch_port_wan.py's config (dim 512, 4 heads x 128,
2 layers) and one HunyuanVideo-tiny carry their weights to the port
through io/from_jax.py; latents and embeddings come from numpy with a
seed.  Routing is off in the JAX runs (the cache adds nothing to the
routed dispatch, which tests/test_torch_port_wan.py holds); JAX runs its
Pallas kernels in interpret mode.

Tolerances: the cache's scalar functions within 1e-6 of JAX's (f32 on
both sides, summed in other orders); sampled latents as the port's other
model tests, rtol 1e-4 and atol 1e-4 x the output's scale; a cache that
never skips is held bit for bit to uncached sampling in the port itself.
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
from vorta_tpu.ops import stepcache as jsc
from vorta_tpu.pipelines.hunyuan_t2v import HunyuanSamplingConfig as JaxHySampling
from vorta_tpu.pipelines.hunyuan_t2v import HunyuanT2VPipeline as JaxHyPipeline
from vorta_tpu.pipelines.wan_t2v import SamplingConfig as JaxSamplingConfig
from vorta_tpu.pipelines.wan_t2v import WanT2VPipeline as JaxPipeline
from vorta_tpu.schedulers.flow_match import FlowMatchEulerSchedule as JaxEuler
from vorta_tpu_torch.config import AttentionConfig, WanModelConfig
from vorta_tpu_torch.io.from_jax import hunyuan_state_from_jax, wan_state_from_jax
from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanModel
from vorta_tpu_torch.models.wan import WanModel
from vorta_tpu_torch.ops import stepcache
from vorta_tpu_torch.pipelines.hunyuan_t2v import HunyuanSamplingConfig, HunyuanT2VPipeline
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
LATENT_SHAPE = (1, 4, 16, 16, 16)
HY_ATTN = dict(latent_shape=(4, 6, 16), sta_window=(3, 3, 3), sta_tile=(4, 6, 8),
               lowres_window=(2, 2, 2), block_q=32, block_kv=32)
HY_LATENT_SHAPE = (1, 4, 12, 32, 16)
STEPS = 6


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
    latents = rng.standard_normal(LATENT_SHAPE).astype(np.float32)
    pe = rng.standard_normal((1, CFG["text_len"], CFG["text_dim"])).astype(np.float32)
    ne = rng.standard_normal((1, CFG["text_len"], CFG["text_dim"])).astype(np.float32)
    return jmodel, tmodel, latents, pe, ne


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scalar_functions_match_jax(seed):
    """rel_l1, rescale (the repo's fitted polynomial and none) and
    cache_decision (the clamp at 0, forced computes, an invalid cache)."""
    rng = np.random.default_rng(seed)
    cur = rng.standard_normal((2, 24)).astype(np.float32)
    prev = rng.standard_normal((2, 24)).astype(np.float32)
    poly = tuple(float(c) for c in np.load("assets/cache_poly_wan1_3b_720p.npz")["coefficients"])
    want = float(jsc.rel_l1(jnp.asarray(cur), jnp.asarray(prev)))
    got = stepcache.rel_l1(torch.from_numpy(cur), torch.from_numpy(prev))
    assert got.dtype == torch.float32 and abs(float(got) - want) <= 1e-6 * abs(want)
    for coeffs in (None, poly, (-3.0, 0.5)):  # the last goes negative: clamped
        d = np.float32(rng.uniform(0.0, 0.3))
        w = float(jsc.rescale(jnp.float32(d), coeffs))
        g = float(stepcache.rescale(torch.tensor(d), coeffs))
        assert abs(g - w) <= 1e-6 * max(abs(w), 1.0)
        # small integers: both sides sum them exactly, so the decision sees
        # one distance (the fitted polynomial magnifies any rounding of it)
        icur = rng.integers(-3, 4, (2, 24)).astype(np.float32)
        iprev = rng.integers(-3, 4, (2, 24)).astype(np.float32)
        for valid in (False, True):
            for force in (None, False, True):
                acc = np.float32(rng.uniform(0.0, 0.2))
                jc = jsc.StepCache(jnp.asarray(iprev), jnp.zeros((2, 3, 4)), jnp.float32(acc),
                                   jnp.asarray(valid))
                tc = stepcache.StepCache(torch.from_numpy(iprev), torch.zeros((2, 3, 4)),
                                         torch.tensor(acc), torch.tensor(valid))
                jf = None if force is None else jnp.asarray(force)
                js, ja = jsc.cache_decision(jc, jnp.asarray(icur), 0.5, jf, coeffs)
                ts, ta = stepcache.cache_decision(tc, torch.from_numpy(icur), 0.5, force, coeffs)
                assert bool(ts) == bool(js)
                if force is not None:  # a () bool tensor: applied on its device, same decision
                    t2, a2 = stepcache.cache_decision(tc, torch.from_numpy(icur), 0.5,
                                                      torch.tensor(force), coeffs)
                    assert bool(t2) == bool(ts) and torch.equal(a2, ta)
                assert abs(float(ta) - float(ja)) <= 1e-6 * max(abs(float(ja)), 1.0)
                assert float(ta) >= acc  # clamped at 0: the sum never falls


@pytest.mark.parametrize("routing", ["off", "hard"])
@pytest.mark.parametrize("cfg_batch", [False, True])
def test_never_skipping_cache_is_bit_exact(wan, routing, cfg_batch):
    """Threshold 0 turns the cache off; a threshold no distance stays under
    keeps it on and computing: both give the uncached trajectory bit for
    bit (and routing still runs and is reported per forward)."""
    _, tmodel, latents, pe, ne = wan
    attn = AttentionConfig(**ATTN, sta_tile=(2, 2, 2), sta_window=(3, 3, 1),
                           lowres_window=(2, 2, 2), sta_block_q=8, sta_block_kv=8)
    pipe = WanT2VPipeline(tmodel, attn_cfg=attn)
    args = (torch.from_numpy(latents), torch.from_numpy(pe), torch.from_numpy(ne))
    base = SamplingConfig(num_inference_steps=3, routing_mode=routing, cfg_batch=cfg_batch)
    ref = pipe(*args, sampling=base)
    log = []
    off = pipe(*args, sampling=dataclasses.replace(base, cache_threshold=0.0), cache_log=log)
    assert torch.equal(off, ref) and log == []
    routing_ids = []
    on = pipe(*args, sampling=dataclasses.replace(base, cache_threshold=1e-12), cache_log=log,
              routing=routing_ids)
    assert torch.equal(on, ref)
    assert [s for *_, s in log] == [False] * (3 if cfg_batch else 6)
    assert len(routing_ids) == (len(log) if routing == "hard" else 0)


def _jax_skips(jmodel, pe, ne, threshold, warmup, coeffs, cfg_batch):
    """The JAX package's skip pattern, replayed by its own cache_decision on
    its model's temb6 at each step's timestep: [(step, arm, skipped)]."""
    sched = JaxEuler.create(STEPS, 5.0)
    arms = [jnp.concatenate([pe, ne])] if cfg_batch else [pe, ne]
    caches = [None] * len(arms)
    out = []
    for i, t in enumerate(sched.timesteps):
        force = jnp.asarray(i < warmup or i == STEPS - 1)
        for a, ctx in enumerate(arms):
            tt = jnp.full((ctx.shape[0],), t)
            _, temb6, _, _ = jmodel.condition_embedder(tt, ctx)
            ind = temb6.reshape(ctx.shape[0], -1).astype(jnp.float32)
            if caches[a] is None:
                caches[a] = jsc.init_step_cache(ctx.shape[0], 1, 1, ind.shape[1], jnp.float32)
            skip, acc = jsc.cache_decision(caches[a], ind, threshold, force, coeffs)
            skip = bool(skip)
            c = caches[a]
            caches[a] = (c._replace(prev_ind=ind, acc=acc) if skip else
                         c._replace(prev_ind=ind, acc=jnp.zeros((), jnp.float32),
                                    valid=jnp.ones((), bool)))
            out.append((i, a, skip))
    return out


@pytest.mark.parametrize("cfg_batch", [False, True])
def test_cached_sampling_matches_jax(wan, cfg_batch):
    """Euler, CFG 5, 6 steps, warm-up 1, the repo's fitted polynomial: the
    port's skip pattern is the JAX package's, some forwards computed and
    some skipped, and the cached latents match the JAX pipeline's."""
    jmodel, tmodel, latents, pe, ne = wan
    coeffs = tuple(float(c) for c in
                   np.load("assets/cache_poly_wan1_3b_720p.npz")["coefficients"])
    threshold = 1.0
    kw = dict(num_inference_steps=STEPS, guidance_scale=5.0, scheduler="euler",
              cfg_batch=cfg_batch, routing_mode="off", cache_threshold=threshold,
              cache_warmup=1, cache_coefficients=coeffs)
    want_log = _jax_skips(jmodel, jnp.asarray(pe), jnp.asarray(ne), threshold, 1, coeffs,
                          cfg_batch)
    skips = [s for *_, s in want_log]
    assert any(skips) and not all(skips), want_log
    ref, _ = JaxPipeline(jmodel, attn_cfg=JaxAttentionConfig(**ATTN), interpret=True)(
        jnp.asarray(latents), jnp.asarray(pe), jnp.asarray(ne),
        sampling=JaxSamplingConfig(**kw))
    log = []
    got = WanT2VPipeline(tmodel, attn_cfg=AttentionConfig(**ATTN))(
        torch.from_numpy(latents), torch.from_numpy(pe), torch.from_numpy(ne),
        sampling=SamplingConfig(**kw), cache_log=log)
    assert log == want_log
    _close(got, ref)
    # and the cache did change the trajectory
    plain = WanT2VPipeline(tmodel, attn_cfg=AttentionConfig(**ATTN))(
        torch.from_numpy(latents), torch.from_numpy(pe), torch.from_numpy(ne),
        sampling=SamplingConfig(**{**kw, "cache_threshold": 0.0}))
    assert not torch.equal(plain, got)


def test_stepper_matches_the_loop_and_refuses_uneven_chunks(wan):
    _, tmodel, latents, pe, ne = wan
    pipe = WanT2VPipeline(tmodel, attn_cfg=AttentionConfig(**ATTN))
    sampling = SamplingConfig(num_inference_steps=4, scheduler="unipc", cache_threshold=5.0)
    pe_t, ne_t = torch.from_numpy(pe), torch.from_numpy(ne)
    ref = pipe(torch.from_numpy(latents), pe_t, ne_t, sampling=sampling)
    init, step_fn, n = pipe.make_stepper(sampling, chunk=2)
    carry = init(torch.from_numpy(latents))
    for i in range(0, n, 2):
        carry = step_fn(carry, i, pe_t, ne_t)
    assert n == 4 and torch.equal(carry[0], ref)
    with pytest.raises(ValueError, match="chunk 3 must divide"):
        pipe.make_stepper(sampling, chunk=3)


def test_training_modes_raise_and_hidden_delta_probe(wan):
    """The cache is a serving mode (JAX's ValueError); the hidden_delta
    probe is the residual a computed step caches, and equals JAX's."""
    jmodel, tmodel, latents, pe, _ = wan
    cfg = tmodel.cfg
    args = (torch.from_numpy(latents), torch.tensor([500.0]), torch.from_numpy(pe))
    cache = stepcache.init_step_cache(1, 256, cfg.dim, 6 * cfg.dim, torch.float32)
    attn = AttentionConfig(**ATTN, sta_tile=(2, 2, 2), sta_window=(3, 3, 1),
                           lowres_window=(2, 2, 2), sta_block_q=8, sta_block_kv=8)
    for bad in (dict(return_losses=True, routing_mode="soft"), dict(calibrate_mm=True)):
        with pytest.raises(ValueError, match="serving mode"):
            tmodel(*args, attn_cfg=attn, step_cache=cache, cache_threshold=0.1, **bad)
    with torch.no_grad():
        probe = tmodel(*args, attn_cfg=AttentionConfig(**ATTN), return_hidden_delta=True)
        out = tmodel(*args, attn_cfg=AttentionConfig(**ATTN), step_cache=cache,
                     cache_threshold=0.1)
    assert out.cache_skipped is False and probe.temb_indicator.shape == (1, 6 * cfg.dim)
    assert torch.equal(out.step_cache.residual, probe.hidden_delta)
    assert torch.equal(out.step_cache.prev_ind, probe.temb_indicator)
    assert bool(out.step_cache.valid) and float(out.step_cache.acc) == 0.0
    want = jmodel(jnp.asarray(latents), jnp.asarray([500.0]), jnp.asarray(pe),
                  attn_cfg=JaxAttentionConfig(**ATTN), interpret=True,
                  return_hidden_delta=True)
    _close(probe.hidden_delta, want.hidden_delta)
    _close(probe.temb_indicator, want.temb_indicator, rtol=1e-5, atol_rel=1e-6)
    # a skipped forward: the cached delta on the new hidden state, no routing
    with torch.no_grad():
        skipped = tmodel(*args, attn_cfg=attn, routing_mode="hard", step_cache=out.step_cache,
                         cache_threshold=1e9, return_scores=True)
    assert skipped.cache_skipped is True and skipped.expert_ids is None
    # JAX's skipped step: zero scores of shape (L, B, H, E)
    assert skipped.routing_scores.shape == (cfg.num_layers, 1, cfg.num_heads, attn.num_experts)
    assert not skipped.routing_scores.any()
    assert torch.equal(skipped.step_cache.residual, out.step_cache.residual)


def test_hunyuan_cached_sampling_matches_jax():
    """HunyuanVideo-tiny, routing off, Euler: a cache that never skips is
    bit for bit the uncached run; one that skips every middle step matches
    the JAX pipeline's cached latents."""
    jmodel = jhunyuan.HunyuanModel(jhunyuan.HUNYUAN_TINY, rngs=nnx.Rngs(0))
    tmodel = HunyuanModel(HUNYUAN_TINY, dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(hunyuan_state_from_jax(_flat(nnx.state(jmodel)), HUNYUAN_TINY))
    rng = np.random.default_rng(1)
    cfg = HUNYUAN_TINY
    latents = rng.standard_normal(HY_LATENT_SHAPE).astype(np.float32)
    text = rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32)
    mask = (np.arange(cfg.text_len) < 17)[None]
    kw = dict(num_inference_steps=4, routing_mode="off", cache_warmup=1)
    pipe = HunyuanT2VPipeline(tmodel, attn_cfg=AttentionConfig(**HY_ATTN))
    targs = tuple(torch.from_numpy(a) for a in (latents, text, mask, pooled))
    plain = pipe(*targs, sampling=HunyuanSamplingConfig(**kw))
    log = []
    never = pipe(*targs, sampling=HunyuanSamplingConfig(**kw, cache_threshold=1e-12),
                 cache_log=log)
    assert torch.equal(never, plain) and [s for *_, s in log] == [False] * 4
    log = []
    got = pipe(*targs, sampling=HunyuanSamplingConfig(**kw, cache_threshold=1e9),
               cache_log=log)
    assert [s for *_, s in log] == [False, True, True, False]
    ref = JaxHyPipeline(jmodel, attn_cfg=JaxAttentionConfig(**HY_ATTN), interpret=True)(
        *(jnp.asarray(a) for a in (latents, text, mask, pooled)),
        sampling=JaxHySampling(**kw, cache_threshold=1e9))
    _close(got, ref)
    assert not torch.equal(got, plain)
    cache = stepcache.init_step_cache(1, 384, cfg.dim, cfg.dim, torch.float32)
    fargs = (*targs[:1], torch.tensor([500.0]), *targs[1:])
    with pytest.raises(ValueError, match="serving mode"):
        tmodel(*fargs, attn_cfg=AttentionConfig(**HY_ATTN), step_cache=cache, calibrate_mm=True)
    # a skipped routed forward: zero scores of shape (L, B, H, E), no routing
    with torch.no_grad():
        first = tmodel(*fargs, attn_cfg=AttentionConfig(**HY_ATTN), step_cache=cache,
                       cache_threshold=1e9)
        skipped = tmodel(*fargs, attn_cfg=AttentionConfig(**HY_ATTN), routing_mode="hard",
                         step_cache=first.step_cache, cache_threshold=1e9, return_scores=True)
    assert first.cache_skipped is False and skipped.cache_skipped is True
    assert skipped.expert_ids is None and not skipped.routing_scores.any()
    assert skipped.routing_scores.shape == (cfg.dual_layers + cfg.single_layers, 1,
                                            cfg.num_heads, 3)
