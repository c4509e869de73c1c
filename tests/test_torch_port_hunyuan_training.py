"""HunyuanVideo router training in the port against the JAX package, on the
CPU: one whole HUNYUAN_TINY train step (its loss terms, the router
gradients and the routers after one AdamW step) against JAX's
``make_hunyuan_router_train_step``, remat on and off, the teacher's
``off_ref`` joint attention, the chunked attention's recompute backward
against autograd through its loop, the router state both ways between the
packages, ``frozen_sharding_specs``, the dataset's prompt mask, and the
trainer CLI through a step dir into the sampler.

Weights: the JAX model's, drawn from numpy (port_assets/random_jax.py),
carried across by io/from_jax; the JAX step's draws (timesteps, sigmas,
noise) are remade here and handed to the port, whose loss takes them
explicitly.  The JAX side's joint attention runs the plain references it
trains through (no Pallas call at this head dim), jitted.  Tolerances, f32
on both sides: rtol 1e-4 and atol 1e-4 x scale (XLA-CPU and PyTorch sum in
other orders, through 4 blocks and their backward); the recompute backward
against autograd through the same loop 1e-5 (the same products, other
sums); the data exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from port_assets.random_jax import random_module
from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.models import hunyuan as jhunyuan
from vorta_tpu.ops import joint_experts as jjoint
from vorta_tpu.schedulers.flow_match import train_sigmas as jax_train_sigmas
from vorta_tpu.training import sampling as jax_sampling
from vorta_tpu.training.data import LatentDataset as JaxLatentDataset
from vorta_tpu.training.step import LossWeights as JaxLossWeights
from vorta_tpu.training.step import frozen_sharding_specs as jax_frozen_specs
from vorta_tpu.training.step import make_hunyuan_router_train_step as jax_make_step
from vorta_tpu.training.step import make_optimizer as jax_make_optimizer
from vorta_tpu.training.step import router_partition as jax_router_partition
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.io.from_jax import (
    _flat_to_state,
    hunyuan_state_from_jax,
    load_jax_params,
    router_state_to_jax,
)
from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanModel
from vorta_tpu_torch.ops import joint_experts as joint
from vorta_tpu_torch.ops.attention_ref import attention_chunked, attention_chunked_recompute
from vorta_tpu_torch.training.data import LatentDataset
from vorta_tpu_torch.training.step import (
    LossWeights,
    MultiSteps,
    frozen_sharding_specs,
    make_hunyuan_router_train_step,
    make_optimizer,
    router_partition,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JAX trainer's hunyuan-tiny geometry (cli/train.py)
ATTN = dict(latent_shape=(4, 4, 8), sta_window=(3, 3, 3), sta_tile=(2, 2, 2),
            lowres_window=(2, 2, 2), block_q=32, block_kv=32, sta_block_q=8, sta_block_kv=8)
LATENTS = (2, 4, 8, 16, 16)  # patch (1, 2, 2): the (4, 4, 8) grid
VALID = 17  # valid text tokens of 24
STACKS = {"dual_blocks": HUNYUAN_TINY.dual_layers, "single_blocks": HUNYUAN_TINY.single_layers}


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * max(np.abs(want).max(), 1e-30))


def _flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step on HUNYUAN_TINY (jit): its inputs, its draws, its
    metrics, the gradients its AdamW took in (first moment / (1 - b1)) and
    its updated routers."""
    model = random_module(lambda: jhunyuan.HunyuanModel(jhunyuan.HUNYUAN_TINY, rngs=nnx.Rngs(0)),
                          seed=31)
    state = _flat(nnx.state(model))
    graphdef, router_state, frozen_state = jax_router_partition(model)
    sig = jax_train_sigmas(shift=3.0)
    opt = jax_make_optimizer(lr=1e-2, max_grad_norm=1e6)  # no clipping: mu is the gradient
    step = jax_make_step(graphdef, JaxAttentionConfig(**ATTN), opt,
                         weights=JaxLossWeights(hidden_layer_distill=1.0),
                         timestep_table=sig * 1000.0, sigma_table=sig, interpret=True)
    rng = np.random.default_rng(32)
    cfg = HUNYUAN_TINY
    latents = rng.standard_normal(LATENTS).astype(np.float32)
    text = rng.standard_normal((2, cfg.text_len, cfg.text_dim)).astype(np.float32)
    mask = np.broadcast_to(np.arange(cfg.text_len) < VALID, (2, cfg.text_len)).copy()
    pooled = rng.standard_normal((2, cfg.pooled_dim)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    new_router, opt_state, metrics = jax.jit(step)(
        router_state, frozen_state, opt.init(router_state),
        *(jnp.asarray(x) for x in (latents, text, mask, pooled)), key)
    # the draws of JAX's loss function, remade here for the port
    k_t, k_eps = jax.random.split(key)
    t, s = jax_sampling.sample_timesteps(k_t, 2, jnp.asarray(sig * 1000.0), jnp.asarray(sig))
    eps = jax.random.normal(k_eps, latents.shape, jnp.float32)
    mu = _flat(opt_state[1][0].mu)
    return dict(state=state, sig=sig, batch=(latents, text, mask, pooled),
                draws=tuple(torch.from_numpy(np.asarray(x)) for x in (t, s, eps)),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=_flat_to_state({k: v / 0.1 for k, v in mu.items()}, STACKS),
                router=_flat_to_state(_flat(new_router), STACKS))


def _port_model(state):
    model = HunyuanModel(HUNYUAN_TINY, dtype=torch.float32, device="cpu")
    model.load_state_dict(hunyuan_state_from_jax(state, HUNYUAN_TINY))
    return model


def _step(sig, remat=True):
    return make_hunyuan_router_train_step(
        AttentionConfig(**ATTN), LossWeights(hidden_layer_distill=1.0),
        timestep_table=sig * 1000.0, sigma_table=sig, remat_blocks=remat)


def _batch(jax_step):
    return [torch.from_numpy(x) for x in jax_step["batch"]]


def test_train_step_matches_jax(jax_step):
    """The loss and its parts, the router gradients, the micro-step's grad
    norm and the routers after one AdamW step equal JAX's, from the same
    weights, batch and draws (guidance 1000 on both sides)."""
    model = _port_model(jax_step["state"])
    routers = router_partition(model)
    assert set(routers) == set(jax_step["router"])
    step = _step(jax_step["sig"])
    share, _ = step.loss(model, *_batch(jax_step), *jax_step["draws"])
    grads = torch.autograd.grad(share, list(routers.values()))
    for name, g in zip(routers, grads):
        _close(g, jax_step["grads"][name].numpy(), rtol=1e-3, atol_rel=1e-3)
    opt = MultiSteps(make_optimizer(routers, lr=1e-2, max_grad_norm=1e6), 1)
    metrics = step.step_with(model, opt, *_batch(jax_step), *jax_step["draws"])
    want = jax_step["metrics"]
    for name in ("loss", "l_fm", "l_reg", "l_last", "l_hidden", "grad_norm", "timestep"):
        np.testing.assert_allclose(float(metrics[name]), want[name], rtol=1e-4, err_msg=name)
    assert want["l_last"] > 0 and want["l_hidden"] > 0
    for name, p in routers.items():
        _close(p, jax_step["router"][name].numpy())


def test_remat_changes_nothing(jax_step):
    """Per-block recompute gives the same loss and router gradients as
    keeping the activations."""
    model = _port_model(jax_step["state"])
    routers = router_partition(model)
    out = []
    for remat in (False, True):
        share, _ = _step(jax_step["sig"], remat).loss(model, *_batch(jax_step),
                                                      *jax_step["draws"])
        out.append((share, torch.autograd.grad(share, list(routers.values()))))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)


def test_off_ref_matches_jax():
    """The teacher's joint attention, full attention through the plain
    version, with a padded text mask: JAX's off_ref, and the port's off
    (the kernel path's plain version) agree with it."""
    cfg = AttentionConfig(**ATTN)
    jcfg = joint.JointConfig(cfg, 24)
    rng = np.random.default_rng(33)
    arrs = [rng.standard_normal((2, 2, n, 64)).astype(np.float32)
            for n in (cfg.seq_len,) * 3 + (24,) * 3]
    mask = np.broadcast_to(np.arange(24) < VALID, (2, 24)).copy()
    want = jjoint.routed_joint_attention(
        *(jnp.asarray(a) for a in arrs), None, jnp.asarray(mask),
        jjoint.JointConfig(JaxAttentionConfig(**ATTN), 24), mode="off_ref")
    args = [torch.from_numpy(a) for a in arrs]
    for mode in ("off_ref", "off"):
        got = joint.routed_joint_attention(*args, None, torch.from_numpy(mask), jcfg, mode=mode)
        for g, w in zip(got, want):
            _close(g, w)
    assert "off_ref" in joint.MODES


@pytest.mark.parametrize("case", ["dense", "block_mask", "bias_valid_len", "masked_row"])
def test_chunked_recompute_backward_matches_autograd(case):
    """attention_chunked_recompute: the same forward, bit for bit, and the
    gradients of q, k and v of autograd through the loop, with block masks,
    an additive kv bias, a valid length and a q block that sees no key (its
    rows zero, their gradients zero)."""
    g = torch.Generator().manual_seed(34)
    b, h, s, d, blk = 2, 3, 96, 16, 32
    q, k, v = (torch.randn((b, h, s, d), generator=g).requires_grad_() for _ in range(3))
    kw = dict(block_q=blk, block_kv=blk)
    if case == "block_mask":
        kw["block_mask"] = torch.rand((h, 3, 3), generator=g) < 0.6
        kw["block_mask"][:, :, 0] = True
    elif case == "bias_valid_len":
        bias = torch.zeros((b, s))
        bias[:, 70:80] = -1e30
        kw.update(kv_bias=bias, kv_valid_len=90)
    elif case == "masked_row":
        kw["block_mask"] = torch.ones((h, 3, 3), dtype=torch.bool)
        kw["block_mask"][1, 2] = False  # head 1's last q block sees nothing
    want = attention_chunked(q, k, v, **kw)
    got = attention_chunked_recompute(q, k, v, **kw)
    assert torch.equal(got, want)
    cot = torch.randn(want.shape, generator=g)
    gw = torch.autograd.grad(want, (q, k, v), cot)
    gg = torch.autograd.grad(got, (q, k, v), cot)
    for a, w in zip(gg, gw):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5 * w.abs().max().item())
    if case == "masked_row":
        assert not got[:, 1, 2 * blk:].any() and not gg[0][:, 1, 2 * blk:].any()


def test_router_state_maps_both_ways(jax_step):
    """The port's routers (a step dir's) as the JAX package's stacked arrays,
    and back through load_jax_params."""
    model = _port_model(jax_step["state"])
    routers = router_partition(model)
    flat = router_state_to_jax(routers)
    assert set(flat) == {f"['{st}']['router']['linear']['{leaf}'].value"
                         for st in STACKS for leaf in ("kernel", "bias")}
    for key, arr in flat.items():
        np.testing.assert_array_equal(arr, jax_step["state"][key])
    other = HunyuanModel(HUNYUAN_TINY, device="cpu", seed=5)
    load_jax_params(other, flat)
    for name, p in router_partition(other).items():
        assert torch.equal(p, routers[name])
    with pytest.raises(KeyError):
        router_state_to_jax({"dual_blocks.1.router.linear.weight": routers[
            "dual_blocks.1.router.linear.weight"]})


def test_frozen_sharding_specs_match_jax(jax_step):
    """The stacks shard by layer, the refiner and the embedders stay
    replicated, in both packages; the routers are not frozen."""
    model = random_module(lambda: jhunyuan.HunyuanModel(jhunyuan.HUNYUAN_TINY,
                                                        rngs=nnx.Rngs(0)), seed=31)
    _, _, frozen = jax_router_partition(model)
    specs = _flat(jax.tree.map(lambda s: len(s) > 0, jax_frozen_specs(frozen, "dp"),
                               is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    want = {k.split("'")[1]: bool(v) for k, v in specs.items()}
    got = frozen_sharding_specs(_port_model(jax_step["state"]))
    assert not any("router" in n for n in got)
    assert {n.split(".")[0]: v for n, v in got.items()} == want
    assert want["dual_blocks"] and want["single_blocks"] and not want["context_embedder"]


def test_latent_dataset_prompt_mask(tmp_path):
    """LatentDataset with prompt_attention_mask files, and collate's masks,
    as JAX's (cfg dropout keeps the first token)."""
    rng = np.random.default_rng(35)
    items = []
    for sub in ("latent", "prompt_embed", "prompt_attention_mask"):
        (tmp_path / sub).mkdir()
    for i in range(3):
        torch.save(torch.from_numpy(rng.standard_normal((16, 6, 4, 4)).astype(np.float32)),
                   tmp_path / "latent" / f"{i}.pt")
        torch.save(torch.from_numpy(rng.standard_normal((24, 48)).astype(np.float32)),
                   tmp_path / "prompt_embed" / f"{i}.pt")
        torch.save(torch.arange(24) < 10 + i, tmp_path / "prompt_attention_mask" / f"{i}.pt")
        items.append({"latent_path": f"{i}.pt", "prompt_embed_path": f"{i}.pt",
                      "prompt_attention_mask": f"{i}.pt"})
    (tmp_path / "m.json").write_text(json.dumps(items))
    for cfg_rate in (0.0, 1.0):
        ours = LatentDataset(str(tmp_path / "m.json"), 4, cfg_rate=cfg_rate, seed=1)
        ref = JaxLatentDataset(str(tmp_path / "m.json"), 4, cfg_rate=cfg_rate, seed=1)
        got = LatentDataset.collate([ours[i] for i in range(3)])
        want = JaxLatentDataset.collate([ref[i] for i in range(3)])
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)
        assert got[2].shape == (3, 24)
    assert got[2][:, 0].all() and not got[2][:, 1:].any()


def test_cli_trains_hunyuan_and_samples_from_its_step_dir(tmp_path, monkeypatch):
    """cli.train --model hunyuan-tiny (synthetic batches with the text mask
    and pooled embedding), 2 steps then resumed for a third; cli.sample
    --router_checkpoint <step dir> serves those routers."""
    from vorta_tpu_torch.cli import sample
    from vorta_tpu_torch.cli.train import main as train

    base = ["--model", "hunyuan-tiny", "--device", "cpu", "--dtype", "fp32", "--synthetic_data",
            "--gradient_accumulation_steps", "1", "--output_dir", str(tmp_path / "exp")]
    first = train(base + ["--max_train_steps", "2"])
    second = train(base + ["--max_train_steps", "3", "--resume_from_checkpoint", "latest"])
    assert (first.final_step, second.init_step, second.final_step) == (2, 2, 3)
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0
               for m in first.metrics + second.metrics)
    for name, p in first.router_final.items():
        assert torch.equal(second.router_init[name], p)
    assert AttentionConfig.load(tmp_path / "exp" / "config.json") == AttentionConfig(
        **{**ATTN, "tau_sparse": 0.3})
    seen = {}
    real = sample.apply_router_state

    def spy(model, state):
        real(model, state)
        seen["routers"] = router_partition(model)

    monkeypatch.setattr(sample, "apply_router_state", spy)
    ckpt = tmp_path / "exp" / "ckpt" / "step-000003"
    out = sample.main(["--model", "hunyuan-tiny", "--device", "cpu", "--dtype", "fp32",
                       "--random_embeds", "--num_frames", "13", "--height", "64", "--width",
                       "128", "--num_inference_steps", "2", "--resume_dir",
                       str(tmp_path / "exp"), "--router_checkpoint", str(ckpt),
                       "--output", str(tmp_path / "s.npy")])
    assert np.isfinite(out.latents.numpy()).all() and out.routing
    for name, p in second.router_final.items():
        assert torch.equal(seen["routers"][name].detach(), p)
