"""The port's router-distillation trainer against the JAX package on the CPU:
timestep sampling, the sigma table, the optimizer and its accumulation
wrapper against optax, one whole WAN_TINY train step (metrics and updated
routers) against JAX's ``make_router_train_step``, remat on and off, the
checkpoint layout, the dataset, the metrics record, the trainer CLI and a
train -> sample round trip.

Weights go across through ``io/from_jax``; JAX's random draws (timesteps,
sigmas, noise) are made in the test and handed to the port, whose loss takes
them explicitly.  JAX runs its Pallas kernels in interpret mode.
Tolerances, f32 on both sides: rtol 1e-4 and atol 1e-4 x scale (XLA-CPU and
PyTorch sum in different orders, through 2 blocks and their backward);
the optimizer's arithmetic is elementwise, so 1e-6 there.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from vorta_tpu.config import WAN_TINY as JAX_WAN_TINY
from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.models.wan import WanModel as JaxWanModel
from vorta_tpu.schedulers.flow_match import train_sigmas as jax_train_sigmas
from vorta_tpu.training import sampling as jax_sampling
from vorta_tpu.training.step import LossWeights as JaxLossWeights
from vorta_tpu.training.step import make_optimizer as jax_make_optimizer
from vorta_tpu.training.step import make_router_train_step as jax_make_step
from vorta_tpu.training.step import router_partition as jax_router_partition
from vorta_tpu_torch.config import WAN_TINY, AttentionConfig
from vorta_tpu_torch.io.from_jax import _flat_to_state, wan_state_from_jax
from vorta_tpu_torch.models.wan import WanModel
from vorta_tpu_torch.schedulers.flow_match import train_sigmas
from vorta_tpu_torch.training import sampling
from vorta_tpu_torch.training.step import (
    LossWeights,
    MultiSteps,
    make_optimizer,
    make_router_train_step,
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


ATTN = dict(latent_shape=(4, 4, 4), sta_window=(3, 3, 1), sta_tile=(2, 2, 2),
            lowres_window=(2, 2, 2), block_q=16, block_kv=16, sta_block_q=8, sta_block_kv=8)


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * max(np.abs(want).max(), 1e-30))


# --- sampling and schedules -------------------------------------------------------

def test_train_sigmas_match_jax():
    for shift in (3.0, 5.0):
        np.testing.assert_array_equal(train_sigmas(shift), jax_train_sigmas(shift))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_timesteps_match_jax(seed):
    """JAX's draws (u, interval) through the port's renormalize and table
    lookup give JAX's timesteps and sigmas; the port's own draws come from
    the table."""
    sig = jax_train_sigmas(3.0)
    tt = sig * 1000.0
    key = jax.random.PRNGKey(seed)
    ku, ki = jax.random.split(key)
    u = np.asarray(jax.random.uniform(ku, (4,)))
    interval = int(jax.random.randint(ki, (), 0, 5))
    want_t, want_s = jax_sampling.sample_timesteps(key, 4, jnp.asarray(tt), jnp.asarray(sig))
    np.testing.assert_allclose(
        sampling.renormalize_uniform(torch.from_numpy(u), interval).numpy(),
        np.asarray(jax_sampling.renormalize_uniform(jnp.asarray(u), jnp.asarray(interval))),
        rtol=1e-6)
    got_t, got_s = sampling.timesteps_from_uniform(
        sampling.renormalize_uniform(torch.from_numpy(u), interval), torch.from_numpy(tt),
        torch.from_numpy(sig))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    t, s = sampling.sample_timesteps(torch.Generator().manual_seed(seed), 8,
                                     torch.from_numpy(tt), torch.from_numpy(sig))
    assert all(np.isclose(tt, ti).any() for ti in t.numpy())
    np.testing.assert_array_equal(s.numpy(), sig[np.searchsorted(-tt, -t.numpy())])


@pytest.mark.parametrize("weights,t", [((1.0, (0.02, 20.0, 0.0)), 100.0),
                                       ((1.0, (0.02, 20.0, 0.0)), 800.0),
                                       ((1.0, (0.02, 20.0, 1.0)), 150.0),
                                       ((0.0, (0.02, 20.0, 0.0)), 100.0)])
def test_rebalance_loss_weights_match_jax(weights, t):
    dw, ows = sampling.rebalance_loss_weights(*weights, torch.tensor([t]))
    jdw, jows = jax_sampling.rebalance_loss_weights(*weights, jnp.asarray([t]))
    np.testing.assert_allclose([dw, *ows], [float(jdw), *map(float, jows)], rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_optimizer_matches_optax(schedule, k):
    """AdamW + clipping + schedule, and MultiSteps(k) accumulation, against
    optax.MultiSteps(chain(clip_by_global_norm, adamw)) over 6 optimizer
    steps; the gradients alternate small and large, so clipping triggers."""
    rng = np.random.default_rng(8)
    init = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule)
    jopt = optax.MultiSteps(jax_make_optimizer(**kw), k)
    jparams = {n: jnp.asarray(v) for n, v in init.items()}
    jstate = jopt.init(jparams)
    jupdate = jax.jit(lambda g, st, p: (lambda u, st2: (optax.apply_updates(p, u), st2))(
        *jopt.update(g, st, p)))
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in init.items()}
    opt = MultiSteps(make_optimizer(params, **kw), k)
    for i in range(6 * k):
        grads = {n: (rng.standard_normal(v.shape) * (3.0 if i % 3 == 1 else 0.3))
                 .astype(np.float32) for n, v in init.items()}
        jparams, jstate = jupdate({n: jnp.asarray(g) for n, g in grads.items()}, jstate,
                                  jparams)
        stepped = opt.step({n: torch.from_numpy(g) for n, g in grads.items()})
        assert stepped == ((i + 1) % k == 0)
        for n in init:
            np.testing.assert_allclose(params[n].detach().numpy(), np.asarray(jparams[n]),
                                       rtol=1e-6, atol=1e-6)
    assert opt.opt.count == 6  # the schedule counted optimizer steps


# --- one train step ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step on WAN_TINY (jit, Pallas in interpret mode): its
    inputs, its draws, its metrics and its updated routers."""
    model = JaxWanModel(JAX_WAN_TINY, rngs=nnx.Rngs(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(model))
    state = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}
    graphdef, router_state, frozen_state = jax_router_partition(model)
    sig = jax_train_sigmas(shift=3.0)
    opt = jax_make_optimizer(lr=1e-2)
    step = jax_make_step(graphdef, JaxAttentionConfig(**ATTN), opt,
                         weights=JaxLossWeights(hidden_layer_distill=1.0),
                         timestep_table=sig * 1000.0, sigma_table=sig, interpret=True)
    rng = np.random.default_rng(9)
    latents = rng.standard_normal((2, 4, 8, 8, WAN_TINY.in_channels)).astype(np.float32)
    embeds = rng.standard_normal((2, WAN_TINY.text_len, WAN_TINY.text_dim)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    new_router, _, metrics = jax.jit(step)(router_state, frozen_state, opt.init(router_state),
                                           jnp.asarray(latents), jnp.asarray(embeds), key)
    # the draws of JAX's loss function, remade here for the port
    k_t, k_eps = jax.random.split(key)
    t, s = jax_sampling.sample_timesteps(k_t, 2, jnp.asarray(sig * 1000.0), jnp.asarray(sig))
    eps = jax.random.normal(k_eps, latents.shape, jnp.float32)
    rflat, _ = jax.tree_util.tree_flatten_with_path(new_router)
    router = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in rflat}
    draws = tuple(torch.from_numpy(np.asarray(x)) for x in (t, s, eps))
    return dict(state=state, sig=sig, latents=latents, embeds=embeds, draws=draws,
                metrics={k: float(v) for k, v in metrics.items()},
                router=_flat_to_state(router, {"blocks": JAX_WAN_TINY.num_layers}))


def _port_model(state):
    model = WanModel(WAN_TINY, dtype=torch.float32, device="cpu")
    model.load_state_dict(wan_state_from_jax(state, WAN_TINY))
    return model


def test_train_step_matches_jax(jax_step):
    """Loss, its parts, the micro-step's grad norm and the routers after one
    AdamW step equal JAX's, from the same weights, batch and draws."""
    model = _port_model(jax_step["state"])
    routers = router_partition(model)
    assert all(p.requires_grad for p in routers.values())
    assert not any(p.requires_grad for n, p in model.named_parameters() if n not in routers)
    sig = jax_step["sig"]
    step = make_router_train_step(AttentionConfig(**ATTN), LossWeights(hidden_layer_distill=1.0),
                                  timestep_table=sig * 1000.0, sigma_table=sig)
    opt = MultiSteps(make_optimizer(routers, lr=1e-2), 1)
    metrics = step.step_with(model, opt, torch.from_numpy(jax_step["latents"]),
                             torch.from_numpy(jax_step["embeds"]), *jax_step["draws"])
    want = jax_step["metrics"]
    for name in ("loss", "l_fm", "l_reg", "l_last", "l_hidden", "grad_norm", "timestep"):
        np.testing.assert_allclose(float(metrics[name]), want[name], rtol=1e-4, err_msg=name)
    assert set(routers) == set(jax_step["router"])
    for name, p in routers.items():
        _close(p, jax_step["router"][name].numpy())


def test_remat_changes_nothing(jax_step):
    """Per-block recompute (remat_blocks) gives the same loss and router
    gradients as keeping the activations."""
    model = _port_model(jax_step["state"])
    routers = router_partition(model)
    sig = jax_step["sig"]
    out = []
    for remat in (False, True):
        step = make_router_train_step(AttentionConfig(**ATTN),
                                      LossWeights(hidden_layer_distill=1.0),
                                      timestep_table=sig * 1000.0, sigma_table=sig,
                                      remat_blocks=remat)
        loss, _ = step.loss(model, torch.from_numpy(jax_step["latents"]),
                            torch.from_numpy(jax_step["embeds"]), *jax_step["draws"])
        out.append((loss, torch.autograd.grad(loss, list(routers.values()))))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)


def test_return_losses_needs_routing():
    model = WanModel(WAN_TINY, device="cpu")
    with pytest.raises(ValueError, match="routed"):
        model(torch.zeros((1, 4, 8, 8, 16)), torch.tensor([500.0]), torch.zeros((1, 16, 32)),
              attn_cfg=AttentionConfig(**ATTN), return_losses=True)


# --- checkpoint, data, metrics ------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    from vorta_tpu_torch.io.checkpoint import (
        apply_router_state,
        latest_checkpoint,
        load_router_checkpoint,
        save_router_checkpoint,
    )

    model = WanModel(WAN_TINY, device="cpu", seed=1)
    routers = router_partition(model)
    opt = MultiSteps(make_optimizer(routers), 2)
    opt.step({n: torch.ones_like(p) for n, p in routers.items()})
    save_router_checkpoint(tmp_path, 100, routers, opt.state_dict())
    path = save_router_checkpoint(tmp_path, 200, routers, opt.state_dict())
    (tmp_path / "step-000300.tmp").mkdir()  # a save cut short is never picked
    assert path == tmp_path.absolute() / "step-000200"
    assert sorted(p.name for p in path.iterdir()) == ["optimizer", "router"]
    assert latest_checkpoint(tmp_path) == path and latest_checkpoint(tmp_path / "none") is None
    router_state, opt_state = load_router_checkpoint(path)
    other = WanModel(WAN_TINY, device="cpu", seed=2)
    apply_router_state(other, router_state)
    other_routers = router_partition(other)
    for name, p in routers.items():
        torch.testing.assert_close(other_routers[name], p, rtol=0, atol=0)
    opt2 = MultiSteps(make_optimizer(other_routers), 2)
    opt2.load_state_dict(opt_state)
    assert opt2.mini_step == 1
    torch.testing.assert_close(opt2.acc, opt.acc, rtol=0, atol=0)
    with pytest.raises(KeyError):
        apply_router_state(other, {k: v for k, v in router_state.items() if "0" not in k})


def test_latent_dataset_matches_jax(tmp_path):
    from vorta_tpu.training.data import LatentDataset as JaxLatentDataset
    from vorta_tpu.training.data import epoch_iterator as jax_epoch_iterator
    from vorta_tpu_torch.training.data import LatentDataset, epoch_iterator

    for sub in ("latent", "prompt_embed", "prompt_attention_mask"):
        (tmp_path / sub).mkdir()
    gen = torch.Generator().manual_seed(0)
    items = []
    for i in range(5):
        torch.save(torch.randn((16, 6, 8, 8), generator=gen), tmp_path / "latent" / f"{i}.pt")
        torch.save(torch.randn((16, 32), generator=gen), tmp_path / "prompt_embed" / f"{i}.pt")
        torch.save(torch.ones(16), tmp_path / "prompt_attention_mask" / f"{i}.pt")
        items.append({"latent_path": f"{i}.pt", "prompt_embed_path": f"{i}.pt",
                      "prompt_attention_mask": f"{i}.pt"})
    manifest = tmp_path / "videos.json"
    manifest.write_text(json.dumps(items))
    ds = LatentDataset(str(manifest), num_latent_t=4, cfg_rate=0.5, seed=3)
    jds = JaxLatentDataset(str(manifest), num_latent_t=4, cfg_rate=0.5, seed=3)
    assert len(ds) == len(jds) == 5
    for got, want in zip(ds[0], jds[0]):  # one cfg-dropout draw each
        np.testing.assert_array_equal(got, want)
    assert ds[1][0].shape == jds[1][0].shape == (4, 8, 8, 16)
    it, jit_ = epoch_iterator(ds, 2, seed=1), jax_epoch_iterator(jds, 2, seed=1)
    for _ in range(5):  # 2 batches per epoch (drop_last), so this crosses epochs
        for a, b in zip(next(it), next(jit_)):
            np.testing.assert_array_equal(a, b)


def test_metrics_logger_matches_jax(tmp_path):
    from vorta_tpu.io.metrics import MetricsLogger as JaxMetricsLogger
    from vorta_tpu_torch.io.metrics import MetricsLogger

    metrics = {"loss": 0.5, "l_fm": 1.25e-3, "grad_norm": 2.0, "timestep": 812.4}
    a, b = MetricsLogger(tmp_path / "port"), JaxMetricsLogger(tmp_path / "jax")
    assert a.log(3, metrics, lr=1e-2) == b.log(3, metrics, lr=1e-2)
    a.close()
    b.close()
    rec_a = json.loads((tmp_path / "port" / "metrics.jsonl").read_text())
    rec_b = json.loads((tmp_path / "jax" / "metrics.jsonl").read_text())
    assert rec_a.keys() == rec_b.keys()
    assert {k: v for k, v in rec_a.items() if k != "wall_s"} == \
        {k: v for k, v in rec_b.items() if k != "wall_s"}


# --- the CLIs -----------------------------------------------------------------------

TINY = ["--model", "wan-tiny", "--device", "cpu", "--dtype", "fp32", "--synthetic_data",
        "--gradient_accumulation_steps", "1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The trainer CLI on the CPU: 2 optimizer steps, then resumed for a 3rd."""
    from vorta_tpu_torch.cli.train import main

    out = tmp_path_factory.mktemp("train")
    first = main(TINY + ["--max_train_steps", "2", "--output_dir", str(out)])
    second = main(TINY + ["--max_train_steps", "3", "--resume_from_checkpoint", "latest",
                          "--output_dir", str(out)])
    return out, first, second


def test_cli_trains_and_resumes(trained):
    out, first, second = trained
    assert (first.init_step, first.final_step) == (0, 2)
    assert (second.init_step, second.final_step) == (2, 3)
    assert [p.name for p in first.checkpoints + second.checkpoints] == \
        ["step-000002", "step-000003"]
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0
               for m in first.metrics + second.metrics)
    moved = max((first.router_final[k] - first.router_init[k]).abs().max().item()
                for k in first.router_init)
    assert moved > 0
    for k in first.router_final:  # the resumed run starts from the checkpoint
        torch.testing.assert_close(second.router_init[k], first.router_final[k], rtol=0, atol=0)
    assert AttentionConfig.load(out / "config.json") == AttentionConfig(**ATTN)
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 3


@pytest.mark.parametrize("extra,match", [
    (["--model", "hunyuan-tiny", "--sp_size", "2"], "not divisible by sp_size 2"),
    (["--sp_size", "2"], "not divisible by sp_size 2"),
    (["--dp_size", "2"], "dp\\*sp"),
    (["--shard_frozen", "--sp_size", "3"], "not divisible by sp_size 3"),
    (["--model", "hunyuan-13B"], "must divide the latent grid")])
def test_cli_refuses_later_slices(extra, match, tmp_path):
    """Hunyuan training and the parallel flags are served now (tests/
    test_torch_port_hunyuan_training.py, test_torch_port_parallel.py); what
    stays refused, before any model is built: a mesh the world (one process
    here) does not divide, as JAX's make_mesh refuses it, and the 13B's
    (6, 9, 8) tile on the default 480 x 832 grid (20, 30, 52), which it does
    not divide."""
    from vorta_tpu_torch.cli.train import main

    with pytest.raises(ValueError, match=match):
        main(TINY + extra + ["--output_dir", str(tmp_path)])


def test_sample_cli_uses_trained_router(trained, tmp_path, monkeypatch):
    """Train -> serve: the sampler reads the trainer's step dir and its
    config.json geometry, and the same routers from a reference-style
    router.pt (blocks.{i}.router.linear.*)."""
    from vorta_tpu_torch.cli import sample

    out, first, second = trained
    seen = {}

    def spy(model, state):
        apply(model, state)
        seen["model"] = model

    apply = sample.apply_router_state
    monkeypatch.setattr(sample, "apply_router_state", spy)
    args = ["--model", "wan-tiny", "--device", "cpu", "--dtype", "fp32", "--random_embeds",
            "--num_frames", "13", "--height", "64", "--width", "64",
            "--num_inference_steps", "2", "--resume_dir", str(out), "--output",
            str(tmp_path / "x.npy")]
    res = sample.main(args + ["--router_checkpoint", str(second.checkpoints[-1])])
    assert np.isfinite(res.latents.numpy()).all() and len(res.routing) == 4
    params = dict(seen["model"].named_parameters())
    for name, p in second.router_final.items():
        torch.testing.assert_close(params[name].detach(), p, rtol=0, atol=0)
    torch.save({k: v for k, v in second.router_final.items()}, tmp_path / "router.pt")
    seen.clear()
    res_pt = sample.main(args + ["--router_checkpoint", str(tmp_path / "router.pt")])
    torch.testing.assert_close(res_pt.latents, res.latents, rtol=0, atol=0)
    params = dict(seen["model"].named_parameters())
    for name, p in second.router_final.items():
        torch.testing.assert_close(params[name].detach(), p, rtol=0, atol=0)
    with pytest.raises(ValueError, match="config.json geometry"):
        sample.main(args[:7] + ["--num_frames", "17"] + args[9:])
