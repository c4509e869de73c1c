"""The port's sequence and data parallelism (parallel/, the models' and
pipelines' ``sp_group``, the train steps' groups, ``--shard_frozen``) on
the CPU: 4 gloo ranks (tests/torch_port_ranks.py, spawned, meeting on a
``file://`` store) as one sp group of 4 and as a (dp 2, sp 2) mesh,
against one process without groups, which is held against the JAX
package.

As JAX's tests/test_ulysses.py, test_sp_hunyuan.py, test_sp_pipeline.py and
test_fsdp_frozen.py hold SP=N to SP=1: the all_to_all round trip and its
order, Wan and HunyuanVideo forwards routing off / hard / soft, the
training losses and the router gradients (summed over sp, averaged over
dp), both pipelines' sampling with CFG batching (Wan with the step cache
too), the frozen blocks layer-sharded against replicated, ``make_mesh``'s
groups and refusals, and cli.train / cli.sample with ``--sp_size 2``.
Models: tiny, 4 heads (tests/torch_port_ranks.py WAN4 / HY4), their
weights drawn by the JAX package (port_assets/random_jax.py) and carried
across by io/from_jax, the routers' biases one-hot so hard routing uses all
three experts.

Tolerances, f32 everywhere: SP=N against SP=1 rtol 1e-5, atol 1e-5 x the
output's max abs value (the ranks run the same sums over other row
blocks, and the text stream's reshard reorders nothing); the router
gradients rtol 1e-4, atol 1e-4 x their max (one more sum, over the
ranks); the sharded frozen blocks against replicated, bit for bit (the
same weights, broadcast); SP=1 against JAX rtol 1e-4, atol 1e-4 x scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import torch_port_ranks as ranks
from port_assets.random_jax import random_module
from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.config import WanModelConfig as JaxWanModelConfig
from vorta_tpu.models import hunyuan as jhunyuan
from vorta_tpu.models.wan import WanModel as JaxWanModel
from vorta_tpu_torch.io.from_jax import hunyuan_state_from_jax, wan_state_from_jax
from vorta_tpu_torch.parallel import make_mesh


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * max(np.abs(want).max(), 1e-30))


def _flat(module) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(module))
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


def _jax_cfgs():
    wan = JaxWanModelConfig(**{f.name: getattr(ranks.WAN4, f.name)
                               for f in dataclasses.fields(ranks.WAN4)})
    hy = jhunyuan.HunyuanModelConfig(**{f.name: getattr(ranks.HY4, f.name)
                                        for f in dataclasses.fields(ranks.HY4)})
    return wan, hy


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX models, the port's (the same weights, one-hot router biases on
    both), the shared inputs and draws, written for the ranks."""
    jwan_cfg, jhy_cfg = _jax_cfgs()
    jwan = random_module(lambda: JaxWanModel(jwan_cfg, rngs=nnx.Rngs(0)), seed=21)
    jhy = random_module(lambda: jhunyuan.HunyuanModel(jhy_cfg, rngs=nnx.Rngs(0)), seed=22)
    path = tmp_path_factory.mktemp("parallel") / "setup.pt"
    data = ranks.make_setup(path, wan_state_from_jax(_flat(jwan), ranks.WAN4),
                            hunyuan_state_from_jax(_flat(jhy), ranks.HY4))
    # the JAX side takes the same router biases
    for stack, experts in ranks.HARD.items():
        jmod = jwan if stack == "blocks" else jhy
        n = jwan_cfg.num_layers if stack == "blocks" else getattr(jhy_cfg, stack[:-7] + "_layers")
        getattr(jmod, stack).router.linear.bias.value = jnp.asarray(
            np.tile(6.0 * np.eye(3, dtype=np.float32)[experts].reshape(-1), (n, 1)))
    return path, data, jwan, jhy


@pytest.fixture(scope="module")
def single(setup):
    """One process, no groups: the references of the ranks' runs."""
    _, data, _, _ = setup
    wan, hy = ranks.models(data)
    out = ranks.forwards(wan, hy, data, None)
    out.update(ranks.train_grads(wan, hy, data, None))
    out.update(ranks.sampling(wan, hy, data, None))
    return out


@pytest.fixture(scope="module")
def ranks_out(setup, tmp_path_factory):
    """The 4 ranks' results, one dict per rank."""
    return ranks.spawn(tmp_path_factory.mktemp("ranks"), setup[0])


SP = pytest.mark.parametrize("sp", ["sp2", "sp4"])


def _members(res, sp: str):
    """(rank, its result) of every rank, and its sp group's size."""
    return [(r, out) for r, out in enumerate(res)], int(sp[2:])


# --- the collectives and the mesh ----------------------------------------------------

@SP
def test_all_to_all_round_trip_and_order(ranks_out, sp):
    """heads_to_seq gives group rank g heads g, the whole sequence in rank
    order; seq_to_heads undoes it; slice_local and gather_sequence are the
    slice and its inverse."""
    members, p = _members(ranks_out, sp)
    x = torch.arange(2 * 4 * 4 * p * 3, dtype=torch.float32).reshape(2, 4, 4 * p, 3)
    n = 4 // p
    for r, out in members:
        g = r % p
        assert torch.equal(out[f"{sp}_heads_to_seq"], x[:, g * n:(g + 1) * n])
        assert torch.equal(out[f"{sp}_round_trip"], out[f"{sp}_local_rows"])
        assert torch.equal(out[f"{sp}_local_rows"], x[:, :, g * 4:(g + 1) * 4])
        assert torch.equal(out[f"{sp}_slice_local"], x[:, g * n:(g + 1) * n])
        assert torch.equal(out[f"{sp}_gather"], x)


def test_make_mesh_groups_and_refusals(ranks_out):
    """Contiguous sp groups of 2, dp the other factor; a size that does not
    divide the world, dp x sp past it, and a CUDA device on a gloo group
    raise."""
    for r, out in enumerate(ranks_out):
        assert out["mesh"].tolist() == [2, 2, r // 2, r % 2, 2, 2]
        no_div, too_many, cuda = out["refusals"]
        assert "not divisible by sp_size 3" in no_div
        assert "dp*sp" in too_many
        assert "NCCL" in cuda


def test_make_mesh_without_a_group():
    """One process and no group: a mesh of one, and JAX's refusals."""
    mesh = make_mesh(device="cpu")
    assert (mesh.dp_size, mesh.sp_size, mesh.sp_group) == (1, 1, None)
    with pytest.raises(ValueError, match="not divisible by sp_size 2"):
        make_mesh(sp_size=2, device="cpu")
    with pytest.raises(ValueError, match="dp\\*sp"):
        make_mesh(dp_size=2, device="cpu")


def test_make_mesh_for_the_clis(monkeypatch):
    """The CLIs' rule: no mesh unless a flag, a group or torchrun's
    environment asks for one, and none for a one-process world; a size the
    world does not divide still raises."""
    from vorta_tpu_torch.parallel.mesh import make_mesh_for

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert make_mesh_for(1, None, "cpu") is None
    assert make_mesh_for(1, None, "cpu", force=True) is None
    assert make_mesh_for(1, 1, "cpu") is None
    with pytest.raises(ValueError, match="not divisible by sp_size 2"):
        make_mesh_for(2, None, "cpu")


def test_sharded_block_fetcher_on_one_rank(tmp_path):
    """Over a group of one rank: blocks not sharded over the group are
    refused; once sharded, each block's frozen parameters are views of one
    flat buffer per dtype, and ``block_at(i)`` runs block i bit for bit as
    the block itself, its router untouched."""
    import torch.distributed as dist
    from torch import nn

    from vorta_tpu_torch.parallel.fsdp import shard_frozen_blocks, sharded_block_fetcher

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = nn.Linear(8, 8)
            self.norm = nn.LayerNorm(8).to(torch.float64)
            self.router = nn.Linear(8, 3)

        def forward(self, x):
            return self.proj(x) + self.norm(x.double()).float() + self.router(x).sum(-1, keepdim=True)

    torch.manual_seed(0)
    blocks = nn.ModuleList([Block() for _ in range(2)])
    x = torch.randn(4, 8)
    with torch.no_grad():
        want = [b(x) for b in blocks]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        with pytest.raises(ValueError, match="shard_frozen_blocks"):
            sharded_block_fetcher(blocks, 2, group)
        shard_frozen_blocks(blocks, group)
        for b in blocks:
            flats = b._frozen_flat
            assert {f.dtype for f in flats} == {torch.float32, torch.float64} and len(flats) == 2
            assert b.proj.weight.untyped_storage().data_ptr() == \
                b.proj.bias.untyped_storage().data_ptr()
        block_at = sharded_block_fetcher(blocks, 2, group)
        with torch.no_grad():
            for i in range(2):
                assert torch.equal(block_at(i)(x), want[i])
    finally:
        dist.destroy_process_group()


# --- SP=N against one process --------------------------------------------------------

@SP
@pytest.mark.parametrize("model", ["wan", "hy"])
@pytest.mark.parametrize("mode", ranks.MODES)
def test_sp_forward_matches_single_process(ranks_out, single, sp, model, mode):
    for out in ranks_out:
        _close(out[f"{sp}_{model}_{mode}"], single[f"{model}_{mode}"])


@SP
@pytest.mark.parametrize("model", ["wan", "hy"])
def test_sp_train_step_matches_single_process(ranks_out, single, sp, model):
    """The losses (fm, last and hidden averaged over sp, reg from the
    replicated scores) and the router gradients summed over sp; every rank
    holds the same."""
    for out in ranks_out:
        _close(out[f"{sp}_{model}_metrics"], single[f"{model}_metrics"])
        _close(out[f"{sp}_{model}_grads"], single[f"{model}_grads"], rtol=1e-4, atol_rel=1e-4)
        assert torch.equal(out[f"{sp}_{model}_grads"], ranks_out[0][f"{sp}_{model}_grads"])
    assert single[f"{model}_grads"].abs().max() > 0


@pytest.mark.parametrize("model", ["wan", "hy"])
def test_dp_sp_mesh_train_step_matches_batch(ranks_out, single, model):
    """(dp 2, sp 2): each replica trains on half the batch of 2, each over
    two ranks' frames; the gradients averaged over dp are the whole batch's."""
    for out in ranks_out:
        _close(out[f"mesh_{model}_grads"], single[f"{model}_grads"], rtol=1e-4, atol_rel=1e-4)
        _close(out[f"mesh_{model}_metrics"], single[f"{model}_metrics"], rtol=1e-4,
               atol_rel=1e-4)


@SP
@pytest.mark.parametrize("model", ["wan", "hy"])
def test_sp_sampling_matches_single_process(ranks_out, single, sp, model):
    """Wan: 3 UniPC steps, CFG batched, step cache on (the same skips);
    HunyuanVideo: 2 Euler steps, true CFG batched; routed hard."""
    for out in ranks_out:
        _close(out[f"{sp}_{model}_sample"], single[f"{model}_sample"])
        if model == "wan":
            assert torch.equal(out[f"{sp}_wan_cache_skips"], single["wan_cache_skips"])
    if model == "wan":
        assert single["wan_cache_skips"].tolist() == [False, True, False]


# --- the frozen blocks layer-sharded ---------------------------------------------------

@pytest.mark.parametrize("what", ["forward", "train"])
def test_shard_frozen_matches_replicated(ranks_out, single, setup, what):
    """Each rank of a dp group of 2 holds half of every stack's frozen
    parameters (the routers all); the forwards and the train step run on
    the blocks broadcast from their owners, bit for bit the replicated
    model's."""
    keys = ([f"{m}_{mode}" for m in ("wan", "hy") for mode in ranks.MODES] if what == "forward"
            else ["wan_grads", "hy_grads", "wan_metrics", "hy_metrics"])
    wan, hy = ranks.models(setup[1])
    routers = [sum(p.numel() for n, p in stack.named_parameters() if "router" in n)
               for stack in (wan.blocks, hy.dual_blocks)]
    full = [sum(p.numel() for p in stack.parameters()) for stack in (wan.blocks, hy.dual_blocks)]
    for out in ranks_out:
        for k in keys:
            assert torch.equal(out[f"sharded_{k}"], single[k]), k
        # 2 layers a stack: a rank keeps one block's frozen weights
        assert out["held_frozen"].tolist() == [(f - r) // 2 + r for f, r in zip(full, routers)]


# --- the entry points ---------------------------------------------------------------------

def test_cli_train_and_sample_with_sp(ranks_out, tmp_path):
    """cli.train (HunyuanVideo-tiny, 1 step) and cli.sample (2 routed Euler
    steps) with --sp_size 2 --dp_size 1 on the joined group (ranks 0 and 1;
    2 and 3 idle), against one process."""
    from vorta_tpu_torch.cli import sample, train

    one = train.main(ranks.TRAIN_ARGV + ["--output_dir", str(tmp_path / "train")])
    latents = sample.main(ranks.SAMPLE_ARGV + ["--output", str(tmp_path / "s.npy")]).latents
    assert "cli_sample" not in ranks_out[2] and "cli_sample" not in ranks_out[3]
    for out in ranks_out[:2]:
        _close(out["cli_train_loss"], torch.tensor(one.metrics[0]["loss"]))
        _close(out["cli_train_routers"],
               torch.cat([v.flatten() for v in one.router_final.values()]))
        _close(out["cli_sample"], latents)


# --- one process against JAX ----------------------------------------------------------------

def test_single_process_matches_jax(setup, single):
    """The port's forwards without groups against the JAX models, soft
    routing (the references both sides run) and, HunyuanVideo, the
    teacher's off_ref."""
    _, data, jwan, jhy = setup
    jattn = {k: JaxAttentionConfig(**dataclasses.asdict(c))
             for k, c in (("wan", ranks.WAN_ATTN), ("hy", ranks.HY_ATTN))}
    t = jnp.asarray([500.0])
    want = jwan(jnp.asarray(data["wan_latents"].numpy()), t, jnp.asarray(data["wan_text"].numpy()),
                attn_cfg=jattn["wan"], routing_mode="soft", interpret=True).sample
    _close(single["wan_soft"], want, rtol=1e-4, atol_rel=1e-4)
    hy_args = (jnp.asarray(data["hy_latents"].numpy()), t, jnp.asarray(data["hy_text"].numpy()),
               jnp.asarray(data["hy_mask"].numpy()), jnp.asarray(data["hy_pooled"].numpy()))
    want = jhy(*hy_args, guidance=jnp.asarray([6000.0]), attn_cfg=jattn["hy"],
               routing_mode="soft", interpret=True).sample
    _close(single["hy_soft"], want, rtol=1e-4, atol_rel=1e-4)
