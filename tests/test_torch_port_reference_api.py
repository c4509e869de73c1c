"""The port's public API against its JAX namesakes, on the CPU.

Three faults of the port are held closed here: the softmax defaults of
flash_manual and sta_batched (JAX's wrappers default to "stable": a call
with JAX's defaults must give JAX's numbers, the Pallas kernels run in
interpret mode, once per kernel), the keywords of sparse_flash_attention_raw
that JAX's wrapper takes (``tokens_per_tile`` and ``cast_p_to_v_dtype``
refused as NotImplementedError, the other wrappers' refusal, not a
TypeError), and the public names the JAX modules have (each against its
JAX namesake on the same numpy inputs; the parallel package's at one rank,
a gloo group of this process against JAX's one-device axis; and the
chunked attention's recompute backward against JAX's autodiff).  Tolerances: f32 on both sides,
rtol 1e-4 and atol 1e-4 x the output's max abs value (the two sides sum in
different orders); exact where both sides only copy or count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vorta_tpu import geometry as jgeometry
from vorta_tpu.ops import attention_ref as jattention_ref
from vorta_tpu.ops import fused_norm as jnorm
from vorta_tpu.ops import prologue as jprologue
from vorta_tpu.ops import qmm as jqmm
from vorta_tpu.ops import quant as jquant
from vorta_tpu.ops import rope as jrope
from vorta_tpu.ops import sta_window as jsta_window
from vorta_tpu.ops.flash_manual import sparse_flash_attention_manual as jax_manual
from vorta_tpu.ops.sta_batched import sta_flash_headbatched as jax_batched
from vorta_tpu_torch import geometry
from vorta_tpu_torch.ops import (attention_ref, fused_norm, prologue, qmm, quant, rope,
                                 sta_window)
from vorta_tpu_torch.ops.flash import sparse_flash_attention_raw, tables_from_block_mask
from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual
from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched
from vorta_tpu_torch.parallel import mesh, ulysses


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * max(np.abs(want).max(), 1e-6))


def _randn(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


# --- fault 1: the softmax defaults ------------------------------------------------------

def test_flash_manual_default_is_jax_default():
    """No softmax given on either side: the stable softmax.  q and k at 8x
    unit scale, where the fast softmax (no running max) gives other numbers:
    the bracket must fail."""
    b, h, s, d, blk = 1, 2, 64, 32, 32
    q, k, v = _randn(61, *[(b, h, s, d)] * 3, scale=8.0)
    tab = tables_from_block_mask(np.ones((1, s // blk, s // blk), bool))
    kw = dict(block_q=blk, block_kv=blk, kv_valid_len=50)
    want = jax_manual(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tab.kv_index),
                      jnp.asarray(tab.kv_count), interpret=True, **kw)
    args = (*(torch.from_numpy(x) for x in (q, k, v)), tab.kv_index, tab.kv_count)
    _close(sparse_flash_attention_manual(*args, **kw), want)
    fast = sparse_flash_attention_manual(*args, softmax="fast", **kw)
    assert not np.allclose(fast.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


def test_sta_batched_default_is_jax_default():
    """The joint layout of a (2, 2, 2) tile with pair bits and the text
    bias, no softmax given on either side; head 1 routed away.  q and k at
    12x unit scale, where the fast softmax overflows: the bracket must
    fail."""
    from vorta_tpu_torch.config import AttentionConfig
    from vorta_tpu_torch.ops import joint_experts as joint

    cfg = joint.JointConfig(AttentionConfig(latent_shape=(4, 4, 8), sta_tile=(2, 2, 2),
                                            lowres_window=(2, 2, 2)), 24)
    lay = joint.joint_layouts(cfg)["sta"]
    tables = joint._joint_sta_tables(cfg)
    q, k, v = _randn(62, *[(1, 3, lay.total, 16)] * 3, scale=12.0)
    bias = joint._bias(torch.from_numpy(np.arange(24) < 17)[None], lay, cfg.video.seq_len)
    active = np.asarray([1, 0, 1], np.int32)
    kw = dict(tokens_per_tile=8, block_q=lay.block_q, block_kv=lay.block_kv)
    want = jax_batched(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tables.kv_index),
                       jnp.asarray(tables.kv_count), jnp.asarray(active),
                       pair_bits=jnp.asarray(tables.pair_bits), kv_bias=jnp.asarray(bias.numpy()),
                       interpret=True, **kw)
    args = (*(torch.from_numpy(x) for x in (q, k, v)), tables.kv_index, tables.kv_count,
            torch.from_numpy(active))
    got = sta_flash_headbatched(*args, pair_bits=tables.pair_bits, kv_bias=bias, **kw)
    _close(got, want)
    assert not got[:, 1].any()
    fast = sta_flash_headbatched(*args, pair_bits=tables.pair_bits, kv_bias=bias,
                                 softmax="fast", **kw)
    assert not np.allclose(fast.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


# --- fault 2: the flash wrapper's keywords ----------------------------------------------

@pytest.mark.parametrize("extra", [dict(tokens_per_tile=8), dict(cast_p_to_v_dtype=False),
                                   dict(tokens_per_tile=8, cast_p_to_v_dtype=False)])
def test_flash_refuses_jax_keywords_it_does_not_port(extra):
    q = torch.zeros((1, 1, 32, 64))
    tab = tables_from_block_mask(np.ones((1, 1, 1), bool))
    with pytest.raises(NotImplementedError, match="item 11"):
        sparse_flash_attention_raw(q, q, q, tab.kv_index, tab.kv_count, block_q=32, block_kv=32,
                                   **extra)
    # the JAX wrapper's own defaults are taken
    out = sparse_flash_attention_raw(q, q, q, tab.kv_index, tab.kv_count, block_q=32,
                                     block_kv=32, tokens_per_tile=None, cast_p_to_v_dtype=True)
    assert out.shape == q.shape


# --- fault 3: the public names of the JAX modules ---------------------------------------

def _norm_inputs():
    x, scale, shift, gamma, beta = _randn(63, (2, 12, 64), (2, 64), (2, 64), (64,), (64,))
    return x, 0.1 * scale, shift, 1 + 0.1 * gamma, beta


def _case_layernorm_fp32():
    x, _, _, gamma, beta = _norm_inputs()
    t = torch.from_numpy
    _close(fused_norm.layernorm_fp32(t(x), 1e-5, t(gamma), t(beta)),
           jnorm.layernorm_fp32(jnp.asarray(x), 1e-5, jnp.asarray(gamma), jnp.asarray(beta)))
    _close(fused_norm.layernorm_fp32(t(x)), jnorm.layernorm_fp32(jnp.asarray(x)))


def _case_adaln_layernorm():
    x, scale, shift, gamma, _ = _norm_inputs()
    t = torch.from_numpy
    _close(fused_norm.adaln_layernorm(t(x), t(scale), t(shift), gamma=t(gamma)),
           jnorm.adaln_layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift),
                                 gamma=jnp.asarray(gamma)))


def _case_rmsnorm():
    x, _, _, gamma, _ = _norm_inputs()
    _close(fused_norm.rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma), 1e-5),
           jnorm.rmsnorm(jnp.asarray(x), jnp.asarray(gamma), 1e-5))


def _case_set_prologue_mode():
    before = (prologue._PROLOGUE_MODE, jprologue._PROLOGUE_MODE)
    try:
        for mode in ("off", "fused"):
            prologue.set_prologue_mode(mode)
            jprologue.set_prologue_mode(mode)
            assert prologue._PROLOGUE_MODE == jprologue._PROLOGUE_MODE == mode
            assert prologue.use_fused_prologue("hard", 64, 128, 2) is (mode == "fused")
    finally:
        prologue._PROLOGUE_MODE, jprologue._PROLOGUE_MODE = before


def _case_window_starts():
    for grid, tile, window in (((20, 45, 80), (4, 9, 10), (3, 3, 3)),
                               ((4, 8, 8), (2, 2, 2), (3, 3, 1))):
        got = sta_window.window_starts(grid, tile, window)
        want = jsta_window.window_starts(grid, tile, window)
        assert got.dtype == want.dtype and (got == want).all()


def _case_full_block_tables():
    for got, want in zip(geometry.full_block_tables(3, 5), jgeometry.full_block_tables(3, 5)):
        assert got.dtype == want.dtype and (got == want).all()


def _case_expand_block_mask():
    mask = np.random.default_rng(64).random((2, 3, 4)) < 0.5
    got = attention_ref.expand_block_mask(torch.from_numpy(mask), 8, 16)
    want = np.asarray(jattention_ref.expand_block_mask(jnp.asarray(mask), 8, 16))
    assert tuple(got.shape) == want.shape == (1, 2, 24, 64)
    assert (got.numpy() == want).all()


def _case_dequantize_tree():
    """A stack with a quantized leaf (int4 and int8) and a plain one, nested."""
    rng = np.random.default_rng(65)
    state = {"w": rng.standard_normal((2, 64, 96)).astype(np.float32),
             "b": rng.standard_normal((2, 96)).astype(np.float32)}
    for bits in (4, 8):
        ref = jquant.quantize_stacked_tree(state, bits=bits, min_bytes=4096)
        got = quant.quantize_stacked_tree({k: torch.from_numpy(v) for k, v in state.items()},
                                          bits=bits, min_bytes=4096)
        assert isinstance(got["w"], quant.QTensor) and not isinstance(got["b"], quant.QTensor)
        want = jquant.dequantize_tree({"blk": ref, "extra": [ref["b"]]})
        deq = quant.dequantize_tree({"blk": got, "extra": [got["b"]]})
        assert isinstance(deq["extra"], list)
        for key in ("w", "b"):
            _close(deq["blk"][key], want["blk"][key], rtol=1e-6, atol_rel=1e-6)
        _close(deq["extra"][0], want["extra"][0], rtol=0, atol_rel=0)


def _case_fused_linear():
    """Two QLinears and a plain bias-less Linear on one input, bf16
    precision: one product, split per layer."""
    rng = np.random.default_rng(66)
    x = rng.standard_normal((1, 9, 32)).astype(np.float32)
    sizes = (16, 24, 8)
    ws = [(rng.standard_normal((32, n)) / 6).astype(np.float32) for n in sizes]
    bs = [rng.standard_normal(n).astype(np.float32) for n in sizes[:2]]
    jlins, tlins = [], []
    for i, w in enumerate(ws):
        site = ("a", "b", None)[i]
        jl = jqmm.QLinear(32, w.shape[1], site=site, use_bias=i < 2, rngs=nnx.Rngs(i))
        jl.kernel.value = jnp.asarray(w)
        tl = qmm.QLinear(32, w.shape[1], site=site, bias=i < 2)
        with torch.no_grad():
            tl.weight.copy_(torch.from_numpy(w.T.copy()))
            if i < 2:
                jl.bias.value = jnp.asarray(bs[i])
                tl.bias.copy_(torch.from_numpy(bs[i]))
        jlins.append(jl)
        tlins.append(tl)
    want = jqmm.fused_linear(jnp.asarray(x), jlins)
    with torch.no_grad():
        got = qmm.fused_linear(torch.from_numpy(x), tlins)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-6, atol_rel=1e-6)


def _case_apply_rope():
    """diffusers' interleaved pairs, bf16 in, f32 rotation, bf16 out."""
    x, ang = _randn(67, (2, 3, 10, 16), (10, 8))
    cos, sin = np.cos(ang), np.sin(ang)
    _close(rope.apply_rope(*(torch.from_numpy(a) for a in (x, cos, sin))),
           jrope.apply_rope(*(jnp.asarray(a) for a in (x, cos, sin))), rtol=1e-6, atol_rel=1e-6)
    got = rope.apply_rope(torch.from_numpy(x).bfloat16(),
                          *(torch.from_numpy(a) for a in (cos, sin)))
    want = jrope.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos), jnp.asarray(sin))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), rtol=1e-2, atol_rel=1e-2)


def _one_rank_group():
    """A gloo group of this one process on a file:// store (destroyed by the
    caller), for the collectives' world-size-1 cases."""
    import tempfile

    import torch.distributed as dist

    tmp = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    return dist.new_group([0])


def _case_ulysses():
    """At one rank each collective is the identity, as JAX's over a
    one-device sp axis (inside shard_map)."""
    import torch.distributed as dist
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from vorta_tpu.parallel import ulysses as julysses
    from vorta_tpu_torch.parallel import ulysses

    (x,) = _randn(70, (2, 4, 12, 8))
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("sp",))
    group = _one_rank_group()
    try:
        for name, kw in (("all_to_all_heads_to_seq", {}), ("all_to_all_seq_to_heads", {}),
                         ("gather_sequence", dict(seq_axis=2)), ("slice_local", dict(dim=1))):
            fn = jax.shard_map(lambda a, f=getattr(julysses, name), kw=kw: f(a, axis="sp", **kw),
                               mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False)
            got = getattr(ulysses, name)(torch.from_numpy(x), group=group, **kw)
            _close(got, fn(jnp.asarray(x)), rtol=0, atol_rel=0)
    finally:
        dist.destroy_process_group()


def _case_make_mesh():
    """One device: a (1, 1) mesh; a size that does not divide it and dp x sp
    past it raise JAX's errors, word for word."""
    from vorta_tpu.parallel import mesh as jmesh
    from vorta_tpu_torch.parallel import mesh

    one = jax.devices()[:1]
    assert dict(jmesh.make_mesh(devices=one).shape) == mesh.make_mesh(device="cpu").shape
    for kw in (dict(sp_size=2), dict(sp_size=1, dp_size=2)):
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(devices=one, **kw)
        with pytest.raises(ValueError) as got:
            mesh.make_mesh(device="cpu", **kw)
        assert str(got.value) == str(want.value)
    assert (mesh.DP_AXIS, mesh.SP_AXIS) == (jmesh.DP_AXIS, jmesh.SP_AXIS)


PUBLIC_NAMES = {  # the port's module: (name, case)
    "ops.rope.apply_rope": (rope, _case_apply_rope),
    "ops.fused_norm.layernorm_fp32": (fused_norm, _case_layernorm_fp32),
    "ops.fused_norm.adaln_layernorm": (fused_norm, _case_adaln_layernorm),
    "ops.fused_norm.rmsnorm": (fused_norm, _case_rmsnorm),
    "ops.prologue.set_prologue_mode": (prologue, _case_set_prologue_mode),
    "ops.sta_window.window_starts": (sta_window, _case_window_starts),
    "geometry.full_block_tables": (geometry, _case_full_block_tables),
    "ops.attention_ref.expand_block_mask": (attention_ref, _case_expand_block_mask),
    "ops.quant.dequantize_tree": (quant, _case_dequantize_tree),
    "ops.qmm.fused_linear": (qmm, _case_fused_linear),
    "parallel.ulysses.all_to_all_heads_to_seq": (ulysses, _case_ulysses),
    "parallel.mesh.make_mesh": (mesh, _case_make_mesh),
}


@pytest.mark.parametrize("path", sorted(PUBLIC_NAMES))
def test_public_name_matches_its_jax_namesake(path):
    module, case = PUBLIC_NAMES[path]
    assert callable(getattr(module, path.rsplit(".", 1)[1]))
    case()


# --- ROADMAP section 3 F1: keywords and module constants of the JAX namesakes -----------

def test_tables_from_block_mask_pad_to_matches_jax():
    """``pad_to`` widens every head's table to one width (JAX's padding rule);
    without it the width is the most kv blocks a q block sees."""
    from vorta_tpu.ops.flash import tables_from_block_mask as jtables

    mask = np.random.default_rng(68).random((2, 4, 6)) < 0.4
    mask[:, :, 0] = True
    for pad_to in (None, 6, 9):
        got, want = tables_from_block_mask(mask, pad_to=pad_to), jtables(mask, pad_to=pad_to)
        for a, b in ((got.kv_index, want.kv_index), (got.kv_count, want.kv_count)):
            assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
    assert tables_from_block_mask(mask, pad_to=9).kv_index.shape == (2, 4, 9)


@pytest.mark.parametrize("dim,flip,shift", [(64, True, 0.0), (64, False, 1.0), (33, True, 1.0),
                                            (32, False, 0.0)])
def test_sinusoidal_timestep_embedding_options_match_jax(dim, flip, shift):
    """Timesteps up to 50 (arguments up to 50 rad: one f32 ulp of a
    frequency, which exp may differ by between XLA and PyTorch, moves the
    sinusoid by ~1e-5 at most); the defaults are the models' [cos, sin]
    with no shift, bit for bit, at every timestep."""
    import math

    from vorta_tpu.models.common import sinusoidal_timestep_embedding as jemb
    from vorta_tpu_torch.models.common import sinusoidal_timestep_embedding as emb

    t = np.array([0.0, 1.0, 7.5, 50.0], np.float32)
    got = emb(torch.from_numpy(t), dim, flip_sin_to_cos=flip, downscale_freq_shift=shift)
    _close(got, jemb(jnp.asarray(t), dim, flip_sin_to_cos=flip, downscale_freq_shift=shift),
           rtol=1e-5, atol_rel=1e-5)
    tt = torch.tensor([0.0, 1.0, 500.0, 999.0])
    half = 32
    args = tt[:, None] * torch.exp(-math.log(10000.0) * torch.arange(half).float() / half)
    assert torch.equal(emb(tt, 64), torch.cat([torch.cos(args), torch.sin(args)], dim=-1))


def test_quantized_builders_take_a_router_checkpoint(tmp_path):
    """``router_checkpoint`` (a path, JAX's keyword, in JAX's position)
    merges the routers ``router_state`` carries; passing both raises."""
    import inspect

    from vorta_tpu.io import quant_serving as jqs
    from vorta_tpu_torch.config import WAN_TINY
    from vorta_tpu_torch.io import quant_serving as qs
    from vorta_tpu_torch.io import torch_import as ti
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY

    for name in ("build_quantized_wan", "build_quantized_hunyuan"):
        want = list(inspect.signature(getattr(jqs, name)).parameters)[:5]
        assert list(inspect.signature(getattr(qs, name)).parameters)[:5] == want
    g = torch.Generator().manual_seed(69)
    out = WAN_TINY.num_heads * 3
    wan = {f"blocks.{i}.router.linear.{p}": torch.randn(*sh, generator=g)
           for i in range(WAN_TINY.num_layers)
           for p, sh in (("weight", (out, WAN_TINY.dim)), ("bias", (out,)))}
    torch.save(wan, tmp_path / "router.pt")
    key = "['router']['linear']['kernel'].value"
    _, by_path = qs.build_quantized_wan(WAN_TINY, 8, router_checkpoint=str(tmp_path / "router.pt"),
                                        seed=1, device="cpu")
    _, by_state = qs.build_quantized_wan(
        WAN_TINY, 8, router_state=ti.wan_router_state(tmp_path / "router.pt",
                                                      WAN_TINY.num_layers), seed=1, device="cpu")
    assert torch.equal(by_path.leaves[key], by_state.leaves[key])
    assert torch.equal(by_path.leaves[key][0].float(),
                       wan["blocks.0.router.linear.weight"].T.bfloat16().float())
    with pytest.raises(ValueError, match="not both"):
        qs.build_quantized_wan(WAN_TINY, 8, router_checkpoint=str(tmp_path / "router.pt"),
                               router_state={}, device="cpu")
    hy = {f"{stack}.{i}.router.linear.{p}": torch.randn(*sh, generator=g)
          for stack, n in (("transformer_blocks", HUNYUAN_TINY.dual_layers),
                           ("single_transformer_blocks", HUNYUAN_TINY.single_layers))
          for i in range(n)
          for p, sh in (("weight", (HUNYUAN_TINY.num_heads * 3, HUNYUAN_TINY.dim)),
                        ("bias", (HUNYUAN_TINY.num_heads * 3,)))}
    torch.save(hy, tmp_path / "hy_router.pt")
    _, (dual, single) = qs.build_quantized_hunyuan(
        HUNYUAN_TINY, 8, router_checkpoint=str(tmp_path / "hy_router.pt"), seed=1, device="cpu")
    assert torch.equal(single.leaves[key][1].float(),
                       hy["single_transformer_blocks.1.router.linear.weight"].T.bfloat16().float())


def test_module_constants_match_jax():
    import importlib

    for module, names in (("ops.flash_manual", ("NEG_INF",)),
                          ("ops.sta_pipe", ("NEG_INF", "LOG2E")),
                          ("ops.sta_window", ("NEG_INF",)),
                          ("ops.sta_row", ("NEG_INF", "LOG2E")),
                          ("ops.sta_batched", ("NEG_INF",)),
                          ("ops.flash_bwd", ("POS_BIG", "NEG_INF", "LOG2E"))):
        port = importlib.import_module(f"vorta_tpu_torch.{module}")
        ref = importlib.import_module(f"vorta_tpu.{module}")
        for name in names:
            assert getattr(port, name) == getattr(ref, name), (module, name)
            assert type(getattr(port, name)) is float


def test_parallel_and_training_names_match_jax():
    """The slice's other public names against their JAX namesakes: the
    parallel package's exports, the train-step factories' leading keywords
    (the groups stand for JAX's axis names, the optimizer is the caller's)."""
    import inspect

    import vorta_tpu.parallel as jparallel
    import vorta_tpu_torch.parallel as parallel
    from vorta_tpu.parallel import fsdp as jfsdp
    from vorta_tpu.training import step as jstep
    from vorta_tpu_torch.parallel import fsdp
    from vorta_tpu_torch.training import step

    public = {n for n in dir(jparallel) if not n.startswith("_")} - {
        "mesh", "ulysses", "fsdp"}
    assert public <= set(dir(parallel))
    assert callable(fsdp.sharded_block_fetcher) and callable(jfsdp.sharded_block_fetcher)
    for name in ("make_router_train_step", "make_hunyuan_router_train_step"):
        want = [p for p in inspect.signature(getattr(jstep, name)).parameters
                if p not in ("graphdef", "optimizer", "interpret")]
        got = list(inspect.signature(getattr(step, name)).parameters)
        assert [p for p in want if p.endswith("_axis")] == [
            "sp_axis", "dp_axis", "frozen_sharded_axis"]
        assert [p for p in got if p in ("sp_group", "dp_group", "frozen_sharded")] == [
            "sp_group", "dp_group", "frozen_sharded"]
        assert [p for p in want if not p.endswith("_axis")] == [
            p for p in got if p not in ("sp_group", "dp_group", "frozen_sharded",
                                        "remat_blocks")]
    assert callable(step.frozen_sharding_specs)


def test_chunked_recompute_matches_jax_autodiff():
    """attention_chunked_recompute against JAX's attention_chunked and its
    XLA autodiff (the chunk scan under jax.checkpoint): outputs and the q, k,
    v gradients, with a block mask, a kv bias and a q block that sees no
    key."""
    q, k, v, cot = _randn(71, *[(1, 2, 64, 16)] * 4)
    bm = np.random.default_rng(72).random((2, 4, 4)) < 0.6
    bm[:, :, 0] = True
    bm[1, 3] = False
    bias = np.zeros((1, 64), np.float32)
    bias[:, 40:48] = -1e30
    kw = dict(block_q=16, block_kv=16)

    def jloss(q, k, v):
        out = jattention_ref.attention_chunked(q, k, v, block_mask=jnp.asarray(bm),
                                               kv_bias=jnp.asarray(bias), **kw)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = attention_ref.attention_chunked_recompute(
        tq, tk, tv, block_mask=torch.from_numpy(bm), kv_bias=torch.from_numpy(bias), **kw)
    _close(got, want)
    for g, w in zip(torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(cot)), jgrads):
        _close(g, w)


def _parser_defaults(main, argv=()) -> dict:
    """{dest: default} of the argparse parser ``main`` builds (it is stopped
    at its parse)."""
    import argparse
    from unittest import mock

    seen = []

    def grab(self, *a, **kw):
        seen.append({act.dest: act.default for act in self._actions if act.dest != "help"})
        raise SystemExit(0)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab), \
            pytest.raises(SystemExit):
        main(*argv)
    return seen[0]


def test_evaluation_names_and_flags_match_jax():
    """The evaluation slice's public names against JAX's: io/quality's and
    io/profiling's functions (profiling's leading parameters too), the Wan
    pipeline's SamplingConfig fields and defaults (return_scores among
    them), and the flags and defaults of cli.sample, cli.bench_compare and
    the two tools, each with --device added."""
    import dataclasses
    import importlib.util
    import inspect
    from pathlib import Path

    import vorta_tpu.io.profiling as jprof
    import vorta_tpu.io.quality as jqual
    from vorta_tpu.pipelines.wan_t2v import SamplingConfig as JaxSampling
    from vorta_tpu_torch.cli import bench_compare, sample
    from vorta_tpu_torch.io import profiling as prof
    from vorta_tpu_torch.io import quality as qual
    from vorta_tpu_torch.pipelines.wan_t2v import SamplingConfig
    from vorta_tpu_torch.tools import calibrate_int8, fit_cache_poly

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and inspect.isfunction(getattr(mod, n))
                and getattr(mod, n).__module__ == mod.__name__}

    assert public(jqual) == public(qual)
    assert {"device_trace", "op_durations", "profile_call"} == public(jprof)
    assert public(jprof) <= public(prof)
    for name in public(jprof):
        want = list(inspect.signature(getattr(jprof, name)).parameters)
        assert list(inspect.signature(getattr(prof, name)).parameters)[:len(want)] == want
    assert {f.name: f.default for f in dataclasses.fields(SamplingConfig)} == {
        f.name: f.default for f in dataclasses.fields(JaxSampling)}

    repo = Path(__file__).resolve().parents[1]

    def jax_main(rel):
        spec = importlib.util.spec_from_file_location("_jax_" + rel.replace("/", "_")[:-3],
                                                      repo / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.main

    for rel, port_main in (("cli/sample.py", sample.parse_args),
                           ("cli/bench_compare.py", bench_compare.parse_args),
                           ("tools/calibrate_int8.py", calibrate_int8.main),
                           ("tools/fit_cache_poly.py", fit_cache_poly.parse_args)):
        jmain = jax_main(rel)
        want = _parser_defaults(jmain, () if rel.startswith("tools") else ([],))
        got = _parser_defaults(port_main, ([],))
        assert set(got) - set(want) == {"device"}, rel
        assert {k: v for k, v in got.items() if k != "device"} == want, rel
