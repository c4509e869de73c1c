"""The port's quantized serving at model level against the JAX package, on
the CPU: a tiny Wan (2 blocks, dim 128, 4 heads x 32, routed hard to all
three experts) with ``qk_int8`` + ``mm int8``, the calibration tables and
a static-scale forward, the model served from a quantized block stack (the
JAX model's own blocks quantized by the JAX package, carried across by
io/from_jax.block_stack_from_jax), and the CLI's four flags; the tiny
HunyuanVideo's: tests/test_torch_port_quant_hunyuan.py.  Which projections
run W8A8, and under which site name, is held to the JAX models' QLinears
one for one, for every Linear of both models.

Weights go from the JAX model to the port through io/from_jax.py; inputs
come from numpy.  JAX runs its Pallas kernels in interpret mode.
Tolerances: the quantized-stack forwards, f32 on both sides, rtol 1e-4 and
atol 1e-4 x the output's scale, as the other port tests (the dequantized
weights are equal); the calibration tables (max |x| in bf16 mode) rtol
1e-5.  With W8A8 and int8 QK the two sides quantize activations that agree
only to f32 rounding, and a value that close to a rounding boundary lands
on the other int8 step (1 / 127 of its row's amax): measured on these
models, the port against itself with its input perturbed by 1e-7 moves the
output by 0.2% (Wan) and 0.5% (HunyuanVideo) rel L2.  So the whole model is
held by rel L2 below INT8_REL = 0.02, and the ops that make it up are held
tightly in tests/test_torch_port_quant.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.config import WanModelConfig as JaxWanModelConfig
from vorta_tpu.models.wan import WanModel as JaxWanModel
from vorta_tpu.ops import quant as jquant
from vorta_tpu_torch.config import AttentionConfig, WanModelConfig
from vorta_tpu_torch.io.from_jax import block_stack_from_jax, wan_state_from_jax
from vorta_tpu_torch.models.wan import WanModel


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(dim=128, ffn_dim=256, num_heads=4, head_dim=32, num_layers=2, text_dim=32,
           text_len=16, freq_dim=32)
ATTN = dict(latent_shape=(4, 8, 8), sta_tile=(2, 2, 2), sta_window=(3, 3, 1),
            lowres_window=(2, 2, 2), block_q=16, block_kv=16, sta_block_q=8, sta_block_kv=8)
EXPERTS = [0, 1, 2, 2]  # FULL, LOWRES, STA, STA in every block
INT8_REL = 0.02


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


def _rel_l2(got, want) -> float:
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(state, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state, is_leaf=is_leaf)
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat}


def _qtree_flat(qtree) -> dict:
    """A JAX quantized stack as io/from_jax.block_stack_from_jax takes it."""
    out = {}
    for key, leaf in _flat(qtree, lambda x: isinstance(x, jquant.QTensor)).items():
        if isinstance(leaf, jquant.QTensor):
            leaf = dict(q=np.asarray(leaf.q), scale=np.asarray(leaf.scale), shape=leaf.shape,
                        dtype=leaf.dtype, bits=leaf.bits)
        out[key] = leaf if isinstance(leaf, dict) else np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def wan():
    jmodel = JaxWanModel(JaxWanModelConfig(**CFG), dtype=jnp.float32, rngs=nnx.Rngs(0))
    bias = 4.0 * np.eye(3, dtype=np.float32)[EXPERTS].reshape(-1)
    jmodel.blocks.router.linear.bias.value = jnp.asarray(np.tile(bias, (CFG["num_layers"], 1)))
    state = {k: np.asarray(v) for k, v in _flat(nnx.state(jmodel)).items()}
    cfg = WanModelConfig(**CFG)
    tmodel = WanModel(cfg, dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(wan_state_from_jax(state, cfg))
    rng = np.random.default_rng(0)
    inputs = (rng.standard_normal((1, 4, 16, 16, 16)).astype(np.float32),
              np.asarray([700.0], np.float32),
              rng.standard_normal((1, CFG["text_len"], CFG["text_dim"])).astype(np.float32))
    return jmodel, tmodel, state, inputs


def _wan_both(wan, attn: dict, **kw):
    jmodel, tmodel, _, inputs = wan
    jkw = {k: v for k, v in kw.items() if k != "quantized_blocks_port"}
    tkw = {k: v for k, v in kw.items() if k != "quantized_blocks"}
    if "quantized_blocks_port" in tkw:
        tkw["quantized_blocks"] = tkw.pop("quantized_blocks_port")
    ref = jmodel(*(jnp.asarray(x) for x in inputs), attn_cfg=JaxAttentionConfig(**attn),
                 interpret=True, **jkw)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(x) for x in inputs), attn_cfg=AttentionConfig(**attn),
                     **tkw)
    return got, ref


def test_wan_qk_int8_mm_int8_matches_jax(wan):
    """Routed hard with int8 QK (FULL, LOWRES) and W8A8 (the JAX model's
    QLinears), against the JAX model; and not the bf16 path."""
    attn = dict(ATTN, qk_int8=True)
    got, ref = _wan_both(wan, attn, routing_mode="hard", mm_precision="int8")
    assert (got.expert_ids == np.asarray(EXPERTS)).all()
    assert _rel_l2(got.sample, ref.sample) < INT8_REL
    with torch.no_grad():
        bf = wan[1](*(torch.from_numpy(x) for x in wan[3]), attn_cfg=AttentionConfig(**ATTN),
                    routing_mode="hard")
    assert 1e-3 < _rel_l2(got.sample, bf.sample.numpy()) < 0.05


def test_wan_calibration_and_static_scales_match_jax(wan):
    """calibrate_mm's per-layer max |x| tables, then a W8A8 forward with the
    static scales amax / 127 (routing off)."""
    attn = dict(latent_shape=(4, 8, 8), block_q=64, block_kv=64)
    got, ref = _wan_both(wan, attn, calibrate_mm=True)
    table, jtable = got.mm_calibration, ref.mm_calibration
    assert sorted(table) == sorted(jtable) == sorted(
        ["attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out", "attn2.to_q",
         "attn2.to_out", "ffn.proj_in", "ffn.proj_out"])
    for site in table:
        assert table[site].shape == (CFG["num_layers"],)
        np.testing.assert_allclose(table[site].numpy(), np.asarray(jtable[site]), rtol=1e-5)
    scales = {k: (v / 127.0).numpy() * np.float32(0.7) for k, v in table.items()}  # clips some
    del scales["ffn.proj_out"]  # a site absent from the table keeps dynamic scales
    got, ref = _wan_both(wan, attn, mm_precision="int8", act_scales=scales)
    assert _rel_l2(got.sample, ref.sample) < INT8_REL
    dyn, _ = _wan_both(wan, attn, mm_precision="int8")
    assert _rel_l2(got.sample, dyn.sample.numpy()) > 1e-4  # the scales took effect


@pytest.mark.parametrize("bits,routing", [(4, "hard"), (8, "off")])
def test_wan_quantized_blocks_match_jax(wan, bits, routing):
    """The JAX model's own block stack quantized by the JAX package (every
    leaf its decision takes, min_bytes 0), served by both through the
    model's block: the port's working block is its first."""
    jmodel, _, state, _ = wan
    _, bstate = nnx.split(jmodel.blocks)
    qtree = jquant.quantize_stacked_tree(jax.tree.map(np.asarray, bstate), bits=bits,
                                         min_bytes=0)
    qtree = jax.tree.map(jnp.asarray, qtree)
    stack = block_stack_from_jax(_qtree_flat(qtree), "blocks")
    assert sum(isinstance(w, type(stack.leaves[k])) for k, w in stack.leaves.items()) > 0
    attn = dict(ATTN) if routing == "hard" else dict(latent_shape=(4, 8, 8), block_q=64,
                                                      block_kv=64)
    fresh = WanModel(WanModelConfig(**CFG), dtype=torch.float32, device="cpu")
    fresh.load_state_dict(wan_state_from_jax(state, WanModelConfig(**CFG)))
    got, ref = _wan_both((jmodel, fresh, state, wan[3]), attn, routing_mode=routing,
                         quantized_blocks=qtree, quantized_blocks_port=stack)
    _close(got.sample, ref.sample)
    if routing == "hard":
        assert (got.expert_ids == np.asarray(EXPERTS)).all()


def test_cli_quantization_flags(tmp_path):
    """The sample CLI takes the JAX CLI's four flags (wan-tiny, CPU): int8 QK
    and W8A8 with a static-scale npz (the JAX tool's {site: (L,)} format)
    from an int4 stack; the checkpoint path names the unported importer."""
    from vorta_tpu_torch.cli.sample import main
    from vorta_tpu_torch.io.quant_serving import build_quantized_wan

    sites = ["attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out", "attn2.to_q",
             "attn2.to_out", "ffn.proj_in", "ffn.proj_out"]
    np.savez(tmp_path / "scales.npz", **{s: np.full(2, 0.05, np.float32) for s in sites})
    base = ["--model", "wan-tiny", "--device", "cpu", "--dtype", "fp32", "--random_embeds",
            "--num_frames", "13", "--height", "64", "--width", "64", "--num_inference_steps",
            "2"]
    res = main(base + ["--qk_int8", "--mm", "int8", "--act_scales", str(tmp_path / "scales.npz"),
                       "--quantize_blocks", "int4", "--output", str(tmp_path / "q.npy")])
    out = np.load(tmp_path / "q.npy")
    assert out.shape == (1, 4, 8, 8, 16) and np.isfinite(out).all() and len(res.routing) == 4
    plain = main(base + ["--output", str(tmp_path / "b.npy")])
    assert not np.allclose(np.load(tmp_path / "b.npy"), out)
    assert plain.latents.shape == res.latents.shape
    # the checkpoint path reads the file (tests/test_torch_port_torch_import.py
    # holds it to JAX's); a missing one raises
    with pytest.raises(FileNotFoundError):
        build_quantized_wan(WanModelConfig(**CFG), checkpoint=str(tmp_path / "dit.safetensors"),
                            device="cpu")


# the scanned stacks, whose layer index the JAX model's module paths lack
STACKS = ("blocks", "dual_blocks", "single_blocks")


def _jax_linears(model) -> dict:
    """{module path: QLinear's site (or None), or "plain" for nnx.Linear}."""
    from vorta_tpu.ops.qmm import QLinear as JaxQLinear

    return {".".join(map(str, path)): (mod.site if isinstance(mod, JaxQLinear) else "plain")
            for path, mod in model.iter_modules() if isinstance(mod, nnx.Linear)}


def _port_linears(model) -> dict:
    """The same from the port's modules, fused projections split into their
    JAX parts and the stacks' layer index dropped."""
    from vorta_tpu_torch.io.from_jax import FUSED
    from vorta_tpu_torch.ops.qmm import FusedLinear, QLinear

    out = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, torch.nn.Linear):
            continue
        parts = name.split(".")
        if parts[0] in STACKS:
            stack, name = parts[0], ".".join(parts[2:])
        entries = [(name, mod.site if isinstance(mod, QLinear) else "plain")]
        if isinstance(mod, FusedLinear):
            pre, names = next((p, n) for p, n, f in FUSED[stack] if name == p + f)
            sites = mod.sites or ("plain",) * len(names)
            entries = [(pre + n, site) for n, site in zip(names, sites)]
        for n, site in entries:
            out[f"{stack}.{n}" if parts[0] in STACKS else n] = site
    return out


def test_int8_sites_match_jax(wan):
    """Every Linear of both models: W8A8 exactly where the JAX model has a
    QLinear, with its site name (None: unnamed, dynamic scales), and the
    model's dtype where it has a plain nnx.Linear."""
    from vorta_tpu.models import hunyuan as jhunyuan
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanModel

    jw, tw = wan[0], wan[1]
    assert _port_linears(tw) == _jax_linears(jw)
    ported = _port_linears(HunyuanModel(HUNYUAN_TINY, device="meta"))
    jh = nnx.eval_shape(lambda: jhunyuan.HunyuanModel(jhunyuan.HUNYUAN_TINY, rngs=nnx.Rngs(0)))
    assert ported == _jax_linears(jh)
    assert ported["dual_blocks.ff_context.proj_in"] is None  # unnamed: int8, dynamic
    assert ported["context_embedder.blocks.0.ff.proj_out"] is None
    assert ported["dual_blocks.attn.add_q_proj"] == "plain"
    assert ported["dual_blocks.norm1_mod.linear"] == "plain"
