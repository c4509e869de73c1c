"""The port's quantized serving ops against the JAX package, on the CPU: the
int8 QK modes of flash_manual and sta_pipe (plain versions vs Pallas in
interpret mode), per-head quantization, W8A8 projections, and the
block-stack packing (the routed dispatch and the joint experts under
``qk_int8``: tests/test_torch_port_quant_dispatch.py).

Inputs come from numpy with a seed and go to both sides.  The int8 kernels
take the same int8 q / k on both sides (quantized by the JAX package's own
per-head quantizer, which the port's equals bitwise), so their int32 scores
are exact on both; the rest runs in f32, rtol 1e-4 and atol 1e-4 x the
output's scale, as the other port tests.  W8A8: the int32 sums are exact,
so the products agree to f32 rounding (rtol 1e-6).  Packing is held to
equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vorta_tpu.ops import qmm as jqmm
from vorta_tpu.ops import quant as jquant
from vorta_tpu.ops import routed_fused as jrouted
from vorta_tpu.ops import sta_pipe as jsta
from vorta_tpu.ops.flash_manual import sparse_flash_attention_manual as jax_manual
from vorta_tpu_torch.ops import qmm, quant
from vorta_tpu_torch.ops.flash import tables_from_block_mask
from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual
from vorta_tpu_torch.ops.routed_fused import quantize_per_head
from vorta_tpu_torch.ops.sta_pipe import sta_pipe_attention


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


def _mean_rel(out, ref) -> float:
    """The JAX package's int8 quality measure (tests/test_routed_fused.py)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).mean() / max(np.abs(ref).mean(), 1e-6))


def _int8_qk(seed, shape, kshape=None):
    """int8 q, k and their (H,) qk_scale, quantized by the JAX package."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal(kshape or shape).astype(np.float32)
    q8, sq = jrouted._quantize_per_head(jnp.asarray(q))
    k8, sk = jrouted._quantize_per_head(jnp.asarray(k))
    return np.asarray(q8), np.asarray(k8), np.asarray(sq * sk)


def test_quantize_per_head_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 50, 16)).astype(np.float32)
    x[:, 1] *= 1e-3  # per-head scales differ
    xq, s = quantize_per_head(torch.from_numpy(x))
    jq, js = jrouted._quantize_per_head(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert xq.dtype == torch.int8 and int(xq.abs().max()) == 127


# --- the kernels' int8 QK modes: plain versions vs Pallas ------------------------------

@pytest.mark.parametrize("d,valid,with_bias", [(64, None, True), (128, 100, True),
                                               (64, 100, False)])
def test_flash_manual_int8_matches_pallas(d, valid, with_bias):
    """int8 q / k with per-head qk_scale, counts with a head routed away,
    kv_bias (masking all of kv block 0) and the kv_valid_len tail rule."""
    b, h, s, blk = 1, 3, 128, 32
    q8, k8, qk_scale = _int8_qk(40, (b, h, s, d))
    rng = np.random.default_rng(41)
    v = rng.standard_normal((b, h, s, d)).astype(np.float32)
    mask = rng.random((1, s // blk, s // blk)) < 0.7
    mask[:, :, 1] = True
    tab = tables_from_block_mask(mask)
    counts = np.broadcast_to(tab.kv_count, (h, s // blk)).copy()
    counts[1] = 0
    bias = None
    if with_bias:
        bias = np.where(rng.random(s) < 0.3, -1e30, 0.0).astype(np.float32)[None]
        bias[:, :blk] = -1e30
    kw = dict(scale=0.9 * d**-0.5, block_q=blk, block_kv=blk, kv_valid_len=valid)
    ref = jax_manual(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v), jnp.asarray(tab.kv_index),
                     jnp.asarray(counts), softmax="fast", interpret=True,
                     qk_scale=jnp.asarray(qk_scale),
                     kv_bias=None if bias is None else jnp.asarray(bias), **kw)
    got = sparse_flash_attention_manual(
        torch.from_numpy(q8), torch.from_numpy(k8), torch.from_numpy(v),
        torch.from_numpy(tab.kv_index), torch.from_numpy(counts), softmax="fast",
        qk_scale=torch.from_numpy(qk_scale),
        kv_bias=None if bias is None else torch.from_numpy(bias), **kw)
    assert got.dtype == torch.float32  # v's dtype
    _close(got, ref)
    assert not got[:, 1].any()


@pytest.mark.parametrize("latent,tile,lt", [
    ((4, 6, 16), (4, 6, 8), 24),   # the joint tests' window-dense geometry, text tail
    ((8, 6, 20), (2, 3, 4), 0),    # tw divides 8: the grouped-width variant, no text
])
def test_sta_pipe_int8_matches_pallas(latent, tile, lt):
    b, h, d = 2, 2, 16
    s = int(np.prod(latent))
    rng = np.random.default_rng(42)
    q8, k8, qk_scale = _int8_qk(43, (b, h, s, d))
    v = rng.standard_normal((b, h, s, d)).astype(np.float32)
    active = np.asarray([1, 0], np.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=0.3)
    text, jtext = {}, {}
    if lt:
        _, tk8, _ = _int8_qk(44, (b, h, s, d), (b, h, lt, d))
        tv = rng.standard_normal((b, h, lt, d)).astype(np.float32)
        bias = np.where(np.arange(lt) < lt - 5, 0.0, -1e30).astype(np.float32)[None]
        text = dict(text_k=torch.from_numpy(tk8), text_v=torch.from_numpy(tv),
                    text_bias=torch.from_numpy(bias))
        jtext = {k: jnp.asarray(t.numpy()) for k, t in text.items()}
    ref = jsta.sta_pipe_attention(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v),
                                  jnp.asarray(active), qk_scale=jnp.asarray(qk_scale),
                                  interpret=True, **kw, **jtext)
    got = sta_pipe_attention(torch.from_numpy(q8), torch.from_numpy(k8), torch.from_numpy(v),
                             torch.from_numpy(active), qk_scale=torch.from_numpy(qk_scale),
                             **kw, **text)
    _close(got, ref)
    assert not got[:, 1].any()


def test_int8_modes_check_their_inputs():
    """As the JAX wrappers: int8 q and k, the fast softmax, sta_pipe's full
    variant and an int8 text_k."""
    x = torch.zeros((1, 2, 32, 16))
    x8 = x.to(torch.int8)
    tab = tables_from_block_mask(np.ones((1, 1, 1), bool))
    kw = dict(block_q=32, block_kv=32, qk_scale=torch.ones(2))
    with pytest.raises(ValueError, match="int8"):
        sparse_flash_attention_manual(x, x, x, tab.kv_index, tab.kv_count, softmax="fast", **kw)
    with pytest.raises(ValueError, match="fast"):
        sparse_flash_attention_manual(x8, x8, x, tab.kv_index, tab.kv_count, softmax="stable",
                                      **kw)
    with pytest.raises(ValueError, match="fast"):  # the default is the stable softmax
        sparse_flash_attention_manual(x8, x8, x, tab.kv_index, tab.kv_count, **kw)
    out = sparse_flash_attention_manual(x8, x8, x.bfloat16(), tab.kv_index, tab.kv_count,
                                        softmax="fast", **kw)
    assert out.dtype == torch.bfloat16
    skw = dict(latent_shape=(2, 4, 4), tile=(2, 4, 4), qk_scale=torch.ones(2))
    with pytest.raises(ValueError, match="variant"):
        sta_pipe_attention(x8, x8, x, torch.ones(2), variant="sT", **skw)
    with pytest.raises(ValueError, match="text_k"):
        sta_pipe_attention(x8, x8, x, torch.ones(2), text_k=x[:, :, :8], text_v=x[:, :, :8],
                           **skw)


# --- W8A8 projections ------------------------------------------------------------------

def _linear_inputs(seed, k=48, n=40, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 7, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)  # JAX layout (K, N)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    return x, w, b


@pytest.mark.parametrize("static,bias", [(False, True), (True, True), (False, False)])
def test_int8_linear_matches_jax(static, bias):
    x, w, b = _linear_inputs(50, bias=bias)
    xs = np.float32(np.abs(x).max() / 127.0 * 0.8) if static else None  # clips the largest
    ref = jqmm.int8_linear(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                           x_scale=None if xs is None else jnp.asarray(xs))
    got = qmm.int8_linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                          None if b is None else torch.from_numpy(b),
                          x_scale=None if xs is None else torch.tensor(xs))
    _close(got, ref, rtol=1e-6, atol_rel=1e-6)
    plain = x @ w + (0 if b is None else b)
    assert 0 < _mean_rel(got, plain) < 0.05


def _jax_qlinears(ws, bs, sites):
    out = []
    for i, (w, b, site) in enumerate(zip(ws, bs, sites)):
        lin = jqmm.QLinear(w.shape[0], w.shape[1], site=site, rngs=nnx.Rngs(i))
        lin.kernel.value = jnp.asarray(w)
        lin.bias.value = jnp.asarray(b)
        out.append(lin)
    return out


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("table", [None, {"a": 0.02}, {"a": 0.02, "b": 0.03}])
def test_fused_linear_matches_jax(precision, table):
    """One product for three QLinears (the last one unnamed): the activation
    quantized once, by the max of the sites' static scales, dynamic where
    none of them is in the table; the calibration records the input's amax
    for each named site."""
    rng = np.random.default_rng(51)
    x = rng.standard_normal((1, 9, 32)).astype(np.float32)
    ws = [(rng.standard_normal((32, n)) / 6).astype(np.float32) for n in (16, 24, 8)]
    bs = [rng.standard_normal(n).astype(np.float32) for n in (16, 24, 8)]
    sites = ("a", "b", None)
    jlins = _jax_qlinears(ws, bs, sites)
    jtable = None if table is None else {k: jnp.float32(v) for k, v in table.items()}
    with jqmm.mm_precision(precision), jqmm.layer_act_scales(jtable), \
            jqmm.calibration_scope() as jsink:
        ref = jqmm.fused_linear(jnp.asarray(x), jlins)
    fl = qmm.FusedLinear(32, (16, 24, 8), sites=sites)
    with torch.no_grad():
        fl.weight.copy_(torch.from_numpy(np.concatenate(ws, axis=1).T.copy()))
        fl.bias.copy_(torch.from_numpy(np.concatenate(bs)))
    with qmm.mm_precision(precision), qmm.layer_act_scales(table), \
            qmm.calibration_scope() as sink:
        got = fl(torch.from_numpy(x))
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-6, atol_rel=1e-6)
    assert sorted(sink) == sorted(jsink) == ["a", "b"]
    for s in sink:
        assert float(sink[s]) == float(jsink[s])
    # the scopes are reset on exit: nothing leaks into the next call
    assert qmm.current_mm_precision() == "bf16"
    assert qmm._ACT_SCALES.get() is None and qmm._CALIB.get() is None


def test_qlinear_switch_and_plain_linears():
    """QLinear obeys the switch, a plain FusedLinear (sites=None) does not."""
    x = torch.randn(1, 20, 32)
    q = qmm.QLinear(32, 16, site="s")
    plain = qmm.FusedLinear(32, (16,))
    with torch.no_grad():
        plain.weight.copy_(q.weight)
        plain.bias.copy_(q.bias)
        with qmm.mm_precision("int8"):
            y8, yp = q(x), plain(x)[0]
    ref = torch.nn.functional.linear(x, q.weight, q.bias)
    torch.testing.assert_close(yp, ref, rtol=0, atol=0)
    assert not torch.equal(y8, ref) and _mean_rel(y8.detach(), ref.detach()) < 0.05
    with pytest.raises(ValueError, match="bf16|int8"):
        qmm.mm_precision("fp8").__enter__()


# --- block-stack packing ---------------------------------------------------------------

STATE_SHAPES = {  # leaf decisions at min_bytes 4096 on the JAX layout (L, ..., in, out)
    "['a']['kernel'].value": (2, 16, 40),    # quantized
    "['b']['kernel'].value": (2, 12, 40),    # in % 8 != 0: stays (its (out, in) is 40 x 12)
    "['c']['bias'].value": (2, 800),         # ndim 2: stays
    "['d']['kernel'].value": (2, 8, 8),      # under min_bytes: stays
    "['e']['table'].value": (2, 3, 8, 24),   # quantized, the amax over axes 1 and 2
}


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_stacked_tree_matches_jax(bits):
    rng = np.random.default_rng(52)
    state = {k: rng.standard_normal(s).astype(np.float32) for k, s in STATE_SHAPES.items()}
    ref = jquant.quantize_stacked_tree(state, bits=bits, min_bytes=4096)
    got = quant.quantize_stacked_tree({k: torch.from_numpy(v) for k, v in state.items()},
                                      bits=bits, min_bytes=4096)
    for key in state:
        r, g = ref[key], got[key]
        assert isinstance(r, jquant.QTensor) == isinstance(g, quant.QTensor), key
        if isinstance(g, quant.QTensor):
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(r.q))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(r.scale))
            assert g.shape == tuple(r.shape) and g.bits == r.bits == bits
            np.testing.assert_array_equal(quant.dequantize(g).numpy(),
                                          np.asarray(jquant.dequantize(r)))
            for i in range(2):  # one layer, as a forward reads it
                np.testing.assert_array_equal(quant.dequantize(g, i).numpy(),
                                              np.asarray(jquant.dequantize(r))[i])
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert quant.quantized_bytes(got) == jquant.quantized_bytes(ref)
    assert sorted(k for k, v in got.items() if isinstance(v, quant.QTensor)) == [
        "['a']['kernel'].value", "['e']['table'].value"]


def test_block_leaves_and_random_stack_match_jax():
    """The JAX leaves of a port block (names, layout, flattening order), and
    the random one-block-tiled stack drawn from a seed, leaf for leaf."""
    from vorta_tpu.config import WanModelConfig as JaxWanModelConfig
    from vorta_tpu.io import quant_serving as jqs
    from vorta_tpu.models.wan import WanModel as JaxWanModel
    from vorta_tpu_torch.config import WanModelConfig
    from vorta_tpu_torch.io.from_jax import block_leaf_shapes
    from vorta_tpu_torch.io.quant_serving import random_block_stack
    from vorta_tpu_torch.models.wan import WanModel

    cfg = dict(dim=256, ffn_dim=512, num_heads=2, head_dim=128, num_layers=40, text_dim=32,
               text_len=16, freq_dim=32)  # 256 x 256 f32 over 40 layers: quantized
    abs_model = nnx.eval_shape(lambda: JaxWanModel(JaxWanModelConfig(**cfg), dtype=jnp.bfloat16,
                                                   param_dtype=jnp.bfloat16, rngs=nnx.Rngs(0)))
    _, abs_blocks = nnx.split(abs_model.blocks)
    flat = jax.tree_util.tree_flatten_with_path(abs_blocks)[0]
    block = WanModel(WanModelConfig(**{**cfg, "num_layers": 1}), device="cpu").blocks[0]
    assert list(block_leaf_shapes("blocks", block, 40).items()) == [
        (jax.tree_util.keystr(kp), tuple(leaf.shape)) for kp, leaf in flat]
    ref = jqs._cast_unquantized_to(jqs._random_quantized_tiled(abs_blocks, 40, 4, 3))
    ref = {jax.tree_util.keystr(kp): leaf for kp, leaf in jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, jquant.QTensor))[0]}
    got = random_block_stack("blocks", block, 40, 4, 3, "cpu")
    n_quantized = 0
    for key, r in ref.items():
        g = got.leaves[key]
        if isinstance(r, jquant.QTensor):
            n_quantized += 1
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(r.q))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(r.scale))
            assert g.dtype == torch.bfloat16 and g.shape == tuple(r.shape)
        else:
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))
    assert n_quantized == 10 and got.num_layers == 40  # attn1 x4, attn2 x4, ffn x2
