"""The port's quantized serving on a tiny HunyuanVideo (HUNYUAN_TINY, routing
off) against the JAX package, on the CPU: ``qk_int8`` + ``mm int8`` (the
joint FULL expert's int8 QK mode on both stacks, W8A8 on the JAX model's
QLinears, the text FFNs' unnamed ones too), the calibration tables of both
stacks' sites, and both stacks served from an int8 stack quantized by the
JAX package (io/from_jax.block_stack_from_jax).

Weights go from the JAX model to the port through io/from_jax.py; inputs
come from numpy; JAX runs its Pallas kernels in interpret mode.
Tolerances as in tests/test_torch_port_quant_models.py: the quantized-stack
forward rtol 1e-4 / atol 1e-4 x scale, the calibration tables rtol 1e-5,
the int8 forward rel L2 below INT8_REL = 0.02 (the port against itself with
its input perturbed by 1e-7 moves by 0.5%: activations that close to an
int8 rounding boundary land on the other step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.models import hunyuan as jhunyuan
from vorta_tpu.ops import quant as jquant
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.io.from_jax import block_stack_from_jax, hunyuan_state_from_jax
from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanModel


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HY_ATTN = dict(latent_shape=(4, 6, 16), sta_window=(3, 3, 3), sta_tile=(4, 6, 8),
               lowres_window=(2, 2, 2), block_q=32, block_kv=32)
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
def hunyuan():
    jmodel = jhunyuan.HunyuanModel(jhunyuan.HUNYUAN_TINY, rngs=nnx.Rngs(0))
    state = {k: np.asarray(v) for k, v in _flat(nnx.state(jmodel)).items()}
    rng = np.random.default_rng(1)
    cfg = HUNYUAN_TINY
    inputs = (rng.standard_normal((1, 4, 12, 32, 16)).astype(np.float32),
              np.asarray([600.0], np.float32),
              rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(np.float32),
              (np.arange(cfg.text_len) < 17)[None],
              rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32))
    return jmodel, state, inputs


def _hunyuan_both(hunyuan, attn: dict, stacks=None, **kw):
    jmodel, state, inputs = hunyuan
    tmodel = HunyuanModel(HUNYUAN_TINY, dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(hunyuan_state_from_jax(state, HUNYUAN_TINY))
    jkw, tkw = dict(kw), dict(kw)
    if stacks is not None:
        jkw["quantized_blocks"], tkw["quantized_blocks"] = stacks
    ref = jmodel(*(jnp.asarray(x) for x in inputs), guidance=jnp.asarray([6000.0]),
                 attn_cfg=JaxAttentionConfig(**attn), interpret=True, **jkw)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(x) for x in inputs), guidance=torch.tensor([6000.0]),
                     attn_cfg=AttentionConfig(**attn), **tkw)
    return got, ref


def test_hunyuan_qk_int8_mm_int8_matches_jax(hunyuan):
    """Routing off: the joint FULL expert's int8 QK mode on both stacks,
    W8A8 on the JAX model's QLinears (the text FFNs' unnamed ones too); the
    calibration tables of both stacks' sites."""
    got, ref = _hunyuan_both(hunyuan, dict(HY_ATTN, qk_int8=True), mm_precision="int8")
    assert _rel_l2(got.sample, ref.sample) < INT8_REL
    got, ref = _hunyuan_both(hunyuan, HY_ATTN, calibrate_mm=True)
    table, jtable = got.mm_calibration, ref.mm_calibration
    assert sorted(table) == sorted(jtable)
    assert {k.split(".")[0] for k in table} == {"dual", "single"}
    for site in table:
        np.testing.assert_allclose(table[site].numpy(), np.asarray(jtable[site]), rtol=1e-5)


def test_hunyuan_quantized_blocks_match_jax(hunyuan):
    """Both stacks int8-quantized by the JAX package (min_bytes 0), served
    through the port's first dual and single blocks, routing off."""
    jmodel = hunyuan[0]
    jstacks, tstacks = [], []
    for name in ("dual_blocks", "single_blocks"):
        _, bstate = nnx.split(getattr(jmodel, name))
        qtree = jax.tree.map(jnp.asarray, jquant.quantize_stacked_tree(
            jax.tree.map(np.asarray, bstate), bits=8, min_bytes=0))
        jstacks.append(qtree)
        tstacks.append(block_stack_from_jax(_qtree_flat(qtree), name))
    got, ref = _hunyuan_both(hunyuan, HY_ATTN, stacks=(tuple(jstacks), tuple(tstacks)))
    _close(got.sample, ref.sample)
