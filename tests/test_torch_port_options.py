"""The softmax options of the ported attention kernels and the fused
residual norm against the JAX package, on the CPU.

The stable softmax of flash_manual, sta_pipe and sta_batched, and sta_pipe's
diagnostic variants (dots, qk, sT), run in the port's plain versions against
the Pallas kernels in interpret mode, each once per feature; the fused
residual norm against the JAX package's fused_residual_norm, which takes its
reference path off the TPU, forward and the gradients of all seven inputs.
Inputs come from numpy with a seed and go to both sides.  Tolerances: f32 on
both sides, rtol 1e-4 and atol 1e-4 x the output's max abs value, as the
port's other kernel tests (the two sides sum in different orders); the norm
in f32 at rtol 1e-5 (atol 1e-5 x max), in bf16 at 2^-5 x the output's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorta_tpu.ops import fused_norm as jnorm
from vorta_tpu.ops import sta_pipe as jsta
from vorta_tpu.ops.flash_manual import sparse_flash_attention_manual as jax_manual
from vorta_tpu.ops.sta_batched import sta_flash_headbatched as jax_batched
from vorta_tpu_torch.ops.flash import tables_from_block_mask
from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual
from vorta_tpu_torch.ops.fused_norm import fused_residual_norm
from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched
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


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# --- fused_residual_norm ----------------------------------------------------------------

B, S, DIM = 2, 12, 64


def _norm_inputs(gate, mod, affine, beta, seed=3):
    x, d, g, sc, sh, ga, be = _randn(seed, (B, S, DIM), (B, S, DIM), (B, DIM), (B, DIM),
                                     (B, DIM), (DIM,), (DIM,))
    return (x, d, g if gate else None, 0.3 * sc if mod else None, sh if mod else None,
            1 + 0.2 * ga if affine else None, be if affine and beta else None)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gate,mod,affine,beta", [
    (False, False, False, False), (True, False, False, False), (False, True, False, False),
    (True, True, False, False), (False, False, True, False), (True, False, True, True),
    (True, True, True, False), (True, True, True, True),
])
def test_fused_residual_norm_matches_jax(gate, mod, affine, beta, dtype):
    arrs = _norm_inputs(gate, mod, affine, beta)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    jx = [None if a is None else jnp.asarray(a, jdt if i < 2 else jnp.float32)
          for i, a in enumerate(arrs)]
    tx = [None if a is None else torch.from_numpy(a).to(tdt if i < 2 else torch.float32)
          for i, a in enumerate(arrs)]
    want = jnorm.fused_residual_norm(*jx, 1e-6)
    got = fused_residual_norm(*tx, 1e-6)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        w = np.asarray(w, np.float32)
        if dtype == "f32":
            _close(g, w, rtol=1e-5, atol_rel=1e-5)
        else:  # bf16 outputs: a rounding apart at most
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                       atol=2.0**-5 * np.abs(w).max())


@pytest.mark.parametrize("gate,mod,affine,beta", [
    (True, True, True, True), (False, False, True, False), (True, False, False, False),
])
def test_fused_residual_norm_gradients_match_jax(gate, mod, affine, beta):
    """The gradients of every input present (all seven in the first case),
    through the port's autograd rule against the JAX package's custom VJP."""
    arrs = _norm_inputs(gate, mod, affine, beta, seed=5)
    w1, w2 = _randn(6, (B, S, DIM), (B, S, DIM))
    idx = [i for i, a in enumerate(arrs) if a is not None]

    def loss(*present):
        full = list(arrs)
        for i, a in zip(idx, present):
            full[i] = a
        xn, y = jnorm.fused_residual_norm(*full, 1e-6)
        return jnp.sum(xn * w1) + jnp.sum(y * w2)

    want = jax.grad(loss, argnums=tuple(range(len(idx))))(*(jnp.asarray(arrs[i]) for i in idx))
    tx = [None if a is None else torch.from_numpy(a).requires_grad_() for a in arrs]
    xn, y = fused_residual_norm(*tx, 1e-6)
    ((xn * torch.from_numpy(w1)).sum() + (y * torch.from_numpy(w2)).sum()).backward()
    for i, w in zip(idx, want):
        _close(tx[i].grad, w, rtol=1e-5, atol_rel=1e-5)


# --- flash_manual: the stable softmax ---------------------------------------------------

@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_manual_stable_matches_pallas(with_bias):
    """The JAX wrapper's default softmax: per-head counts with a head routed
    away (count 0), a kv_valid_len tail, and with kv_bias masking kv block 0
    (which q block 1 visits first) and random keys."""
    b, h, s, d, blk = 1, 3, 128, 32, 32
    q, k, v = _randn(21, *[(b, h, s, d)] * 3)
    rng = np.random.default_rng(22)
    bias = np.where(rng.random(s) < 0.3, -1e30, rng.standard_normal(s)).astype(np.float32)
    bias[:blk] = -1e30
    mask = rng.random((1, s // blk, s // blk)) < 0.7
    mask[:, :, 0] = True
    tab = tables_from_block_mask(mask)
    counts = np.broadcast_to(tab.kv_count, (h, s // blk)).copy()
    counts[1] = 0
    kw = dict(scale=0.9 * d**-0.5, block_q=blk, block_kv=blk, kv_valid_len=100)
    jb = dict(kv_bias=jnp.asarray(bias[None])) if with_bias else {}
    tb = dict(kv_bias=torch.from_numpy(bias[None])) if with_bias else {}
    want = jax_manual(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tab.kv_index),
                      jnp.asarray(counts), interpret=True, **jb, **kw)  # softmax: the default
    got = sparse_flash_attention_manual(*(torch.from_numpy(x) for x in (q, k, v)),
                                        tab.kv_index, torch.from_numpy(counts),
                                        softmax="stable", **tb, **kw)
    _close(got, want)
    assert not got[:, 1].any()


# --- sta_batched: the stable softmax -----------------------------------------------------

def test_sta_batched_stable_matches_pallas():
    """The joint layout of a (2, 2, 2) tile with pair bits and the text
    bias, the JAX wrapper's default (stable) softmax; head 1 routed away."""
    from vorta_tpu_torch.config import AttentionConfig
    from vorta_tpu_torch.ops import joint_experts as joint

    cfg = joint.JointConfig(AttentionConfig(latent_shape=(4, 4, 8), sta_tile=(2, 2, 2),
                                            lowres_window=(2, 2, 2)), 24)
    lay = joint.joint_layouts(cfg)["sta"]
    tables = joint._joint_sta_tables(cfg)
    q, k, v = _randn(31, *[(1, 3, lay.total, 16)] * 3)
    bias = joint._bias(torch.from_numpy(np.arange(24) < 17)[None], lay, cfg.video.seq_len)
    active = np.asarray([1, 0, 1], np.int32)
    kw = dict(tokens_per_tile=8, block_q=lay.block_q, block_kv=lay.block_kv, scale=0.3)
    want = jax_batched(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tables.kv_index),
                       jnp.asarray(tables.kv_count), jnp.asarray(active),
                       pair_bits=jnp.asarray(tables.pair_bits), kv_bias=jnp.asarray(bias.numpy()),
                       interpret=True, **kw)
    got = sta_flash_headbatched(*(torch.from_numpy(x) for x in (q, k, v)), tables.kv_index,
                                tables.kv_count, torch.from_numpy(active),
                                pair_bits=tables.pair_bits, kv_bias=bias, softmax="stable", **kw)
    _close(got, want)
    assert not got[:, 1].any()


# --- sta_pipe: the stable softmax and the diagnostic variants ----------------------------

@pytest.mark.parametrize("latent,tile,softmax,variant", [
    ((4, 6, 16), (2, 3, 8), "stable", "full"),  # tile_w 8-aligned: the per-w-tile branch
    ((4, 6, 16), (2, 3, 8), "fast", "dots"),
    ((4, 6, 16), (2, 3, 8), "fast", "qk"),
    ((4, 6, 16), (2, 3, 8), "fast", "sT"),
    ((8, 6, 20), (2, 3, 4), "stable", "dots"),  # tile_w | 8: the masked branch, the variant ignored
])
def test_sta_pipe_modes_match_pallas(latent, tile, softmax, variant):
    b, h, d = 1, 2, 32
    q, k, v = _randn(41, *[(b, h, int(np.prod(latent)), d)] * 3)
    active = np.asarray([1, 0], np.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=0.2, softmax=softmax,
              variant=variant)
    want = jsta.sta_pipe_attention(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(active),
                                   interpret=True, **kw)
    got = sta_pipe_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             torch.from_numpy(active), **kw)
    _close(got, want)
    assert not got[:, 1].any()
    if variant == "sT":  # the transposed scores give the fast full output
        full = sta_pipe_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  torch.from_numpy(active), **{**kw, "variant": "full"})
        _close(got, full.numpy())


@pytest.mark.parametrize("variant", ["full", "qk"])
def test_sta_pipe_stable_text_tail_matches_pallas(variant):
    """The joint text tail under the stable softmax (24 text keys, the last 7
    masked by the bias): after the full window, and after the qk variant,
    whose sums the stable tail rescales away as the TPU kernel's does."""
    latent, tile, lt = (4, 6, 16), (2, 3, 8), 24
    b, h, d = 1, 2, 32
    s = int(np.prod(latent))
    q, k, v, tk, tv = _randn(43, *[(b, h, s, d)] * 3, *[(b, h, lt, d)] * 2)
    bias = np.where(np.arange(lt) < 17, 0.0, -1e30).astype(np.float32)[None]
    active = np.asarray([1, 1], np.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=0.2, softmax="stable",
              variant=variant)
    want = jsta.sta_pipe_attention(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(active),
                                   text_k=jnp.asarray(tk), text_v=jnp.asarray(tv),
                                   text_bias=jnp.asarray(bias), interpret=True, **kw)
    got = sta_pipe_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             torch.from_numpy(active), text_k=torch.from_numpy(tk),
                             text_v=torch.from_numpy(tv), text_bias=torch.from_numpy(bias), **kw)
    _close(got, want)


def test_options_left_to_later_slices_raise():
    """f32 P (cast_p_to_v_dtype=False), per-head kv_valid and flash_manual's
    pair bits stay refused, naming their ROADMAP item; unknown modes and the int8
    mode with a stable softmax or a variant raise ValueError, as in JAX."""
    x = torch.zeros((1, 2, 4 * 6 * 16, 16))
    act = torch.ones(2)
    skw = dict(latent_shape=(4, 6, 16), tile=(2, 3, 8))
    with pytest.raises(NotImplementedError, match="item 11"):
        sta_pipe_attention(x, x, x, act, cast_p_to_v_dtype=False, **skw)
    for bad in (dict(softmax="exact"), dict(variant="dots_only")):
        with pytest.raises(ValueError):
            sta_pipe_attention(x, x, x, act, **skw, **bad)
    x8 = x.to(torch.int8)
    for bad in (dict(softmax="stable"), dict(variant="qk")):
        with pytest.raises(ValueError):
            sta_pipe_attention(x8, x8, x, act, qk_scale=torch.ones(2), **skw, **bad)
    tab = tables_from_block_mask(np.ones((1, 1, 1), bool))
    q = x[:, :, :32]
    fkw = dict(block_q=32, block_kv=32)
    for bad in (dict(kv_valid=torch.ones(2)), dict(pair_bits=torch.zeros((1, 1, 1))),
                dict(cast_p_to_v_dtype=False)):
        with pytest.raises(NotImplementedError, match="item 11"):
            sparse_flash_attention_manual(q, q, q, tab.kv_index, tab.kv_count, softmax="stable",
                                          **fkw, **bad)
    with pytest.raises(NotImplementedError, match="item 11"):
        sta_flash_headbatched(q, q, q, tab.kv_index, tab.kv_count, act, softmax="stable",
                              cast_p_to_v_dtype=False, **fkw)
