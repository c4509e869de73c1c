"""The window-dense STA kernels in f32 and the int8 QK modes with an f32 v,
on the CPU against the JAX package: the plain versions of sta_window and
sta_row, and of flash_manual's and sta_pipe's int8 modes with f32 v (the
functions the card's f32 kernels are held to), against the Pallas kernels
in interpret mode; a 2-block Wan forward in f32 at tile (4, 9, 10) (the STA
heads on sta_window) and one with ``qk_int8``, each against the JAX
package's WanModel with the weights carried over by io/from_jax.

Inputs are drawn with numpy from a seed and go to both sides; the int8
modes take the same int8 q / k on both (quantized by the JAX package's own
per-head quantizer), so their int32 scores are exact on both.  At these
small shapes the JAX package's VMEM gate would give the (4, 9, 10) heads to
sta_pipe, so the model tests turn that gate off in both packages, as
tests/test_torch_port_sta_fallbacks.py does.  Tolerances: the kernels rtol
1e-5 and atol 1e-5 x the output's max |value|; the models rtol 1e-4 and
atol 1e-4 x max (f32 on both sides, summed in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.config import WanModelConfig as JaxWanModelConfig
from vorta_tpu.models.wan import WanModel as JaxWanModel
from vorta_tpu.ops import routed_fused as jrouted
from vorta_tpu.ops import sta_pipe as jsta_pipe
from vorta_tpu.ops.flash_manual import sparse_flash_attention_manual as jax_manual
from vorta_tpu.ops.sta_row import sta_row_attention as jax_row
from vorta_tpu.ops.sta_window import sta_window_attention as jax_window
from vorta_tpu_torch.config import AttentionConfig, WanModelConfig
from vorta_tpu_torch.io.from_jax import wan_state_from_jax
from vorta_tpu_torch.models.wan import WanModel
from vorta_tpu_torch.ops import routed_fused as routed
from vorta_tpu_torch.ops.flash import tables_from_block_mask
from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual
from vorta_tpu_torch.ops.sta_pipe import sta_pipe_attention
from vorta_tpu_torch.ops.sta_row import sta_row_attention
from vorta_tpu_torch.ops.sta_window import sta_window_attention


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-6))


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _int8_qk(seed, shape, kshape=None):
    """int8 q, k and their (H,) qk_scale, quantized by the JAX package."""
    q, k = _randn(seed, shape, kshape or shape)
    q8, sq = jrouted._quantize_per_head(jnp.asarray(q))
    k8, sk = jrouted._quantize_per_head(jnp.asarray(k))
    return np.asarray(q8), np.asarray(k8), np.asarray(sq * sk)


def _both(x):
    """(jax array, torch tensor) of a numpy array, or (None, None)."""
    return (None, None) if x is None else (jnp.asarray(x), torch.from_numpy(x))


# --- sta_window and sta_row in f32 --------------------------------------------------

@pytest.mark.parametrize("kernel", ["sta_window", "sta_row"])
@pytest.mark.parametrize("text", [False, True])
def test_window_dense_f32_matches_pallas(kernel, text):
    """Both kernels at a geometry both take (tile_w 8), the stable softmax
    over the clamped window, with and without the text tail (24 keys, 19
    valid: not a multiple of the card kernels' 64-key chunks), a head
    inactive; the output stays f32."""
    shape, tile = (4, 6, 32), (2, 3, 8)
    s = int(np.prod(shape))
    q, k, v, tk, tv = _randn(21, *[(1, 3, s, 32)] * 3, *[(1, 3, 24, 32)] * 2)
    active = np.asarray([1, 0, 1], np.int32)
    tb = np.where(np.arange(24) < 19, 0.0, -1e30).astype(np.float32)[None]
    kw = dict(latent_shape=shape, tile=tile, window=(3, 3, 3), scale=0.2)
    jt, tt = {}, {}
    if text:
        for name, x in (("text_k", tk), ("text_v", tv), ("text_bias", tb)):
            jt[name], tt[name] = _both(x)
    jfn, fn = {"sta_window": (jax_window, sta_window_attention),
               "sta_row": (jax_row, sta_row_attention)}[kernel]
    want = jfn(*(jnp.asarray(x) for x in (q, k, v, active)), interpret=True, **kw, **jt)
    got = fn(*(torch.from_numpy(x) for x in (q, k, v, active)), **kw, **tt)
    _close(got, want, 1e-5)
    assert not got[:, 1].any()


# --- int8 q / k with an f32 v ----------------------------------------------------------

@pytest.mark.parametrize("valid,with_bias", [(120, True), (None, True), (100, False)])
def test_flash_manual_int8_f32_v_matches_pallas(valid, with_bias):
    """int8 q / k with the per-head qk_scale and an f32 v: kv_bias masking
    all of kv block 0, the kv_valid_len tail rule, a head routed away; the
    output is v's f32."""
    b, h, s, d, blk = 1, 3, 128, 32, 32
    q8, k8, qk_scale = _int8_qk(22, (b, h, s, d))
    (v,) = _randn(23, (b, h, s, d))
    mask = np.random.default_rng(24).random((1, s // blk, s // blk)) < 0.7
    mask[:, :, 1] = True
    tab = tables_from_block_mask(mask)
    counts = np.broadcast_to(tab.kv_count, (h, s // blk)).copy()
    counts[1] = 0
    bias = None
    if with_bias:
        bias = np.where(np.random.default_rng(25).random(s) < 0.3, -1e30,
                        0.0).astype(np.float32)[None]
        bias[:, :blk] = -1e30
    kw = dict(scale=0.9 * d**-0.5, block_q=blk, block_kv=blk, kv_valid_len=valid,
              softmax="fast")
    args = (q8, k8, v, tab.kv_index, counts)
    jb, tb = _both(bias)
    want = jax_manual(*(jnp.asarray(x) for x in args), qk_scale=jnp.asarray(qk_scale),
                      kv_bias=jb, interpret=True, **kw)
    got = sparse_flash_attention_manual(*(torch.from_numpy(x) for x in args),
                                        qk_scale=torch.from_numpy(qk_scale), kv_bias=tb, **kw)
    _close(got, want, 1e-5)
    assert not got[:, 1].any()


def test_int8_qk_takes_only_the_fast_softmax_as_jax():
    """The stable softmax with qk_scale raises ValueError in both packages,
    whatever v's dtype; so does an int8 q with a non-int8 k."""
    q8, k8, qk_scale = _int8_qk(26, (1, 2, 32, 32))
    (v,) = _randn(27, (1, 2, 32, 32))
    tab = tables_from_block_mask(np.ones((1, 1, 1), bool))
    kw = dict(block_q=32, block_kv=32)
    for softmax, k in (("stable", k8), ("fast", k8.astype(np.float32))):
        args = (q8, k, v, tab.kv_index, tab.kv_count)
        with pytest.raises(ValueError):
            jax_manual(*(jnp.asarray(x) for x in args), qk_scale=jnp.asarray(qk_scale),
                       softmax=softmax, interpret=True, **kw)
        with pytest.raises(ValueError):
            sparse_flash_attention_manual(*(torch.from_numpy(x) for x in args),
                                          qk_scale=torch.from_numpy(qk_scale), softmax=softmax,
                                          **kw)


@pytest.mark.parametrize("latent,tile,lt", [
    ((4, 6, 16), (4, 6, 8), 24),   # a window-dense tile with int8 text keys (19 valid)
    ((4, 9, 20), (4, 9, 10), 0),   # the (4, 9, 10) tile: tile_w 10, no text
])
def test_sta_pipe_int8_f32_v_matches_pallas(latent, tile, lt):
    b, h, d = 1, 2, 32
    s = int(np.prod(latent))
    q8, k8, qk_scale = _int8_qk(28, (b, h, s, d))
    (v,) = _randn(29, (b, h, s, d))
    active = np.asarray([1, 0], np.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=0.3)
    jt, tt = {}, {}
    if lt:
        _, tk8, _ = _int8_qk(30, (b, h, s, d), (b, h, lt, d))
        (tv,) = _randn(31, (b, h, lt, d))
        tb = np.where(np.arange(lt) < lt - 5, 0.0, -1e30).astype(np.float32)[None]
        for name, x in (("text_k", tk8), ("text_v", tv), ("text_bias", tb)):
            jt[name], tt[name] = _both(x)
    args = (q8, k8, v, active)
    want = jsta_pipe.sta_pipe_attention(*(jnp.asarray(x) for x in args),
                                        qk_scale=jnp.asarray(qk_scale), interpret=True, **kw,
                                        **jt)
    got = sta_pipe_attention(*(torch.from_numpy(x) for x in args),
                             qk_scale=torch.from_numpy(qk_scale), **kw, **tt)
    _close(got, want, 1e-5)
    assert not got[:, 1].any()


# --- 2-block Wan forwards in f32 against the JAX model -----------------------------------

CFG = dict(dim=128, ffn_dim=256, num_heads=4, head_dim=32, num_layers=2, text_dim=32,
           text_len=16, freq_dim=32)
ATTN_4910 = dict(latent_shape=(4, 9, 20), sta_tile=(4, 9, 10), sta_window=(3, 3, 3),
                 lowres_window=(2, 3, 2), block_q=32, block_kv=32)
EXPERTS = [0, 1, 2, 2]  # FULL, LOWRES, STA, STA in every block


@pytest.fixture(scope="module")
def wan():
    jmodel = JaxWanModel(JaxWanModelConfig(**CFG), dtype=jnp.float32, rngs=nnx.Rngs(0))
    bias = 4.0 * np.eye(3, dtype=np.float32)[EXPERTS].reshape(-1)
    jmodel.blocks.router.linear.bias.value = jnp.asarray(np.tile(bias, (CFG["num_layers"], 1)))
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(jmodel))
    state = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}
    cfg = WanModelConfig(**CFG)
    tmodel = WanModel(cfg, dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(wan_state_from_jax(state, cfg))
    grid = ATTN_4910["latent_shape"]
    lat, ctx = _randn(32, (1, grid[0], 2 * grid[1], 2 * grid[2], 16),
                      (1, CFG["text_len"], CFG["text_dim"]))
    return jmodel, tmodel, (lat, np.asarray([700.0], np.float32), ctx)


@pytest.mark.parametrize("qk_int8", [False, True])
def test_wan_f32_at_4910_matches_jax(wan, qk_int8, monkeypatch):
    """Routed hard, the STA heads at tile (4, 9, 10) on sta_window (the VMEM
    gate that would give them sta_pipe at this small shape off in both
    packages); with ``qk_int8`` FULL and LOWRES take int8 q / k with the
    f32 v (STA stays unquantized, as in the JAX package)."""
    for mod in (jrouted, jsta_pipe, routed):
        monkeypatch.setattr(mod, "supports_pipe", lambda *a, **k: False)
    attn = dict(ATTN_4910, qk_int8=qk_int8)
    assert routed.routed_sta_kernel(AttentionConfig(**attn), 32, 4) == "sta_window"
    jmodel, tmodel, inputs = wan
    want = jmodel(*(jnp.asarray(x) for x in inputs), attn_cfg=JaxAttentionConfig(**attn),
                  routing_mode="hard", interpret=True)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(x) for x in inputs), attn_cfg=AttentionConfig(**attn),
                     routing_mode="hard")
    assert (got.expert_ids == np.asarray(EXPERTS)).all()
    _close(got.sample, want.sample, 1e-4)
