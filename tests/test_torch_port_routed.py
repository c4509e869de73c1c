"""The port's routed slice (hard routing, its experts and their kernels'
plain versions) against the JAX package, on the CPU.

Inputs come from numpy with a seed and go to both sides; the JAX package
runs its Pallas kernels in interpret mode.  Tolerances: f32 on both sides,
rtol 1e-4 and atol 1e-4 x the output's scale (its max abs value), as the
routing-off slice's tests: XLA-CPU and PyTorch sum in different orders.
Pooling is pure selection and is held to equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorta_tpu import geometry as jgeo
from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.ops import coreset as jcoreset
from vorta_tpu.ops import coreset_pallas as jpallas
from vorta_tpu.ops import experts as jexperts
from vorta_tpu.ops import layout as jlayout
from vorta_tpu.ops import routed_fused as jrouted
from vorta_tpu.ops import sta_pipe as jsta
from vorta_tpu.ops.flash_manual import sparse_flash_attention_manual as jax_manual
from vorta_tpu_torch import geometry as tgeo
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.ops import coreset, layout
from vorta_tpu_torch.ops.coreset_pallas import pool_qkv, unpool
from vorta_tpu_torch.ops.experts import FULL, LOWRES, STA, routed_attention
from vorta_tpu_torch.ops.flash import tables_from_block_mask
from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual
from vorta_tpu_torch.ops.routed_fused import fused_routed_attention, route_expert_ids
from vorta_tpu_torch.ops.sta_pipe import sta_pipe_attention, supports_pipe


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


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


# --- geometry and layout --------------------------------------------------------

GEOMS = [  # (latent, tile, window): clamped on every axis, and spanning axes whole
    ((8, 12, 20), (2, 3, 4), (3, 3, 3)),
    ((4, 6, 16), (2, 3, 8), (3, 3, 3)),
    ((20, 30, 52), (4, 6, 4), (3, 3, 3)),
    ((4, 4, 4), (2, 2, 2), (3, 3, 1)),
    ((6, 10, 14), (2, 2, 2), (5, 1, 3)),
]


@pytest.mark.parametrize("latent,tile,window", GEOMS)
def test_sta_geometry_matches_jax(latent, tile, window):
    from vorta_tpu.ops.sta_row import _row_starts, _w_window_starts
    from vorta_tpu.ops.sta_window import window_starts

    np.testing.assert_array_equal(tgeo.sta_tile_mask(latent, window, tile),
                                  jgeo.sta_tile_mask(latent, window, tile))
    np.testing.assert_array_equal(tgeo.window_starts(latent, tile, window),
                                  window_starts(latent, tile, window))
    np.testing.assert_array_equal(tgeo.row_starts(latent, tile, window),
                                  _row_starts(latent, tile, window))
    assert tgeo.w_window_starts(latent, tile, window) == _w_window_starts(latent, tile, window)
    perm = tgeo.tile_permutation(latent, tile)
    np.testing.assert_array_equal(perm, jgeo.tile_permutation(latent, tile))
    np.testing.assert_array_equal(tgeo.inverse_permutation(perm), jgeo.inverse_permutation(perm))
    tm = tgeo.sta_tile_mask(latent, window, tile)
    tpt = int(np.prod(tile))
    np.testing.assert_array_equal(tgeo.expand_tile_mask(tm, tpt, tpt // tile[0], tpt),
                                  jgeo.expand_tile_mask(tm, tpt, tpt // tile[0], tpt))
    assert supports_pipe(latent, tile, 128, window=window) == jsta.supports_pipe(
        latent, tile, 128, window=window)
    # the window spans an axis whole exactly where it is not narrower than it
    n = [latent[a] // tile[a] for a in range(3)]
    sees = tm.reshape(n + n).sum(axis=(3, 4, 5))
    assert (sees == np.prod([min(window[a], n[a]) for a in range(3)])).all()


@pytest.mark.parametrize("latent,window,rate", [((4, 6, 16), (2, 3, 2), 0.5),
                                                ((20, 30, 52), (2, 3, 2), 0.5),
                                                ((4, 8, 8), (2, 2, 2), 0.25)])
def test_lowres_groups_and_layout_match_jax(latent, window, rate):
    mine, ref = tgeo.build_lowres_groups(latent, window, rate), jgeo.build_lowres_groups(
        latent, window, rate)
    np.testing.assert_array_equal(mine.center, ref.center)
    np.testing.assert_array_equal(mine.margins, ref.margins)
    assert mine.num_kept_margins == ref.num_kept_margins
    assert mine.pooled_length == ref.pooled_length and mine.full_length == ref.full_length
    assert dataclasses.astuple(mine._geom) == dataclasses.astuple(ref._geom)
    x = np.random.default_rng(0).standard_normal((2, int(np.prod(latent)), 3)).astype(np.float32)
    got = layout.tile_sequence(torch.from_numpy(x), latent, window)
    np.testing.assert_array_equal(got.numpy(), jlayout.tile_sequence(jnp.asarray(x), latent, window))
    np.testing.assert_array_equal(layout.untile_sequence(got, latent, window).numpy(), x)


# --- coreset selection ----------------------------------------------------------

LATENT, WINDOW = (4, 6, 16), (2, 3, 2)


def _min_gap(q: np.ndarray, groups) -> float:
    """Smallest gap between two margins' ranking similarities."""
    sim = coreset.slot_similarity(coreset.group_view(torch.from_numpy(q), groups),
                                  groups._geom.center_slot)
    s = sim.sort(dim=-1).values[..., :-1]  # drop the center's +inf
    return (s[..., 1:] - s[..., :-1]).min().item()


def test_pool_by_similarity_matches_jax():
    groups, jgroups = tgeo.build_lowres_groups(LATENT, WINDOW), jgeo.build_lowres_groups(
        LATENT, WINDOW)
    q, k, _ = _qkv(0, (1, 2, int(np.prod(LATENT)), 32))
    pq, m = coreset.pool_by_similarity(torch.from_numpy(q), groups)
    pk, _ = coreset.pool_by_similarity(torch.from_numpy(k), groups, m)
    jq, jm = jcoreset.pool_by_similarity(jnp.asarray(q), jgroups)
    jk, _ = jcoreset.pool_by_similarity(jnp.asarray(k), jgroups, jm)
    np.testing.assert_array_equal(m.kept.numpy(), np.asarray(jm.kept))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    out = np.random.default_rng(1).standard_normal(pq.shape).astype(np.float32)
    np.testing.assert_array_equal(
        coreset.unpool_by_similarity(torch.from_numpy(out), groups, m).numpy(),
        np.asarray(jcoreset.unpool_by_similarity(jnp.asarray(out), jgroups, jm)))


def test_pool_qkv_and_unpool_match_pallas():
    """Picks equal at a seed whose smallest similarity gap is > 1e-4 (so no
    arg-min sits at a tie); pooled values, picks and unpool equal."""
    groups, jgroups = tgeo.build_lowres_groups(LATENT, WINDOW), jgeo.build_lowres_groups(
        LATENT, WINDOW)
    q, k, v = _qkv(3, (1, 3, int(np.prod(LATENT)), 32))
    assert _min_gap(q, groups) > 1e-4
    active = np.asarray([1, 0, 1], np.int32)
    got = pool_qkv(*(torch.from_numpy(x) for x in (q, k, v)), groups,
                   active=torch.from_numpy(active), return_picks=True)
    ref = jpallas.pool_qkv(*(jnp.asarray(x) for x in (q, k, v)), jgroups,
                           active=jnp.asarray(active), return_picks=True, interpret=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = np.random.default_rng(4).standard_normal(got[0].shape).astype(np.float32)
    up = unpool(torch.from_numpy(out), torch.from_numpy(q), groups,
                active=torch.from_numpy(active), picks=got[3])
    jup = jpallas.unpool(jnp.asarray(out), jnp.asarray(q), jgroups, active=jnp.asarray(active),
                         picks=ref[3], interpret=True)
    np.testing.assert_array_equal(up.numpy(), np.asarray(jup))
    # without picks the plain unpool derives Q's matching again
    again = unpool(torch.from_numpy(out), torch.from_numpy(q), groups,
                   active=torch.from_numpy(active))
    np.testing.assert_array_equal(again.numpy(), up.numpy())


# --- flash_manual -----------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("per_head_index", [False, True])
@pytest.mark.parametrize("valid", [None, 100, 120])
def test_flash_manual_matches_pallas(valid, per_head_index, d):
    """Fast softmax, per-head counts with heads routed away (count 0), and
    the tail rule (only block kv_valid_len // block_kv is cut)."""
    b, h, s, blk = 1, 3, 128, 32
    q, k, v = _qkv(5, (b, h, s, d))
    rng = np.random.default_rng(6)
    mask = rng.random((h if per_head_index else 1, s // blk, s // blk)) < 0.6
    mask[..., :, 0] = True
    tab = tables_from_block_mask(mask)
    counts = np.broadcast_to(tab.kv_count, (h, s // blk)).copy()
    counts[1] = 0  # a head routed away
    counts[2, 0] = 0
    kw = dict(scale=0.9 * d**-0.5, block_q=blk, block_kv=blk, kv_valid_len=valid)
    ref = jax_manual(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tab.kv_index),
                     jnp.asarray(counts), softmax="fast", interpret=True, **kw)
    got = sparse_flash_attention_manual(*(torch.from_numpy(x) for x in (q, k, v)),
                                        torch.from_numpy(tab.kv_index),
                                        torch.from_numpy(counts), softmax="fast", **kw)
    _close(got, ref)
    assert not got[:, 1].any() and not got[:, 2, :blk].any()


def test_flash_manual_unported_options_raise():
    """kv_bias, int8 QK and the stable softmax are served (the joint
    experts' text mask, quantized serving, the JAX wrapper's default
    softmax, held here to the Pallas kernel); per-head kv_valid and
    pair_bits still raise."""
    q = torch.zeros((1, 2, 32, 64))
    tab = tables_from_block_mask(np.ones((1, 1), bool))
    kw = dict(block_q=32, block_kv=32)
    qs, ks, vs = _qkv(9, (1, 2, 32, 64))
    want = jax_manual(*(jnp.asarray(x) for x in (qs, ks, vs)), jnp.asarray(tab.kv_index),
                      jnp.asarray(tab.kv_count), kv_valid_len=20, interpret=True, **kw)
    got = sparse_flash_attention_manual(*(torch.from_numpy(x) for x in (qs, ks, vs)),
                                        tab.kv_index, tab.kv_count, kv_valid_len=20,
                                        softmax="stable", **kw)
    _close(got, want)
    out = sparse_flash_attention_manual(q, q, q, tab.kv_index, tab.kv_count,
                                        kv_bias=torch.zeros((1, 32)), softmax="fast", **kw)
    assert out.shape == q.shape
    q8 = q.to(torch.int8)
    out = sparse_flash_attention_manual(q8, q8, q, tab.kv_index, tab.kv_count,
                                        qk_scale=torch.ones(2), softmax="fast", **kw)
    assert out.shape == q.shape and out.dtype == q.dtype
    for bad in (dict(kv_valid=torch.ones(2)), dict(pair_bits=torch.zeros((1, 1, 1)))):
        with pytest.raises(NotImplementedError):
            sparse_flash_attention_manual(q, q, q, tab.kv_index, tab.kv_count, **kw, **bad)


# --- sta_pipe ------------------------------------------------------------------------

@pytest.mark.parametrize("latent,tile", [
    ((8, 6, 32), (2, 3, 8)),   # tw a multiple of 8: the per-w-tile variant
    ((8, 6, 20), (2, 3, 4)),   # tw divides 8: the grouped-width variant
    ((8, 6, 30), (2, 3, 6)),   # neither: the masked-width variant
    ((4, 6, 16), (2, 3, 8)),   # the window spans t and h whole
])
def test_sta_pipe_matches_pallas(latent, tile):
    b, h, d = 1, 2, 32
    q, k, v = _qkv(7, (b, h, int(np.prod(latent)), d))
    active = np.asarray([1, 0], np.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=0.2)
    ref = jsta.sta_pipe_attention(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(active),
                                  interpret=True, **kw)
    got = sta_pipe_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             torch.from_numpy(active), **kw)
    _close(got, ref)
    assert not got[:, 1].any()


def test_sta_pipe_equals_tiled_flash_oracle():
    """The plain raster version equals the STA expert of the experts module
    (tile layout + tile-granular block tables, stable softmax)."""
    from vorta_tpu_torch.ops.experts import sta_attention

    cfg = AttentionConfig(latent_shape=(8, 12, 20), sta_tile=(2, 3, 4), sta_window=(3, 3, 3))
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, (1, 2, cfg.seq_len, 16)))
    got = sta_pipe_attention(q, k, v, torch.ones(2), latent_shape=cfg.latent_shape,
                             tile=cfg.sta_tile, window=cfg.sta_window)
    _close(got, sta_attention(q, k, v, cfg))


# --- routed dispatch ---------------------------------------------------------------------

# the geometry of tests/test_routed_fused.py: 128 tokens, 8-token tiles
ROUTED = dict(latent_shape=(4, 4, 8), sta_window=(3, 3, 3), sta_tile=(2, 2, 2),
              lowres_window=(2, 2, 2), lowres_reduction=0.5, block_q=32, block_kv=16,
              sta_block_q=8, sta_block_kv=8)
S_ROUTED = 128


def _routed_inputs(seed, b=2, h=4, d=8):
    q, k, v = _qkv(seed, (b, h, S_ROUTED, d))
    return (q, k, v), tuple(torch.from_numpy(x) for x in (q, k, v))


@pytest.fixture(scope="module")
def jax_fused_routed():
    """The JAX package's masked dispatch at ROUTED under one jit: the expert
    ids are traced (as in the JAX model), so the cases share one compile of
    its interpret-mode kernels; its outputs are the eager call's, bit for bit."""
    cfg = JaxAttentionConfig(**ROUTED)
    return jax.jit(lambda q, k, v, ids: jrouted.fused_routed_attention(q, k, v, ids, cfg,
                                                                      interpret=True))


@pytest.mark.parametrize("ids", [[FULL] * 4, [LOWRES] * 4, [STA] * 4,
                                 [FULL, LOWRES, STA, FULL], [STA, STA, LOWRES, STA]])
def test_fused_routed_matches_jax(ids, jax_fused_routed):
    (qn, kn, vn), (q, k, v) = _routed_inputs(sum(ids))
    ref = jax_fused_routed(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                           jnp.asarray(ids, jnp.int32))
    got = fused_routed_attention(q, k, v, torch.tensor(ids), AttentionConfig(**ROUTED))
    _close(got, ref)


def test_route_expert_ids_tau_matches_jax():
    scores = np.asarray([[[0.2, 0.5, 0.3], [0.31, 0.33, 0.36], [0.05, 0.05, 0.9]],
                         [[0.9, 0.05, 0.05], [0.1, 0.1, 0.8], [0.3, 0.4, 0.3]]], np.float32)
    got = route_expert_ids(torch.from_numpy(scores), 0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jrouted.route_expert_ids(jnp.asarray(scores), 0.4)))
    np.testing.assert_array_equal(got.numpy(), [LOWRES, FULL, STA])  # row 0 routes the batch


@pytest.mark.parametrize("mode", ["soft", "hard_ref", "hard"])
def test_routed_attention_matches_jax(mode):
    (qn, kn, vn), (q, k, v) = _routed_inputs(9)
    scores = jax.nn.softmax(3.0 * jax.random.normal(jax.random.PRNGKey(3), (2, 4, 3)), axis=-1)
    ref = jexperts.routed_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), scores,
                                    JaxAttentionConfig(**ROUTED), mode=mode, interpret=True)
    got = routed_attention(q, k, v, torch.from_numpy(np.array(scores)),
                           AttentionConfig(**ROUTED), mode=mode)
    _close(got, ref)
    if mode == "hard":  # and hard == hard_ref in the port itself
        _close(got, routed_attention(q, k, v, torch.from_numpy(np.array(scores)),
                                     AttentionConfig(**ROUTED), mode="hard_ref").numpy())


def test_unserved_geometries_and_options_raise(monkeypatch):
    ((qn, kn, vn), (q, k, v)) = _routed_inputs(10)
    ids = torch.tensor([FULL, STA, LOWRES, STA])
    # 12-token tiles: the JAX package's sta_batched tables refuse them (ValueError)
    bad = {**ROUTED, "sta_tile": (3, 2, 2)}
    with pytest.raises(ValueError, match="tokens_per_tile 12 must be a multiple of 8"):
        jrouted.routed_geometry(JaxAttentionConfig(**bad))
    with pytest.raises(ValueError, match="tokens_per_tile 12 must be a multiple of 8"):
        fused_routed_attention(q, k, v, ids, AttentionConfig(**bad))
    # qk_int8 is served: the STA heads stay bf16, bitwise
    out8 = fused_routed_attention(q, k, v, ids, AttentionConfig(**ROUTED, qk_int8=True))
    out = fused_routed_attention(q, k, v, ids, AttentionConfig(**ROUTED))
    torch.testing.assert_close(out8[:, ids == STA], out[:, ids == STA], rtol=0, atol=0)
    assert (out8[:, ids != STA] - out[:, ids != STA]).abs().mean() < 0.05 * out.abs().mean()
    # the per-head switch dispatch is served: equal to the JAX package's under
    # the same variable (this geometry takes its fused branch: sta_pipe), and
    # to the masked dispatch
    monkeypatch.setenv("VORTA_ROUTED_DISPATCH", "switch")
    got = fused_routed_attention(q, k, v, ids, AttentionConfig(**ROUTED))
    _close(got, jrouted.fused_routed_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                               jnp.asarray(ids.numpy(), jnp.int32),
                                               JaxAttentionConfig(**ROUTED), interpret=True))
    _close(got, out.numpy())
