"""The port's joint (video + text) experts and the new features of their
kernels' plain versions against the JAX package, on the CPU.

Inputs come from numpy with a seed and go to both sides; the JAX package
runs its Pallas kernels in interpret mode.  The joint geometry is
window-dense, as HunyuanVideo's own: latent (4, 6, 16), STA tile (4, 6, 8)
(192 tokens), text 24 with 17 valid, so the JAX package takes its
window-dense STA branch (sta_pipe with the text tail).  Tolerances: f32 on
both sides, rtol 1e-4 and atol 1e-4 x the output's scale (its max abs
value); pooling is pure selection and is held to equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorta_tpu import geometry as jgeo
from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.ops import coreset_pallas as jpallas
from vorta_tpu.ops import joint_experts as jjoint
from vorta_tpu.ops import sta_pipe as jsta
from vorta_tpu.ops.flash_manual import sparse_flash_attention_manual as jax_manual
from vorta_tpu.ops.sta_row import supports_row_dense as jax_supports_row_dense
from vorta_tpu.ops.sta_window import prefer_window_dense as jax_prefer_window_dense
from vorta_tpu_torch import geometry as tgeo
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.ops import coreset
from vorta_tpu_torch.ops import joint_experts as joint
from vorta_tpu_torch.ops.coreset_pallas import pool_qkv, unpool
from vorta_tpu_torch.ops.experts import FULL, LOWRES, STA
from vorta_tpu_torch.ops.flash import tables_from_block_mask
from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual
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


VIDEO = dict(latent_shape=(4, 6, 16), sta_window=(3, 3, 3), sta_tile=(4, 6, 8),
             lowres_window=(2, 2, 2), block_q=32, block_kv=32)
L, EFF = 24, 17  # padded text length, valid text tokens
SV = 4 * 6 * 16


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * max(np.abs(want).max(), 1e-6))


def _jcfgs(**video):
    video = {**VIDEO, **video}
    text_len = video.pop("text_len", L)
    return (joint.JointConfig(AttentionConfig(**video), text_len),
            jjoint.JointConfig(JaxAttentionConfig(**video), text_len))


def _inputs(seed, b=2, h=3, d=16, sv=SV, lt=L, eff=EFF):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for n in (sv, sv, sv, lt, lt, lt)]
    mask = np.broadcast_to(np.arange(lt) < eff, (b, lt)).copy()
    return arrs + [mask]


def _both(arrs):
    return [torch.from_numpy(a) for a in arrs], [jnp.asarray(a) for a in arrs]


# --- the kernels' new features: plain versions vs Pallas ----------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("valid", [None, 100])
def test_flash_manual_kv_bias_matches_pallas(valid, d):
    """kv_bias added in the log2 domain, with and without the kv_valid_len
    tail; the bias masks all of kv block 0, which q block 1 visits first."""
    b, h, s, blk = 1, 3, 128, 32
    rng = np.random.default_rng(20)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    bias = np.where(rng.random(s) < 0.3, -1e30, rng.standard_normal(s)).astype(np.float32)
    bias[:blk] = -1e30
    mask = rng.random((1, s // blk, s // blk)) < 0.7
    mask[:, :, 1] = True
    tab = tables_from_block_mask(mask)
    counts = np.broadcast_to(tab.kv_count, (h, s // blk)).copy()
    counts[1] = 0  # a head routed away
    kw = dict(scale=0.9 * d**-0.5, block_q=blk, block_kv=blk, kv_valid_len=valid)
    ref = jax_manual(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tab.kv_index),
                     jnp.asarray(counts), kv_bias=jnp.asarray(bias[None]), softmax="fast",
                     interpret=True, **kw)
    got = sparse_flash_attention_manual(*(torch.from_numpy(x) for x in (q, k, v)),
                                        torch.from_numpy(tab.kv_index), torch.from_numpy(counts),
                                        kv_bias=torch.from_numpy(bias[None]), softmax="fast", **kw)
    _close(got, ref)
    assert not got[:, 1].any()


@pytest.mark.parametrize("latent,tile,lt,with_bias", [
    ((4, 6, 16), (4, 6, 8), 24, True),   # the joint tests' window-dense geometry
    ((8, 6, 32), (2, 3, 8), 16, True),   # clamped windows on t and w
    ((8, 6, 20), (2, 3, 4), 8, False),   # no text_bias: zeros
])
def test_sta_pipe_text_tail_matches_pallas(latent, tile, lt, with_bias):
    b, h, d = 2, 2, 16
    rng = np.random.default_rng(21)
    s = int(np.prod(latent))
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    tk, tv = (rng.standard_normal((b, h, lt, d)).astype(np.float32) for _ in range(2))
    bias = np.where(np.arange(lt) < lt - 5, 0.0, -1e30).astype(np.float32)[None]
    active = np.asarray([1, 0], np.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=0.3)
    ref = jsta.sta_pipe_attention(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(active),
                                  text_k=jnp.asarray(tk), text_v=jnp.asarray(tv),
                                  text_bias=jnp.asarray(bias) if with_bias else None,
                                  interpret=True, **kw)
    got = sta_pipe_attention(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(active),
                             text_k=torch.from_numpy(tk), text_v=torch.from_numpy(tv),
                             text_bias=torch.from_numpy(bias) if with_bias else None, **kw)
    _close(got, ref)
    assert not got[:, 1].any()


def test_sta_pipe_text_tail_needs_multiple_of_8():
    q = torch.zeros((1, 1, 4 * 6 * 16, 16))
    t = torch.zeros((1, 1, 20, 16))
    with pytest.raises(ValueError, match="multiple of 8"):
        sta_pipe_attention(q, q, q, torch.ones(1), latent_shape=(4, 6, 16), tile=(4, 6, 8),
                           text_k=t, text_v=t)


def _min_gap(x: np.ndarray, groups) -> float:
    sim = coreset.slot_similarity(coreset.group_view(torch.from_numpy(x), groups),
                                  groups._geom.center_slot)
    s = sim.sort(dim=-1).values[..., :-1]  # drop the center's +inf
    return (s[..., 1:] - s[..., :-1]).min().item()


def test_pool_qkv_kv_matching_from_k_matches_pallas():
    """K and V pooled by K's own matching, the picks Q's; pooled values,
    picks and unpool equal the Pallas kernels' (no arg-min at a tie: the
    smallest similarity gap of q and of k is > 1e-4)."""
    latent, window = (4, 6, 16), (2, 3, 2)
    groups = tgeo.build_lowres_groups(latent, window)
    jgroups = jgeo.build_lowres_groups(latent, window)
    rng = np.random.default_rng(20)
    q, k, v = (rng.standard_normal((1, 3, int(np.prod(latent)), 32)).astype(np.float32)
               for _ in range(3))
    assert _min_gap(q, groups) > 1e-4 and _min_gap(k, groups) > 1e-4
    active = np.asarray([1, 0, 1], np.int32)
    got = pool_qkv(*(torch.from_numpy(x) for x in (q, k, v)), groups, kv_matching_from_k=True,
                   active=torch.from_numpy(active), return_picks=True)
    ref = jpallas.pool_qkv(*(jnp.asarray(x) for x in (q, k, v)), jgroups,
                           kv_matching_from_k=True, active=jnp.asarray(active),
                           return_picks=True, interpret=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # K's matching differs from Q's here, so the flag is not a no-op
    q_only = pool_qkv(*(torch.from_numpy(x) for x in (q, k, v)), groups,
                      active=torch.from_numpy(active))
    assert not torch.equal(q_only[1], got[1]) and torch.equal(q_only[0], got[0])
    out = rng.standard_normal(got[0].shape).astype(np.float32)
    up = unpool(torch.from_numpy(out), torch.from_numpy(q), groups,
                active=torch.from_numpy(active), picks=got[3])
    jup = jpallas.unpool(jnp.asarray(out), jnp.asarray(q), jgroups, active=jnp.asarray(active),
                         picks=ref[3], interpret=True)
    np.testing.assert_array_equal(up.numpy(), np.asarray(jup))


# --- layouts, masks and gates ---------------------------------------------------------

HUNYUAN_45F = dict(latent_shape=(12, 45, 80), sta_window=(3, 3, 3), sta_tile=(6, 9, 8),
                   lowres_window=(2, 3, 2), text_len=256)


@pytest.mark.parametrize("video", [{}, HUNYUAN_45F])
def test_layouts_and_bias_match_jax(video):
    """The expert layouts and biases equal the JAX package's; the STA text
    rows' layout and bias equal what its joint_sta_attention builds inline."""
    tj, jj = _jcfgs(**video)
    mine, ref = dict(joint.joint_layouts(tj)), jjoint.joint_layouts(jj)  # a copy: it is cached
    rows = mine.pop("sta_text_rows")
    assert {k: tuple(v) for k, v in mine.items()} == {k: tuple(v) for k, v in ref.items()}
    lt, sv, bkv = tj.text_len, tj.video.seq_len, tj.video.block_kv
    mask = np.broadcast_to(np.arange(lt) < lt - 7, (2, lt)).copy()
    for name, valid in (("full", sv), ("sta", sv)):
        np.testing.assert_array_equal(
            joint._bias(torch.from_numpy(mask), mine[name], valid).numpy(),
            np.asarray(jjoint._bias(jnp.asarray(mask), ref[name], valid)))
    bq = max(8, 1 << (lt - 1).bit_length())  # joint_experts.py:356-358 of the JAX package
    assert tuple(rows) == (sv, sv, bkv * -(-(sv + lt) // bkv), bq, bkv)
    want = np.full((1, rows.total), -1e30, np.float32)
    want[0, :sv] = 0.0
    want[0, sv:sv + lt] = np.where(mask[0], 0.0, -1e30)
    np.testing.assert_array_equal(joint._bias(torch.from_numpy(mask), rows, sv).numpy(), want)


def test_sta_subtile_mask_matches_jax_tables():
    """The densified visibility equals the JAX package's pair-bit tables
    expanded as its plain version does (joint_sta_attention_ref)."""
    tj, jj = _jcfgs()
    layout = jjoint.joint_layouts(jj)["sta"]
    idx, cnt, bits = jjoint._joint_sta_tables(jj)
    tpt = jj.video.tokens_per_tile
    n_sub = layout.total // tpt
    m_sub, k_sub = layout.block_q // tpt, layout.block_kv // tpt
    want = np.zeros((n_sub, n_sub), bool)
    for qi in range(idx.shape[1]):
        for j in range(cnt[0, qi]):
            word = np.uint32(bits[0, qi, j])
            for mi in range(m_sub):
                for ki in range(k_sub):
                    if (word >> np.uint32(mi * k_sub + ki)) & np.uint32(1):
                        want[qi * m_sub + mi, idx[0, qi, j] * k_sub + ki] = True
    np.testing.assert_array_equal(joint._joint_sta_subtile_mask(tj)[0], want)


@pytest.mark.parametrize("video", [
    {},                                               # window-dense, pipe fits
    HUNYUAN_45F,                                      # HunyuanVideo-13B at 720p x 45f
    {**HUNYUAN_45F, "latent_shape": (30, 45, 80)},    # at 720p x 117f
    {"sta_tile": (2, 2, 2)},                          # small tiles: sta_batched
    {"text_len": 20},                                 # text not a multiple of 8
    {"latent_shape": (8, 48, 640), "sta_tile": (8, 8, 8)},     # pipe too big: sta_row
    {"latent_shape": (8, 48, 1280), "sta_tile": (8, 8, 16)},   # neither fits
])
def test_sta_kernel_choice_matches_jax_gates(video):
    tj, jj = _jcfgs(**video)
    cfg, d, lt = jj.video, 128, jj.text_len
    shape, tile, window = cfg.latent_shape, cfg.sta_tile, cfg.sta_window
    if not (jax_prefer_window_dense(shape, tile) and lt % 8 == 0):
        want = "sta_batched"
    elif jsta.supports_pipe(shape, tile, d, 2, text_len=lt, window=window):
        want = "sta_pipe"
    elif jax_supports_row_dense(shape, tile, d, 2, text_len=lt, window=window):
        want = "sta_row"
    else:
        want = "sta_window"
    assert joint.joint_sta_kernel(tj, d, 2) == want


def test_the_hunyuan_geometries_take_sta_pipe():
    for frames in (12, 30):
        tj, _ = _jcfgs(**{**HUNYUAN_45F, "latent_shape": (frames, 45, 80)})
        assert joint.joint_sta_kernel(tj, 128, 2) == "sta_pipe"


# --- the experts -------------------------------------------------------------------

EXPERTS = {"full": (joint.joint_full_attention, jjoint.joint_full_attention),
           "lowres": (joint.joint_lowres_attention, jjoint.joint_lowres_attention),
           "sta": (joint.joint_sta_attention, jjoint.joint_sta_attention)}


@pytest.mark.parametrize("expert", sorted(EXPERTS))
def test_joint_experts_match_jax(expert):
    """Each expert over all heads, then with head 1 routed away: its video
    and text rows zero, the others as before (heads are independent, so the
    JAX package's output over all heads, head 1 zeroed, is its output with
    that head routed away; one JAX run keeps the interpret-mode compile
    time down).  Text padding is masked through the kv bias."""
    tj, jj = _jcfgs()
    (t_in, j_in) = _both(_inputs(30))
    mine, ref = EXPERTS[expert]
    want = [np.asarray(w) for w in ref(*j_in[:6], j_in[6], jj, scale=0.3, interpret=True)]
    active = np.asarray([True, False, True])
    for kw in ({}, dict(active=torch.from_numpy(active))):
        got = mine(*t_in[:6], t_in[6], tj, scale=0.3, **kw)
        if kw:
            want = [w * active[None, :, None, None] for w in want]
        _close(got[0], want[0])
        _close(got[1][:, :, :EFF], want[1][:, :, :EFF])
    assert not got[0][:, 1].any() and not got[1][:, 1].any()


@pytest.mark.parametrize("expert", ["full", "lowres", "sta"])
def test_joint_refs_match_jax(expert):
    tj, jj = _jcfgs()
    (t_in, j_in) = _both(_inputs(31))
    mine = getattr(joint, f"joint_{expert}_attention_ref")
    ref = getattr(jjoint, f"joint_{expert}_attention_ref")
    got = mine(*t_in[:6], t_in[6], tj)
    want = ref(*j_in[:6], j_in[6], jj)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("mode", ["off", "hard", "soft"])
def test_routed_joint_attention_matches_jax(mode):
    """Hard routing sends head 0 to FULL, 1 to LOWRES, 2 to STA (the JAX
    package's per-head switch at this window-dense geometry, the port's
    masked dispatch); padded text rows are zero."""
    tj, jj = _jcfgs()
    (t_in, j_in) = _both(_inputs(32))
    scores = np.asarray([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05], [0.05, 0.05, 0.9]], np.float32)
    if mode == "soft":
        scores = np.random.default_rng(33).dirichlet(np.ones(3), size=3).astype(np.float32)
    scores = np.broadcast_to(scores, (2, 3, 3)).copy()
    got = joint.routed_joint_attention(*t_in[:6], torch.from_numpy(scores), t_in[6], tj,
                                       mode=mode)
    want = jjoint.routed_joint_attention(*j_in[:6], jnp.asarray(scores), j_in[6], jj, mode=mode,
                                         interpret=True)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert not got[1][:, :, EFF:].any()
    if mode == "hard":  # each head equals its expert's output in the port itself
        for e, fn in ((FULL, joint.joint_full_attention), (LOWRES, joint.joint_lowres_attention),
                      (STA, joint.joint_sta_attention)):
            ve, te = fn(*t_in[:6], t_in[6], tj)
            torch.testing.assert_close(got[0][:, e], ve[:, e], rtol=0, atol=0)
            torch.testing.assert_close(got[1][:, e, :EFF], te[:, e, :EFF], rtol=0, atol=0)


@pytest.mark.parametrize("video,kernel", [({"sta_tile": (2, 2, 2)}, "sta_batched"),
                                          ({"text_len": 16}, None)])
def test_hard_routing_raises_where_jax_runs_an_unported_kernel(video, kernel):
    """Hard routing at a small-tile geometry, where the JAX package runs
    sta_batched for the STA heads, now runs it too (no longer raises): the
    STA head equals the JAX package's sliding-tile expert, text rows
    included; so at a text length of 16 (window-dense, sta_pipe).  FULL and
    LOWRES heads run as before."""
    tj, jj = _jcfgs(**video)
    lt = tj.text_len
    eff = min(EFF, lt)
    (t_in, j_in) = _both(_inputs(34, lt=lt, eff=eff))
    assert joint.joint_sta_kernel(tj, 16, 4) == (kernel or "sta_pipe")
    args = (*t_in[:6], None, t_in[6], tj)
    ids = torch.tensor([FULL, LOWRES, STA])
    video_out, text_out = joint.routed_joint_attention(*args, mode="hard",
                                                       expert_ids=(ids, ids.numpy()))
    want = jjoint.joint_sta_attention(*j_in[:6], j_in[6], jj, interpret=True)
    _close(video_out[:, 2], want[0][:, 2])
    _close(text_out[:, 2, :eff], want[1][:, 2, :eff])
    ids = torch.tensor([FULL, LOWRES, LOWRES])
    video_out, _ = joint.routed_joint_attention(*args, mode="hard",
                                                expert_ids=(ids, ids.numpy()))
    assert torch.isfinite(video_out).all()


def test_unknown_mode_and_qk_int8_raise():
    """An unknown routing mode raises; qk_int8 no longer does: routing off
    runs the full expert's int8 QK mode, within the JAX package's quality
    gate of the bf16 path (tests/test_torch_port_quant.py holds it to JAX)."""
    tj, _ = _jcfgs()
    (t_in, _) = _both(_inputs(35))
    with pytest.raises(ValueError, match="routing mode"):
        joint.routed_joint_attention(*t_in[:6], None, t_in[6], tj, mode="sparse")
    t8 = dataclasses.replace(tj, video=dataclasses.replace(tj.video, qk_int8=True))
    video8, _ = joint.routed_joint_attention(*t_in[:6], None, t_in[6], t8, mode="off")
    video, _ = joint.routed_joint_attention(*t_in[:6], None, t_in[6], tj, mode="off")
    assert 0 < (video8 - video).abs().mean() < 0.05 * video.abs().mean()
