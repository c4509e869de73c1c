"""The port's STA fallback kernels (sta_batched, sta_window, sta_row), their
tables and their dispatch against the JAX package, on the CPU.

Inputs come from numpy with a seed and go to both sides; the JAX package
runs its Pallas kernels in interpret mode.  At these small shapes the JAX
package's VMEM budgets always admit sta_pipe, so the dispatch tests that
need sta_row or sta_window turn its gates off (``supports_pipe``, and
``supports_row_dense`` for sta_window) in both packages, inside the test.
Tolerances: f32 on both sides, rtol 1e-4 and atol 1e-4 x the output's scale
(its max abs value), as the port's other tests: XLA-CPU and PyTorch sum in
different orders.  Tables are held to equality, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.models import hunyuan as jhunyuan
from vorta_tpu.ops import joint_experts as jjoint
from vorta_tpu.ops import routed_fused as jrouted
from vorta_tpu.ops import sta_pipe as jsta_pipe
from vorta_tpu.ops.sta_batched import sta_flash_headbatched as jax_batched
from vorta_tpu.ops.sta_row import sta_row_attention as jax_row
from vorta_tpu.ops.sta_row import supports_row_dense as jax_supports_row_dense
from vorta_tpu.ops.sta_window import prefer_window_dense as jax_prefer_window_dense
from vorta_tpu.ops.sta_window import sta_window_attention as jax_window
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.io.from_jax import hunyuan_state_from_jax
from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanModel
from vorta_tpu_torch.ops import joint_experts as joint
from vorta_tpu_torch.ops import routed_fused as routed
from vorta_tpu_torch.ops.experts import FULL, LOWRES, STA, routed_attention
from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched, sta_flash_headbatched_ref
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


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * max(np.abs(want).max(), 1e-6))


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _cfgs(**kw):
    return AttentionConfig(**kw), JaxAttentionConfig(**kw)


# --- tables ----------------------------------------------------------------------

# the CLI's hunyuan-tiny (13 frames at 96 x 256) and Wan tiny geometries, the
# routed tests' geometry, and HunyuanVideo-13B at 720p x 45f with the (2, 9, 8) tile
HY_TINY = dict(latent_shape=(4, 6, 16), sta_window=(3, 3, 3), sta_tile=(2, 2, 2),
               lowres_window=(2, 2, 2), block_q=32, block_kv=32)
HY_45F_298 = dict(latent_shape=(12, 45, 80), sta_window=(3, 3, 3), sta_tile=(2, 9, 8),
                  lowres_window=(2, 3, 2))
TABLE_GEOMS = {
    "hunyuan_tiny": (HY_TINY, 24),
    "wan_tiny": (dict(latent_shape=(4, 8, 8), sta_tile=(2, 2, 2), sta_window=(3, 3, 1),
                      lowres_window=(2, 2, 2), block_q=16, block_kv=16), 24),
    "routed": (dict(latent_shape=(4, 4, 8), sta_tile=(2, 2, 2), lowres_window=(2, 2, 2),
                    block_q=32, block_kv=16), 20),
    "hunyuan_13b_45f": (HY_45F_298, 256),
}


@pytest.mark.parametrize("name", sorted(TABLE_GEOMS))
def test_tables_match_jax_bit_for_bit(name):
    """RoutedGeometry.sta and the joint layout's tables and pair bits
    (text 256 at full width, the tiny lengths otherwise, and 83)."""
    video, lt = TABLE_GEOMS[name]
    cfg, jcfg = _cfgs(**video)
    got, want = routed.routed_geometry(cfg).sta, jrouted.routed_geometry(jcfg).sta
    assert (got.block_q, got.block_kv, got.q_pad, got.kv_pad, got.valid_len) == (
        want.block_q, want.block_kv, want.q_pad, want.kv_pad, want.valid_len)
    for a, b in ((got.tables.kv_index, want.kv_index), (got.tables.kv_count, want.kv_count),
                 (got.tables.pair_bits, want.pair_bits)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for text_len in (lt, 83):
        got = joint._joint_sta_tables(joint.JointConfig(cfg, text_len))
        want = jjoint._joint_sta_tables(jjoint.JointConfig(jcfg, text_len))
        for a, b in zip((got.kv_index, got.kv_count, got.pair_bits), want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert joint.joint_layouts(joint.JointConfig(cfg, text_len))["sta"] == tuple(
            jjoint.joint_layouts(jjoint.JointConfig(jcfg, text_len))["sta"])


def test_hunyuan_298_joint_layout():
    """The (2, 9, 8) tile's joint layout at 720p x 45f: blocks 432 / 1008 (3 x 7
    sub-tiles), lcm 3,024, text at 45,360, total 48,384."""
    lay = joint.joint_layouts(joint.JointConfig(AttentionConfig(**HY_45F_298), 256))["sta"]
    assert (lay.block_q, lay.block_kv, lay.text_off, lay.total) == (432, 1008, 45360, 48384)


def test_unservable_tiles_raise_as_jax():
    """tokens_per_tile 12 (tile (3, 2, 2)) and a tile that does not divide the
    grid: the JAX package raises ValueError building its tables, and so does
    the port, before any kernel."""
    for tile in ((3, 2, 2), (2, 3, 8)):
        cfg, jcfg = _cfgs(latent_shape=(6, 4, 8), sta_tile=tile, lowres_window=(2, 2, 2))
        with pytest.raises(ValueError) as want:
            jrouted.routed_geometry(jcfg)
        with pytest.raises(ValueError) as got:
            routed.routed_geometry(cfg)
        assert str(got.value) == str(want.value)


# --- kernel choice -----------------------------------------------------------------

def _jax_routed_choice(cfg, d=128, itemsize=2):
    """The JAX package's routed dispatch (routed_fused.py:40-51, :384-386)."""
    shape, tile, window = cfg.latent_shape, cfg.sta_tile, cfg.sta_window
    pipe = jsta_pipe.supports_pipe(shape, tile, d, itemsize, window=window)
    if not (jax_prefer_window_dense(shape, tile) or pipe):
        return "sta_batched"
    if pipe:
        return "sta_pipe"
    if jax_supports_row_dense(shape, tile, d, itemsize, window=window):
        return "sta_row"
    return "sta_window"


def _jax_joint_choice(jcfg, d=128, itemsize=2):
    """The JAX package's joint dispatch (joint_experts.py:291, :340-349)."""
    cfg, lt = jcfg.video, jcfg.text_len
    shape, tile, window = cfg.latent_shape, cfg.sta_tile, cfg.sta_window
    if not (jax_prefer_window_dense(shape, tile) and lt % 8 == 0):
        return "sta_batched"
    if jsta_pipe.supports_pipe(shape, tile, d, itemsize, text_len=lt, window=window):
        return "sta_pipe"
    if jax_supports_row_dense(shape, tile, d, itemsize, text_len=lt, window=window):
        return "sta_row"
    return "sta_window"


WAN_720P = dict(latent_shape=(20, 45, 80), sta_window=(3, 3, 3), lowres_window=(2, 3, 2))
HY_45F = dict(latent_shape=(12, 45, 80), sta_window=(3, 3, 3), lowres_window=(2, 3, 2))
CHOICES = [  # (video, text length or None for the routed dispatch, the kernel JAX runs)
    ({**WAN_720P, "sta_tile": (5, 9, 8)}, None, "sta_pipe"),
    ({**WAN_720P, "sta_tile": (4, 9, 10)}, None, "sta_window"),
    ({**HY_45F, "sta_tile": (6, 9, 8)}, 256, "sta_pipe"),
    ({**HY_45F, "sta_tile": (6, 9, 8)}, 83, "sta_batched"),
    ({**HY_45F, "sta_tile": (2, 9, 8)}, 256, "sta_batched"),
    ({**HY_45F, "sta_tile": (2, 9, 8)}, 83, "sta_batched"),
    ({**HY_45F, "sta_tile": (4, 9, 10)}, 256, "sta_window"),
    ({**HY_45F, "sta_tile": (4, 9, 10)}, 83, "sta_batched"),
    (HY_TINY, 24, "sta_batched"),
]


@pytest.mark.parametrize("video,text_len,kernel", CHOICES)
def test_kernel_choice_matches_jax_gates(video, text_len, kernel):
    cfg, jcfg = _cfgs(**video)
    if text_len is None:
        want = _jax_routed_choice(jcfg)
        assert routed.routed_sta_kernel(cfg, 128, 2) == want == kernel
    else:
        want = _jax_joint_choice(jjoint.JointConfig(jcfg, text_len))
        assert joint.joint_sta_kernel(joint.JointConfig(cfg, text_len), 128, 2) == want == kernel


# --- the plain versions vs the Pallas kernels (interpret mode) ----------------------

def test_sta_batched_matches_pallas():
    """The joint layout of a (2, 2, 2) tile (blocks 40 / 48): pair bits,
    all-ones text blocks with a kv bias masking the padded text, the fast
    softmax; heads 1 and 3 routed away."""
    cfg, jcfg = _cfgs(**{**HY_TINY, "latent_shape": (4, 4, 8)})
    tj, jj = joint.JointConfig(cfg, 24), jjoint.JointConfig(jcfg, 24)
    lay = joint.joint_layouts(tj)["sta"]
    tables = joint._joint_sta_tables(tj)
    q, k, v = _randn(1, *[(2, 4, lay.total, 16)] * 3)
    mask = np.broadcast_to(np.arange(24) < 17, (2, 24))
    bias = joint._bias(torch.from_numpy(mask), lay, cfg.seq_len)
    active = np.asarray([1, 0, 1, 0], np.int32)
    kw = dict(tokens_per_tile=8, block_q=lay.block_q, block_kv=lay.block_kv)
    want = jax_batched(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(tables.kv_index), jnp.asarray(tables.kv_count),
                       jnp.asarray(active), pair_bits=jnp.asarray(tables.pair_bits),
                       kv_bias=jnp.asarray(bias.numpy()), interpret=True, softmax="fast", **kw)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tables.kv_index,
            tables.kv_count, torch.from_numpy(active))
    got = sta_flash_headbatched(*args, pair_bits=tables.pair_bits, kv_bias=bias, softmax="fast",
                                **kw)
    _close(got, want)
    assert not got[:, active == 0].any()
    # rows past the last tile's q block see only text; the bias matters
    unbiased = sta_flash_headbatched_ref(*args, pair_bits=tables.pair_bits, softmax="fast", **kw)
    assert not np.allclose(unbiased.numpy(), np.asarray(want), atol=1e-3)


WINDOW_GEOMS = {  # (latent, tile): tile_w 8-aligned, and tile_w 10 (tile size 40)
    "aligned": ((4, 6, 32), (2, 3, 8)),
    "misaligned": ((6, 4, 30), (2, 2, 10)),
}


@pytest.mark.parametrize("text", [False, True])
@pytest.mark.parametrize("geom", sorted(WINDOW_GEOMS))
def test_sta_window_matches_pallas(geom, text):
    """Stable softmax over the clamped window, with and without the joint text
    tail (16 keys, 11 valid through text_bias); head 2 routed away."""
    shape, tile = WINDOW_GEOMS[geom]
    s = int(np.prod(shape))
    q, k, v, tk, tv = _randn(2, *[(2, 3, s, 16)] * 3, *[(2, 3, 16, 16)] * 2)
    active = np.asarray([1, 1, 0], np.int32)
    tb = np.where(np.arange(16) < 11, 0.0, -1e30).astype(np.float32)[None]
    kw = dict(latent_shape=shape, tile=tile, window=(3, 3, 3))
    jt = dict(text_k=jnp.asarray(tk), text_v=jnp.asarray(tv), text_bias=jnp.asarray(tb))
    tt = dict(text_k=torch.from_numpy(tk), text_v=torch.from_numpy(tv),
              text_bias=torch.from_numpy(tb))
    want = jax_window(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(active),
                      interpret=True, **kw, **(jt if text else {}))
    got = sta_window_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(active), **kw, **(tt if text else {}))
    _close(got, want)
    assert not got[:, 2].any()


@pytest.mark.parametrize("text", [False, True])
def test_sta_row_matches_pallas(text):
    shape, tile = (4, 6, 32), (2, 3, 8)
    s = int(np.prod(shape))
    q, k, v, tk, tv = _randn(3, *[(1, 3, s, 16)] * 3, *[(1, 3, 24, 16)] * 2)
    active = np.asarray([0, 1, 1], np.int32)
    tb = np.where(np.arange(24) < 17, 0.0, -1e30).astype(np.float32)[None]
    kw = dict(latent_shape=shape, tile=tile, window=(3, 3, 3))
    jt = dict(text_k=jnp.asarray(tk), text_v=jnp.asarray(tv), text_bias=jnp.asarray(tb))
    tt = dict(text_k=torch.from_numpy(tk), text_v=torch.from_numpy(tv),
              text_bias=torch.from_numpy(tb))
    want = jax_row(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(active),
                   interpret=True, **kw, **(jt if text else {}))
    got = sta_row_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(active), **kw, **(tt if text else {}))
    _close(got, want)
    assert not got[:, 0].any()


def test_sta_row_refuses_what_its_gate_refuses():
    q = torch.zeros((1, 1, 4 * 6 * 30, 16))
    with pytest.raises(ValueError, match="row-dense"):
        sta_row_attention(q, q, q, [1], latent_shape=(4, 6, 30), tile=(2, 3, 10))
    with pytest.raises(ValueError, match="unsupported"):
        sta_window_attention(q, q, q, [1], latent_shape=(4, 6, 30), tile=(2, 3, 4))


# --- the dispatches ------------------------------------------------------------------

def _gates_off(monkeypatch, kernel):
    """Turn the JAX package's VMEM gates off in both packages so that small
    shapes take ``kernel``: sta_pipe's for sta_row / sta_batched, and
    sta_row's too for sta_window."""
    monkeypatch.setattr(jrouted, "supports_pipe", lambda *a, **k: False)
    monkeypatch.setattr(jsta_pipe, "supports_pipe", lambda *a, **k: False)
    monkeypatch.setattr(routed, "supports_pipe", lambda *a, **k: False)
    if kernel == "sta_window":
        monkeypatch.setattr(jrouted, "supports_row_dense", lambda *a, **k: False)
        monkeypatch.setattr(jjoint, "supports_row_dense", lambda *a, **k: False)
        monkeypatch.setattr(routed, "supports_row_dense", lambda *a, **k: False)


ROUTED_GEOMS = {  # kernel: (latent, tile); 192 and 240-token tiles are window-dense
    "sta_batched": ((4, 4, 8), (2, 2, 2)),
    "sta_row": ((4, 12, 16), (2, 12, 8)),
    "sta_window": ((4, 12, 20), (2, 12, 10)),
}
IDS = np.asarray([FULL, LOWRES, STA], np.int32)  # heads on all three experts


@pytest.mark.parametrize("kernel", sorted(ROUTED_GEOMS))
def test_routed_dispatch_matches_jax(kernel, monkeypatch):
    """fused_routed_attention, heads on all three experts (FULL, LOWRES,
    STA), at a geometry where both packages run ``kernel`` for the STA head.
    sta_batched (the JAX package's guarded three-expert branch): the whole
    dispatch against the JAX package's.  sta_row / sta_window (its
    window-dense branch, whose FULL and LOWRES heads the gates do not touch
    and tests/test_torch_port_routed.py holds to JAX): the STA head against
    the JAX package's STA dispatch, every head against the port's plain
    hard_ref formulation."""
    _gates_off(monkeypatch, kernel)
    shape, tile = ROUTED_GEOMS[kernel]
    cfg, jcfg = _cfgs(latent_shape=shape, sta_tile=tile, sta_window=(3, 3, 3),
                      lowres_window=(2, 2, 2), block_q=32, block_kv=32)
    assert routed.routed_sta_kernel(cfg, 16, 4) == _jax_routed_choice(jcfg, 16, 4) == kernel
    q, k, v = _randn(4, *[(1, 3, cfg.seq_len, 16)] * 3)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = routed.fused_routed_attention(tq, tk, tv, torch.from_numpy(IDS).long(), cfg)
    if kernel == "sta_batched":
        _close(got, jrouted.fused_routed_attention(jq, jk, jv, jnp.asarray(IDS), jcfg,
                                                   interpret=True))
        return
    want = jrouted._sta_dispatch(jq[:, 2:], jk[:, 2:], jv[:, 2:], jnp.ones((1,), jnp.int32),
                                 jcfg, None, True)
    _close(got[:, 2:], want)
    scores = torch.from_numpy(np.eye(3, dtype=np.float32)[IDS][None])
    _close(got, routed_attention(tq, tk, tv, scores, cfg, mode="hard_ref"))


JOINT_GEOMS = {  # kernel: (latent, tile)
    "sta_batched": ((4, 6, 16), (2, 2, 2)),
    "sta_row": ((4, 12, 16), (2, 12, 8)),
    "sta_window": ((4, 12, 20), (2, 12, 10)),
}


@pytest.mark.parametrize("kernel", sorted(JOINT_GEOMS))
def test_joint_dispatch_matches_jax(kernel, monkeypatch):
    """routed_joint_attention hard-routed, heads FULL, LOWRES, STA, text 24
    with 17 valid; padded text rows are zero.  sta_batched (the JAX
    package's masked three-expert branch): the whole dispatch against the
    JAX package's.  sta_row / sta_window (its per-head switch, whose FULL
    and LOWRES experts the gates do not touch and
    tests/test_torch_port_joint.py holds to JAX): the STA head against the
    JAX package's sliding-tile expert, the others equal to the port's own
    experts."""
    if kernel != "sta_batched":
        _gates_off(monkeypatch, kernel)
    shape, tile = JOINT_GEOMS[kernel]
    cfg, jcfg = _cfgs(latent_shape=shape, sta_tile=tile, sta_window=(3, 3, 3),
                      lowres_window=(2, 2, 2), block_q=32, block_kv=32)
    tj, jj = joint.JointConfig(cfg, 24), jjoint.JointConfig(jcfg, 24)
    assert joint.joint_sta_kernel(tj, 16, 4) == _jax_joint_choice(jj, 16, 4) == kernel
    sv = cfg.seq_len
    arrs = _randn(5, *[(1, 3, sv, 16)] * 3, *[(1, 3, 24, 16)] * 3)
    mask = (np.arange(24) < 17)[None]
    ja, ta = [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]
    ids = torch.from_numpy(IDS).long()
    got = joint.routed_joint_attention(*ta, None, torch.from_numpy(mask), tj, mode="hard",
                                       expert_ids=(ids, IDS))
    assert not got[1][:, :, 17:].any()
    if kernel == "sta_batched":
        scores = np.eye(3, dtype=np.float32)[IDS][None]
        want = jjoint.routed_joint_attention(*ja, jnp.asarray(scores), jnp.asarray(mask), jj,
                                             mode="hard", interpret=True)
        _close(got[0], want[0])
        _close(got[1], want[1])
        return
    want = jjoint.joint_sta_attention(*(a[:, 2:] for a in ja), jnp.asarray(mask), jj,
                                      interpret=True)
    _close(got[0][:, 2:], want[0])
    _close(got[1][:, 2:, :17], want[1][:, :, :17])
    for e, fn in ((FULL, joint.joint_full_attention), (LOWRES, joint.joint_lowres_attention)):
        ve, te = fn(*ta, torch.from_numpy(mask), tj)
        torch.testing.assert_close(got[0][:, e], ve[:, e], rtol=0, atol=0)
        torch.testing.assert_close(got[1][:, e, :17], te[:, e, :17], rtol=0, atol=0)


# --- hunyuan-tiny at its own tile ---------------------------------------------------

def _flat(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat}


def test_hunyuan_tiny_hard_routed_at_its_own_tile():
    """A hunyuan-tiny forward cut to one dual block (its 2 heads on LOWRES and
    STA: the routers' biases are one-hot logits) at the JAX CLI's own
    geometry for it (tile (2, 2, 2): sta_batched), routed hard, 17 of 24
    text tokens valid.  The FULL expert's heads are held to JAX at this
    geometry by the dispatch tests above."""
    jcfg_model = dataclasses.replace(jhunyuan.HUNYUAN_TINY, dual_layers=1, single_layers=0)
    # weights drawn with numpy onto the abstract model (no init to compile)
    graph, abstract = nnx.split(nnx.eval_shape(
        lambda: jhunyuan.HunyuanModel(jcfg_model, rngs=nnx.Rngs(0))))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype), abstract)
    jmodel = nnx.merge(graph, params)
    bias = 4.0 * np.eye(3, dtype=np.float32)[[LOWRES, STA]].reshape(-1)
    jmodel.dual_blocks.router.linear.bias.value = jnp.asarray(bias[None])
    state = {k: np.asarray(v) for k, v in _flat(nnx.state(jmodel)).items()}
    cfg_model = dataclasses.replace(HUNYUAN_TINY, dual_layers=1, single_layers=0)
    tmodel = HunyuanModel(cfg_model, dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(hunyuan_state_from_jax(state, cfg_model))
    attn, jattn = _cfgs(**HY_TINY)
    assert joint.joint_sta_kernel(joint.JointConfig(attn, cfg_model.text_len), 64, 4) == \
        "sta_batched"
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((1, 4, 12, 32, 16)).astype(np.float32)
    text = rng.standard_normal((1, cfg_model.text_len, cfg_model.text_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, cfg_model.pooled_dim)).astype(np.float32)
    mask = (np.arange(cfg_model.text_len) < 17)[None]
    t = np.asarray([600.0], np.float32)
    g = np.asarray([6000.0], np.float32)
    want = jmodel(*(jnp.asarray(a) for a in (lat, t, text, mask, pooled)),
                  guidance=jnp.asarray(g), attn_cfg=jattn, routing_mode="hard",
                  interpret=True)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in (lat, t, text, mask, pooled)),
                     guidance=torch.from_numpy(g), attn_cfg=attn, routing_mode="hard")
    assert (got.expert_ids == [[LOWRES, STA]]).all()
    _close(got.sample, want.sample)


# --- serving a config.json's STA tile -------------------------------------------------

def test_resume_dir_rules_match_the_jax_cli(tmp_path):
    """--resume_dir: for Wan, config.json's grid must be the requested video's
    and --tau_sparse overrides its threshold (JAX cli/sample.py:212-218); for
    HunyuanVideo the file is taken as it is (:409-410)."""
    from vorta_tpu_torch.cli.sample import parse_args, resolve_attention_config

    saved = AttentionConfig(latent_shape=(4, 8, 8), sta_tile=(2, 2, 2), sta_window=(3, 3, 1),
                            lowres_window=(2, 2, 2), tau_sparse=0.1)
    saved.save(tmp_path / "config.json")

    def resolve(model, grid, *extra):
        args = parse_args(["--model", model, "--device", "cpu", "--resume_dir", str(tmp_path),
                           "--tau_sparse", "0.7", *extra])
        return resolve_attention_config(args, grid)

    assert resolve("wan-tiny", (4, 8, 8)) == dataclasses.replace(saved, tau_sparse=0.7)
    assert resolve("wan-tiny", (4, 8, 8), "--qk_int8") == dataclasses.replace(
        saved, tau_sparse=0.7, qk_int8=True)
    with pytest.raises(ValueError, match="geometry"):
        resolve("wan-tiny", (4, 6, 16))
    assert resolve("hunyuan-tiny", (4, 6, 16)) == saved
    assert resolve("hunyuan-tiny", (4, 8, 8)) == saved
