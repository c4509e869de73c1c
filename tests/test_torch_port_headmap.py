"""The pool's head-map mode, the alternative routed dispatches and the flash
kernels' blocks of 8 x odd, the port against the JAX package on the CPU.

  * ``pool_qkv`` / ``unpool`` in head-map mode (``head_map`` + ``num_active``)
    against the JAX package's, on the routed heads (the others are
    uninitialized by contract; the port's plain versions fill them with NaN),
    picks passed through, and ``_mode_plan``'s refusals;
  * ``fused_routed_attention`` under ``VORTA_LOWRES_DISPATCH=batched`` /
    ``hybrid`` and ``VORTA_ROUTED_DISPATCH=switch``, each variable set for
    both packages, at a geometry of the JAX package's fused branch (sta_pipe)
    and at one of its guarded branch (sta_batched), which ignores ``hybrid``
    and ``switch``;
  * ``routed_joint_attention`` hard at a window-dense joint geometry, two
    heads on LOWRES, which pools in head-map mode on both sides;
  * the flash forward's plain version with its lse, and the flash
    backward's, at 360-token blocks (tile (5, 9, 8), the bench router's)
    against ``sparse_flash_attention_raw`` and its VJP.

Inputs come from numpy with a seed and go to both sides; the JAX package
runs its Pallas kernels in interpret mode.  Tolerances: f32 on both sides,
rtol 1e-4 and atol 1e-4 x the compared array's max abs value; pooling is
pure selection and is held to equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorta_tpu import geometry as jgeo
from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.ops import coreset_pallas as jpallas
from vorta_tpu.ops import joint_experts as jjoint
from vorta_tpu.ops import routed_fused as jrouted
from vorta_tpu.ops import sta_pipe as jsta_pipe
from vorta_tpu.ops.flash import make_sparse_attention as jax_make_attention
from vorta_tpu.ops.flash import sparse_flash_attention_raw as jax_flash
from vorta_tpu.ops.flash import tables_from_block_mask as jax_tables_from_block_mask
from vorta_tpu_torch import geometry as tgeo
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.ops import coreset_pallas
from vorta_tpu_torch.ops import joint_experts as joint
from vorta_tpu_torch.ops import routed_fused
from vorta_tpu_torch.ops.coreset_pallas import head_map_for, pool_qkv, unpool
from vorta_tpu_torch.ops.experts import FULL, LOWRES, STA
from vorta_tpu_torch.ops.flash import (
    make_sparse_attention,
    sparse_flash_attention_raw,
    tables_from_block_mask,
)
from vorta_tpu_torch.ops.routed_fused import fused_routed_attention, routed_sta_kernel


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


# --- pool_qkv / unpool in head-map mode ---------------------------------------------

LATENT, WINDOW = (4, 6, 16), (2, 3, 2)


@pytest.mark.parametrize("head_map,kv_from_k", [([1, 3, 3, 3], False), ([0, 2, 2], True)])
def test_headmap_pool_unpool_match_jax_on_routed_heads(head_map, kv_from_k):
    """The JAX package's two head-map cases (tests/test_coreset_pallas.py):
    the routed heads' pooled rows, picks and unpooled rows equal JAX's; the
    port's plain version leaves every other head NaN (picks -1)."""
    h, n = len(head_map), 2
    routed = sorted(set(head_map[:n]))
    s = int(np.prod(LATENT))
    qn, kn, vn = _randn(len(head_map), *[(1, h, s, 32)] * 3)
    tg, jg = tgeo.build_lowres_groups(LATENT, WINDOW), jgeo.build_lowres_groups(LATENT, WINDOW)
    (on,) = _randn(7, (1, h, tg.pooled_length, 32))
    hm_j = dict(head_map=jnp.asarray(head_map, jnp.int32), num_active=jnp.asarray(n, jnp.int32))
    want = jpallas.pool_qkv(*map(jnp.asarray, (qn, kn, vn)), jg, kv_matching_from_k=kv_from_k,
                            return_picks=True, interpret=True, **hm_j)
    want_out = jpallas.unpool(jnp.asarray(on), jnp.asarray(qn), jg, picks=want[3],
                              interpret=True, **hm_j)
    hm_t = dict(head_map=np.asarray(head_map, np.int32), num_active=n)
    got = pool_qkv(*map(torch.from_numpy, (qn, kn, vn)), tg, kv_matching_from_k=kv_from_k,
                   return_picks=True, **hm_t)
    got_out = unpool(torch.from_numpy(on), torch.from_numpy(qn), tg, picks=got[3], **hm_t)
    others = [i for i in range(h) if i not in routed]
    for a, w in zip((*got, got_out), (*want, want_out)):
        np.testing.assert_array_equal(a.numpy()[:, routed], np.asarray(w)[:, routed])
        fill = -1 if a.dtype == torch.int32 else np.nan
        np.testing.assert_array_equal(a.numpy()[:, others], np.full_like(a.numpy()[:, others],
                                                                         fill))


def test_head_map_for_and_mode_plan():
    """head_map_for packs as the JAX callers do (routed heads first, the last
    repeated; at least one position); the modes refuse what JAX refuses."""
    act = np.asarray([False, True, False, True])
    hm, n = head_map_for(torch.from_numpy(act))
    lh = jnp.asarray(act)
    n_j = jnp.maximum(jnp.sum(lh.astype(jnp.int32)), 1)
    want = jnp.take(jnp.argsort(~lh), jnp.minimum(jnp.arange(4), n_j - 1))
    np.testing.assert_array_equal(hm.numpy(), np.asarray(want))
    assert n == int(n_j) == 2 and hm.dtype == torch.int32
    np.testing.assert_array_equal(head_map_for(torch.from_numpy(act), 2)[0], hm)
    assert head_map_for(torch.zeros(3, dtype=torch.bool))[1] == 1
    tg = tgeo.build_lowres_groups(LATENT, WINDOW)
    x = torch.zeros((1, 4, int(np.prod(LATENT)), 32))
    for kw, msg in ((dict(head_map=hm), "requires num_active"),
                    (dict(head_map=hm, num_active=2, active=act), "mutually exclusive")):
        for fn in (jpallas._mode_plan, coreset_pallas._mode_plan):
            with pytest.raises(ValueError, match=msg):
                fn(kw.get("active"), kw["head_map"], kw.get("num_active"))
        with pytest.raises(ValueError, match=msg):
            pool_qkv(x, x, x, tg, **kw)
    with pytest.raises(ValueError, match="distinct"):
        pool_qkv(x, x, x, tg, head_map=np.asarray([1, 1, 1, 1]), num_active=2)


# --- the routed dispatches ----------------------------------------------------------

FUSED = dict(latent_shape=(4, 6, 16), sta_tile=(2, 3, 8), sta_window=(3, 3, 3),
             lowres_window=(2, 3, 2), block_q=32, block_kv=32)
# tests/test_torch_port_routed.py's geometry: 8-token tiles (not window-dense)
GUARDED = dict(latent_shape=(4, 4, 8), sta_window=(3, 3, 3), sta_tile=(2, 2, 2),
               lowres_window=(2, 2, 2), lowres_reduction=0.5, block_q=32, block_kv=16,
               sta_block_q=8, sta_block_kv=8)
IDS = np.asarray([LOWRES, STA, LOWRES, FULL])


@pytest.mark.parametrize("geometry,var,value", [
    ("fused", "VORTA_LOWRES_DISPATCH", "batched"),
    ("fused", "VORTA_LOWRES_DISPATCH", "hybrid"),
    ("fused", "VORTA_ROUTED_DISPATCH", "switch"),
    ("guarded", "VORTA_LOWRES_DISPATCH", "batched"),  # honoured there too
    ("guarded", "VORTA_ROUTED_DISPATCH", "switch"),  # ignored there, as hybrid is
])
def test_routed_dispatch_variables_match_jax(monkeypatch, geometry, var, value):
    """Each variable set for both packages; heads on all three experts, two
    on LOWRES.  The port's output equals JAX's and, heads being
    independent, its own masked dispatch's."""
    cfg = {"fused": FUSED, "guarded": GUARDED}[geometry]
    if geometry == "guarded":  # small shapes pass sta_pipe's VMEM gate: turn it off in both
        for mod in (jrouted, jsta_pipe, routed_fused):
            monkeypatch.setattr(mod, "supports_pipe", lambda *a, **k: False)
    tcfg = AttentionConfig(**cfg)
    assert (routed_sta_kernel(tcfg, 16, 4) == "sta_batched") == (geometry == "guarded")
    qn, kn, vn = _randn(len(value), *[(1, 4, tcfg.seq_len, 16)] * 3)
    t_in = [torch.from_numpy(x) for x in (qn, kn, vn)]
    masked = fused_routed_attention(*t_in, torch.from_numpy(IDS), tcfg)
    monkeypatch.setenv(var, value)
    calls = []
    real_pool = pool_qkv

    def spy(*args, **kw):
        calls.append(kw.get("head_map") is not None)
        return real_pool(*args, **kw)

    monkeypatch.setattr(routed_fused, "pool_qkv", spy)
    got = fused_routed_attention(*t_in, torch.from_numpy(IDS), tcfg)
    want = jrouted.fused_routed_attention(*map(jnp.asarray, (qn, kn, vn)),
                                          jnp.asarray(IDS, jnp.int32),
                                          JaxAttentionConfig(**cfg), interpret=True)
    _close(got, want)
    _close(got, masked.numpy())
    # batched: one head-map pool; hybrid and switch (fused only): one pool per
    # LOWRES head; otherwise the masked dispatch's one active-mode pool
    n_lowres = int((IDS == LOWRES).sum())
    if value == "batched":
        assert calls == [True]
    elif geometry == "fused":
        assert calls == [False] * n_lowres
    else:
        assert calls == [False]


# --- HunyuanVideo's routed joint attention ------------------------------------------

VIDEO = dict(latent_shape=(4, 6, 16), sta_window=(3, 3, 3), sta_tile=(4, 6, 8),
             lowres_window=(2, 2, 2), block_q=32, block_kv=32)
L, EFF, SV = 24, 17, 4 * 6 * 16


def test_routed_joint_attention_hard_pools_in_head_map_mode(monkeypatch):
    """Hard routing at a window-dense joint geometry (tile (4, 6, 8), 192
    tokens; the JAX package's per-head switch, each LOWRES head a one-head
    head-map pool there) with heads 0 and 2 on LOWRES, 1 on STA, 3 on FULL:
    video and text rows equal JAX's; the port pools once, in head-map mode
    over heads (0, 2)."""
    tj = joint.JointConfig(AttentionConfig(**VIDEO), L)
    jj = jjoint.JointConfig(JaxAttentionConfig(**VIDEO), L)
    arrs = _randn(40, *[(1, 4, SV, 16)] * 3, *[(1, 4, L, 16)] * 3)
    mask = np.broadcast_to(np.arange(L) < EFF, (1, L)).copy()
    scores = (np.eye(3, dtype=np.float32)[IDS] * 0.9 + 0.05)[None]
    calls = []
    real_pool = pool_qkv

    def spy(*args, **kw):
        calls.append((kw.get("head_map"), kw.get("num_active")))
        return real_pool(*args, **kw)

    monkeypatch.setattr(joint, "pool_qkv", spy)
    got = joint.routed_joint_attention(*map(torch.from_numpy, arrs), torch.from_numpy(scores),
                                       torch.from_numpy(mask), tj, mode="hard")
    want = jjoint.routed_joint_attention(*map(jnp.asarray, arrs), jnp.asarray(scores),
                                         jnp.asarray(mask), jj, mode="hard", interpret=True)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert len(calls) == 1
    np.testing.assert_array_equal(calls[0][0], [0, 2, 2, 2])
    assert calls[0][1] == 2


# --- flash at blocks of 8 x odd -----------------------------------------------------

BLK360, S720 = 360, 720  # latent (5, 9, 16), tile (5, 9, 8): two 360-token tiles
FLASH_CASES = {  # name: (block mask (1, 2, 2), kv_valid_len)
    "sta": (np.ones((1, 2, 2), bool), None),
    "sparse_tail": (np.asarray([[[False, True], [True, True]]]), 700),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_and_backward_at_360_token_blocks_match_jax(case):
    """The forward with its lse and make_sparse_attention's gradients (the
    backward kernels' plain version) at blocks of 360 = 8 x 45 against the
    JAX kernels; the tail case cuts kv block 1 at 700."""
    mask, valid = FLASH_CASES[case]
    qn, kn, vn, gn = _randn(360, *[(1, 2, S720, 16)] * 4)
    kw = dict(scale=0.25, block_q=BLK360, block_kv=BLK360, kv_valid_len=valid)
    jt, tt = jax_tables_from_block_mask(mask), tables_from_block_mask(mask)
    want_out, want_lse = jax_flash(*map(jnp.asarray, (qn, kn, vn)), jnp.asarray(jt.kv_index),
                                   jnp.asarray(jt.kv_count), return_lse=True, interpret=True,
                                   **kw)
    out, lse = sparse_flash_attention_raw(*map(torch.from_numpy, (qn, kn, vn)), tt.kv_index,
                                          tt.kv_count, return_lse=True, **kw)
    _close(out, want_out)
    _close(lse, want_lse)

    jattn = jax_make_attention(jt, n_kv_blocks=2, interpret=True, **kw)
    want = jax.grad(lambda q, k, v: jnp.sum(jattn(q, k, v) * jnp.asarray(gn)),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (qn, kn, vn)))
    attn = make_sparse_attention(tt, n_kv_blocks=2, **kw)
    assert attn.kernel_bwd
    xs = [torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn)]
    (attn(*xs) * torch.from_numpy(gn)).sum().backward()
    for x, w in zip(xs, want):
        _close(x.grad, w)
    if valid:
        assert not xs[1].grad[:, :, valid:].any() and not xs[2].grad[:, :, valid:].any()


# --- the pool benchmark tool ----------------------------------------------------------

def test_copy_probe_plain_matches_the_jax_slot_layout():
    """The copy probe's plain version: slot 0 of each group as its center,
    slots 0..U-1 as its margins, slots in raster order inside the window,
    against the JAX package's window tiling of the same tensor."""
    from vorta_tpu.ops.layout import tile_sequence as jax_tile_sequence
    from vorta_tpu_torch.tools.bench_pool import copy_probe

    tg = tgeo.build_lowres_groups(LATENT, WINDOW)
    g, gs, u = tg.num_groups, tg.group_size, tg.num_kept_margins
    xs = _randn(5, *[(1, 2, int(np.prod(LATENT)), 32)] * 3)
    got = copy_probe(*map(torch.from_numpy, xs), tg)
    for a, x in zip(got, xs):
        slots = np.asarray(jax_tile_sequence(jnp.asarray(x), LATENT, WINDOW)).reshape(1, 2, g,
                                                                                      gs, 32)
        want = np.concatenate([slots[:, :, :, 0], slots[:, :, :, :u].reshape(1, 2, g * u, 32)], 2)
        np.testing.assert_array_equal(a.numpy(), want)


@pytest.mark.parametrize("stage", ["both", "pool", "copy", "headmap5", "headmap12"])
def test_bench_pool_tool_runs_on_the_cpu(stage, capsys):
    """Every stage, both arms, at a small grid on the CPU (plain versions)."""
    from vorta_tpu_torch.tools import bench_pool

    times = bench_pool.main(["--device", "cpu", "--latent", "2", "3", "8", "--stage", stage])
    assert set(times) == {"plain", "kernel"} and all(t > 0 for t in times.values())
    assert "kernel" in capsys.readouterr().out
