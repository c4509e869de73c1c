"""The port's routed dispatch and joint experts under ``qk_int8`` against
the JAX package, on the CPU: FULL and LOWRES quantize q and k per head
(LOWRES after the pool; the joint experts the assembled [video | text]
layout) and run flash_manual's int8 QK mode, STA stays bf16, bitwise.

Inputs come from numpy with a seed and go to both sides; the JAX package
runs its Pallas kernels in interpret mode.  Both sides quantize the same
f32 values to the same int8 (tests/test_torch_port_quant.py holds the
quantizer bitwise), so the int32 scores are exact on both; the rest runs
in f32, rtol 1e-4 and atol 1e-4 x the output's scale.  Against the bf16
path: the JAX package's quality gate, mean relative error below 0.05.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.ops import joint_experts as jjoint
from vorta_tpu.ops import routed_fused as jrouted
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.ops import joint_experts as joint
from vorta_tpu_torch.ops.experts import FULL, LOWRES, STA
from vorta_tpu_torch.ops.routed_fused import fused_routed_attention


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


ROUTED = dict(latent_shape=(4, 6, 16), sta_tile=(2, 3, 8), sta_window=(3, 3, 3),
              lowres_window=(2, 3, 2), block_q=32, block_kv=32, qk_int8=True)


def test_routed_dispatch_qk_int8_matches_jax():
    """FULL and LOWRES heads through the int8 mode, STA bitwise the bf16
    path's; within the JAX package's quality gate of the unquantized path."""
    rng = np.random.default_rng(45)
    q, k, v = (rng.standard_normal((2, 4, 384, 32)).astype(np.float32) for _ in range(3))
    ids = np.asarray([FULL, LOWRES, STA, FULL])
    ref = jrouted.fused_routed_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                         jnp.asarray(ids, jnp.int32),
                                         JaxAttentionConfig(**ROUTED), interpret=True)
    t_in = [torch.from_numpy(x) for x in (q, k, v)]
    got = fused_routed_attention(*t_in, torch.from_numpy(ids), AttentionConfig(**ROUTED))
    _close(got, ref)
    bf = fused_routed_attention(*t_in, torch.from_numpy(ids),
                                AttentionConfig(**{**ROUTED, "qk_int8": False}))
    torch.testing.assert_close(got[:, 2], bf[:, 2], rtol=0, atol=0)
    assert 0 < _mean_rel(got, bf) < 0.05


VIDEO = dict(latent_shape=(4, 6, 16), sta_window=(3, 3, 3), sta_tile=(4, 6, 8),
             lowres_window=(2, 2, 2), block_q=32, block_kv=32, qk_int8=True)
L, EFF, SV = 24, 17, 4 * 6 * 16


def _joint_inputs(seed, b=2, h=3, d=16):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (SV,) * 3 + (L,) * 3]
    mask = np.broadcast_to(np.arange(L) < EFF, (b, L)).copy()
    return [torch.from_numpy(a) for a in arrs + [mask]], [jnp.asarray(a) for a in arrs + [mask]]


@pytest.mark.parametrize("expert", ["full", "lowres"])
def test_joint_experts_qk_int8_match_jax(expert):
    """The assembled joint layout quantized per head, kv_bias kept; a head
    routed away writes zeros."""
    tj = joint.JointConfig(AttentionConfig(**VIDEO), L)
    jj = jjoint.JointConfig(JaxAttentionConfig(**VIDEO), L)
    t_in, j_in = _joint_inputs(46)
    mine, ref = {"full": (joint.joint_full_attention, jjoint.joint_full_attention),
                 "lowres": (joint.joint_lowres_attention, jjoint.joint_lowres_attention)}[expert]
    want = [np.asarray(w) for w in ref(*j_in[:6], j_in[6], jj, scale=0.3, interpret=True)]
    active = np.asarray([True, False, True])
    got = mine(*t_in[:6], t_in[6], tj, scale=0.3, active=torch.from_numpy(active))
    _close(got[0], want[0] * active[None, :, None, None])
    _close(got[1][:, :, :EFF], (want[1] * active[None, :, None, None])[:, :, :EFF])


@pytest.mark.parametrize("mode", ["off", "hard"])
def test_routed_joint_attention_qk_int8_matches_jax(mode):
    """Routing off (Hunyuan's off arm runs int8 QK too) and hard (head 0
    FULL, 1 LOWRES, 2 STA, the STA head bitwise the bf16 path's)."""
    tj = joint.JointConfig(AttentionConfig(**VIDEO), L)
    jj = jjoint.JointConfig(JaxAttentionConfig(**VIDEO), L)
    t_in, j_in = _joint_inputs(47)
    scores = np.broadcast_to(np.asarray([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05],
                                         [0.05, 0.05, 0.9]], np.float32), (2, 3, 3)).copy()
    got = joint.routed_joint_attention(*t_in[:6], torch.from_numpy(scores), t_in[6], tj,
                                       mode=mode)
    want = jjoint.routed_joint_attention(*j_in[:6], jnp.asarray(scores), j_in[6], jj, mode=mode,
                                         interpret=True)
    _close(got[0], want[0])
    _close(got[1], want[1])
    tb = dataclasses.replace(tj, video=dataclasses.replace(tj.video, qk_int8=False))
    bf = joint.routed_joint_attention(*t_in[:6], torch.from_numpy(scores), t_in[6], tb,
                                      mode=mode)
    if mode == "hard":
        torch.testing.assert_close(got[0][:, STA], bf[0][:, STA], rtol=0, atol=0)
        torch.testing.assert_close(got[1][:, STA], bf[1][:, STA], rtol=0, atol=0)
    assert 0 < _mean_rel(got[0], bf[0]) < 0.05
