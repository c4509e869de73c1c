"""The port's kernel modules (vorta_tpu_torch.ops) against the JAX package's
Pallas kernels run in interpret mode on the CPU.

On CPU tensors each port wrapper runs its kernel's plain PyTorch version, so
these tests hold those plain versions to the TPU kernels' function.  Inputs
come from numpy and go to both.  Tolerances: f32 at 1e-5 (the two sides sum
in different orders), bf16 at 2e-2 (one bf16 rounding of the output, as
tests/test_prologue.py states).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorta_tpu.ops.flash import sparse_flash_attention_raw as jax_flash
from vorta_tpu.ops.fused_norm import _norm_fwd_pallas
from vorta_tpu.ops.prologue import fused_qk_prologue as jax_prologue
from vorta_tpu_torch.ops import _build
from vorta_tpu_torch.ops.attention_ref import attention_chunked, attention_dense
from vorta_tpu_torch.ops.flash import (
    BlockTables,
    dense_tables,
    sparse_flash_attention_raw,
    tables_from_block_mask,
)
from vorta_tpu_torch.ops.fused_norm import fused_norm
from vorta_tpu_torch.ops.prologue import fused_qk_prologue
from vorta_tpu_torch.ops.rope import apply_rope_half


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(arr: np.ndarray, name: str):
    """The same values as a JAX array and a torch CPU tensor of one dtype."""
    _, jdt, tdt, _ = DTYPES[name]
    j = jnp.asarray(arr, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# --- flash ------------------------------------------------------------------

B, H, S, BLK = 1, 2, 128, 32
NB = S // BLK


def _sparse_tables(per_head: bool) -> BlockTables:
    rng = np.random.default_rng(7)
    mask = rng.random((H if per_head else 1, NB, NB)) < 0.5
    mask[..., 0, :] = False  # q block 0 sees nothing: kv_count 0 -> zero rows
    mask[..., 1, 1] = True
    return tables_from_block_mask(mask)


TABLES = {
    "dense": lambda: dense_tables(NB, NB),
    "shared": lambda: _sparse_tables(False),
    "per_head": lambda: _sparse_tables(True),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tables,valid", [("dense", 100), ("dense", None),
                                          ("shared", None), ("per_head", 111)])
def test_flash_matches_pallas(tables, valid, d, dtype):
    rng = np.random.default_rng(0)
    qn, kn, vn = (rng.standard_normal((B, H, S, d)).astype(np.float32) for _ in range(3))
    (qj, qt), (kj, kt), (vj, vt) = _pair(qn, dtype), _pair(kn, dtype), _pair(vn, dtype)
    tab = TABLES[tables]()
    kw = dict(scale=0.1, block_q=BLK, block_kv=BLK, kv_valid_len=valid)
    ref = jax_flash(qj, kj, vj, jnp.asarray(tab.kv_index), jnp.asarray(tab.kv_count),
                    interpret=True, **kw)
    got = sparse_flash_attention_raw(qt, kt, vt, torch.from_numpy(tab.kv_index),
                                     torch.from_numpy(tab.kv_count), **kw)
    assert got.dtype == DTYPES[dtype][2] and got.shape == (B, H, S, d)
    tol = DTYPES[dtype][3]
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)
    if tables != "dense":
        assert not np.any(_np(got)[:, :, :BLK])  # empty q block -> 0


def test_flash_dense_equals_oracles():
    """Dense tables + tail mask == attention_dense on the valid prefix, and
    the plain chunked version agrees with the JAX one."""
    from vorta_tpu.ops.attention_ref import attention_chunked as jax_chunked

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, 64)).astype(np.float32))
               for _ in range(3))
    tab = dense_tables(NB, NB)
    got = sparse_flash_attention_raw(q, k, v, tab.kv_index, tab.kv_count, block_q=BLK,
                                     block_kv=BLK, kv_valid_len=100)
    want = attention_dense(q, k[:, :, :100], v[:, :, :100])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    bm = torch.from_numpy(_sparse_tables(True).block_mask(NB))
    ch = attention_chunked(q, k, v, bm, block_q=BLK, block_kv=BLK, kv_valid_len=100)
    chj = jax_chunked(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                      jnp.asarray(bm.numpy()), block_q=BLK, block_kv=BLK, kv_valid_len=100)
    np.testing.assert_allclose(ch.numpy(), np.asarray(chj), atol=1e-5, rtol=1e-5)


def test_flash_unported_features_raise():
    """Per-head kv_valid and pair_bits of the flash kernel are not ported (no
    call site on the served paths passes them)."""
    q = torch.zeros((1, 1, 32, 64))
    tab = dense_tables(1, 1)
    for kw in (dict(kv_valid=torch.tensor([20])), dict(pair_bits=torch.zeros((1, 1, 1)))):
        with pytest.raises(NotImplementedError):
            sparse_flash_attention_raw(q, q, q, tab.kv_index, tab.kv_count, block_q=32,
                                       block_kv=32, **kw)


# --- AdaLN norm ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("mod", [False, True])
@pytest.mark.parametrize("affine", ["none", "gamma", "gamma_beta"])
@pytest.mark.parametrize("rms", [False, True])
def test_norm_matches_pallas(rms, affine, mod, out_f32, dtype):
    rng = np.random.default_rng(2)
    b, s, dim = 2, 16, 128
    xj, xt = _pair(3.0 * rng.standard_normal((b, s, dim)) + 0.5, dtype)
    vec = {n: rng.standard_normal(shape).astype(np.float32) * 0.3
           for n, shape in (("scale", (b, dim)), ("shift", (b, dim)),
                            ("gamma", (dim,)), ("beta", (dim,)))}
    use = {"scale": mod, "shift": mod, "gamma": affine != "none", "beta": affine == "gamma_beta"}
    jargs = [jnp.asarray(vec[n]) if use[n] else None for n in ("scale", "shift", "gamma", "beta")]
    targs = [torch.from_numpy(vec[n]) if use[n] else None
             for n in ("scale", "shift", "gamma", "beta")]
    ref = _norm_fwd_pallas(xj, *jargs, rms=rms, eps=1e-6, out_f32=out_f32, interpret=True)
    got = fused_norm(xt, *targs, rms, 1e-6, out_f32)
    assert got.dtype == (torch.float32 if out_f32 else xt.dtype)
    tol = 1e-5 if (dtype == "f32" or out_f32) else 2e-2
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)


# --- qk prologue --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("norm_scope", ["row", "head"])
@pytest.mark.parametrize("qk_norm", [True, False])
def test_prologue_matches_pallas(qk_norm, norm_scope, dtype):
    b, s, h, d = 2, 48, 3, 128
    dim = h * d
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng.standard_normal((b, s, dim)), dtype)
                                    for _ in range(3))
    gq = (1.0 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    gk = (1.0 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    ang = rng.uniform(0, 6.28, (s, d // 2))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    kw = dict(num_heads=h, eps=1e-6, qk_norm=qk_norm, norm_scope=norm_scope)
    gj = (jnp.asarray(gq), jnp.asarray(gk)) if qk_norm else (None, None)
    gt = (torch.from_numpy(gq), torch.from_numpy(gk)) if qk_norm else (None, None)
    ref = jax_prologue(qj, kj, vj, *gj, jnp.asarray(cos), jnp.asarray(sin),
                       interpret=True, **kw)
    got = fused_qk_prologue(qt, kt, vt, *gt, torch.from_numpy(cos), torch.from_numpy(sin), **kw)
    tol = DTYPES[dtype][3]
    for g, r in zip(got[:2], ref[:2]):
        assert g.shape == (b, h, s, d) and g.dtype == qt.dtype
        np.testing.assert_allclose(_np(g), _np(r), atol=tol, rtol=tol)
    np.testing.assert_array_equal(_np(got[2]), _np(ref[2]))


def test_prologue_equals_unfused_path():
    """Fused plain version == RMSNorm -> head split -> apply_rope_half."""
    from vorta_tpu_torch.models.common import RMSNorm

    b, s, h, d = 1, 20, 2, 64  # S and d the TPU kernel could not take
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    ang = torch.from_numpy(rng.uniform(0, 6.28, (s, d // 2)).astype(np.float32))
    cos, sin = ang.cos(), ang.sin()
    norm = RMSNorm(h * d)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(1 + 0.1 * rng.standard_normal(h * d)))
    fq, fk, fv = fused_qk_prologue(q, k, v, norm.weight, norm.weight, cos, sin, num_heads=h)

    def unfused(x):
        return apply_rope_half(norm(x).reshape(b, s, h, d).transpose(1, 2), cos, sin)

    torch.testing.assert_close(fq, unfused(q), atol=0, rtol=0)
    torch.testing.assert_close(fk, unfused(k), atol=0, rtol=0)
    torch.testing.assert_close(fv, v.reshape(b, s, h, d).transpose(1, 2), atol=0, rtol=0)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: no build, no count."""
    from vorta_tpu_torch.geometry import build_lowres_groups
    from vorta_tpu_torch.ops.coreset_pallas import pool_qkv, unpool
    from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual
    from vorta_tpu_torch.ops.sta_pipe import sta_pipe_attention

    _build.reset_launches()
    x = torch.ones((1, 16, 128))
    fused_norm(x, None, None, None, None, False, 1e-6, False)
    q = torch.ones((1, 2, 64, 64))
    tab = dense_tables(2, 2)
    sparse_flash_attention_manual(q, q, q, tab.kv_index, tab.kv_count, block_q=32, block_kv=32)
    sta_pipe_attention(q, q, q, torch.ones(2), latent_shape=(4, 4, 4), tile=(2, 2, 2))
    groups = build_lowres_groups((4, 4, 4), (2, 2, 2))
    pq, pk, pv, picks = pool_qkv(q, q, q, groups, return_picks=True)
    unpool(pq, q, groups, picks=picks)
    assert sum(_build.launches.values()) == 0
    assert set(_build.launches) == set(_build.KERNELS)
    assert not _build._libs
