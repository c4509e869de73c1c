"""The port's differentiable attention and norm (the training slice) against
the JAX package on the CPU: the flash forward's lse, ``transpose_tables``,
the flash backward's plain version and ``make_sparse_attention``'s
gradients, ``fused_norm``'s autograd rule, the soft routed experts'
gradients, the coreset pooling's gradient, and the inference-only
wrappers' grad guards.

JAX runs its Pallas kernels in interpret mode (``tests/test_flash_bwd.py``'s
way).  Inputs come from numpy and go to both sides.  Tolerances, f32 on
both sides: rtol 1e-4 and atol 1e-4 x the compared array's scale (its max
abs value), since XLA-CPU and PyTorch sum in different orders; gradients
of the JAX chunked oracle (``xla_bwd``) are 5e-3 apart from its kernels in
the JAX package's own test, and the port holds both of its paths to the
JAX kernels' gradients at 1e-4 x scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorta_tpu.ops.flash import make_sparse_attention as jax_make_attention
from vorta_tpu.ops.flash import sparse_flash_attention_raw as jax_flash
from vorta_tpu.ops.flash import tables_from_block_mask as jax_tables_from_block_mask
from vorta_tpu.ops.flash_bwd import transpose_tables as jax_transpose_tables
from vorta_tpu.ops.fused_norm import fused_norm as jax_fused_norm
from vorta_tpu_torch.ops import _build
from vorta_tpu_torch.ops.attention_ref import attention_chunked, attention_dense
from vorta_tpu_torch.ops.flash import (
    dense_tables,
    make_sparse_attention,
    sparse_flash_attention_raw,
    tables_from_block_mask,
)
from vorta_tpu_torch.ops.flash_bwd import flash_backward, flash_backward_ref, transpose_tables
from vorta_tpu_torch.ops.fused_norm import fused_norm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, H, S, D, BLK = 1, 2, 64, 32, 16
NB = S // BLK


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * max(np.abs(want).max(), 1e-30))


def _mask(kind: str) -> np.ndarray:
    """(1, NB, NB) block mask: dense, or random with q block 0 empty."""
    if kind == "dense":
        return np.ones((1, NB, NB), bool)
    rng = np.random.default_rng(1)
    mask = rng.random((1, NB, NB)) < 0.6
    mask[:, 0, :] = False  # a q block with kv_count 0: lse sentinel, zero dq
    mask[:, 1:, 0] = True
    return mask


CASES = {  # name: (mask kind, kv_valid_len)
    "dense": ("dense", None),
    "sparse": ("sparse", None),
    "tail": ("dense", 50),
    "sparse_tail": ("sparse", 57),
}


def _qkv(seed=0, s=S, d=D, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, s, d)).astype(np.float32) for _ in range(n)]


# --- forward lse ----------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_lse_matches_pallas(case):
    kind, valid = CASES[case]
    qn, kn, vn = _qkv(0, n=3)
    mask = _mask(kind)
    jt, tt = jax_tables_from_block_mask(mask), tables_from_block_mask(mask)
    kw = dict(scale=0.2, block_q=BLK, block_kv=BLK, kv_valid_len=valid)
    ref_out, ref_lse = jax_flash(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(jt.kv_index), jnp.asarray(jt.kv_count),
                                 return_lse=True, interpret=True, **kw)
    out, lse = sparse_flash_attention_raw(*map(torch.from_numpy, (qn, kn, vn)), tt.kv_index,
                                          tt.kv_count, return_lse=True, **kw)
    assert lse.shape == (B, H, S, 1) and lse.dtype == torch.float32
    _close(out, ref_out)
    ref_lse = np.asarray(ref_lse)
    empty = ref_lse == 1e30
    assert (lse.numpy()[empty] == 1e30).all() and empty.any() == (kind == "sparse")
    _close(lse[torch.from_numpy(~empty)], ref_lse[~empty])


# --- transposed tables ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transpose_tables_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((1, 6, 8)) < 0.4
    mask[0, 2] = False
    tab = tables_from_block_mask(mask)
    got = transpose_tables(tab.kv_index, tab.kv_count, 8)
    want = jax_transpose_tables(tab.kv_index, tab.kv_count, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --- the backward ---------------------------------------------------------------

def _jax_grads(attn, q, k, v, g):
    def loss(q, k, v):
        return jnp.sum(attn(q, k, v).astype(jnp.float32) * g)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _torch_grads(attn, q, k, v, g):
    qs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (attn(*qs) * torch.from_numpy(g)).sum().backward()
    return [x.grad for x in qs]


@pytest.fixture(scope="module")
def jax_reference():
    """JAX kernel-backward gradients per case (module-scoped: interpret-mode
    Pallas is the slow side)."""
    q, k, v, g = _qkv(2)
    out = {}
    for case, (kind, valid) in CASES.items():
        attn = jax_make_attention(jax_tables_from_block_mask(_mask(kind)), n_kv_blocks=NB,
                                  block_q=BLK, block_kv=BLK, kv_valid_len=valid, interpret=True)
        out[case] = [np.asarray(x) for x in _jax_grads(attn, *map(jnp.asarray, (q, k, v, g)))]
    return (q, k, v, g), out


@pytest.mark.parametrize("xla_bwd", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_attention_grads_match_jax(jax_reference, case, xla_bwd):
    """make_sparse_attention's gradients (the kernels' plain version, or the
    attention_chunked oracle with xla_bwd) equal JAX's kernel gradients;
    padded kv rows get zero dk and dv, an empty q block zero dq."""
    (q, k, v, g), ref = jax_reference
    kind, valid = CASES[case]
    attn = make_sparse_attention(tables_from_block_mask(_mask(kind)), n_kv_blocks=NB,
                                 block_q=BLK, block_kv=BLK, kv_valid_len=valid, xla_bwd=xla_bwd)
    assert attn.kernel_bwd == (not xla_bwd)
    got = _torch_grads(attn, q, k, v, g)
    for a, b in zip(got, ref[case]):
        _close(a, b)
    if valid:
        assert not got[1][:, :, valid:].any() and not got[2][:, :, valid:].any()
    if kind == "sparse":
        assert not got[0][:, :, :BLK].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_ref_matches_dense_autograd(case):
    """flash_backward (its plain version) against autograd of attention_dense
    with the expanded mask, and attention_chunked's autograd against the
    same: both oracles are differentiable and agree."""
    kind, valid = CASES[case]
    q, k, v, g = (torch.from_numpy(x) for x in _qkv(3))
    mask = _mask(kind)
    tab = tables_from_block_mask(mask)
    vis = torch.from_numpy(mask[0]).repeat_interleave(BLK, 0).repeat_interleave(BLK, 1)
    vis &= torch.arange(S) < (valid or S)
    out, lse = sparse_flash_attention_raw(q, k, v, tab.kv_index, tab.kv_count, block_q=BLK,
                                          block_kv=BLK, kv_valid_len=valid, return_lse=True)
    qi, qc = transpose_tables(tab.kv_index, tab.kv_count, NB)
    got = flash_backward(q, k, v, out, lse, g, tab.kv_index, tab.kv_count, qi, qc,
                         scale=D**-0.5, block_q=BLK, block_kv=BLK, kv_valid_len=valid or S)

    def oracle(fn):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*xs) * g).sum().backward()
        return [x.grad for x in xs]

    rows = vis.any(-1)[:, None]  # attention_dense gives a row with no key the mean of v
    dense = oracle(lambda a, b, c: torch.where(rows, attention_dense(a, b, c, mask=vis), 0.0))
    chunked = oracle(lambda a, b, c: attention_chunked(
        a, b, c, block_mask=torch.from_numpy(mask).expand(H, -1, -1), block_q=BLK,
        block_kv=BLK, kv_valid_len=valid))
    for a, b, c in zip(got, dense, chunked):
        _close(a, b.numpy())
        _close(c, b.numpy())


def test_flash_backward_skips_what_is_not_needed():
    q, k, v, g = (torch.from_numpy(x) for x in _qkv(4))
    tab = dense_tables(NB, NB)
    out, lse = sparse_flash_attention_raw(q, k, v, tab.kv_index, tab.kv_count, block_q=BLK,
                                          block_kv=BLK, return_lse=True)
    qi, qc = transpose_tables(tab.kv_index, tab.kv_count, NB)
    kw = dict(scale=D**-0.5, block_q=BLK, block_kv=BLK, kv_valid_len=S)
    full = flash_backward(q, k, v, out, lse, g, tab.kv_index, tab.kv_count, qi, qc, **kw)
    dq, dk, dv = flash_backward(q, k, v, out, lse, g, tab.kv_index, tab.kv_count, qi, qc,
                                need_dkv=False, **kw)
    assert dk is None and dv is None and torch.equal(dq, full[0])
    dq, dk, dv = flash_backward_ref(q, k, v, out, lse, g, tab.kv_index, tab.kv_count,
                                    need_dq=False, **{k_: w for k_, w in kw.items()})
    assert dq is None and torch.equal(dk, full[1]) and torch.equal(dv, full[2])
    # k, v without grad (the cross-attention's frozen text): no dk, dv
    attn = make_sparse_attention(tab, n_kv_blocks=NB, block_q=BLK, block_kv=BLK)
    qg = q.clone().requires_grad_()
    (attn(qg, k, v) * g).sum().backward()
    torch.testing.assert_close(qg.grad, full[0], rtol=0, atol=0)


# --- fused_norm's autograd rule ---------------------------------------------------

@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("mod", [False, True])
@pytest.mark.parametrize("affine", ["none", "gamma", "gamma_beta"])
@pytest.mark.parametrize("rms", [False, True])
def test_norm_grads_match_jax_vjp(rms, affine, mod, out_f32):
    rng = np.random.default_rng(5)
    b, s, dim = 2, 8, 64
    x = (3.0 * rng.standard_normal((b, s, dim)) + 0.5).astype(np.float32)
    vec = {n: (0.3 * rng.standard_normal(shape)).astype(np.float32)
           for n, shape in (("scale", (b, dim)), ("shift", (b, dim)), ("gamma", (dim,)),
                            ("beta", (dim,)))}
    use = {"scale": mod, "shift": mod, "gamma": affine != "none", "beta": affine == "gamma_beta"}
    names = [n for n in ("scale", "shift", "gamma", "beta") if use[n]]
    g = rng.standard_normal((b, s, dim)).astype(np.float32)

    def jfn(x, *args):
        a = dict(zip(names, args))
        return jax_fused_norm(x, a.get("scale"), a.get("shift"), a.get("gamma"), a.get("beta"),
                              rms, 1e-6, out_f32)

    ref_out, vjp = jax.vjp(jfn, jnp.asarray(x), *(jnp.asarray(vec[n]) for n in names))
    ref = vjp(jnp.asarray(g))
    xs = torch.from_numpy(x).requires_grad_()
    args = {n: torch.from_numpy(vec[n]).requires_grad_() for n in names}
    out = fused_norm(xs, args.get("scale"), args.get("shift"), args.get("gamma"),
                     args.get("beta"), rms, 1e-6, out_f32)
    assert out.grad_fn is not None and "FusedNorm" in type(out.grad_fn).__name__
    (out * torch.from_numpy(g)).sum().backward()
    _close(out, ref_out)
    for got, want in zip([xs.grad] + [args[n].grad for n in names], ref):
        _close(got, want)


# --- the soft routed experts and the coreset pooling -----------------------------

def _routed_cfgs():
    from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
    from vorta_tpu_torch.config import AttentionConfig

    kw = dict(latent_shape=(4, 4, 4), sta_window=(3, 3, 1), sta_tile=(2, 2, 2),
              lowres_window=(2, 2, 2), block_q=16, block_kv=16, sta_block_q=8, sta_block_kv=8)
    return JaxAttentionConfig(**kw), AttentionConfig(**kw)


def test_soft_routed_attention_grads_match_jax():
    """Soft routing's gradients in q, k, v and the scores: the three experts
    (each through make_sparse_attention) and the weighted combine, at
    tests/test_flash_bwd.py's geometry."""
    from vorta_tpu.ops.experts import routed_attention as jax_routed
    from vorta_tpu_torch.ops.experts import routed_attention

    jcfg, tcfg = _routed_cfgs()
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 2, 64, 16)).astype(np.float32) for _ in range(3))
    logits = rng.standard_normal((1, 2, 3)).astype(np.float32)
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    g = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)

    def jloss(q, k, v, sc):
        out = jax_routed(q, k, v, sc, jcfg, mode="soft", interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, scores)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, scores)]
    (routed_attention(*xs[:3], xs[3], tcfg, mode="soft") * torch.from_numpy(g)).sum().backward()
    for got, want in zip(xs, ref):
        _close(got.grad, want)


def test_coreset_pool_unpool_grads_match_jax():
    """Gradients flow through the pooled / unpooled values only (the
    matching is discrete): the port's gather / scatter against JAX's one-hot
    einsums, through pool -> a per-token scale -> unpool."""
    from vorta_tpu.geometry import build_lowres_groups as jax_groups
    from vorta_tpu.ops.coreset import pool_by_similarity as jax_pool
    from vorta_tpu.ops.coreset import unpool_by_similarity as jax_unpool
    from vorta_tpu_torch.geometry import build_lowres_groups
    from vorta_tpu_torch.ops.coreset import pool_by_similarity, unpool_by_similarity

    shape, window = (4, 4, 4), (2, 2, 2)
    jg, tg = jax_groups(shape, window, 0.5), build_lowres_groups(shape, window, 0.5)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    w = rng.standard_normal((1, 2, tg.pooled_length, 16)).astype(np.float32)
    g = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)

    def jloss(x):
        pooled, matching = jax_pool(x, jg)
        return jnp.sum(jax_unpool(pooled * w, jg, matching) * g)

    ref = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    pooled, matching = pool_by_similarity(xt, tg)
    (unpool_by_similarity(pooled * torch.from_numpy(w), tg, matching)
     * torch.from_numpy(g)).sum().backward()
    _close(xt.grad, ref)


# --- the inference-only wrappers ---------------------------------------------------

def _wrapper_calls(device):
    from vorta_tpu_torch.geometry import build_lowres_groups
    from vorta_tpu_torch.ops.coreset_pallas import pool_qkv, unpool
    from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual
    from vorta_tpu_torch.ops.prologue import fused_qk_prologue
    from vorta_tpu_torch.ops.sta_pipe import sta_pipe_attention

    groups = build_lowres_groups((4, 4, 4), (2, 2, 2))
    tab = dense_tables(1, 1)
    ones = torch.ones(2)

    def q_like():
        return torch.randn((1, 2, 64, 64)).to(device).requires_grad_()

    x = torch.randn((1, 64, 128)).to(device).requires_grad_()
    cos = torch.ones((64, 32), device=device)
    picks = torch.zeros((1, 2, 2, 2, 2, groups.num_kept_margins), dtype=torch.int32,
                        device=device)
    return {
        "flash": lambda: sparse_flash_attention_raw(q_like(), q_like(), q_like(), tab.kv_index,
                                                    tab.kv_count, block_q=64, block_kv=64),
        "flash_manual": lambda: sparse_flash_attention_manual(
            q_like(), q_like(), q_like(), tab.kv_index, tab.kv_count, block_q=64, block_kv=64),
        "sta_pipe": lambda: sta_pipe_attention(q_like(), q_like(), q_like(), ones,
                                               latent_shape=(4, 4, 4), tile=(2, 2, 2)),
        "pool_qkv": lambda: pool_qkv(q_like(), q_like(), q_like(), groups),
        "unpool": lambda: unpool(q_like()[:, :, :groups.pooled_length], q_like(), groups,
                                 picks=picks if device != "cpu" else None),
        "prologue": lambda: fused_qk_prologue(x, x, x, None, None, cos, cos, num_heads=2),
    }


@pytest.mark.parametrize("name", ["flash", "flash_manual", "sta_pipe", "pool_qkv", "unpool",
                                  "prologue"])
def test_inference_wrappers_guard_gradients(name):
    """On the CPU the plain versions stay differentiable; off the CPU (meta
    tensors here, CUDA on the card) a wrapper without a backward raises
    under grad mode instead of cutting the graph silently, before any
    build or launch."""
    out = _wrapper_calls("cpu")[name]()
    first = out[0] if isinstance(out, tuple) else out
    assert first.requires_grad
    first.float().sum().backward()
    with pytest.raises(RuntimeError, match="no backward"):
        _wrapper_calls("meta")[name]()
    assert not _build._libs
