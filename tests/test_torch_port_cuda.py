"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (Hopper, sm_90a) and the CUDA toolkit: they
carry the ``cuda`` marker and skip without a card.  They import no JAX, so
they run on a machine without it, without the JAX package's conftest:

  python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

``chip_smoke.py`` checks the kernels at the main path's shapes and flags;
these cover the rest of what each wrapper accepts (bf16 inputs, as the
model runs on the card): the norm's rms / affine / out_f32 flags, the
prologue's head scope, qk_norm off and odd sequence lengths, flash and
flash_manual at head dim 64, small blocks, per-head tables and counts,
sta_pipe at every tile-width class with clamped and whole-axis windows,
pool/unpool with inactive heads, and that the options each wrapper leaves
to later slices raise.  Tolerances: 1e-5 x max
|plain| for f32 outputs (the two sides sum in different orders); for bf16
outputs, element by element, 2^-5 x max(|plain|, RMS(plain)), i.e. 4 to 8
bf16 ulps at the element's magnitude (an output rounding, and P rounded to
bf16 inside flash, can differ between the two sides).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vorta_tpu_torch.geometry import build_lowres_groups
from vorta_tpu_torch.ops import _build
from vorta_tpu_torch.ops.coreset_pallas import (
    pick_gaps,
    pool_qkv,
    pool_qkv_ref,
    unpool,
    unpool_ref,
)
from vorta_tpu_torch.ops.flash import (
    dense_tables,
    sparse_flash_attention_raw,
    sparse_flash_attention_ref,
    tables_from_block_mask,
)
from vorta_tpu_torch.ops.flash_manual import (
    sparse_flash_attention_manual,
    sparse_flash_attention_manual_ref,
)
from vorta_tpu_torch.ops.fused_norm import _norm_ref, fused_norm
from vorta_tpu_torch.ops.prologue import _prologue_ref, fused_qk_prologue
from vorta_tpu_torch.ops.sta_pipe import sta_pipe_attention, sta_pipe_attention_ref

pytestmark = pytest.mark.cuda

@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    f32 = got.dtype == torch.float32
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    if f32:
        assert err.max().item() <= 1e-5 * want.abs().max().item()
    else:
        floor = torch.maximum(want.abs(), want.pow(2).mean().sqrt())
        assert (err / floor).max().item() <= 2.0**-5


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


# --- flash ------------------------------------------------------------------

def _tables(kind: str, h: int, nq: int, nkv: int):
    if kind == "dense":
        return dense_tables(nq, nkv)
    rng = np.random.default_rng(1)
    mask = rng.random((h if kind == "per_head" else 1, nq, nkv)) < 0.5
    mask[..., 0, :] = False  # a q block with kv_count 0 gives zero rows
    mask[..., 1, 0] = True
    return tables_from_block_mask(mask)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,block,seq,valid", [
    ("dense", 32, 128, 100),      # small blocks, one warp per CUDA block
    ("dense", 1024, 2048, 1500),  # self-attention's blocks, tail mid-block
    ("dense", 64, 192, None),
    ("shared", 64, 256, 250),
    ("per_head", 32, 256, None),
])
def test_flash_kernel_matches_plain(card, d, kind, block, seq, valid):
    b, h = 2, 3
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (_randn(g, (b, h, seq, d), torch.bfloat16) for _ in range(3))
    ki, kc = _tables(kind, h, seq // block, seq // block).on(card)
    kw = dict(block_q=block, block_kv=block, kv_valid_len=valid, scale=1.1 * d**-0.5)
    _build.reset_launches()
    got = sparse_flash_attention_raw(q, k, v, ki, kc, **kw)
    assert _build.launches["flash"] == 1
    _close(got, sparse_flash_attention_ref(q, k, v, ki, kc, **kw))
    if kind != "dense":
        assert not got[:, :, :block].any()


def test_flash_kernel_cross_attention_blocks(card):
    """Cross-attention's tables: 2048-row q blocks over one 512 kv block, text tail."""
    g = torch.Generator(device=card).manual_seed(2)
    q = _randn(g, (1, 2, 4096, 128), torch.bfloat16)
    k, v = (_randn(g, (1, 2, 512, 128), torch.bfloat16) for _ in range(2))
    ki, kc = dense_tables(2, 1).on(card)
    kw = dict(block_q=2048, block_kv=512, kv_valid_len=300)
    _close(sparse_flash_attention_raw(q, k, v, ki, kc, **kw),
           sparse_flash_attention_ref(q, k, v, ki, kc, **kw))


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 1, 64, 128), device=card)
    ki, kc = dense_tables(1, 1).on(card)
    with pytest.raises(NotImplementedError, match="bf16"):
        sparse_flash_attention_raw(q, q, q, ki, kc, block_q=64, block_kv=64)
    qb = torch.zeros((1, 1, 64, 96), device=card, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="D 64/128"):
        sparse_flash_attention_raw(qb, qb, qb, ki, kc, block_q=64, block_kv=64)


# --- flash_manual (routed FULL / LOWRES experts) -----------------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,block,seq,valid", [
    ("dense", 32, 128, 100),      # small blocks, one warp per CUDA block
    ("dense", 1024, 2048, 1500),  # the experts' blocks, tail mid-block
    ("shared", 64, 256, 250),
    ("per_head", 32, 256, None),  # per-head index tables and counts
])
def test_flash_manual_kernel_matches_plain(card, d, kind, block, seq, valid):
    """Head-shared index tables with per-head counts (some heads routed
    away: count 0 writes zeros), as the routed experts launch it."""
    b, h = 2, 3
    g = torch.Generator(device=card).manual_seed(10)
    # unit-RMS q/k, as the qk-normed model feeds the fast softmax
    q, k, v = (_randn(g, (b, h, seq, d), torch.bfloat16) for _ in range(3))
    ki, kc = _tables(kind, h, seq // block, seq // block).on(card)
    if kind != "per_head":  # per-head counts over the shared index table
        kc = torch.where(torch.tensor([True, False, True], device=card)[:, None], kc, 0)
    kw = dict(block_q=block, block_kv=block, kv_valid_len=valid, scale=1.1 * d**-0.5)
    _build.reset_launches()
    got = sparse_flash_attention_manual(q, k, v, ki, kc, **kw)
    assert _build.launches["flash_manual"] == 1
    _close(got, sparse_flash_attention_manual_ref(q, k, v, ki, kc, **kw))
    if kind != "per_head":
        assert not got[:, 1].any()  # the head routed away


def test_flash_manual_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 64, 128), device=card, dtype=torch.bfloat16)
    ki, kc = dense_tables(1, 1).on(card)
    kw = dict(block_q=64, block_kv=64)
    for bad in (dict(kv_valid=torch.ones(2)), dict(pair_bits=ki), dict(kv_bias=q[0, :1, :, 0]),
                dict(qk_scale=torch.ones(2)), dict(softmax="stable")):
        with pytest.raises(NotImplementedError):
            sparse_flash_attention_manual(q, q, q, ki, kc, **kw, **bad)
    with pytest.raises(NotImplementedError, match="bf16"):
        sparse_flash_attention_manual(q.float(), q.float(), q.float(), ki, kc, **kw)


# --- sta_pipe (routed STA expert) ---------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("latent,tile,window", [
    ((4, 6, 16), (2, 3, 8), (3, 3, 3)),    # tw % 8 == 0; window spans t and h whole
    ((8, 6, 32), (2, 3, 8), (3, 3, 3)),    # real clamping on t and w
    ((8, 6, 20), (2, 3, 4), (3, 3, 3)),    # tw | 8 (the TPU's grouped-width variant)
    ((8, 6, 30), (2, 3, 6), (3, 3, 3)),    # neither (masked-width variant)
    ((12, 18, 20), (4, 6, 4), (3, 3, 3)),  # the 480p tile, window narrower on every axis
    ((4, 4, 4), (2, 2, 2), (3, 3, 1)),     # wan-tiny's window
])
def test_sta_kernel_matches_plain(card, d, latent, tile, window):
    b, h = 2, 3
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(11)
    q, k, v = (_randn(g, (b, h, s, d), torch.bfloat16) for _ in range(3))
    active = torch.tensor([1, 0, 1], device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, window=window, scale=1.1 * d**-0.5)
    _build.reset_launches()
    got = sta_pipe_attention(q, k, v, active, **kw)
    assert _build.launches["sta_pipe"] == 1
    _close(got, sta_pipe_attention_ref(q, k, v, active, **kw))
    assert not got[:, 1].any()  # inactive head


def test_sta_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 4 * 6 * 16, 128), device=card, dtype=torch.bfloat16)
    kw = dict(latent_shape=(4, 6, 16), tile=(2, 3, 8))
    act = torch.ones(2, device=card, dtype=torch.int32)
    for bad in (dict(text_k=q[:, :, :8]), dict(qk_scale=torch.ones(2)), dict(softmax="stable"),
                dict(variant="sT")):
        with pytest.raises(NotImplementedError):
            sta_pipe_attention(q, q, q, act, **kw, **bad)
    with pytest.raises(NotImplementedError, match="bf16"):
        sta_pipe_attention(q.float(), q.float(), q.float(), act, **kw)


# --- coreset pool / unpool (routed LOWRES expert) ------------------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("latent,window", [((4, 6, 16), (2, 3, 2)), ((4, 8, 8), (2, 2, 2))])
def test_pool_unpool_kernels_match_plain(card, d, latent, window):
    """Picks equal the plain version's but at near-ties (|dsim| < 1e-5 in
    f32); pooled and unpooled rows are pure selection, bitwise equal."""
    b, h = 2, 3
    groups = build_lowres_groups(latent, window, 0.5)
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(12)
    q, k, v = (_randn(g, (b, h, s, d), torch.bfloat16) for _ in range(3))
    active = torch.tensor([1, 1, 0], device=card, dtype=torch.int32)
    _build.reset_launches()
    got = pool_qkv(q, k, v, groups, active=active, return_picks=True)
    want = pool_qkv_ref(q, k, v, groups, active=active)
    torch.cuda.synchronize()
    assert (pick_gaps(got[3], want[3], q, groups) < 1e-5).all()
    same = (got[3] == want[3]).all().item()
    for a, w in zip(got[:3], want[:3]):
        assert a.shape == w.shape and (torch.equal(a, w) or not same)
    out_p = _randn(g, (b, h, groups.pooled_length, d), torch.bfloat16)
    up = unpool(out_p, q, groups, active=active, picks=got[3])
    assert _build.launches["pool_qkv"] == 1 and _build.launches["unpool"] == 1
    assert torch.equal(up, unpool_ref(out_p, q, groups, active=active, picks=got[3]))
    assert not up[:, 2].any() and not got[0][:, 2].any()


def test_pool_unpool_kernels_reject_what_they_do_not_take(card):
    groups = build_lowres_groups((4, 6, 16), (2, 3, 2), 0.5)
    q = torch.zeros((1, 2, 384, 128), device=card, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        pool_qkv(q, q, q, groups, kv_matching_from_k=True)
    with pytest.raises(NotImplementedError):
        pool_qkv(q, q, q, groups, head_map=torch.zeros(2), num_active=1)
    with pytest.raises(NotImplementedError, match="picks"):
        unpool(q[:, :, :groups.pooled_length], q, groups)
    with pytest.raises(NotImplementedError, match="bf16"):
        pool_qkv(q.float(), q.float(), q.float(), groups)


# --- AdaLN norm ---------------------------------------------------------------

@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("mod", [False, True])
@pytest.mark.parametrize("affine", ["none", "gamma", "gamma_beta"])
@pytest.mark.parametrize("rms", [False, True])
def test_norm_kernel_matches_plain(card, rms, affine, mod, out_f32):
    b, s, dim = 2, 37, 1000  # dim not a multiple of the block's 256 threads
    g = torch.Generator(device=card).manual_seed(3)
    x = (_randn(g, (b, s, dim), torch.float32, 3.0) + 0.5).to(torch.bfloat16)
    scale, shift = ((0.3 * torch.randn((b, dim), generator=g, device=card)) if mod else None
                    for _ in range(2))
    gamma = 1 + 0.1 * torch.randn(dim, generator=g, device=card) if affine != "none" else None
    beta = 0.1 * torch.randn(dim, generator=g, device=card) if affine == "gamma_beta" else None
    _build.reset_launches()
    got = fused_norm(x, scale, shift, gamma, beta, rms, 1e-6, out_f32)
    assert _build.launches["fused_norm"] == 1
    assert got.dtype == (torch.float32 if out_f32 else torch.bfloat16)
    _close(got, _norm_ref(x, scale, shift, gamma, beta, rms=rms, eps=1e-6, out_f32=out_f32))


def test_norm_kernel_takes_column_slices_of_the_modulation(card):
    """AdaLN passes mod[:, 1] / mod[:, 0], strided (B, dim) views of (B, 6, dim)."""
    g = torch.Generator(device=card).manual_seed(4)
    x = _randn(g, (2, 64, 1536), torch.bfloat16, 3.0)
    mod = torch.randn((2, 6, 1536), generator=g, device=card)
    got = fused_norm(x, mod[:, 1], mod[:, 0], None, None, False, 1e-6, False)
    _close(got, _norm_ref(x, mod[:, 1], mod[:, 0], None, None, rms=False, eps=1e-6,
                          out_f32=False))


# --- qk prologue --------------------------------------------------------------

@pytest.mark.parametrize("norm_scope", ["row", "head"])
@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("h,d", [(3, 128), (5, 64)])
def test_prologue_kernel_matches_plain(card, h, d, strided, qk_norm, norm_scope):
    b, s = 2, 37  # S not a multiple of 16: the TPU's gate, not the card's
    dim, dt = h * d, torch.bfloat16
    g = torch.Generator(device=card).manual_seed(5)
    if strided:  # column slices of one fused qkv product, read in place
        q, k, v = _randn(g, (b, s, 3 * dim), dt, 3.0).split(dim, dim=-1)
    else:
        q, k, v = (_randn(g, (b, s, dim), dt, 3.0) for _ in range(3))
    gq, gk = (1 + 0.1 * torch.randn(dim, generator=g, device=card) for _ in range(2))
    ang = torch.rand((s, d // 2), generator=g, device=card) * 6.28
    cos, sin = ang.cos(), ang.sin()
    kw = dict(num_heads=h, eps=1e-6, qk_norm=qk_norm, norm_scope=norm_scope)
    _build.reset_launches()
    got = fused_qk_prologue(q, k, v, gq, gk, cos, sin, **kw)
    assert _build.launches["prologue"] == 1
    want = _prologue_ref(q, k, v, gq, gk, cos, sin, **kw)
    for a, w in zip(got[:2], want[:2]):
        assert a.shape == (b, h, s, d) and a.dtype == dt
        _close(a, w)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])  # v is only moved


def test_norm_and_prologue_kernels_take_bf16_only(card):
    x = torch.zeros((1, 4, 256), device=card)
    with pytest.raises(NotImplementedError, match="dtype"):
        fused_norm(x, None, None, None, None, False, 1e-6, False)
    cs = torch.zeros((4, 64), device=card)
    with pytest.raises(NotImplementedError, match="dtype"):
        fused_qk_prologue(x, x, x, None, None, cs, cs, num_heads=2)


# --- the model on the card ------------------------------------------------------

def test_wan_forward_on_card_matches_cpu(card):
    """A 2-block model at head dim 128: the card (bf16, kernels) against the
    CPU (f32, plain versions) from the same weights, and one launch of each
    kernel where the model calls it.  bf16 activations through 2 blocks:
    rel L2 below 0.05."""
    from vorta_tpu_torch.config import WAN_TINY, AttentionConfig
    from vorta_tpu_torch.models.wan import WanModel

    cfg = dataclasses.replace(WAN_TINY, dim=512, ffn_dim=1024, num_heads=4, head_dim=128,
                              text_dim=64, text_len=16, freq_dim=64)
    attn = AttentionConfig(latent_shape=(4, 8, 8), block_q=64, block_kv=64)
    cpu = WanModel(cfg, dtype=torch.float32, device="cpu", seed=1)
    gpu = WanModel(cfg, dtype=torch.bfloat16, device=card, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(6)
    lat = torch.randn((1, 4, 16, 16, 16), generator=gen)
    ctx = torch.randn((1, 16, 64), generator=gen)
    t = torch.tensor([600.0])
    _build.reset_launches()
    with torch.inference_mode():
        got = gpu(lat.to(card), t.to(card), ctx.to(card), attn_cfg=attn).sample.float().cpu()
        launches = dict(_build.launches)
        want = cpu(lat, t, ctx, attn_cfg=attn).sample
    layers = cfg.num_layers
    assert launches == {**dict.fromkeys(_build.KERNELS, 0), "flash": 2 * layers,
                        "fused_norm": 2 * layers + 1, "prologue": layers}
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 0.05


def test_cli_samples_on_card(card, tmp_path):
    from vorta_tpu_torch.cli.sample import main

    out = tmp_path / "tiny.npy"
    res = main(["--model", "wan-tiny", "--native_attention", "--random_embeds",
                "--num_frames", "13", "--height", "64", "--width", "64",
                "--num_inference_steps", "2", "--output", str(out)])
    arr = np.load(out)
    assert arr.shape == (1, 4, 8, 8, 16) and np.isfinite(arr).all()
    assert res.latents.device.type == "cuda"


def test_routed_forward_on_card_matches_cpu(card):
    """Hard routing on the card (bf16, kernels) against the CPU (f32, plain
    versions): routers set to one-hot logits so the heads go to all three
    experts; each expert is launched once per block, the pool/unpool pair
    with LOWRES.  rel L2 below 0.05 (bf16 activations through 2 blocks)."""
    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_TINY
    from vorta_tpu_torch.models.wan import WanModel

    cfg = dataclasses.replace(WAN_TINY, dim=512, ffn_dim=1024, num_heads=4, head_dim=128,
                              text_dim=64, text_len=16, freq_dim=64)
    attn = attention_config("wan-tiny", (4, 8, 8))
    cpu = WanModel(cfg, dtype=torch.float32, device="cpu", seed=2)
    with torch.no_grad():
        for block in cpu.blocks:
            block.router.linear.weight.zero_()
            block.router.linear.bias.copy_(torch.eye(3)[[0, 1, 2, 2]].reshape(-1) * 4.0)
    gpu = WanModel(cfg, dtype=torch.bfloat16, device=card, seed=2)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(7)
    lat = torch.randn((1, 4, 16, 16, 16), generator=gen)
    ctx = torch.randn((1, 16, 64), generator=gen)
    t = torch.tensor([600.0])
    _build.reset_launches()
    with torch.inference_mode():
        res = gpu(lat.to(card), t.to(card), ctx.to(card), attn_cfg=attn, routing_mode="hard")
        got = res.sample.float().cpu()
        launches = dict(_build.launches)
        want = cpu(lat, t, ctx, attn_cfg=attn, routing_mode="hard").sample
    n = cfg.num_layers
    assert (res.expert_ids == np.array([0, 1, 2, 2])).all()
    assert launches == {"flash": n, "fused_norm": 2 * n + 1, "prologue": n,
                        "flash_manual": 2 * n, "sta_pipe": n, "pool_qkv": n, "unpool": n}
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 0.05


def test_cli_routes_on_card(card, tmp_path):
    from vorta_tpu_torch.cli.sample import main

    out = tmp_path / "tiny_routed.npy"
    res = main(["--model", "wan-tiny", "--random_embeds", "--num_frames", "13",
                "--height", "64", "--width", "64", "--num_inference_steps", "2",
                "--output", str(out)])
    assert np.load(out).shape == (1, 4, 8, 8, 16) and np.isfinite(np.load(out)).all()
    assert len(res.routing) == 4 and res.latents.device.type == "cuda"
