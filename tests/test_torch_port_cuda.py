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
the STA fallbacks (sta_batched on joint layouts with pair bits and kv_bias,
blocks 40 / 48 and 432 / 1008; sta_window and sta_row with and without the
text tail, tile_w 8-aligned or not, more w tiles than a CUDA block takes;
1 + 1-block Hunyuan and 2-block Wan forwards against the CPU where the
gates pick them), pool/unpool with inactive heads and in head-map mode
(the routed heads against the plain version, head-map launches counted
apart), the copy probe of tools/bench_pool.py, the routed dispatch under
each of the JAX package's dispatch variables (batched, hybrid, switch)
against the CPU with exact launch counts, and that the options each wrapper leaves
to later slices raise; for HunyuanVideo, flash_manual's kv_bias (with and
without kv_valid_len, the joint experts' blocks), sta_pipe's text tail
(active and inactive heads, 24 and 256 text keys, 432-token tiles), the
pool's K matching, a 1 + 1-block model off and routed and the tiny CLI;
for training, the forward's lse, the dq and dk/dv kernels (1, 2 and 4
warps, tails, empty q blocks, blocks of 8 x odd: 360 and 24), the autograd rules of
the attention and the norm, the grad guards of the forward-only wrappers,
a train step against the CPU and the trainer CLI; for quantized serving,
flash_manual's and sta_pipe's int8 QK modes (D 64 / 128, bias, tail, text
tail, inactive heads) on the same int8 inputs as their plain versions,
W8A8 ``int8_linear`` at odd shapes (int32 sums exact: within one bf16 ulp
of the plain version), 2-block models with ``qk_int8`` + ``mm int8`` and
from a quantized stack against the CPU, and the CLIs' four quantization
flags; and (PR 8) the stable softmax of flash_manual, sta_pipe and
sta_batched, sta_pipe's dots / qk / sT variants at every tile-width class
with and without the text tail (each mode's launches counted apart),
fused_residual_norm (x_new bitwise, y, the gradients through its Function)
and its refusals, the five sta_diag variants (dma_only all zeros, no_dma
launched only) and the sta_diag tool's launches; and the Hopper
path of flash and flash_manual (csrc/attn_sm90.cuh: wgmma, the TMA ring):
its probe (one tile's two products against torch.matmul), count-0 rows
beside full ones, per-head and shared tables, kv_valid_len tails inside a
128-key sub-tile and on its edge, kv_bias with -1e30 columns, batch 2, the
lse sentinel, blocks 2048 x 512 and 256 x 1024, the backward kernels fed
the new forward's lse, and which launches take the path; the backward's
Hopper kernels against the plain version and the mma.sync kernels at
blocks 128 / 1024 / 2048 x 512, kv tails inside a 128-key slot, kv tiles
wholly past the tail, a kv block no q block visits and an empty q block
(exact zeros), need_dq / need_dkv alone (bit for bit), and the rule's
split on the card; the prologue's warp-per-row kernel against its plain
version and the block-per-row kernel (strided slices, head scope, qk_norm
off, rows no CTA divides, many rows a warp, the 14B width, its normalised
values within one bf16 ulp, a layout the C entry refuses) and sta_row's
Hopper path against its plain version and its mma.sync kernel (with and
without the text tail, inactive heads, full width, a shape the C entry
refuses); the sta_diag bisection kernel's Hopper path (full, full_unroll,
dots_only against the plain version and the mma.sync kernel, dma_only all
zeros, no_dma twice and then full still right, a shape the C entry
refuses, the tool's launches on sta_diag_wgmma) and unpool's batched
16-byte copy (bit for bit against the plain version and the first
design's kernel in both modes, D 64 and 128, groups of 1, 12 and 32 slots,
U = 0 and group size - 1, counted as unpool_rows); and (no kernel: cuBLAS
/ cuDNN products) the VAEs' chunked causal conv and GroupNorm
statistics over tensors of more than 2^31 elements against references
computed in pieces, the text encoders at 2 layers and the tiny VAEs
(whole, chunked, tiled) against the CPU, and cli.sample --prompt --decode
on the card; and the f32 modes of sta_window and sta_row (tile_w 8 and 10,
360-token tiles, text tails of 24 and 88 keys, D 64 / 128) and the int8 QK
modes of flash_manual and sta_pipe with an f32 v (int8 text keys, kv_bias,
tails, 64-row parts of 32 rows), each on the same inputs as its plain
version, with the mixes they refuse; and the f32 modes' tensor-core core of
flash and flash_manual (3xTF32 on wgmma: its probe against f64 products,
kv tails inside and on the edge of a 64-key chunk, count-0 q blocks, per-head
tables, the lse, kv_bias with kv_valid_len, either softmax, a head routed
away, beside the FFMA core at the same call, and the shapes its C entry
refuses), and the f32 window walks of sta_window and sta_pipe on the
tensor cores (tiles of 48, 96, 360 and 432 tokens, clamped edges, nt <
win_t, text tails of 8, 24 and 256 keys, either softmax, batch 2, a head
routed away, beside the FFMA core at the same call, and what their C
entries refuse).  Tolerances: 1e-5 x max
|plain| for f32 outputs (the two sides sum in different orders); for bf16
outputs, element by element, 2^-5 x max(|plain|, RMS(plain)), i.e. 4 to 8
bf16 ulps at the element's magnitude (an output rounding, and P rounded to
bf16 inside flash, can differ between the two sides).
"""

import ctypes
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
    f32_tc_path,
    sm90_probe,
    sparse_flash_attention_raw,
    sparse_flash_attention_ref,
    tables_from_block_mask,
)
from vorta_tpu_torch.ops.flash_manual import (
    sparse_flash_attention_manual,
    sparse_flash_attention_manual_ref,
)
from vorta_tpu_torch.ops.fused_norm import _norm_ref, fused_norm, norm_layout
from vorta_tpu_torch.ops.prologue import _prologue_ref, fused_qk_prologue
from vorta_tpu_torch.ops.sta_pipe import (
    sta_pipe_attention,
    sta_pipe_attention_mma_sync,
    sta_pipe_attention_ref,
    sta_wgmma_path,
)

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
    q = torch.zeros((1, 1, 64, 128), device=card, dtype=torch.float16)
    ki, kc = dense_tables(1, 1).on(card)
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        sparse_flash_attention_raw(q, q, q, ki, kc, block_q=64, block_kv=64)
    with pytest.raises(NotImplementedError, match="bf16 or f32"):  # f16 with the lse too
        sparse_flash_attention_raw(q, q, q, ki, kc, block_q=64, block_kv=64, return_lse=True)
    qb = torch.zeros((1, 1, 64, 96), device=card, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="D 64/128"):
        sparse_flash_attention_raw(qb, qb, qb, ki, kc, block_q=64, block_kv=64)


# --- flash_manual (routed FULL / LOWRES experts) -----------------------------------

@pytest.mark.parametrize("softmax", ["fast", "stable"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,block,seq,valid", [
    ("dense", 32, 128, 100),      # small blocks, one warp per CUDA block
    ("dense", 1024, 2048, 1500),  # the experts' blocks, tail mid-block
    ("shared", 64, 256, 250),
    ("per_head", 32, 256, None),  # per-head index tables and counts
])
def test_flash_manual_kernel_matches_plain(card, d, kind, block, seq, valid, softmax):
    """Head-shared index tables with per-head counts (some heads routed
    away: count 0 writes zeros), as the routed experts launch it; the fast
    softmax and the stable one."""
    b, h = 2, 3
    g = torch.Generator(device=card).manual_seed(10)
    # unit-RMS q/k, as the qk-normed model feeds the fast softmax
    q, k, v = (_randn(g, (b, h, seq, d), torch.bfloat16) for _ in range(3))
    ki, kc = _tables(kind, h, seq // block, seq // block).on(card)
    if kind != "per_head":  # per-head counts over the shared index table
        kc = torch.where(torch.tensor([True, False, True], device=card)[:, None], kc, 0)
    kw = dict(block_q=block, block_kv=block, kv_valid_len=valid, scale=1.1 * d**-0.5,
              softmax=softmax)
    _build.reset_launches()
    got = sparse_flash_attention_manual(q, k, v, ki, kc, **kw)
    assert _build.launches["flash_manual"] == 1
    assert _build.launches["flash_manual_stable"] == (softmax == "stable")
    _close(got, sparse_flash_attention_manual_ref(q, k, v, ki, kc, **kw))
    if kind != "per_head":
        assert not got[:, 1].any()  # the head routed away


def test_flash_manual_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 64, 128), device=card, dtype=torch.bfloat16)
    ki, kc = dense_tables(1, 1).on(card)
    kw = dict(block_q=64, block_kv=64)
    for bad in (dict(kv_valid=torch.ones(2)), dict(pair_bits=ki),
                dict(cast_p_to_v_dtype=False)):
        with pytest.raises(NotImplementedError, match="item 11"):
            sparse_flash_attention_manual(q, q, q, ki, kc, **kw, **bad)
    # the stable softmax is served, with kv_bias too
    g = torch.Generator(device=card).manual_seed(12)
    qs, ks, vs = (_randn(g, (1, 2, 64, 128), torch.bfloat16) for _ in range(3))
    bias = torch.where(torch.arange(64, device=card) % 5 == 0, -1e30, 0.5)[None]
    for extra in ({}, dict(kv_bias=bias)):
        skw = dict(softmax="stable", kv_valid_len=50, **kw, **extra)
        _close(sparse_flash_attention_manual(qs, ks, vs, ki, kc, **skw),
               sparse_flash_attention_manual_ref(qs, ks, vs, ki, kc, **skw))
    # the int8 mode is served: int8 q / k, bf16 v
    qk_scale = torch.ones(2, device=card)
    with pytest.raises(ValueError, match="int8"):
        sparse_flash_attention_manual(q, q, q, ki, kc, qk_scale=qk_scale, softmax="fast", **kw)
    # int8 QK with an f32 v is served: the f32 core's int8 mode, against its plain version
    q8, k8, qk2 = _int8_qk(card, g, (1, 2, 64, 128))
    vf = torch.randn((1, 2, 64, 128), generator=g, device=card)
    ikw = dict(qk_scale=qk2, softmax="fast", kv_valid_len=50, **kw)
    _build.reset_launches()
    got = sparse_flash_attention_manual(q8, k8, vf, ki, kc, **ikw)
    assert (_build.launches["flash_manual_f32"], _build.launches["flash_manual_int8"]) == (1, 1)
    _close(got, sparse_flash_attention_manual_ref(q8, k8, vf, ki, kc, **ikw))
    with pytest.raises(ValueError, match="int8"):  # int8 q with a non-int8 k
        sparse_flash_attention_manual(q8, q, vf, ki, kc, qk_scale=qk_scale, softmax="fast", **kw)
    with pytest.raises(NotImplementedError, match="f32"):  # int8 q / k, a v of neither mode
        sparse_flash_attention_manual(q8, k8, vf.half(), ki, kc, qk_scale=qk_scale,
                                      softmax="fast", **kw)
    with pytest.raises(ValueError, match="kv_bias"):
        sparse_flash_attention_manual(q, q, q, ki, kc, kv_bias=torch.zeros((1, 32), device=card),
                                      **kw)
    with pytest.raises(NotImplementedError, match="bf16"):
        sparse_flash_attention_manual(q.half(), q.half(), q.half(), ki, kc, **kw)


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
    with pytest.raises(NotImplementedError, match="item 11"):
        sta_pipe_attention(q, q, q, act, cast_p_to_v_dtype=False, **kw)
    # the stable softmax and the sT variant are served
    g = torch.Generator(device=card).manual_seed(13)
    qs, ks, vs = (_randn(g, q.shape, torch.bfloat16) for _ in range(3))
    for extra in (dict(softmax="stable"), dict(variant="sT")):
        _close(sta_pipe_attention(qs, ks, vs, act, **kw, **extra),
               sta_pipe_attention_ref(qs, ks, vs, act, **kw, **extra))
    # the int8 mode is served: int8 q / k / text_k, bf16 v
    qk_scale = torch.ones(2, device=card)
    with pytest.raises(ValueError, match="int8"):
        sta_pipe_attention(q, q, q, act, qk_scale=qk_scale, **kw)
    # int8 QK with an f32 v is served: int8 text keys, an f32 text_v
    q8, k8, qk2 = _int8_qk(card, g, q.shape)
    vf = torch.randn(q.shape, generator=g, device=card)
    t8 = k8[:, :, :24].contiguous()
    tv = torch.randn((1, 2, 24, 128), generator=g, device=card)
    ikw = dict(qk_scale=qk2, text_k=t8, text_v=tv, **kw)
    _build.reset_launches()
    got = sta_pipe_attention(q8, k8, vf, act, **ikw)
    assert (_build.launches["sta_pipe_f32"], _build.launches["sta_pipe_int8"]) == (1, 1)
    _close(got, sta_pipe_attention_ref(q8, k8, vf, act, **ikw))
    with pytest.raises(ValueError, match="int8"):  # int8 q with a non-int8 k
        sta_pipe_attention(q8, q, vf, act, qk_scale=qk2, **kw)
    with pytest.raises(ValueError, match="text_v"):  # int8 text_k, text_v missing
        sta_pipe_attention(q8, k8, vf, act, qk_scale=qk2, text_k=t8, **kw)
    with pytest.raises(NotImplementedError, match="f32"):  # a bf16 text_v beside an f32 v
        sta_pipe_attention(q8, k8, vf, act, **{**ikw, "text_v": tv.bfloat16()})
    with pytest.raises(NotImplementedError, match="bf16"):  # an f32 text_v beside a bf16 v
        sta_pipe_attention(q8, k8, q, act, **ikw)
    with pytest.raises(ValueError, match="multiple of 8"):
        sta_pipe_attention(q, q, q, act, text_k=q[:, :, :12], text_v=q[:, :, :12], **kw)
    with pytest.raises(NotImplementedError, match="bf16"):
        sta_pipe_attention(q.half(), q.half(), q.half(), act, **kw)


@pytest.mark.parametrize("softmax,variant", [
    ("stable", "full"), ("fast", "dots"), ("fast", "qk"), ("fast", "sT"), ("stable", "sT"),
    ("stable", "qk"),
])
@pytest.mark.parametrize("latent,tile,text_len", [
    ((8, 6, 32), (2, 3, 8), 0),     # tw % 8 == 0: the variant runs
    ((8, 6, 32), (2, 3, 8), 24),    # with the text tail (fast or stable by the softmax)
    ((8, 6, 20), (2, 3, 4), 16),    # tw | 8: the softmax runs whatever the variant
    ((4, 18, 16), (2, 9, 8), 0),    # 144-token tiles (4 warps, a ragged CUDA block)
])
def test_sta_kernel_modes_match_plain(card, latent, tile, text_len, softmax, variant):
    """The stable softmax and the diagnostic variants, each counted apart."""
    b, h, d = 2, 3, 128
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(15)
    q, k, v = (_randn(g, (b, h, s, d), torch.bfloat16) for _ in range(3))
    active = torch.tensor([1, 0, 1], device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, scale=1.1 * d**-0.5, softmax=softmax,
              variant=variant)
    if text_len:
        kw.update(text_k=_randn(g, (b, h, text_len, d), torch.bfloat16),
                  text_v=_randn(g, (b, h, text_len, d), torch.bfloat16),
                  text_bias=torch.where(torch.arange(text_len, device=card) < 9, 0.0, -1e30)[None])
    _build.reset_launches()
    got = sta_pipe_attention(q, k, v, active, **kw)
    ran = variant if tile[2] % 8 == 0 and variant != "full" else None
    assert _build.launches["sta_pipe"] == 1
    assert _build.launches["sta_pipe_stable"] == (softmax == "stable")
    assert all(_build.launches[f"sta_pipe_{x}"] == (x == ran) for x in ("dots", "qk", "sT"))
    _close(got, sta_pipe_attention_ref(q, k, v, active, **kw))
    assert not got[:, 1].any()


# --- the fused residual norm and the STA bisection tool --------------------------------

@pytest.mark.parametrize("b,s,dim", [(2, 100, 1536), (1, 300, 3072), (1, 7, 128)])
@pytest.mark.parametrize("gate,mod,affine", [
    (True, True, False), (False, False, True), (True, True, True), (False, False, False),
])
def test_fused_residual_norm_kernel_matches_plain(card, b, s, dim, gate, mod, affine):
    """x_new bitwise (one rounding of the f32 residual on both sides), y
    within the bf16 tolerance; then the gradients through the Function."""
    from vorta_tpu_torch.ops.fused_norm import _res_norm_ref, fused_residual_norm

    g = torch.Generator(device=card).manual_seed(16)
    x, dl = (_randn(g, (b, s, dim), torch.bfloat16) for _ in range(2))
    f32 = torch.float32
    gt = _randn(g, (b, dim), f32, 0.3) if gate else None
    sc, sh = (_randn(g, (b, dim), f32, 0.2) if mod else None for _ in range(2))
    ga, be = (1 + _randn(g, (dim,), f32, 0.1), _randn(g, (dim,), f32, 0.1)) if affine else (None,
                                                                                           None)
    args = (x, dl, gt, sc, sh, ga, be, 1e-6)
    _build.reset_launches()
    with torch.no_grad():
        xn, y = fused_residual_norm(*args)
    assert _build.launches["fused_residual_norm"] == 1
    xr, yr = _res_norm_ref(*args)
    assert torch.equal(xn, xr)
    _close(y, yr)
    leaves = [t.clone().requires_grad_() if t is not None else None for t in args[:7]]
    xn, y = fused_residual_norm(*leaves, 1e-6)
    w = _randn(g, y.shape, torch.bfloat16)
    ((xn.float() * w.float()).sum() + (y.float() * w.float()).sum()).backward()
    ref_leaves = [t.detach().clone().requires_grad_() if t is not None else None
                  for t in args[:7]]
    xr, yr = _res_norm_ref(*ref_leaves, 1e-6)
    ((xr.float() * w.float()).sum() + (yr.float() * w.float()).sum()).backward()
    for a, r in zip(leaves, ref_leaves):
        if a is not None:
            got, want = a.grad.float(), r.grad.float()
            assert (got - want).norm() <= 1e-2 * want.norm()


def test_fused_residual_norm_kernel_rejects_what_it_does_not_take(card):
    from vorta_tpu_torch.ops.fused_norm import fused_residual_norm

    x = torch.zeros((1, 4, 128), device=card)
    with pytest.raises(NotImplementedError, match="dtype"):
        fused_residual_norm(x, x, None, None, None, None, None, 1e-6)
    xb = torch.zeros((1, 4, 16384), device=card, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="12288"):
        fused_residual_norm(xb, xb, None, None, None, None, None, 1e-6)
    xb = xb[..., :128]
    with pytest.raises(NotImplementedError, match="delta"):
        fused_residual_norm(xb, xb.float(), None, None, None, None, None, 1e-6)
    with pytest.raises(ValueError, match="together"):
        fused_residual_norm(xb, xb, None, torch.zeros((1, 128), device=card), None, None, None,
                            1e-6)


@pytest.mark.parametrize("variant", ["full", "full_unroll", "dots_only", "dma_only", "no_dma"])
@pytest.mark.parametrize("latent,tile,d", [
    ((4, 6, 16), (2, 3, 8), 64),      # one chunk per chain, whole-axis windows
    ((8, 18, 32), (4, 9, 8), 128),    # 144-row tiles: a ragged 128-row CUDA block
    ((10, 18, 40), (5, 9, 8), 128),   # the tool's tile, clamped windows, 17 sub-tiles a chunk
])
def test_sta_diag_kernel_matches_plain(card, latent, tile, d, variant):
    from vorta_tpu_torch.tools.sta_diag import sta_diag_attention, sta_diag_ref

    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(17)
    q, k, v = (_randn(g, (2, 2, s, d), torch.bfloat16) for _ in range(3))
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), variant=variant)
    _build.reset_launches()
    got = sta_diag_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _build.launches["sta_diag"] == 1
    assert _build.launches["sta_diag_wgmma"] == int(d == 128)  # the rule's split
    if variant == "dma_only":
        assert not got.any()
    elif variant != "no_dma":  # no_dma's output is undefined
        _close(got, sta_diag_ref(q, k, v, **kw))


def test_sta_diag_tool_times_every_variant(card):
    from vorta_tpu_torch.tools import sta_diag

    _build.reset_launches()
    times = sta_diag.main(["--latent", "10", "18", "40", "--iters", "2", *sta_diag.VARIANTS])
    assert set(times) == set(sta_diag.VARIANTS) and all(t > 0 for t in times.values())
    assert _build.launches["sta_diag"] == 4 * len(sta_diag.VARIANTS)  # warm-up + timed
    assert _build.launches["sta_diag_wgmma"] == 4 * len(sta_diag.VARIANTS)  # all on Hopper


@pytest.mark.parametrize("latent,tile", [
    ((6, 6, 40), (2, 3, 8)),      # chunks of two slots, the second holding one run
    ((10, 18, 40), (5, 9, 8)),    # the tool's tile, clamped windows, 9 slots a chunk
    ((8, 18, 48), (2, 9, 16)),    # runs of 48, two a slot: 9 slots of 96 keys a chunk
    ((4, 6, 16), (2, 3, 8)),      # one slot a chunk, whole-axis windows
])
def test_sta_diag_hopper_path_matches_plain_and_mma_sync(card, latent, tile):
    """The Hopper path (tools/sta_diag.py:diag_wgmma_path) of full,
    full_unroll and dots_only against the plain version and the mma.sync
    kernel on the same inputs (every head attends: the tool has no routing);
    dma_only all zeros; no_dma run twice, then full still right (the
    producer drains every copy: no launch inherits one in flight)."""
    from vorta_tpu_torch.tools.sta_diag import (
        diag_wgmma_path,
        sta_diag_attention,
        sta_diag_attention_mma_sync,
        sta_diag_ref,
    )

    assert diag_wgmma_path(128, latent, tile)
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(18)
    q, k, v = (_randn(g, (2, 3, s, 128), torch.bfloat16) for _ in range(3))
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3))
    for variant in ("full", "full_unroll", "dots_only"):
        _build.reset_launches()
        got = sta_diag_attention(q, k, v, variant=variant, **kw)
        torch.cuda.synchronize()
        assert (_build.launches["sta_diag"], _build.launches["sta_diag_wgmma"]) == (1, 1)
        _close(got, sta_diag_ref(q, k, v, variant=variant, **kw))
        _close(got, sta_diag_attention_mma_sync(q, k, v, variant=variant, **kw))
        assert _build.launches["sta_diag_wgmma"] == 1  # the yardstick: mma.sync
    assert not sta_diag_attention(q, k, v, variant="dma_only", **kw).any()
    for _ in range(2):
        sta_diag_attention(q, k, v, variant="no_dma", **kw)
    torch.cuda.synchronize()
    _close(sta_diag_attention(q, k, v, variant="full", **kw),
           sta_diag_ref(q, k, v, variant="full", **kw))


def test_sta_diag_hopper_entry_refuses_what_its_rule_refuses(card):
    """The C entry mirrors diag_wgmma_path: D = 64 on the Hopper path, or a
    box that leaves its chunk, is an error, never a fallback."""
    from vorta_tpu_torch.tools import sta_diag

    latent, tile, window = (4, 6, 16), (2, 3, 8), (3, 3, 3)
    walk = sta_diag._walk_on(latent, tile, window, card)
    q = torch.zeros((1, 1, int(np.prod(latent)), 64), device=card, dtype=torch.bfloat16)
    fn = sta_diag._diag_fn()
    stream = _build.stream_ptr(card)
    for d, box in ((64, (16, 1)), (128, (16, 2))):  # D 64; box_h 2 does not divide th = 3
        x = q if d == 64 else torch.zeros((1, 1, q.shape[2], 128), device=card,
                                          dtype=torch.bfloat16)
        err = fn(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), 0.1, 0, 1, 1, *latent,
                 d, *tile, *window, walk.data_ptr(), walk.shape[0], *box, 1, stream)
        assert err != 0


# --- the STA fallbacks: sta_batched, sta_window, sta_row -------------------------------

def _joint_sta_case(latent, tile, text_len, card, valid=17, lowres_window=(2, 2, 2)):
    """The joint layout's sta_batched inputs: tables, pair bits, the bias of
    ``valid`` text tokens."""
    from vorta_tpu_torch.config import AttentionConfig
    from vorta_tpu_torch.ops import joint_experts as joint

    jcfg = joint.JointConfig(AttentionConfig(latent_shape=latent, sta_tile=tile,
                                             lowres_window=lowres_window), text_len)
    lay = joint.joint_layouts(jcfg)["sta"]
    mask = (torch.arange(text_len) < valid)[None]
    bias = joint._bias(mask, lay, jcfg.video.seq_len).to(card)
    return lay, joint._joint_sta_tables(jcfg).on(card), bias, jcfg.video.tokens_per_tile


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("latent,tile,text_len", [
    ((4, 4, 8), (2, 2, 2), 24),     # 8-token tiles: blocks 40 / 48 (not multiples of 16)
    ((4, 18, 16), (2, 9, 8), 24),   # HunyuanVideo's (2, 9, 8): blocks 432 / 1008
    ((4, 6, 16), (2, 3, 8), 20),    # 48-token tiles, text length not a multiple of 8
])
@pytest.mark.parametrize("softmax", ["fast", "stable"])
def test_sta_batched_kernel_matches_plain(card, d, latent, tile, text_len, softmax):
    """The joint layout: pair bits (all-ones text blocks), kv bias, heads 1
    routed away; and the same tables without bits or bias; both softmaxes."""
    from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched, sta_flash_headbatched_ref

    lay, (ki, kc, bits), bias, tpt = _joint_sta_case(latent, tile, text_len, card)
    g = torch.Generator(device=card).manual_seed(31)
    q, k, v = (_randn(g, (2, 3, lay.total, d), torch.bfloat16) for _ in range(3))
    active = torch.tensor([1, 0, 1], device=card, dtype=torch.int32)
    for extra in (dict(pair_bits=bits, tokens_per_tile=tpt, kv_bias=bias), {}):
        kw = dict(block_q=lay.block_q, block_kv=lay.block_kv, scale=1.1 * d**-0.5,
                  softmax=softmax, **extra)
        _build.reset_launches()
        got = sta_flash_headbatched(q, k, v, ki, kc, active, **kw)
        assert _build.launches["sta_batched"] == 1
        assert _build.launches["sta_batched_stable"] == (softmax == "stable")
        _close(got, sta_flash_headbatched_ref(q, k, v, ki, kc, active, **kw))
        assert not got[:, 1].any()


def test_sta_batched_kernel_rejects_what_it_does_not_take(card):
    from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched

    lay, (ki, kc, bits), bias, tpt = _joint_sta_case((4, 4, 8), (2, 2, 2), 24, card)
    q = torch.zeros((1, 2, lay.total, 128), device=card, dtype=torch.bfloat16)
    act = torch.ones(2, device=card, dtype=torch.int32)
    kw = dict(block_q=lay.block_q, block_kv=lay.block_kv, pair_bits=bits, tokens_per_tile=tpt)
    with pytest.raises(NotImplementedError, match="item 11"):
        sta_flash_headbatched(q, q, q, ki, kc, act, cast_p_to_v_dtype=False, **kw)
    # the stable softmax is served
    from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched_ref

    g = torch.Generator(device=card).manual_seed(14)
    qs, ks, vs = (_randn(g, q.shape, torch.bfloat16) for _ in range(3))
    _close(sta_flash_headbatched(qs, ks, vs, ki, kc, act, softmax="stable", kv_bias=bias, **kw),
           sta_flash_headbatched_ref(qs, ks, vs, ki, kc, act, softmax="stable", kv_bias=bias,
                                     **kw))
    with pytest.raises(NotImplementedError, match="bf16"):
        sta_flash_headbatched(q.half(), q.half(), q.half(), ki, kc, act, **kw)
    with pytest.raises(NotImplementedError, match="D 64/128"):
        sta_flash_headbatched(q[..., :32], q[..., :32], q[..., :32], ki, kc, act, **kw)
    with pytest.raises(ValueError, match="tokens_per_tile"):
        sta_flash_headbatched(q, q, q, ki, kc, act, **{**kw, "tokens_per_tile": None})
    with pytest.raises(ValueError, match="32 bits"):
        sta_flash_headbatched(q, q, q, ki, kc, act, **{**kw, "tokens_per_tile": 4})
    with pytest.raises(ValueError, match="head-shared"):
        sta_flash_headbatched(q, q, q, ki.expand(2, -1, -1), kc.expand(2, -1), act, **kw)
    blocks = dict(block_q=20, block_kv=20)  # not multiples of 8
    q20 = q[:, :, :240]
    ki20, kc20 = dense_tables(12, 12).on(card)
    with pytest.raises(NotImplementedError, match="multiples of 8"):
        sta_flash_headbatched(q20, q20, q20, ki20, kc20, act, **blocks)


WINDOW_CASES = [  # (latent, tile): tile_w 8-aligned, 10 (misaligned), 4; clamping on every axis
    ((4, 6, 32), (2, 3, 8)),
    ((6, 4, 30), (2, 2, 10)),
    ((12, 18, 20), (4, 6, 4)),
    ((4, 9, 80), (4, 9, 10)),
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("text", [False, True])
@pytest.mark.parametrize("latent,tile", WINDOW_CASES)
def test_sta_window_kernel_matches_plain(card, d, latent, tile, text):
    """Stable softmax over the clamped window, with and without the text
    tail (24 keys, 17 valid), head 1 routed away."""
    from vorta_tpu_torch.ops.sta_window import sta_window_attention, sta_window_attention_ref

    _check_window_dense(card, d, latent, tile, text, "sta_window", sta_window_attention,
                        sta_window_attention_ref)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("text", [False, True])
@pytest.mark.parametrize("latent,tile", [
    ((4, 6, 32), (2, 3, 8)),    # 4 w tiles in one CUDA block
    ((4, 6, 80), (2, 3, 8)),    # 10 w tiles: two groups of 5
    ((8, 6, 16), (2, 3, 16)),   # tile_w 16, 1 w tile per row
    ((4, 4, 8), (2, 2, 8)),     # 1 w tile, the window spans every axis
])
def test_sta_row_kernel_matches_plain(card, d, latent, tile, text):
    from vorta_tpu_torch.ops.sta_row import sta_row_attention, sta_row_attention_ref

    _check_window_dense(card, d, latent, tile, text, "sta_row", sta_row_attention,
                        sta_row_attention_ref)


def _check_window_dense(card, d, latent, tile, text, name, kernel, plain):
    b, h, lt = 2, 3, 24
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(32)
    q, k, v = (_randn(g, (b, h, s, d), torch.bfloat16) for _ in range(3))
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=1.1 * d**-0.5)
    if text:
        kw.update(text_k=_randn(g, (b, h, lt, d), torch.bfloat16),
                  text_v=_randn(g, (b, h, lt, d), torch.bfloat16),
                  text_bias=torch.where(torch.arange(lt, device=card) < 17, 0.0, -1e30)[None])
    active = torch.tensor([1, 0, 1], device=card, dtype=torch.int32)
    _build.reset_launches()
    got = kernel(q, k, v, active, **kw)
    assert _build.launches[name] == 1
    _close(got, plain(q, k, v, active, **kw))
    assert not got[:, 1].any()


def test_sta_window_and_row_kernels_reject_what_they_do_not_take(card):
    from vorta_tpu_torch.ops.sta_row import sta_row_attention
    from vorta_tpu_torch.ops.sta_window import sta_window_attention

    q = torch.zeros((1, 2, 4 * 6 * 16, 128), device=card, dtype=torch.bfloat16)
    kw = dict(latent_shape=(4, 6, 16), tile=(2, 3, 8))
    act = torch.ones(2, device=card, dtype=torch.int32)
    for fn in (sta_window_attention, sta_row_attention):
        with pytest.raises(NotImplementedError, match="bf16 or f32"):
            fn(q.half(), q.half(), q.half(), act, **kw)
        with pytest.raises(NotImplementedError, match="one dtype"):
            fn(q.float(), q.float(), q, act, **kw)
        with pytest.raises(NotImplementedError, match="D 64/128"):
            fn(q[..., :32], q[..., :32], q[..., :32], act, **kw)
        with pytest.raises(NotImplementedError):
            fn(q, q, q, act, cast_p_to_v_dtype=False, **kw)
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(q, q, q, act, text_k=q[:, :, :12], text_v=q[:, :, :12], **kw)
        with pytest.raises(ValueError):  # tiles that do not divide the grid
            fn(q, q, q, act, latent_shape=(4, 6, 16), tile=(3, 3, 8))
    with pytest.raises(ValueError, match="row-dense"):  # tile_w not a multiple of 8
        sta_row_attention(q, q, q, act, latent_shape=(4, 6, 16), tile=(2, 3, 4))


@pytest.mark.parametrize("kernel,latent,tile", [
    ("sta_batched", (4, 6, 16), (2, 2, 2)),   # the tiny models' own 8-token tiles
    ("sta_window", (4, 9, 80), (4, 9, 10)),   # 360-token tiles, tile_w 10
])
def test_hunyuan_forward_sta_fallbacks_on_card_matches_cpu(card, kernel, latent, tile):
    """A 1 + 1-block model at head dim 128, routed hard with the heads on
    all three experts, at a geometry where the JAX package's gates pick
    ``kernel`` for the STA heads: the card (bf16, kernels) against the CPU
    (f32, plain versions), rel L2 below 0.05, each kernel launched as the
    dispatch says (sta_batched takes the STA text rows itself)."""
    from vorta_tpu_torch.config import AttentionConfig
    from vorta_tpu_torch.models.hunyuan import HunyuanModel
    from vorta_tpu_torch.ops.joint_experts import JointConfig, joint_sta_kernel

    cfg = _hunyuan_card_cfg()
    attn = AttentionConfig(latent_shape=latent, sta_tile=tile, lowres_window=(2, 3, 2),
                           block_q=32, block_kv=32)
    assert joint_sta_kernel(JointConfig(attn, cfg.text_len), 128, 2) == kernel
    cpu = HunyuanModel(cfg, dtype=torch.float32, device="cpu", seed=5)
    with torch.no_grad():
        for block in cpu.blocks:
            block.router.linear.weight.zero_()
            block.router.linear.bias.copy_(torch.eye(3).reshape(-1) * 4.0)
    gpu = HunyuanModel(cfg, dtype=torch.bfloat16, device=card, seed=5)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(9)
    lat = torch.randn((1, latent[0], 2 * latent[1], 2 * latent[2], 16), generator=gen)
    text = torch.randn((1, 24, 64), generator=gen)
    pooled = torch.randn((1, 32), generator=gen)
    mask = (torch.arange(24) < 17)[None]
    args = (lat, torch.tensor([600.0]), text, mask, pooled)
    kw = dict(guidance=torch.tensor([6000.0]), attn_cfg=attn, routing_mode="hard")
    _build.reset_launches()
    with torch.inference_mode():
        res = gpu(*(x.to(card) for x in args), **{**kw, "guidance": kw["guidance"].to(card)})
        got = res.sample.float().cpu()
        launches = dict(_build.launches)
        want = cpu(*args, **kw).sample
    assert (res.expert_ids == np.array([[0, 1, 2]] * 2)).all()
    text_rows = 2 if kernel == "sta_window" else 0  # flash_manual over the STA text rows
    # sta_window's Hopper path takes (4, 9, 10) (its runs of 30 padded to 32);
    # sta_batched's does not take 8-token tiles
    hopper = {"sta_window_wgmma": 2} if kernel == "sta_window" else {}
    # the LOWRES head pools and unpools in head-map mode, as the JAX package's does
    assert launches == {**dict.fromkeys(_build.KERNELS, 0), "prologue": 2, "fused_norm": 6,
                        "flash_manual": 4 + text_rows, kernel: 2, "pool_qkv_headmap": 2,
                        "unpool_headmap": 2, "unpool_rows": 2, **hopper}
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 0.05


def test_routed_forward_sta_window_on_card_matches_cpu(card):
    """Wan hard routing at tile (4, 9, 10) on a 80-wide grid, where the JAX
    package's gates give the STA heads sta_window: card vs CPU, rel L2 below
    0.05, sta_window launched once per block and sta_pipe never."""
    from vorta_tpu_torch.config import WAN_TINY, AttentionConfig
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops.routed_fused import routed_sta_kernel

    cfg = dataclasses.replace(WAN_TINY, dim=384, ffn_dim=768, num_heads=3, head_dim=128,
                              text_dim=64, text_len=16, freq_dim=64)
    attn = AttentionConfig(latent_shape=(4, 9, 80), sta_tile=(4, 9, 10), lowres_window=(2, 3, 2),
                           block_q=64, block_kv=64)
    assert routed_sta_kernel(attn, 128, 2) == "sta_window"
    cpu = WanModel(cfg, dtype=torch.float32, device="cpu", seed=3)
    with torch.no_grad():
        for block in cpu.blocks:
            block.router.linear.weight.zero_()
            block.router.linear.bias.copy_(torch.eye(3).reshape(-1) * 4.0)
    gpu = WanModel(cfg, dtype=torch.bfloat16, device=card, seed=3)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(8)
    lat = torch.randn((1, 4, 18, 160, 16), generator=gen)
    ctx = torch.randn((1, 16, 64), generator=gen)
    t = torch.tensor([600.0])
    _build.reset_launches()
    with torch.inference_mode():
        res = gpu(lat.to(card), t.to(card), ctx.to(card), attn_cfg=attn, routing_mode="hard")
        got = res.sample.float().cpu()
        launches = dict(_build.launches)
        want = cpu(lat, t, ctx, attn_cfg=attn, routing_mode="hard").sample
    n = cfg.num_layers
    assert (res.expert_ids == np.array([0, 1, 2])).all()
    assert launches == {**dict.fromkeys(_build.KERNELS, 0), "flash": n,
                        "fused_norm": 2 * n + 1, "prologue": n, "flash_manual": 2 * n,
                        "sta_window": n, "sta_window_wgmma": n, "pool_qkv": n, "unpool": n,
                        "unpool_rows": n}
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 0.05


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
    assert _build.launches["unpool_rows"] == 1
    assert torch.equal(up, unpool_ref(out_p, q, groups, active=active, picks=got[3]))
    assert not up[:, 2].any() and not got[0][:, 2].any()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("latent,window,rate", [
    ((4, 6, 16), (2, 3, 2), 0.5),   # the served window, U = 5
    ((4, 6, 16), (2, 3, 2), 0.0),   # U = 11: group size - 1
    ((4, 6, 16), (2, 3, 2), 0.9),   # U = 0: every slot the centre's row
    ((4, 8, 8), (2, 4, 4), 0.5),    # 32 slots: the 16-store (D 128) / 8-store (D 64) kernel
    ((4, 8, 8), (2, 4, 4), 0.0),    # 32 slots, U = 31: as many kept-row loads as stores
    ((4, 4, 8), (2, 2, 2), 0.0),    # 8 slots, U = 7: the 4-store kernel, 4 loads at D 128
    ((2, 3, 4), (1, 1, 1), 0.0),    # 1 slot, U = 0
])
@pytest.mark.parametrize("mode", ["active", "headmap"])
def test_unpool_rows_kernel_matches_plain_and_per_group(card, d, latent, window, rate, mode):
    """unpool's batched 16-byte copy (ops/coreset_pallas.py:unpool_layout)
    bit for bit against the plain version and the first design's kernel
    (unpool_per_group), on the written heads: active mode (inactive heads
    zero) and head-map mode (the mapped heads only), every instantiation
    (stores and kept-row loads a lane) among the cases; random distinct picks,
    never the centre, as the pool gives them; a pooled tensor that starts
    16 bytes into its storage (the wrapper copies it to an aligned one)."""
    from vorta_tpu_torch.ops.coreset import geometry_of
    from vorta_tpu_torch.ops.coreset_pallas import (
        _picks_shape,
        head_map_for,
        unpool_layout,
        unpool_per_group,
    )

    groups = build_lowres_groups(latent, window, rate)
    b, h, u, gs = 2, 3, groups.num_kept_margins, groups.group_size
    assert unpool_layout(d, gs, u) is not None
    cs = geometry_of(groups).center_slot
    rng = np.random.default_rng(19)
    margins = np.array([x for x in range(gs) if x != cs], dtype=np.int32)
    picks = torch.from_numpy(np.stack([rng.permutation(margins)[:u] for _ in
                                       range(b * h * groups.num_groups)]).astype(np.int32))
    picks = picks.reshape(_picks_shape(groups, b, h)).to(card)
    g = torch.Generator(device=card).manual_seed(19)
    flat = _randn(g, (b * h * groups.pooled_length * d + 8,), torch.bfloat16)
    out_p = flat[8:].view(b, h, groups.pooled_length, d)  # 16 bytes into its storage
    q = torch.zeros((b, h, groups.full_length, d), device=card, dtype=torch.bfloat16)
    if mode == "active":
        kw, heads = dict(active=torch.tensor([1, 0, 1], device=card, dtype=torch.int32)), [0, 1, 2]
    else:
        hm, n = head_map_for(torch.tensor([1, 0, 1]))
        kw, heads = dict(head_map=hm.to(card), num_active=n), [0, 2]
    _build.reset_launches()
    got = unpool(out_p, q, groups, picks=picks, **kw)
    torch.cuda.synchronize()
    counter = "unpool" if mode == "active" else "unpool_headmap"
    assert _build.launches == {**dict.fromkeys(_build.KERNELS, 0), counter: 1, "unpool_rows": 1}
    assert torch.equal(got[:, heads], unpool_ref(out_p, q, groups, picks=picks, **kw)[:, heads])
    assert torch.equal(got[:, heads], unpool_per_group(out_p, q, groups, picks=picks,
                                                       **kw)[:, heads])
    assert _build.launches["unpool_rows"] == 1  # the yardstick took the first design
    if mode == "active":
        assert not got[:, 1].any()


def test_pool_unpool_kernels_reject_what_they_do_not_take(card):
    """The head-map mode runs (it raised before it was ported): on the
    routed heads the kernels equal their plain versions, bitwise where the
    picks agree, and only the head-map counters count; unpool without
    picks and non-bf16 inputs still raise."""
    groups = build_lowres_groups((4, 6, 16), (2, 3, 2), 0.5)
    g = torch.Generator(device=card).manual_seed(14)
    q, k, v = (_randn(g, (1, 4, 384, 128), torch.bfloat16) for _ in range(3))
    for head_map, n in (([1, 3, 3, 3], 2), ([2, 2, 2, 2], 1), ([3, 0, 1, 2], 4)):
        routed = sorted(head_map[:n])
        kw = dict(head_map=torch.tensor(head_map, dtype=torch.int32), num_active=n)
        _build.reset_launches()
        got = pool_qkv(q, k, v, groups, kv_matching_from_k=n == 1, return_picks=True, **kw)
        want = pool_qkv_ref(q, k, v, groups, kv_matching_from_k=n == 1, **kw)
        torch.cuda.synchronize()
        assert (pick_gaps(got[3][:, routed], want[3][:, routed], q[:, routed], groups)
                < 1e-5).all()
        same = (got[3][:, routed] == want[3][:, routed]).all().item()
        for a, w in zip(got[:3], want[:3]):
            assert torch.equal(a[:, routed], w[:, routed]) or not same
        out_p = _randn(g, (1, 4, groups.pooled_length, 128), torch.bfloat16)
        up = unpool(out_p, q, groups, picks=got[3], **kw)
        assert torch.equal(up[:, routed],
                           unpool_ref(out_p, q, groups, picks=got[3], **kw)[:, routed])
        assert _build.launches == {**dict.fromkeys(_build.KERNELS, 0), "pool_qkv_headmap": 1,
                                   "unpool_headmap": 1, "unpool_rows": 1}
    q = q[:, :2]
    with pytest.raises(ValueError, match="distinct"):
        pool_qkv(q, q, q, groups, head_map=torch.zeros(2), num_active=2)
    with pytest.raises(NotImplementedError, match="picks"):
        unpool(q[:, :, :groups.pooled_length], q, groups)
    with pytest.raises(NotImplementedError, match="bf16"):
        pool_qkv(q.half(), q.half(), q.half(), groups)


DISPATCH_LAUNCHES = {  # heads (LOWRES, STA, LOWRES, FULL): launches per dispatch
    None: dict(sta_pipe=1, sta_pipe_wgmma=1, flash_manual=2, pool_qkv=1, unpool=1,
               unpool_rows=1),
    ("VORTA_LOWRES_DISPATCH", "batched"): dict(sta_pipe=1, sta_pipe_wgmma=1, flash_manual=2,
                                               pool_qkv_headmap=1, unpool_headmap=1,
                                               unpool_rows=1),
    ("VORTA_LOWRES_DISPATCH", "hybrid"): dict(sta_pipe=1, sta_pipe_wgmma=1, flash_manual=2,
                                              pool_qkv=2, unpool=2, unpool_rows=2),
    ("VORTA_ROUTED_DISPATCH", "switch"): dict(sta_pipe=1, sta_pipe_wgmma=1, flash_manual=3,
                                              pool_qkv=2, unpool=2, unpool_rows=2),
}


@pytest.mark.parametrize("env", list(DISPATCH_LAUNCHES))
def test_routed_dispatch_variables_on_card_match_cpu(card, env, monkeypatch):
    """fused_routed_attention under each dispatch variable on the card
    (bf16, kernels) against the CPU (the plain versions, f32, from the same
    bf16 values): rel L2 below 0.02, and against the card's masked dispatch
    within the bf16 gate; launch counts exact."""
    from vorta_tpu_torch.config import AttentionConfig
    from vorta_tpu_torch.ops.experts import FULL, LOWRES, STA
    from vorta_tpu_torch.ops.routed_fused import fused_routed_attention

    cfg = AttentionConfig(latent_shape=(4, 6, 16), sta_tile=(2, 3, 8), sta_window=(3, 3, 3),
                          lowres_window=(2, 3, 2), block_q=64, block_kv=64)
    ids = torch.tensor([LOWRES, STA, LOWRES, FULL])
    g = torch.Generator(device=card).manual_seed(16)
    q, k, v = (_randn(g, (1, 4, cfg.seq_len, 128), torch.bfloat16) for _ in range(3))
    masked = fused_routed_attention(q, k, v, ids.to(card), cfg, expert_ids_host=ids.numpy())
    if env is not None:
        monkeypatch.setenv(*env)
    _build.reset_launches()
    got = fused_routed_attention(q, k, v, ids.to(card), cfg, expert_ids_host=ids.numpy())
    assert _build.launches == {**dict.fromkeys(_build.KERNELS, 0), **DISPATCH_LAUNCHES[env]}
    want = fused_routed_attention(*(x.float().cpu() for x in (q, k, v)), ids, cfg)
    assert torch.isfinite(got).all()
    assert ((got.float().cpu() - want).norm() / want.norm()).item() < 0.02
    _close(got, masked)


@pytest.mark.parametrize("d", [64, 128])
def test_copy_probe_kernel_matches_plain(card, d):
    """tools/bench_pool.py's copy probe: pure selection, bitwise."""
    from vorta_tpu_torch.tools.bench_pool import copy_probe, copy_probe_ref

    groups = build_lowres_groups((4, 6, 16), (2, 3, 2), 0.5)
    g = torch.Generator(device=card).manual_seed(15)
    q, k, v = (_randn(g, (2, 3, 384, d), torch.bfloat16) for _ in range(3))
    _build.reset_launches()
    got = copy_probe(q, k, v, groups)
    assert _build.launches["copy_probe"] == 1
    for a, w in zip(got, copy_probe_ref(q, k, v, groups)):
        assert torch.equal(a, w)


# --- HunyuanVideo's joint features: kv_bias, the text tail, K's matching --------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block_q,block_kv,sq,skv,valid", [
    (32, 32, 128, 128, 100),         # small blocks, one warp
    (1024, 1024, 2048, 2048, None),  # the FULL / LOWRES joint layouts' blocks
    (256, 1024, 256, 3072, 2900),    # the STA text rows: kv_valid_len and the bias
])
def test_flash_manual_kv_bias_kernel_matches_plain(card, d, block_q, block_kv, sq, skv, valid):
    """The (1, Skv) bias added to the pre-scaled scores: -1e30 on 30% of
    the keys and on all of kv block 0, which every row visits first (no
    garbage may enter the sums), random finite values elsewhere."""
    b, h = 2, 3
    g = torch.Generator(device=card).manual_seed(20)
    q = _randn(g, (b, h, sq, d), torch.bfloat16)
    k, v = (_randn(g, (b, h, skv, d), torch.bfloat16) for _ in range(2))
    bias = torch.randn((1, skv), generator=g, device=card)
    bias = torch.where(torch.rand((1, skv), generator=g, device=card) < 0.3, -1e30, bias)
    bias[:, :block_kv] = -1e30
    ki, kc = dense_tables(sq // block_q, skv // block_kv).on(card)
    kc = torch.where(torch.tensor([True, False, True], device=card)[:, None], kc, 0)
    kw = dict(block_q=block_q, block_kv=block_kv, kv_valid_len=valid, scale=d**-0.5,
              kv_bias=bias, softmax="fast")
    _build.reset_launches()
    got = sparse_flash_attention_manual(q, k, v, ki, kc, **kw)
    assert _build.launches["flash_manual"] == 1
    _close(got, sparse_flash_attention_manual_ref(q, k, v, ki, kc, **kw))
    assert not got[:, 1].any()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("latent,tile,lt,with_bias", [
    ((4, 6, 16), (4, 6, 8), 24, True),      # the joint CPU tests' window-dense geometry
    ((12, 18, 16), (6, 9, 8), 256, True),   # HunyuanVideo's 432-token tile, 256 text keys
    ((8, 6, 20), (2, 3, 4), 8, False),      # tw | 8; text_bias None: zeros
])
def test_sta_kernel_text_tail_matches_plain(card, d, latent, tile, lt, with_bias):
    b, h = 2, 3
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(21)
    q, k, v = (_randn(g, (b, h, s, d), torch.bfloat16) for _ in range(3))
    tk, tv = (_randn(g, (b, h, lt, d), torch.bfloat16) for _ in range(2))
    bias = (torch.where(torch.arange(lt, device=card) < lt - 5, 0.0, -1e30)[None]
            if with_bias else None)
    active = torch.tensor([1, 0, 1], device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=d**-0.5, text_k=tk,
              text_v=tv, text_bias=bias)
    _build.reset_launches()
    got = sta_pipe_attention(q, k, v, active, **kw)
    assert _build.launches["sta_pipe"] == 1
    _close(got, sta_pipe_attention_ref(q, k, v, active, **kw))
    assert not got[:, 1].any()


@pytest.mark.parametrize("latent,window", [((4, 6, 16), (2, 3, 2)), ((4, 8, 8), (2, 2, 2))])
def test_pool_kv_matching_from_k_kernel_matches_plain(card, latent, window):
    """K and V pooled by K's own matching, the picks Q's: picks equal but
    at near-ties; pooled rows equal wherever no group's K ranking has a
    near-tie (pure selection)."""
    from vorta_tpu_torch.ops.coreset import group_view, slot_similarity

    b, h, d = 2, 3, 128
    groups = build_lowres_groups(latent, window, 0.5)
    g = torch.Generator(device=card).manual_seed(22)
    q, k, v = (_randn(g, (b, h, int(np.prod(latent)), d), torch.bfloat16) for _ in range(3))
    active = torch.tensor([1, 1, 0], device=card, dtype=torch.int32)
    got = pool_qkv(q, k, v, groups, kv_matching_from_k=True, active=active, return_picks=True)
    want = pool_qkv_ref(q, k, v, groups, kv_matching_from_k=True, active=active)
    torch.cuda.synchronize()
    assert (pick_gaps(got[3], want[3], q, groups) < 1e-5).all()
    sim = slot_similarity(group_view(k, groups), groups._geom.center_slot)
    gaps = sim.sort(dim=-1).values[..., :-1].diff(dim=-1)
    if gaps.min().item() > 1e-5:
        for a, w in zip(got[1:3], want[1:3]):
            assert torch.equal(a, w)
    q_only = pool_qkv(q, k, v, groups, active=active)
    assert not torch.equal(q_only[1], got[1])


def _hunyuan_card_cfg():
    from vorta_tpu_torch.models.hunyuan import HunyuanModelConfig

    return HunyuanModelConfig(dim=384, num_heads=3, head_dim=128, dual_layers=1,
                              single_layers=1, text_dim=64, text_len=24, pooled_dim=32,
                              freq_dim=64, refiner_layers=1)


@pytest.mark.parametrize("mode", ["off", "hard"])
def test_hunyuan_forward_on_card_matches_cpu(card, mode):
    """A 1 + 1-block model at head dim 128, window-dense geometry: the card
    (bf16, kernels) against the CPU (f32, plain versions) from the same
    weights, rel L2 below 0.05; routed hard, the heads go to all three
    experts and each kernel launches as the dispatch says."""
    from vorta_tpu_torch.config import AttentionConfig
    from vorta_tpu_torch.models.hunyuan import HunyuanModel

    cfg = _hunyuan_card_cfg()
    attn = AttentionConfig(latent_shape=(4, 6, 16), sta_tile=(4, 6, 8), lowres_window=(2, 2, 2),
                           block_q=32, block_kv=32)
    cpu = HunyuanModel(cfg, dtype=torch.float32, device="cpu", seed=4)
    with torch.no_grad():
        for block in cpu.blocks:
            block.router.linear.weight.zero_()
            block.router.linear.bias.copy_(torch.eye(3).reshape(-1) * 4.0)
    gpu = HunyuanModel(cfg, dtype=torch.bfloat16, device=card, seed=4)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(8)
    lat = torch.randn((1, 4, 12, 32, 16), generator=gen)
    text = torch.randn((1, 24, 64), generator=gen)
    pooled = torch.randn((1, 32), generator=gen)
    mask = (torch.arange(24) < 17)[None]
    args = (lat, torch.tensor([600.0]), text, mask, pooled)
    kw = dict(guidance=torch.tensor([6000.0]), attn_cfg=attn, routing_mode=mode)
    _build.reset_launches()
    with torch.inference_mode():
        res = gpu(*(x.to(card) for x in args), **{**kw, "guidance": kw["guidance"].to(card)})
        got = res.sample.float().cpu()
        launches = dict(_build.launches)
        want = cpu(*args, **kw).sample
    expected = {**dict.fromkeys(_build.KERNELS, 0), "flash_manual": 2, "prologue": 2,
                "fused_norm": 6}
    if mode == "hard":
        assert (res.expert_ids == np.array([[0, 1, 2]] * 2)).all()
        expected.update(flash_manual=6, sta_pipe=2, sta_pipe_wgmma=2, pool_qkv_headmap=2,
                        unpool_headmap=2, unpool_rows=2)
    assert launches == expected
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 0.05


def test_hunyuan_cli_on_card(card, tmp_path):
    import json

    from vorta_tpu_torch.cli.sample import main

    base = ["--model", "hunyuan-tiny", "--random_embeds", "--num_frames", "13",
            "--height", "96", "--width", "256", "--num_inference_steps", "2"]
    res = main(base + ["--native_attention", "--output", str(tmp_path / "off.npy")])
    assert res.latents.device.type == "cuda" and np.isfinite(np.load(tmp_path / "off.npy")).all()
    (tmp_path / "config.json").write_text(json.dumps(dict(
        latent_shape=[4, 6, 16], sta_tile=[4, 6, 8], lowres_window=[2, 2, 2], block_q=32,
        block_kv=32)))
    res = main(base + ["--resume_dir", str(tmp_path), "--output", str(tmp_path / "hard.npy")])
    assert np.load(tmp_path / "hard.npy").shape == (1, 4, 12, 32, 16)
    assert len(res.routing) == 2
    # hard routing at the tiny model's own 8-token tiles: sta_batched
    _build.reset_launches()
    res = main(base + ["--output", str(tmp_path / "own.npy")])
    assert np.isfinite(np.load(tmp_path / "own.npy")).all() and len(res.routing) == 2
    assert _build.launches["sta_batched"] > 0 and _build.launches["sta_pipe"] == 0


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
    """bf16 or f32 (the f32 serving path): f16 raises."""
    x = torch.zeros((1, 4, 256), device=card, dtype=torch.float16)
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
                        "fused_norm": 2 * layers + 1, "prologue": layers,
                        "prologue_rows": layers}
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
    assert launches == {**dict.fromkeys(_build.KERNELS, 0), "flash": n,
                        "fused_norm": 2 * n + 1, "prologue": n, "prologue_rows": n,
                        "flash_manual": 2 * n, "sta_pipe": n, "pool_qkv": n, "unpool": n,
                        "unpool_rows": n}
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


# --- training: the forward's lse, the flash backward, autograd rules ----------

def _bwd_inputs(card, b, h, sq, skv, d, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q, dout = (_randn(g, (b, h, sq, d), torch.bfloat16) for _ in range(2))
    k, v = (_randn(g, (b, h, skv, d), torch.bfloat16) for _ in range(2))
    return q, k, v, dout


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,block,seq,valid", [
    ("dense", 32, 128, 100),
    ("dense", 1024, 2048, 1500),  # FULL's blocks, tail mid-block
    ("shared", 64, 256, 250),     # q block 0 sees nothing: the 1e30 sentinel
    ("dense", 96, 384, None),     # STA's 96-token tiles: 2 warps per CUDA block
    ("dense", 16, 64, 50),
    ("dense", 360, 1080, 1000),   # 720p's 360-token STA tiles: a ragged last CUDA block
    ("shared", 24, 96, 90),       # 8 x 3: the 8-row tail warp opens a CUDA block
])
def test_flash_lse_matches_plain(card, d, kind, block, seq, valid):
    """The forward kernel's lse (f32) against the plain version's: the same
    f32 logits summed in another order, so rtol 1e-5 (atol 1e-4 for lse
    near 0); empty rows carry exactly 1e30."""
    q, k, v, _ = _bwd_inputs(card, 2, 3, seq, seq, d, 3)
    ki, kc = _tables(kind, 3, seq // block, seq // block).on(card)
    kw = dict(block_q=block, block_kv=block, kv_valid_len=valid, scale=d**-0.5)
    _build.reset_launches()
    out, lse = sparse_flash_attention_raw(q, k, v, ki, kc, return_lse=True, **kw)
    assert (_build.launches["flash"], _build.launches["flash_lse"]) == (1, 1)
    want_out, want_lse = sparse_flash_attention_ref(q, k, v, ki, kc, return_lse=True, **kw)
    _close(out, want_out)
    torch.cuda.synchronize()
    assert lse.shape == (2, 3, seq, 1) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    if kind == "shared":
        assert (lse[:, :, :block] == 1e30).all()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", [
    ("dense", 64, 64, 256, 256, 200),          # kv tail mid-block
    ("shared", 64, 64, 256, 256, None),        # sparse, q block 0 empty
    ("dense", 96, 96, 384, 384, None),         # STA's 96-token blocks: 2 warps
    ("dense", 256, 64, 512, 128, 100),         # cross-attention's shape class
    ("dense", 1024, 1024, 2048, 2048, 1500),   # FULL's blocks
    ("dense", 16, 16, 64, 64, 50),             # 1 warp
    ("dense", 360, 360, 1080, 1080, 1000),     # 720p's 360-token STA tiles
    ("shared", 360, 360, 1080, 1080, None),
    ("shared", 24, 24, 96, 96, 90),            # 8 x 3: tail warps open CUDA blocks
    ("dense", 24, 360, 96, 720, 700),          # mixed: q blocks 24, kv blocks 360
])
def test_flash_backward_kernels_match_plain(card, d, kind, bq, bkv, sq, skv, valid):
    """dq and dk/dv kernels against flash_backward_ref on the same inputs,
    the forward kernel's out and lse; padded kv rows get exactly zero dk and
    dv, an empty q block exactly zero dq."""
    from vorta_tpu_torch.ops.flash_bwd import flash_backward, flash_backward_ref, transpose_tables

    q, k, v, dout = _bwd_inputs(card, 2, 3, sq, skv, d, 4)
    tab = _tables(kind, 1, sq // bq, skv // bkv)
    ki, kc = tab.on(card)
    qi, qc = (torch.from_numpy(a).to(card)
              for a in transpose_tables(tab.kv_index, tab.kv_count, skv // bkv))
    kw = dict(scale=d**-0.5, block_q=bq, block_kv=bkv)
    out, lse = sparse_flash_attention_raw(q, k, v, ki, kc, kv_valid_len=valid, return_lse=True,
                                          **kw)
    _build.reset_launches()
    got = flash_backward(q, k, v, out, lse, dout, ki, kc, qi, qc, kv_valid_len=valid or skv, **kw)
    assert (_build.launches["flash_dq"], _build.launches["flash_dkv"]) == (1, 1)
    want = flash_backward_ref(q, k, v, out, lse, dout, ki, kc, kv_valid_len=valid or skv, **kw)
    for a, w in zip(got, want):
        _close(a, w)
    if valid:
        assert not got[1][:, :, valid:].any() and not got[2][:, :, valid:].any()
    if kind == "shared":
        assert not got[0][:, :, :bq].any()
    _build.reset_launches()
    dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ki, kc, qi, qc,
                                kv_valid_len=valid or skv, need_dkv=False, **kw)
    assert dk is None and dv is None and torch.equal(dq, got[0])
    assert (_build.launches["flash_dq"], _build.launches["flash_dkv"]) == (1, 0)


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("kv_grad", [True, False])
def test_sparse_attention_grads_on_card_match_cpu(card, kv_grad, block):
    """make_sparse_attention's autograd on the card (bf16, kernels) against
    the CPU (f32, plain versions): rel L2 below 0.02 (bf16 inputs and
    outputs, ds and p rounded to bf16).  Without grad on k and v (the
    cross-attention's frozen text) the dk/dv kernel is not launched.
    Blocks of 128 take the Hopper kernels, forward and backward; blocks of
    64 the mma.sync ones."""
    from vorta_tpu_torch.ops.flash import make_sparse_attention

    tab = tables_from_block_mask(np.array([[1, 1, 0, 0], [0, 1, 1, 0], [1, 0, 1, 1],
                                           [0, 0, 0, 0]], bool))
    attn = make_sparse_attention(tab, n_kv_blocks=4, block_q=block, block_kv=block,
                                 kv_valid_len=230 * block // 64)
    gen = torch.Generator().manual_seed(8)
    q, k, v, gout = (torch.randn((1, 2, 4 * block, 128), generator=gen) for _ in range(4))

    def grads(dev, dtype):
        qq, kk, vv = (t.to(dev, dtype).requires_grad_(n)
                      for t, n in zip((q, k, v), (True, kv_grad, kv_grad)))
        out = attn(qq, kk, vv)
        (out.float() * gout.to(dev)).sum().backward()
        return [t.grad.float().cpu() for t in (qq, kk, vv) if t.grad is not None]

    _build.reset_launches()
    got = grads(card, torch.bfloat16)
    assert _build.launches["flash_lse"] == 1 and _build.launches["flash_dq"] == 1
    assert _build.launches["flash_dkv"] == (1 if kv_grad else 0)
    hopper = int(block == 128)
    assert (_build.launches["flash_wgmma"], _build.launches["flash_dq_wgmma"],
            _build.launches["flash_dkv_wgmma"]) == (hopper, hopper, hopper * kv_grad)
    want = grads("cpu", torch.float32)
    assert len(got) == len(want) == (3 if kv_grad else 1)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        assert ((a - w).norm() / w.norm()).item() < 0.02


@pytest.mark.parametrize("rms,affine,mod", [(False, "none", True), (False, "gamma_beta", False),
                                            (True, "gamma", False), (False, "gamma", True)])
def test_norm_backward_on_card_matches_plain(card, rms, affine, mod):
    """fused_norm's autograd rule on the card (kernel forward, plain
    backward) against autograd of the plain version on the same tensors:
    bf16 dx by the 2^-5 rule, f32 parameter gradients to 1e-4 x max (sums
    over 4,096 rows in another order)."""
    g = torch.Generator(device=card).manual_seed(9)
    b, s, dim = 2, 2048, 512
    x = _randn(g, (b, s, dim), torch.bfloat16, 3.0)
    vec = {n: 0.3 * torch.randn(shape, generator=g, device=card)
           for n, shape in (("scale", (b, dim)), ("shift", (b, dim)), ("gamma", (dim,)),
                            ("beta", (dim,)))}
    use = {"scale": mod, "shift": mod, "gamma": affine != "none", "beta": affine == "gamma_beta"}
    gout = torch.randn((b, s, dim), generator=g, device=card)

    def run(fn):
        xs = x.clone().requires_grad_(True)
        args = [vec[n].clone().requires_grad_(True) if use[n] else None
                for n in ("scale", "shift", "gamma", "beta")]
        (fn(xs, *args).float() * gout).sum().backward()
        return [xs.grad] + [a.grad for a in args if a is not None]

    _build.reset_launches()
    got = run(lambda *a: fused_norm(*a, rms, 1e-6, False))
    assert _build.launches["fused_norm"] == 1
    want = run(lambda *a: _norm_ref(*a, rms=rms, eps=1e-6, out_f32=False))
    _close(got[0], want[0])
    for a, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-4 * w.abs().max().item())


def test_forward_only_kernels_raise_under_grad(card):
    """The wrappers with no backward in the JAX package raise on CUDA
    tensors that require grad under grad mode, and run under no_grad."""
    from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual
    from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched
    from vorta_tpu_torch.ops.sta_pipe import sta_pipe_attention
    from vorta_tpu_torch.ops.sta_row import sta_row_attention
    from vorta_tpu_torch.ops.sta_window import sta_window_attention

    q = torch.zeros((1, 2, 64, 64), device=card, dtype=torch.bfloat16, requires_grad=True)
    ki, kc = dense_tables(1, 1).on(card)
    groups = build_lowres_groups((4, 4, 4), (2, 2, 2))
    x = torch.zeros((1, 64, 128), device=card, dtype=torch.bfloat16, requires_grad=True)
    cos = torch.ones((64, 32), device=card)
    calls = [
        lambda: sparse_flash_attention_raw(q, q, q, ki, kc, block_q=64, block_kv=64),
        lambda: sparse_flash_attention_manual(q, q, q, ki, kc, block_q=64, block_kv=64),
        lambda: sta_pipe_attention(q, q, q, torch.ones(2, device=card), latent_shape=(4, 4, 4),
                                   tile=(2, 2, 2)),
        lambda: pool_qkv(q, q, q, groups),
        lambda: unpool(q[:, :, :groups.pooled_length], q, groups,
                       picks=torch.zeros((1, 2, 2, 2, 2, groups.num_kept_margins),
                                         dtype=torch.int32, device=card)),
        lambda: fused_qk_prologue(x, x, x, None, None, cos, cos, num_heads=2),
        lambda: sta_flash_headbatched(q, q, q, ki, kc, torch.ones(2, device=card), block_q=64,
                                      block_kv=64),
        lambda: sta_window_attention(q, q, q, torch.ones(2, device=card), latent_shape=(4, 4, 4),
                                     tile=(2, 2, 2)),
        lambda: sta_row_attention(q, q, q, torch.ones(2, device=card), latent_shape=(1, 1, 64),
                                  tile=(1, 1, 8)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()


def _train_cfg():
    from vorta_tpu_torch.config import WAN_TINY, AttentionConfig

    cfg = dataclasses.replace(WAN_TINY, dim=512, ffn_dim=1024, num_heads=4, head_dim=128,
                              text_dim=64, text_len=16, freq_dim=64)
    # 16-token STA tiles, so the flash kernel's 16-row blocks take them
    attn = AttentionConfig(latent_shape=(4, 8, 8), sta_tile=(2, 2, 4), sta_window=(3, 3, 1),
                           lowres_window=(2, 2, 2), block_q=64, block_kv=64)
    return cfg, attn


def test_train_step_on_card_matches_cpu(card):
    """One router train step's loss and router gradients on the card (bf16,
    kernels) against the CPU (f32, plain versions) from the same weights and
    draws: loss within 2%, router gradients rel L2 below 0.1 (bf16 through
    the forward and the backward of 2 blocks).  The launches per micro-step
    follow the graph: block 0's self-attention inputs need no gradient (no
    lse, no backward kernels), its cross-attention q does (dq only: the text
    k and v are frozen), and remat runs each student block's forward twice."""
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.schedulers.flow_match import train_sigmas
    from vorta_tpu_torch.training.step import LossWeights, make_router_train_step, router_partition

    cfg, attn = _train_cfg()
    sig = train_sigmas(3.0)
    step = make_router_train_step(attn, LossWeights(hidden_layer_distill=1.0),
                                  timestep_table=sig * 1000.0, sigma_table=sig)
    gen = torch.Generator().manual_seed(10)
    lat = torch.randn((1, 4, 16, 16, 16), generator=gen)
    ctx = torch.randn((1, 16, 64), generator=gen)
    eps = torch.randn(lat.shape, generator=gen)
    t, s = torch.tensor([700.0]), torch.tensor([0.7])

    cpu_model = WanModel(cfg, dtype=torch.float32, device="cpu", seed=3)

    def run(dev, dtype):
        model = WanModel(cfg, dtype=dtype, device=dev, seed=3)
        model.load_state_dict(cpu_model.state_dict())  # the card's generator draws others
        routers = router_partition(model)
        loss, metrics = step.loss(model, *(x.to(dev) for x in (lat, ctx, t, s, eps)))
        grads = torch.autograd.grad(loss, list(routers.values()))
        return loss.item(), torch.cat([g.flatten().cpu() for g in grads])

    _build.reset_launches()
    loss_g, grads_g = run(card, torch.bfloat16)
    launches = dict(_build.launches)
    loss_c, grads_c = run("cpu", torch.float32)
    n = cfg.num_layers
    assert launches == {**dict.fromkeys(_build.KERNELS, 0), "flash": 10 * n,
                        "flash_lse": 8 * n - 6, "flash_dq": 4 * n - 3, "flash_dkv": 3 * n - 3,
                        "fused_norm": 6 * n + 2, "prologue": n, "prologue_rows": n}
    assert abs(loss_g - loss_c) <= 0.02 * abs(loss_c)
    assert torch.isfinite(grads_g).all()
    assert ((grads_g - grads_c).norm() / grads_c.norm()).item() < 0.1


def test_train_cli_on_card(card, tmp_path):
    """The trainer CLI on the card: 2 optimizer steps of 2 micro-steps, a
    checkpoint, a resumed third step; finite losses, routers moved."""
    from vorta_tpu_torch.cli.train import main

    args = ["--model", "wan-1_3B", "--num_latent_t", "4", "--video_height", "384",
            "--video_width", "256", "--sta_tile", "4", "4", "4", "--synthetic_data",
            "--gradient_accumulation_steps", "2", "--output_dir", str(tmp_path)]
    first = main(args + ["--max_train_steps", "2"])
    second = main(args + ["--max_train_steps", "3", "--resume_from_checkpoint", "latest"])
    assert (first.final_step, second.init_step, second.final_step) == (2, 2, 3)
    assert all(np.isfinite(m["loss"]) for m in first.metrics + second.metrics)
    moved = max((first.router_final[k] - first.router_init[k]).abs().max().item()
                for k in first.router_init)
    assert moved > 0


# --- quantized serving: the int8 QK modes, W8A8, quantized stacks --------------------

def _int8_qk(card, g, shape, kshape=None):
    """int8 q, k quantized per head from bf16 draws, and their qk_scale."""
    from vorta_tpu_torch.ops.routed_fused import quantize_qk

    return quantize_qk(_randn(g, shape, torch.bfloat16), _randn(g, kshape or shape, torch.bfloat16))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block_q,block_kv,sq,skv,valid,with_bias", [
    (32, 32, 128, 128, 100, False),        # small blocks, one warp, the tail rule
    (1024, 1024, 2048, 2048, 1500, False),  # the routed experts' blocks
    (1024, 1024, 2048, 2048, None, True),  # the joint layouts: kv_bias
])
def test_flash_manual_int8_kernel_matches_plain(card, d, block_q, block_kv, sq, skv, valid,
                                                with_bias):
    """The int8 QK mode on the same int8 q / k as the plain version (exact
    int32 scores on both sides), a head routed away."""
    b, h = 2, 3
    g = torch.Generator(device=card).manual_seed(30)
    q8, k8, qk_scale = _int8_qk(card, g, (b, h, sq, d), (b, h, skv, d))
    v = _randn(g, (b, h, skv, d), torch.bfloat16)
    ki, kc = dense_tables(sq // block_q, skv // block_kv).on(card)
    kc = torch.where(torch.tensor([True, False, True], device=card)[:, None], kc, 0)
    kw = dict(block_q=block_q, block_kv=block_kv, kv_valid_len=valid, scale=d**-0.5,
              qk_scale=qk_scale, softmax="fast")
    if with_bias:
        bias = torch.where(torch.rand((1, skv), generator=g, device=card) < 0.3, -1e30, 0.0)
        bias[:, :block_kv] = -1e30
        kw["kv_bias"] = bias
    _build.reset_launches()
    got = sparse_flash_attention_manual(q8, k8, v, ki, kc, **kw)
    assert _build.launches["flash_manual"] == 1 and _build.launches["flash_manual_int8"] == 1
    _close(got, sparse_flash_attention_manual_ref(q8, k8, v, ki, kc, **kw))
    assert not got[:, 1].any()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("latent,tile,lt", [
    ((12, 18, 20), (4, 6, 4), 0),         # the 480p tile, 2 warps
    ((8, 6, 32), (2, 3, 8), 0),           # clamping on t and w
    ((12, 18, 16), (6, 9, 8), 256),       # HunyuanVideo's 432-token tile, int8 text keys
])
def test_sta_kernel_int8_matches_plain(card, d, latent, tile, lt):
    b, h = 2, 3
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(31)
    q8, k8, qk_scale = _int8_qk(card, g, (b, h, s, d))
    v = _randn(g, (b, h, s, d), torch.bfloat16)
    active = torch.tensor([1, 0, 1], device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=d**-0.5,
              qk_scale=qk_scale)
    if lt:
        from vorta_tpu_torch.ops.routed_fused import quantize_per_head

        kw.update(text_k=quantize_per_head(_randn(g, (b, h, lt, d), torch.bfloat16))[0],
                  text_v=_randn(g, (b, h, lt, d), torch.bfloat16),
                  text_bias=torch.where(torch.arange(lt, device=card) < 83, 0.0, -1e30)[None])
    _build.reset_launches()
    got = sta_pipe_attention(q8, k8, v, active, **kw)
    assert _build.launches["sta_pipe"] == 1 and _build.launches["sta_pipe_int8"] == 1
    _close(got, sta_pipe_attention_ref(q8, k8, v, active, **kw))
    assert not got[:, 1].any()


@pytest.mark.parametrize("m,k,n,static", [
    (4096, 1536, 8960, False),  # the Wan FFN's input projection, 4,096 tokens
    (300, 200, 100, True),      # K, N not multiples of 8: zero-padded for _int_mm
    (5, 64, 48, False),         # M below _int_mm's 17 rows
])
def test_int8_linear_on_card_matches_plain(card, m, k, n, static):
    """W8A8 on the card (torch._int_mm) against the same function on the
    CPU: the quantized operands and the int32 sums are exact, so the bf16
    outputs agree within one ulp."""
    from vorta_tpu_torch.ops.qmm import int8_linear

    g = torch.Generator(device=card).manual_seed(32)
    x = _randn(g, (1, m, k), torch.bfloat16)
    w = _randn(g, (n, k), torch.bfloat16, scale=k**-0.5)
    b = _randn(g, (n,), torch.bfloat16)
    xs = torch.tensor(0.02, device=card) if static else None
    got = int8_linear(x, w, b, x_scale=xs)
    want = int8_linear(x.cpu(), w.cpu(), b.cpu(), x_scale=None if xs is None else xs.cpu())
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    err = (got.float().cpu() - want.float()).abs()
    floor = torch.maximum(want.float().abs(), want.float().pow(2).mean().sqrt())
    assert (err / floor).max().item() <= 2.0**-8


def test_quantized_wan_forward_on_card_matches_cpu(card):
    """qk_int8 + mm int8, routed hard to all three experts, and the same
    from an int8 quantized stack: the card (bf16, kernels, _int_mm) against
    the CPU (f32, plain versions), rel L2 below 0.05; the int8 modes launch
    where the bf16 ones did."""
    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_TINY
    from vorta_tpu_torch.io.quant_serving import random_block_stack
    from vorta_tpu_torch.models.wan import WanModel

    cfg = dataclasses.replace(WAN_TINY, dim=512, ffn_dim=1024, num_heads=4, head_dim=128,
                              text_dim=64, text_len=16, freq_dim=64)
    attn = dataclasses.replace(attention_config("wan-tiny", (4, 8, 8)), qk_int8=True)
    cpu = WanModel(cfg, dtype=torch.float32, device="cpu", seed=2)
    with torch.no_grad():
        for block in cpu.blocks:
            block.router.linear.weight.zero_()
            block.router.linear.bias.copy_(torch.eye(3)[[0, 1, 2, 2]].reshape(-1) * 4.0)
    gpu = WanModel(cfg, dtype=torch.bfloat16, device=card, seed=2)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(7)
    lat, ctx, t = torch.randn((1, 4, 16, 16, 16), generator=gen), torch.randn((1, 16, 64), generator=gen), torch.tensor([600.0])
    kw = dict(attn_cfg=attn, routing_mode="hard", mm_precision="int8")
    n = cfg.num_layers
    stacks = {}
    for where, model, dev in (("gpu", gpu, card), ("cpu", cpu, "cpu")):
        stacks[where] = random_block_stack("blocks", model.blocks[0], n, 8, 5, dev)
        for key, w in stacks[where].leaves.items():
            if "router" in key:  # one-hot routing, as above
                stacks[where].set_leaf(key, torch.zeros_like(w) if "kernel" in key else
                                       (torch.eye(3)[[0, 1, 2, 2]].reshape(-1) * 4.0)
                                       .to(w).expand_as(w).contiguous())
    _build.reset_launches()
    with torch.inference_mode():
        res = gpu(lat.to(card), t.to(card), ctx.to(card), **kw)
        launches = dict(_build.launches)
        want = cpu(lat, t, ctx, **kw).sample
        got_q = gpu(lat.to(card), t.to(card), ctx.to(card), quantized_blocks=stacks["gpu"], **kw)
        want_q = cpu(lat, t, ctx, quantized_blocks=stacks["cpu"], **kw).sample
    assert (res.expert_ids == np.array([0, 1, 2, 2])).all()
    assert launches == {**dict.fromkeys(_build.KERNELS, 0), "flash": n,
                        "fused_norm": 2 * n + 1, "prologue": n, "prologue_rows": n,
                        "flash_manual": 2 * n, "flash_manual_int8": 2 * n, "sta_pipe": n,
                        "pool_qkv": n, "unpool": n, "unpool_rows": n}
    for got, ref in ((res.sample, want), (got_q.sample, want_q)):
        got = got.float().cpu()
        assert torch.isfinite(got).all()
        assert ((got - ref).norm() / ref.norm()).item() < 0.05


@pytest.mark.parametrize("mode", ["off", "hard"])
def test_quantized_hunyuan_forward_on_card_matches_cpu(card, mode):
    """qk_int8 + mm int8 on a 1 + 1-block model, routing off (FULL in int8
    on both blocks) and hard: card against CPU, rel L2 below 0.05."""
    from vorta_tpu_torch.config import AttentionConfig
    from vorta_tpu_torch.models.hunyuan import HunyuanModel

    cfg = _hunyuan_card_cfg()
    attn = AttentionConfig(latent_shape=(4, 6, 16), sta_tile=(4, 6, 8), lowres_window=(2, 2, 2),
                           block_q=32, block_kv=32, qk_int8=True)
    cpu = HunyuanModel(cfg, dtype=torch.float32, device="cpu", seed=4)
    with torch.no_grad():
        for block in cpu.blocks:
            block.router.linear.weight.zero_()
            block.router.linear.bias.copy_(torch.eye(3).reshape(-1) * 4.0)
    gpu = HunyuanModel(cfg, dtype=torch.bfloat16, device=card, seed=4)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(8)
    args = (torch.randn((1, 4, 12, 32, 16), generator=gen), torch.tensor([600.0]),
            torch.randn((1, 24, 64), generator=gen), (torch.arange(24) < 17)[None],
            torch.randn((1, 32), generator=gen))
    kw = dict(attn_cfg=attn, routing_mode=mode, mm_precision="int8")
    _build.reset_launches()
    with torch.inference_mode():
        got = gpu(*(x.to(card) for x in args), guidance=torch.tensor([6000.0], device=card),
                  **kw).sample.float().cpu()
        launches = dict(_build.launches)
        want = cpu(*args, guidance=torch.tensor([6000.0]), **kw).sample
    assert launches["flash_manual_int8"] == (2 if mode == "off" else 4)
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 0.05


def test_cli_quantized_on_card(card, tmp_path):
    """The CLI's four flags on the card: wan-tiny routed with all four
    (static scales from a table), hunyuan-tiny off with int8 QK and W8A8."""
    from vorta_tpu_torch.cli.sample import main

    sites = ["attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out", "attn2.to_q",
             "attn2.to_out", "ffn.proj_in", "ffn.proj_out"]
    np.savez(tmp_path / "scales.npz", **{s: np.full(2, 0.05, np.float32) for s in sites})
    out = tmp_path / "q.npy"
    res = main(["--model", "wan-tiny", "--random_embeds", "--num_frames", "13", "--height", "64",
                "--width", "64", "--num_inference_steps", "2", "--qk_int8", "--mm", "int8",
                "--act_scales", str(tmp_path / "scales.npz"), "--quantize_blocks", "int4",
                "--output", str(out)])
    assert np.isfinite(np.load(out)).all() and len(res.routing) == 4
    res = main(["--model", "hunyuan-tiny", "--random_embeds", "--num_frames", "13",
                "--height", "96", "--width", "256", "--num_inference_steps", "2",
                "--native_attention", "--qk_int8", "--mm", "int8", "--quantize_blocks", "int8",
                "--output", str(tmp_path / "hy.npy")])
    assert np.isfinite(np.load(tmp_path / "hy.npy")).all()


# --- the Hopper path of flash and flash_manual (csrc/attn_sm90.cuh) -----------------

def test_sm90_probe_matches_matmul(card):
    """One 128 x 128 tile through the path's TMA loads and descriptors: S =
    Q K^T from shared memory (K-major both), O = bf16(S) V with P from
    registers and V MN-major, against torch.matmul in f32."""
    g = torch.Generator(device=card).manual_seed(30)
    q, k, v = (_randn(g, (128, 128), torch.bfloat16) for _ in range(3))
    s, o = sm90_probe(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(o, s.to(torch.bfloat16).float() @ v.float(), rtol=1e-5, atol=1e-4)


def _hopper_tables(kind: str, h: int, nq: int, nkv: int):
    """dense; shared / per_head: random block masks with q block 0 empty
    (count 0 beside full rows) and q block 1 seeing kv block 0."""
    if kind == "dense":
        return dense_tables(nq, nkv)
    rng = np.random.default_rng(7)
    mask = rng.random((h if kind == "per_head" else 1, nq, nkv)) < 0.6
    mask[..., 0, :] = False
    mask[..., 1, 0] = True
    return tables_from_block_mask(mask)


HOPPER_CASES = [  # kind, block_q, block_kv, sq, skv, kv_valid_len
    ("dense", 256, 256, 1024, 1024, 1000),   # tail inside the last 128-key sub-tile
    ("dense", 256, 256, 1024, 1024, 896),    # tail on a sub-tile edge (768 + 128)
    ("shared", 256, 256, 1024, 1024, 1000),  # q block 0 count 0 beside full rows
    ("per_head", 128, 128, 768, 768, None),  # per-head tables
    ("dense", 2048, 512, 4096, 512, 300),    # cross-attention's blocks, text tail
    ("dense", 256, 1024, 256, 3072, 2900),   # the STA text rows' blocks
    ("dense", 1024, 1024, 2048, 2048, None),  # the experts' blocks, no tail
]


@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", HOPPER_CASES)
def test_flash_hopper_path_matches_plain(card, kind, bq, bkv, sq, skv, valid):
    """flash with the lse on the Hopper path, batch 2, against the plain
    version: out within the bf16 tolerance, the lse within 1e-4 + 1e-5 x
    |plain|, exactly 1e30 (and zero rows) where a q block sees nothing."""
    q, k, v, _ = _bwd_inputs(card, 2, 3, sq, skv, 128, 31)
    ki, kc = _hopper_tables(kind, 3, sq // bq, skv // bkv).on(card)
    kw = dict(block_q=bq, block_kv=bkv, kv_valid_len=valid, scale=1.1 * 128**-0.5)
    _build.reset_launches()
    out, lse = sparse_flash_attention_raw(q, k, v, ki, kc, return_lse=True, **kw)
    assert (_build.launches["flash"], _build.launches["flash_wgmma"]) == (1, 1)
    want_out, want_lse = sparse_flash_attention_ref(q, k, v, ki, kc, return_lse=True, **kw)
    _close(out, want_out)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    if kind != "dense":
        assert not out[:, :, :bq].any() and (lse[:, :, :bq] == 1e30).all()
    _build.reset_launches()
    _close(sparse_flash_attention_raw(q, k, v, ki, kc, **kw), want_out)
    assert (_build.launches["flash_wgmma"], _build.launches["flash_lse"]) == (1, 0)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", HOPPER_CASES)
def test_flash_manual_hopper_path_matches_plain(card, kind, bq, bkv, sq, skv, valid, with_bias):
    """flash_manual's fast softmax on the Hopper path, batch 2: per-head
    counts over the tables (head 1 routed away writes zeros), and a kv_bias
    with -1e30 on 30% of the keys and on all of kv block 0, which row
    block 1 visits first (on its first half where there is one kv block, so
    that some keys stay visible)."""
    q, k, v, _ = _bwd_inputs(card, 2, 3, sq, skv, 128, 32)
    ki, kc = _hopper_tables(kind, 3, sq // bq, skv // bkv).on(card)
    if kind != "per_head":
        kc = torch.where(torch.tensor([True, False, True], device=card)[:, None], kc, 0)
    bias = None
    if with_bias:
        g = torch.Generator(device=card).manual_seed(33)
        bias = torch.randn((1, skv), generator=g, device=card)
        bias = torch.where(torch.rand((1, skv), generator=g, device=card) < 0.3, -1e30, bias)
        bias[:, :min(bkv, skv // 2)] = -1e30
    kw = dict(block_q=bq, block_kv=bkv, kv_valid_len=valid, scale=128**-0.5, kv_bias=bias,
              softmax="fast")
    _build.reset_launches()
    got = sparse_flash_attention_manual(q, k, v, ki, kc, **kw)
    assert (_build.launches["flash_manual"], _build.launches["flash_manual_wgmma"]) == (1, 1)
    _close(got, sparse_flash_attention_manual_ref(q, k, v, ki, kc, **kw))
    if kind != "per_head":
        assert not got[:, 1].any()


@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", HOPPER_CASES[:4] + HOPPER_CASES[5:])
def test_flash_manual_int8_hopper_path_matches_plain(card, kind, bq, bkv, sq, skv, valid):
    """The int8 QK mode on the Hopper path (wgmma s8): int8 q / k, bf16 v, a
    per-head qk_scale and a kv_bias, against the plain version on the same
    int8 inputs (its f32 einsum of int8 values is exact)."""
    g = torch.Generator(device=card).manual_seed(36)
    q, k = (torch.randint(-127, 128, (2, 3, n, 128), generator=g, device=card,
                          dtype=torch.int8) for n in (sq, skv))
    v = _randn(g, (2, 3, skv, 128), torch.bfloat16)
    qk_scale = torch.tensor([0.4, 0.5, 0.6], device=card) / 127.0**2
    ki, kc = _hopper_tables(kind, 3, sq // bq, skv // bkv).on(card)
    if kind != "per_head":
        kc = torch.where(torch.tensor([True, False, True], device=card)[:, None], kc, 0)
    bias = torch.where(torch.arange(skv, device=card) % 7 == 0, -1e30, 0.25)[None]
    kw = dict(block_q=bq, block_kv=bkv, kv_valid_len=valid, scale=128**-0.5, kv_bias=bias,
              qk_scale=qk_scale, softmax="fast")
    _build.reset_launches()
    got = sparse_flash_attention_manual(q, k, v, ki, kc, **kw)
    assert (_build.launches["flash_manual_int8"], _build.launches["flash_manual_wgmma"]) == (1, 1)
    _close(got, sparse_flash_attention_manual_ref(q, k, v, ki, kc, **kw))


def test_hopper_path_rule_on_the_card(card):
    """The same wrapper sends D = 64, blocks 128 does not tile and the stable
    softmax to the mma.sync kernel (counted in the total only), and D = 128
    with blocks of 128 to the Hopper path, flash_manual's int8 QK mode too."""
    g = torch.Generator(device=card).manual_seed(34)
    cases = [(128, 128, True), (64, 128, False), (128, 96, False), (128, 64, False)]
    for d, block, hopper in cases:
        q, k, v = (_randn(g, (1, 2, 384, d), torch.bfloat16) for _ in range(3))
        ki, kc = dense_tables(384 // block, 384 // block).on(card)
        _build.reset_launches()
        sparse_flash_attention_raw(q, k, v, ki, kc, block_q=block, block_kv=block)
        sparse_flash_attention_manual(q, k, v, ki, kc, block_q=block, block_kv=block,
                                      softmax="fast")
        assert (_build.launches["flash_wgmma"], _build.launches["flash_manual_wgmma"]) == (
            int(hopper), int(hopper)), (d, block)
    ki, kc = dense_tables(3, 3).on(card)
    _build.reset_launches()
    sparse_flash_attention_manual(q, k, v, ki, kc, block_q=128, block_kv=128, softmax="stable")
    q8 = q.to(torch.int8)
    sparse_flash_attention_manual(q8, q8, v, ki, kc, block_q=128, block_kv=128,
                                  qk_scale=torch.ones(2, device=card), softmax="fast")
    assert (_build.launches["flash_manual"], _build.launches["flash_manual_wgmma"]) == (2, 1)
    assert _build.launches["flash_manual_int8"] == 1


@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", [
    ("dense", 1024, 1024, 2048, 2048, 1500),
    ("shared", 256, 256, 1024, 1024, 1000),
    ("dense", 2048, 512, 4096, 512, 300),
])
def test_flash_backward_on_hopper_forward_lse(card, kind, bq, bkv, sq, skv, valid):
    """The dq and dk/dv kernels fed the Hopper path's out and lse, against
    flash_backward_ref on the same out and lse; that lse against the plain
    forward's (the backward reads exp2(s - lse))."""
    from vorta_tpu_torch.ops.flash_bwd import flash_backward, flash_backward_ref, transpose_tables

    q, k, v, dout = _bwd_inputs(card, 2, 3, sq, skv, 128, 35)
    tab = _hopper_tables(kind, 1, sq // bq, skv // bkv)
    ki, kc = tab.on(card)
    qi, qc = (torch.from_numpy(a).to(card)
              for a in transpose_tables(tab.kv_index, tab.kv_count, skv // bkv))
    kw = dict(scale=128**-0.5, block_q=bq, block_kv=bkv)
    _build.reset_launches()
    out, lse = sparse_flash_attention_raw(q, k, v, ki, kc, kv_valid_len=valid, return_lse=True,
                                          **kw)
    assert _build.launches["flash_wgmma"] == 1
    _, want_lse = sparse_flash_attention_ref(q, k, v, ki, kc, kv_valid_len=valid,
                                             return_lse=True, **kw)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    _build.reset_launches()
    got = flash_backward(q, k, v, out, lse, dout, ki, kc, qi, qc, kv_valid_len=valid or skv, **kw)
    assert (_build.launches["flash_dq_wgmma"], _build.launches["flash_dkv_wgmma"]) == (1, 1)
    want = flash_backward_ref(q, k, v, out, lse, dout, ki, kc, kv_valid_len=valid or skv, **kw)
    for a, w in zip(got, want):
        _close(a, w)


def _bwd_case(card, kind, bq, bkv, sq, skv, valid, seed):
    """Inputs, tables (forward and transposed) and the Hopper forward's out
    and lse for a backward test; "unvisited": q block 0 visits nothing and
    no q block visits the last kv block but one."""
    from vorta_tpu_torch.ops.flash_bwd import transpose_tables

    q, k, v, dout = _bwd_inputs(card, 2, 3, sq, skv, 128, seed)
    nq, nkv = sq // bq, skv // bkv
    if kind == "unvisited":
        mask = np.random.default_rng(seed).random((1, nq, nkv)) < 0.7
        mask[0, 0, :] = False
        mask[0, 1:, 0] = True
        mask[0, :, nkv - 2] = False
        tab = tables_from_block_mask(mask)
    else:
        tab = _hopper_tables(kind, 1, nq, nkv)
    ki, kc = tab.on(card)
    qi, qc = (torch.from_numpy(a).to(card)
              for a in transpose_tables(tab.kv_index, tab.kv_count, nkv))
    kw = dict(scale=1.1 * 128**-0.5, block_q=bq, block_kv=bkv)
    out, lse = sparse_flash_attention_raw(q, k, v, ki, kc, kv_valid_len=valid, return_lse=True,
                                          **kw)
    return (q, k, v, out, lse, dout, ki, kc, qi, qc), dict(kv_valid_len=valid or skv, **kw)


BWD_HOPPER_CASES = [  # kind, block_q, block_kv, sq, skv, kv_valid_len
    ("dense", 128, 128, 512, 512, 450),        # tail inside the last 128-key slot
    ("dense", 1024, 1024, 2048, 2048, 1100),   # FULL's blocks: 7 kv tiles wholly past the tail
    ("dense", 2048, 512, 4096, 512, 300),      # cross-attention's blocks, a text tail
    ("unvisited", 1024, 1024, 4096, 4096, None),  # an empty q block, an unvisited kv block
    ("unvisited", 128, 256, 1024, 2048, 1900),
    ("shared", 256, 256, 1024, 1024, 1000),
]


@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", BWD_HOPPER_CASES)
def test_flash_backward_hopper_matches_plain_and_mma_sync(card, kind, bq, bkv, sq, skv, valid):
    """The Hopper dq and dk/dv kernels (batch 2, 3 heads) against
    flash_backward_ref and against the mma.sync kernels on the same inputs,
    each within the bf16 tolerance; padded kv rows, kv tiles wholly past the
    tail and a kv block no q block visits get exactly zero dk and dv, a q
    block that sees nothing exactly zero dq.  Counted once each on the
    Hopper path; the mma.sync run in the totals only."""
    from vorta_tpu_torch.ops.flash_bwd import (
        flash_backward,
        flash_backward_mma_sync,
        flash_backward_ref,
    )

    args, kw = _bwd_case(card, kind, bq, bkv, sq, skv, valid, 41)
    _build.reset_launches()
    got = flash_backward(*args, **kw)
    assert (_build.launches["flash_dq"], _build.launches["flash_dq_wgmma"],
            _build.launches["flash_dkv"], _build.launches["flash_dkv_wgmma"]) == (1, 1, 1, 1)
    want = flash_backward_ref(*args[:8], **kw)
    _build.reset_launches()
    old = flash_backward_mma_sync(*args, **kw)
    assert (_build.launches["flash_dq"], _build.launches["flash_dq_wgmma"],
            _build.launches["flash_dkv"], _build.launches["flash_dkv_wgmma"]) == (1, 0, 1, 0)
    for a, w, o in zip(got, want, old):
        _close(a, w)
        _close(a, o)
    if valid:
        assert not got[1][:, :, valid:].any() and not got[2][:, :, valid:].any()
    if kind != "dense":
        assert not got[0][:, :, :bq].any()
    if kind == "unvisited":
        rows = slice((skv // bkv - 2) * bkv, (skv // bkv - 1) * bkv)
        assert not got[1][:, :, rows].any() and not got[2][:, :, rows].any()


@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", [BWD_HOPPER_CASES[1], BWD_HOPPER_CASES[4]])
def test_flash_backward_hopper_need_dq_or_dkv_alone(card, kind, bq, bkv, sq, skv, valid):
    """need_dkv=False launches the Hopper dq kernel alone, need_dq=False the
    dk/dv kernel alone; each gives bit for bit what the call of both gives
    (one writer per output row, no atomics)."""
    from vorta_tpu_torch.ops.flash_bwd import flash_backward

    args, kw = _bwd_case(card, kind, bq, bkv, sq, skv, valid, 42)
    both = flash_backward(*args, **kw)
    _build.reset_launches()
    dq, dk, dv = flash_backward(*args, need_dkv=False, **kw)
    assert dk is None and dv is None and torch.equal(dq, both[0])
    assert (_build.launches["flash_dq_wgmma"], _build.launches["flash_dkv"]) == (1, 0)
    _build.reset_launches()
    dq, dk, dv = flash_backward(*args, need_dq=False, **kw)
    assert dq is None and torch.equal(dk, both[1]) and torch.equal(dv, both[2])
    assert (_build.launches["flash_dq"], _build.launches["flash_dkv_wgmma"]) == (0, 1)


def test_flash_backward_rule_leaves_the_rest_on_mma_sync(card):
    """D = 64 and blocks 128 does not divide (96, 360, 24: the STA tiles; 64)
    run the mma.sync kernels, counted in the totals only; D = 128 with
    blocks of 128 the Hopper kernels."""
    from vorta_tpu_torch.ops.flash_bwd import flash_backward, transpose_tables

    tab = dense_tables(4, 4)
    qi, qc = (torch.from_numpy(a).to(card)
              for a in transpose_tables(tab.kv_index, tab.kv_count, 4))
    ki, kc = tab.on(card)
    for d, block, hopper in [(128, 128, 1), (64, 128, 0), (128, 96, 0), (128, 64, 0),
                             (128, 360, 0), (128, 24, 0)]:
        n = 4 * block
        q, k, v, dout = _bwd_inputs(card, 1, 2, n, n, d, 43)
        kw = dict(scale=d**-0.5, block_q=block, block_kv=block)
        out, lse = sparse_flash_attention_raw(q, k, v, ki, kc, return_lse=True, **kw)
        _build.reset_launches()
        flash_backward(q, k, v, out, lse, dout, ki, kc, qi, qc, kv_valid_len=n, **kw)
        torch.cuda.synchronize()
        assert (_build.launches["flash_dq"], _build.launches["flash_dkv"],
                _build.launches["flash_dq_wgmma"], _build.launches["flash_dkv_wgmma"]) == (
            1, 1, hopper, hopper), (d, block)


# --- sta_pipe's Hopper path (csrc/attn_sm90.cuh over the window) --------------------

STA_SERVED = [  # (latent, tile, text_len): Wan 480p x 77f, Wan 720p x 77f, Hunyuan 45f
    ((20, 30, 52), (4, 6, 4), 0),
    ((20, 45, 80), (5, 9, 8), 0),
    ((12, 45, 80), (6, 9, 8), 256),
]


@pytest.mark.parametrize("latent,tile,lt", STA_SERVED)
def test_sta_hopper_path_at_the_served_geometries(card, latent, tile, lt):
    """Two heads, one inactive (zeros): the Hopper path against the plain
    version, the text tail with 83 of 256 keys valid, and without the tail
    the plain version fails the gate; the mma.sync kernel agrees too."""
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(40)
    q, k, v = (_randn(g, (1, 2, s, 128), torch.bfloat16) for _ in range(3))
    active = torch.tensor([1, 0], device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=128**-0.5)
    if lt:
        kw.update(text_k=_randn(g, (1, 2, lt, 128), torch.bfloat16),
                  text_v=_randn(g, (1, 2, lt, 128), torch.bfloat16),
                  text_bias=torch.where(torch.arange(lt, device=card) < 83, 0.0, -1e30)[None])
    assert sta_wgmma_path(128, latent, tile)
    _build.reset_launches()
    got = sta_pipe_attention(q, k, v, active, **kw)
    assert (_build.launches["sta_pipe"], _build.launches["sta_pipe_wgmma"]) == (1, 1)
    want = sta_pipe_attention_ref(q, k, v, active, **kw)
    _close(got, want)
    assert not got[:, 1].any()
    _close(sta_pipe_attention_mma_sync(q, k, v, active, **kw), want)
    assert _build.launches["sta_pipe_wgmma"] == 1
    if lt:
        torch.cuda.synchronize()
        no_tail = sta_pipe_attention_ref(q, k, v, active, latent_shape=latent, tile=tile,
                                         scale=128**-0.5)
        err = (no_tail[:, 0] - want[:, 0]).float().abs()
        floor = torch.maximum(want[:, 0].float().abs(), want[:, 0].float().pow(2).mean().sqrt())
        assert (err / floor).max().item() > 2.0**-5


@pytest.mark.parametrize("latent,tile", [((8, 18, 40), (2, 6, 8)), ((12, 18, 20), (4, 6, 4))])
def test_sta_hopper_path_at_the_corner_tiles(card, latent, tile):
    """Windows clamped at every corner of the grid: the rows of the first and
    last q tiles and of the two other (h, w) corners of the first t row,
    batch 2, against the plain version."""
    from vorta_tpu_torch.ops.layout import tile_sequence

    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(41)
    q, k, v = (_randn(g, (2, 2, s, 128), torch.bfloat16) for _ in range(3))
    active = torch.ones(2, device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=1.1 * 128**-0.5)
    _build.reset_launches()
    got = sta_pipe_attention(q, k, v, active, **kw)
    assert _build.launches["sta_pipe_wgmma"] == 1
    want = sta_pipe_attention_ref(q, k, v, active, **kw)
    _close(got, want)
    nh, nw = latent[1] // tile[1], latent[2] // tile[2]
    tpt = int(np.prod(tile))
    n = s // tpt
    gt, wt = (tile_sequence(x, latent, tile).reshape(2, 2, n, tpt, 128) for x in (got, want))
    for corner in (0, nw - 1, (nh - 1) * nw, n - 1):
        _close(gt[:, :, corner], wt[:, :, corner])


def test_sta_hopper_path_text_tail_of_24_keys(card):
    """A text tail shorter than one ring slot (24 keys, 17 valid, the last
    slot cut at 24): inactive heads zero."""
    latent, tile = (4, 6, 16), (4, 6, 8)
    g = torch.Generator(device=card).manual_seed(42)
    q, k, v = (_randn(g, (2, 3, 384, 128), torch.bfloat16) for _ in range(3))
    tk, tv = (_randn(g, (2, 3, 24, 128), torch.bfloat16) for _ in range(2))
    bias = torch.where(torch.arange(24, device=card) < 17, 0.0, -1e30)[None]
    active = torch.tensor([1, 0, 1], device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, scale=128**-0.5, text_k=tk, text_v=tv,
              text_bias=bias)
    _build.reset_launches()
    got = sta_pipe_attention(q, k, v, active, **kw)
    assert _build.launches["sta_pipe_wgmma"] == 1
    _close(got, sta_pipe_attention_ref(q, k, v, active, **kw))
    assert not got[:, 1].any()


def test_sta_rule_leaves_the_rest_on_mma_sync(card):
    """Runs of 18 tokens over 6 rows cannot land on 8-row multiples, D = 64
    is not the path's, nor are the stable softmax, a variant or int8 QK:
    each runs on mma.sync, counted in sta_pipe only, and agrees."""
    g = torch.Generator(device=card).manual_seed(43)
    cases = [(((8, 6, 30), (2, 3, 6)), 128, {}), (((8, 6, 32), (2, 3, 8)), 64, {}),
             (((8, 6, 32), (2, 3, 8)), 128, dict(softmax="stable")),
             (((8, 6, 32), (2, 3, 8)), 128, dict(variant="sT"))]
    for (latent, tile), d, extra in cases:
        q, k, v = (_randn(g, (1, 2, int(np.prod(latent)), d), torch.bfloat16) for _ in range(3))
        act = torch.ones(2, device=card, dtype=torch.int32)
        kw = dict(latent_shape=latent, tile=tile, **extra)
        _build.reset_launches()
        got = sta_pipe_attention(q, k, v, act, **kw)
        assert (_build.launches["sta_pipe"], _build.launches["sta_pipe_wgmma"]) == (1, 0)
        _close(got, sta_pipe_attention_ref(q, k, v, act, **kw))
    q8 = q.to(torch.int8)
    _build.reset_launches()
    sta_pipe_attention(q8, q8, v, act, latent_shape=(8, 6, 32), tile=(2, 3, 8),
                       qk_scale=torch.ones(2, device=card) / 127.0**2)
    assert (_build.launches["sta_pipe_int8"], _build.launches["sta_pipe_wgmma"]) == (1, 0)


# --- sta_window's and sta_batched's Hopper paths ----------------------------------------

@pytest.mark.parametrize("latent,lt", [((20, 45, 80), 0), ((12, 45, 80), 256)])
def test_sta_window_hopper_path_at_the_served_geometries(card, latent, lt):
    """Wan 720p x 77f and HunyuanVideo 45f (83 of 256 text keys valid) at
    tile (4, 9, 10), runs of 30 read as boxes of 32: two heads, one inactive
    (zeros), against the plain version; the mma.sync kernel agrees."""
    from vorta_tpu_torch.ops.sta_window import (
        sta_window_attention,
        sta_window_attention_mma_sync,
        sta_window_attention_ref,
        window_box,
    )

    tile = (4, 9, 10)
    assert window_box(latent, tile) == (32, 1)
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(44)
    q, k, v = (_randn(g, (1, 2, s, 128), torch.bfloat16) for _ in range(3))
    active = torch.tensor([1, 0], device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=128**-0.5)
    if lt:
        kw.update(text_k=_randn(g, (1, 2, lt, 128), torch.bfloat16),
                  text_v=_randn(g, (1, 2, lt, 128), torch.bfloat16),
                  text_bias=torch.where(torch.arange(lt, device=card) < 83, 0.0, -1e30)[None])
    _build.reset_launches()
    got = sta_window_attention(q, k, v, active, **kw)
    assert (_build.launches["sta_window"], _build.launches["sta_window_wgmma"]) == (1, 1)
    want = sta_window_attention_ref(q, k, v, active, **kw)
    _close(got, want)
    assert not got[:, 1].any()
    _close(sta_window_attention_mma_sync(q, k, v, active, **kw), want)
    assert (_build.launches["sta_window"], _build.launches["sta_window_wgmma"]) == (2, 1)


@pytest.mark.parametrize("latent,tile", [((4, 9, 80), (4, 9, 10)), ((8, 18, 40), (4, 9, 10)),
                                         ((4, 8, 45), (2, 4, 9))])
def test_sta_window_hopper_path_masks_the_padded_columns(card, latent, tile):
    """Inside the grid the padded columns of each run (2 of 30, or 5 of an
    odd 27, 4 runs a box) are the next tile's first tokens: the first 2 of
    each tile have 8x larger keys, so that a score that leaked into a row's
    max or sum would show; at the grid's edge TMA reads zeros there; every q
    tile (corners clamped, interior) against the plain version, the stable
    softmax's scale 1.3 / sqrt(128)."""
    from vorta_tpu_torch.ops.layout import tile_sequence
    from vorta_tpu_torch.ops.sta_window import sta_window_attention, sta_window_attention_ref

    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(45)
    q, k, v = (_randn(g, (2, 2, s, 128), torch.bfloat16) for _ in range(3))
    w = torch.arange(s, device=card) % latent[2]
    k = torch.where((w % tile[2] < 2)[None, None, :, None], 8 * k, k)  # each tile's first 2
    active = torch.ones(2, device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=1.3 * 128**-0.5)
    _build.reset_launches()
    got = sta_window_attention(q, k, v, active, **kw)
    assert _build.launches["sta_window_wgmma"] == 1
    want = sta_window_attention_ref(q, k, v, active, **kw)
    tpt = int(np.prod(tile))
    n = s // tpt
    gt, wt = (tile_sequence(x, latent, tile).reshape(2, 2, n, tpt, 128) for x in (got, want))
    for t in range(n):
        _close(gt[:, :, t], wt[:, :, t])


def test_sta_window_hopper_rule_leaves_the_rest_on_mma_sync(card):
    """Runs of 6 over 2 planes (padded to 8: a box not built), D = 64: the
    mma.sync kernel, counted in sta_window only, and it agrees."""
    from vorta_tpu_torch.ops.sta_window import sta_window_attention, sta_window_attention_ref

    g = torch.Generator(device=card).manual_seed(46)
    for latent, tile, d in (((4, 8, 8), (2, 2, 2), 128), ((4, 9, 80), (4, 9, 10), 64)):
        q, k, v = (_randn(g, (1, 2, int(np.prod(latent)), d), torch.bfloat16) for _ in range(3))
        act = torch.ones(2, device=card, dtype=torch.int32)
        kw = dict(latent_shape=latent, tile=tile)
        _build.reset_launches()
        got = sta_window_attention(q, k, v, act, **kw)
        assert (_build.launches["sta_window"], _build.launches["sta_window_wgmma"]) == (1, 0)
        _close(got, sta_window_attention_ref(q, k, v, act, **kw))


def _hy_298_case(card, latent, text_len, valid, heads, seed):
    lay, (ki, kc, bits), bias, tpt = _joint_sta_case(latent, (2, 9, 8), text_len, card, valid,
                                                     lowres_window=(2, 3, 2))
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (_randn(g, (1, heads, lay.total, 128), torch.bfloat16) for _ in range(3))
    kw = dict(pair_bits=bits, tokens_per_tile=tpt, kv_bias=bias, scale=128**-0.5,
              block_q=lay.block_q, block_kv=lay.block_kv, softmax="fast")
    return (q, k, v, ki, kc), kw


def test_sta_batched_hopper_path_at_the_served_geometry(card):
    """HunyuanVideo 720p x 45f at tile (2, 9, 8): the joint layout
    (1, 2, 48384, 128), blocks 432 / 1008, pair bits, 83 of 256 text tokens
    valid, one head routed away; against the plain version, and the
    mma.sync kernel agrees."""
    from vorta_tpu_torch.ops.sta_batched import (
        sta_flash_headbatched,
        sta_flash_headbatched_mma_sync,
        sta_flash_headbatched_ref,
    )

    args, kw = _hy_298_case(card, (12, 45, 80), 256, 83, 2, 47)
    active = torch.tensor([1, 0], device=card, dtype=torch.int32)
    _build.reset_launches()
    got = sta_flash_headbatched(*args, active, **kw)
    assert (_build.launches["sta_batched"], _build.launches["sta_batched_wgmma"]) == (1, 1)
    want = sta_flash_headbatched_ref(*args, active, **kw)
    _close(got, want)
    assert not got[:, 1].any()
    _close(sta_flash_headbatched_mma_sync(*args, active, **kw), want)
    assert _build.launches["sta_batched_wgmma"] == 1


def test_sta_batched_hopper_path_bias_and_counts(card):
    """A q block with count 0 (zeros), a bias that masks every key of some
    128-key slots (those slots skipped), and tables without pair bits or
    bias: each against the plain version."""
    from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched, sta_flash_headbatched_ref

    (q, k, v, ki, kc), kw = _hy_298_case(card, (4, 18, 16), 24, 17, 3, 48)
    active = torch.tensor([1, 1, 0], device=card, dtype=torch.int32)
    kc = kc.clone()
    kc[0, 1] = 0
    bias = kw["kv_bias"].clone()
    bias[:, 200:600] = -1e30  # the third and fourth slots of kv block 0, whole
    bias[:, 1008 + 130:1008 + 140] = -1e30
    for extra in (dict(kv_bias=bias), dict(pair_bits=None, kv_bias=None)):
        kwe = {**kw, **extra}
        _build.reset_launches()
        got = sta_flash_headbatched(q, k, v, ki, kc, active, **kwe)
        assert _build.launches["sta_batched_wgmma"] == 1
        _close(got, sta_flash_headbatched_ref(q, k, v, ki, kc, active, **kwe))
        assert not got[:, 2].any()
        assert not got[:, :, kw["block_q"]:2 * kw["block_q"]].any()  # q block 1: count 0


def test_sta_batched_hopper_rule_leaves_the_rest_on_mma_sync(card):
    """hunyuan-tiny's 8-token tiles, the stable softmax and D = 64 take the
    mma.sync kernel, counted in sta_batched only, and agree."""
    from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched, sta_flash_headbatched_ref

    g = torch.Generator(device=card).manual_seed(49)
    for latent, tile, d, softmax in (((4, 6, 16), (2, 2, 2), 128, "fast"),
                                     ((4, 18, 16), (2, 9, 8), 128, "stable"),
                                     ((4, 18, 16), (2, 9, 8), 64, "fast")):
        lay, (ki, kc, bits), bias, tpt = _joint_sta_case(latent, tile, 24, card)
        q, k, v = (_randn(g, (1, 2, lay.total, d), torch.bfloat16) for _ in range(3))
        act = torch.ones(2, device=card, dtype=torch.int32)
        kw = dict(pair_bits=bits, tokens_per_tile=tpt, kv_bias=bias, block_q=lay.block_q,
                  block_kv=lay.block_kv, softmax=softmax)
        _build.reset_launches()
        got = sta_flash_headbatched(q, k, v, ki, kc, act, **kw)
        assert (_build.launches["sta_batched"], _build.launches["sta_batched_wgmma"]) == (1, 0)
        _close(got, sta_flash_headbatched_ref(q, k, v, ki, kc, act, **kw))


# --- the warp-per-row norm --------------------------------------------------------------

@pytest.mark.parametrize("dim", [1536, 3072, 5120, 1000])
@pytest.mark.parametrize("mod,affine,rms,out_f32", [
    ("f32", False, False, False),    # AdaLN, as the models call it
    ("bf16", True, False, True),
    (None, True, True, False),
    ("f32", True, True, True),
    (None, False, False, False),
])
def test_norm_rows_kernel_matches_plain(card, dim, mod, affine, rms, out_f32):
    """Dims 1,536 / 3,072 (one warp a row) and 5,120 (two warps) on the
    warp-per-row kernel, 1,000 on the block-per-row one; the modulation as
    AdaLN passes it, column slices of a (B, 6, dim) tensor read in place."""
    assert (norm_layout(dim) is None) == (dim == 1000)
    b, s = 2, 331  # rows that leave the last block part-filled
    g = torch.Generator(device=card).manual_seed(44)
    x = (_randn(g, (b, s, dim), torch.float32, 3.0) + 0.5).to(torch.bfloat16)
    sc = sh = gamma = beta = None
    if mod:
        m = (0.3 * torch.randn((b, 6, dim), generator=g, device=card)).to(
            torch.float32 if mod == "f32" else torch.bfloat16)
        sc, sh = m[:, 1], m[:, 0]
    if affine:
        gamma = 1 + 0.1 * torch.randn(dim, generator=g, device=card)
        beta = 0.1 * torch.randn(dim, generator=g, device=card)
    _build.reset_launches()
    got = fused_norm(x, sc, sh, gamma, beta, rms, 1e-6, out_f32)
    assert _build.launches["fused_norm"] == 1
    assert got.dtype == (torch.float32 if out_f32 else torch.bfloat16)
    _close(got, _norm_ref(x, sc, sh, gamma, beta, rms=rms, eps=1e-6, out_f32=out_f32))


# --- the prologue's warp-per-row kernel ----------------------------------------------

def _bf16_ulps(a, b):
    """max |a - b| in bf16 ulps of the larger of the two, element by element."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return ((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max().item()


def _check_prologue_rows(card, b, s, h, strided, qk_norm, norm_scope, seed):
    """The warp-per-row kernel on (b, s, h * 128) against the plain version
    and the block-per-row kernel (v bitwise), and its normalised values
    (read through an identity rotation) within one bf16 ulp of the
    block-per-row kernel's: only the order of the sums of squares differs;
    the last 24 rows are text-like rows, cos = 1 and sin = 0."""
    from vorta_tpu_torch.ops.prologue import fused_qk_prologue_block, prologue_layout

    d, dt = 128, torch.bfloat16
    dim = h * d
    assert prologue_layout(dim, h) is not None
    g = torch.Generator(device=card).manual_seed(seed)
    if strided:  # column slices of one fused product, read in place
        q, k, v = _randn(g, (b, s, 3 * dim + 256), dt, 3.0)[..., :3 * dim].split(dim, dim=-1)
    else:
        q, k, v = (_randn(g, (b, s, dim), dt, 3.0) for _ in range(3))
    gq, gk = (1 + 0.1 * torch.randn(dim, generator=g, device=card) for _ in range(2))
    ang = torch.rand((s, d // 2), generator=g, device=card) * 6.28
    cos, sin = ang.cos(), ang.sin()
    cos[-24:], sin[-24:] = 1.0, 0.0
    kw = dict(num_heads=h, eps=1e-6, qk_norm=qk_norm, norm_scope=norm_scope)
    _build.reset_launches()
    got = fused_qk_prologue(q, k, v, gq, gk, cos, sin, **kw)
    assert (_build.launches["prologue"], _build.launches["prologue_rows"]) == (1, 1)
    old = fused_qk_prologue_block(q, k, v, gq, gk, cos, sin, **kw)
    assert (_build.launches["prologue"], _build.launches["prologue_rows"]) == (2, 1)
    want = _prologue_ref(q, k, v, gq, gk, cos, sin, **kw)
    for a, w, o in zip(got[:2], want[:2], old[:2]):
        assert a.shape == (b, h, s, d) and a.dtype == dt
        _close(a, w)
        _close(a, o)
    assert torch.equal(got[2], want[2]) and torch.equal(got[2], old[2])
    one, zero = torch.ones_like(cos), torch.zeros_like(sin)
    normed = fused_qk_prologue(q, k, v, gq, gk, one, zero, **kw)
    normed_old = fused_qk_prologue_block(q, k, v, gq, gk, one, zero, **kw)
    assert max(_bf16_ulps(a, o) for a, o in zip(normed[:2], normed_old[:2])) <= 1


@pytest.mark.parametrize("norm_scope", ["row", "head"])
@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("h", [2, 12, 24, 40])
def test_prologue_rows_kernel_matches_plain_and_block(card, h, strided, qk_norm, norm_scope):
    """12 / 24 / 40 heads of 128 (Wan-1.3B, HunyuanVideo, Wan-14B: layouts
    (1, 6), (2, 6), (4, 5)) and 2 ((1, 1)); B = 2 and S = 333, rows that no
    CTA's row groups divide."""
    _check_prologue_rows(card, 2, 333, h, strided, qk_norm, norm_scope, 60)


@pytest.mark.parametrize("h,norm_scope", [(12, "row"), (24, "head"), (40, "row")])
def test_prologue_rows_kernel_walks_many_rows(card, h, norm_scope):
    """More rows than the grid's row groups: each warp walks many rows, the
    next row's loads in flight while the current one is written."""
    _check_prologue_rows(card, 1, 20_011, h, True, True, norm_scope, 61)


def test_prologue_rows_layout_mismatch_raises(card, monkeypatch):
    """The C entry holds the wrapper's layout against its own: a layout the
    C rule does not give is refused (an error, never a fallback)."""
    from vorta_tpu_torch.ops import prologue

    x = torch.zeros((1, 16, 1536), device=card, dtype=torch.bfloat16)
    cs = torch.ones((16, 64), device=card)
    monkeypatch.setattr(prologue, "prologue_layout", lambda dim, heads, itemsize=2: (2, 3))
    with pytest.raises(RuntimeError, match="prologue: CUDA error"):
        prologue.fused_qk_prologue(x, x, x, None, None, cs, cs, num_heads=12)


# --- sta_row's Hopper path ----------------------------------------------------------

def _check_row_hopper(card, latent, tile, lt, valid, seed):
    from vorta_tpu_torch.ops.sta_row import (
        row_wgmma_path,
        sta_row_attention,
        sta_row_attention_mma_sync,
        sta_row_attention_ref,
    )

    assert row_wgmma_path(128, latent, tile, text_len=lt)
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (_randn(g, (1, 3, s, 128), torch.bfloat16) for _ in range(3))
    active = torch.tensor([1, 0, 1], device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=1.2 * 128**-0.5)
    if lt:
        kw.update(text_k=_randn(g, (1, 3, lt, 128), torch.bfloat16),
                  text_v=_randn(g, (1, 3, lt, 128), torch.bfloat16),
                  text_bias=torch.where(torch.arange(lt, device=card) < valid, 0.0, -1e30)[None])
    _build.reset_launches()
    got = sta_row_attention(q, k, v, active, **kw)
    assert (_build.launches["sta_row"], _build.launches["sta_row_wgmma"]) == (1, 1)
    want = sta_row_attention_ref(q, k, v, active, **kw)
    _close(got, want)
    assert not got[:, 1].any()
    mma = sta_row_attention_mma_sync(q, k, v, active, **kw)
    assert (_build.launches["sta_row"], _build.launches["sta_row_wgmma"]) == (2, 1)
    _close(mma, want)
    _close(got, mma)


@pytest.mark.parametrize("lt", [0, 24])
@pytest.mark.parametrize("latent,tile", [
    ((4, 6, 32), (2, 3, 8)),      # 4 w tiles a row
    ((8, 6, 48), (2, 3, 16)),     # tile_w 16: runs of 48, two a box
    ((2, 6, 40), (2, 3, 8)),      # one t tile: the window clamps to it
    ((10, 18, 32), (5, 9, 8)),    # Wan 720p's tile, windows clamped on every axis
])
def test_sta_row_hopper_path_matches_plain_and_mma_sync(card, latent, tile, lt):
    """Batch 1, three heads, head 1 inactive (zeros); with and without a text
    tail of 24 keys (17 valid); the mma.sync kernel agrees."""
    _check_row_hopper(card, latent, tile, lt, 17, 62)


@pytest.mark.parametrize("latent,tile,lt", [
    ((20, 45, 80), (5, 9, 8), 0),      # Wan 720p x 77f
    ((12, 45, 80), (6, 9, 8), 256),    # HunyuanVideo 720p x 45f, 83 of 256 text keys valid
])
def test_sta_row_hopper_path_at_full_width(card, latent, tile, lt):
    _check_row_hopper(card, latent, tile, lt, 83, 63)


def test_sta_row_rule_mismatch_raises(card, monkeypatch):
    """The C entry holds the Hopper path to its shapes: D = 64 that the rule
    is made to give it is refused (an error, never a fallback)."""
    from vorta_tpu_torch.ops import sta_row

    q = torch.zeros((1, 2, 4 * 6 * 32, 64), device=card, dtype=torch.bfloat16)
    monkeypatch.setattr(sta_row, "row_wgmma_path", lambda *a, **k: True)
    with pytest.raises(RuntimeError, match="sta_row: CUDA error"):
        sta_row.sta_row_attention(q, q, q, torch.ones(2, device=card, dtype=torch.int32),
                                  latent_shape=(4, 6, 32), tile=(2, 3, 8))


# --- the step cache, the checkpoint importer and I2V ---------------------------------

@pytest.mark.parametrize("nk,hopper", [(257, True), (1, False), (129, True), (512, True)])
def test_padded_dense_attention_kv_tails(card, nk, hopper):
    """Cross-attention to 257 image tokens (block_kv 512, kv_valid_len 257:
    one valid key in the third 128-key slot, a fourth all padding), 1, 129
    and 512 keys: the plain version on the same inputs, the Hopper path
    where its rule holds (blocks of 128), no row seeing a padded key (the
    padded keys' values are huge, so any weight on them would show)."""
    from vorta_tpu_torch.ops.experts import padded_dense_attention

    g = torch.Generator(device=card).manual_seed(nk)
    q, k, v = (_randn(g, (1, 4, 2100, 128), torch.bfloat16),
               _randn(g, (1, 4, nk, 128), torch.bfloat16),
               _randn(g, (1, 4, nk, 128), torch.bfloat16))
    _build.reset_launches()
    got = padded_dense_attention(q, k, v)
    torch.cuda.synchronize()
    assert (_build.launches["flash"], _build.launches["flash_wgmma"]) == (1, int(hopper))
    want = padded_dense_attention(q.cpu(), k.cpu(), v.cpu()).to(card)
    _close(got, want)
    sdpa = torch.nn.functional.scaled_dot_product_attention(q.float(), k.float(), v.float())
    assert (got.float() - sdpa).abs().max().item() <= 2.0**-5 * sdpa.abs().max().item()


@pytest.mark.parametrize("b,s,dim,n", [(1, 4000, 3072, 1440), (2, 700, 3072, 100),
                                       (2, 300, 1536, 17), (2, 90, 128, 16)])
def test_token_replace_norm_two_row_ranges(card, b, s, dim, n):
    """HunyuanVideo's token-replace norm: the kernel over the first n rows
    with one modulation and the rest with another, into one output (views
    whose batches lie s rows apart: no copy), against the plain norm with a
    per-row select between the two modulations; counted as ranges."""
    from vorta_tpu_torch.models.common import FP32LayerNorm

    g = torch.Generator(device=card).manual_seed(s)
    x = (_randn(g, (b, s, dim), torch.float32, 2.0) + 0.3).to(torch.bfloat16)
    mod = (0.3 * torch.randn((b, 6 * dim), generator=g, device=card)).chunk(6, dim=-1)
    norm = FP32LayerNorm(dim, 1e-6, device=card)
    out = torch.empty_like(x)
    _build.reset_launches()
    norm.modulated(x[:, :n], mod[1], mod[0], out=out[:, :n])
    norm.modulated(x[:, n:], mod[4], mod[3], out=out[:, n:])
    assert (_build.launches["fused_norm"], _build.launches["fused_norm_range"]) == (2, 2)
    first = (torch.arange(s, device=card) < n)[None, :, None]
    want = torch.where(first, _norm_ref(x, mod[1], mod[0], None, None, rms=False, eps=1e-6,
                                        out_f32=False),
                       _norm_ref(x, mod[4], mod[3], None, None, rms=False, eps=1e-6,
                                 out_f32=False))
    _close(out, want)
    with pytest.raises(ValueError, match="out strides"):
        fused_norm(x[:, :n], mod[1], mod[0], None, None, False, 1e-6, False,
                   out=torch.empty((b, n, dim + 8), dtype=x.dtype, device=card)[..., :dim])


def test_token_replace_hunyuan_on_card_matches_cpu(card):
    """A 1 + 1-block token-replace model at head dim 128, routing off: card
    vs CPU, rel L2 below 0.05; the norm's two row ranges counted (three
    video norms a forward run as two ranges each)."""
    from vorta_tpu_torch.config import AttentionConfig
    from vorta_tpu_torch.models.hunyuan import HunyuanModel

    cfg = dataclasses.replace(_hunyuan_card_cfg(), image_condition_type="token_replace")
    attn = AttentionConfig(latent_shape=(4, 6, 16), block_q=32, block_kv=32)
    cpu = HunyuanModel(cfg, dtype=torch.float32, device="cpu", seed=6)
    gpu = HunyuanModel(cfg, dtype=torch.bfloat16, device=card, seed=6)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(8)
    args = (torch.randn((1, 4, 12, 32, 16), generator=gen), torch.tensor([600.0]),
            torch.randn((1, 24, 64), generator=gen), (torch.arange(24) < 17)[None],
            torch.randn((1, 32), generator=gen))
    kw = dict(guidance=torch.tensor([6000.0]), attn_cfg=attn)
    _build.reset_launches()
    with torch.inference_mode():
        got = gpu(*(x.to(card) for x in args), guidance=kw["guidance"].to(card),
                  attn_cfg=attn).sample.float().cpu()
        launches = dict(_build.launches)
        want = cpu(*args, **kw).sample
    assert launches == {**dict.fromkeys(_build.KERNELS, 0), "flash_manual": 2, "prologue": 2,
                        "fused_norm": 9, "fused_norm_range": 6}
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 0.05


def test_cached_trajectory_launches_on_card(card):
    """4 Euler steps with CFG (8 forwards) at a threshold that skips the two
    middle steps: exactly the computed forwards' kernels (flash, the
    prologue, the norms), the skipped ones only the head's norm; the
    trajectory against the CPU's, the same skips."""
    from vorta_tpu_torch.config import WAN_TINY, AttentionConfig
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.pipelines.wan_t2v import SamplingConfig, WanT2VPipeline

    cfg = dataclasses.replace(WAN_TINY, dim=256, ffn_dim=512, num_heads=2, head_dim=128,
                              text_dim=64, text_len=16, freq_dim=64)
    attn = AttentionConfig(latent_shape=(4, 8, 8), block_q=64, block_kv=64)
    cpu = WanModel(cfg, dtype=torch.float32, device="cpu", seed=2)
    gpu = WanModel(cfg, dtype=torch.bfloat16, device=card, seed=2)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(3)
    lat = torch.randn((1, 4, 16, 16, 16), generator=gen)
    pe, ne = torch.randn((1, 16, 64), generator=gen), torch.randn((1, 16, 64), generator=gen)
    sampling = SamplingConfig(num_inference_steps=4, scheduler="euler", cache_threshold=1e9)
    logs = ([], [])
    _build.reset_launches()
    with torch.inference_mode():
        got = WanT2VPipeline(gpu, attn_cfg=attn)(lat.to(card), pe.to(card), ne.to(card),
                                                 sampling=sampling, cache_log=logs[0]).cpu()
        launches = dict(_build.launches)
        want = WanT2VPipeline(cpu, attn_cfg=attn)(lat, pe, ne, sampling=sampling,
                                                  cache_log=logs[1])
    assert logs[0] == logs[1]
    assert [s for *_, s in logs[0]] == [False] * 2 + [True] * 4 + [False] * 2
    n, computed, skipped = cfg.num_layers, 4, 4
    assert launches == {**dict.fromkeys(_build.KERNELS, 0), "flash": 2 * n * computed,
                        "prologue": n * computed, "prologue_rows": n * computed,
                        "fused_norm": (2 * n + 1) * computed + skipped}
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 0.05


def test_importer_loads_onto_the_card(card, tmp_path):
    """A diffusers-format checkpoint (two safetensors shards, bf16) straight
    into a model on the card: every parameter the mapped source tensor, bit
    for bit; the I2V forward runs its image branch on the kernels."""
    from safetensors.torch import save_file

    from vorta_tpu_torch.config import WAN_TINY, AttentionConfig
    from vorta_tpu_torch.io import torch_import as ti
    from vorta_tpu_torch.models.wan import WanModel

    cfg = dataclasses.replace(WAN_TINY, dim=256, ffn_dim=512, num_heads=2, head_dim=128,
                              text_dim=64, text_len=16, freq_dim=64, image_dim=96)
    gen = torch.Generator().manual_seed(4)
    sd = {k: (0.05 * torch.randn(sh, generator=gen)).to(torch.bfloat16)
          for k, sh in ti.wan_expected_shapes(cfg, routers=True).items()}
    keys = sorted(sd)
    (tmp_path / "ckpt").mkdir()
    for i, part in enumerate((keys[::2], keys[1::2])):
        save_file({k: sd[k] for k in part}, str(tmp_path / "ckpt" / f"part-{i}.safetensors"))
    model = WanModel(cfg, dtype=torch.bfloat16, device=card, seed=0)
    applied, missing = ti.load_wan_torch_weights(model, tmp_path / "ckpt")
    assert missing == []
    want = ti.wan_state_dict_to_tree(sd, cfg.num_layers, cfg.head_dim)
    params = model.state_dict()
    assert sorted(applied) == sorted(params)
    for k, v in want.items():
        assert torch.equal(params[k].cpu(), v.to(params[k].dtype)), k
    _build.reset_launches()
    with torch.inference_mode():
        out = model(torch.randn((1, 4, 16, 16, 16), device=card), torch.tensor([500.0], device=card),
                    torch.randn((1, 16, 64), device=card),
                    attn_cfg=AttentionConfig(latent_shape=(4, 8, 8), block_q=64, block_kv=64),
                    image_context=torch.randn((1, 257, 96), device=card)).sample
    assert torch.isfinite(out).all()
    # the image call (block_kv 512) on the Hopper path; the 64-token blocks
    # and the 16 text keys stay on mma.sync
    assert (_build.launches["flash"], _build.launches["flash_wgmma"]) == (
        3 * cfg.num_layers, cfg.num_layers)


# --- prompt to video: the text encoders and VAEs (cuBLAS / cuDNN products, no kernel) -----

def test_chunked_causal_conv_over_2e31_elements(card, monkeypatch):
    """A causal 3 x 3 x 3 conv over (1, 192, 21, 720, 1280) bf16, 3.7e9
    elements (over 2^31), through CausalConv3d's frame chunks: no cuDNN call
    sees more than CHUNK_ELEMENTS, and each output frame equals the conv of
    its own three input frames (zeros before the first), computed apart."""
    import torch.nn.functional as F

    from vorta_tpu_torch.models import wan_vae as wv

    gen = torch.Generator(device="cuda").manual_seed(50)
    conv = wv.CausalConv3d(192, 8, dtype=torch.bfloat16, device=card)
    x = torch.randn((1, 192, 21, 720, 1280), generator=gen, device=card, dtype=torch.bfloat16)
    assert x.numel() > 2**31
    seen, real = [], F.conv3d

    def spy(xi, *args):
        seen.append(xi.numel())
        return real(xi, *args)

    monkeypatch.setattr(wv.F, "conv3d", spy)
    with torch.inference_mode():
        got = conv(x)
        assert len(seen) > 1 and max(seen) <= wv.CHUNK_ELEMENTS
        for t in range(x.shape[2]):
            piece = F.pad(x[:, :, max(0, t - 2):t + 1], (1, 1, 1, 1, max(0, 2 - t), 0))
            _close(got[:, :, t:t + 1], real(piece, conv.conv.weight, conv.conv.bias))


def test_groupnorm_statistics_over_2e31_elements(card):
    """HunyuanVAE's GroupNorm over (1, 128, 21, 720, 1280) bf16, 2.48e9
    elements: the statistics its chunks sum (whole-clip, over (C / G, T, H,
    W)) against each group's own in f64, a group at a time; frames of the
    normalised clip against the plain formula in f64."""
    from vorta_tpu_torch.models.hunyuan_vae import GroupNorm

    gen = torch.Generator(device="cuda").manual_seed(51)
    gn = GroupNorm(128, 32, device=card)
    with torch.no_grad():
        gn.scale.copy_(1 + 0.1 * torch.randn(128, generator=gen, device=card))
        gn.bias.copy_(0.1 * torch.randn(128, generator=gen, device=card))
    x = (2 + torch.randn((1, 128, 21, 720, 1280), generator=gen, device=card)).bfloat16()
    assert x.numel() > 2**31
    with torch.inference_mode():
        mean, mul = gn.stats(x)
        m, v = [], []
        for g in range(32):
            xs = x[:, 4 * g:4 * g + 4].double()
            m.append(xs.mean())
            v.append(xs.var(unbiased=False))
        m = torch.stack(m).repeat_interleave(4)
        v = torch.stack(v).repeat_interleave(4)
        want_mul = torch.rsqrt(v + 1e-6) * gn.scale.double()
        torch.testing.assert_close(mean.flatten().double(), m, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(mul.flatten().double(), want_mul, rtol=1e-4, atol=0)
        got = gn.normalize(x[:, :, 5:7], (mean, mul))
        want = ((x[:, :, 5:7].double() - m[:, None, None, None]) * want_mul[:, None, None, None]
                + gn.bias.double()[:, None, None, None])
        err = (got.double() - want).abs().max().item()
        assert got.dtype == torch.float32 and err <= 1e-4 * want.abs().max().item()


def _encoder(name):
    from vorta_tpu_torch.models import text_encoders as te
    from vorta_tpu_torch.models import umt5

    return {"umt5": (umt5.UMT5Encoder, umt5.UMT5_XXL, lambda m, i, k: m(i, k)),
            "llama": (te.LlamaTextEncoder, te.LLAMA_8B, lambda m, i, k: m(i, k, crop_start=8)),
            "clip": (te.CLIPTextEncoder, te.CLIP_L, lambda m, i, k: m(i))}[name]


@pytest.mark.parametrize("name", ["umt5", "llama", "clip"])
def test_text_encoder_on_card_matches_cpu(card, name):
    """Each encoder at 2 layers and full width (token table cut to 1,024
    rows), 64 tokens with a padded tail: the card in bf16 against the CPU in
    f32 with the same weights, rel L2 < 0.05; UMT5's padded rows zero."""
    cls, cfg, call = _encoder(name)
    small = dataclasses.replace(cfg, num_layers=2, vocab_size=1024)
    cpu = cls(small, dtype=torch.float32, device="cpu", seed=3)
    gpu = cls(small, dtype=torch.bfloat16, device=card, seed=3)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(52)
    ids = torch.randint(3, 1024, (2, 64), generator=gen)
    mask = torch.arange(64)[None] < torch.tensor([[64], [40]])
    with torch.inference_mode():
        got = call(gpu, ids.to(card), mask.to(card)).float().cpu()
        want = call(cpu, ids, mask)
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < 0.05
    if name == "umt5":
        assert (got[1, 40:] == 0).all()


@pytest.mark.parametrize("name", ["wan", "hunyuan"])
def test_vae_on_card_matches_cpu_whole_chunked_and_tiled(card, name):
    """The tiny VAEs: decode on the card (bf16) against the CPU (f32), rel
    L2 < 0.05; chunks of at most 2,000 elements against one call, rel L2 <=
    1e-3; tiled decode (tiles (2, 4, 4), overlaps (1, 2, 2)) against the
    CPU's tiled decode, rel L2 < 0.05, and encode against the CPU."""
    from vorta_tpu_torch.models import hunyuan_vae as hv
    from vorta_tpu_torch.models import wan_vae as wv
    from vorta_tpu_torch.models.vae_tiling import tiled_decode

    cls, cfg = {"wan": (wv.WanVAE, wv.WAN_VAE_TINY),
                "hunyuan": (hv.HunyuanVAE, hv.HUNYUAN_VAE_TINY)}[name]
    cpu = cls(cfg, dtype=torch.float32, device="cpu", seed=4)
    gpu = cls(cfg, dtype=torch.bfloat16, device=card, seed=4)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(53)
    z = torch.randn((1, 3, 6, 7, 16), generator=gen)
    video = torch.randn((1, 9, 16, 24, 3), generator=gen)

    def rel(a, b):
        return ((a.float().cpu() - b).norm() / b.norm()).item()

    with torch.inference_mode():
        whole = gpu.decode(z.to(card))
        assert rel(whole, cpu.decode(z)) < 0.05
        with wv.chunk_budget(2000):
            assert rel(gpu.decode(z.to(card)), whole.float().cpu()) <= 1e-3
        kw = dict(tile_latent=(2, 4, 4), overlap_latent=(1, 2, 2))
        tiled = tiled_decode(lambda zz: gpu.decode(zz, denormalize=False), z.to(card), **kw)
        assert tiled.dtype == torch.float32 and tiled.device.type == "cuda"
        assert rel(tiled, tiled_decode(lambda zz: cpu.decode(zz, denormalize=False), z,
                                       **kw)) < 0.05
        assert rel(gpu.encode(video.to(card))[0], cpu.encode(video)[0]) < 0.05


@pytest.mark.parametrize("model,extra", [("wan-tiny", []), ("hunyuan-tiny", ["--vae_tiling"])])
def test_prompt_to_video_cli_on_card(card, tmp_path, monkeypatch, model, extra):
    """cli.sample --prompt --tokenizer_dir --decode on the card (a stand-in
    tokenizer: the machine may lack the tokenizers package): the frames of
    the JAX CLI's shape as .npy, finite; routed, the DiT's kernels launched."""
    import types

    from vorta_tpu_torch.cli.sample import main
    from vorta_tpu_torch.io import text as text_io

    class StandIn:
        def encode(self, s):
            return types.SimpleNamespace(ids=[3 + len(w) * 7 for w in s.split()])

    monkeypatch.setattr(text_io, "load_tokenizer", lambda path: StandIn())
    size = ["--num_frames", "5", "--height", "32", "--width", "32"] if model == "wan-tiny" \
        else ["--num_frames", "13", "--height", "96", "--width", "320", "--native_attention"]
    _build.reset_launches()
    res = main(["--model", model, "--prompt", "a cat walking", "--tokenizer_dir", "unused",
                "--num_inference_steps", "1", "--decode", "--output",
                str(tmp_path / "v.npy")] + size + extra)
    frames = np.load(res.video)
    want = (5, 32, 32, 3) if model == "wan-tiny" else (13, 96, 320, 3)
    assert frames.shape == want and np.isfinite(frames).all()
    assert res.encode_s > 0 and res.decode_s > 0
    kernel = "flash" if model == "wan-tiny" else "flash_manual"
    assert _build.launches[kernel] > 0


# --- HunyuanVideo router training and sequence parallelism -----------------------------

@pytest.mark.parametrize("case", ["dense", "masks_and_bias"])
def test_chunked_recompute_backward_on_card(card, case):
    """attention_chunked_recompute on CUDA tensors: the forward bit for bit
    the loop's, the q / k / v gradients within 1e-5 x max of autograd
    through the loop (f32, TF32 off), at the joint layouts' block sizes."""
    from vorta_tpu_torch.ops.attention_ref import attention_chunked, attention_chunked_recompute

    g = torch.Generator(device="cuda").manual_seed(81)
    b, h, s, d, blk = 1, 4, 512, 128, 128
    q, k, v = (_randn(g, (b, h, s, d), torch.float32).requires_grad_() for _ in range(3))
    kw = dict(block_q=blk, block_kv=blk)
    if case == "masks_and_bias":
        bm = torch.rand((h, 4, 4), generator=g, device="cuda") < 0.6
        bm[:, :, 0] = True
        bm[2, 3] = False  # a q block that sees no key
        bias = torch.zeros((1, s), device="cuda")
        bias[:, 300:340] = -1e30
        kw.update(block_mask=bm, kv_bias=bias, kv_valid_len=500)
    want = attention_chunked(q, k, v, **kw)
    got = attention_chunked_recompute(q, k, v, **kw)
    assert torch.equal(got, want)
    cot = _randn(g, want.shape, torch.float32)
    for a, w in zip(torch.autograd.grad(got, (q, k, v), cot),
                    torch.autograd.grad(want, (q, k, v), cot)):
        _close(a, w)


def test_collectives_at_world_size_one_on_card(card, tmp_path):
    """A world-size-1 NCCL group (a file:// store): every Ulysses collective
    is the identity, forward and backward, bit for bit; make_mesh takes the
    group, and a second mesh reuses it."""
    import torch.distributed as dist

    from vorta_tpu_torch.parallel import (
        all_to_all_heads_to_seq,
        all_to_all_seq_to_heads,
        gather_sequence,
        make_mesh,
        slice_local,
    )

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(sp_size=1, dp_size=1)
        assert mesh.shape == {"dp": 1, "sp": 1} and mesh.device.type == "cuda"
        g = torch.Generator(device="cuda").manual_seed(82)
        x = _randn(g, (2, 4, 96, 128), torch.bfloat16).requires_grad_()
        cot = _randn(g, x.shape, torch.bfloat16)
        for fn in (lambda a: all_to_all_heads_to_seq(a, mesh.sp_group),
                   lambda a: all_to_all_seq_to_heads(a, mesh.sp_group),
                   lambda a: gather_sequence(a, 2, mesh.sp_group),
                   lambda a: slice_local(a, 1, mesh.sp_group)):
            y = fn(x)
            assert torch.equal(y, x)
            (gx,) = torch.autograd.grad(y, x, cot)
            assert torch.equal(gx, cot)
        with pytest.raises(ValueError, match="not divisible by sp_size 2"):
            make_mesh(sp_size=2)
    finally:
        dist.destroy_process_group()


# --- evaluation and the last entry points (no new kernel) -----------------------------

# Wan-1.3B at full width and depth on a small grid the CLI geometry's tile
# (4, 6, 4) and low-res window (2, 3, 2) divide: 13 frames at 96 x 128 ->
# (4, 6, 8), 192 tokens
SMALL_WAN = ["--model", "wan-1_3B", "--num_frames", "13", "--height", "96", "--width", "128"]


def _wan_off_launches(n):
    return {**dict.fromkeys(_build.KERNELS, 0), "flash": 60 * n, "fused_norm": 61 * n,
            "prologue": 30 * n}


def _wan_routed_launches(tables, skipped=0):
    """Routed Wan launches from the computed forwards' (blocks, heads) ids."""
    t = np.stack(tables)
    has = [(t == e).any(-1) for e in range(3)]
    n = t.shape[0]
    return {**dict.fromkeys(_build.KERNELS, 0), "flash": 30 * n,
            "fused_norm": 61 * n + skipped, "prologue": 30 * n,
            "flash_manual": int(has[0].sum() + has[1].sum()), "sta_pipe": int(has[2].sum()),
            "pool_qkv": int(has[1].sum()), "unpool": int(has[1].sum())}


_TOTALS = ("flash", "fused_norm", "prologue", "flash_manual", "sta_pipe", "pool_qkv", "unpool")


def _totals(launches):
    return {k: launches[k] for k in _TOTALS}


@pytest.mark.parametrize("mm", ["bf16", "int8_static"])
def test_bench_compare_on_card(card, tmp_path, mm):
    """cli.bench_compare at Wan-1.3B on a small grid, 2 UniPC steps with CFG:
    each arm's launches exact (two runs each; the baseline no routed
    kernel), the mix counted from the routing ids, finite metrics; with
    --mm int8_static the 3 calibration forwards outside the arms."""
    from vorta_tpu_torch.cli import bench_compare

    extra = (["--cache_threshold", "0.5", "--cache_warmup", "1", "--tau_sweep", "0.2"]
             if mm == "bf16" else ["--mm", "int8_static"])
    _build.reset_launches()
    res = bench_compare.main(SMALL_WAN + ["--num_inference_steps", "2", "--seed", "3",
                                          "--output_dir", str(tmp_path), *extra])
    total = dict(_build.launches)
    n = 2 * 2 * 2  # two runs x 2 steps x CFG's two forwards
    for arm, got in res.launches.items():
        if arm == "baseline":
            assert _totals(got) == _totals(_wan_off_launches(n))
        else:
            skipped = sum(s for *_, s in res.cache_log[arm])
            assert _totals(got) == _totals(_wan_routed_launches(res.routing[arm], skipped)), arm
    ids = np.stack(res.routing["vorta"][:n // 2])
    assert res.summary["routing_mix"] == {
        k: round(float((ids == e).sum()) / ids.size, 4)
        for e, k in enumerate(("full", "lowres", "sta"))}
    calib = {k: total[k] - sum(a[k] for a in res.launches.values()) for k in _TOTALS}
    want = dict.fromkeys(_TOTALS, 0) if mm == "bf16" else None
    if want is not None:
        assert calib == want
    else:
        assert (calib["flash"], calib["fused_norm"], calib["prologue"]) == (90, 183, 90)
    assert np.isfinite(res.summary["psnr_vorta_vs_baseline_db"])
    assert (tmp_path / "summary.json").exists() and res.latents["vorta"].device.type == "cuda"


def test_fit_cache_poly_and_calibration_on_card(card, tmp_path):
    """fit_cache_poly at Wan-1.3B on a small grid, 6 Euler steps, CFG 5: 5
    points, finite coefficients, 12 routed forwards' launches exact;
    calibrate_wan over two of the model's calibrate_mm forwards is their
    max."""
    from unittest import mock

    from vorta_tpu_torch.tools import calibrate_int8, fit_cache_poly

    tables, built = [], []
    real = fit_cache_poly.WanModel

    def hooked(*a, **kw):
        m = real(*a, **kw)
        m.register_forward_hook(lambda mod, inp, out: tables.append(out.expert_ids))
        built.append(m)
        return m

    _build.reset_launches()
    with mock.patch.object(fit_cache_poly, "WanModel", hooked):
        rec = fit_cache_poly.main(SMALL_WAN + ["--steps", "6", "--guidance_scale", "5",
                                               "--out", str(tmp_path / "p.npz")])
    assert rec["points"] == 5 and np.isfinite(rec["coefficients"]).all()
    assert len(tables) == 12
    assert _totals(dict(_build.launches)) == _totals(_wan_routed_launches(tables))
    model = built[0]
    attn = fit_cache_poly.probe_attention_config("wan-1_3B", (4, 6, 8))
    g = torch.Generator(device=card).manual_seed(9)
    pts = [(torch.randn((1, 4, 12, 16, 16), generator=g, device=card),
            torch.tensor([ts], device=card),
            torch.randn((1, 512, 4096), generator=g, device=card)) for ts in (300.0, 800.0)]

    def call(lat, t, ctx):
        with torch.inference_mode():
            return model(lat, t, ctx, attn_cfg=attn, routing_mode="hard",
                         calibrate_mm=True).mm_calibration

    amax = calibrate_int8.calibrate_wan(call, pts)
    each = [call(*p) for p in pts]
    for k, v in amax.items():
        want = torch.maximum(each[0][k], each[1][k]).cpu().numpy()
        assert v.dtype == np.float32 and np.array_equal(v, want)


@pytest.mark.parametrize("entry", ["bench_compare_wan", "bench_compare_hunyuan",
                                   "fit_cache_poly"])
def test_tiny_models_run_on_the_card_in_f32(card, entry, tmp_path):
    """The tiny models run in f32, as the JAX tools build them, and on the
    card through the kernels' f32 modes: every launch of the path is an f32 one, none on a Hopper
    path, the outputs finite."""
    from vorta_tpu_torch.cli import bench_compare
    from vorta_tpu_torch.tools import fit_cache_poly

    _build.reset_launches()
    if entry == "fit_cache_poly":
        rec = fit_cache_poly.main(["--steps", "4", "--degree", "2",
                                   "--out", str(tmp_path / "poly.npz")])
        assert np.isfinite(rec["coefficients"]).all()
    else:
        model = "wan-tiny" if entry.endswith("wan") else "hunyuan-tiny"
        size = (["--height", "64", "--width", "64"] if model == "wan-tiny"
                else ["--height", "96", "--width", "256"])
        res = bench_compare.main(["--model", model, "--num_inference_steps", "1",
                                  "--num_frames", "13", "--output_dir", str(tmp_path), *size])
        assert all(np.isfinite(a.cpu().numpy()).all() for a in res.latents.values())
    n = _build.launches
    assert n["fused_norm_f32"] == n["fused_norm"] > 0 and n["prologue_f32"] == n["prologue"] > 0
    for k in ("flash", "flash_manual", "sta_pipe", "sta_batched"):
        assert n[f"{k}_f32"] == n[k] and n[f"{k}_wgmma"] == 0, k
    assert n["pool_qkv_f32"] == n["pool_qkv"] + n["pool_qkv_headmap"]
    assert n["unpool_f32"] == n["unpool"] + n["unpool_headmap"]


def test_profiling_counts_match_launches_on_card(card):
    """io/profiling on a routed Wan forward (full width and depth, the small
    grid): every port kernel's device events, by its symbols, equal its
    launch counter."""
    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.io import profiling
    from vorta_tpu_torch.models.wan import WanModel

    model = WanModel(WAN_1_3B, dtype=torch.bfloat16, device=card, seed=4)
    g = torch.Generator(device=card).manual_seed(10)
    lat = torch.randn((1, 4, 12, 16, 16), generator=g, device=card)
    ctx = torch.randn((1, 512, 4096), generator=g, device=card)
    t = torch.tensor([500.0], device=card)
    attn = attention_config("wan-1_3B", (4, 6, 8))

    def fwd():
        with torch.inference_mode():
            model(lat, t, ctx, attn_cfg=attn, routing_mode="hard")

    fwd()
    _build.reset_launches()
    rows = profiling.profile_call(fwd, top=None, warmup=False)
    counts = profiling.kernel_counts(rows)
    launches = dict(_build.launches)
    for counter in set(profiling.SYMBOL_COUNTERS.values()):
        assert counts.get(counter, 0) == launches[counter], counter
    assert launches["flash"] == 30 and sum(n for *_, n in rows) > sum(counts.values())


def test_sample_batch_flags_on_card(card, tmp_path):
    """cli.sample --prompt_embeds_dir (a .npy and a .pt) with --cfg_batch and
    --negative_prompt_embeds on the card; --skip_existing skips the second
    run's files."""
    from vorta_tpu_torch.cli.sample import main

    src = tmp_path / "embeds"
    src.mkdir()
    rng = np.random.default_rng(5)
    np.save(src / "a.npy", rng.standard_normal((8, 32)).astype(np.float32))
    torch.save(torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)), src / "b.pt")
    np.save(tmp_path / "neg.npy", rng.standard_normal((16, 32)).astype(np.float32))
    argv = ["--model", "wan-tiny", "--num_frames", "13", "--height", "64", "--width", "64",
            "--num_inference_steps", "2", "--prompt_embeds_dir", str(src), "--cfg_batch",
            "--negative_prompt_embeds", str(tmp_path / "neg.npy"), "--skip_existing",
            "--output", str(tmp_path / "out")]
    res = main(argv)
    assert len(res) == 2 and all(len(r.routing) == 2 for r in res)  # one forward a step
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["a.npy", "b.npy"]
    assert all(np.isfinite(np.load(tmp_path / "out" / n)).all() for n in ("a.npy", "b.npy"))
    assert main(argv) == []



# --- the f32 modes of the f32 serving path ------------------------------------------
# Each f32 mode against its plain version on the same f32 inputs, TF32 off
# (the card fixture): attention and the norm / prologue within _close's f32
# rule (1e-5 x max |plain|, tighter than the smoke's 1e-4 and 1e-5 x
# max(|plain|, RMS)), pool and unpool bit for bit.


def _f32(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,block,seq,valid", [
    ("dense", 8, 64, 60),        # 8-row blocks: a CTA of 8 rows
    ("per_head", 16, 96, 90),    # wan-tiny's blocks, count-0 q blocks, a tail
    ("shared", 96, 384, 380),    # two 64-row parts, the second of 32
    ("dense", 1024, 2048, 1500),
])
def test_flash_f32_matches_plain(card, d, kind, block, seq, valid):
    g = torch.Generator(device=card).manual_seed(40)
    q, k, v = (_f32(g, 2, 3, seq, d) for _ in range(3))
    ki, kc = _tables(kind, 3, seq // block, seq // block).on(card)
    kw = dict(block_q=block, block_kv=block, kv_valid_len=valid, scale=1.1 * d**-0.5)
    _build.reset_launches()
    got = sparse_flash_attention_raw(q, k, v, ki, kc, **kw)
    assert (_build.launches["flash"], _build.launches["flash_f32"],
            _build.launches["flash_wgmma"]) == (1, 1, 0)
    _close(got, sparse_flash_attention_ref(q, k, v, ki, kc, **kw))
    if kind != "dense":
        assert not got[:, :, :block].any()


@pytest.mark.parametrize("softmax", ["fast", "stable"])
@pytest.mark.parametrize("d,block,bias", [(64, 8, True), (128, 16, False), (128, 32, True),
                                         (64, 256, True)])
def test_flash_manual_f32_matches_plain(card, softmax, d, block, bias):
    """kv_bias (-1e30 on some keys) with kv_valid_len, per-head counts with a
    head routed away (count 0 rows write 0)."""
    g = torch.Generator(device=card).manual_seed(41)
    s, h = 512, 3
    q, k, v = (_f32(g, 1, h, s, d) for _ in range(3))
    ki, kc = _tables("shared", h, s // block, s // block).on(card)
    counts = kc.expand(h, -1).clone()
    counts[1] = 0
    kb = None
    if bias:
        kb = torch.where(torch.rand((1, s), generator=g, device=card) < 0.2, -1e30,
                         _f32(g, 1, s))
    kw = dict(block_q=block, block_kv=block, kv_valid_len=s - 5, kv_bias=kb, softmax=softmax,
              scale=0.9 * d**-0.5)
    _build.reset_launches()
    got = sparse_flash_attention_manual(q, k, v, ki, counts, **kw)
    assert (_build.launches["flash_manual_f32"], _build.launches["flash_manual_stable"]) == \
        (1, int(softmax == "stable"))
    _close(got, sparse_flash_attention_manual_ref(q, k, v, ki, counts, **kw))
    assert not got[:, 1].any()


@pytest.mark.parametrize("softmax", ["fast", "stable"])
@pytest.mark.parametrize("latent,tile,window,d,text", [
    ((4, 4, 4), (2, 2, 2), (3, 3, 1), 64, 0),      # wan-tiny's window
    ((4, 6, 16), (2, 3, 8), (3, 3, 3), 128, 24),   # a 48-token tile, the text tail
    ((6, 9, 16), (6, 9, 8), (3, 3, 3), 128, 256),  # 432-token tiles: 7 parts of 64 rows
    ((8, 6, 20), (2, 3, 4), (3, 3, 3), 64, 8),     # tile_w 4
])
def test_sta_pipe_f32_matches_plain(card, softmax, latent, tile, window, d, text):
    g = torch.Generator(device=card).manual_seed(42)
    n = latent[0] * latent[1] * latent[2]
    q, k, v = (_f32(g, 1, 3, n, d) for _ in range(3))
    act = torch.tensor([1, 0, 1], device=card)
    kw = dict(latent_shape=latent, tile=tile, window=window, softmax=softmax, scale=d**-0.5)
    if text:
        kw.update(text_k=_f32(g, 1, 3, text, d), text_v=_f32(g, 1, 3, text, d),
                  text_bias=torch.where(torch.arange(text, device=card) < text - 3, 0.0,
                                        -1e30)[None])
    _build.reset_launches()
    got = sta_pipe_attention(q, k, v, act, **kw)
    assert (_build.launches["sta_pipe_f32"], _build.launches["sta_pipe_wgmma"]) == (1, 0)
    _close(got, sta_pipe_attention_ref(q, k, v, act, **kw))
    assert not got[:, 1].any()


@pytest.mark.parametrize("softmax", ["fast", "stable"])
@pytest.mark.parametrize("latent,text_len,d", [((4, 6, 16), 24, 64), ((4, 4, 8), 24, 128)])
def test_sta_batched_f32_matches_plain(card, softmax, latent, text_len, d):
    """hunyuan-tiny's joint layout: 8-token tiles (blocks 40 / 48), pair bits,
    all-ones text blocks and the text bias; gated on the rows callers read."""
    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.ops import joint_experts as joint
    from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched, sta_flash_headbatched_ref

    cfg = attention_config("hunyuan-tiny", latent)
    jcfg = joint.JointConfig(cfg, text_len)
    lay = joint.joint_layouts(jcfg)["sta"]
    ki, kc, bits = joint._joint_sta_tables(jcfg).on(card)
    mask = (torch.arange(text_len, device=card) < 17)[None]
    bias = joint._bias(mask, lay, cfg.seq_len)
    g = torch.Generator(device=card).manual_seed(43)
    q, k, v = (_f32(g, 1, 3, lay.total, d) for _ in range(3))
    act = torch.tensor([1, 0, 1], device=card)
    kw = dict(pair_bits=bits, tokens_per_tile=8, kv_bias=bias, block_q=lay.block_q,
              block_kv=lay.block_kv, softmax=softmax, scale=d**-0.5)
    _build.reset_launches()
    got = sta_flash_headbatched(q, k, v, ki, kc, act, **kw)
    assert (_build.launches["sta_batched_f32"], _build.launches["sta_batched_wgmma"]) == (1, 0)
    rows = torch.cat([torch.arange(cfg.seq_len, device=card),
                      lay.text_off + torch.arange(17, device=card)])
    want = sta_flash_headbatched_ref(q, k, v, ki, kc, act, **kw)
    _close(got[:, :, rows], want[:, :, rows])
    assert not got[:, 1].any()


# --- the window-dense kernels in f32 and the int8 QK modes with an f32 v ----------------

WINDOW_F32_CASES = [  # (latent, tile, text keys): tile_w 8-aligned, 10 (360-token tiles:
    ((4, 6, 32), (2, 3, 8), 0),      # 5 parts of 64 rows and one of 40), clamping; text
    ((4, 9, 80), (4, 9, 10), 24),    # tails of 24 and 88 keys (not multiples of 64)
    ((6, 4, 30), (2, 2, 10), 88),
    ((4, 4, 8), (2, 2, 8), 0),       # the window spans every axis
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kernel,latent,tile,lt", [
    (kernel, *case) for kernel in ("sta_window", "sta_row") for case in WINDOW_F32_CASES
    if kernel == "sta_window" or case[1][2] % 8 == 0])  # sta_row: tile_w multiples of 8
def test_window_dense_f32_matches_plain(card, d, kernel, latent, tile, lt):
    """sta_window's and sta_row's f32 modes (the f32 core over the window
    walk, the stable softmax) against their plain version, with and without
    the text tail (a few keys masked by the bias), head 1 inactive (zeros);
    counted as <kernel> and <kernel>_f32, never on the Hopper path."""
    from vorta_tpu_torch.ops import sta_row, sta_window

    mod = sta_window if kernel == "sta_window" else sta_row
    fn, plain = getattr(mod, f"{kernel}_attention"), getattr(mod, f"{kernel}_attention_ref")
    g = torch.Generator(device=card).manual_seed(43)
    n = int(np.prod(latent))
    q, k, v = (_f32(g, 2, 3, n, d) for _ in range(3))
    act = torch.tensor([1, 0, 1], device=card)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=1.1 * d**-0.5)
    if lt:
        kw.update(text_k=_f32(g, 2, 3, lt, d), text_v=_f32(g, 2, 3, lt, d),
                  text_bias=torch.where(torch.arange(lt, device=card) < lt - 5, 0.0,
                                        -1e30)[None])
    _build.reset_launches()
    got = fn(q, k, v, act, **kw)
    assert (_build.launches[kernel], _build.launches[f"{kernel}_f32"],
            _build.launches[f"{kernel}_wgmma"]) == (1, 1, 0)
    _close(got, plain(q, k, v, act, **kw))
    assert not got[:, 1].any()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block_q,block_kv,sq,skv,valid,with_bias", [
    (32, 32, 128, 128, 100, False),         # small blocks, the tail rule
    (1024, 1024, 2048, 2048, 1500, False),  # the routed experts' blocks
    (1024, 1024, 2048, 2048, None, True),   # the joint layouts: kv_bias
    (96, 96, 384, 384, 380, True),          # 64-row parts: the second of 32
])
def test_flash_manual_int8_f32_v_matches_plain(card, d, block_q, block_kv, sq, skv, valid,
                                               with_bias):
    """The int8 QK mode with an f32 v on the same int8 q / k as the plain
    version (exact int32 scores on both sides), a head routed away; counted
    as flash_manual, flash_manual_f32 and flash_manual_int8, and as
    flash_manual_int8_tc where f32_tc_path holds (the tensor-core kernel)."""
    b, h = 2, 3
    g = torch.Generator(device=card).manual_seed(44)
    q8, k8, qk_scale = _int8_qk(card, g, (b, h, sq, d), (b, h, skv, d))
    v = _f32(g, b, h, skv, d)
    ki, kc = dense_tables(sq // block_q, skv // block_kv).on(card)
    kc = torch.where(torch.tensor([True, False, True], device=card)[:, None], kc, 0)
    kw = dict(block_q=block_q, block_kv=block_kv, kv_valid_len=valid, scale=d**-0.5,
              qk_scale=qk_scale, softmax="fast")
    if with_bias:
        bias = torch.where(torch.rand((1, skv), generator=g, device=card) < 0.3, -1e30, 0.0)
        bias[:, :block_kv] = -1e30
        kw["kv_bias"] = bias
    _build.reset_launches()
    got = sparse_flash_attention_manual(q8, k8, v, ki, kc, **kw)
    assert (_build.launches["flash_manual"], _build.launches["flash_manual_f32"],
            _build.launches["flash_manual_int8"], _build.launches["flash_manual_wgmma"],
            _build.launches["flash_manual_int8_tc"], _build.launches["flash_manual_f32_tc"]) == \
        (1, 1, 1, 0, int(f32_tc_path(d, block_q, block_kv)), 0)
    _close(got, sparse_flash_attention_manual_ref(q8, k8, v, ki, kc, **kw))
    assert not got[:, 1].any()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("latent,tile,lt", [
    ((12, 18, 20), (4, 6, 4), 0),         # the 480p tile
    ((8, 6, 32), (2, 3, 8), 0),           # clamping on t and w
    ((12, 18, 16), (6, 9, 8), 256),       # HunyuanVideo's 432-token tile, int8 text keys
    ((4, 9, 80), (4, 9, 10), 24),         # 360-token tiles, 24 text keys
])
def test_sta_pipe_int8_f32_v_matches_plain(card, d, latent, tile, lt):
    from vorta_tpu_torch.ops.routed_fused import quantize_per_head

    b, h = 2, 3
    s = int(np.prod(latent))
    g = torch.Generator(device=card).manual_seed(45)
    q8, k8, qk_scale = _int8_qk(card, g, (b, h, s, d))
    v = _f32(g, b, h, s, d)
    active = torch.tensor([1, 0, 1], device=card, dtype=torch.int32)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=d**-0.5,
              qk_scale=qk_scale)
    if lt:
        kw.update(text_k=quantize_per_head(_f32(g, b, h, lt, d))[0], text_v=_f32(g, b, h, lt, d),
                  text_bias=torch.where(torch.arange(lt, device=card) < min(83, lt - 3), 0.0,
                                        -1e30)[None])
    _build.reset_launches()
    got = sta_pipe_attention(q8, k8, v, active, **kw)
    assert (_build.launches["sta_pipe"], _build.launches["sta_pipe_f32"],
            _build.launches["sta_pipe_int8"], _build.launches["sta_pipe_wgmma"]) == (1, 1, 1, 0)
    _close(got, sta_pipe_attention_ref(q8, k8, v, active, **kw))
    assert not got[:, 1].any()


@pytest.mark.parametrize("dim", [128, 1000, 1536, 5120])
@pytest.mark.parametrize("rms,affine,mod", [(False, False, True), (True, True, False),
                                            (False, True, True)])
def test_norm_f32_matches_plain(card, dim, rms, affine, mod):
    """f32 x on both kernels (block-per-row at 128 / 1000, warp-per-row at
    1536 / 5120), written in f32."""
    g = torch.Generator(device=card).manual_seed(44)
    x = _f32(g, 2, 37, dim, scale=3.0) + 0.5
    gamma = 1.0 + 0.1 * _f32(g, dim) if affine else None
    beta = 0.1 * _f32(g, dim) if affine else None
    sc, sh = (0.3 * _f32(g, 2, dim), 0.3 * _f32(g, 2, dim)) if mod else (None, None)
    _build.reset_launches()
    got = fused_norm(x, sc, sh, gamma, beta, rms, 1e-6, False)
    assert got.dtype == torch.float32 and _build.launches["fused_norm_f32"] == 1
    _close(got, _norm_ref(x, sc, sh, gamma, beta, rms=rms, eps=1e-6, out_f32=False))


@pytest.mark.parametrize("dim,heads,scope", [(1536, 12, "row"), (3072, 24, "head"),
                                             (5120, 40, "row"), (128, 2, "head"),
                                             (96, 3, "row")])
def test_prologue_f32_matches_plain(card, dim, heads, scope):
    """The warp-per-row kernel in f32 (two, four and eight warps a row) on
    the fused qkv product's column slices, and the block kernel (the tiny
    models' head dim 64, an odd head count)."""
    from vorta_tpu_torch.ops.prologue import prologue_layout
    from vorta_tpu_torch.ops.rope import rope_cos_sin

    grid = (2, 4, 5)
    s = grid[0] * grid[1] * grid[2]
    hd = dim // heads
    g = torch.Generator(device=card).manual_seed(45)
    qkv = _f32(g, 2, s, 3 * dim, scale=3.0)
    q, k, v = qkv.split(dim, dim=-1)
    gq, gk = (1.0 + 0.1 * _f32(g, dim) for _ in range(2))
    cos, sin = (torch.from_numpy(a).to(card) for a in rope_cos_sin(grid, hd))
    kw = dict(num_heads=heads, eps=1e-6, qk_norm=True, norm_scope=scope)
    _build.reset_launches()
    got = fused_qk_prologue(q, k, v, gq, gk, cos, sin, **kw)
    rows = prologue_layout(dim, heads, 4) is not None
    assert (_build.launches["prologue_f32"], _build.launches["prologue_rows"]) == (1, int(rows))
    want = _prologue_ref(q, k, v, gq, gk, cos, sin, **kw)
    for a, w in zip(got, want):
        _close(a, w)
    assert torch.equal(got[2], want[2])  # v is only moved


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("latent,window,kv_from_k", [((4, 6, 8), (2, 3, 2), False),
                                                      ((4, 4, 8), (2, 2, 2), True),
                                                      ((4, 6, 8), (2, 3, 4), False)])
def test_pool_unpool_f32_match_plain(card, d, latent, window, kv_from_k):
    """f32 pool (both modes, K's matching) and unpool bit for bit against the
    plain versions where the picks agree; a 24-slot group at D 128 takes the
    first design's unpool kernel by the f32 rule (no rows layout)."""
    from vorta_tpu_torch.ops.coreset_pallas import head_map_for, unpool_layout

    groups = build_lowres_groups(latent, window)
    g = torch.Generator(device=card).manual_seed(46)
    s = latent[0] * latent[1] * latent[2]
    q, k, v = (_f32(g, 2, 4, s, d) for _ in range(3))
    on = torch.tensor([1, 0, 1, 1], device=card)
    hm, n = head_map_for(on)
    for kw in (dict(active=on), dict(head_map=hm, num_active=n)):
        _build.reset_launches()
        got = pool_qkv(q, k, v, groups, kv_matching_from_k=kv_from_k, return_picks=True, **kw)
        torch.cuda.synchronize()
        assert _build.launches["pool_qkv_f32"] == 1
        want = pool_qkv_ref(q, k, v, groups, kv_matching_from_k=kv_from_k, **kw)
        hs = on > 0
        gaps = pick_gaps(got[3][:, hs], want[3][:, hs], q[:, hs], groups)
        assert gaps.numel() == 0 or gaps.max().item() < 1e-5
        if gaps.numel() == 0:
            for a, w in zip(got, want):
                assert torch.equal(a[:, hs], w[:, hs])
        out_p = _f32(g, 2, 4, groups.pooled_length, d)
        _build.reset_launches()
        up = unpool(out_p, q, groups, picks=got[3], **kw)
        torch.cuda.synchronize()
        rows = unpool_layout(d, groups.group_size, groups.num_kept_margins, 4) is not None
        assert (_build.launches["unpool_f32"], _build.launches["unpool_rows"]) == (1, int(rows))
        ref = unpool_ref(out_p, q, groups, picks=got[3], **kw)
        assert torch.equal(up[:, hs], ref[:, hs])


def test_f32_c_entries_refuse_what_their_rules_refuse(card):
    """The f32 C entries mirror the wrappers' rules: a head dim outside 64 /
    128, blocks not multiples of 8 or not dividing the sequence: an error
    code, never a launch; the f32 lse (the f32 training path) is taken."""
    from vorta_tpu_torch.ops.flash import _flash_f32_fn
    from vorta_tpu_torch.ops.sta_pipe import _sta_f32_fn

    q = torch.zeros((1, 1, 64, 128), device=card)
    ki, kc = dense_tables(1, 1).on(card)
    lse = torch.zeros((1, 1, 64, 1), device=card)
    stream = _build.stream_ptr(q.device)
    p = [q.data_ptr()] * 4

    def flash(lse_ptr, d, block, work=None):
        tab = dense_tables(64 // block, 64 // block).on(card) if block < 64 else (ki, kc)
        return _flash_f32_fn()(*p, lse_ptr, tab[0].data_ptr(), tab[1].data_ptr(), 1, 1, 64, 64,
                               d, 1, 64 // block, 64 // block, block, block, 64, 0.1, work,
                               stream)

    assert flash(None, 128, 64) == 0
    torch.cuda.synchronize()
    assert flash(lse.data_ptr(), 128, 64) == 0
    assert flash(None, 96, 64) != 0
    assert flash(None, 128, 12) != 0
    # the tensor-core core where flash_f32_tc_path holds (D 128, blocks multiples of 8:
    # 64 and 32 too), refused at D 64: an error, never the FFMA core
    work = torch.zeros(6 * 64 * 128, device=card)
    assert flash(None, 128, 64, work.data_ptr()) == 0
    assert flash(lse.data_ptr(), 128, 32, work.data_ptr()) == 0
    torch.cuda.synchronize()
    assert flash(None, 64, 64, work.data_ptr()) != 0
    act = torch.ones(1, dtype=torch.int32, device=card)
    sta = _sta_f32_fn()  # (..., stable, work, stream): work None, the FFMA core
    args = [*p, act.data_ptr(), None, None, None, None, 0, 1, 1, 4, 4, 4]
    assert sta(*args, 96, 2, 2, 2, 3, 3, 3, 0, None, stream) != 0
    assert sta(*args, 128, 2, 2, 2, 3, 3, 3, 0, None, stream) == 0
    assert sta(*args, 128, 3, 2, 2, 3, 3, 3, 0, None, stream) != 0
    # the int8 mode (a qk factor) takes the fast softmax only
    qkc = torch.ones(1, device=card)
    args8 = [*p, act.data_ptr(), None, None, None, qkc.data_ptr(), 0, 1, 1, 4, 4, 4]
    assert sta(*args8, 128, 2, 2, 2, 3, 3, 3, 1, None, stream) != 0
    for name, tw in (("sta_window", 2), ("sta_row", 8)):
        fn = getattr(_build.load(name), f"vorta_{name}_fwd_f32")  # (..., work, stream)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_int] * 13 + [
            ctypes.c_void_p, ctypes.c_void_p]
        wq = torch.zeros((1, 1, 4 * 4 * 2 * tw, 128), device=card)
        wp = [wq.data_ptr()] * 4 + [act.data_ptr(), None, None, None, 0.1, 0, 1, 1, 4, 4,
                                    2 * tw]
        assert fn(*wp, 128, 2, 2, tw, 3, 3, 3, None, stream) == 0
        assert fn(*wp, 96, 2, 2, tw, 3, 3, 3, None, stream) != 0
        assert fn(*wp, 128, 3, 2, tw, 3, 3, 3, None, stream) != 0
        assert fn(*[*wp[:4], None, *wp[5:]], 128, 2, 2, tw, 3, 3, 3, None,
                  stream) != 0  # no active
    wr = getattr(_build.load("sta_row"), "vorta_sta_row_fwd_f32")
    assert wr(*[wq.data_ptr()] * 4, act.data_ptr(), None, None, None, 0.1, 0, 1, 1, 4, 4, 16,
              128, 2, 2, 4, 3, 3, 3, None, stream) != 0  # tile_w not a multiple of 8
    torch.cuda.synchronize()


def test_cli_sample_fp32_on_card_matches_cpu(card, tmp_path):
    """cli.sample --dtype fp32, wan-tiny routed, 2 steps: the card against
    --device cpu from the same weights, noise and embeddings (drawn on the
    host: the two devices' generators differ): final latents rel L2 <= 1e-3,
    the routing equal, every launch an f32 one; TF32 off after the call."""
    from unittest import mock

    from vorta_tpu_torch.cli import sample
    from vorta_tpu_torch.config import WAN_TINY
    from vorta_tpu_torch.pipelines.wan_t2v import WanT2VPipeline

    emb = tmp_path / "emb.npy"
    np.save(emb, np.random.default_rng(7).standard_normal(
        (1, WAN_TINY.text_len, WAN_TINY.text_dim)).astype(np.float32))
    real = sample.WanModel

    def on_host(cfg, dtype=torch.float32, device=None, seed=0):
        return real(cfg, dtype=dtype, device="cpu", seed=seed).to(device)

    def noise(self, generator, batch, frames, height, width):
        shape = (batch, (frames - 1) // 4 + 1, height // 8, width // 8, 16)
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            generator.initial_seed())).to(self.model.device)

    base = ["--model", "wan-tiny", "--dtype", "fp32", "--prompt_embeds", str(emb),
            "--num_frames", "13", "--height", "64", "--width", "64",
            "--num_inference_steps", "2"]
    runs = {}
    with mock.patch.object(sample, "WanModel", on_host), \
            mock.patch.object(WanT2VPipeline, "prepare_latents", noise):
        for dev in ("cuda", "cpu"):
            _build.reset_launches()
            runs[dev] = sample.main(base + ["--device", dev, "--output",
                                            str(tmp_path / f"{dev}.npy")])
            if dev == "cuda":
                n = dict(_build.launches)
    assert torch.backends.cudnn.allow_tf32 is False
    assert all(np.array_equal(a, b) for a, b in zip(runs["cuda"].routing, runs["cpu"].routing))
    a, b = runs["cuda"].latents.cpu(), runs["cpu"].latents
    assert ((a - b).norm() / b.norm()).item() <= 1e-3
    for kname in ("flash", "flash_manual", "sta_pipe", "fused_norm", "prologue", "pool_qkv",
                  "unpool"):
        assert n[f"{kname}_f32"] == n[kname] > 0, kname


# --- the f32 modes' tensor-core core (csrc/attn_f32_tc.cuh: 3xTF32 on wgmma) ------------
# flash at D = 128 with blocks that are multiples of 8 (ops/flash.py:
# flash_f32_tc_path) and flash_manual with blocks that are multiples of 128
# (f32_tc_path) against their plain versions on the same f32 inputs, TF32
# off, within _close's f32 rule, and against the FFMA core at the same call
# (sparse_flash_attention_ffma / _manual_ffma: the yardstick).

def test_f32_tc_probe(card):
    """One 64-row tile's two products on the core's pieces (the Q / K splits
    in the 128-byte swizzle, V^T's permuted keys, P from the S registers)
    against f64 products: 3xTF32 holds them to f32's precision."""
    from vorta_tpu_torch.ops.flash import f32_tc_probe

    g = torch.Generator(device=card).manual_seed(60)
    q, k, v = (_f32(g, 64, 128) for _ in range(3))
    s, o = f32_tc_probe(q, k, v)
    torch.cuda.synchronize()
    s_want = q.double() @ k.double().T
    o_want = s.double() @ v.double()
    assert (s - s_want).abs().max().item() <= 1e-5 * s_want.abs().max().item()
    assert (o - o_want).abs().max().item() <= 1e-5 * o_want.abs().max().item()


@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", [
    ("dense", 128, 128, 512, 512, 500),       # the tail inside a 64-key chunk
    ("dense", 256, 256, 512, 512, 448),       # the tail on a chunk's edge: a chunk skipped
    ("shared", 256, 256, 1024, 1024, 1000),   # q block 0 with count 0: zeros, lse 1e30
    ("per_head", 128, 128, 512, 512, None),   # per-head tables
    ("dense", 2048, 512, 2048, 1024, 600),    # cross-attention's blocks, a kv tail
    ("dense", 1024, 1024, 2048, 2048, 1500),  # FULL's blocks
])
def test_flash_f32_tc_matches_plain(card, kind, bq, bkv, sq, skv, valid):
    """The tensor-core core with and without the lse, counted as
    flash_f32_tc (never flash_wgmma), against the plain version and the FFMA
    core at the same call."""
    _tc_forward_case(card, kind, bq, bkv, sq, skv, valid)


@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", [
    ("shared", 96, 96, 384, 384, 344),       # STA 96: 64 + 32 rows, q block 0 empty, a tail
    ("dense", 96, 96, 288, 288, 288),        # no tail, every block visited
    ("shared", 360, 360, 1080, 1080, 980),   # STA 360: 5 x 64 + 40 rows and keys
    ("shared", 24, 24, 120, 120, 115),       # STA 24: one 24-row CTA, a 19-key tail
    ("per_head", 96, 96, 384, 384, None),    # per-head tables, a count-0 block per head
    ("dense", 24, 360, 96, 720, 700),        # q blocks 24, kv blocks 360
    ("dense", 1024, 64, 2048, 128, 100),     # kv blocks of 64
    ("shared", 16, 16, 96, 96, 90),          # blocks of 16 and 8 at D 128
    ("dense", 8, 8, 64, 64, 60),
])
def test_flash_f32_tc_at_the_sta_blocks(card, kind, bq, bkv, sq, skv, valid):
    """The tensor-core core at blocks that 64 does not divide (the STA
    training tiles 96, 360, 24; 16 and 8) and kv blocks of 64: ragged 64-row
    CTAs whose rows past the block are never stored, 64-key chunks masked
    past the block, against the plain version and the FFMA core; a count-0
    q block's rows exact zeros with the lse sentinel while the next block's
    rows hold (the early exit writes only its own rows)."""
    _tc_forward_case(card, kind, bq, bkv, sq, skv, valid)


def _tc_forward_case(card, kind, bq, bkv, sq, skv, valid):
    from vorta_tpu_torch.ops.flash import flash_f32_tc_path, sparse_flash_attention_ffma

    assert flash_f32_tc_path(128, bq, bkv)
    g = torch.Generator(device=card).manual_seed(61)
    q = _f32(g, 2, 3, sq, 128)
    k, v = (_f32(g, 2, 3, skv, 128) for _ in range(2))
    ki, kc = _tables(kind, 3, sq // bq, skv // bkv).on(card)
    kw = dict(block_q=bq, block_kv=bkv, kv_valid_len=valid, scale=1.1 * 128**-0.5)
    _build.reset_launches()
    got = sparse_flash_attention_raw(q, k, v, ki, kc, **kw)
    out, lse = sparse_flash_attention_raw(q, k, v, ki, kc, return_lse=True, **kw)
    n = _build.launches
    assert (n["flash"], n["flash_f32"], n["flash_f32_tc"], n["flash_lse"], n["flash_wgmma"]) == \
        (2, 2, 2, 1, 0)
    want, want_lse = sparse_flash_attention_ref(q, k, v, ki, kc, return_lse=True, **kw)
    _close(got, want)
    assert torch.equal(out, got)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    if kind == "shared":
        assert not got[:, :, :bq].any() and (lse[:, :, :bq] == 1e30).all()
        # block 1 (visited) is not zeroed by block 0's last CTA
        assert (lse[:, :, bq:2 * bq] < 1e30).all()
        assert got[:, :, bq:bq + 8].abs().amax(-1).gt(0).all()
    _build.reset_launches()
    _close(sparse_flash_attention_ffma(q, k, v, ki, kc, **kw), want)
    assert (n["flash_f32"], n["flash_f32_tc"]) == (1, 0)


@pytest.mark.parametrize("softmax", ["fast", "stable"])
@pytest.mark.parametrize("bq,bkv,s,valid,bias", [
    (128, 128, 512, 507, True),      # kv_bias (-1e30 on some keys) with kv_valid_len
    (256, 1024, 2048, 1900, True),   # the STA text rows' blocks
    (1024, 1024, 2048, 2048, False),  # FULL / LOWRES's blocks, no tail
])
def test_flash_manual_f32_tc_matches_plain(card, softmax, bq, bkv, s, valid, bias):
    """Either softmax on the tensor-core core, per-head counts with a head
    routed away (its rows exact zeros), counted as flash_manual_f32_tc."""
    from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual_ffma

    g = torch.Generator(device=card).manual_seed(62)
    h = 3
    q = _f32(g, 1, h, s, 128)
    k, v = (_f32(g, 1, h, s, 128) for _ in range(2))
    ki, kc = dense_tables(s // bq, s // bkv).on(card)
    counts = kc.expand(h, -1).clone()
    counts[1] = 0
    kb = None
    if bias:
        kb = torch.where(torch.rand((1, s), generator=g, device=card) < 0.2, -1e30,
                         _f32(g, 1, s))
    kw = dict(block_q=bq, block_kv=bkv, kv_valid_len=valid, kv_bias=kb, softmax=softmax,
              scale=0.9 * 128**-0.5)
    _build.reset_launches()
    got = sparse_flash_attention_manual(q, k, v, ki, counts, **kw)
    n = _build.launches
    assert (n["flash_manual"], n["flash_manual_f32"], n["flash_manual_f32_tc"],
            n["flash_manual_stable"], n["flash_manual_wgmma"]) == \
        (1, 1, 1, int(softmax == "stable"), 0)
    want = sparse_flash_attention_manual_ref(q, k, v, ki, counts, **kw)
    _close(got, want)
    assert not got[:, 1].any()
    _build.reset_launches()
    _close(sparse_flash_attention_manual_ffma(q, k, v, ki, counts, **kw), want)
    assert (n["flash_manual_f32"], n["flash_manual_f32_tc"]) == (1, 0)


def test_f32_tc_c_entries_refuse_what_the_rule_refuses(card):
    """flash_manual's f32 entry takes the tensor cores (a scratch pointer:
    the f32 core, or the int8 mode's kernel with a qk factor) only where
    f32_tc_path holds: an error code, never a launch, no fallback."""
    from vorta_tpu_torch.ops.flash import f32_tc_work
    from vorta_tpu_torch.ops.flash_manual import _flash_manual_f32_fn

    q = torch.zeros((1, 1, 256, 128), device=card)
    q64 = torch.zeros((1, 1, 256, 64), device=card)
    ki, kc = dense_tables(2, 2).on(card)
    qkc = torch.ones(1, device=card)
    work = f32_tc_work(1, 1, 256, 256, card).data_ptr()
    stream = _build.stream_ptr(q.device)

    def manual(x, d, block, w, qk=None):
        return _flash_manual_f32_fn()(*[x.data_ptr()] * 4, ki.data_ptr(), kc.data_ptr(), None,
                                      qk, 1, 1, 256, 256, d, 1, 1, 256 // block, 256 // block,
                                      block, block, 256, 0, 0.1, w, stream)

    assert manual(q, 128, 128, work) == 0
    torch.cuda.synchronize()
    assert manual(q64, 64, 128, work) != 0
    assert manual(q, 128, 128, work, qkc.data_ptr()) == 0  # the int8 mode's kernel
    torch.cuda.synchronize()
    assert manual(q64, 64, 128, work, qkc.data_ptr()) != 0
    assert manual(q, 128, 64, work, qkc.data_ptr()) != 0
    assert manual(q, 128, 64, work) != 0  # blocks of 64: not the rule's
    assert manual(q, 128, 128, None) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("bq,bkv,s,valid,bias", [
    (128, 128, 512, 507, True),       # kv_bias (-1e30 on some keys) with kv_valid_len
    (256, 1024, 2048, 1900, True),    # q blocks of two 128-row CTAs
    (1024, 1024, 2048, 2048, False),  # FULL / LOWRES's blocks, no tail
    (2048, 512, 2048, 1600, False),   # a tail on a chunk boundary: chunks past it skipped
])
def test_flash_manual_int8_tc_matches_plain(card, bq, bkv, s, valid, bias):
    """The int8 QK mode with an f32 v on the tensor cores (csrc/attn_int8_tc.cuh)
    against the plain version and the dp4a / FFMA mode on the same int8 q / k,
    per-head counts with a head routed away (exact zeros) and a count-0 q
    block, counted as flash_manual_int8_tc (never _f32_tc or _wgmma)."""
    from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual_ffma

    g = torch.Generator(device=card).manual_seed(64)
    h = 3
    q8, k8, qk_scale = _int8_qk(card, g, (1, h, s, 128))
    v = _f32(g, 1, h, s, 128)
    ki, kc = dense_tables(s // bq, s // bkv).on(card)
    counts = kc.expand(h, -1).clone()
    counts[1] = 0
    counts[2, -1] = 0
    kb = None
    if bias:
        kb = torch.where(torch.rand((1, s), generator=g, device=card) < 0.2, -1e30,
                         _f32(g, 1, s))
    kw = dict(block_q=bq, block_kv=bkv, kv_valid_len=valid, kv_bias=kb, softmax="fast",
              scale=128**-0.5, qk_scale=qk_scale)
    _build.reset_launches()
    got = sparse_flash_attention_manual(q8, k8, v, ki, counts, **kw)
    n = _build.launches
    assert (n["flash_manual"], n["flash_manual_f32"], n["flash_manual_int8"],
            n["flash_manual_int8_tc"], n["flash_manual_f32_tc"], n["flash_manual_wgmma"]) == \
        (1, 1, 1, 1, 0, 0)
    want = sparse_flash_attention_manual_ref(q8, k8, v, ki, counts, **kw)
    _close(got, want)
    assert not got[:, 1].any() and not got[:, 2, -bq:].any()
    _build.reset_launches()
    _close(sparse_flash_attention_manual_ffma(q8, k8, v, ki, counts, **kw), want)
    assert (n["flash_manual_int8"], n["flash_manual_int8_tc"]) == (1, 0)


# --- the window walks' f32 mode on the tensor cores (csrc/window_walk_f32_tc.cuh) ------
# sta_window and sta_pipe at D = 128 with q tiles of a multiple of 8 tokens
# (ops/sta_pipe.py:sta_f32_tc_path) against their plain versions and the FFMA
# core at the same call (sta_window_attention_ffma / sta_pipe_attention_ffma).

WINDOW_TC_CASES = [  # (kernel, latent, tile, text keys, softmax)
    ("sta_window", (4, 6, 32), (2, 3, 8), 0, "stable"),     # 48-token tiles, clamped edges
    ("sta_window", (8, 9, 40), (4, 9, 10), 24, "stable"),   # 360: 5 x 64 + 40, nt = 2 < 3
    ("sta_window", (4, 9, 80), (4, 9, 10), 256, "stable"),  # 256 text keys, a few padded
    ("sta_pipe", (8, 12, 16), (4, 6, 4), 0, "fast"),        # 96: runs of 288 keys
    ("sta_pipe", (8, 12, 16), (4, 6, 4), 0, "stable"),
    ("sta_pipe", (6, 9, 16), (6, 9, 8), 256, "fast"),       # 432: 7 parts, the text tail
    ("sta_pipe", (6, 9, 16), (6, 9, 8), 256, "stable"),
    ("sta_pipe", (4, 4, 8), (2, 2, 8), 8, "fast"),          # the window spans every axis
]


@pytest.mark.parametrize("kernel,latent,tile,lt,softmax", WINDOW_TC_CASES)
def test_window_f32_tc_matches_plain_and_the_ffma_core(card, kernel, latent, tile, lt, softmax):
    """The tensor-core walk (batch 2, head 1 routed away: exact zeros; the
    text bias masking a few keys) against the plain version and the FFMA
    core at the same call, counted as <kernel>_f32_tc (the FFMA arm never),
    never on the Hopper path; rows past a q tile are never stored (the
    plain comparison sees every raster row)."""
    from vorta_tpu_torch.ops import sta_pipe, sta_window

    fn, ffma, plain = {
        "sta_window": (sta_window.sta_window_attention, sta_window.sta_window_attention_ffma,
                       sta_window.sta_window_attention_ref),
        "sta_pipe": (sta_pipe_attention, sta_pipe.sta_pipe_attention_ffma,
                     sta_pipe_attention_ref)}[kernel]
    g = torch.Generator(device=card).manual_seed(70)
    n = int(np.prod(latent))
    q, k, v = (_f32(g, 2, 3, n, 128) for _ in range(3))
    act = torch.tensor([1, 0, 1], device=card)
    kw = dict(latent_shape=latent, tile=tile, window=(3, 3, 3), scale=128**-0.5)
    if kernel == "sta_pipe":
        kw["softmax"] = softmax
    if lt:
        kw.update(text_k=_f32(g, 2, 3, lt, 128), text_v=_f32(g, 2, 3, lt, 128),
                  text_bias=torch.where(torch.arange(lt, device=card) < lt - 5, 0.0,
                                        -1e30)[None])
    want = plain(q, k, v, act, **kw)
    for arm, tc in ((fn, 1), (ffma, 0)):
        _build.reset_launches()
        got = arm(q, k, v, act, **kw)
        assert (_build.launches[kernel], _build.launches[f"{kernel}_f32"],
                _build.launches[f"{kernel}_f32_tc"], _build.launches[f"{kernel}_wgmma"]) == \
            (1, 1, tc, 0)
        _close(got, want)
        assert not got[:, 1].any()


def test_window_f32_tc_c_entries_refuse_what_the_rule_refuses(card):
    """sta_pipe's and sta_window's f32 entries take the tensor cores (a
    scratch pointer) only where sta_f32_tc_path holds: D 64, a q tile of 4
    tokens and sta_pipe's int8 QK mode are error codes, never a launch; a
    scratch pointer to sta_row's f32 entry too (it has no tensor-core walk)."""
    from vorta_tpu_torch.ops import sta_pipe
    from vorta_tpu_torch.ops.flash import f32_tc_work

    shape = (2, 4, 16)
    s = int(np.prod(shape))
    x = {d: torch.zeros((1, 1, s, d), device=card) for d in (64, 128)}
    act = torch.ones(1, dtype=torch.int32, device=card)
    work = f32_tc_work(1, 1, s, s, card).data_ptr()
    stream = _build.stream_ptr(card)
    pipe = sta_pipe._sta_f32_fn()

    def window(lib, d, tile, w):
        fn = getattr(_build.load(lib), f"vorta_{lib}_fwd_f32")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [ctypes.c_float] + [i] * 13 + [p, p]
        fn.restype = ctypes.c_int
        return fn(*[x[d].data_ptr()] * 4, act.data_ptr(), None, None, None, 0.1, 0, 1, 1,
                  *shape, d, *tile, 3, 3, 3, w, stream)

    def pipe_call(d, tile, w, qk=None):
        return pipe(*[x[d].data_ptr()] * 4, act.data_ptr(), None, None, None, qk, 0, 1, 1,
                    *shape, d, *tile, 3, 3, 3, 0, w, stream)

    assert pipe_call(128, (2, 2, 8), work) == 0
    assert window("sta_window", 128, (2, 2, 8), work) == 0
    torch.cuda.synchronize()
    assert pipe_call(64, (2, 2, 8), work) != 0
    assert pipe_call(128, (1, 1, 4), work) != 0  # 4 tokens a tile: not the rule's
    assert pipe_call(128, (2, 2, 8), work, torch.ones(1, device=card).data_ptr()) != 0
    assert window("sta_window", 64, (2, 2, 8), work) != 0
    assert window("sta_window", 128, (1, 1, 4), work) != 0
    assert window("sta_row", 128, (2, 2, 8), work) != 0
    assert window("sta_row", 128, (2, 2, 8), None) == 0
    torch.cuda.synchronize()


# --- the f32 training path: the f32 lse, the f32 dq and dk/dv kernels -------------------
# Each against its plain version on the same f32 inputs, TF32 off (the card
# fixture), within _close's f32 rule (1e-5 x max |plain|); the lse within
# rtol 1e-5 and atol 1e-4, its sentinel exactly.

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", [
    ("dense", 8, 8, 64, 64, 60),              # 8-row blocks: a CTA of 8 rows
    ("shared", 16, 16, 96, 96, 90),           # wan-tiny's blocks, q block 0 empty, a tail
    ("dense", 24, 24, 96, 96, 90),            # 8 x 3: one CTA of 24 rows a block
    ("shared", 360, 360, 1080, 1080, 1000),   # 360 = 5 x 64 + 40: a ragged last CTA
    ("dense", 24, 360, 96, 720, 700),         # q blocks 24, kv blocks 360
    ("dense", 256, 64, 512, 128, 100),        # cross-attention's shape class, a kv tail
    ("dense", 1024, 1024, 2048, 2048, 1500),  # FULL's blocks
])
def test_flash_f32_lse_and_backward_match_plain(card, d, kind, bq, bkv, sq, skv, valid):
    """The f32 forward with its lse, then the f32 dq and dk/dv kernels fed
    that out and lse, against the plain versions: exact zeros for an empty
    q block (dq; lse 1e30) and for kv rows past the tail (dk, dv); need_dq
    alone bit for bit; every launch on the f32 mode, none on a Hopper path."""
    from vorta_tpu_torch.ops.flash_bwd import flash_backward, flash_backward_ref, transpose_tables

    g = torch.Generator(device=card).manual_seed(47)
    q, dout = (_f32(g, 2, 3, sq, d) for _ in range(2))
    k, v = (_f32(g, 2, 3, skv, d) for _ in range(2))
    tab = _tables(kind, 1, sq // bq, skv // bkv)
    ki, kc = tab.on(card)
    qi, qc = (torch.from_numpy(a).to(card)
              for a in transpose_tables(tab.kv_index, tab.kv_count, skv // bkv))
    kw = dict(scale=1.1 * d**-0.5, block_q=bq, block_kv=bkv)
    _build.reset_launches()
    out, lse = sparse_flash_attention_raw(q, k, v, ki, kc, kv_valid_len=valid, return_lse=True,
                                          **kw)
    want_out, want_lse = sparse_flash_attention_ref(q, k, v, ki, kc, kv_valid_len=valid,
                                                    return_lse=True, **kw)
    _close(out, want_out)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    if kind == "shared":
        assert (lse[:, :, :bq] == 1e30).all()
    got = flash_backward(q, k, v, out, lse, dout, ki, kc, qi, qc, kv_valid_len=valid or skv, **kw)
    n = _build.launches
    assert (n["flash"], n["flash_f32"], n["flash_lse"], n["flash_dq_f32"], n["flash_dkv_f32"],
            n["flash_wgmma"], n["flash_dq_wgmma"], n["flash_dkv_wgmma"]) == (1, 1, 1, 1, 1, 0, 0, 0)
    want = flash_backward_ref(q, k, v, out, lse, dout, ki, kc, kv_valid_len=valid or skv, **kw)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        _close(a, w)
    if valid:
        assert not got[1][:, :, valid:].any() and not got[2][:, :, valid:].any()
    if kind == "shared":
        assert not got[0][:, :, :bq].any()
    dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ki, kc, qi, qc,
                                kv_valid_len=valid or skv, need_dkv=False, **kw)
    assert dk is None and dv is None and torch.equal(dq, got[0])


def test_flash_f32_backward_c_entries_refuse_what_their_rules_refuse(card):
    """The f32 backward entries refuse a head dim outside 64 / 128 and blocks
    not multiples of 8: an error code, never a launch.  Given the
    tensor-core scratch they refuse every shape off ops/flash.py:
    flash_f32_tc_path (D 64) and take the rest (D 128, blocks multiples of 8:
    64, 96), as the split entry does: nothing falls back to the FFMA
    kernels."""
    from vorta_tpu_torch.ops.flash_bwd import _fn, _split_fn, f32_tc_bwd_work

    q = torch.zeros((1, 1, 256, 128), device=card)
    lse = torch.zeros((1, 1, 256), device=card)
    ki, kc = dense_tables(1, 1).on(card)
    stream = _build.stream_ptr(q.device)
    dq_fn, dkv_fn = _fn("vorta_flash_bwd_dq_f32", 9, 9), _fn("vorta_flash_bwd_dkv_f32", 10, 9)
    work = f32_tc_bwd_work(1, 1, 256, 256, card)

    def both(d, block, scratch=None, s=64):
        p = [q.data_ptr()] * 4 + [lse.data_ptr()] * 2
        tail = [ki.data_ptr(), kc.data_ptr(), 1, 1, s, s, d, 1, block, block, s, 0.1, scratch,
                stream]
        return (dq_fn(*p, q.data_ptr(), *tail), dkv_fn(*p, q.data_ptr(), q.data_ptr(), *tail))

    def split(d, block, s=256):
        return _split_fn()(*[q.data_ptr()] * 4, work.data_ptr(), 1, 1, s, s, d, block, block, s,
                           1, 1, stream)

    assert both(128, 64) == (0, 0)
    for block in (256, 64, 96):  # the rule's shapes (one q and one kv block): split, then both
        assert split(128, block, block) == 0 and both(128, block, work.data_ptr(), block) == (0, 0)
    torch.cuda.synchronize()
    assert all(err != 0 for err in both(96, 64) + both(128, 12))
    assert all(err != 0 for err in both(64, 128, work.data_ptr(), 256)
               + both(64, 64, work.data_ptr()) + both(128, 12, work.data_ptr(), 96))
    assert split(64, 256) != 0 and split(64, 64, 64) != 0 and split(128, 12, 96) != 0


@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", [
    ("dense", 128, 128, 512, 512, 500),      # the tail inside a 32-key chunk
    ("dense", 256, 256, 512, 512, 448),      # the tail on a chunk's edge: chunks skipped
    ("shared", 256, 256, 1024, 1024, 1000),  # q block 0 with count 0: zero dq
    ("shared", 128, 256, 1024, 512, 512),    # q and kv blocks differ, no tail
    ("dense", 2048, 512, 2048, 512, 300),    # cross-like 1-block tables, a kv tail
])
def test_flash_f32_tc_backward_matches_plain(card, kind, bq, bkv, sq, skv, valid):
    """The f32 backward on the tensor cores (csrc/attn_f32_tc_bwd.cuh: one
    split pre-pass, dq and dk/dv on 3xTF32 wgmma), counted once each as
    flash_dq_f32_tc / flash_dkv_f32_tc and never _wgmma, against the plain
    version (dq reads each kernel's ds, dv its p, dk its ds) and the FFMA
    kernels at the same call (flash_backward_ffma); exact zeros for kv rows
    past the tail and for the count-0 q block; need_dq and need_dkv alone
    bit for bit."""
    _tc_backward_case(card, kind, bq, bkv, sq, skv, valid)


@pytest.mark.parametrize("kind,bq,bkv,sq,skv,valid", [
    ("shared", 96, 96, 384, 384, 344),       # STA 96: 64 + 32 rows, the tail mid-chunk
    ("dense", 96, 96, 288, 288, 288),        # no tail, every block visited
    ("shared", 360, 360, 1080, 1080, 980),   # STA 360: 5 x 64 + 40 rows, 11 x 32 + 8 keys
    ("shared", 24, 24, 120, 120, 115),       # STA 24: one 24-row CTA, a 19-key tail
    ("dense", 24, 360, 96, 720, 700),        # q blocks 24, kv blocks 360
    ("dense", 24, 128, 96, 256, 250),        # a partial q chunk, whole 64-row kv tiles
    ("dense", 1024, 64, 2048, 128, 100),     # kv blocks of 64
    ("shared", 16, 16, 96, 96, 90),          # blocks of 16 and 8 at D 128
    ("dense", 8, 8, 64, 64, 60),
])
def test_flash_f32_tc_backward_at_the_sta_blocks(card, kind, bq, bkv, sq, skv, valid):
    """The tensor-core dq and dk/dv at blocks that 128 does not divide (the
    STA training tiles 96, 360, 24; kv blocks of 64; 16 and 8): ragged
    64-row CTAs and 32-row chunks, against the plain version and the FFMA
    kernels, counted as _f32_tc; exact zeros past the kv tail and for the
    count-0 q block; need_dq and need_dkv alone bit for bit."""
    _tc_backward_case(card, kind, bq, bkv, sq, skv, valid)


def _tc_backward_case(card, kind, bq, bkv, sq, skv, valid):
    from vorta_tpu_torch.ops.flash import flash_f32_tc_path
    from vorta_tpu_torch.ops.flash_bwd import (flash_backward, flash_backward_ffma,
                                               flash_backward_ref, transpose_tables)

    assert flash_f32_tc_path(128, bq, bkv)
    g = torch.Generator(device=card).manual_seed(62)
    q, dout = (_f32(g, 2, 3, sq, 128) for _ in range(2))
    k, v = (_f32(g, 2, 3, skv, 128) for _ in range(2))
    tab = _tables(kind, 1, sq // bq, skv // bkv)
    ki, kc = tab.on(card)
    qi, qc = (torch.from_numpy(a).to(card)
              for a in transpose_tables(tab.kv_index, tab.kv_count, skv // bkv))
    kw = dict(scale=1.1 * 128**-0.5, block_q=bq, block_kv=bkv, kv_valid_len=valid)
    out, lse = sparse_flash_attention_raw(q, k, v, ki, kc, return_lse=True, **kw)
    args = (q, k, v, out, lse, dout, ki, kc, qi, qc)
    _build.reset_launches()
    got = flash_backward(*args, **kw)
    n = dict(_build.launches)
    assert tuple(n[x] for x in ("flash_dq", "flash_dq_f32", "flash_dq_f32_tc", "flash_dq_wgmma",
                                "flash_dkv", "flash_dkv_f32", "flash_dkv_f32_tc",
                                "flash_dkv_wgmma")) == (1, 1, 1, 0, 1, 1, 1, 0)
    want = flash_backward_ref(q, k, v, out, lse, dout, ki, kc, **kw)
    _build.reset_launches()
    ffma = flash_backward_ffma(*args, **kw)
    assert (_build.launches["flash_dq_f32"], _build.launches["flash_dq_f32_tc"],
            _build.launches["flash_dkv_f32"], _build.launches["flash_dkv_f32_tc"]) == (1, 0, 1, 0)
    for a, f, w in zip(got, ffma, want):
        _close(a, w)
        _close(f, w)
    assert not got[1][:, :, valid:].any() and not got[2][:, :, valid:].any()
    if kind == "shared":
        assert not got[0][:, :, :bq].any()
    dq, dk, dv = flash_backward(*args, need_dkv=False, **kw)
    assert dk is None and dv is None and torch.equal(dq, got[0])
    dq, dk, dv = flash_backward(*args, need_dq=False, **kw)
    assert dq is None and torch.equal(dk, got[1]) and torch.equal(dv, got[2])
    dq, dk, dv = flash_backward(*args, need_dq=False, **kw)
    assert dq is None and torch.equal(dk, got[1]) and torch.equal(dv, got[2])


@pytest.mark.parametrize("block", [16, 128])
def test_sparse_attention_f32_grads_on_card_match_cpu(card, block):
    """make_sparse_attention's autograd in f32 on the card (the f32 kernels)
    against the CPU (the plain versions) from the same inputs: rel L2 below
    1e-5 per gradient; k and v without grad launch no dk/dv kernel."""
    from vorta_tpu_torch.ops.flash import make_sparse_attention

    rng = np.random.default_rng(48)
    s, d = 4 * block, 64
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, s, d)).astype(np.float32))
                  for _ in range(4))
    mask = rng.random((1, 4, 4)) < 0.6
    mask[:, 0] = False
    mask[:, 1:, 0] = True
    attn = make_sparse_attention(tables_from_block_mask(mask), n_kv_blocks=4, block_q=block,
                                 block_kv=block, kv_valid_len=s - 3)

    def grads(dev, kv_grad=True):
        xs = [x.to(dev, copy=True).requires_grad_(i == 0 or kv_grad)
              for i, x in enumerate((q, k, v))]
        (attn(*xs) * g.to(dev)).sum().backward()
        return [x.grad.cpu() for x in xs if x.grad is not None]

    _build.reset_launches()
    on_card = grads(card)
    assert (_build.launches["flash_dq_f32"], _build.launches["flash_dkv_f32"]) == (1, 1)
    for a, b in zip(on_card, grads("cpu")):
        assert ((a - b).norm() / b.norm()).item() < 1e-5
    _build.reset_launches()
    grads(card, kv_grad=False)
    assert (_build.launches["flash_dq_f32"], _build.launches["flash_dkv"]) == (1, 0)


def test_train_cli_fp32_on_card_matches_cpu(card, tmp_path):
    """cli.train --dtype fp32, wan-tiny, 2 optimizer steps of 1 micro-step:
    the card against --device cpu from the same weights and draws (both made
    on the host: the two devices' generators differ): the routers after the
    run within rel L2 1e-3, every flash / dq / dk/dv launch an f32 one, none
    on a Hopper path; TF32 off after the call."""
    from unittest import mock

    from vorta_tpu_torch.cli import train
    from vorta_tpu_torch.training.step import RouterTrainStep

    real, draw = train.WanModel, RouterTrainStep.draw
    host_gens = {}

    def on_host(cfg, dtype=torch.float32, device=None, seed=0):
        return real(cfg, dtype=dtype, device="cpu", seed=seed).to(device)

    def host_draw(self, generator, latents):
        gen = host_gens.setdefault(id(generator), torch.Generator().manual_seed(
            generator.initial_seed()))
        return draw(self, gen, latents)

    runs = {}
    with mock.patch.object(train, "WanModel", on_host), \
            mock.patch.object(RouterTrainStep, "draw", host_draw):
        for dev in ("cuda", "cpu"):
            host_gens.clear()
            _build.reset_launches()
            runs[dev] = train.main(["--model", "wan-tiny", "--dtype", "fp32", "--device", dev,
                                    "--synthetic_data", "--max_train_steps", "2",
                                    "--gradient_accumulation_steps", "1",
                                    "--output_dir", str(tmp_path / dev)])
            if dev == "cuda":
                n = dict(_build.launches)
    assert torch.backends.cudnn.allow_tf32 is False
    assert n["flash"] == n["flash_f32"] > 0 and n["flash_lse"] > 0
    assert n["flash_dq"] == n["flash_dq_f32"] > 0 and n["flash_dkv"] == n["flash_dkv_f32"] > 0
    assert n["flash_wgmma"] == n["flash_dq_wgmma"] == n["flash_dkv_wgmma"] == 0
    a, b = (torch.cat([r.router_final[k].flatten() for k in sorted(r.router_final)])
            for r in (runs["cuda"], runs["cpu"]))
    assert ((a - b).norm() / b.norm()).item() <= 1e-3
    assert all(np.isfinite(m["loss"]) for m in runs["cuda"].metrics)
