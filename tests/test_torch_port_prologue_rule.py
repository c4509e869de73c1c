"""The qk prologue's warp-per-row kernel on the CPU: its layout rule
(``ops/prologue.py:prologue_layout``), its lane map mirrored in Python
(each element's warp, lane and chunk, the ``lane ^ 8`` rotation partner,
the sums of squares in the kernel's order for row and head scope) and
applied to CPU tensors against the plain version ``_prologue_ref`` (bitwise
without the norm, within one bf16 ulp with it, since only the order of the
sum of squares differs; the rotated outputs within the card's tolerance,
since a rotation whose products cancel can turn a one-ulp input into more
ulps of its result), once against the JAX package's
``fused_qk_prologue`` in interpret mode, and HunyuanVideo's per-module
copy of its repeated gains.  The card tests (``tests/test_torch_port_cuda.py``)
hold the kernel itself to the plain version and to the block-per-row
kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorta_tpu.ops.prologue import fused_qk_prologue as jax_prologue
from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanJointAttention, _row_gains
from vorta_tpu_torch.ops.prologue import _prologue_ref, fused_qk_prologue, prologue_layout


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the layout rule ------------------------------------------------------------------------

@pytest.mark.parametrize("dim,heads,layout", [
    (1536, 12, (1, 6)),    # Wan-1.3B: 6 chunks a lane, one warp a row
    (3072, 24, (2, 6)),    # HunyuanVideo-13B: 12 chunks, two warps
    (5120, 40, (4, 5)),    # Wan-14B: 20 chunks, four warps
    (256, 2, (1, 1)),      # the card tests' widths
    (512, 4, (1, 2)),
    (2048, 16, (2, 4)),
    (6144, 48, (4, 6)),
    (384, 3, None),        # an odd head count: half a chunk
    (128, 2, None),        # head dim 64 (the tiny models)
    (1792, 14, None),      # 7 chunks: more than 6 a lane, and no warp count divides them
    (7168, 56, None),      # 28 chunks: 7 a lane at four warps
])
def test_prologue_layout(dim, heads, layout):
    assert prologue_layout(dim, heads) == layout


# --- the lane map, mirrored -----------------------------------------------------------------

def _lane_map(dim, heads):
    """(column, partner column) of every (warp of the row, lane, chunk,
    element): lane l of warp w holds columns 8 * ((c * WPR + w) * 32 + l) +
    e, its rotation partner in lane l ^ 8."""
    wpr, ch = prologue_layout(dim, heads)
    w, lane, c, e = np.meshgrid(np.arange(wpr), np.arange(32), np.arange(ch), np.arange(8),
                                indexing="ij")
    col = 8 * ((c * wpr + w) * 32 + lane) + e
    partner = 8 * ((c * wpr + w) * 32 + (lane ^ 8)) + e
    return col, partner


@pytest.mark.parametrize("dim,heads", [(1536, 12), (3072, 24), (5120, 40), (256, 2)])
def test_lane_map_covers_the_row_and_pairs_the_halves(dim, heads):
    """Each column once; a head is 16 lanes of one chunk, (l & 15) * 8 + e
    its column in the head; the partner is column j +- 64 of the same head;
    the lane's cos / sin columns (l & 7) * 8 + e are j mod 64."""
    col, partner = _lane_map(dim, heads)
    assert np.array_equal(np.sort(col.ravel()), np.arange(dim))
    w, lane, c, e = np.meshgrid(*(np.arange(n) for n in col.shape), indexing="ij")
    wpr = col.shape[0]
    assert (col // 128 == (c * wpr + w) * 2 + lane // 16).all()
    assert (col % 128 == (lane & 15) * 8 + e).all()
    assert (partner // 128 == col // 128).all()
    assert (partner % 128 == (col % 128 + 64) % 128).all()
    assert ((lane & 7) * 8 + e == col % 64).all()


def _butterfly(x, offsets):
    """Lanes (axis 1) summed by xor shuffles, in the kernel's order: every
    lane gets the same f32 total."""
    lanes = np.arange(32)
    for o in offsets:
        x = x + x[:, lanes ^ o]
    return x


def _mirror(q, k, v, gq, gk, cos, sin, *, num_heads, eps, qk_norm, norm_scope):
    """The warp-per-row kernel's arithmetic on CPU tensors, (B, S) rows at
    once: loads by the lane map, the sums of squares as the kernel takes
    them (row: each lane over its chunks and elements, a 5-step shuffle,
    then the warps in order; head: each chunk's 8 elements, a 4-step
    shuffle), (x * r) * g rounded through bf16, the rotation against the
    lane ^ 8 partner, each output chunk stored to its head's row."""
    b, s, dim = q.shape
    d = 128
    col, partner = _lane_map(dim, num_heads)
    wpr, ch = col.shape[0], col.shape[2]
    lanes = np.arange(32)
    cs = cos.float()[:, (lanes[:, None] & 7) * 8 + np.arange(8)]  # (S, 32, 8)
    sn = sin.float()[:, (lanes[:, None] & 7) * 8 + np.arange(8)]
    lo = torch.from_numpy((lanes & 8) == 0)[:, None, None]  # (32, 1, 1) per lane
    out = []
    for x, g in ((q, gq), (k, gk)):
        xs = x.float().reshape(b * s, dim)[:, col]  # (R, WPR, 32, CH, 8)
        if qk_norm:
            if norm_scope == "row":
                acc = torch.zeros(xs.shape[:3])
                for c in range(ch):  # each chunk's 8 squares, then onto the lane's sum
                    part = torch.zeros(xs.shape[:3])
                    for e in range(8):
                        part = part + xs[..., c, e] * xs[..., c, e]
                    acc = acc + part
                per_warp = torch.stack([_butterfly(acc[:, w], (16, 8, 4, 2, 1))[:, 0]
                                        for w in range(wpr)], dim=1)
                tot = per_warp[:, 0]
                for w in range(1, wpr):
                    tot = tot + per_warp[:, w]
                f = torch.rsqrt(tot / dim + eps)[:, None, None, None, None]
            else:
                acc = torch.zeros(xs.shape[:4])
                for e in range(8):
                    acc = acc + xs[..., e] * xs[..., e]
                f = torch.rsqrt(torch.stack([_butterfly(acc[:, w], (1, 2, 4, 8))
                                             for w in range(wpr)], dim=1) / d + eps)[..., None]
            xs = ((xs * f) * g.float()[torch.from_numpy(col)]).to(torch.bfloat16).float()
        xp = xs[:, :, lanes ^ 8]  # the partner's values, lane l ^ 8
        c_ = cs.repeat(b, 1, 1)[:, None, :, None, :]  # (R, 1, 32, 1, 8)
        s_ = sn.repeat(b, 1, 1)[:, None, :, None, :]
        own, other = xs * c_, xp * s_
        o = torch.where(lo, own - other, other + own).to(torch.bfloat16)
        out.append(o)
    heads = torch.zeros((2, b * s, dim), dtype=torch.bfloat16)
    for i, o in enumerate(out):
        heads[i][:, torch.from_numpy(col.ravel())] = o.reshape(b * s, -1)
    vo = torch.zeros((b * s, dim), dtype=v.dtype)
    vo[:, torch.from_numpy(col.ravel())] = v.reshape(b * s, dim)[:, col].reshape(b * s, -1)

    def head_major(t):
        return t.reshape(b, s, num_heads, d).transpose(1, 2)

    return head_major(heads[0]), head_major(heads[1]), head_major(vo)


def _bf16_ulps(a, b):
    """max |a - b| in bf16 ulps of the larger of the two, element by element."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return ((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max().item()


def _inputs(b, s, heads, seed, strided=False, text_rows=0):
    rng = np.random.default_rng(seed)
    dim = heads * 128
    width = 3 * dim + (256 if strided else 0)
    qkv = torch.from_numpy(3.0 * rng.standard_normal((b, s, width), np.float32)).bfloat16()
    q, k, v = qkv[..., :3 * dim].split(dim, dim=-1)
    if not strided:
        q, k, v = (x.contiguous() for x in (q, k, v))
    gq, gk = (torch.from_numpy((1 + 0.1 * rng.standard_normal(dim)).astype(np.float32))
              for _ in range(2))
    ang = torch.from_numpy(rng.uniform(0, 6.28, (s, 64)).astype(np.float32))
    cos, sin = ang.cos(), ang.sin()
    if text_rows:  # HunyuanVideo's text rows: the identity rotation
        cos[-text_rows:], sin[-text_rows:] = 1.0, 0.0
    return q, k, v, gq, gk, cos, sin


@pytest.mark.parametrize("norm_scope", ["row", "head"])
@pytest.mark.parametrize("heads", [2, 12, 24, 40])
def test_mirror_without_the_norm_is_bitwise_the_plain_version(heads, norm_scope):
    """The loads, the partner's half and the rotation's separate products
    and sum, and the head-major stores: bit for bit."""
    args = _inputs(2, 5, heads, 1, strided=True)
    kw = dict(num_heads=heads, eps=1e-6, qk_norm=False, norm_scope=norm_scope)
    for got, want in zip(_mirror(*args, **kw), _prologue_ref(*args, **kw)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("norm_scope", ["row", "head"])
@pytest.mark.parametrize("heads", [2, 12, 24, 40])
def test_mirror_with_the_norm_is_within_one_ulp(heads, norm_scope):
    """The kernel's order of the sums of squares against the plain
    version's: the normalised values (read through an identity rotation,
    cos = 1 and sin = 0) within one bf16 ulp, v bitwise; the rotated
    outputs within the card's tolerance (a one-ulp input can move a
    rotation whose two products cancel by more than one ulp of its
    result)."""
    q, k, v, gq, gk, cos, sin = _inputs(2, 7, heads, 2, text_rows=3)
    kw = dict(num_heads=heads, eps=1e-6, qk_norm=True, norm_scope=norm_scope)
    one, zero = torch.ones_like(cos), torch.zeros_like(sin)
    got = _mirror(q, k, v, gq, gk, one, zero, **kw)
    want = _prologue_ref(q, k, v, gq, gk, one, zero, **kw)
    assert max(_bf16_ulps(a, b) for a, b in zip(got[:2], want[:2])) <= 1
    assert torch.equal(got[2], want[2])
    got = _mirror(q, k, v, gq, gk, cos, sin, **kw)
    want = _prologue_ref(q, k, v, gq, gk, cos, sin, **kw)
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        floor = torch.maximum(b.abs(), b.pow(2).mean().sqrt())
        assert ((a - b).abs() / floor).max().item() <= 2.0**-5


@pytest.mark.parametrize("case", ["row", "head_text", "no_norm_strided"])
def test_mirror_and_port_match_jax(case):
    """Once against the JAX package's fused_qk_prologue in interpret mode at
    the warp-per-row layout (1, 1): row scope; head scope with text rows
    (cos = 1, sin = 0); qk_norm off on strided column slices.  q and k
    within 2^-7 of max(|JAX|, RMS(JAX)) per element (one bf16 ulp at the
    element's magnitude, XLA's sums and products rounding in their own
    order), v exact."""
    heads = 2
    scope = "row" if case == "row" else "head"
    qk_norm = case != "no_norm_strided"
    q, k, v, gq, gk, cos, sin = _inputs(2, 32, heads, 3, strided=not qk_norm,
                                        text_rows=8 if case == "head_text" else 0)
    kw = dict(num_heads=heads, eps=1e-6, qk_norm=qk_norm, norm_scope=scope)

    def jx(t):
        return jnp.asarray(t.float().contiguous().numpy()).astype(jnp.bfloat16)

    gains = (jnp.asarray(gq.numpy()), jnp.asarray(gk.numpy())) if qk_norm else (None, None)
    ref = jax_prologue(jx(q), jx(k), jx(v), *gains, jnp.asarray(cos.numpy()),
                       jnp.asarray(sin.numpy()), interpret=True, **kw)
    ref = [torch.from_numpy(np.array(r.astype(jnp.float32))) for r in ref]
    for got in (_mirror(q, k, v, gq, gk, cos, sin, **kw),
                fused_qk_prologue(q, k, v, gq if qk_norm else None, gk if qk_norm else None,
                                  cos, sin, **kw)):
        for a, b in zip(got[:2], ref[:2]):
            floor = torch.maximum(b.abs(), b.pow(2).mean().sqrt())
            assert ((a.float() - b).abs() / floor).max().item() <= 2.0**-7
        assert torch.equal(got[2].float(), ref[2])


# --- HunyuanVideo's repeated gains, made once per module ---------------------------------------

def test_hunyuan_gains_are_kept_until_the_weights_change():
    """The (dim,) gains the fused prologue takes: the same tensors call after
    call (no copy a call), equal to each head's gain repeated; remade after
    an in-place update of a weight, and where the weights take a gradient;
    a copy made in inference mode is not reused outside it; weights made
    under inference mode (no version counter) get fresh gains each call."""
    attn = HunyuanJointAttention(HUNYUAN_TINY, dtype=torch.float32, device="cpu")
    h = attn.num_heads
    with torch.no_grad():
        attn.norm_q.weight.uniform_(0.5, 1.5)
        attn.norm_k.weight.uniform_(0.5, 1.5)
        gq, gk = _row_gains(attn, h)
        again = _row_gains(attn, h)
        assert again[0] is gq and again[1] is gk
        assert torch.equal(gq, attn.norm_q.weight.repeat(h))
        assert torch.equal(gk, attn.norm_k.weight.repeat(h))
        attn.norm_k.weight.mul_(2.0)
        gq2, gk2 = _row_gains(attn, h)
        assert torch.equal(gk2, attn.norm_k.weight.repeat(h)) and not torch.equal(gk2, gk)
        assert torch.equal(gq2, gq)
    gq3, _ = _row_gains(attn, h)  # grad mode, weights that take a gradient: not kept
    assert gq3.requires_grad and gq3 is not gq2
    attn.requires_grad_(False)
    with torch.inference_mode():
        inf_q, _ = _row_gains(attn, h)
        assert inf_q.is_inference()
    out_q, _ = _row_gains(attn, h)
    assert not out_q.is_inference() and torch.equal(out_q, inf_q)
    with torch.inference_mode():  # weights made under inference mode: no version counter
        frozen = HunyuanJointAttention(HUNYUAN_TINY, dtype=torch.float32, device="cpu")
        first, _ = _row_gains(frozen, h)
        frozen.norm_q.weight.mul_(3.0)
        second, _ = _row_gains(frozen, h)
        assert torch.equal(second, frozen.norm_q.weight.repeat(h))
        assert torch.equal(second, 3.0 * first)
