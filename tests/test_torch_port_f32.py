"""The f32 serving path's rules on the CPU: which kernel entry each wrapper
asks for with f32 tensors off the CPU, what still raises (naming its
ROADMAP item), the STA kernel choice at f32's itemsize against the JAX
package's gates, the entry points that took f32 on CUDA, and the f32 plain
versions against the Pallas kernels where no other port test holds them.

Meta tensors stand for CUDA ones: the wrappers' device check is let
through and the first library entry a wrapper asks for is recorded and
stops it before any build or launch (there is no nvcc here).  The card
runs the f32 kernels themselves: ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``'s f32 phases.  Tolerances against Pallas: f32 on both
sides, rtol 1e-4 and atol 1e-4 x the output's max |value| (XLA-CPU and
PyTorch sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.ops import sta_pipe as jsta_pipe
from vorta_tpu.ops.flash import sparse_flash_attention_raw as jax_flash
from vorta_tpu.ops.flash_manual import sparse_flash_attention_manual as jax_manual
from vorta_tpu.ops.sta_batched import sta_flash_headbatched as jax_batched
from vorta_tpu.ops.sta_row import supports_row_dense as jax_supports_row_dense
from vorta_tpu.ops.sta_window import prefer_window_dense as jax_prefer_window_dense
from vorta_tpu_torch.config import AttentionConfig
from vorta_tpu_torch.geometry import build_lowres_groups
from vorta_tpu_torch.ops import _build
from vorta_tpu_torch.ops import joint_experts as joint
from vorta_tpu_torch.ops import routed_fused as routed
from vorta_tpu_torch.ops.coreset_pallas import pool_qkv, unpool, unpool_layout
from vorta_tpu_torch.ops.flash import sparse_flash_attention_raw, tables_from_block_mask
from vorta_tpu_torch.ops.flash_manual import sparse_flash_attention_manual
from vorta_tpu_torch.ops.fused_norm import fused_norm, fused_residual_norm
from vorta_tpu_torch.ops.prologue import fused_qk_prologue, prologue_layout
from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched
from vorta_tpu_torch.ops.sta_pipe import sta_pipe_attention
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


class _Reached(Exception):
    """A wrapper asked the library for a kernel entry: it passed its checks."""


@pytest.fixture
def meta_card(monkeypatch):
    """Meta tensors take the CUDA branch of every wrapper; returns the list
    of (library, entry) the wrappers ask for, each ask raising _Reached."""
    asked = []

    class Library:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            asked.append((self.name, entry))
            raise _Reached(entry)

    monkeypatch.setattr(_build, "require_cuda", lambda *tensors: tensors[0].device)
    monkeypatch.setattr(_build, "load", Library)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return asked


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


GROUPS = build_lowres_groups((4, 4, 4), (2, 2, 2))


def _calls(dtype):
    """One call of each of the eight kernels' wrappers on meta tensors, and
    of the window-dense kernels and the int8 QK modes: int8 q / k with a v
    of ``dtype`` in flash_manual and sta_pipe (int8 text keys), sta_window
    and sta_row."""
    ki = torch.zeros((1, 2, 2), dtype=torch.int32)
    kc = torch.full((1, 2), 2, dtype=torch.int32)
    q = _t(1, 2, 64, 64, dtype=dtype)
    q8 = _t(1, 2, 64, 64, dtype=torch.int8)
    qw = _t(1, 2, 4 * 6 * 16, 128, dtype=dtype)  # a geometry both window-dense kernels take
    wgrid = dict(latent_shape=(4, 6, 16), tile=(2, 3, 8))
    x = _t(1, 64, 256, dtype=dtype)
    cos = _t(64, 32)
    bits = torch.full((1, 2, 2), -1, dtype=torch.int32)
    picks = torch.zeros((1, 2, 2, 2, 2, GROUPS.num_kept_margins), dtype=torch.int32,
                        device="meta")
    act = torch.ones(2, dtype=torch.int32)
    return {
        "flash": lambda: sparse_flash_attention_raw(q, q, q, ki, kc, block_q=32, block_kv=32,
                                                    kv_valid_len=60),
        "flash_manual": lambda: sparse_flash_attention_manual(
            q, q, q, ki, kc, block_q=32, block_kv=32, kv_bias=_t(1, 64), softmax="stable"),
        "sta_pipe": lambda: sta_pipe_attention(
            q, q, q, act, latent_shape=(4, 4, 4), tile=(2, 2, 2),
            text_k=_t(1, 2, 8, 64, dtype=dtype), text_v=_t(1, 2, 8, 64, dtype=dtype)),
        "sta_batched": lambda: sta_flash_headbatched(q, q, q, ki, kc, act, pair_bits=bits,
                                                     tokens_per_tile=8, block_q=32, block_kv=32,
                                                     kv_bias=_t(1, 64), softmax="fast"),
        "fused_norm": lambda: fused_norm(x, _t(1, 256), _t(1, 256), None, None, False, 1e-6,
                                         False),
        "prologue": lambda: fused_qk_prologue(x, x, x, _t(256), _t(256), cos, cos,
                                              num_heads=4),
        "pool_qkv": lambda: pool_qkv(q, q, q, GROUPS, active=act, return_picks=True),
        "unpool": lambda: unpool(q[:, :, :GROUPS.pooled_length], q, GROUPS, picks=picks,
                                 active=act),
        "flash_manual_int8_f32_v": lambda: sparse_flash_attention_manual(
            q8, q8, q, ki, kc, block_q=32, block_kv=32, qk_scale=torch.ones(2),
            softmax="fast"),
        "sta_pipe_int8_f32_v": lambda: sta_pipe_attention(
            q8, q8, q, act, qk_scale=torch.ones(2), latent_shape=(4, 4, 4), tile=(2, 2, 2),
            text_k=_t(1, 2, 8, 64, dtype=torch.int8), text_v=_t(1, 2, 8, 64, dtype=dtype)),
        "sta_window": lambda: sta_window_attention(qw, qw, qw, act, **wgrid),
        "sta_row": lambda: sta_row_attention(qw, qw, qw, act, **wgrid),
    }


ENTRIES = {  # (library, f32 entry, bf16 entry)
    "flash": ("flash", "vorta_flash_fwd_f32", "vorta_flash_fwd_bf16"),
    "flash_manual": ("flash_manual", "vorta_flash_manual_fwd_f32",
                     "vorta_flash_manual_fwd_bf16"),
    "sta_pipe": ("sta_pipe", "vorta_sta_fwd_f32", "vorta_sta_fwd_bf16"),
    "sta_batched": ("sta_batched", "vorta_sta_batched_fwd_f32", "vorta_sta_batched_fwd_bf16"),
    "fused_norm": ("fused_norm", "vorta_fused_norm", "vorta_fused_norm"),
    "prologue": ("prologue", "vorta_qk_prologue", "vorta_qk_prologue"),
    "pool_qkv": ("coreset_pool", "vorta_coreset_pool_f32", "vorta_coreset_pool_bf16"),
    "unpool": ("coreset_pool", "vorta_coreset_unpool_f32", "vorta_coreset_unpool_bf16"),
    "flash_manual_int8_f32_v": ("flash_manual", "vorta_flash_manual_fwd_f32",
                                "vorta_flash_manual_fwd_bf16"),
    "sta_pipe_int8_f32_v": ("sta_pipe", "vorta_sta_fwd_f32", "vorta_sta_fwd_bf16"),
    "sta_window": ("sta_window", "vorta_sta_window_fwd_f32", "vorta_sta_window_fwd_bf16"),
    "sta_row": ("sta_row", "vorta_sta_row_fwd_f32", "vorta_sta_row_fwd_bf16"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", sorted(ENTRIES))
def test_wrappers_take_f32_to_their_f32_entry(meta_card, kernel, dtype):
    """Off the CPU an f32 call passes every check and asks for its f32
    kernel (the norm and the prologue: their one entry, told the dtype); a
    bf16 call asks for the bf16 entry.  Nothing casts or falls back."""
    with pytest.raises(_Reached):
        _calls(dtype)[kernel]()
    lib, f32_entry, bf16_entry = ENTRIES[kernel]
    assert meta_card == [(lib, f32_entry if dtype == torch.float32 else bf16_entry)]


def _unported():
    ki = torch.zeros((1, 2, 2), dtype=torch.int32)
    kc = torch.full((1, 2), 2, dtype=torch.int32)
    q = _t(1, 2, 64, 64)
    act = torch.ones(2, dtype=torch.int32)
    grid = dict(latent_shape=(4, 4, 4), tile=(2, 2, 2))
    from vorta_tpu_torch.tools.bench_pool import copy_probe
    from vorta_tpu_torch.tools.sta_diag import sta_diag_attention

    return {
        "sta_pipe_variant": ("A7", lambda: sta_pipe_attention(
            _t(1, 2, 4 * 4 * 16, 64), _t(1, 2, 4 * 4 * 16, 64), _t(1, 2, 4 * 4 * 16, 64), act,
            latent_shape=(4, 4, 16), tile=(2, 2, 8), variant="dots")),
        "fused_residual_norm": ("A6", lambda: fused_residual_norm(
            _t(1, 4, 256), _t(1, 4, 256), None, None, None, None, None, 1e-6)),
        "sta_diag": ("A7", lambda: sta_diag_attention(q, q, q, **grid)),
        "copy_probe": ("A7", lambda: copy_probe(q, q, q, GROUPS)),
        "flash_d96": ("D 64/128", lambda: sparse_flash_attention_raw(
            _t(1, 2, 64, 96), _t(1, 2, 64, 96), _t(1, 2, 64, 96), ki, kc, block_q=32,
            block_kv=32)),
        "sta_pipe_d96": ("D 64/128", lambda: sta_pipe_attention(
            _t(1, 2, 64, 96), _t(1, 2, 64, 96), _t(1, 2, 64, 96), act, **grid)),
    }


@pytest.mark.parametrize("case", sorted(_unported()))
def test_what_stays_unported_raises_naming_its_roadmap_item(meta_card, case):
    """f32 where this slice ports nothing raises NotImplementedError naming
    the ROADMAP row that holds it (or the shape rule), before any library
    is asked for."""
    item, call = _unported()[case]
    with pytest.raises(NotImplementedError, match=item):
        call()
    assert meta_card == []


def _int8_mixes():
    ki = torch.zeros((1, 2, 2), dtype=torch.int32)
    kc = torch.full((1, 2), 2, dtype=torch.int32)
    q8, q, qb = _t(1, 2, 64, 64, dtype=torch.int8), _t(1, 2, 64, 64), _t(1, 2, 64, 64,
                                                                          dtype=torch.bfloat16)
    t8, tv = _t(1, 2, 8, 64, dtype=torch.int8), _t(1, 2, 8, 64)
    act = torch.ones(2, dtype=torch.int32)
    qs = torch.ones(2)
    grid = dict(latent_shape=(4, 4, 4), tile=(2, 2, 2), qk_scale=qs)
    manual = dict(block_q=32, block_kv=32, qk_scale=qs, softmax="fast")
    return {
        "flash_manual_int8_q_f32_k": (ValueError, lambda: sparse_flash_attention_manual(
            q8, q, q, ki, kc, **manual)),
        "flash_manual_int8_qk_f16_v": (NotImplementedError, lambda: sparse_flash_attention_manual(
            q8, q8, q.half(), ki, kc, **manual)),
        "sta_pipe_int8_q_bf16_k": (ValueError, lambda: sta_pipe_attention(q8, qb, q, act, **grid)),
        "sta_pipe_int8_text_k_no_text_v": (ValueError, lambda: sta_pipe_attention(
            q8, q8, q, act, text_k=t8, **grid)),
        "sta_pipe_bf16_text_v_beside_f32_v": (NotImplementedError, lambda: sta_pipe_attention(
            q8, q8, q, act, text_k=t8, text_v=tv.bfloat16(), **grid)),
        "sta_pipe_f32_text_v_beside_bf16_v": (NotImplementedError, lambda: sta_pipe_attention(
            q8, q8, qb, act, text_k=t8, text_v=tv, **grid)),
        "sta_pipe_f32_text_k_with_qk_scale": (ValueError, lambda: sta_pipe_attention(
            q8, q8, q, act, text_k=tv, text_v=tv, **grid)),
    }


@pytest.mark.parametrize("case", sorted(_int8_mixes()))
def test_int8_qk_modes_refuse_mixed_dtypes(meta_card, case):
    """The int8 QK modes take int8 q / k (and text keys) with a bf16 or an
    f32 v of one dtype with text_v: any other mix raises before a library
    is asked for."""
    error, call = _int8_mixes()[case]
    with pytest.raises(error):
        call()
    assert meta_card == []


# --- the STA kernel choice at f32's itemsize ------------------------------------

def _jax_routed_choice(cfg, d, itemsize):
    """The JAX package's routed dispatch from its own gates
    (routed_fused.py:40-51, :384-386)."""
    shape, tile, window = cfg.latent_shape, cfg.sta_tile, cfg.sta_window
    pipe = jsta_pipe.supports_pipe(shape, tile, d, itemsize, window=window)
    if not (jax_prefer_window_dense(shape, tile) or pipe):
        return "sta_batched"
    if pipe:
        return "sta_pipe"
    if jax_supports_row_dense(shape, tile, d, itemsize, window=window):
        return "sta_row"
    return "sta_window"


def _jax_joint_choice(cfg, lt, d, itemsize):
    """The JAX package's joint dispatch (joint_experts.py:291, :340-349)."""
    shape, tile, window = cfg.latent_shape, cfg.sta_tile, cfg.sta_window
    if not (jax_prefer_window_dense(shape, tile) and lt % 8 == 0):
        return "sta_batched"
    if jsta_pipe.supports_pipe(shape, tile, d, itemsize, text_len=lt, window=window):
        return "sta_pipe"
    if jax_supports_row_dense(shape, tile, d, itemsize, text_len=lt, window=window):
        return "sta_row"
    return "sta_window"


GEOMETRIES = [  # (latent, tile, window, head dim, joint text length or None)
    ((20, 30, 52), (4, 6, 4), (3, 3, 3), 128, None),   # Wan 480p x 77f
    ((6, 30, 52), (4, 6, 4), (3, 3, 3), 128, None),    # Wan 480p x 21f
    ((20, 45, 80), (4, 6, 4), (3, 3, 3), 128, None),   # Wan 720p at the CLI's tile
    ((20, 45, 80), (5, 9, 8), (3, 3, 3), 128, None),
    ((20, 45, 80), (4, 9, 10), (3, 3, 3), 128, None),
    ((4, 4, 4), (2, 2, 2), (3, 3, 1), 64, None),       # wan-tiny
    ((12, 45, 80), (6, 9, 8), (3, 3, 3), 128, 256),    # HunyuanVideo-13B 45f
    ((12, 45, 80), (2, 9, 8), (3, 3, 3), 128, 256),
    ((12, 45, 80), (4, 9, 10), (3, 3, 3), 128, 256),
    ((8, 45, 80), (4, 9, 10), (3, 3, 3), 128, None),   # Wan 720p x 29f, the f32 smoke's
    ((30, 45, 80), (6, 9, 8), (3, 3, 3), 128, 256),    # 117f
    ((4, 6, 16), (2, 2, 2), (3, 3, 3), 64, 24),        # hunyuan-tiny
    ((4, 6, 16), (4, 6, 8), (3, 3, 3), 64, 24),
]


@pytest.mark.parametrize("latent,tile,window,d,lt", GEOMETRIES)
def test_sta_kernel_choice_at_f32_matches_jax_gates(latent, tile, window, d, lt):
    """The port's dispatch chooses at the true itemsize (4 in f32) what the
    JAX package's VMEM gates choose there (and at 2 in bf16)."""
    kw = dict(latent_shape=latent, sta_tile=tile, sta_window=window)
    cfg, jcfg = AttentionConfig(**kw), JaxAttentionConfig(**kw)
    for itemsize in (4, 2):
        if lt is None:
            assert routed.routed_sta_kernel(cfg, d, itemsize) == _jax_routed_choice(
                jcfg, d, itemsize)
        else:
            assert joint.joint_sta_kernel(joint.JointConfig(cfg, lt), d, itemsize) == \
                _jax_joint_choice(jcfg, lt, d, itemsize)


# --- the layout rules at f32's itemsize -------------------------------------------

@pytest.mark.parametrize("dim,heads,layout", [
    (1536, 12, (2, 6)), (3072, 24, (4, 6)), (5120, 40, (8, 5)), (128, 2, None),
    (1024, 8, (2, 4)), (640, 5, (1, 5)), (7680, 60, None)])
def test_prologue_layout_in_f32(dim, heads, layout):
    """16-byte chunks of 4 f32: a lane holds as many bytes as in bf16, so a
    row takes twice the warps (eight at Wan-14B's width); bf16 unchanged."""
    assert prologue_layout(dim, heads, 4) == layout
    if layout is not None and layout[0] > 1:
        assert prologue_layout(dim, heads) == (layout[0] // 2, layout[1])


@pytest.mark.parametrize("d,gs,kept,layout", [
    (128, 12, 5, (1, 16, 8)), (128, 12, 11, (1, 16, 16)), (64, 12, 5, (2, 8, 4)),
    (64, 8, 3, (2, 4, 2)), (128, 17, 5, None), (64, 32, 10, (2, 16, 8))])
def test_unpool_layout_in_f32(d, gs, kept, layout):
    """unpool's batched copy moves 128 / d rows an instruction in f32; past
    16 stores a lane (f32, d = 128, more than 16 slots) the rule gives no
    layout and the first design's kernel runs."""
    assert unpool_layout(d, gs, kept, 4) == layout


# --- the entry points ------------------------------------------------------------

def _entries():
    from vorta_tpu_torch.cli import bench_compare, sample
    from vorta_tpu_torch.tools import fit_cache_poly

    tiny = ["--num_frames", "13", "--height", "64", "--width", "64", "--random_embeds",
            "--num_inference_steps", "1"]
    return {
        "sample_wan_tiny": lambda: sample.main(
            ["--model", "wan-tiny", "--dtype", "fp32", *tiny]),
        "sample_hunyuan_tiny": lambda: sample.main(
            ["--model", "hunyuan-tiny", "--dtype", "fp32", *tiny]),
        "sample_wan_1_3b": lambda: sample.main(["--model", "wan-1_3B", "--dtype", "fp32",
                                                "--random_embeds"]),
        "bench_compare_wan_tiny": lambda: bench_compare.main(["--model", "wan-tiny"]),
        "bench_compare_hunyuan_tiny": lambda: bench_compare.main(["--model", "hunyuan-tiny"]),
        "fit_cache_poly": lambda: fit_cache_poly.main(["--steps", "2"]),
    }


@pytest.mark.parametrize("entry", sorted(_entries()))
def test_entry_points_take_f32_on_cuda(entry, monkeypatch, capsys):
    """f32 on the card is served: without a card the run stops at the
    device check (RuntimeError), not at an f32 refusal (SystemExit)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entries()[entry]()
    assert "A3" not in capsys.readouterr().err


def test_the_trainer_takes_f32_on_cuda(monkeypatch, tmp_path):
    """Training in f32 on the card is ported: --dtype fp32 parses at the
    default device, and a run without a card stops at the device check,
    not at an f32 refusal."""
    from vorta_tpu_torch.cli import train

    args = train.parse_args(["--dtype", "fp32", "--output_dir", str(tmp_path)])
    assert (args.dtype, args.device) == ("fp32", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--dtype", "fp32", "--output_dir", str(tmp_path)])


# --- f32 plain versions against Pallas where no other port test holds them --------

def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(np.abs(want).max(), 1e-6))


def test_flash_f32_blocks_of_16_with_a_tail_matches_pallas():
    """wan-tiny's flash blocks (16 rows, D 64) with per-head tables, count-0
    q blocks and the tail rule: the f32 kernel's smallest table walk."""
    rng = np.random.default_rng(19)
    q, k, v = (rng.standard_normal((1, 2, 96, 64)).astype(np.float32) for _ in range(3))
    mask = rng.random((2, 6, 6)) < 0.5
    mask[:, 0, :] = False
    mask[:, 1, 5] = True
    tab = tables_from_block_mask(mask)
    kw = dict(scale=64**-0.5, block_q=16, block_kv=16, kv_valid_len=90)
    want = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tab.kv_index),
                     jnp.asarray(tab.kv_count), interpret=True, **kw)
    got = sparse_flash_attention_raw(*(torch.from_numpy(x) for x in (q, k, v)), tab.kv_index,
                                     tab.kv_count, **kw)
    _close(got, want)


def test_flash_manual_f32_stable_8_row_blocks_bias_tail_matches_pallas():
    """The stable softmax at 8-row blocks with kv_bias, kv_valid_len and a
    head routed away (count 0): the f32 mode's smallest blocks, every mask
    hook at once."""
    rng = np.random.default_rng(20)
    q, k, v = (rng.standard_normal((1, 3, 64, 64)).astype(np.float32) for _ in range(3))
    bias = np.where(rng.random(64) < 0.3, -1e30, rng.standard_normal(64)).astype(np.float32)
    mask = rng.random((1, 8, 8)) < 0.6
    mask[:, :, 0] = True
    tab = tables_from_block_mask(mask)
    counts = np.broadcast_to(tab.kv_count, (3, 8)).copy()
    counts[1] = 0
    kw = dict(scale=0.9 * 64**-0.5, block_q=8, block_kv=8, kv_valid_len=61, softmax="stable")
    want = jax_manual(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tab.kv_index),
                      jnp.asarray(counts), kv_bias=jnp.asarray(bias[None]), interpret=True, **kw)
    got = sparse_flash_attention_manual(*(torch.from_numpy(x) for x in (q, k, v)),
                                        torch.from_numpy(tab.kv_index), torch.from_numpy(counts),
                                        kv_bias=torch.from_numpy(bias[None]), **kw)
    _close(got, want)
    assert not got[:, 1].any()


def test_sta_batched_f32_stable_hunyuan_tiny_joint_matches_pallas():
    """hunyuan-tiny's joint layout (8-token tiles, blocks 40 / 48) in the
    stable softmax with pair bits and the text bias, a head routed away."""
    kw_cfg = dict(latent_shape=(4, 6, 16), sta_tile=(2, 2, 2), sta_window=(3, 3, 3),
                  lowres_window=(2, 2, 2), block_q=32, block_kv=32, sta_block_q=8,
                  sta_block_kv=8)
    tj = joint.JointConfig(AttentionConfig(**kw_cfg), 24)
    lay = joint.joint_layouts(tj)["sta"]
    tables = joint._joint_sta_tables(tj)
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal((1, 2, lay.total, 64)).astype(np.float32) for _ in range(3))
    mask = np.arange(24)[None] < 17
    bias = joint._bias(torch.from_numpy(mask), lay, tj.video.seq_len)
    active = np.asarray([1, 0], np.int32)
    kw = dict(tokens_per_tile=8, block_q=lay.block_q, block_kv=lay.block_kv, softmax="stable")
    want = jax_batched(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tables.kv_index),
                       jnp.asarray(tables.kv_count), jnp.asarray(active),
                       pair_bits=jnp.asarray(tables.pair_bits),
                       kv_bias=jnp.asarray(bias.numpy()), interpret=True, **kw)
    got = sta_flash_headbatched(*(torch.from_numpy(x) for x in (q, k, v)), tables.kv_index,
                                tables.kv_count, torch.from_numpy(active),
                                pair_bits=tables.pair_bits, kv_bias=bias, **kw)
    rows = np.r_[0:tj.video.seq_len, lay.text_off:lay.text_off + 17]  # what the caller reads
    _close(got[:, :, rows], np.asarray(want)[:, :, rows])
