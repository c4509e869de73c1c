"""The Hopper path's shape rule (``ops/flash.py:wgmma_path``,
``ops/flash_manual.py:manual_wgmma_path``), held on the CPU against the
calls the port's served and trained paths make: every served geometry
takes the wgmma kernel (Wan's routed FULL / LOWRES ``ExpertCall``s at 480p
and 720p, self- and cross-attention, HunyuanVideo's joint layouts and its
STA text rows, training's FULL / LOWRES / cross-attention; flash_manual's
int8 QK mode too), while D = 64, the 96-, 360- and 24-token STA tiles and
flash_manual's stable softmax stay on the mma.sync kernel.  The card tests
(``tests/test_torch_port_cuda.py``) hold both kernels against their plain
versions and count the launches each rule sends to the Hopper path."""

import dataclasses

import pytest
import torch

from vorta_tpu_torch.cli.sample import attention_config
from vorta_tpu_torch.ops import experts
from vorta_tpu_torch.ops.flash import wgmma_path
from vorta_tpu_torch.ops.flash_manual import manual_wgmma_path
from vorta_tpu_torch.ops.joint_experts import JointConfig, joint_layouts
from vorta_tpu_torch.ops.routed_fused import routed_geometry

WAN_GRIDS = {"480p_77f": (20, 30, 52), "720p_77f": (20, 45, 80), "480p_21f": (6, 30, 52)}
WAN_ROUTED = {"480p_77f": ((20, 30, 52), (4, 6, 4)), "720p_77f": ((20, 45, 80), (5, 9, 8))}
HY_GRIDS = {"45f": (12, 45, 80), "117f": (30, 45, 80)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def spy_blocks(monkeypatch):
    """Record the (block_q, block_kv) of every make_sparse_attention call the
    experts make; the attention itself returns zeros of q's shape."""
    seen = []

    def fake(tables, *, n_kv_blocks, scale=None, block_q, block_kv, kv_valid_len=None,
             xla_bwd=False):
        seen.append((block_q, block_kv))
        return lambda q, k, v: torch.zeros_like(q)

    monkeypatch.setattr(experts, "make_sparse_attention", fake)
    return seen


@pytest.mark.parametrize("name", sorted(WAN_ROUTED))
@pytest.mark.parametrize("expert", ["full", "lowres"])
def test_routed_wan_expert_calls_take_the_hopper_path(name, expert):
    grid, tile = WAN_ROUTED[name]
    cfg = dataclasses.replace(attention_config("wan-1_3B", grid), sta_tile=tile)
    call = getattr(routed_geometry(cfg), expert)
    assert manual_wgmma_path(128, call.block_q, call.block_kv)  # bf16 or int8 QK
    assert wgmma_path(128, call.block_q, call.block_kv)
    # the stable softmax (on no served path) stays on mma.sync at the same shape
    assert not manual_wgmma_path(128, call.block_q, call.block_kv, stable=True)


@pytest.mark.parametrize("name", sorted(WAN_GRIDS))
def test_wan_self_and_cross_attention_take_the_hopper_path(name, spy_blocks):
    """Routing off (and the trainer's teacher): full_attention over the raster
    sequence, then padded_dense_attention to the 512 text tokens."""
    cfg = attention_config("wan-1_3B", WAN_GRIDS[name])
    s = cfg.seq_len
    q = torch.zeros((1, 1, s, 128))
    experts.full_attention(q, q, q, cfg)
    text = torch.zeros((1, 1, 512, 128))
    experts.padded_dense_attention(q, text, text)
    assert len(spy_blocks) == 2
    for bq, bkv in spy_blocks:
        assert wgmma_path(128, bq, bkv), (bq, bkv)
    assert spy_blocks[1] == ((2048, 512) if s >= 8192 else (512, 512))


@pytest.mark.parametrize("name", sorted(HY_GRIDS))
@pytest.mark.parametrize("layout", ["full", "lowres", "sta_text_rows"])
def test_hunyuan_joint_layouts_take_the_hopper_path(name, layout):
    cfg = attention_config("hunyuan-13B", HY_GRIDS[name])
    lay = joint_layouts(JointConfig(cfg, 256))[layout]
    assert manual_wgmma_path(128, lay.block_q, lay.block_kv), (lay.block_q, lay.block_kv)
    if layout == "sta_text_rows":
        assert (lay.block_q, lay.block_kv) == (256, 1024)


@pytest.mark.parametrize("grid", [(20, 30, 52), (10, 45, 80)])
def test_training_full_lowres_and_cross_take_the_hopper_path(grid, spy_blocks):
    """The trainer's student experts FULL and LOWRES and its cross-attention,
    at the JAX trainer's default geometry and the bench router's."""
    cfg = attention_config("wan-1_3B", grid)
    q = torch.zeros((1, 1, cfg.seq_len, 128))
    experts.full_attention(q, q, q, cfg)
    experts.lowres_attention(q, q, q, cfg)
    text = torch.zeros((1, 1, 512, 128))
    experts.padded_dense_attention(q, text, text)
    assert len(spy_blocks) == 3 and all(wgmma_path(128, *b) for b in spy_blocks), spy_blocks


@pytest.mark.parametrize("grid,tile,tokens", [
    ((20, 30, 52), (4, 6, 4), 96),    # the JAX trainer's STA tiles
    ((10, 45, 80), (5, 9, 8), 360),   # the bench router's
    ((8, 30, 52), (2, 3, 4), 24),     # 24-token tiles
])
def test_sta_tiles_of_training_stay_on_mma_sync(grid, tile, tokens, spy_blocks):
    cfg = dataclasses.replace(attention_config("wan-1_3B", grid), sta_tile=tile)
    q = torch.zeros((1, 1, cfg.seq_len, 128))
    experts.sta_attention(q, q, q, cfg)
    assert spy_blocks == [(tokens, tokens)]
    assert not wgmma_path(128, tokens, tokens)


@pytest.mark.parametrize("d,block_q,block_kv,want", [
    (128, 1024, 1024, True),
    (128, 2048, 512, True),
    (128, 256, 1024, True),
    (128, 128, 128, True),
    (64, 1024, 1024, False),   # D = 64
    (128, 64, 64, False),      # blocks the 128-row CTA does not tile
    (128, 1024, 64, False),    # a kv block the 128-key ring slot does not tile
    (128, 96, 96, False),
    (128, 360, 360, False),
    (128, 24, 24, False),
    (96, 1024, 1024, False),
])
def test_shape_rule(d, block_q, block_kv, want):
    assert wgmma_path(d, block_q, block_kv) is want
    assert manual_wgmma_path(d, block_q, block_kv) is want
