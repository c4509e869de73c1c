"""Configuration dataclasses with JSON round-trip (the port's own copy of
vorta_tpu/config.py, so the port imports nothing of the JAX package).

The one config that must survive a round trip is the attention geometry: the
reference persists it to ``exp_dir/config.json`` at training time and re-reads
it at inference so routing checkpoints are interpreted with the same expert
geometry (reference: scripts/wan/train.py:219-228, scripts/wan/inference.py:125-135).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple

Shape3 = Tuple[int, int, int]


def _tuple3(x) -> Shape3:
    t = tuple(int(v) for v in x)
    if len(t) != 3:
        raise ValueError(f"expected 3 elements, got {x}")
    return t  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Static geometry of the three attention experts for one latent shape."""

    latent_shape: Shape3
    # sliding-tile expert: window is measured in tiles (reference constants:
    # wan 720p tile [5,9,8] window [3,3,3]; hunyuan tile [6,8,8])
    sta_window: Shape3 = (3, 3, 3)
    sta_tile: Shape3 = (6, 8, 8)
    # low-res expert
    lowres_window: Shape3 = (2, 2, 2)
    lowres_reduction: float = 0.5
    # kernel block sizes; sta blocks must divide prod(sta_tile)
    block_q: int = 1024
    block_kv: int = 1024
    sta_block_q: Optional[int] = None  # default: tokens per tile
    sta_block_kv: Optional[int] = None
    # routing
    tau_sparse: float = 0.3
    num_experts: int = 3
    # serving-only: run the full/lowres experts' QK^T in int8
    # (SageAttention-style, dynamic per-head symmetric scales).  Kept so a
    # config.json round-trips; the int8 path belongs to a later port slice.
    qk_int8: bool = False

    def __post_init__(self):
        object.__setattr__(self, "latent_shape", _tuple3(self.latent_shape))
        object.__setattr__(self, "sta_window", _tuple3(self.sta_window))
        object.__setattr__(self, "sta_tile", _tuple3(self.sta_tile))
        object.__setattr__(self, "lowres_window", _tuple3(self.lowres_window))

    @property
    def seq_len(self) -> int:
        t, h, w = self.latent_shape
        return t * h * w

    @property
    def tokens_per_tile(self) -> int:
        t, h, w = self.sta_tile
        return t * h * w

    @property
    def sta_blocks(self) -> Tuple[int, int]:
        bq = self.sta_block_q or self.tokens_per_tile
        bkv = self.sta_block_kv or self.tokens_per_tile
        return bq, bkv

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "AttentionConfig":
        return cls(**json.loads(s))

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "AttentionConfig":
        return cls.from_json(Path(path).read_text())


@dataclasses.dataclass(frozen=True)
class WanModelConfig:
    """Wan 2.1 DiT hyperparameters (native Flax implementation).

    Values mirror the HF diffusers configs for Wan2.1-T2V so that torch
    checkpoints import 1:1 (reference gets the model from diffusers;
    SURVEY §2.3).
    """

    dim: int = 1536
    ffn_dim: int = 8960
    num_heads: int = 12
    head_dim: int = 128
    num_layers: int = 30
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    text_len: int = 512
    freq_dim: int = 256
    patch_size: Shape3 = (1, 2, 2)
    eps: float = 1e-6
    cross_attn_norm: bool = True
    qk_norm: bool = True
    rope_theta: float = 10000.0
    image_dim: Optional[int] = None  # I2V variants: the CLIP image tokens' width (1280)

    def __post_init__(self):
        object.__setattr__(self, "patch_size", _tuple3(self.patch_size))
        if self.dim != self.num_heads * self.head_dim:
            raise ValueError(
                f"dim {self.dim} != num_heads*head_dim {self.num_heads * self.head_dim}"
            )


WAN_1_3B = WanModelConfig()
WAN_14B = WanModelConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)

# tiny configs for tests / smoke runs
WAN_TINY = WanModelConfig(
    dim=128, ffn_dim=256, num_heads=2, head_dim=64, num_layers=2,
    text_dim=32, text_len=16, freq_dim=32,
)
