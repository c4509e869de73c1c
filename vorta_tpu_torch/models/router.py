"""Per-block routing MLP (counterpart of vorta_tpu/models/router.py).

Maps the pre-projection timestep embedding to a per-head distribution over
the three attention experts: SiLU -> Linear -> softmax.  Its parameters live
in every block and carry across from the JAX model (io/from_jax.py); only
the routed modes call it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Router(nn.Module):
    def __init__(self, embedding_dim: int, heads: int, num_experts: int = 3, *, device=None):
        super().__init__()
        self.heads = heads
        self.num_experts = num_experts
        self.linear = nn.Linear(embedding_dim, heads * num_experts, dtype=torch.float32,
                                device=device)

    def forward(self, temb: torch.Tensor) -> torch.Tensor:
        """temb: (B, D) -> (B, heads, num_experts) f32 scores."""
        logits = self.linear(F.silu(temb).float())
        logits = logits.reshape(temb.shape[0], self.heads, self.num_experts)
        return torch.softmax(logits, dim=-1)
