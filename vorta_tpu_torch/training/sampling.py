"""Timestep sampling for router distillation training (counterpart of
vorta_tpu/training/sampling.py).

The interval curriculum of the reference (vorta/train/edm_utils.py:67-104):
each step draws uniform u, squeezes it into one of ``n_intervals`` random
sub-intervals of [0, 1], and in the lowest-noise interval zeroes the
diffusion loss while upweighting the distillation losses.  Draws come from
an explicit ``torch.Generator`` (JAX's keys give other numbers, so the
tests hand both sides the same draws).
"""

from __future__ import annotations

from typing import Tuple

import torch


def renormalize_uniform(u: torch.Tensor, interval_index, n_intervals: int = 5) -> torch.Tensor:
    """Map uniform u in [0, 1] into the interval [k/n, (k+1)/n]."""
    k = torch.as_tensor(interval_index, dtype=torch.float32, device=u.device)
    lo, hi = k / n_intervals, (k + 1.0) / n_intervals
    return torch.minimum(torch.maximum(u * (hi - lo) + lo, lo), hi)


def timesteps_from_uniform(u: torch.Tensor, timestep_table: torch.Tensor,
                           sigma_table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index the scheduler tables at floor(u * T), clipped to the table."""
    n = timestep_table.shape[0]
    idx = (u * n).to(torch.int32).clamp(0, n - 1).long()
    return timestep_table[idx], sigma_table[idx]


def sample_timesteps(generator: torch.Generator, batch: int, timestep_table: torch.Tensor,
                     sigma_table: torch.Tensor, n_intervals: int = 5):
    """(timesteps (B,), sigmas (B,)): uniform u, one shared random interval
    per step, then the table entries (scripts/wan/train_one_step.py:54-65)."""
    dev = timestep_table.device
    u = torch.rand((batch,), generator=generator, device=generator.device).to(dev)
    interval = torch.randint(0, n_intervals, (), generator=generator, device=generator.device)
    u = renormalize_uniform(u, interval.to(dev), n_intervals)
    return timesteps_from_uniform(u, timestep_table, sigma_table)


def rebalance_loss_weights(diffusion_weight: float, other_weights: Tuple[float, ...],
                           timesteps: torch.Tensor, n_intervals: int = 5,
                           num_train_timesteps: int = 1000):
    """In the lowest-noise interval drop the diffusion loss and upweight the
    active distillation losses (vorta/train/edm_utils.py:87-104).  Returns
    Python floats: (diffusion weight, (other weights))."""
    if diffusion_weight == 0:
        return 0.0, tuple(float(w) for w in other_weights)
    in_low = float(timesteps[0]) < num_train_timesteps / n_intervals
    num_active = sum(1 for w in other_weights if w > 0)
    boost = 1.0 + 1.0 / max(num_active, 1)
    dw = 0.0 if in_low else float(diffusion_weight)
    ows = tuple((w * boost if in_low else float(w)) if w > 0 else 0.0 for w in other_weights)
    return dw, ows
