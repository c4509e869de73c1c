"""Step-level residual caching for diffusion sampling, TeaCache family
(counterpart of vorta_tpu/ops/stepcache.py).

Across adjacent denoise steps the DiT's block stack changes its input
slowly: when an inexpensive indicator says the change since the last
computed step is small, the stack is skipped and that step's block
residual (``hidden_out - hidden_in``) is added to the current hidden state
instead.  Patch embedding and the output head run every step, so the
integrator keeps its identity path through the current latents.

Indicator: the flattened AdaLN modulation (Wan's temb6, HunyuanVideo's
temb).  Its step-to-step relative L1 distance, optionally rescaled by a
fitted polynomial (``assets/cache_poly_wan1_3b_720p.npz``, highest degree
first) and clamped at 0, accumulates; once the sum reaches ``threshold``
the blocks run and the sum resets.

The JAX package decides inside a traced ``lax.cond``.  Eager PyTorch can
skip the block stack only on a host branch, so the models read the skip
flag to the host once per forward: where routing is hard, in the one
device-to-host copy that already carries the forward's routing; else in a
copy of its own; not at all on a forced step.  ``acc`` and ``prev_ind``
stay on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch


@dataclasses.dataclass
class StepCache:
    """Carried across denoise steps, one per DiT evaluation stream."""

    prev_ind: torch.Tensor  # (B, K) f32: the previous step's indicator
    residual: torch.Tensor  # (B, S, D) model dtype: the cached block-stack delta
    acc: torch.Tensor  # () f32: accumulated rescaled distance since the last compute
    valid: torch.Tensor  # () bool: False until the first computed step


def init_step_cache(batch: int, seq: int, dim: int, ind_dim: int, dtype=torch.bfloat16,
                    device=None) -> StepCache:
    return StepCache(
        prev_ind=torch.zeros((batch, ind_dim), dtype=torch.float32, device=device),
        residual=torch.zeros((batch, seq, dim), dtype=dtype, device=device),
        acc=torch.zeros((), dtype=torch.float32, device=device),
        valid=torch.zeros((), dtype=torch.bool, device=device),
    )


def rel_l1(cur: torch.Tensor, prev: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean relative L1 distance between two indicators -> () f32, over the
    whole batch: one decision covers every sample (both CFG arms under
    ``cfg_batch``), as in the JAX package."""
    cur, prev = cur.float(), prev.float()
    return (cur - prev).abs().mean() / (prev.abs().mean() + eps)


def rescale(d: torch.Tensor, coefficients: Optional[Sequence[float]]) -> torch.Tensor:
    """Polynomial rescale of the raw distance (highest degree first, numpy's
    polyval order), in f32; None or empty -> identity."""
    if not coefficients:
        return d
    out = torch.zeros_like(d, dtype=torch.float32)
    for c in coefficients:
        out = out * d + float(c)
    return out


def cache_decision(cache: StepCache, indicator: torch.Tensor, threshold: float,
                   force_compute: Union[bool, torch.Tensor, None] = None,
                   coefficients: Optional[Sequence[float]] = None):
    """``(skip, acc_if_skipped)``, both () device tensors: ``skip`` is True
    when the accumulated (rescaled, clamped at 0) distance stays under
    ``threshold`` and nothing forces a compute.  A caller that runs the
    blocks resets ``acc`` to 0; one that skips carries ``acc_if_skipped``.
    Python numbers stay on the host: no host-to-device copy, so no sync."""
    d = rescale(rel_l1(indicator, cache.prev_ind), coefficients).clamp(min=0.0)
    acc = cache.acc + d
    skip = cache.valid & (acc < float(threshold))
    if isinstance(force_compute, torch.Tensor):
        skip = skip & ~force_compute.to(skip.device)
    elif force_compute:
        skip = torch.zeros_like(skip)
    return skip, acc


def computed(indicator: torch.Tensor, x_in: torch.Tensor, x_out: torch.Tensor) -> StepCache:
    """The cache after a computed step: the block-stack delta in the model's
    dtype, the sum reset."""
    return StepCache(prev_ind=indicator, residual=(x_out - x_in).to(x_in.dtype),
                     acc=torch.zeros((), dtype=torch.float32, device=x_in.device),
                     valid=torch.ones((), dtype=torch.bool, device=x_in.device))


def skipped(cache: StepCache, indicator: torch.Tensor, acc: torch.Tensor) -> StepCache:
    """The cache after a skipped step: the residual kept, the sum carried."""
    return StepCache(prev_ind=indicator, residual=cache.residual, acc=acc, valid=cache.valid)


def read_decision(skip: torch.Tensor, force_compute, ids_dev: Optional[torch.Tensor] = None):
    """``(skip, ids)`` on the host, in at most one device-to-host copy: none
    for the flag on a step forced (a Python True) to compute; the flag
    appended to the routing ids ``ids_dev`` where the forward routes hard."""
    forced = force_compute is True
    if ids_dev is None:
        return (False if forced else bool(skip.item())), None
    if forced:
        return False, ids_dev.cpu().numpy()
    both = torch.cat([ids_dev.reshape(-1), skip.reshape(1).to(ids_dev.dtype)]).cpu().numpy()
    return bool(both[-1]), both[:-1].reshape(tuple(ids_dev.shape))
