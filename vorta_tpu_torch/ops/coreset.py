"""Similarity-based sequence pooling for the low-resolution attention expert
(counterpart of vorta_tpu/ops/coreset.py).

Per non-overlapping 3D window ("group") the expert keeps the center token
plus the ``U`` margin tokens *least* cosine-similar to the center; attention
runs on the short sequence and the output is scattered back, dropped
positions taking their group center's output.  The selection is computed
once from Q and reused for K/V.

Selection semantics, exactly as the JAX package: ranking by
``(c.m) * rsqrt(max(|m|^2, 1e-24))`` in f32 (the center norm scales a whole
group alike, so it is left out), the center excluded by a +inf sentinel,
then U arg-min passes, ties to the lower slot.  Gathers and scatters are
pure selection, so pooled values equal their inputs bit for bit.

Gradients flow through the pooled and unpooled values only: the matching
is discrete (computed on detached values), as the JAX package's one-hot
built from comparisons is.  The gather's gradient scatters back to the
picked slots; the unpool's sends every slot that took its center's output
back to that center.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import LowresGroups
from .layout import tile_sequence, untile_sequence


class Matching(NamedTuple):
    """Per-(batch, head, group) kept-margin selection.

    ``slots`` indexes the group's slot axis (0..group_size-1, raster order
    inside the window), least similar first; ``kept`` the margin axis
    (the center slot removed), as the JAX package's ``Matching.kept``.
    """

    slots: torch.Tensor  # (B, H, G, U) int64
    kept: torch.Tensor  # (B, H, G, U) int64


def geometry_of(groups: LowresGroups):
    if not hasattr(groups, "_geom"):
        raise ValueError("LowresGroups missing geometry; build via build_lowres_groups")
    return groups._geom  # type: ignore[attr-defined]


def group_view(x: torch.Tensor, groups: LowresGroups) -> torch.Tensor:
    """(B, H, S, D) raster -> (B, H, G, group_size, D), slots in raster order."""
    geom = geometry_of(groups)
    if x.shape[-2] != groups.full_length:
        raise ValueError(
            f"sequence length {x.shape[-2]} != groups.full_length {groups.full_length}")
    b, h, _, d = x.shape
    return tile_sequence(x, geom.latent_shape, geom.window).reshape(
        b, h, groups.num_groups, groups.group_size, d)


def slot_similarity(xg: torch.Tensor, center_slot: int) -> torch.Tensor:
    """(B, H, G, gs, D) grouped tokens -> (B, H, G, gs) f32 ranking
    similarity to the group center, +inf at the center itself."""
    xf = xg.float()
    c = xf[:, :, :, center_slot:center_slot + 1]
    sim = (xf * c).sum(-1) * torch.rsqrt(torch.clamp((xf * xf).sum(-1), min=1e-24))
    sim[..., center_slot] = float("inf")
    return sim


def match_slots(xg: torch.Tensor, num_kept: int, center_slot: int) -> torch.Tensor:
    """(B, H, G, gs, D) grouped tokens -> (B, H, G, U) kept slot ids."""
    sim = slot_similarity(xg, center_slot)
    gs = sim.shape[-1]
    slot = torch.arange(gs, device=sim.device)
    picks = []
    for _ in range(num_kept):
        m = sim.amin(-1, keepdim=True)
        idx = torch.where(sim <= m, slot, gs).amin(-1, keepdim=True)
        picks.append(idx)
        sim = torch.where(slot == idx, float("inf"), sim)
    if not picks:
        return torch.zeros(sim.shape[:-1] + (0,), dtype=torch.long, device=sim.device)
    return torch.cat(picks, dim=-1)


def pool_grouped(xg: torch.Tensor, slots: torch.Tensor, center_slot: int) -> torch.Tensor:
    """(B, H, G, gs, D) + slots -> pooled (B, H, G*(1+U), D):
    [all G centers | G*U kept margins, group-major, least similar first]."""
    b, h, g, _, d = xg.shape
    u = slots.shape[-1]
    centers = xg[:, :, :, center_slot]
    kept = torch.gather(xg, 3, slots[..., None].expand(b, h, g, u, d))
    return torch.cat([centers, kept.reshape(b, h, g * u, d)], dim=2)


def unpool_grouped(pooled: torch.Tensor, slots: torch.Tensor, group_size: int) -> torch.Tensor:
    """Pooled (B, H, P, D) + slots -> (B, H, G, gs, D): kept slots take their
    own value, every other slot (the center among them) its center's."""
    b, h, _, d = pooled.shape
    g, u = slots.shape[2], slots.shape[3]
    out = pooled[:, :, :g, None, :].expand(b, h, g, group_size, d).clone()
    kept = pooled[:, :, g:g * (1 + u)].reshape(b, h, g, u, d)
    return out.scatter_(3, slots[..., None].expand(b, h, g, u, d), kept)


def pool_by_similarity(x: torch.Tensor, groups: LowresGroups,
                       matching: Optional[Matching] = None):
    """Pool (B, H, S, D) to (B, H, P, D), P = G * (1 + U); returns
    ``(pooled, matching)`` so K/V can reuse Q's matching."""
    cs = geometry_of(groups).center_slot
    xg = group_view(x, groups)
    if matching is None:
        slots = match_slots(xg.detach(), groups.num_kept_margins, cs)
        matching = Matching(slots=slots, kept=slots - (slots > cs).long())
    return pool_grouped(xg, matching.slots, cs), matching


def unpool_by_similarity(pooled: torch.Tensor, groups: LowresGroups,
                         matching: Matching) -> torch.Tensor:
    """Scatter a pooled (B, H, P, D) sequence back to (B, H, S, D)."""
    geom = geometry_of(groups)
    if pooled.shape[2] != groups.pooled_length:
        raise ValueError(f"pooled length {pooled.shape[2]} != expected {groups.pooled_length}")
    b, h, _, d = pooled.shape
    full = unpool_grouped(pooled, matching.slots, groups.group_size)
    return untile_sequence(full.reshape(b, h, groups.full_length, d),
                           geom.latent_shape, geom.window)
