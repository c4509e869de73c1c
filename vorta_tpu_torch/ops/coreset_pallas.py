"""Fused pooling for the low-resolution attention expert (counterpart of
vorta_tpu/ops/coreset_pallas.py): ``pool_qkv`` and ``unpool``.

``pool_qkv`` reads q/k/v (B, H, S, D) in raster order, computes Q's
kept-margin matching per group in f32 (shared by K and V, or with
``kv_matching_from_k`` K's own matching, the same rule on K, pools K and
V: HunyuanVideo's joint experts), and writes the
pooled sequences [G centers | G*U kept margins, group-major, least similar
first] and, with ``return_picks``, the picked slot ids as (B, H, T2, H3,
W2, U) int32, the TPU kernel's layout.  ``unpool`` scatters a pooled
attention output back through those picks, dropped slots taking their
group center.  The selection semantics are those of ops/coreset.py.

Three modes, as the TPU kernels' (``_mode_plan``): "plain" (every head),
"active" (``active`` (H,) masks heads: inactive heads write zeros) and
"headmap" (``head_map`` + ``num_active``: only heads
``head_map[:num_active]`` are pooled / unpooled, each once; the rows of
every other head come back uninitialized and the caller masks them, as
ops/routed_fused.py's ``lowres_all_batched`` and ops/joint_experts.py's
``joint_lowres_attention`` do).  ``head_map_for`` packs an (H,) routing
mask into the JAX package's head map: the routed heads first, the
last one repeated.  In head-map mode the CUDA launch covers only the
``num_active`` routed heads (the port routes on the host, so the count
sizes the grid); the plain versions fill the other heads' rows with NaN
(picks with -1), so that a caller that forgets the mask shows it.

On CUDA tensors both launch ``csrc/coreset_pool.cu`` (bf16, or f32 on the
f32 serving path, counted as ``pool_qkv_f32`` / ``unpool_f32`` too; D 64
or 128, at most 32 slots per group; ``unpool`` there needs ``picks``); on CPU
tensors they run the plain versions built from ops/coreset.py.  ``unpool``
launches the batched 16-byte copy (``unpool_rows_kernel``, counted as
``unpool_rows`` too) wherever ``unpool_layout`` gives a layout: every shape
the file takes in bf16, in both modes, and in f32 all but D = 128 with
more than 16 slots a group; ``unpool_per_group`` runs the first
design's kernel (a warp per group, one row in flight) at the same call, the
card's yardstick.  Forward only, as in the JAX package: on CUDA both raise
where grad mode is on and an input requires grad.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..geometry import LowresGroups
from . import _build
from .coreset import (
    geometry_of,
    group_view,
    match_slots,
    pool_grouped,
    slot_similarity,
    unpool_grouped,
)
from .layout import untile_sequence


def _picks_shape(groups: LowresGroups, b: int, h: int):
    t, hh, w = geometry_of(groups).latent_shape
    wt, wh, ww = geometry_of(groups).window
    return (b, h, t // wt, hh // wh, w // ww, groups.num_kept_margins)


def _head_mask(active, h: int, device) -> Optional[torch.Tensor]:
    if active is None:
        return None
    return torch.as_tensor(active, device=device).reshape(1, h, 1, 1) > 0


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask.reshape((1, -1) + (1,) * (x.ndim - 2)), x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _mode_plan(active, head_map, num_active) -> str:
    """"plain", "active" or "headmap", with the JAX package's ValueErrors."""
    if head_map is not None:
        if num_active is None:
            raise ValueError("head_map requires num_active")
        if active is not None:
            raise ValueError("head_map and active are mutually exclusive")
        return "headmap"
    return "active" if active is not None else "plain"


def head_map_for(active, num_active: Optional[int] = None) -> Tuple[torch.Tensor, int]:
    """(H,) routing mask -> (head_map (H,) int32 on the mask's device,
    num_active): the routed heads first in head order, the last repeated as
    padding, and max(routed, 1), as the JAX package's callers build them.
    ``num_active``: the routed count where the caller has it on the host
    (else it is read from the mask: a device sync for a CUDA mask)."""
    act = torch.as_tensor(active).reshape(-1).bool()
    n = max(int(act.sum()) if num_active is None else int(num_active), 1)
    order = torch.sort((~act).to(torch.int32), stable=True).indices
    pos = torch.clamp(torch.arange(act.numel(), device=act.device), max=n - 1)
    return order[pos].to(torch.int32), n


def _mapped_heads(head_map, num_active, h: int) -> torch.Tensor:
    """The (num_active,) distinct head ids a head-map call pools, checked."""
    n = int(num_active)
    heads = torch.as_tensor(head_map).reshape(-1)[:n].long().cpu()
    if not 1 <= n <= h or heads.numel() != n or len(set(heads.tolist())) != n \
            or not ((heads >= 0) & (heads < h)).all():
        raise ValueError(f"head_map {torch.as_tensor(head_map).tolist()} with num_active {n} "
                         f"for {h} heads: needs {n} distinct head ids")
    return heads


def _scatter_heads(x: torch.Tensor, heads: torch.Tensor, h: int) -> torch.Tensor:
    """(B, n, ...) rows of ``heads`` into a (B, H, ...) tensor whose other
    heads hold NaN (-1 for int picks): the head-map mode's uninitialized rows."""
    fill = -1 if not x.is_floating_point() else float("nan")
    out = torch.full((x.shape[0], h) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=x.device)
    out[:, heads.to(x.device)] = x
    return out


def pool_qkv_ref(q, k, v, groups: LowresGroups, *, kv_matching_from_k: bool = False,
                 active=None, head_map=None, num_active=None):
    """Plain PyTorch version: (pq, pk, pv, picks)."""
    b, h = q.shape[:2]
    if _mode_plan(active, head_map, num_active) == "headmap":
        heads = _mapped_heads(head_map, num_active, h).to(q.device)
        out = pool_qkv_ref(q[:, heads], k[:, heads], v[:, heads], groups,
                           kv_matching_from_k=kv_matching_from_k)
        return tuple(_scatter_heads(x, heads, h) for x in out)
    cs = geometry_of(groups).center_slot
    u = groups.num_kept_margins
    qg, kg, vg = group_view(q, groups), group_view(k, groups), group_view(v, groups)
    slots = match_slots(qg, u, cs)
    kv_slots = match_slots(kg, u, cs) if kv_matching_from_k else slots
    mask = _head_mask(active, h, q.device)
    pooled = (pool_grouped(qg, slots, cs), pool_grouped(kg, kv_slots, cs),
              pool_grouped(vg, kv_slots, cs))
    picks = slots.to(torch.int32).reshape(_picks_shape(groups, b, h))
    return tuple(_masked(x, mask) for x in pooled) + (_masked(picks, mask),)


def unpool_ref(pooled_out, q, groups: LowresGroups, *, active=None, head_map=None,
               num_active=None, picks=None):
    """Plain PyTorch version: with ``picks`` the pool pass's matching, else
    Q's matching derived again."""
    b, h, _, d = pooled_out.shape
    if _mode_plan(active, head_map, num_active) == "headmap":
        heads = _mapped_heads(head_map, num_active, h).to(pooled_out.device)
        out = unpool_ref(pooled_out[:, heads], q[:, heads], groups,
                         picks=None if picks is None else picks[:, heads])
        return _scatter_heads(out, heads, h)
    geom = geometry_of(groups)
    if picks is None:
        slots = match_slots(group_view(q, groups), groups.num_kept_margins, geom.center_slot)
    else:
        slots = picks.reshape(b, h, groups.num_groups, groups.num_kept_margins).long()
    full = unpool_grouped(pooled_out[:, :, :groups.pooled_length], slots, groups.group_size)
    out = untile_sequence(full.reshape(b, h, groups.full_length, d), geom.latent_shape,
                          geom.window)
    return _masked(out, _head_mask(active, h, q.device))


def pick_gaps(picks: torch.Tensor, picks_ref: torch.Tensor, q: torch.Tensor,
              groups: LowresGroups) -> torch.Tensor:
    """|sim(pick) - sim(reference pick)| at every position where two picks
    tensors disagree, from Q's f32 similarities (an arg-min that flips
    between two margins this close is a near-tie, not an error)."""
    b, h = q.shape[:2]
    shape = (b, h, groups.num_groups, groups.num_kept_margins)
    a, r = picks.reshape(shape).long(), picks_ref.reshape(shape).long()
    sim = slot_similarity(group_view(q, groups), geometry_of(groups).center_slot)
    diff = a != r
    return (sim.gather(3, a) - sim.gather(3, r)).abs()[diff]


def _fn(name: str, n_int: int, n_ptr: int):
    fn = getattr(_build.load("coreset_pool"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _cuda_args(x: torch.Tensor, groups: LowresGroups, active, head_map, num_active):
    """Checks shared by both kernels; returns (device, active int32 or None,
    head map int32 or None, num_active, ints)."""
    dev = _build.require_cuda(x)
    b, h, s, d = x.shape
    geom = geometry_of(groups)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the CUDA pool/unpool kernels take bf16 or f32, got {x.dtype}")
    if d not in (64, 128) or groups.group_size > 32:
        raise NotImplementedError(f"the CUDA pool/unpool kernels take D 64/128 and at most "
                                  f"32 slots per group, got D={d}, {groups.group_size}")
    ints = (b, h, *geom.latent_shape, d, *geom.window, groups.num_kept_margins)
    if _mode_plan(active, head_map, num_active) == "headmap":
        n = int(num_active)
        if not (torch.is_tensor(head_map) and head_map.is_cuda):  # checked where it costs no sync
            _mapped_heads(head_map, n, h)
        hm = torch.as_tensor(head_map, device=dev).reshape(-1).to(torch.int32).contiguous()
        if hm.numel() < n or not 1 <= n <= h:
            raise ValueError(f"head_map of {hm.numel()} with num_active {n} for {h} heads")
        return dev, None, hm, n, ints
    if active is None:
        active = torch.ones(h, dtype=torch.int32, device=dev)
    active = torch.as_tensor(active, device=dev).to(torch.int32).contiguous()
    if active.shape != (h,):
        raise ValueError(f"active {tuple(active.shape)} for {h} heads")
    return dev, active, None, 0, ints


def pool_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, groups: LowresGroups, *,
             kv_matching_from_k: bool = False, active=None, head_map=None, num_active=None,
             return_picks: bool = False):
    """Pool (B, H, S, D) q/k/v to (B, H, P, D); with ``return_picks`` also the
    picks (B, H, T2, H3, W2, U) int32 for ``unpool`` (Q's, whichever
    matching pools K and V).  ``head_map`` (H,) int32 (tensor or numpy) and
    ``num_active`` (an int on CUDA): head-map mode, see the module doc."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] != groups.full_length:
        raise ValueError(f"seq len {q.shape[2]} != groups.full_length {groups.full_length}")
    if q.device.type == "cpu":
        out = pool_qkv_ref(q, k, v, groups, kv_matching_from_k=kv_matching_from_k,
                           active=active, head_map=head_map, num_active=num_active)
        return out if return_picks else out[:3]

    _build.forward_only("pool_qkv", q, k, v)
    dev, active, hm, n, ints = _cuda_args(q, groups, active, head_map, num_active)
    if k.dtype != q.dtype or v.dtype != q.dtype or _build.require_cuda(q, k, v) != dev:
        raise ValueError("q, k and v must share one dtype and device")
    q, k, v = (_build.aligned16(x.contiguous()) for x in (q, k, v))
    b, h, _, d = q.shape
    pooled = [torch.empty((b, h, groups.pooled_length, d), dtype=q.dtype, device=dev)
              for _ in range(3)]
    picks = torch.empty(_picks_shape(groups, b, h), dtype=torch.int32, device=dev)
    f32 = q.dtype == torch.float32
    err = _fn("vorta_coreset_pool_f32" if f32 else "vorta_coreset_pool_bf16", 2 + len(ints), 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *(p.data_ptr() for p in pooled),
        picks.data_ptr(), _build.ptr(active), _build.ptr(hm), n, int(kv_matching_from_k),
        *ints, _build.stream_ptr(dev))
    _build.check(err, "pool_qkv")
    _build.launches["pool_qkv" if hm is None else "pool_qkv_headmap"] += 1
    _build.launches["pool_qkv_f32"] += f32
    return tuple(pooled) + ((picks,) if return_picks else ())


UNPOOL_STORES = (4, 8, 16)  # the rows kernel's instantiations: store instructions a lane


def unpool_layout(d: int, group_size: int, kept: int,
                  itemsize: int = 2) -> Optional[Tuple[int, int, int]]:
    """(rows a warp instruction moves, store instructions a lane, kept-row
    loads a lane) of unpool's batched 16-byte copy (``csrc/coreset_pool.cu:
    unpool_rows_kernel``) for groups of ``group_size`` slots with ``kept``
    kept margins, or None where it takes no shape: a row of d elements of
    ``itemsize`` bytes is d * itemsize / 16 lanes of 16 bytes, so a warp
    moves 512 / (d * itemsize) rows an instruction (256 / d in bf16, 128 /
    d in f32); a group of up to 32 slots takes ceil(group_size / rows)
    stores a lane, rounded up to an instantiated count (``UNPOOL_STORES``;
    none fits f32 at d = 128 past 16 slots), and ceil(kept / rows) loads,
    held in half as many registers as stores where they fit (the served
    rate keeps fewer than half the slots), else as many.  The C entry
    mirrors the rule and refuses any other pair."""
    if d not in (64, 128) or not 1 <= group_size <= 32 or not 0 <= kept < group_size:
        return None
    rows = 512 // (d * itemsize)
    if -(-group_size // rows) > UNPOOL_STORES[-1]:
        return None
    stores = next(n for n in UNPOOL_STORES if n * rows >= group_size)
    loads = stores // 2 if -(-kept // rows) <= stores // 2 else stores
    return rows, stores, loads


def unpool(pooled_out: torch.Tensor, q: torch.Tensor, groups: LowresGroups, *, active=None,
           head_map=None, num_active=None, picks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter a pooled (B, H, P, D) attention output back to (B, H, S, D);
    ``head_map`` / ``num_active`` as for ``pool_qkv`` (picks from a head-map
    pool feed a head-map unpool)."""
    return _unpool(pooled_out, q, groups, active=active, head_map=head_map,
                   num_active=num_active, picks=picks, rows_ok=True)


def unpool_per_group(pooled_out, q, groups, **kw) -> torch.Tensor:
    """``unpool`` on the first design's kernel (a warp per group) whatever
    ``unpool_layout`` says: the card's yardstick beside the rows kernel at
    the same call (``chip_smoke.py`` times both), counted in ``unpool`` /
    ``unpool_headmap`` only."""
    return _unpool(pooled_out, q, groups, rows_ok=False, **kw)


def _unpool(pooled_out, q, groups: LowresGroups, *, active=None, head_map=None,
            num_active=None, picks=None, rows_ok: bool = True) -> torch.Tensor:
    b, h, p, d = pooled_out.shape
    if p != groups.pooled_length or q.shape[:2] != (b, h) or q.shape[2] != groups.full_length:
        raise ValueError(f"pooled {tuple(pooled_out.shape)}, q {tuple(q.shape)} for "
                         f"{groups.pooled_length} pooled of {groups.full_length} tokens")
    if pooled_out.device.type == "cpu":
        return unpool_ref(pooled_out, q, groups, active=active, head_map=head_map,
                          num_active=num_active, picks=picks)

    _build.forward_only("unpool", pooled_out)
    if picks is None:
        raise NotImplementedError("the CUDA unpool kernel takes the pool pass's picks")
    dev, active, hm, n, ints = _cuda_args(pooled_out, groups, active, head_map, num_active)
    if tuple(picks.shape) != _picks_shape(groups, b, h) or picks.dtype != torch.int32:
        raise ValueError(f"picks {tuple(picks.shape)} {picks.dtype}")
    _build.require_cuda(pooled_out, picks)
    f32 = pooled_out.dtype == torch.float32
    layout = (unpool_layout(d, groups.group_size, groups.num_kept_margins,
                            pooled_out.element_size()) if rows_ok else None)
    pooled_out, picks = _build.aligned16(pooled_out.contiguous()), picks.contiguous()
    out = torch.empty((b, h, groups.full_length, d), dtype=pooled_out.dtype, device=dev)
    err = _fn("vorta_coreset_unpool_f32" if f32 else "vorta_coreset_unpool_bf16",
              3 + len(ints), 5)(
        pooled_out.data_ptr(), picks.data_ptr(), _build.ptr(active), _build.ptr(hm),
        out.data_ptr(), n, *ints, *(layout[1:] if layout else (0, 0)), _build.stream_ptr(dev))
    _build.check(err, "unpool")
    _build.launches["unpool" if hm is None else "unpool_headmap"] += 1
    _build.launches["unpool_f32"] += f32
    if layout is not None:
        _build.launches["unpool_rows"] += 1
    return out
