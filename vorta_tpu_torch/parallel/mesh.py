"""Process groups for (data, sequence) parallelism (counterpart of
vorta_tpu/parallel/mesh.py).

The reference partitions the torch.distributed world into contiguous
sequence-parallel groups with the leftover factor as data parallelism
(vorta/ulysses/parallel_states.py:55-72); JAX builds the same structure as
a 2D mesh with axes ("dp", "sp").  Here it is two families of process
groups: rank ``dp_rank * sp_size + sp_rank`` belongs to sp group
``dp_rank`` (contiguous ranks, one node's NVLink neighbours under torchrun)
and to dp group ``sp_rank``.

``make_mesh`` joins the process group torchrun describes (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) unless the
caller has initialised one already: NCCL on ``cuda:LOCAL_RANK``, gloo only
for the CPU; a CUDA run never takes gloo.  With neither, the world is this
one process and the mesh has no groups (sp = dp = 1, as the JAX mesh of a
single device).  The JAX module's ``pin_platform_from_env`` restores a JAX
platform choice that plugins override; PyTorch has no such thing, so it
has no counterpart here.  ``make_mesh_for`` is the CLIs' rule for when a
run takes a mesh at all.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

DP_AXIS = "dp"
SP_AXIS = "sp"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (dp, sp) mesh.  ``sp_group`` /
    ``dp_group`` are None when the world is one process and no group was
    made; ``in_mesh`` is False for the ranks past dp * sp, which take no
    part."""

    dp_size: int
    sp_size: int
    dp_rank: int
    sp_rank: int
    sp_group: Optional[object]
    dp_group: Optional[object]
    device: torch.device
    in_mesh: bool = True

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.dp_size, SP_AXIS: self.sp_size}


def _join(device: torch.device) -> None:
    """init_process_group from torchrun's environment, on ``device``'s backend."""
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")


def _group(ranks: list, world: int):
    return dist.group.WORLD if ranks == list(range(world)) else dist.new_group(ranks)


def make_mesh(sp_size: int = 1, dp_size: Optional[int] = None, device=None) -> Mesh:
    """The (dp, sp) groups over the world's first dp * sp ranks; ``dp_size``
    defaults to the world size over ``sp_size``.  ``device`` ("cuda", the
    default, or "cpu") picks the backend when this call joins the group;
    with a group already joined, a CUDA device on a gloo group raises."""
    device = torch.device("cuda" if device is None else device)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        _join(device)
    if dist.is_initialized():
        backend = dist.get_backend()
        if device.type == "cuda" and backend != "nccl":
            raise ValueError(f"a CUDA run takes NCCL, not the {backend} process group")
        n, rank = dist.get_world_size(), dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    else:
        n, rank = 1, 0
    if n % sp_size:
        raise ValueError(f"device count {n} not divisible by sp_size {sp_size}")
    if dp_size is None:
        dp_size = n // sp_size
    if dp_size * sp_size > n:
        raise ValueError(f"dp*sp = {dp_size * sp_size} > {n} devices")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, None, None, device)
    sp_group = dp_group = None
    # every rank makes every group, in the same order (torch.distributed's
    # rule); a group of the whole world is the default one, whose
    # communicator exists already
    for d in range(dp_size):
        g = _group(list(range(d * sp_size, (d + 1) * sp_size)), n)
        if d == rank // sp_size:
            sp_group = g
    for s in range(sp_size):
        g = _group([d * sp_size + s for d in range(dp_size)], n)
        if s == rank % sp_size:
            dp_group = g
    in_mesh = rank < dp_size * sp_size
    return Mesh(dp_size, sp_size, rank // sp_size if in_mesh else 0, rank % sp_size,
                sp_group if in_mesh else None, dp_group if in_mesh else None, device, in_mesh)


def make_mesh_for(sp_size: int = 1, dp_size: Optional[int] = None, device=None,
                  force: bool = False) -> Optional[Mesh]:
    """The mesh where the flags (``sp_size`` above 1, a ``dp_size``, or
    ``force``), a joined process group or torchrun's environment ask for
    one (the JAX CLIs' rule, torchrun's environment counting too); None
    otherwise, and None where the world is this one process (no group)."""
    if not (sp_size > 1 or dp_size is not None or force or dist.is_initialized()
            or "WORLD_SIZE" in os.environ):
        return None
    mesh = make_mesh(sp_size, dp_size, device)
    return None if mesh.in_mesh and mesh.sp_group is None else mesh
