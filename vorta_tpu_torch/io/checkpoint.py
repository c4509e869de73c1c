"""Router-only checkpoints (counterpart of vorta_tpu/io/checkpoint.py).

The JAX package's layout, ``ckpt/step-%06d/router`` and
``ckpt/step-%06d/optimizer``, written with torch serialization instead of
orbax: ``router`` holds the router parameters by name ({name: f32
tensor}), ``optimizer`` the accumulating optimizer's state
(training/step.py ``MultiSteps.state_dict``).  A step dir is written
under a temporary name and renamed when complete, so ``latest_checkpoint``
never finds a half-written one.  ``--resume_from_checkpoint latest``
resolves the newest step dir (reference vorta/utils/misc.py:52-65).
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Optional, Tuple

import torch


def _step_dir(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step-{step:06d}"


def save_router_checkpoint(ckpt_dir, step: int, router_state: dict,
                           opt_state: Optional[dict] = None) -> Path:
    """Write ``router_state`` ({name: tensor}) and ``opt_state`` under
    ``ckpt_dir/step-XXXXXX``; returns that path."""
    path = _step_dir(Path(ckpt_dir).absolute(), step)
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save({k: v.detach().cpu() for k, v in router_state.items()}, tmp / "router")
    if opt_state is not None:
        torch.save(opt_state, tmp / "optimizer")
    shutil.rmtree(path, ignore_errors=True)
    tmp.rename(path)
    return path


def load_router_checkpoint(path) -> Tuple[dict, Optional[dict]]:
    """(router_state, opt_state or None) from a step dir, on the CPU."""
    path = Path(path)
    if not (path / "router").is_file():
        raise FileNotFoundError(f"{path} is not a router checkpoint step dir (no 'router')")
    router = torch.load(path / "router", map_location="cpu", weights_only=True)
    opt = None
    if (path / "optimizer").is_file():
        opt = torch.load(path / "optimizer", map_location="cpu", weights_only=True)
    return router, opt


def apply_router_state(model: torch.nn.Module, router_state: dict) -> None:
    """Copy a checkpoint's router parameters into ``model``; a missing,
    extra or misshapen router parameter raises."""
    params = {n: p for n, p in model.named_parameters() if "router" in n.split(".")}
    if set(params) != set(router_state):
        raise KeyError(f"checkpoint routers {sorted(set(router_state) ^ set(params))[:4]} "
                       "do not match the model's")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(router_state[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: {tuple(router_state[name].shape)} != {tuple(p.shape)}")
            p.copy_(router_state[name])


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """The newest step dir under ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best, best_step = None, -1
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step-(\d+)", p.name)
        if m and p.is_dir() and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best
