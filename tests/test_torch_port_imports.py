"""The port imports no JAX, and its entry points never drift to the CPU."""

import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import vorta_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "vorta_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vorta_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vorta_tpu_torch.__path__, "vorta_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if any(k == f or k.startswith(f + ".") for f in {forbidden!r}))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    code = _IMPORT_ALL.format(forbidden=FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 30, proc.stdout  # every module was walked
    assert bad == "[]", f"the port loaded {bad}"
    names = {m.name for m in pkgutil.walk_packages(vorta_tpu_torch.__path__, "vorta_tpu_torch.")}
    assert {"vorta_tpu_torch.ops.flash_bwd", "vorta_tpu_torch.training.step",
            "vorta_tpu_torch.training.sampling", "vorta_tpu_torch.training.data",
            "vorta_tpu_torch.io.checkpoint", "vorta_tpu_torch.io.metrics",
            "vorta_tpu_torch.cli.train", "vorta_tpu_torch.ops.joint_experts",
            "vorta_tpu_torch.models.hunyuan", "vorta_tpu_torch.pipelines.hunyuan_t2v"} <= names


def test_every_module_imports_without_building():
    """Importing a module builds no kernel (no nvcc here)."""
    from vorta_tpu_torch.ops import _build

    for m in pkgutil.walk_packages(vorta_tpu_torch.__path__, "vorta_tpu_torch."):
        importlib.import_module(m.name)
    assert not _build._libs


@pytest.mark.parametrize("entry", ["model", "cli", "hunyuan_model", "hunyuan_cli"])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """With no device given, an entry point asks for CUDA and raises without it."""
    from vorta_tpu_torch.config import WAN_TINY
    from vorta_tpu_torch.models.wan import WanModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "model":
            WanModel(WAN_TINY)
        elif entry == "hunyuan_model":
            from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanModel

            HunyuanModel(HUNYUAN_TINY)
        else:
            from vorta_tpu_torch.cli.sample import main

            model = "hunyuan-tiny" if entry == "hunyuan_cli" else "wan-tiny"
            main(["--model", model, "--native_attention", "--random_embeds"])
