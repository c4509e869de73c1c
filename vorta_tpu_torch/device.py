"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for another device.
Without CUDA they raise: they never drift to the CPU on their own.  An
entry point that runs a model in f32 on the card calls ``full_f32`` first,
so that PyTorch's own products and convolutions stay f32 (TF32 off), as
the port's f32 kernels are.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch versions on the CPU")
    return dev


def full_f32(device: torch.device) -> None:
    """f32 means f32 on the card: TF32 off for cuBLAS's matrix products
    (PyTorch's default already) and for cuDNN's convolutions (on by default,
    which would put the f32 VAE decode's convs in TF32).  A no-op off CUDA."""
    if device.type != "cuda":
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
