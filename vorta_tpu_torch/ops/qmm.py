"""W8A8 int8 projections for serving, and concatenated projections
(counterpart of vorta_tpu/ops/qmm.py).

``QLinear`` is an ``nn.Linear`` whose forward obeys ``mm_precision``: in
"bf16" (the default) it is the plain product; in "int8" both operands are
quantized on the fly, symmetric, the activation per token (the amax over the
last axis, in f32) or by a static per-tensor scale, the weight per output
channel, and the int8 product accumulates in int32 (``torch._int_mm``; the
JAX package leaves it to XLA's ``dot_general``, outside any Pallas kernel),
then ``acc * x_scale * w_scale + bias`` in f32, cast to x's dtype.
``FusedLinear`` holds several projections that read one input as one
product (weights concatenated along the output dim); in int8 it quantizes
the activation once, its static scale the max of its sites' scales.

Which projections obey the switch follows the JAX model exactly: a module
built as ``QLinear`` / ``FusedLinear(sites=...)`` is one of its QLinears
(``site`` names it within a block for the static-scale table; an unnamed
one always takes dynamic scales); a plain ``nn.Linear`` or
``FusedLinear(sites=None)`` stays in the model's dtype.

The switch and the tables are scoped, not stored: ``mm_precision(mode)``
around a forward, ``layer_act_scales({site: scale})`` around one block's
call, and ``calibration_scope()`` around calls whose per-site max |x| it
collects.  Each is a context manager over a ``contextvars.ContextVar``,
reset on exit, so nothing leaks from one call to the next.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_MM_PRECISION: contextvars.ContextVar[str] = contextvars.ContextVar(
    "vorta_mm_precision", default="bf16")
_ACT_SCALES: contextvars.ContextVar = contextvars.ContextVar("vorta_act_scales", default=None)
_CALIB: contextvars.ContextVar = contextvars.ContextVar("vorta_mm_calib", default=None)

MM_MODES = ("bf16", "int8")


@contextlib.contextmanager
def _scoped(var: contextvars.ContextVar, value):
    tok = var.set(value)
    try:
        yield value
    finally:
        var.reset(tok)


def mm_precision(mode: str):
    """Context: the QLinears called under it run in ``mode`` ("bf16" | "int8")."""
    if mode not in MM_MODES:
        raise ValueError(f"mm_precision must be bf16|int8, got {mode}")
    return _scoped(_MM_PRECISION, mode)


def current_mm_precision() -> str:
    return _MM_PRECISION.get()


def layer_act_scales(scales: Optional[dict]):
    """Context: one layer's static activation scales ({site: f32 scalar}) for
    the QLinears called under it; a site absent from it takes dynamic scales."""
    return _scoped(_ACT_SCALES, scales)


def calibration_scope():
    """Context yielding a dict that collects {site: max |x|} (f32 scalar
    tensors) from the named QLinears called under it."""
    return _scoped(_CALIB, {})


def layer_scale_table(act_scales: Optional[dict], device):
    """{site: (L,)} static activation scales -> i -> layer i's {site: scalar}
    (None without a table), the table moved to ``device`` once."""
    if not act_scales:
        return lambda i: None
    table = {k: torch.as_tensor(v, dtype=torch.float32).reshape(-1).to(device)
             for k, v in act_scales.items()}
    return lambda i: {k: v[i] for k, v in table.items()}


def calibration(on: bool):
    """``calibration_scope()`` where ``on``, else a scope yielding None."""
    return calibration_scope() if on else contextlib.nullcontext()


def stack_calibration(per_layer: list) -> dict:
    """[{site: amax} per layer] -> {site: (L,) f32}."""
    return {k: torch.stack([layer[k] for layer in per_layer]) for k in per_layer[0]}


def _record(sites, x: torch.Tensor) -> None:
    calib = _CALIB.get()
    named = [s for s in sites if s is not None]
    if calib is None or not named:
        return
    amax = x.detach().float().abs().amax()
    for s in named:
        calib[s] = amax if s not in calib else torch.maximum(calib[s], amax)


def _static_scale(sites) -> Optional[torch.Tensor]:
    scales = _ACT_SCALES.get()
    if scales is None:
        return None
    have = [torch.as_tensor(scales[s]).float() for s in sites if s is not None and s in scales]
    return torch.stack(have).amax() if have else None


def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, a true division on every device: CUDA PyTorch multiplies by
    the reciprocal of a Python-scalar divisor (off by an ulp at times), so
    the divisor is a tensor on x's device.  The quantizers' scales are
    amax / 127 (or / 7) as the JAX package divides them."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def quantize_symmetric(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to +-127, as int8 (round half to even, as jnp.round)."""
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 (M, N) = (M, K) int8 @ (N, K)^T int8: ``torch._int_mm``
    on CUDA, which needs M > 16 and K, N multiples of 8 (the operands are
    zero-padded to that; zeros add nothing to the sums), the plain version
    elsewhere (the CPU's ``_int_mm`` may saturate int16 pair sums on a CPU
    without VNNI, so it is not exact everywhere)."""
    if xq.device.type != "cuda":
        return int8_matmul_ref(xq, wq)
    m, k = xq.shape
    n = wq.shape[0]
    mp, kp, np_ = max(_round_up(m, 8), 32), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        xq = F.pad(xq, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        wq = F.pad(wq, (0, kp - k, 0, np_ - n))
    return torch._int_mm(xq, wq.t())[:m, :n]


def int8_matmul_ref(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The plain version of ``int8_matmul``: the product in f64, exact for
    int8 operands (|sum| <= 127^2 K < 2^53), as int32."""
    return (xq.double() @ wq.double().t()).to(torch.int32)


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                x_scale: Optional[torch.Tensor] = None, matmul=int8_matmul) -> torch.Tensor:
    """y = x @ weight.T (+ bias) with symmetric int8 quantization (the JAX
    package's ``int8_linear``; ``weight`` is the (N, K) nn.Linear weight).

    x_scale: None for dynamic per-token scales (amax over the last axis, in
    f32, / 127), or a static per-tensor scalar.  ``matmul``: the int8
    product, ``int8_matmul_ref`` for the plain version."""
    xf = x.float()
    if x_scale is None:
        x_scale = divide(xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12), 127.0)
    else:
        x_scale = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    xq = quantize_symmetric(xf, x_scale)
    wf = weight.float()
    w_scale = divide(wf.abs().amax(dim=1).clamp(min=1e-12), 127.0)  # (N,)
    wq = quantize_symmetric(wf, w_scale[:, None])
    acc = matmul(xq.reshape(-1, xq.shape[-1]), wq).reshape(*x.shape[:-1], -1)
    y = acc.float() * x_scale * w_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _project(x: torch.Tensor, weight: torch.Tensor, bias, sites) -> torch.Tensor:
    """A QLinear's (or a fused group's) product under the current scope."""
    _record(sites, x)
    if _MM_PRECISION.get() == "int8":
        return int8_linear(x, weight, bias, x_scale=_static_scale(sites))
    return F.linear(x, weight, bias)


class QLinear(nn.Linear):
    """nn.Linear that obeys ``mm_precision`` (the JAX package's QLinear);
    ``site`` names it within its block for the static-scale table."""

    def __init__(self, in_features: int, out_features: int, *, site: Optional[str] = None, **kw):
        super().__init__(in_features, out_features, **kw)
        self.site = site

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _project(x, self.weight, self.bias, (self.site,))


def fused_linear(x: torch.Tensor, linears) -> list:
    """Several Linears / QLinears that share the input ``x``, as ONE product
    of their concatenated weights (the JAX package's ``fused_linear``):
    each output column's sum is unchanged; in int8 the input is quantized
    once, by the max of the named sites' static scales.  Returns one output
    per layer."""
    sizes = [lin.out_features for lin in linears]
    weight = torch.cat([lin.weight for lin in linears], dim=0)
    bias = None
    if any(lin.bias is not None for lin in linears):
        bias = torch.cat([lin.bias if lin.bias is not None
                          else torch.zeros(n, dtype=x.dtype, device=x.device)
                          for lin, n in zip(linears, sizes)])
    y = _project(x, weight, bias, tuple(getattr(lin, "site", None) for lin in linears))
    return list(torch.split(y, sizes, dim=-1))


class FusedLinear(nn.Linear):
    """Several Linears that share one input, as ONE product.

    The weights and biases are stored concatenated along the output dim
    (``io/from_jax.py`` concatenates the JAX model's separate kernels once,
    at load), so a call is one product, returned as column views: each
    output column's sum is unchanged, one launch instead of
    ``len(out_sizes)``.  ``sites``: None for plain Linears, else one entry
    (a site name or None) per part: the parts are QLinears, and in int8 the
    input is quantized once, with the max of the parts' static scales
    (the JAX package's ``fused_linear``).
    """

    def __init__(self, in_features: int, out_sizes: Sequence[int],
                 sites: Optional[Sequence[Optional[str]]] = None, **kw):
        super().__init__(in_features, sum(out_sizes), **kw)
        self.out_sizes = tuple(out_sizes)
        if sites is not None and len(sites) != len(self.out_sizes):
            raise ValueError(f"{len(sites)} sites for {len(self.out_sizes)} parts")
        self.sites = None if sites is None else tuple(sites)

    def forward(self, x: torch.Tensor) -> list:
        if self.sites is None:
            y = super().forward(x)
        else:
            y = _project(x, self.weight, self.bias, self.sites)
        return list(torch.split(y, self.out_sizes, dim=-1))
