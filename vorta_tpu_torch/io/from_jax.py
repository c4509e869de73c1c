"""Carry a JAX WanModel's weights into the port's ``WanModel``.

Input: the JAX model state flattened to ``jax.tree_util.keystr`` paths, e.g.
``"['blocks']['attn1']['to_q']['kernel'].value"`` -> numpy array (the key
format of the JAX package's router npz files).  The caller flattens with
jax; this module takes only numpy.

  * the scanned ``blocks`` leading axis is unstacked into ``blocks.{i}``;
  * Flax Linear kernels (in, out) become nn.Linear weights (out, in);
  * the NDHWC Conv kernel (kt, kh, kw, cin, cout) becomes the Conv3d
    weight (cout, cin, kt, kh, kw);
  * q/k columns and qk-norm gains stay in their half-permuted RoPE layout
    (ops/rope.py permute_qk_to_half), exactly as stored;
  * self-attention's to_q / to_k / to_v are concatenated, once, into the
    port's one ``attn1.qkv`` (ops/qmm.py FusedLinear);
  * router parameters come along.

A missing or extra key, or a shape that does not match, raises.

``load_router_npz`` carries only the routers, from the npz files of the JAX
package's router training (``bench.py:load_router_npz``'s input, e.g.
``assets/bench_router_wan1_3b_720p_half.npz``), into a built model.
``load_jax_params`` carries any subset of the parameters into a built
model, e.g. ``port_assets/wan1_3b_time_embedder_rngs0.npz``, the time
embedder that the trained router was trained against.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from ..config import WanModelConfig

_PART = re.compile(r"\['([^']+)'\]")


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable, contiguous copy


def _convert(parts: list, arr: np.ndarray) -> tuple:
    name = ".".join(parts)
    if parts[-1] == "kernel":
        name = ".".join(parts[:-1] + ["weight"])
        if parts[0] == "patch_embedding":
            arr = np.transpose(arr, (4, 3, 0, 1, 2))
        else:
            arr = np.swapaxes(arr, -1, -2)
    return name, arr


def _flat_to_state(flat, num_layers: int) -> dict:
    """{keystr path: array} -> {port parameter name: tensor}, blocks unstacked."""
    state = {}
    for key in flat:
        parts = _PART.findall(key)
        if not parts:
            raise KeyError(f"not a keystr path: {key!r}")
        arr = np.asarray(flat[key])
        if parts[0] == "blocks":
            if arr.shape[0] != num_layers:
                raise ValueError(f"{key}: leading axis {arr.shape[0]} != {num_layers} layers")
            for i in range(num_layers):
                name, a = _convert(parts[1:], arr[i])
                state[f"blocks.{i}.{name}"] = _to_tensor(a)
        else:
            name, a = _convert(parts, arr)
            state[name] = _to_tensor(a)
    return state


def wan_state_from_jax(flat: dict, cfg: WanModelConfig) -> dict:
    """{keystr path: array} of the JAX WanModel -> the port's state_dict."""
    from ..models.wan import WanModel

    state = _flat_to_state(flat, cfg.num_layers)
    for i in range(cfg.num_layers):
        for p in ("weight", "bias"):
            keys = [f"blocks.{i}.attn1.to_{n}.{p}" for n in "qkv"]
            if all(key in state for key in keys):  # else they stay, and raise below
                state[f"blocks.{i}.attn1.qkv.{p}"] = torch.cat([state.pop(key) for key in keys])

    expected = WanModel(cfg, device="meta").state_dict()
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise KeyError(f"missing {missing[:8]} extra {extra[:8]}")
    for name, t in expected.items():
        if tuple(t.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: {tuple(state[name].shape)} != {tuple(t.shape)}")
    return state


ROUTER_KEYS = {
    "weight": "['blocks']['router']['linear']['kernel'].value",  # (L, dim, H*E)
    "bias": "['blocks']['router']['linear']['bias'].value",  # (L, H*E)
}


def load_router_npz(model, source) -> None:
    """Set every block's router of the port's ``WanModel`` from the stacked
    JAX router arrays: ``source`` is an npz path or a {keystr: array}
    mapping.  A missing key, a missing block or a wrong shape raises."""
    data = np.load(source) if isinstance(source, (str, Path)) else source
    n, dim = len(model.blocks), model.cfg.dim
    out = model.blocks[0].router.linear.out_features
    want = {"weight": (n, dim, out), "bias": (n, out)}
    arrays = {}
    for name, key in ROUTER_KEYS.items():
        if key not in data:
            raise KeyError(f"router key {key!r} missing")
        arrays[name] = np.asarray(data[key], np.float32)
        if arrays[name].shape != want[name]:
            raise ValueError(f"{key}: shape {arrays[name].shape} != {want[name]} "
                             f"({n} blocks, dim {dim}, {out} router outputs)")
    with torch.no_grad():
        for i, block in enumerate(model.blocks):
            lin = block.router.linear
            lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(arrays["weight"][i].T)))
            lin.bias.copy_(torch.from_numpy(arrays["bias"][i]))


def load_jax_params(model, source) -> None:
    """Set the parameters that ``source`` (an npz path or a {keystr: array}
    mapping of JAX WanModel paths) names, and no others, in the port's
    built ``WanModel``.  A path the model does not have or a wrong shape
    raises before anything is set."""
    data = np.load(source) if isinstance(source, (str, Path)) else source
    state = _flat_to_state(data, len(model.blocks))
    params = model.state_dict()
    unknown = sorted(set(state) - set(params))
    if unknown:
        raise KeyError(f"the model has no parameter {unknown[:8]}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: {tuple(t.shape)} != {tuple(params[name].shape)}")
    with torch.no_grad():
        for name, t in state.items():
            params[name].copy_(t)
