"""Carry a JAX WanModel's or HunyuanModel's weights into the port's model.

Input: the JAX model state flattened to ``jax.tree_util.keystr`` paths, e.g.
``"['blocks']['attn1']['to_q']['kernel'].value"`` -> numpy array (the key
format of the JAX package's router npz files).  The caller flattens with
jax; this module takes only numpy.

  * the scanned stacks' leading axis (Wan's ``blocks``, Hunyuan's
    ``dual_blocks`` and ``single_blocks``) is unstacked into
    ``<stack>.{i}``; list indices (``[0]``) become ``.0``;
  * Flax Linear kernels (in, out) become nn.Linear weights (out, in);
  * the NDHWC Conv kernel (kt, kh, kw, cin, cout) becomes the Conv3d
    weight (cout, cin, kt, kh, kw);
  * q/k columns and qk-norm gains stay in their half-permuted RoPE layout
    (ops/rope.py permute_qk_to_half), exactly as stored;
  * projections that share an input are concatenated, once, into the
    port's one product (ops/qmm.py FusedLinear): Wan's self-attention
    to_q / to_k / to_v into ``attn1.qkv``; Hunyuan's dual-block to_q /
    to_k / to_v into ``attn.qkv`` and add_q_proj / add_k_proj / add_v_proj
    into ``attn.add_qkv``, its single-block attn.to_q / to_k / to_v and
    proj_mlp into ``qkv_mlp``;
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

_PART = re.compile(r"\[(?:'([^']+)'|(\d+))\]")
_CONVS = ("patch_embedding", "x_embedder")  # NDHWC Conv kernels


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable, contiguous copy


def _parts(key: str) -> list:
    parts = [a or b for a, b in _PART.findall(key)]
    if not parts:
        raise KeyError(f"not a keystr path: {key!r}")
    return parts


def _convert(parts: list, arr: np.ndarray) -> tuple:
    name = ".".join(parts)
    if parts[-1] == "kernel":
        name = ".".join(parts[:-1] + ["weight"])
        if parts[0] in _CONVS:
            arr = np.transpose(arr, (4, 3, 0, 1, 2))
        else:
            arr = np.swapaxes(arr, -1, -2)
    return name, arr


def _meta(arr) -> torch.Tensor:
    return torch.empty(np.shape(arr), device="meta")


def _flat_to_state(flat, stacks: dict, to_tensor=_to_tensor) -> dict:
    """{keystr path: array} -> {port parameter name: tensor}, the stacks
    ({name: layers}) unstacked."""
    state = {}
    for key in flat:
        parts = _parts(key)
        arr = np.asarray(flat[key])
        if parts[0] in stacks:
            n = stacks[parts[0]]
            if arr.shape[0] != n:
                raise ValueError(f"{key}: leading axis {arr.shape[0]} != {n} layers")
            for i in range(n):
                name, a = _convert(parts[1:], arr[i])
                state[f"{parts[0]}.{i}.{name}"] = to_tensor(a)
        else:
            name, a = _convert(parts, arr)
            state[name] = to_tensor(a)
    return state


def _fuse(state: dict, prefix: str, parts, fused: str) -> None:
    """Concatenate ``prefix + part`` weights and biases into ``prefix +
    fused`` where all parts are present (else they stay, and the key check
    names them)."""
    for p in ("weight", "bias"):
        keys = [f"{prefix}{n}.{p}" for n in parts]
        if all(key in state for key in keys):
            state[f"{prefix}{fused}.{p}"] = torch.cat([state.pop(key) for key in keys])


def _check_against(state: dict, expected: dict) -> dict:
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise KeyError(f"missing {missing[:8]} extra {extra[:8]}")
    for name, t in expected.items():
        if tuple(t.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: {tuple(state[name].shape)} != {tuple(t.shape)}")
    return state


def wan_state_from_jax(flat: dict, cfg: WanModelConfig) -> dict:
    """{keystr path: array} of the JAX WanModel -> the port's state_dict."""
    from ..models.wan import WanModel

    state = _flat_to_state(flat, {"blocks": cfg.num_layers})
    _fuse_wan(state, cfg.num_layers)
    return _check_against(state, WanModel(cfg, device="meta").state_dict())


def _fuse_wan(state: dict, num_layers: int) -> None:
    for i in range(num_layers):
        _fuse(state, f"blocks.{i}.attn1.", ("to_q", "to_k", "to_v"), "qkv")


def _fuse_hunyuan(state: dict, stacks: dict) -> None:
    for i in range(stacks.get("dual_blocks", 0)):
        pre = f"dual_blocks.{i}.attn."
        _fuse(state, pre, ("to_q", "to_k", "to_v"), "qkv")
        _fuse(state, pre, ("add_q_proj", "add_k_proj", "add_v_proj"), "add_qkv")
    for i in range(stacks.get("single_blocks", 0)):
        _fuse(state, f"single_blocks.{i}.", ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp"),
              "qkv_mlp")


def hunyuan_state_from_jax(flat: dict, cfg, meta: bool = False) -> dict:
    """{keystr path: array} of the JAX HunyuanModel -> the port's state_dict
    (``cfg``: the port's HunyuanModelConfig).  ``meta=True`` maps names and
    shapes only, to meta tensors, copying no data: the check of a full-size
    configuration's layout (the arrays may then be zero-stride views)."""
    from ..models.hunyuan import HunyuanModel

    stacks = {"dual_blocks": cfg.dual_layers, "single_blocks": cfg.single_layers}
    state = _flat_to_state(flat, stacks, _meta if meta else _to_tensor)
    _fuse_hunyuan(state, stacks)
    return _check_against(state, HunyuanModel(cfg, device="meta").state_dict())


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
    mapping of JAX WanModel or HunyuanModel paths) names, and no others, in
    the port's built model (a fused projection only with all its parts).
    A path the model does not have or a wrong shape raises before anything
    is set."""
    data = np.load(source) if isinstance(source, (str, Path)) else source
    if hasattr(model, "dual_blocks"):
        stacks = {"dual_blocks": len(model.dual_blocks),
                  "single_blocks": len(model.single_blocks)}
        state = _flat_to_state(data, stacks)
        _fuse_hunyuan(state, stacks)
    else:
        state = _flat_to_state(data, {"blocks": len(model.blocks)})
        _fuse_wan(state, len(model.blocks))
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
