"""Carry a JAX WanModel's or HunyuanModel's weights into the port's model
(and, through ``module_state_from_jax``, a JAX text encoder's or VAE's).

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

Quantized serving: ``block_stack_from_jax`` carries a JAX quantized block
stack (``io/quant_serving``'s, its ``QTensor`` leaves given as dicts of
numpy ``q`` / ``scale`` and ``shape`` / ``dtype`` / ``bits``) into the port's
``ops.quant.BlockStack``, keeping the JAX layout; ``block_targets`` maps
each of its leaves onto a port block's parameter (and the rows of it, for
the fused projections), ``block_leaf_shapes`` goes the other way, from a
port block to the JAX leaves, in the JAX package's flattening order.
``load_act_scales`` reads the JAX tool's static int8 scale table.
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


# per block stack: (prefix, the JAX projections, the port's fused one)
FUSED = {
    "blocks": (("attn1.", ("to_q", "to_k", "to_v"), "qkv"),),
    "dual_blocks": (("attn.", ("to_q", "to_k", "to_v"), "qkv"),
                    ("attn.", ("add_q_proj", "add_k_proj", "add_v_proj"), "add_qkv")),
    "single_blocks": (("", ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp"), "qkv_mlp"),),
}


def _fuse_stacks(state: dict, stacks: dict) -> None:
    for stack, n in stacks.items():
        for i in range(n):
            for prefix, parts, fused in FUSED[stack]:
                _fuse(state, f"{stack}.{i}.{prefix}", parts, fused)


def _fuse_wan(state: dict, num_layers: int) -> None:
    _fuse_stacks(state, {"blocks": num_layers})


def _fuse_hunyuan(state: dict, stacks: dict) -> None:
    _fuse_stacks(state, stacks)


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


def _convert_leaf(parts: list, arr: np.ndarray) -> tuple:
    """One leaf of a JAX text encoder or VAE -> (port name, array): Flax
    ``kernel`` (in, out) -> Linear ``weight`` (out, in), the NDHWC Conv
    kernel (kt, kh, kw, in, out) -> Conv3d ``weight`` (out, in, kt, kh, kw),
    ``embedding`` -> nn.Embedding's ``weight``; every other leaf as it is."""
    if parts[-1] == "kernel":
        arr = np.transpose(arr, (4, 3, 0, 1, 2)) if arr.ndim == 5 else np.swapaxes(arr, -1, -2)
        parts = parts[:-1] + ["weight"]
    elif parts[-1] == "embedding":
        parts = parts[:-1] + ["weight"]
    return ".".join(parts), arr


def module_state_from_jax(flat: dict, module: torch.nn.Module) -> dict:
    """{keystr path: array} of a JAX UMT5Encoder, LlamaTextEncoder,
    CLIPTextEncoder, WanVAE or HunyuanVAE -> the state_dict of its port
    namesake ``module`` (built, any device), names and shapes checked."""
    state = {}
    for key, arr in flat.items():
        name, a = _convert_leaf(_parts(key), np.asarray(arr))
        state[name] = _to_tensor(a)
    return _check_against(state, module.state_dict())


ROUTER_KEYS = {
    "weight": "['blocks']['router']['linear']['kernel'].value",  # (L, dim, H*E)
    "bias": "['blocks']['router']['linear']['bias'].value",  # (L, H*E)
}


# the time embedder of the model the JAX package's trained routers were
# trained against (WanModel(WAN_1_3B, bf16, nnx.Rngs(0)); its routers read
# only the timestep embedding): port_assets/export_time_embedder.py
TIME_EMBEDDER = (Path(__file__).resolve().parents[2] / "port_assets"
                 / "wan1_3b_time_embedder_rngs0.npz")


def load_trained_router(model, source, time_embedder: bool = True) -> None:
    """``load_router_npz``, then, with ``time_embedder`` and where the model
    has Wan-1.3B's width, the time embedder the router was trained against
    (``TIME_EMBEDDER``), so it routes as in the JAX package's model."""
    load_router_npz(model, source)
    if time_embedder and model.cfg.dim == 1536:
        load_jax_params(model, TIME_EMBEDDER)


def router_state_from_jax(flat: dict) -> dict:
    """The JAX package's stacked router parameters ({keystr path: array},
    each a block stack's ``['router']['linear']`` kernel or bias, e.g. a
    JAX trainer's router checkpoint flattened) -> the port's {name: f32
    tensor}, the inverse of ``router_state_to_jax``: what a step dir of
    io/checkpoint.py holds."""
    stacks = {}
    for key, arr in flat.items():
        parts = _parts(key)
        if len(parts) != 4 or parts[1:3] != ["router", "linear"] or parts[3] not in (
                "kernel", "bias"):
            raise KeyError(f"not a block stack's router parameter: {key!r}")
        stacks[parts[0]] = np.shape(arr)[0]
    state = _flat_to_state({k: np.asarray(v, np.float32) for k, v in flat.items()}, stacks)
    return {k: v.contiguous() for k, v in state.items()}


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


def router_state_to_jax(router_state: dict) -> dict:
    """The port's router parameters ({name: tensor}, e.g. a step dir's
    ``router``) as the JAX package's stacked arrays: for each block stack
    (Wan's ``blocks``, HunyuanVideo's ``dual_blocks`` and ``single_blocks``)
    ``['<stack>']['router']['linear']['kernel'].value`` (L, dim, H*E) and
    ``...['bias'].value`` (L, H*E), f32 numpy.  ``load_jax_params`` maps
    them back."""
    rows = {}
    for name, t in router_state.items():
        parts = name.split(".")
        if len(parts) != 5 or parts[2:4] != ["router", "linear"] or not parts[1].isdigit():
            raise KeyError(f"not a block's router parameter: {name!r}")
        rows.setdefault((parts[0], parts[4]), {})[int(parts[1])] = \
            t.detach().float().cpu().numpy()
    out = {}
    for (stack, kind), by_layer in rows.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise KeyError(f"{stack}: router layers {sorted(by_layer)} are not 0..L-1")
        layers = [by_layer[i] for i in range(len(by_layer))]
        leaf = "kernel" if kind == "weight" else "bias"
        out[f"['{stack}']['router']['linear']['{leaf}'].value"] = np.stack(
            [a.T if kind == "weight" else a for a in layers])
    return out


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


# --- quantized block stacks -------------------------------------------------------


def _keystr(parts) -> str:
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in parts) + ".value"


def _fused_part(stack: str, block, name: str):
    """(fused parameter name, first row) where ``name`` (a JAX-named port
    parameter, e.g. "attn1.to_k.weight") is part of a fused projection."""
    for prefix, parts, fused in FUSED[stack]:
        for j, part in enumerate(parts):
            if name.startswith(f"{prefix}{part}."):
                sizes = block.get_submodule(prefix + fused).out_sizes
                return f"{prefix}{fused}.{name.rsplit('.', 1)[1]}", sum(sizes[:j])
    return name, 0


def block_targets(stack: str, block, keys) -> dict:
    """{JAX leaf path: (port parameter, first row, transpose)} for one block
    of ``stack``; every parameter of ``block`` must be covered exactly."""
    params = dict(block.named_parameters())
    targets, covered = {}, {}
    for key in keys:
        parts = _parts(key)
        kernel = parts[-1] == "kernel"
        name = ".".join(parts[:-1] + ["weight"] if kernel else parts)
        param, row0 = _fused_part(stack, block, name)
        if param not in params:
            raise KeyError(f"{stack} leaf {key}: the block has no parameter {param}")
        targets[key] = (param, row0, kernel)
        covered[param] = covered.get(param, 0) + 1
    missing = sorted(set(params) - set(covered))
    if missing:
        raise KeyError(f"{stack}: no leaf for {missing[:8]}")
    return targets


def block_leaf_shapes(stack: str, block, depth: int) -> dict:
    """{JAX leaf path: (depth, ...) shape in the JAX layout} of one port
    block, in the JAX package's flattening order (sorted paths)."""
    leaves = {}
    for name, p in block.named_parameters():
        owner, tail = name.rsplit(".", 1) if "." in name else ("", name)
        module = block.get_submodule(owner)
        pieces = [(name, tuple(p.shape))]
        for pre, parts, fused in FUSED[stack]:
            if owner == pre + fused:
                pieces = [(f"{pre}{part}.{tail}", (n,) + tuple(p.shape[1:]))
                          for part, n in zip(parts, module.out_sizes)]
        for pname, shape in pieces:
            parts = pname.split(".")
            if isinstance(module, torch.nn.Linear) and tail == "weight":
                parts[-1], shape = "kernel", shape[::-1]
            leaves[tuple(parts)] = (depth,) + shape
    return {_keystr(k): leaves[k] for k in sorted(leaves)}


def qtensor_from_jax(leaf: dict):
    """A JAX ``QTensor``, as {"q", "scale", "shape", "dtype", "bits"} of numpy
    arrays and its static fields, -> ``ops.quant.QTensor``."""
    from ..ops.quant import QTensor

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "float16": torch.float16}[np.dtype(leaf["dtype"]).name]
    return QTensor(q=_to_tensor(leaf["q"]), scale=_to_tensor(leaf["scale"]).float(),
                   shape=tuple(leaf["shape"]), dtype=dtype, bits=int(leaf["bits"]))


def block_stack_from_jax(flat: dict, stack: str):
    """{JAX leaf path: array, or a QTensor's dict} of one stacked block state
    (the JAX package's quantized stack) -> ``ops.quant.BlockStack``."""
    from ..ops.quant import BlockStack

    return BlockStack({key: qtensor_from_jax(v) if isinstance(v, dict) else _to_tensor(v)
                       for key, v in flat.items()}, stack)


def load_act_scales(source) -> dict:
    """The JAX tool's static int8 activation scales (an npz path or a
    mapping, ``{site: (L,) scale}``) -> {site: (L,) f32 tensor}."""
    data = np.load(source) if isinstance(source, (str, Path)) else source
    return {k: torch.from_numpy(np.asarray(data[k], np.float32).reshape(-1)) for k in data}
