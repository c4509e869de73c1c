"""Export a JAX trainer's router checkpoint as a step dir of the port.

``cli/train.py`` (the JAX package's trainer) writes its routers as an orbax
checkpoint, ``<run>/ckpt/step-XXXXXX/router``, beside ``<run>/config.json``
(the attention geometry) and ``<run>/args.json`` (its flags).  The port
reads only its own step dirs (``vorta_tpu_torch/io/checkpoint.py``), and
the machine that serves it has no orbax.  This script, run where JAX and
orbax are, restores the routers against the model's abstract router state
(``nnx.eval_shape``: no weights are drawn, so HunyuanVideo-13B costs
nothing), maps them to the port's parameter names
(``vorta_tpu_torch.io.from_jax.router_state_from_jax``), and writes them
with the port's own checkpoint writer, with ``config.json`` beside:

  <out>/config.json
  <out>/ckpt/step-XXXXXX/router

which the port's CLI serves unchanged:

  JAX_PLATFORMS=cpu python -m port_assets.export_jax_router \\
      <run>/ckpt/step-000010 --out results/exported
  python -m vorta_tpu_torch.cli.sample --model wan-1_3B --random_embeds \\
      --resume_dir results/exported --router_checkpoint results/exported/ckpt/step-000010

The model (``wan-tiny``, ``wan-1_3B``, ``wan-14B``, ``hunyuan-tiny``,
``hunyuan-13B``) and the routers' dtype come from the run's ``args.json``,
or from ``--model`` / ``--dtype``.  The routers are written as f32.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
from pathlib import Path

import numpy as np


def _model_class(model: str):
    from vorta_tpu.config import WAN_1_3B, WAN_14B, WAN_TINY
    from vorta_tpu.models.hunyuan import HUNYUAN_13B, HUNYUAN_TINY, HunyuanModel
    from vorta_tpu.models.wan import WanModel

    return {"wan-1_3B": (WanModel, WAN_1_3B), "wan-14B": (WanModel, WAN_14B),
            "wan-tiny": (WanModel, WAN_TINY), "hunyuan-13B": (HunyuanModel, HUNYUAN_13B),
            "hunyuan-tiny": (HunyuanModel, HUNYUAN_TINY)}[model]


def router_template(model: str, dtype: str = "bf16"):
    """The model's router state (``training.step.router_partition``) as
    zeros of its shapes and dtype, built without drawing any weight."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from vorta_tpu.training.step import router_partition

    cls, cfg = _model_class(model)
    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    abstract = nnx.eval_shape(lambda: cls(cfg, dtype=dt, param_dtype=dt, rngs=nnx.Rngs(0)))
    _, routers, _ = router_partition(abstract)
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), routers)


def jax_router_arrays(step_dir, model: str, dtype: str = "bf16") -> dict:
    """{keystr path: f32 array} of the routers in a JAX trainer's step dir."""
    import jax

    from vorta_tpu.io.checkpoint import load_router_checkpoint

    routers, _ = load_router_checkpoint(Path(step_dir), router_template(model, dtype))
    flat, _ = jax.tree_util.tree_flatten_with_path(routers)
    return {jax.tree_util.keystr(p): np.asarray(leaf, np.float32) for p, leaf in flat}


def export(step_dir, out, model=None, dtype=None) -> Path:
    """Write the port's ``<out>/ckpt/step-XXXXXX`` (and ``<out>/config.json``
    from the run) for a JAX step dir; returns the new step dir."""
    from vorta_tpu_torch.io.checkpoint import save_router_checkpoint
    from vorta_tpu_torch.io.from_jax import router_state_from_jax

    step_dir, out = Path(step_dir), Path(out)
    m = re.fullmatch(r"step-(\d+)", step_dir.name)
    if m is None or not (step_dir / "router").exists():
        raise FileNotFoundError(f"{step_dir} is not a step-XXXXXX dir with a router checkpoint")
    run = step_dir.parent.parent
    run_args = json.loads((run / "args.json").read_text()) if (run / "args.json").exists() else {}
    model = model or run_args.get("model")
    if model is None:
        raise ValueError(f"no args.json in {run}: pass --model")
    dtype = dtype or run_args.get("dtype", "bf16")
    state = router_state_from_jax(jax_router_arrays(step_dir, model, dtype))
    path = save_router_checkpoint(out / "ckpt", int(m.group(1)), state)
    if (run / "config.json").exists():
        shutil.copyfile(run / "config.json", out / "config.json")
    print(f"[export] {len(state)} router tensors of {model} from {step_dir} -> {path}",
          flush=True)
    return path


def main(argv=None) -> Path:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("step_dir", help="<run>/ckpt/step-XXXXXX written by cli/train.py")
    p.add_argument("--out", required=True, help="the port's run dir to write")
    p.add_argument("--model", default=None, help="default: the run's args.json")
    p.add_argument("--dtype", default=None, choices=["bf16", "fp32"],
                   help="the trainer's --dtype (default: the run's args.json, else bf16)")
    args = p.parse_args(argv)
    return export(args.step_dir, args.out, args.model, args.dtype)


if __name__ == "__main__":
    main()
