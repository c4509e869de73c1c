"""Export the time embedder of the JAX package's benchmark model, for the port.

``bench.py`` builds ``WanModel(WAN_1_3B, bf16, rngs=nnx.Rngs(0))`` with
random weights and routes it with ``assets/bench_router_wan1_3b_720p_half.npz``,
a router trained against that model.  Every block's router reads only the
timestep embedding ``condition_embedder.time_embedder(sinusoid(t))``, so a
port model that takes these weights (``vorta_tpu_torch.io.from_jax.
load_jax_params``) feeds the trained router what ``bench.py`` feeds it.

The weights are drawn as ``WanModel.__init__`` draws them: the patch
embedding, then the time embedder, from one ``nnx.Rngs(seed)`` stream (the
condition embedder makes its time embedder first, and nothing else draws
before it), so the 1.3B model is never built.
``tests/test_torch_port_routed.py`` checks this against a whole model at the
tiny configuration, and the committed file against a fresh export.

  JAX_PLATFORMS=cpu python -m port_assets.export_time_embedder
      writes port_assets/wan1_3b_time_embedder_rngs0.npz ({keystr path:
      float32 array}, holding the bf16 values exactly)
  JAX_PLATFORMS=cpu python -m port_assets.export_time_embedder \\
      --mix assets/bench_router_wan1_3b_720p_half.npz --t 500
      also prints the heads the router sends to each expert at timestep t,
      as the JAX package computes it (bench.py's routing_mix at tau 0.3)
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent / "wan1_3b_time_embedder_rngs0.npz"
PREFIX = "['condition_embedder']['time_embedder']"


def time_embedder_params(cfg, seed: int = 0) -> dict:
    """{keystr path: float32 array} of the time embedder that
    ``WanModel(cfg, bf16, rngs=nnx.Rngs(seed))`` draws."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from vorta_tpu.models.common import TimestepEmbedding

    rngs = nnx.Rngs(seed)
    kw = dict(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16, rngs=rngs)
    nnx.Conv(cfg.in_channels, cfg.dim, kernel_size=cfg.patch_size, strides=cfg.patch_size,
             padding="VALID", **kw)  # WanModel's first draw
    emb = TimestepEmbedding(cfg.freq_dim, cfg.dim, **kw)
    flat = jax.tree_util.tree_flatten_with_path(nnx.state(emb))[0]
    return {PREFIX + jax.tree_util.keystr(p): np.asarray(leaf, np.float32) for p, leaf in flat}


def routing_heads(params: dict, router_npz, t: float, cfg, tau: float = 0.3) -> np.ndarray:
    """Heads per expert (full, lowres, sta) over all blocks at timestep
    ``t``, from the JAX package's own time embedder and router modules."""
    import jax.numpy as jnp
    from flax import nnx

    from vorta_tpu.models.common import TimestepEmbedding, sinusoidal_timestep_embedding
    from vorta_tpu.models.router import Router
    from vorta_tpu.ops.routed_fused import route_expert_ids

    emb = TimestepEmbedding(cfg.freq_dim, cfg.dim, dtype=jnp.bfloat16,
                            param_dtype=jnp.bfloat16, rngs=nnx.Rngs(0))
    for name in ("linear_1", "linear_2"):
        lin = getattr(emb, name)
        lin.kernel.value = jnp.asarray(params[f"{PREFIX}['{name}']['kernel'].value"], jnp.bfloat16)
        lin.bias.value = jnp.asarray(params[f"{PREFIX}['{name}']['bias'].value"], jnp.bfloat16)
    sin = sinusoidal_timestep_embedding(jnp.full((1,), t), cfg.freq_dim)
    temb = emb(sin.astype(jnp.bfloat16))
    data = np.load(router_npz)
    w = data["['blocks']['router']['linear']['kernel'].value"]
    b = data["['blocks']['router']['linear']['bias'].value"]
    router = Router(cfg.dim, cfg.num_heads, rngs=nnx.Rngs(0))
    ids = []
    for i in range(w.shape[0]):
        router.linear.kernel.value = jnp.asarray(w[i])
        router.linear.bias.value = jnp.asarray(b[i])
        ids.append(np.asarray(route_expert_ids(router(temb), tau)))
    return np.bincount(np.concatenate(ids), minlength=3)


def main(argv=None) -> None:
    from vorta_tpu.config import WAN_1_3B

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=str(OUT))
    p.add_argument("--mix", default=None, help="a router npz of the JAX package")
    p.add_argument("--t", type=float, default=500.0)
    args = p.parse_args(argv)
    params = time_embedder_params(WAN_1_3B)
    np.savez_compressed(args.out, **params)
    print(f"wrote {args.out}: " + ", ".join(f"{k} {v.shape}" for k, v in params.items()))
    if args.mix:
        heads = routing_heads(params, args.mix, args.t, WAN_1_3B)
        print(f"{args.mix} at t = {args.t:g}: heads full {heads[0]}, lowres {heads[1]}, "
              f"sta {heads[2]} (of {heads.sum()})")


if __name__ == "__main__":
    main()
