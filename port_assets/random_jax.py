"""Random JAX (Flax NNX) modules without a compile per parameter shape.

Flax draws each parameter with ``jax.random``; on the CPU that compiles a
truncated-normal program for every distinct shape, about half a second
each, so building a VAE or the Wan DiT costs tens of seconds before any
work.  The port's CPU tests only need the JAX module and the port to share
random weights, so ``random_module`` builds the module's abstract state
(``nnx.eval_shape``, no draws) and fills it from numpy: arrays of two or
more axes N(0, 1 / fan_in) with fan_in the product of every axis but the
last (a Flax kernel's inputs, an embedding table's rows), biases
N(0, 0.01^2), other 1-D parameters (norm gains) 1 + N(0, 0.01^2).
"""

from __future__ import annotations

import jax
import numpy as np
from flax import nnx


def random_module(make, seed: int = 0):
    """``make()`` (e.g. ``lambda: WanVAE(cfg, rngs=nnx.Rngs(0))``) built with
    numpy draws from ``seed`` in place of Flax's initialisers."""
    graphdef, state = nnx.split(nnx.eval_shape(make))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape, dtype = leaf.shape, leaf.dtype
        if len(shape) >= 2:
            arr = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif "bias" in jax.tree_util.keystr(path):
            arr = 0.01 * rng.standard_normal(shape)
        else:
            arr = 1.0 + 0.01 * rng.standard_normal(shape)
        return jax.numpy.asarray(arr.astype(np.float32)).astype(dtype)

    return nnx.merge(graphdef, jax.tree_util.tree_map_with_path(fill, state))
