"""The port's STA bisection tool (vorta_tpu_torch/tools/sta_diag.py) against
the JAX tool's kernel (tools/sta_diag.py:_kernel), on the CPU.

The JAX tool's ``run`` returns only seconds, so these tests build its
``pallas_call`` as ``run``'s ``call`` does and run it in interpret mode, one
call per variant, at latent (4, 6, 16), tile (2, 3, 8), window (3, 3, 3)
(two chunks of 2 x 3 x 16 keys: both softmax chains hold one), 2 heads x 64.
Inputs come from numpy with a seed, f32 on both sides; tolerance rtol 1e-4
and atol 1e-4 x the output's max abs value (the two sides sum in different
orders).  ``no_dma``'s output is undefined in both packages and is not
compared.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vorta_tpu.ops.sta_window import window_starts
from vorta_tpu_torch.tools import sta_diag


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LATENT, TILE, WINDOW, H, D = (4, 6, 16), (2, 3, 8), (3, 3, 3), 2, 64


@pytest.fixture(scope="module")
def jax_tool():
    path = Path(__file__).resolve().parent.parent / "tools" / "sta_diag.py"
    spec = importlib.util.spec_from_file_location("jax_sta_diag", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_call(tool, variant, q, k, v):
    """tools/sta_diag.py:run's ``call``, in interpret mode."""
    t, hh, w = LATENT
    tt, th, tw = TILE
    nt, nh, nw = t // tt, hh // th, w // tw
    win_eff = (min(WINDOW[0], nt), min(WINDOW[1], nh), min(WINDOW[2], nw))
    bw, tpt = win_eff[2] * tw, tt * th * tw
    starts = jnp.asarray(window_starts(LATENT, TILE, WINDOW))
    kernel = functools.partial(tool._kernel, tile=TILE, win_eff=win_eff, variant=variant,
                               scale=D**-0.5)

    def q_map(bb, gg, ii, *r):
        ti = ii // (nh * nw)
        rem = ii - ti * (nh * nw)
        return (bb, gg, ti, rem // nw, rem - (rem // nw) * nw, 0)

    n_slots = 4
    shape6 = (1, H, t, hh, w, D)
    out6 = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(1, H, nt * nh * nw),
            in_specs=[pl.BlockSpec((1, 1, tt, th, tw, D), q_map),
                      pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((1, 1, tt, th, tw, D), q_map),
            scratch_shapes=[
                pltpu.VMEM((2, tpt, 1), jnp.float32), pltpu.VMEM((2, tpt, 1), jnp.float32),
                pltpu.VMEM((2, tpt, D), jnp.float32),
                pltpu.VMEM((n_slots, tt, th, bw, D), k.dtype),
                pltpu.VMEM((n_slots, tt, th, bw, D), v.dtype),
                pltpu.SemaphoreType.DMA((n_slots, 2)),
            ]),
        out_shape=jax.ShapeDtypeStruct(shape6, q.dtype),
        interpret=True,
    )(starts, *(x.reshape(shape6) for x in (q, k, v)))
    return out6.reshape(q.shape)


@pytest.mark.parametrize("variant", ["full", "full_unroll", "dots_only", "dma_only"])
def test_plain_variants_match_the_jax_kernel(jax_tool, variant):
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((1, H, int(np.prod(LATENT)), D)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(_jax_call(jax_tool, variant, *(jnp.asarray(x) for x in (q, k, v))))
    got = sta_diag.sta_diag_attention(*map(torch.from_numpy, (q, k, v)), latent_shape=LATENT,
                                      tile=TILE, window=WINDOW, variant=variant)
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1e-6))
    if variant == "dma_only":
        assert not got.any()


def test_tool_runs_on_the_cpu_and_wants_a_device(capsys):
    """``--device cpu`` runs every variant's plain version and prints the JAX
    tool's lines; without ``--device`` the tool asks for CUDA, which this
    machine lacks, and raises."""
    times = sta_diag.main(["--device", "cpu", "--latent", *map(str, LATENT), "--tile",
                           *map(str, TILE), "--heads", "2", "--head_dim", "64", "--iters", "1",
                           *sta_diag.VARIANTS])
    assert set(times) == set(sta_diag.VARIANTS) and all(t > 0 for t in times.values())
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(sta_diag.VARIANTS)
    assert all(ln.endswith(" ms") for ln in lines)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sta_diag.main([])
