"""``tools.calibrate_int8`` and ``tools.fit_cache_poly`` against the JAX
package's tools, on the CPU.

calibrate_int8: ``bench_attn_cfg`` at both geometries field for field, and
``calibrate_wan`` at ``WAN_TINY`` with the JAX model's weights carried over
(io/from_jax.py) and two (latents, timestep, context) points drawn with
numpy, each side's model under ``calibrate_mm`` (routing off; the JAX model
jitted, its kernels in interpret mode): the same {site: (L,)} maxima within
rtol 1e-5 (f32 on both sides, summed in other orders).  The JAX tool's
``main`` builds Wan-1.3B, so the port's ``main`` runs on the card only
(chip_smoke.py).

fit_cache_poly: the JAX tool at its default ``wan-tiny`` with CFG
(``--guidance_scale 5``, 6 Euler steps) against the port's tool on the same
weights (numpy draws, port_assets/random_jax.py), noise and text states:
the npz's ``indicator`` and ``residual`` within rtol 1e-3 (relative L1
distances of f32 tensors, routed hard), the port's ``coefficients`` equal
to ``np.polyfit`` of its own points (a degree-4 fit of five points
amplifies last-bit differences, so JAX's coefficients are not compared),
and the last JSON line's keys.
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vorta_tpu.models.wan as jwan
import vorta_tpu.pipelines.wan_t2v as jwpipe
from port_assets.random_jax import random_module
from vorta_tpu.config import WAN_TINY as JAX_WAN_TINY
from vorta_tpu_torch.config import WAN_TINY
from vorta_tpu_torch.io import from_jax
from vorta_tpu_torch.models.wan import WanModel
from vorta_tpu_torch.pipelines.wan_t2v import WanT2VPipeline
from vorta_tpu_torch.tools import calibrate_int8, fit_cache_poly

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(jmodel) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(jmodel))
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


def _port_of(jmodel, cfg=WAN_TINY):
    model = WanModel(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax.wan_state_from_jax(_flat(jmodel), cfg))
    return model


@pytest.mark.parametrize("geom", ["720p", "480p"])
def test_bench_attn_cfg_matches_jax(geom):
    want = dataclasses.asdict(_jax_tool("calibrate_int8").bench_attn_cfg(geom))
    assert dataclasses.asdict(calibrate_int8.bench_attn_cfg(geom)) == want


def test_calibrate_wan_matches_jax():
    jtool = _jax_tool("calibrate_int8")
    jmodel = random_module(lambda: jwan.WanModel(JAX_WAN_TINY, dtype=jnp.float32,
                                                 rngs=nnx.Rngs(0)), 3)
    tmodel = _port_of(jmodel)
    from vorta_tpu.config import AttentionConfig as JaxAttentionConfig

    from vorta_tpu_torch.config import AttentionConfig

    grid = dict(latent_shape=(4, 4, 4), block_q=16, block_kv=16)
    rng = np.random.default_rng(17)
    points = [(rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32), np.array([ts], np.float32),
               rng.standard_normal((1, 16, 32)).astype(np.float32)) for ts in (300.0, 800.0)]
    graphdef, state = nnx.split(jmodel)

    @jax.jit
    def jcall(lat, t, ctx):
        return nnx.merge(graphdef, state)(lat, t, ctx, attn_cfg=JaxAttentionConfig(**grid),
                                          interpret=True, calibrate_mm=True).mm_calibration

    want = jtool.calibrate_wan(jcall, [tuple(jnp.asarray(x) for x in p) for p in points])

    def tcall(lat, t, ctx):
        with torch.inference_mode():
            return tmodel(lat, t, ctx, attn_cfg=AttentionConfig(**grid),
                          calibrate_mm=True).mm_calibration

    got = calibrate_int8.calibrate_wan(tcall, [tuple(torch.from_numpy(x) for x in p)
                                               for p in points])
    assert set(got) == set(want) and len(got) >= 4
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == (WAN_TINY.num_layers,)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, err_msg=k)
    # the max over the points: each point alone stays at or under it
    one = calibrate_int8.calibrate_wan(tcall, [tuple(torch.from_numpy(x) for x in points[0])])
    assert all((one[k] <= got[k]).all() for k in got)


def test_calibrate_main_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibrate_int8.main(["--geom", "480p"])


def test_fit_cache_poly_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    """wan-tiny, CFG 5, 6 Euler steps (5 points for the degree-4 fit)."""
    made = {}
    real = jwan.WanModel
    monkeypatch.setattr(jwan, "WanModel", lambda *a, **kw: made.setdefault(
        "dit", random_module(lambda: real(*a, **{**kw, "rngs": nnx.Rngs(0)}), 0)))
    jprep, tprep = jwpipe.WanT2VPipeline.prepare_latents, WanT2VPipeline.prepare_latents
    noise = {}

    def jnoise(self, *a):
        noise["x"] = np.asarray(jprep(self, *a))  # the JAX tool's own draw
        return jnp.asarray(noise["x"])

    monkeypatch.setattr(jwpipe.WanT2VPipeline, "prepare_latents", jnoise)
    argv = ["--guidance_scale", "5", "--steps", "6"]
    jout, tout = tmp_path / "jax.npz", tmp_path / "port.npz"
    monkeypatch.setattr(sys, "argv", ["fit_cache_poly.py", *argv, "--out", str(jout)])
    _jax_tool("fit_cache_poly").main()
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    monkeypatch.setattr(fit_cache_poly, "WanModel", lambda cfg, **kw: _port_of(made["dit"], cfg))
    monkeypatch.setattr(WanT2VPipeline, "prepare_latents", lambda self, gen, *a: torch.from_numpy(
        noise["x"]).reshape(tuple(tprep(self, gen, *a).shape)))
    monkeypatch.setattr(fit_cache_poly, "random_embeds", lambda gen, seed, shape, device:
                        torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                                                     shape))))
    rec = fit_cache_poly.main(argv + ["--device", "cpu", "--out", str(tout)])
    tline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(tline) == set(jline) and tline["points"] == jline["points"] == 5
    assert tline == {k: v for k, v in rec.items() if k in tline}
    got, want = np.load(tout), np.load(jout)
    assert set(got.files) == set(want.files) == {"coefficients", "indicator", "residual"}
    for k in ("indicator", "residual"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    np.testing.assert_array_equal(got["coefficients"],
                                  np.polyfit(got["indicator"], got["residual"], 4))
    assert np.isfinite(tline["r2"])


def test_fit_cache_poly_refuses_f32_on_cuda(capsys):
    with pytest.raises(SystemExit):
        fit_cache_poly.parse_args([])  # wan-tiny, the card by default
    assert "A3" in capsys.readouterr().err
    assert fit_cache_poly.parse_args(["--model", "wan-1_3B"]).device == "cuda"
