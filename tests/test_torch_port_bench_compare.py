"""``cli.bench_compare`` and the Wan pipeline's ``return_scores`` against the
JAX package, on the CPU.

One comparison runs through both CLIs at ``wan-tiny`` (13 frames at 64 x
64, 4 UniPC steps with CFG as one batch-2 forward, the step cache at
threshold 1.0 after 1 warm-up step with the repo's fitted polynomial, and a
one-value ``--tau_sweep``): the JAX CLI (``cli/bench_compare.py``, loaded
from its file) builds its model with random weights from numpy
(port_assets/random_jax.py), the port's CLI takes them through
io/from_jax.py, both draw the JAX CLI's text states and the same numpy
noise.  The JAX side runs its Pallas kernels in interpret mode; its CLI is
held once, and the rest against the port's own functions.

Tolerances: latents (f32 on both sides, summed in other orders) within
max |port - JAX| <= 1e-4 * max(max |JAX|, 1), as the other CLI parity
tests; router scores rtol 1e-4; PSNR within 0.05 dB, SSIM and the
weight-free metrics within 1e-3 when recomputed from the two CLIs' latents
(they compare latents that differ by ~1e-2, so 1e-5 moves them in their
third decimal at most); the expert mix exactly.  HunyuanVideo's branch is
held against the port's own pipeline called directly (bit for bit).
"""

import argparse
import importlib.util
import json
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
from vorta_tpu_torch.cli import bench_compare
from vorta_tpu_torch.config import WAN_TINY
from vorta_tpu_torch.geometry import HUNYUAN_GEOMETRY
from vorta_tpu_torch.io import from_jax
from vorta_tpu_torch.io import quality as q
from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanModel
from vorta_tpu_torch.models.wan import WanModel
from vorta_tpu_torch.pipelines.hunyuan_t2v import HunyuanSamplingConfig, HunyuanT2VPipeline
from vorta_tpu_torch.pipelines.wan_t2v import SamplingConfig, WanT2VPipeline

REPO = Path(__file__).resolve().parents[1]
ARGV = ["--model", "wan-tiny", "--num_frames", "13", "--height", "64", "--width", "64",
        "--num_inference_steps", "4", "--cfg_batch", "--cache_threshold", "1.0",
        "--cache_warmup", "1", "--cache_poly", str(REPO / "assets/cache_poly_wan1_3b_720p.npz"),
        "--tau_sweep", "0.5", "--seed", "3"]
ARMS = ("baseline", "vorta", "vorta_cached")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli():
    spec = importlib.util.spec_from_file_location("_jax_cli_bench_compare",
                                                  REPO / "cli" / "bench_compare.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _noise(shape):
    return np.random.default_rng(11).standard_normal(shape).astype(np.float32)


def _jax_normal(seed, shape):
    """The JAX CLI's text states: jax.random.normal(PRNGKey(seed), shape)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))


def _flat(jmodel) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(jmodel))
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX dir, port dir, the port's Comparison, {side: routing_mix's
    scores}, the port model) of one request through both CLIs."""
    mp = pytest.MonkeyPatch()
    made, scores = {}, {}
    real_wan = jwan.WanModel
    try:
        mp.setattr(jwan, "WanModel", lambda *a, **kw: made.setdefault(
            "dit", random_module(lambda: real_wan(*a, **{**kw, "rngs": nnx.Rngs(0)}), 0)))
        jprep, tprep = jwpipe.WanT2VPipeline.prepare_latents, WanT2VPipeline.prepare_latents
        mp.setattr(jwpipe.WanT2VPipeline, "prepare_latents", lambda self, *a: jnp.asarray(
            _noise(jprep(self, *a).shape)))
        mp.setattr(WanT2VPipeline, "prepare_latents", lambda self, gen, *a: torch.from_numpy(
            _noise(tuple(tprep(self, gen, *a).shape))))
        jcli = _jax_cli()

        def spy(side, fn):
            def wrapped(s, tau):
                scores.setdefault(side, np.asarray(q._host(s)))
                return fn(s, tau)
            return wrapped

        mp.setattr(jcli, "routing_mix", spy("jax", jcli.routing_mix))
        mp.setattr(bench_compare, "routing_mix", spy("port", bench_compare.routing_mix))
        jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
        jcli.main(ARGV + ["--output_dir", str(jdir)])

        def build(cfg, *, dtype, device, seed):
            model = WanModel(cfg, dtype=dtype, device=device, seed=seed)
            model.load_state_dict(from_jax.wan_state_from_jax(_flat(made["dit"]), cfg))
            made["port"] = model
            return model

        mp.setattr(bench_compare, "WanModel", build)
        mp.setattr(bench_compare, "random_embeds", lambda gen, seed, shape, device:
                   torch.from_numpy(_jax_normal(seed, shape)))
        res = bench_compare.main(ARGV + ["--output_dir", str(tdir), "--device", "cpu"])
    finally:
        mp.undo()
    return jdir, tdir, res, scores, made["port"]


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


def _keys(x):
    """The summary's structure: nested keys, lists by their items'."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(v) for v in x]
    return None


def test_summary_keys_and_latents_match_the_jax_cli(both):
    jdir, tdir, res, _, _ = both
    jsum = json.loads((jdir / "summary.json").read_text())
    tsum = json.loads((tdir / "summary.json").read_text())
    assert _keys(tsum) == _keys(jsum) and tsum == res.summary
    assert list(tsum) == list(jsum)  # and in the JAX CLI's order
    assert tsum["routing_mix"] == jsum["routing_mix"]
    assert tsum["lpips_vorta_vs_baseline"] is None and set(tsum["vbench"].values()) == {None}
    assert {k: tsum[k] for k in ("mm_routed", "stepwise")} == {"mm_routed": "bf16",
                                                               "stepwise": False}
    for arm in ARMS:
        _close(np.load(tdir / arm / "latents.npy"), np.load(jdir / arm / "latents.npy"))
        assert tsum[arm]["steps_per_dispatch"] == jsum[arm]["steps_per_dispatch"] == 4
    # the cache skipped some forwards, and the JAX CLI's cached arm agrees
    skipped = [s for *_, s in res.cache_log["vorta_cached"]]
    assert any(skipped) and not all(skipped)
    assert not np.array_equal(np.load(tdir / "vorta_cached" / "latents.npy"),
                              np.load(tdir / "vorta" / "latents.npy"))


def test_metrics_from_the_two_clis_latents_agree(both):
    jdir, tdir, res, _, _ = both
    tsum = res.summary
    jsum = json.loads((jdir / "summary.json").read_text())
    ja, ta = (np.load(d / "baseline" / "latents.npy") for d in (jdir, tdir))
    for arm, tag in (("vorta", "vorta"), ("vorta_cached", "cached")):
        jb, tb = (np.load(d / arm / "latents.npy") for d in (jdir, tdir))
        assert q.psnr(ta, tb) == pytest.approx(q.psnr(ja, jb), abs=0.05)
        assert q.ssim(ta, tb) == pytest.approx(q.ssim(ja, jb), abs=1e-3)
        assert tsum[f"psnr_{tag}_vs_baseline_db"] == round(q.psnr(ta, tb), 2)
        assert tsum[f"psnr_{tag}_vs_baseline_db"] == pytest.approx(
            jsum[f"psnr_{tag}_vs_baseline_db"], abs=0.05)
        assert tsum[f"ssim_{tag}_vs_baseline"] == pytest.approx(
            jsum[f"ssim_{tag}_vs_baseline"], abs=1e-3)
        for k, v in jsum[f"weightfree_{tag}"].items():
            assert tsum[f"weightfree_{tag}"][k] == pytest.approx(v, abs=1e-3), k
    (jrow,), (trow,) = jsum["tau_sweep"], tsum["tau_sweep"]
    assert trow["tau"] == jrow["tau"] == 0.5 and trow["mix"] == jrow["mix"]
    assert trow["psnr_db"] == pytest.approx(jrow["psnr_db"], abs=0.05)
    for k in ("ssim", "flicker_sample", "flicker_baseline", "temporal_consistency",
              "highfreq_energy_ratio"):
        assert trow[k] == pytest.approx(jrow[k], abs=1e-3), k


def test_cfg_batch_scores_match_jax(both):
    """The vorta arm's return_scores under cfg_batch: (steps, layers, 2B,
    H, 3), the batch-2 forward's, as JAX's."""
    _, _, res, scores, _ = both
    cfg = WAN_TINY
    assert scores["port"].shape == scores["jax"].shape == (4, cfg.num_layers, 2,
                                                           cfg.num_heads, 3)
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=1e-4, atol=1e-6)
    # the routing ids of the arm's two runs (4 steps x 1 forward each) count
    # the summary's mix: both are the first batch row's top-1 with tau's fallback
    ids = np.stack(res.routing["vorta"])
    assert ids.shape == (8, cfg.num_layers, cfg.num_heads)
    assert np.array_equal(ids[:4], ids[4:])
    counts = np.bincount(ids[:4].reshape(-1), minlength=3) / ids[:4].size
    assert res.summary["routing_mix"] == dict(zip(("full", "lowres", "sta"),
                                                  (round(float(c), 4) for c in counts)))


def test_return_scores_sequential_cfg_and_a_cached_step(both):
    """Sequential CFG returns the conditional forward's scores, the first B
    rows of cfg_batch's; a step the cache skips gives zeros and the
    computed steps the uncached scores; without return_scores the
    pipeline returns latents alone."""
    _, _, res, scores, model = both
    attn = bench_compare.wan_attention_config(bench_compare.parse_args(
        ARGV + ["--device", "cpu"]), (4, 4, 4))
    pipe = WanT2VPipeline(model, attn_cfg=attn)
    rng = np.random.default_rng(13)
    lat = torch.from_numpy(rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32))
    pe = torch.from_numpy(rng.standard_normal((1, 16, 32)).astype(np.float32))
    kw = dict(num_inference_steps=4, routing_mode="hard", return_scores=True)
    final, seq = pipe(lat, pe, sampling=SamplingConfig(**kw))
    assert tuple(seq.shape) == (4, 2, 1, 2, 3)
    _, batched = pipe(lat, pe, sampling=SamplingConfig(**kw, cfg_batch=True))
    torch.testing.assert_close(seq, batched[:, :, :1], rtol=1e-6, atol=1e-7)
    # the scores read only the timestep: those of the CLI's run, the same schedule
    np.testing.assert_allclose(seq.numpy(), scores["jax"][:, :, :1], rtol=1e-4, atol=1e-6)
    log = []
    cached, cscores = pipe(lat, pe, sampling=SamplingConfig(
        **kw, cache_threshold=1.0, cache_warmup=1,
        cache_coefficients=bench_compare.load_cache_poly(bench_compare.parse_args(
            ARGV + ["--device", "cpu"]))), cache_log=log)
    skipped = [s for i, arm, s in log if arm == 0]
    assert any(skipped) and not all(skipped)
    for i, s in enumerate(skipped):
        if s:
            assert not cscores[i].any()
        else:
            torch.testing.assert_close(cscores[i], seq[i], rtol=0, atol=0)
    plain = pipe(lat, pe, sampling=SamplingConfig(num_inference_steps=4, routing_mode="hard"))
    assert isinstance(plain, torch.Tensor) and torch.equal(plain, final)


def test_hunyuan_comparison_matches_the_pipeline(tmp_path):
    """hunyuan-tiny through the CLI against HunyuanT2VPipeline called
    directly on the same weights, conditioning and noise: each arm's
    latents bit for bit, the summary's metrics from them."""
    argv = ["--model", "hunyuan-tiny", "--device", "cpu", "--num_frames", "13", "--height",
            "64", "--width", "128", "--num_inference_steps", "2", "--seed", "5",
            "--output_dir", str(tmp_path)]
    res = bench_compare.main(argv)
    args = bench_compare.parse_args(argv)
    grid = HUNYUAN_GEOMETRY.tokens((13, 64, 128))
    model = HunyuanModel(HUNYUAN_TINY, dtype=torch.float32, device="cpu", seed=5)
    gen = torch.Generator()
    text = bench_compare.random_embeds(gen, 6, (1, HUNYUAN_TINY.text_len,
                                                HUNYUAN_TINY.text_dim), "cpu")
    pooled = torch.randn((1, HUNYUAN_TINY.pooled_dim), generator=gen)
    mask = torch.ones((1, HUNYUAN_TINY.text_len), dtype=torch.bool)
    pipe = HunyuanT2VPipeline(model, attn_cfg=bench_compare.hunyuan_attention_config(args, grid))
    noise = pipe.prepare_latents(gen.manual_seed(5), 1, 13, 64, 128)
    out = {}
    for arm, mode in (("baseline", "off"), ("vorta", "hard")):
        out[arm] = pipe(noise, text, mask, pooled, sampling=HunyuanSamplingConfig(
            num_inference_steps=2, guidance_scale=5.0, flow_shift=5.0, routing_mode=mode))
        assert torch.equal(res.latents[arm], out[arm]), arm
    a, b = out["baseline"].numpy(), out["vorta"].numpy()
    assert res.summary["psnr_vorta_vs_baseline_db"] == round(q.psnr(a, b), 2)
    assert res.summary["ssim_vorta_vs_baseline"] == round(q.ssim(a, b), 4)
    assert res.summary["weightfree_vorta"] == q.weightfree_video_metrics(b, a)
    assert "routing_mix" not in res.summary  # as the JAX CLI's HunyuanVideo branch
    assert len(res.routing["vorta"]) == 4 and not res.routing["baseline"]


@pytest.mark.parametrize("model", ["wan-tiny", "hunyuan-tiny"])
def test_tiny_models_refuse_cuda_naming_f32(model, capsys):
    with pytest.raises(SystemExit):
        bench_compare.parse_args(["--model", model])
    assert "A3" in capsys.readouterr().err


def test_flags_and_arm_chunks_match_the_jax_cli():
    jcli = _jax_cli()
    seen = []
    real = argparse.ArgumentParser.parse_args

    def grab(self, argv=None, namespace=None):
        seen.append({a.dest: a.default for a in self._actions})
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        for fn in (jcli.main, bench_compare.parse_args):
            with pytest.raises(SystemExit):
                fn([])
    finally:
        argparse.ArgumentParser.parse_args = real
    jflags, tflags = seen
    assert set(tflags) - set(jflags) == {"device"} and set(jflags) <= set(tflags)
    assert {k: v for k, v in tflags.items() if k != "device"} == jflags
    for spd in ("1", "2", "2,8,8", "2,4"):
        ns = argparse.Namespace(steps_per_dispatch=spd)
        for arm in ARMS + ("tau",):
            assert bench_compare._arm_chunk(ns, arm) == jcli._arm_chunk(ns, arm)
