"""``cli.sample``'s batch and CFG flags against the JAX CLI, and the exporter
of the JAX trainer's router checkpoints, on the CPU.

Batch sampling: one request through both CLIs at ``wan-tiny`` (5 frames at
32 x 32, routing off, 2 UniPC steps): ``--prompt_embeds_dir`` over three
files (a short .npy, a long .pt, and one whose output is already there),
``--skip_existing``, ``--negative_prompt_embeds`` from a .pt and
``--cfg_batch``.  The JAX CLI (``cli/sample.py``, loaded from its file)
builds its DiT from numpy draws (port_assets/random_jax.py), the port's
takes those weights through io/from_jax.py, and both start from the same
numpy noise.  The file names written and the latents are compared: f32 on
both sides, max |port - JAX| <= 1e-4 * max(max |JAX|, 1), as the other CLI
parity tests; the existing output is left as it was.

The exporter (port_assets/export_jax_router.py): the JAX package's
``save_router_checkpoint`` (orbax) writes a ``wan-tiny`` and a
``hunyuan-tiny`` router step dir, as the JAX trainer does (bf16 routers,
with ``args.json`` and ``config.json`` beside), the exporter turns each into
a port step dir, and every router tensor equals JAX's bit for bit in f32;
``cli.sample --resume_dir --router_checkpoint`` serves the Wan one routed
hard, its model holding those routers.
"""

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
from port_assets import export_jax_router
from port_assets.random_jax import random_module
from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.io.checkpoint import save_router_checkpoint as jax_save_router_checkpoint
from vorta_tpu_torch.cli import sample
from vorta_tpu_torch.io import from_jax
from vorta_tpu_torch.io.checkpoint import load_router_checkpoint
from vorta_tpu_torch.pipelines.wan_t2v import WanT2VPipeline

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


def _jax_cli():
    spec = importlib.util.spec_from_file_location("_jax_cli_sample_batch",
                                                  REPO / "cli" / "sample.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _noise(shape):
    return np.random.default_rng(11).standard_normal(shape).astype(np.float32)


def _flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


def test_batch_flags_match_the_jax_cli(tmp_path, monkeypatch):
    rng = np.random.default_rng(21)
    src = tmp_path / "embeds"
    src.mkdir()
    np.save(src / "a_short.npy", rng.standard_normal((10, 32)).astype(np.float32))  # padded
    torch.save(torch.from_numpy(rng.standard_normal((1, 20, 32)).astype(np.float32)),
               src / "b_long.pt")  # cut to text_len 16
    np.save(src / "c_done.npy", rng.standard_normal((16, 32)).astype(np.float32))
    (src / "notes.txt").write_text("not an embedding")
    neg = tmp_path / "neg.pt"
    torch.save(torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)), neg)
    outs = {}
    for side in ("jax", "port"):
        outs[side] = tmp_path / f"out_{side}"
        outs[side].mkdir()
        np.save(outs[side] / "c_done.npy", np.full((2,), 7.0, np.float32))  # already there
    argv = ["--model", "wan-tiny", "--dtype", "fp32", "--native_attention", "--num_frames", "5",
            "--height", "32", "--width", "32", "--num_inference_steps", "2",
            "--prompt_embeds_dir", str(src), "--skip_existing",
            "--negative_prompt_embeds", str(neg), "--cfg_batch"]

    made = {}
    real = jwan.WanModel
    monkeypatch.setattr(jwan, "WanModel", lambda *a, **kw: made.setdefault(
        "dit", random_module(lambda: real(*a, **{**kw, "rngs": nnx.Rngs(0)}), 0)))
    jprep, tprep = jwpipe.WanT2VPipeline.prepare_latents, WanT2VPipeline.prepare_latents
    monkeypatch.setattr(jwpipe.WanT2VPipeline, "prepare_latents", lambda self, *a: jnp.asarray(
        _noise(jprep(self, *a).shape)))
    monkeypatch.setattr(WanT2VPipeline, "prepare_latents", lambda self, gen, *a: torch.from_numpy(
        _noise(tuple(tprep(self, gen, *a).shape))))
    _jax_cli().main(argv + ["--output", str(outs["jax"])])

    port_wan = sample.WanModel

    def build(cfg, *, dtype, device, seed):
        model = port_wan(cfg, dtype=dtype, device=device, seed=seed)
        model.load_state_dict(from_jax.wan_state_from_jax(_flat(nnx.state(made["dit"])), cfg))
        return model

    monkeypatch.setattr(sample, "WanModel", build)
    res = sample.main(argv + ["--output", str(outs["port"]), "--device", "cpu"])
    assert isinstance(res, list) and len(res) == 2
    names = {side: sorted(p.name for p in outs[side].iterdir()) for side in outs}
    assert names["port"] == names["jax"] == ["a_short.npy", "b_long.npy", "c_done.npy"]
    for name in ("a_short.npy", "b_long.npy"):
        _close(np.load(outs["port"] / name), np.load(outs["jax"] / name))
    for r, name in zip(res, ("a_short.npy", "b_long.npy")):
        assert np.array_equal(r.latents.numpy(), np.load(outs["port"] / name))
    np.testing.assert_array_equal(np.load(outs["port"] / "c_done.npy"), np.full((2,), 7.0))
    # the two prompts differ, and the negative states took part
    assert not np.allclose(np.load(outs["port"] / "a_short.npy"),
                           np.load(outs["port"] / "b_long.npy"))


def test_load_embeds_reads_npy_and_pt_alike(tmp_path):
    from vorta_tpu_torch.config import WAN_TINY

    arr = np.random.default_rng(22).standard_normal((1, 12, 32)).astype(np.float32)
    np.save(tmp_path / "x.npy", arr)
    torch.save(torch.from_numpy(arr[0]).bfloat16(), tmp_path / "x.pt")
    got_npy = sample.load_embeds(tmp_path / "x.npy", WAN_TINY)
    got_pt = sample.load_embeds(tmp_path / "x.pt", WAN_TINY)
    assert got_npy.shape == got_pt.shape == (1, 16, 32) and not got_npy[:, 12:].any()
    np.testing.assert_array_equal(got_pt[:, :12],
                                  torch.from_numpy(arr[0]).bfloat16().float()[None].numpy())
    assert sample.load_image_embeds(tmp_path / "x.pt").shape == (1, 12, 32)
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no .npy/.pt embeds"):
        sample.embeds_files(tmp_path / "empty")


def _jax_run(tmp_path, model: str, attn: JaxAttentionConfig):
    """A JAX trainer's run dir: bf16 routers of the model drawn from numpy,
    saved by the JAX package's writer as step 3, with args.json and
    config.json; (step dir, {keystr: f32 array} of the routers)."""
    run = tmp_path / f"jax_{model}"
    template = export_jax_router.router_template(model)
    rng = np.random.default_rng(23)
    routers = jax.tree.map(lambda z: jnp.asarray(
        rng.standard_normal(z.shape).astype(np.float32)).astype(z.dtype), template)
    step = jax_save_router_checkpoint(run / "ckpt", 3, routers)
    (run / "args.json").write_text(json.dumps({"model": model, "dtype": "bf16"}))
    attn.save(run / "config.json")
    return step, {k: v.astype(np.float32) for k, v in _flat(routers).items()}


@pytest.mark.parametrize("model", ["wan-tiny", "hunyuan-tiny"])
def test_exported_router_checkpoint_equals_jax(model, tmp_path, monkeypatch):
    attn = JaxAttentionConfig(latent_shape=(4, 4, 4), sta_window=(3, 3, 1), sta_tile=(2, 2, 2),
                              lowres_window=(2, 2, 2), block_q=16, block_kv=16,
                              sta_block_q=8, sta_block_kv=8)
    step, want = _jax_run(tmp_path, model, attn)
    out = tmp_path / "port"
    path = export_jax_router.main([str(step), "--out", str(out)])
    assert path == (out / "ckpt" / "step-000003").absolute()
    assert json.loads((out / "config.json").read_text()) == json.loads(attn.to_json())
    state, opt = load_router_checkpoint(path)
    assert opt is None and all(t.dtype == torch.float32 for t in state.values())
    got = from_jax.router_state_to_jax(state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if model != "wan-tiny":
        return
    served = {}
    real_apply = sample.apply_router_state

    def spy(m, st):
        real_apply(m, st)
        served["model"] = m

    monkeypatch.setattr(sample, "apply_router_state", spy)
    res = sample.main(["--model", "wan-tiny", "--dtype", "fp32", "--device", "cpu",
                       "--random_embeds", "--num_frames", "13", "--height", "64", "--width",
                       "64", "--num_inference_steps", "1", "--resume_dir", str(out),
                       "--router_checkpoint", str(path), "--output", str(tmp_path / "x.npy")])
    params = {n: p for n, p in served["model"].named_parameters() if "router" in n.split(".")}
    assert set(params) == set(state)
    assert all(torch.equal(params[n], state[n]) for n in state)
    assert len(res.routing) == 2 and np.isfinite(res.latents.numpy()).all()
