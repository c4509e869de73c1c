"""``cli.sample --prompt ... --decode`` end to end against the JAX CLI, on the CPU.

Both CLIs run the same request: a prompt tokenized by a toy BPE tokenizer
trained in the test (as tests/test_text_pipeline.py does), the tiny DiT
with the tiny text encoders the JAX CLI sizes for it, denoising, and the
VAE (the full Wan 2.1 VAE for ``wan-tiny``, as the JAX CLI has it; the tiny
HunyuanVAE in blended tiles for ``hunyuan-tiny``).  The JAX CLI
(``cli/sample.py``, loaded from its file) builds every module with random
weights from numpy (port_assets/random_jax.py, in place of Flax's
initialisers); the port's CLI takes each module's weights from the JAX
module it mirrors (io/from_jax.py), and both start from the same numpy
noise.  The float frames each CLI hands to ``save_video`` are compared;
the written files too.

Tolerance: f32 on both sides, max |port - JAX| <= 1e-4 * max(max |JAX|, 1)
on the frames (the two sum in different orders).  The GIF files quantize
to a 256-colour palette, so one frame value that rounds the other way can
move a pixel's palette entry: their decoded frames must agree to a mean
of 1 level in 255.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vorta_tpu.io.video as jvideo
import vorta_tpu.models.hunyuan as jhunyuan
import vorta_tpu.models.hunyuan_vae as jhv
import vorta_tpu.models.text_encoders as jte
import vorta_tpu.models.umt5 as jumt5
import vorta_tpu.models.wan as jwan
import vorta_tpu.models.wan_vae as jwv
import vorta_tpu.pipelines.hunyuan_t2v as jhpipe
import vorta_tpu.pipelines.wan_t2v as jwpipe
from port_assets.random_jax import random_module
from vorta_tpu_torch.cli import sample
from vorta_tpu_torch.io import from_jax, video
from vorta_tpu_torch.pipelines.hunyuan_t2v import HunyuanT2VPipeline
from vorta_tpu_torch.pipelines.wan_t2v import WanT2VPipeline


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy_tokenizer(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(vocab_size=100, special_tokens=["<pad>", "<unk>", "</s>"])
    tok.train_from_iterator([
        "a cat walking on grass",
        "a dog running through a sunny field of flowers",
        "cinematic shot of a city at night",
    ], trainer)
    d = tmp_path_factory.mktemp("tok")
    tok.save(str(d / "tokenizer.json"))
    return d


def _jax_cli():
    path = Path(__file__).resolve().parents[1] / "cli" / "sample.py"
    spec = importlib.util.spec_from_file_location("_jax_cli_sample", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _noise(shape):
    return np.random.default_rng(11).standard_normal(shape).astype(np.float32)


# per role, the JAX module and the class the JAX CLI builds (the port CLI's
# name for its namesake is the same)
ROLES = {
    "wan": {"dit": (jwan, "WanModel"), "text": (jumt5, "UMT5Encoder"), "vae": (jwv, "WanVAE")},
    "hunyuan": {"dit": (jhunyuan, "HunyuanModel"), "text": (jte, "LlamaTextEncoder"),
                "clip": (jte, "CLIPTextEncoder"), "vae": (jhv, "HunyuanVAE")},
}


def _flat(jmodel) -> dict:
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(jmodel))
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


def _run_both(family, argv, monkeypatch):
    """(JAX frames, port frames, the JAX CLI's file, the port's result) of
    one request through both CLIs."""
    made, frames = {}, {}
    for seed, (role, (module, name)) in enumerate(ROLES[family].items()):
        cls = getattr(module, name)

        def make(*args, _cls=cls, _role=role, _seed=seed, **kw):
            made[_role] = random_module(lambda: _cls(*args, **{**kw, "rngs": nnx.Rngs(0)}),
                                        _seed)
            return made[_role]

        monkeypatch.setattr(module, name, make)
    jpipe, tpipe = ((jwpipe.WanT2VPipeline, WanT2VPipeline) if family == "wan"
                    else (jhpipe.HunyuanT2VPipeline, HunyuanT2VPipeline))
    jprep, tprep = jpipe.prepare_latents, tpipe.prepare_latents
    monkeypatch.setattr(jpipe, "prepare_latents", lambda self, *a: jnp.asarray(
        _noise(jprep(self, *a).shape)))
    monkeypatch.setattr(tpipe, "prepare_latents", lambda self, gen, *a: torch.from_numpy(
        _noise(tuple(tprep(self, gen, *a).shape))))

    def spy(key, save):
        def wrapped(arr, path, *a):
            frames[key] = np.array(arr)
            return save(arr, path, *a)
        return wrapped

    monkeypatch.setattr(jvideo, "save_video", spy("jax", jvideo.save_video))
    monkeypatch.setattr(sample, "save_video", spy("port", video.save_video))
    out = Path(argv[argv.index("--output") + 1])
    jout = out.with_name("jax_" + out.name)
    _jax_cli().main(argv[:argv.index("--output")] + ["--output", str(jout)])

    def port(role, model_cls, cfg_state=None):
        def build(cfg, *, dtype, device, seed):
            tmodel = model_cls(cfg, dtype=dtype, device=device, seed=seed)
            flat = _flat(made[role])
            state = (cfg_state(flat, cfg) if cfg_state
                     else from_jax.module_state_from_jax(flat, tmodel))
            tmodel.load_state_dict(state)
            return tmodel
        return build

    dit_state = from_jax.wan_state_from_jax if family == "wan" else from_jax.hunyuan_state_from_jax
    for role, (_, name) in ROLES[family].items():
        monkeypatch.setattr(sample, name, port(role, getattr(sample, name),
                                               dit_state if role == "dit" else None))
    res = sample.main(argv + ["--device", "cpu"])
    return frames["jax"], frames["port"], jout, res


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


def test_wan_prompt_to_gif_matches_the_jax_cli(toy_tokenizer, tmp_path, monkeypatch, capsys):
    """wan-tiny: UMT5 (tiny), 5 frames at 32 x 32, the full Wan VAE, a GIF."""
    argv = ["--model", "wan-tiny", "--dtype", "fp32", "--prompt", "a cat walking on grass",
            "--tokenizer_dir", str(toy_tokenizer), "--native_attention", "--num_frames", "5",
            "--height", "32", "--width", "32", "--num_inference_steps", "1", "--decode",
            "--output", str(tmp_path / "cat.gif")]
    jframes, tframes, jout, res = _run_both("wan", argv, monkeypatch)
    assert tframes.shape == (5, 32, 32, 3)
    _close(tframes, jframes)
    assert res.video == tmp_path / "cat.gif" and res.encode_s > 0 and res.decode_s > 0
    got, want = video.load_video(res.video), video.load_video(jout)
    assert got.shape == want.shape == (5, 32, 32, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).mean() <= 1.0
    printed = capsys.readouterr().out
    assert "WARNING: encoding with random UMT5 weights" in printed


def test_hunyuan_prompt_to_tiled_video_matches_the_jax_cli(toy_tokenizer, tmp_path,
                                                           monkeypatch):
    """hunyuan-tiny: Llama + CLIP (tiny), 13 frames at 96 x 320 (latent
    (4, 12, 40): two tiles of 32 latent columns), ``--vae_tiling``, the
    frames as .npy."""
    argv = ["--model", "hunyuan-tiny", "--dtype", "fp32", "--prompt", "a dog running",
            "--tokenizer_dir", str(toy_tokenizer), "--native_attention", "--num_frames", "13",
            "--height", "96", "--width", "320", "--num_inference_steps", "1", "--decode",
            "--vae_tiling", "--output", str(tmp_path / "dog.npy")]
    jframes, tframes, jout, res = _run_both("hunyuan", argv, monkeypatch)
    assert tframes.shape == (13, 96, 320, 3)
    _close(tframes, jframes)
    np.testing.assert_array_equal(np.load(res.video), tframes)
    _close(np.load(res.video), np.load(jout))


def test_cli_takes_the_jax_clis_flags():
    args = sample.parse_args([
        "--prompt", "p", "--tokenizer_dir", "t", "--text_encoder_checkpoint", "u",
        "--clip_tokenizer_dir", "c", "--clip_checkpoint", "k", "--decode", "--vae_tiling",
        "--vae_checkpoint", "v"])
    assert (args.prompt, args.tokenizer_dir, args.text_encoder_checkpoint,
            args.clip_tokenizer_dir, args.clip_checkpoint, args.vae_checkpoint) == \
        ("p", "t", "u", "c", "k", "v")
    assert args.decode and args.vae_tiling
    with pytest.raises(SystemExit, match="--prompt with --tokenizer_dir"):
        sample.main(["--model", "wan-tiny", "--device", "cpu", "--prompt", "p",
                     "--num_frames", "5", "--height", "32", "--width", "32"])
