"""The port's VAEs, tiled decode, their checkpoint maps and video I/O
against the JAX package, on the CPU.

WAN_VAE_TINY and HUNYUAN_VAE_TINY are built by the JAX package, with random
weights from a seed (port_assets/random_jax.py), and carried into the port
through io/from_jax.py; the same numpy latents
and videos go to both.  The port runs every convolution over chunks of
frames (models/wan_vae.py ``conv3d_frames``): at a budget forced down to a
few hundred elements the chunked decode and encode must equal the
unchunked ones, HunyuanVAE's GroupNorm keeping whole-clip statistics.  The
importer maps take the synthetic diffusers state dicts of the JAX package's
own importer test (tests/test_vae_import.py builds them from the config)
through both maps.

Tolerance: f32 on both sides, max |port - JAX| <= 1e-4 * max(max |JAX|, 1);
chunked against unchunked 1e-5 on the same scale (the same arithmetic in
other call shapes); exact where both only copy, place or count.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from port_assets.random_jax import random_module
from vorta_tpu.io import torch_import as jimport
from vorta_tpu.io import video as jvideo
from vorta_tpu.models import hunyuan_vae as jhv
from vorta_tpu.models import vae_tiling as jtiling
from vorta_tpu.models import wan_vae as jwv
from vorta_tpu_torch.io import torch_import, video
from vorta_tpu_torch.io.from_jax import module_state_from_jax
from vorta_tpu_torch.models import hunyuan_vae as hv
from vorta_tpu_torch.models import vae_tiling
from vorta_tpu_torch.models import wan_vae as wv


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-4):
    """max |got - want| <= rel * max(max |want|, 1), shapes equal."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1.0)


def _flat(jmodel) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(jmodel))
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


VAES = {  # name: (JAX class, port class, JAX config, port config)
    "wan": (jwv.WanVAE, wv.WanVAE, jwv.WAN_VAE_TINY, wv.WAN_VAE_TINY),
    "hunyuan": (jhv.HunyuanVAE, hv.HunyuanVAE, jhv.HUNYUAN_VAE_TINY, hv.HUNYUAN_VAE_TINY),
}


@pytest.fixture(scope="module")
def vaes():
    out = {}
    for name, (jcls, tcls, jcfg, tcfg) in VAES.items():
        jmodel = random_module(lambda: jcls(jcfg, rngs=nnx.Rngs(0)))
        tmodel = tcls(tcfg, device="cpu")
        tmodel.load_state_dict(module_state_from_jax(_flat(jmodel), tmodel))
        out[name] = (jmodel, tmodel.requires_grad_(False))
    return out


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


Z = (1, 3, 4, 6, 16)  # latents: 9 frames of 32 x 48 pixels
VIDEO = (1, 9, 16, 24, 3)


@pytest.mark.parametrize("name", sorted(VAES))
def test_decode_matches_jax(vaes, name):
    """Denormalise + decode: (1, 4(T-1)+1, 8H, 8W, 3)."""
    jmodel, tmodel = vaes[name]
    z = _randn(0, Z)
    got = tmodel.decode(torch.from_numpy(z))
    assert got.shape == (1, 9, 32, 48, 3)
    _close(got, jmodel.decode(jnp.asarray(z)))
    _close(tmodel.denormalize_latents(torch.from_numpy(z)),
           jmodel.denormalize_latents(jnp.asarray(z)), rel=1e-6)


@pytest.mark.parametrize("name", sorted(VAES))
def test_encode_matches_jax(vaes, name):
    jmodel, tmodel = vaes[name]
    v = _randn(1, VIDEO)
    mean, logvar = tmodel.encode(torch.from_numpy(v))
    jmean, jlogvar = jmodel.encode(jnp.asarray(v))
    assert mean.shape == (1, 3, 2, 3, 16)
    _close(mean, jmean)
    _close(logvar, jlogvar)


@pytest.mark.parametrize("name", sorted(VAES))
def test_chunked_equals_unchunked(vaes, name):
    """A budget of 700 elements forces one- and two-frame chunks (every
    causal halo, the strided time convs, HunyuanVAE's summed statistics and
    the frame-chunked attention) against one call over the whole clip."""
    _, tmodel = vaes[name]
    z, v = torch.from_numpy(_randn(2, Z)), torch.from_numpy(_randn(3, VIDEO))
    with wv.chunk_budget(1 << 62):
        whole, (wmean, _) = tmodel.decode(z), tmodel.encode(v)
    with wv.chunk_budget(700):
        _close(tmodel.decode(z), whole.numpy(), rel=1e-5)
        _close(tmodel.encode(v)[0], wmean.numpy(), rel=1e-5)
    assert wv.CHUNK_ELEMENTS == 1 << 29  # restored


def test_conv_chunks_stay_under_the_budget(monkeypatch):
    """No conv call sees an input or an output over the budget (a frame
    larger than the budget goes alone)."""
    seen = []
    real = torch.nn.functional.conv3d

    def spy(x, w, *args):
        y = real(x, w, *args)
        seen.append((x.numel(), y.numel()))
        return y

    monkeypatch.setattr(wv.F, "conv3d", spy)
    conv = wv.CausalConv3d(4, 6, dtype=torch.float32, device="cpu")
    x = torch.randn(1, 4, 11, 5, 7)
    with wv.chunk_budget(1 << 62):
        want = conv(x)
    seen.clear()
    with wv.chunk_budget(600):  # 140 (+ pads 252) elements a frame in, 210 out
        got = conv(x)
    assert len(seen) > 3 and max(max(s) for s in seen) <= 600
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_wan_decode_is_causal(vaes):
    """Convs pad only the past and Wan's norms are per voxel: a change to
    latent frame 2 leaves pixel frames 0-4 (those before 4 * 2 - 3) exactly
    as they were, and moves frame 5."""
    _, tmodel = vaes["wan"]
    z = torch.from_numpy(_randn(4, Z))
    z2 = z.clone()
    z2[:, 2] += 1.0
    with wv.chunk_budget(700):
        a, b = tmodel.decode(z), tmodel.decode(z2)
    assert torch.equal(a[:, :5], b[:, :5])
    assert not torch.allclose(a[:, 5], b[:, 5])


def test_hunyuan_groupnorm_spans_the_clip(vaes):
    """HunyuanVAE's GroupNorm statistics span T (as JAX's ``nnx.GroupNorm``):
    a late change moves early frames too, but far less than late ones."""
    _, tmodel = vaes["hunyuan"]
    z = _randn(5, (1, 4, 4, 4, 16))
    z2 = z.copy()
    z2[:, -1] += 1.0
    with wv.chunk_budget(700):
        a = tmodel.decode(torch.from_numpy(z)).numpy()
        b = tmodel.decode(torch.from_numpy(z2)).numpy()
    early, late = np.abs(a[:, :5] - b[:, :5]).mean(), np.abs(a[:, -4:] - b[:, -4:]).mean()
    assert 0 < early and late > 5 * early


def test_tiling_layout_matches_jax():
    for total, tile, overlap in ((10, 4, 1), (45, 16, 4), (20, 32, 8), (160, 32, 8)):
        assert vae_tiling._starts(total, tile, overlap) == jtiling._starts(total, tile, overlap)
    np.testing.assert_array_equal(vae_tiling._ramp(32), jtiling._ramp(32))
    assert (vae_tiling.SPATIAL, vae_tiling.TEMPORAL) == (jtiling.SPATIAL, jtiling.TEMPORAL)


@pytest.mark.parametrize("name", sorted(VAES))
def test_tiled_decode_matches_jax(vaes, name):
    """A (1, 6, 10, 12) latent in tiles of (3, 6, 6) overlapping (1, 2, 2):
    2 x 2 x 3 tiles, every seam blended on both sides."""
    jmodel, tmodel = vaes[name]
    z = _randn(6, (1, 6, 10, 12, 16))
    kw = dict(tile_latent=(3, 6, 6), overlap_latent=(1, 2, 2))
    got = vae_tiling.tiled_decode(lambda zz: tmodel.decode(zz, denormalize=False),
                                  torch.from_numpy(z), **kw)
    want = jtiling.tiled_decode(lambda zz: jmodel.decode(zz, denormalize=False),
                                jnp.asarray(z), **kw)
    assert got.shape == (1, 21, 80, 96, 3) and got.dtype == torch.float32
    _close(got, want)


def test_tiled_decode_places_and_blends_as_jax():
    """A local stand-in decoder (nearest x8 / the causal x4 frames): tiled
    and whole-clip agree, and the port's blend is JAX's to f32 rounding."""
    def local(z):
        px = z.mean(dim=-1, keepdim=True).expand(*z.shape[:-1], 3)
        px = px.repeat_interleave(8, dim=2).repeat_interleave(8, dim=3)
        return px.repeat_interleave(4, dim=1)[:, 3:]

    def jlocal(z):
        px = jnp.mean(z, axis=-1, keepdims=True) * jnp.ones((1, 1, 1, 1, 3))
        px = jnp.repeat(jnp.repeat(px, 8, axis=2), 8, axis=3)
        return jnp.repeat(px, 4, axis=1)[:, 3:]

    z = _randn(7, (1, 7, 9, 11, 4))
    kw = dict(tile_latent=(3, 4, 5), overlap_latent=(1, 2, 2))
    got = vae_tiling.tiled_decode(local, torch.from_numpy(z), **kw)
    _close(got, local(torch.from_numpy(z)).numpy(), rel=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtiling.tiled_decode(
        jlocal, jnp.asarray(z), **kw)), rtol=1e-6, atol=1e-6)


def test_tiled_decode_single_tile_is_the_whole_decode(vaes):
    _, tmodel = vaes["hunyuan"]
    z = torch.from_numpy(_randn(8, (1, 2, 4, 4, 16)))
    whole = tmodel.decode(z, denormalize=False)
    assert torch.equal(vae_tiling.tiled_decode(
        lambda zz: tmodel.decode(zz, denormalize=False), z), whole)


def test_pipeline_decode(vaes):
    """HunyuanT2VPipeline.decode: the VAE's, whole or tiled; without a VAE
    it raises, as JAX's does."""
    from vorta_tpu_torch.pipelines.hunyuan_t2v import HunyuanT2VPipeline

    _, tmodel = vaes["hunyuan"]
    z = torch.from_numpy(_randn(9, (1, 3, 6, 8, 16)))
    pipe = HunyuanT2VPipeline(model=None, vae=tmodel)
    assert torch.equal(pipe.decode(z), tmodel.decode(z))
    kw = dict(tile_latent=(2, 4, 4), overlap_latent=(1, 2, 2))
    want = vae_tiling.tiled_decode(lambda zz: tmodel.decode(zz, denormalize=False),
                                   tmodel.denormalize_latents(z), **kw)
    assert torch.equal(pipe.decode(z, tiled=True, **kw), want)
    with pytest.raises(ValueError):
        HunyuanT2VPipeline(model=None).decode(z)


# --- the importer maps ----------------------------------------------------------------


def _jax_vae_sd_builders():
    """The synthetic diffusers state dicts of the JAX package's importer test."""
    path = Path(__file__).with_name("test_vae_import.py")
    spec = importlib.util.spec_from_file_location("_jax_vae_import_sd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {"wan": (mod.build_wan_vae_sd, jimport.wan_vae_state_dict_to_tree,
                    torch_import.load_wan_vae_torch_weights),
            "hunyuan": (mod.build_hunyuan_vae_sd, jimport.hunyuan_vae_state_dict_to_tree,
                        torch_import.load_hunyuan_vae_torch_weights)}


@pytest.mark.parametrize("name", sorted(VAES))
def test_vae_importer_matches_jax(name, tmp_path):
    """One diffusers-style state dict (.pt) through both maps: every port
    parameter set, equal to the JAX VAE's after its import; a key the model
    lacks raises."""
    build, jmap, load = _jax_vae_sd_builders()[name]
    jcls, tcls, jcfg, tcfg = VAES[name]
    sd = build(jcfg)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "vae.pt")
    jmodel = random_module(lambda: jcls(jcfg, rngs=nnx.Rngs(0)))
    _, state = nnx.split(jmodel)
    _, jmissing = jimport._apply_tree(state, jmap(sd, jcfg))
    nnx.update(jmodel, state)
    tmodel = tcls(tcfg, device="cpu", seed=5)
    applied, missing = load(tmodel, tmp_path / "vae.pt")
    assert not jmissing and not missing
    assert sorted(applied) == sorted(tmodel.state_dict())
    want = module_state_from_jax(_flat(jmodel), tmodel)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, want[k]), k
    # another layout (a shortcut conv where the model's block has none) raises, as in JAX
    short = {"decoder.mid_block.resnets.0.conv_shortcut.weight": torch.zeros(1),
             "decoder.mid_block.resnets.0.conv_shortcut.bias": torch.zeros(1)}
    torch.save({**{k: torch.from_numpy(v) for k, v in sd.items()}, **short}, tmp_path / "x.pt")
    with pytest.raises(ValueError, match="did not match"):
        load(tmodel, tmp_path / "x.pt")


# --- video I/O --------------------------------------------------------------------------


def test_video_roundtrips_match_jax(tmp_path):
    """.npy exact; .gif frames as JAX writes them (same uint8 in, same file
    out); .mp4 falls back to a .gif beside it where imageio has no ffmpeg,
    as JAX's does; an image directory loads sorted."""
    frames = np.tanh(_randn(10, (5, 16, 24, 3)))
    np.testing.assert_array_equal(video.to_uint8(frames), jvideo.to_uint8(frames))
    u8 = video.to_uint8(frames)
    assert video.to_uint8(u8) is u8
    for suffix in (".npy", ".gif", ".mp4"):
        got = video.save_video(frames, tmp_path / f"port{suffix}")
        want = jvideo.save_video(frames, tmp_path / f"jax{suffix}")
        assert got.suffix == want.suffix
        assert got.read_bytes() == want.read_bytes()
        loaded = video.load_video(got)
        np.testing.assert_array_equal(loaded, jvideo.load_video(want))
        assert loaded.shape == (5, 16, 24, 3)
    np.testing.assert_array_equal(video.load_video(tmp_path / "port.npy"), frames)
    from PIL import Image

    (tmp_path / "frames").mkdir()
    for i in (1, 0):
        Image.fromarray(u8[i]).save(tmp_path / "frames" / f"{i:03d}.png")
    np.testing.assert_array_equal(video.load_video(tmp_path / "frames"), u8[:2])
    with pytest.raises(ValueError):
        video.save_video(frames, tmp_path / "x.avi")
    for prompt in ("A cat, walking on grass!", "", "x" * 100):
        assert video.prompt_to_file_name(prompt) == jvideo.prompt_to_file_name(prompt)
