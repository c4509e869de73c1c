"""The port's diffusers / reference checkpoint importer (io/torch_import.py)
and the quantized checkpoint path (io/quant_serving.py) against the JAX
package's, on the CPU.

Synthetic state dicts carry diffusers' key names and shapes
(``wan_expected_shapes`` / ``hunyuan_expected_shapes``, themselves held to
the JAX package's key set), with values from numpy seeds.  The maps are
held bit for bit: the port's state equals the JAX importer's tree carried
into the port by io/from_jax.py.  Forwards of the two imported models run
in f32 (JAX's Pallas kernels in interpret mode), rtol 1e-4 and atol 1e-4 x
the output's scale, as the port's other model tests; quantized stacks
leaf for leaf (int codes and scales equal).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vorta_tpu.config import AttentionConfig as JaxAttentionConfig
from vorta_tpu.config import WanModelConfig as JaxWanModelConfig
from vorta_tpu.io import quant_serving as jqs
from vorta_tpu.io import torch_import as jti
from vorta_tpu.models import hunyuan as jhunyuan
from vorta_tpu.models.wan import WanModel as JaxWanModel
from vorta_tpu.ops import quant as jquant
from vorta_tpu_torch.config import AttentionConfig, WanModelConfig
from vorta_tpu_torch.io import quant_serving as qs
from vorta_tpu_torch.io import torch_import as ti
from vorta_tpu_torch.io.from_jax import hunyuan_state_from_jax, wan_state_from_jax
from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY, HunyuanModel
from vorta_tpu_torch.models.wan import WanModel


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(dim=128, ffn_dim=256, num_heads=2, head_dim=64, num_layers=2, text_dim=32,
           text_len=16, freq_dim=32)
IMAGE_DIM = 48  # stands in for CLIP's 1280
ATTN = dict(latent_shape=(4, 4, 4), block_q=16, block_kv=16)


def _close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


def _flat(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


def _random_sd(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(sh) * 0.05).astype(np.float32))
            for k, sh in shapes.items()}


def _jax_wan(cfg: dict, sd: dict):
    """A JAX WanModel loaded by the JAX importer from ``sd``."""
    jmodel = JaxWanModel(JaxWanModelConfig(**cfg), dtype=jnp.float32, rngs=nnx.Rngs(0))
    _, state = nnx.split(jmodel)
    tree = jti.wan_state_dict_to_tree({k: v.numpy() for k, v in sd.items()},
                                      cfg["num_layers"], cfg["head_dim"])
    applied, missing = jti._apply_tree(state, tree)
    nnx.update(jmodel, state)
    return jmodel, applied, missing


@pytest.fixture(scope="module", params=["t2v", "i2v"])
def wan(request):
    cfg = dict(CFG, image_dim=IMAGE_DIM if request.param == "i2v" else None)
    sd = _random_sd(ti.wan_expected_shapes(WanModelConfig(**cfg), routers=True), 0)
    jmodel, _, missing = _jax_wan(cfg, sd)
    assert missing == []
    return cfg, sd, jmodel


def test_wan_map_matches_jax_bit_for_bit(wan):
    """T2V and I2V: the port's map is the JAX importer's tree after from_jax
    (fusions, half-RoPE rows and gains, names), every parameter."""
    cfg, sd, jmodel = wan
    port_cfg = WanModelConfig(**cfg)
    want = wan_state_from_jax(_flat(nnx.state(jmodel)), port_cfg)
    got = ti.wan_state_dict_to_tree(sd, cfg["num_layers"], cfg["head_dim"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k
    model = WanModel(port_cfg, device="cpu")
    applied, missing = ti.apply_state(model, got)
    assert missing == [] and sorted(applied) == sorted(model.state_dict())


def test_wan_forward_matches_jax(wan):
    """The imported models' forwards, routing off (I2V: with 257 image
    tokens through the image branch)."""
    cfg, sd, jmodel = wan
    model = WanModel(WanModelConfig(**cfg), device="cpu")
    ti.apply_state(model, ti.wan_state_dict_to_tree(sd, cfg["num_layers"], cfg["head_dim"]))
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32)
    ctx = rng.standard_normal((1, cfg["text_len"], cfg["text_dim"])).astype(np.float32)
    img = (rng.standard_normal((1, 257, IMAGE_DIM)).astype(np.float32)
           if cfg["image_dim"] else None)
    t = np.asarray([600.0], np.float32)
    want = jmodel(jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx),
                  attn_cfg=JaxAttentionConfig(**ATTN), interpret=True,
                  image_context=None if img is None else jnp.asarray(img)).sample
    with torch.no_grad():
        got = model(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                    attn_cfg=AttentionConfig(**ATTN),
                    image_context=None if img is None else torch.from_numpy(img)).sample
    _close(got, want)


def test_load_state_dict_shards_pt_and_errors(tmp_path):
    """Two safetensors shards in a directory, one .pt, a .bin directory and a
    saved module load the same tensors, dtypes kept; a T2V model reports an
    I2V checkpoint's image branch as missing; a wrong shape raises."""
    from safetensors.torch import save_file

    cfg = WanModelConfig(**CFG, image_dim=IMAGE_DIM)
    sd = _random_sd(ti.wan_expected_shapes(cfg, routers=True), 2)
    sd = {k: (v.bfloat16() if i % 2 else v) for i, (k, v) in enumerate(sd.items())}
    keys = sorted(sd)
    shards = tmp_path / "shards"
    shards.mkdir()
    save_file({k: sd[k] for k in keys[::2]},
              str(shards / "diffusion_pytorch_model-00001-of-00002.safetensors"))
    save_file({k: sd[k] for k in keys[1::2]},
              str(shards / "diffusion_pytorch_model-00002-of-00002.safetensors"))
    torch.save(sd, tmp_path / "w.pt")
    (tmp_path / "bins").mkdir()
    torch.save(sd, tmp_path / "bins" / "pytorch_model.bin")
    for src in (shards, tmp_path / "w.pt", tmp_path / "bins"):
        got = ti.load_state_dict(src)
        assert sorted(got) == keys
        assert all(got[k].dtype == sd[k].dtype and torch.equal(got[k], sd[k]) for k in keys)
    with pytest.raises(FileNotFoundError):
        ti.load_state_dict(tmp_path / "bins" / "..")  # no weight file at the top
    t2v = WanModel(WanModelConfig(**CFG), device="cpu")
    applied, missing = ti.load_wan_torch_weights(t2v, shards)
    assert missing and all("image_embedder" in k or "add_" in k or "norm_added_k" in k
                           for k in missing)
    assert sorted(applied) == sorted(t2v.state_dict())
    bad = dict(sd, **{"blocks.0.ffn.net.2.weight": torch.zeros(7, 7)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ti.apply_state(t2v, ti.wan_state_dict_to_tree(bad, 2, 64))


def test_router_files_match_jax(tmp_path):
    """Reference router files: Wan's blocks.{i}.router.linear.*, Hunyuan's
    transformer_blocks / single_transformer_blocks under a DDP "module."
    prefix; the port loads what the JAX loaders load."""
    cfg = dict(CFG)
    routers = {f"blocks.{i}.router.linear.{p}": torch.from_numpy(
        np.random.default_rng(i).standard_normal(sh).astype(np.float32))
        for i in range(2) for p, sh in (("weight", (6, 128)), ("bias", (6,)))}
    torch.save(routers, tmp_path / "router.pt")
    jmodel = JaxWanModel(JaxWanModelConfig(**cfg), dtype=jnp.float32, rngs=nnx.Rngs(0))
    jti.load_router_torch_checkpoint(jmodel, tmp_path / "router.pt")
    model = WanModel(WanModelConfig(**cfg), device="cpu")
    applied, missing = ti.load_router_torch_checkpoint(model, tmp_path / "router.pt")
    assert len(applied) == 4 and missing == []
    want = wan_state_from_jax(_flat(nnx.state(jmodel)), WanModelConfig(**cfg))
    for k in applied:
        assert torch.equal(model.state_dict()[k], want[k])
    hy = {}
    for stack, n in (("transformer_blocks", 2), ("single_transformer_blocks", 2)):
        for i in range(n):
            for p, sh in (("weight", (6, 128)), ("bias", (6,))):
                hy[f"module.{stack}.{i}.router.linear.{p}"] = torch.from_numpy(
                    np.random.default_rng(10 + i).standard_normal(sh).astype(np.float32))
    torch.save(hy, tmp_path / "hy_router.pt")
    jhy = jhunyuan.HunyuanModel(jhunyuan.HUNYUAN_TINY, rngs=nnx.Rngs(0))
    jti.load_hunyuan_router_torch_checkpoint(jhy, tmp_path / "hy_router.pt")
    thy = HunyuanModel(HUNYUAN_TINY, device="cpu")
    applied, _ = ti.load_hunyuan_router_torch_checkpoint(thy, tmp_path / "hy_router.pt")
    assert len(applied) == 8
    want = hunyuan_state_from_jax(_flat(nnx.state(jhy)), HUNYUAN_TINY)
    for k in applied:
        assert torch.equal(thy.state_dict()[k], want[k])
    torch.save({"blocks.0.ffn.weight": torch.zeros(2)}, tmp_path / "none.pt")
    with pytest.raises(ValueError, match="no router keys"):
        ti.load_router_torch_checkpoint(model, tmp_path / "none.pt")


def test_hunyuan_map_keys_and_validation_match_jax():
    """The Hunyuan map bit for bit against the JAX importer's tree after
    from_jax; the expected key set equals JAX's (with and without guidance
    and routers) and validation reports the same missing / unexpected keys;
    the imported tiny model's forward matches JAX's."""
    cfg = HUNYUAN_TINY
    for guidance in (True, False):
        for routers in (True, False):
            shapes = ti.hunyuan_expected_shapes(cfg, guidance, routers)
            assert set(shapes) == jti.hunyuan_expected_keys(2, 2, 1, guidance, routers)
            assert set(shapes) == ti.hunyuan_expected_keys(2, 2, 1, guidance, routers)
    sd = _random_sd(ti.hunyuan_expected_shapes(cfg, routers=True), 3)
    assert ti.validate_hunyuan_checkpoint_keys(sd, 2, 2, 1) == ([], [])
    broken = set(sd) - {"transformer_blocks.1.attn.norm_added_k.weight"} | {"extra.weight"}
    assert (ti.validate_hunyuan_checkpoint_keys(broken, 2, 2, 1)
            == jti.validate_hunyuan_checkpoint_keys(broken, 2, 2, 1)
            == (["transformer_blocks.1.attn.norm_added_k.weight"], ["extra.weight"]))
    jmodel = jhunyuan.HunyuanModel(jhunyuan.HUNYUAN_TINY, rngs=nnx.Rngs(0))
    _, state = nnx.split(jmodel)
    _, missing = jti._apply_tree(state, jti.hunyuan_state_dict_to_tree(
        {k: v.numpy() for k, v in sd.items()}, 2, 2, 1, cfg.head_dim))
    nnx.update(jmodel, state)
    assert missing == []
    want = hunyuan_state_from_jax(_flat(nnx.state(jmodel)), cfg)
    got = ti.hunyuan_state_dict_to_tree(sd, 2, 2, 1, cfg.head_dim)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = HunyuanModel(cfg, device="cpu")
    _, missing = ti.apply_state(model, got)
    assert missing == []
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, 4, 12, 32, 16)).astype(np.float32)
    text = rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32)
    mask = (np.arange(cfg.text_len) < 17)[None]
    attn = dict(latent_shape=(4, 6, 16), block_q=32, block_kv=32)
    ref = jmodel(*(jnp.asarray(a) for a in (lat, np.float32([400.0]), text, mask, pooled)),
                 guidance=jnp.asarray([6000.0]), attn_cfg=JaxAttentionConfig(**attn),
                 interpret=True).sample
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (lat, np.float32([400.0]), text, mask,
                                                     pooled)),
                    guidance=torch.tensor([6000.0]), attn_cfg=AttentionConfig(**attn)).sample
    _close(out, ref)


@pytest.mark.parametrize("sizes", [(3, 0, 5, 2, 1, 7), (1, 4, 0, 9, 8), (6, 11, 1, 1, 2)])
def test_rng_skip_matches_drawing(sizes):
    """The checkpoint path steps its generator past a leaf the checkpoint
    has: the next draws equal those after drawing it, for odd and even
    counts and after a draw that left half a 64-bit output unused."""
    drawn, skipped = np.random.default_rng(9), np.random.default_rng(9)
    for j, n in enumerate(sizes):
        want = drawn.random(n, dtype=np.float32)
        if j % 2:
            qs._skip_f32_draws(skipped, n)
        else:
            np.testing.assert_array_equal(skipped.random(n, dtype=np.float32), want)
    np.testing.assert_array_equal(skipped.random(5, dtype=np.float32),
                                  drawn.random(5, dtype=np.float32))


def test_quantized_checkpoint_matches_jax(tmp_path):
    """build_quantized_wan / build_quantized_hunyuan from a checkpoint: the
    stacks leaf for leaf as the JAX package's (quantized leaves' codes and
    scales, bf16 leaves, the leaves the checkpoint lacks drawn from the
    seed), the non-block modules as imported; a reference router file
    merged unquantized."""
    from safetensors.torch import save_file

    cfg = dict(dim=256, ffn_dim=512, num_heads=2, head_dim=128, num_layers=16, text_dim=32,
               text_len=16, freq_dim=32)  # 256 x 256 f32 over 16 layers: quantized
    sd = _random_sd(ti.wan_expected_shapes(WanModelConfig(**cfg)), 5)  # no routers
    save_file(sd, str(tmp_path / "wan.safetensors"))
    jm, jq = jqs.build_quantized_wan(JaxWanModelConfig(**cfg), bits=4,
                                     checkpoint=str(tmp_path / "wan.safetensors"), seed=3,
                                     dtype=jnp.bfloat16)
    ref = {jax.tree_util.keystr(kp): leaf for kp, leaf in jax.tree_util.tree_flatten_with_path(
        jq, is_leaf=lambda x: isinstance(x, jquant.QTensor))[0]}
    model, stack = qs.build_quantized_wan(WanModelConfig(**cfg), 4,
                                          checkpoint=str(tmp_path / "wan.safetensors"), seed=3,
                                          device="cpu")
    assert set(stack.leaves) == set(ref) and stack.num_layers == 16
    n_quantized = 0
    for key, r in ref.items():
        g = stack.leaves[key]
        if isinstance(r, jquant.QTensor):
            n_quantized += 1
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(r.q))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(r.scale))
        else:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))
    assert n_quantized == 10
    jflat = _flat(nnx.state(jm))
    for k, v in model.state_dict().items():
        if not k.startswith("blocks."):
            want = wan_state_from_jax(jflat, WanModelConfig(**{**cfg, "num_layers": 1}))[k]
            assert torch.equal(v, want), k
    routers = {f"blocks.{i}.router.linear.{p}": torch.full(sh, float(i))
               for i in range(16) for p, sh in (("weight", (6, 256)), ("bias", (6,)))}
    torch.save(routers, tmp_path / "router.pt")
    _, stack = qs.build_quantized_wan(WanModelConfig(**cfg), 8,
                                      checkpoint=str(tmp_path / "wan.safetensors"),
                                      router_state=ti.wan_router_state(tmp_path / "router.pt", 16),
                                      seed=3, device="cpu")
    w = stack.leaves["['router']['linear']['kernel'].value"]
    assert w.dtype == torch.bfloat16 and torch.equal(w[:, 0, 0].float(), torch.arange(16.0))
    # HunyuanVideo-tiny: two stacks (seeds 3 and 4), nothing large enough to quantize
    hsd = _random_sd(ti.hunyuan_expected_shapes(HUNYUAN_TINY), 6)
    save_file(hsd, str(tmp_path / "hy.safetensors"))
    _, (jd, js) = jqs.build_quantized_hunyuan(jhunyuan.HUNYUAN_TINY, bits=4,
                                              checkpoint=str(tmp_path / "hy.safetensors"),
                                              seed=3, dtype=jnp.bfloat16)
    _, (td, ts) = qs.build_quantized_hunyuan(HUNYUAN_TINY, 4,
                                             checkpoint=str(tmp_path / "hy.safetensors"),
                                             seed=3, device="cpu")
    for jstack, tstack in ((jd, td), (js, ts)):
        flat = _flat(jstack)
        assert set(flat) == set(tstack.leaves)
        for key, r in flat.items():
            np.testing.assert_array_equal(tstack.leaves[key].float().numpy(),
                                          np.asarray(r, np.float32))
