"""The port's text encoders, prompt encoding and their checkpoint maps
against the JAX package, on the CPU.

UMT5_TINY, LLAMA_TINY and CLIP_TINY are built by the JAX package, with
random weights from a seed (port_assets/random_jax.py), and carried into
the port through io/from_jax.py
(``module_state_from_jax``); the same numpy ids and masks go to both.  The
prompt stage runs a toy BPE tokenizer trained in the test (as
tests/test_text_pipeline.py does), with and without HunyuanVideo's
template crop.  The importer maps take one synthetic transformers state
dict (the real key names, the config's shapes) through both packages'
maps: the port's parameters must equal the JAX model's after its import,
bit for bit.

Tolerance: f32 on both sides, max |port - JAX| <= 1e-4 * max(max |JAX|, 1)
(the two sum in different orders); exact where both only copy or count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from port_assets.random_jax import random_module
from vorta_tpu.io import text as jtext
from vorta_tpu.io import torch_import as jimport
from vorta_tpu.models import text_encoders as jte
from vorta_tpu.models import umt5 as jumt5
from vorta_tpu_torch.io import text, torch_import
from vorta_tpu_torch.io.from_jax import module_state_from_jax
from vorta_tpu_torch.models import text_encoders as te
from vorta_tpu_torch.models import umt5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    """max |got - want| <= 1e-4 * max(max |want|, 1), shapes equal."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


def _flat(jmodel) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(nnx.state(jmodel))
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


def _port(jmodel, cls, cfg):
    tmodel = cls(cfg, device="cpu")
    tmodel.load_state_dict(module_state_from_jax(_flat(jmodel), tmodel))
    return tmodel


ENCODERS = {  # name: (JAX class, port class, JAX config, port config, seed)
    "umt5": (jumt5.UMT5Encoder, umt5.UMT5Encoder, jumt5.UMT5_TINY, umt5.UMT5_TINY, 0),
    "llama": (jte.LlamaTextEncoder, te.LlamaTextEncoder, jte.LLAMA_TINY, te.LLAMA_TINY, 0),
    "clip": (jte.CLIPTextEncoder, te.CLIPTextEncoder, jte.CLIP_TINY, te.CLIP_TINY, 1),
}


@pytest.fixture(scope="module")
def encoders():
    out = {}
    for name, (jcls, tcls, jcfg, tcfg, seed) in ENCODERS.items():
        jmodel = random_module(lambda: jcls(jcfg, rngs=nnx.Rngs(0)), seed)
        out[name] = (jmodel, _port(jmodel, tcls, tcfg))
    return out


def _ids(seed, vocab, shape=(2, 12)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, shape)
    mask = np.ones(shape, bool)
    mask[1, 7:] = False  # the second prompt is padded
    return ids, mask


def test_configs_match_jax():
    pairs = [(jcfg, tcfg) for _, _, jcfg, tcfg, _ in ENCODERS.values()]
    pairs += [(jumt5.UMT5_XXL, umt5.UMT5_XXL), (jte.LLAMA_8B, te.LLAMA_8B),
              (jte.CLIP_L, te.CLIP_L)]
    for jcfg, tcfg in pairs:
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 16), (32, 20)])
def test_relative_position_bucket_matches_jax(num_buckets, max_distance):
    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    np.testing.assert_array_equal(
        umt5.relative_position_bucket(rel, num_buckets, max_distance),
        jumt5.relative_position_bucket(rel, num_buckets, max_distance))


def test_umt5_matches_jax(encoders):
    """Each layer its own relative bias, unscaled f32 attention with the key
    mask, gated tanh-GELU FFN; padded rows zero."""
    jmodel, tmodel = encoders["umt5"]
    ids, mask = _ids(0, umt5.UMT5_TINY.vocab_size)
    got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, jmodel(jnp.asarray(ids), jnp.asarray(mask)))
    assert torch.all(got[1, 7:] == 0) and not torch.all(got[1, :7] == 0)


@pytest.mark.parametrize("crop_start", [0, 3])
def test_llama_matches_jax(encoders, crop_start):
    """GQA (4 / 2 heads), rotate-half RoPE, causal and key masks, the last
    layer normed, ``crop_start`` rows dropped."""
    jmodel, tmodel = encoders["llama"]
    ids, mask = _ids(1, te.LLAMA_TINY.vocab_size)
    got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask), crop_start=crop_start)
    assert got.shape == (2, 12 - crop_start, te.LLAMA_TINY.dim)
    _close(got, jmodel(jnp.asarray(ids), jnp.asarray(mask), crop_start=crop_start))


def test_llama_rope_tables_match_jax():
    for s, hd, theta in ((16, 16, 10000.0), (300, 128, 500000.0)):
        cos, sin = te._llama_rope(s, hd, theta)
        jcos, jsin = jte._llama_rope(s, hd, theta)
        np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
        np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


def test_clip_matches_jax(encoders):
    """Causal, quick-GELU, pooled at the first EOS (row 0 has two), or at
    the last token where there is none (row 1)."""
    jmodel, tmodel = encoders["clip"]
    ids, _ = _ids(2, te.CLIP_TINY.vocab_size)
    ids[0, 5] = ids[0, 9] = 99
    ids[1][ids[1] == 99] = 98
    got = tmodel(torch.from_numpy(ids), eos_token_id=99)
    _close(got, jmodel(jnp.asarray(ids), eos_token_id=99))
    assert got.dtype == torch.float32


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


def test_tokenize_matches_jax(toy_tokenizer):
    tok = text.load_tokenizer(toy_tokenizer)
    jtok = jtext.load_tokenizer(toy_tokenizer)
    prompts = ["a cat walking", "a dog running through a sunny field of flowers at night"]
    ids, mask = text.tokenize(tok, prompts, max_len=8)
    jids, jmask = jtext.tokenize(jtok, prompts, max_len=8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    with pytest.raises(FileNotFoundError):
        text.load_tokenizer(toy_tokenizer / "absent")


def test_encode_prompt_wan_matches_jax(encoders, toy_tokenizer):
    jmodel, tmodel = encoders["umt5"]
    tok = text.load_tokenizer(toy_tokenizer)
    prompts = ["a cat walking on grass", "a dog"]
    got = text.encode_prompt_wan(prompts, tok, tmodel, max_len=16)
    _close(got, jtext.encode_prompt_wan(prompts, tok, jmodel, max_len=16))
    _, mask = text.tokenize(tok, prompts, 16)
    n = int(mask[1].sum())
    assert torch.all(got[1, n:] == 0) and not torch.all(got[1, :n] == 0)


@pytest.mark.parametrize("template", [None, "cinematic shot of {}"])
def test_encode_prompt_hunyuan_matches_jax(encoders, toy_tokenizer, template):
    """The Llama states and mask cropped past the template's tokens, CLIP on
    the raw prompt."""
    (jllama, tllama), (jclip, tclip) = encoders["llama"], encoders["clip"]
    tok = text.load_tokenizer(toy_tokenizer)
    kw = dict(max_len=10, clip_max_len=12, template=template)
    states, mask, pooled = text.encode_prompt_hunyuan("a dog running", tok, tllama, tok, tclip,
                                                      **kw)
    jstates, jmask, jpooled = jtext.encode_prompt_hunyuan("a dog running", tok, jllama, tok,
                                                          jclip, **kw)
    assert states.shape == (1, 10, te.LLAMA_TINY.dim)
    _close(states, jstates)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    _close(pooled, jpooled)


# --- the importer maps ----------------------------------------------------------------


def _r(g, *shape):
    return torch.randn(*shape, generator=g) * 0.05


def _umt5_sd(c, g):
    inner = c.num_heads * c.d_kv
    sd = {"shared.weight": _r(g, c.vocab_size, c.d_model),
          "encoder.final_layer_norm.weight": 1 + _r(g, c.d_model)}
    for i in range(c.num_layers):
        p = f"encoder.block.{i}"
        att, ff = f"{p}.layer.0.SelfAttention", f"{p}.layer.1.DenseReluDense"
        sd.update({
            f"{p}.layer.0.layer_norm.weight": 1 + _r(g, c.d_model),
            f"{att}.q.weight": _r(g, inner, c.d_model), f"{att}.k.weight": _r(g, inner, c.d_model),
            f"{att}.v.weight": _r(g, inner, c.d_model), f"{att}.o.weight": _r(g, c.d_model, inner),
            f"{att}.relative_attention_bias.weight": _r(
                g, c.relative_attention_num_buckets, c.num_heads),
            f"{p}.layer.1.layer_norm.weight": 1 + _r(g, c.d_model),
            f"{ff}.wi_0.weight": _r(g, c.d_ff, c.d_model),
            f"{ff}.wi_1.weight": _r(g, c.d_ff, c.d_model),
            f"{ff}.wo.weight": _r(g, c.d_model, c.d_ff),
        })
    return sd


def _llama_sd(c, g):
    kv = c.num_kv_heads * (c.dim // c.num_heads)
    sd = {"model.embed_tokens.weight": _r(g, c.vocab_size, c.dim),
          "model.norm.weight": 1 + _r(g, c.dim)}
    for i in range(c.num_layers):
        p = f"model.layers.{i}"
        sd.update({
            f"{p}.input_layernorm.weight": 1 + _r(g, c.dim),
            f"{p}.self_attn.q_proj.weight": _r(g, c.dim, c.dim),
            f"{p}.self_attn.k_proj.weight": _r(g, kv, c.dim),
            f"{p}.self_attn.v_proj.weight": _r(g, kv, c.dim),
            f"{p}.self_attn.o_proj.weight": _r(g, c.dim, c.dim),
            f"{p}.post_attention_layernorm.weight": 1 + _r(g, c.dim),
            f"{p}.mlp.gate_proj.weight": _r(g, c.ffn_dim, c.dim),
            f"{p}.mlp.up_proj.weight": _r(g, c.ffn_dim, c.dim),
            f"{p}.mlp.down_proj.weight": _r(g, c.dim, c.ffn_dim),
        })
    return sd


def _clip_sd(c, g):
    sd = {"text_model.embeddings.token_embedding.weight": _r(g, c.vocab_size, c.dim),
          "text_model.embeddings.position_embedding.weight": _r(g, c.max_len, c.dim),
          "text_model.final_layer_norm.weight": 1 + _r(g, c.dim),
          "text_model.final_layer_norm.bias": _r(g, c.dim)}
    for i in range(c.num_layers):
        p = f"text_model.encoder.layers.{i}"
        for name, shape in [("layer_norm1", (c.dim,)), ("layer_norm2", (c.dim,)),
                            ("self_attn.q_proj", (c.dim, c.dim)),
                            ("self_attn.k_proj", (c.dim, c.dim)),
                            ("self_attn.v_proj", (c.dim, c.dim)),
                            ("self_attn.out_proj", (c.dim, c.dim)),
                            ("mlp.fc1", (c.ffn_dim, c.dim)), ("mlp.fc2", (c.dim, c.ffn_dim))]:
            sd[f"{p}.{name}.weight"] = _r(g, *shape)
            sd[f"{p}.{name}.bias"] = _r(g, shape[0])
    return sd


IMPORTERS = {  # name: (synthetic state dict, JAX map, port loader)
    "umt5": (_umt5_sd, jimport.umt5_state_dict_to_tree, torch_import.load_umt5_torch_weights),
    "llama": (_llama_sd, jimport.llama_state_dict_to_tree, torch_import.load_llama_torch_weights),
    "clip": (_clip_sd, jimport.clip_text_state_dict_to_tree,
             torch_import.load_clip_text_torch_weights),
}


@pytest.mark.parametrize("name", sorted(IMPORTERS))
def test_importer_matches_jax(name, tmp_path):
    """One transformers-style state dict, saved as a .pt, through both maps:
    every port parameter set, equal to the JAX model's after its import."""
    make_sd, jmap, load = IMPORTERS[name]
    jcls, tcls, jcfg, tcfg, seed = ENCODERS[name]
    sd = make_sd(tcfg, torch.Generator().manual_seed(7))
    torch.save(sd, tmp_path / "enc.pt")
    jmodel = random_module(lambda: jcls(jcfg, rngs=nnx.Rngs(0)), seed)
    _, state = nnx.split(jmodel)
    _, jmissing = jimport._apply_tree(state, jmap({k: v.numpy() for k, v in sd.items()},
                                                  jcfg.num_layers))
    nnx.update(jmodel, state)
    tmodel = tcls(tcfg, device="cpu", seed=3)
    applied, missing = load(tmodel, tmp_path / "enc.pt")
    assert not jmissing and not missing
    assert sorted(applied) == sorted(tmodel.state_dict())
    want = module_state_from_jax(_flat(jmodel), tmodel)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_umt5_importer_takes_the_encoder_table():
    """Without ``shared.weight`` the table comes from the encoder's own
    ``embed_tokens`` (the JAX map's fallback)."""
    c = umt5.UMT5_TINY
    sd = _umt5_sd(c, torch.Generator().manual_seed(8))
    table = sd.pop("shared.weight")
    sd["encoder.embed_tokens.weight"] = table
    assert torch.equal(torch_import.umt5_state_dict_to_tree(sd, c.num_layers)["embed.weight"],
                       table)
