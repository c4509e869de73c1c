"""The f32 training path's rules on the CPU: the flash forward's f32 lse and
the flash backward's f32 dq and dk/dv modes (which C entry each wrapper
calls with f32 tensors off the CPU, with what, and what it counts), f16
and mixed dtypes still raising, the bf16 entries unchanged, the f32 plain
versions against the JAX package's Pallas kernels in interpret mode, and
the entry points that train (or profile training) in f32 on CUDA.

Meta tensors stand for CUDA ones: the wrappers' device check is let
through and each library entry a wrapper calls is recorded and returns 0
(success) without a build or a launch (there is no nvcc here); a meta
tensor's data pointer is 0, so a tensor the wrapper passes shows as 0 and
an absent one as None.  The card runs the kernels themselves:
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``'s phase s.
Tolerances against Pallas: f32 on both sides, rtol 1e-4 and atol 1e-4 x
the compared array's max |value| (XLA-CPU and PyTorch sum in different
orders); the lse sentinel 1e30 exactly.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorta_tpu.ops.flash import sparse_flash_attention_raw as jax_flash
from vorta_tpu.ops.flash_bwd import flash_backward as jax_flash_backward
from vorta_tpu_torch.ops import _build
from vorta_tpu_torch.ops.flash import (
    make_sparse_attention,
    sparse_flash_attention_raw,
    tables_from_block_mask,
)
from vorta_tpu_torch.ops.flash_bwd import flash_backward, transpose_tables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    several pytest workers side by side, and PyTorch's default of a thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Entry:
    """A stand-in C entry: records its arguments, returns 0 (success)."""

    def __init__(self, lib, name, calls):
        self.lib, self.name, self.calls = lib, name, calls
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append((self.lib, self.name, args, self.argtypes))
        return 0


@pytest.fixture
def meta_card(monkeypatch):
    """Meta tensors take the CUDA branch of every wrapper; returns the list
    of (library, entry, arguments, argtypes) of the entries called."""
    calls = []

    class Library:
        def __init__(self, name):
            self.name, self.entries = name, {}

        def __getattr__(self, entry):
            if entry.startswith("__"):
                raise AttributeError(entry)
            return self.entries.setdefault(entry, _Entry(self.name, entry, calls))

    libs = {}
    monkeypatch.setattr(_build, "require_cuda", lambda *tensors: tensors[0].device)
    monkeypatch.setattr(_build, "load", lambda name: libs.setdefault(name, Library(name)))
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    _build.reset_launches()
    yield calls
    _build.reset_launches()


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _tables(nq, nkv):
    ki = torch.from_numpy(np.broadcast_to(np.arange(nkv, dtype=np.int32), (1, nq, nkv)).copy())
    return ki, torch.full((1, nq), nkv, dtype=torch.int32)


def _launched(**want):
    got = {k: v for k, v in _build.launches.items() if v}
    assert got == want


# --- the forward's lse ---------------------------------------------------------------

@pytest.mark.parametrize("d,block", [(64, 16), (128, 128), (128, 1024), (128, 96)])
def test_f32_lse_calls_the_f32_entry_with_an_lse(meta_card, d, block):
    """An f32 call with return_lse asks the f32 entry, with an lse buffer
    (B, H, Sq, 1) f32 in the lse slot; counted as flash, flash_f32 and
    flash_lse, never on the Hopper path (its rule is bf16's); at D 128 with
    blocks multiples of 8 (the STA tiles' 96 too) on the tensor-core core
    (its scratch in the next-to-last slot, counted as flash_f32_tc), at D 64
    on the FFMA core."""
    s = 2 * block
    q = _t(1, 2, s, d)
    ki, kc = _tables(2, 2)
    out, lse = sparse_flash_attention_raw(q, q, q, ki, kc, block_q=block, block_kv=block,
                                          kv_valid_len=s - 5, return_lse=True)
    [(lib, entry, args, argtypes)] = meta_card
    assert (lib, entry) == ("flash", "vorta_flash_fwd_f32")
    assert len(args) == len(argtypes) == 21 and args[4] is not None  # the lse slot
    assert args[7:18] == (1, 2, s, s, d, 1, 2, 2, block, block, s - 5)
    tc = d == 128
    assert (args[19] is not None) == tc  # the tensor-core core's scratch
    assert lse.shape == (1, 2, s, 1) and lse.dtype == torch.float32
    assert out.dtype == torch.float32
    _launched(flash=1, flash_f32=1, flash_lse=1, **({"flash_f32_tc": 1} if tc else {}))


def test_f32_forward_without_lse_passes_none(meta_card):
    q = _t(1, 2, 32, 64)
    ki, kc = _tables(2, 2)
    out = sparse_flash_attention_raw(q, q, q, ki, kc, block_q=16, block_kv=16)
    assert isinstance(out, torch.Tensor) and meta_card[0][2][4] is None
    _launched(flash=1, flash_f32=1)


@pytest.mark.parametrize("block,hopper", [(128, 1), (96, 0)])
def test_bf16_lse_entry_unchanged(meta_card, block, hopper):
    """bf16 keeps its entry, its Hopper rule and its flag."""
    q = _t(1, 2, 2 * block, 128, dtype=torch.bfloat16)
    ki, kc = _tables(2, 2)
    sparse_flash_attention_raw(q, q, q, ki, kc, block_q=block, block_kv=block, return_lse=True)
    [(lib, entry, args, argtypes)] = meta_card
    assert (lib, entry) == ("flash", "vorta_flash_fwd_bf16")
    assert len(args) == len(argtypes) == 21 and args[4] is not None and args[19] == hopper
    _launched(flash=1, flash_lse=1, **({"flash_wgmma": 1} if hopper else {}))


# --- the backward ----------------------------------------------------------------------

def _bwd(dtype, d=64, block=16, n=3, dout_dtype=None, **kw):
    s = n * block
    q = _t(1, 2, s, d, dtype=dtype)
    dout = _t(1, 2, s, d, dtype=dout_dtype or dtype)
    ki, kc = _tables(n, n)
    qi, qc = transpose_tables(ki.numpy(), kc.numpy(), n)
    return flash_backward(q, q, q, q, _t(1, 2, s, 1), dout, ki, kc, torch.from_numpy(qi),
                          torch.from_numpy(qc), scale=d**-0.5, block_q=block, block_kv=block,
                          kv_valid_len=s - 3, **kw)


@pytest.mark.parametrize("d,block", [(64, 8), (64, 24), (128, 128), (128, 360)])
def test_f32_backward_calls_the_f32_entries(meta_card, d, block):
    """f32 inputs call vorta_flash_bwd_dq_f32 and vorta_flash_bwd_dkv_f32
    (no Hopper flag: 9 + 9 and 10 + 9 arguments, the scale, the tensor-core
    kernels' scratch, the stream) at any shape, the Hopper rule's too; f32
    dq, dk, dv; counted as flash_dq / flash_dkv and their _f32 subsets, never
    _wgmma.  At D 128 (blocks multiples of 8: the backward's tensor-core
    rule) the split pre-pass runs first and both entries get its scratch
    (counted as _f32_tc too); at D 64 the scratch is None (the FFMA
    kernels)."""
    s = 3 * block
    tc = d == 128
    dq, dk, dv = _bwd(torch.float32, d, block)
    assert [(c[0], c[1]) for c in meta_card] == (
        [("flash_bwd", "vorta_flash_bwd_f32_tc_split")] * tc
        + [("flash_bwd", "vorta_flash_bwd_dq_f32"), ("flash_bwd", "vorta_flash_bwd_dkv_f32")])
    for (_, _, args, argtypes), n_ptr in zip(meta_card[tc:], (9, 10)):
        assert len(args) == len(argtypes) == n_ptr + 9 + 3
        # scale, scratch, stream
        assert argtypes[n_ptr + 9:] == [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        assert args[n_ptr:n_ptr + 5] == (1, 2, s, s, d)
        assert args[n_ptr + 6:n_ptr + 9] == (block, block, s - 3)
        assert args[n_ptr + 9] == pytest.approx(d**-0.5)
        assert (args[n_ptr + 10] is not None) == tc
    assert all(t.dtype == torch.float32 and t.shape == (1, 2, s, d) for t in (dq, dk, dv))
    _launched(flash_dq=1, flash_dkv=1, flash_dq_f32=1, flash_dkv_f32=1,
              **({"flash_dq_f32_tc": 1, "flash_dkv_f32_tc": 1} if tc else {}))


@pytest.mark.parametrize("need", ["dq", "dkv"])
def test_f32_backward_skips_what_is_not_needed(meta_card, need):
    dq, dk, dv = _bwd(torch.float32, need_dq=need == "dq", need_dkv=need == "dkv")
    assert (dq is None) == (need != "dq") and (dk is None) == (dv is None) == (need != "dkv")
    assert [c[1] for c in meta_card] == [f"vorta_flash_bwd_{need}_f32"]
    _launched(**{f"flash_{need}": 1, f"flash_{need}_f32": 1})


@pytest.mark.parametrize("block,hopper", [(128, 1), (24, 0)])
def test_bf16_backward_entries_unchanged(meta_card, block, hopper):
    _bwd(torch.bfloat16, 128, block)
    assert [c[1] for c in meta_card] == ["vorta_flash_bwd_dq_bf16", "vorta_flash_bwd_dkv_bf16"]
    for (_, _, args, argtypes), n_ptr in zip(meta_card, (9, 10)):
        assert len(args) == len(argtypes) == n_ptr + 9 + 3 and args[-2] == hopper
    _launched(flash_dq=1, flash_dkv=1,
              **({"flash_dq_wgmma": 1, "flash_dkv_wgmma": 1} if hopper else {}))


@pytest.mark.parametrize("case", ["f16", "f32_with_bf16_dout", "bf16_with_f32_dout"])
def test_backward_other_dtypes_still_raise(meta_card, case):
    """f16, and f32 mixed with bf16, raise before any entry is called:
    nothing casts, nothing falls back."""
    kw = {"f16": dict(dtype=torch.float16),
          "f32_with_bf16_dout": dict(dtype=torch.float32, dout_dtype=torch.bfloat16),
          "bf16_with_f32_dout": dict(dtype=torch.bfloat16, dout_dtype=torch.float32)}[case]
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        _bwd(**kw)
    assert meta_card == []


def test_forward_f16_lse_still_raises(meta_card):
    q = _t(1, 2, 32, 64, dtype=torch.float16)
    ki, kc = _tables(2, 2)
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        sparse_flash_attention_raw(q, q, q, ki, kc, block_q=16, block_kv=16, return_lse=True)
    assert meta_card == []


def test_sparse_attention_f32_autograd_calls_the_f32_kernels(meta_card):
    """make_sparse_attention under grad with f32 q, k, v: the forward asks
    the f32 entry with an lse, the backward both f32 entries."""
    q = _t(1, 2, 48, 64).requires_grad_()
    attn = make_sparse_attention(tables_from_block_mask(np.ones((1, 3, 3), bool)),
                                 n_kv_blocks=3, block_q=16, block_kv=16)
    attn(q, q, q).sum().backward()
    assert [c[1] for c in meta_card] == ["vorta_flash_fwd_f32", "vorta_flash_bwd_dq_f32",
                                         "vorta_flash_bwd_dkv_f32"]
    assert meta_card[0][2][4] is not None and q.grad.dtype == torch.float32
    _launched(flash=1, flash_f32=1, flash_lse=1, flash_dq=1, flash_dkv=1, flash_dq_f32=1,
              flash_dkv_f32=1)


# --- the f32 plain versions against Pallas (interpret mode) ------------------------------

CASES = {  # name: (block, D, sequence, kv_valid_len)
    "blocks8_d64": (8, 64, 48, 45),
    "blocks16_d128": (16, 128, 64, 57),
    "blocks24_d64": (24, 64, 96, 90),
}


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(np.abs(want).max(), 1e-6))


def _case(name):
    block, d, s, valid = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, dout = (rng.standard_normal((1, 2, s, d)).astype(np.float32) for _ in range(4))
    nb = s // block
    mask = rng.random((1, nb, nb)) < 0.6
    mask[:, 0] = False  # a q block with count 0: the lse sentinel, zero dq
    mask[:, 1:, nb - 1] = True  # the tail block is visited
    mask[:, 1:, 0] = True
    return (q, k, v, dout), mask, dict(scale=1.1 * d**-0.5, block_q=block, block_kv=block), valid


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_lse_and_backward_plain_match_pallas(name):
    """The f32 plain forward with its lse and flash_backward_ref against the
    JAX kernels in interpret mode, in f32: blocks of 8, 16 and 24 rows, D 64
    and 128, a kv tail, a count-0 q block (lse 1e30, zero dq), kv rows past
    the tail (zero dk, dv)."""
    (q, k, v, dout), mask, kw, valid = _case(name)
    tab = tables_from_block_mask(mask)
    nkv = mask.shape[2]
    qi, qc = transpose_tables(tab.kv_index, tab.kv_count, nkv)
    j = [jnp.asarray(x) for x in (q, k, v, dout)]
    jout, jlse = jax_flash(*j[:3], jnp.asarray(tab.kv_index), jnp.asarray(tab.kv_count),
                           kv_valid_len=valid, return_lse=True, interpret=True, **kw)
    jgrads = jax_flash_backward(*j[:3], jout, jlse, j[3], jnp.asarray(tab.kv_index),
                                jnp.asarray(tab.kv_count), jnp.asarray(qi), jnp.asarray(qc),
                                kv_valid_len=valid, interpret=True, **kw)
    t = [torch.from_numpy(x) for x in (q, k, v, dout)]
    out, lse = sparse_flash_attention_raw(*t[:3], tab.kv_index, tab.kv_count, kv_valid_len=valid,
                                          return_lse=True, **kw)
    _close(out, jout)
    jlse = np.asarray(jlse)
    empty = jlse == 1e30
    assert empty[:, :, :kw["block_q"]].all() and (lse.numpy()[empty] == 1e30).all()
    _close(lse[torch.from_numpy(~empty)], jlse[~empty])
    # the backward from the same out and lse (the JAX forward's), so that the
    # comparison holds the backward alone
    got = flash_backward(*t[:3], torch.from_numpy(np.array(jout)),
                         torch.from_numpy(jlse.copy()), t[3], tab.kv_index, tab.kv_count, qi, qc,
                         kv_valid_len=valid, **kw)
    for a, w in zip(got, jgrads):
        assert a.dtype == torch.float32
        _close(a, w)
    assert not got[0][:, :, :kw["block_q"]].any()
    assert not got[1][:, :, valid:].any() and not got[2][:, :, valid:].any()


# --- the entry points ------------------------------------------------------------------

def test_train_fp32_on_cuda_stops_at_the_device_check(monkeypatch, tmp_path):
    """cli.train --dtype fp32 at its default device: without a card the run
    stops at the device check (RuntimeError), not at an f32 refusal
    (SystemExit, as before this slice)."""
    from vorta_tpu_torch.cli import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("wan-1_3B", "wan-tiny", "hunyuan-tiny"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--model", model, "--dtype", "fp32", "--synthetic_data",
                        "--output_dir", str(tmp_path)])


@pytest.mark.parametrize("dtype,calls", [("fp32", 1), ("bf16", 0)])
def test_train_fp32_turns_tf32_off_on_the_card(monkeypatch, tmp_path, dtype, calls):
    """An f32 model on the card first calls device.full_f32 (TF32 off), as
    cli.sample does; bf16 does not."""
    from vorta_tpu_torch.cli import train

    seen = []

    class Stop(Exception):
        pass

    def attention_config(args):
        raise Stop

    monkeypatch.setattr(train, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(train, "full_f32", seen.append)
    monkeypatch.setattr(train, "attention_config", attention_config)
    with pytest.raises(Stop):
        train.main(["--dtype", dtype, "--output_dir", str(tmp_path)])
    assert seen == [torch.device("cuda")] * calls


def test_profile_forward_takes_fp32(monkeypatch):
    """cli.profile_forward --dtype fp32 --train parses and stops at the
    device check without a card; with the quantized flags or a VAE it is
    refused."""
    from vorta_tpu_torch.cli import profile_forward

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_forward.main(["--num_frames", "77", "--train", "--dtype", "fp32"])
    for extra in (["--mm", "int8"], ["--vae", "wan"]):
        with pytest.raises(SystemExit):
            profile_forward.main(["--dtype", "fp32", *extra])
