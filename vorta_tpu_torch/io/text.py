"""Prompt -> conditioning embeddings (counterpart of vorta_tpu/io/text.py).

HuggingFace *fast* tokenizers (the Rust ``tokenizers`` runtime, imported in
``load_tokenizer``; a ``tokenizer.json`` is needed, the sentencepiece format
is not read) feed the port's encoders: UMT5 for Wan (models/umt5.py), Llama
+ CLIP for HunyuanVideo (models/text_encoders.py).  Token ids and masks are
made on the host and go to the encoder's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch


def load_tokenizer(path):
    """Load a fast tokenizer from a directory (tokenizer.json) or file."""
    from tokenizers import Tokenizer

    p = Path(path)
    if p.is_dir():
        p = p / "tokenizer.json"
    if not p.exists():
        raise FileNotFoundError(
            f"{p} not found — need a HuggingFace fast-tokenizer file "
            "(tokenizer.json; the slow sentencepiece format is not supported)"
        )
    return Tokenizer.from_file(str(p))


def tokenize(tokenizer, prompts, max_len: int, pad_id: int = 0, device=None):
    """-> (ids (B, L) int64, mask (B, L) bool) on ``device``, padded /
    truncated to max_len."""
    if isinstance(prompts, str):
        prompts = [prompts]
    ids = np.full((len(prompts), max_len), pad_id, np.int64)
    mask = np.zeros((len(prompts), max_len), bool)
    for i, prompt in enumerate(prompts):
        toks = tokenizer.encode(prompt).ids[:max_len]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = True
    return torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)


def encode_prompt_wan(prompts, tokenizer, encoder, max_len: int = 512) -> torch.Tensor:
    """Prompt(s) -> (B, max_len, text_dim) UMT5 hidden states, padded rows
    zero (Wan runs its text without a mask: padded positions carry zeros)."""
    ids, mask = tokenize(tokenizer, prompts, max_len, device=encoder.device)
    states = encoder(ids, mask)
    return states * mask[:, :, None].to(states.dtype)


def encode_prompt_hunyuan(
    prompts,
    llama_tokenizer,
    llama_encoder,  # models.text_encoders.LlamaTextEncoder
    clip_tokenizer,
    clip_encoder,  # models.text_encoders.CLIPTextEncoder
    max_len: int = 256,
    clip_max_len: int = 77,
    template: Optional[str] = None,
    crop_start: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prompt(s) -> (Llama hidden states (B, max_len, D), mask (B, max_len),
    CLIP pooled (B, Dp)), the HunyuanVideo conditioning triple.

    With a ``template`` (the instruction prompt HunyuanVideo wraps user
    prompts in) only the Llama input is templated: the template's prefix
    tokens are tokenized with extra budget and cropped from the states and
    the mask (``crop_start``), and CLIP sees the raw prompt."""
    raw_prompts = prompts
    if template is not None:
        if crop_start is None:
            # tokens the template contributes before the user prompt
            crop_start = len(llama_tokenizer.encode(template.format("")).ids)
        if isinstance(prompts, str):
            prompts = template.format(prompts)
        else:
            prompts = [template.format(p) for p in prompts]
    else:
        crop_start = 0
    ids, mask = tokenize(llama_tokenizer, prompts, max_len + crop_start,
                         device=llama_encoder.device)
    states = llama_encoder(ids, mask, crop_start=crop_start)
    cids, _ = tokenize(clip_tokenizer, raw_prompts, clip_max_len, device=clip_encoder.device)
    return states, mask[:, crop_start:], clip_encoder(cids)
