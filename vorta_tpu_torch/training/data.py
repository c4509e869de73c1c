"""Precomputed-latents dataset for router training (the port's own copy of
vorta_tpu/training/data.py).

The reference's FastVideo-style layout (vorta/dataset/latent_datasets.py): a
JSON manifest next to ``latent/``, ``prompt_embed/`` and optional
``prompt_attention_mask/`` directories of torch-saved tensors.  Training
never touches the VAE or text encoder.  Tensors come back channels-last
(T, H, W, C) numpy, as the JAX package gives them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, List

import numpy as np
import torch


def _load_tensor(path: Path) -> np.ndarray:
    return torch.load(path, map_location="cpu", weights_only=True).float().numpy()


class LatentDataset:
    """items: dicts with keys latent_path, prompt_embed_path[, prompt_attention_mask]."""

    def __init__(self, manifest_path: str, num_latent_t: int, cfg_rate: float = 0.0,
                 seed: int = 42):
        self.root = Path(manifest_path).parent
        with open(manifest_path) as f:
            self.items: List[dict] = json.load(f)
        self.num_latent_t = num_latent_t
        self.cfg_rate = cfg_rate
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int):
        item = self.items[idx]
        latent = _load_tensor(self.root / "latent" / item["latent_path"])
        # stored (C, T, H, W): crop to the last num_latent_t frames
        # (reference: latent_datasets.py:70-75), emit channels-last
        latent = np.transpose(latent[:, -self.num_latent_t:], (1, 2, 3, 0))
        embed = _load_tensor(self.root / "prompt_embed" / item["prompt_embed_path"])
        mask = None
        if "prompt_attention_mask" in item:
            mask = _load_tensor(self.root / "prompt_attention_mask" / item["prompt_attention_mask"])
        if self.cfg_rate > 0 and self._rng.random() < self.cfg_rate:
            embed = np.zeros_like(embed)
            if mask is not None:
                mask = np.concatenate([np.ones_like(mask[:1]), np.zeros_like(mask[1:])], axis=0)
        return latent, embed, mask

    @staticmethod
    def collate(samples):
        """Pad latents to the largest (T, H, W) of the batch and stack."""
        latents = [s[0] for s in samples]
        t, h, w = (max(x.shape[a] for x in latents) for a in range(3))
        padded = np.stack([
            np.pad(x, ((0, t - x.shape[0]), (0, h - x.shape[1]), (0, w - x.shape[2]), (0, 0)))
            for x in latents])
        embeds = np.stack([s[1] for s in samples])
        masks = np.stack([s[2] for s in samples]) if samples[0][2] is not None else None
        return padded, embeds, masks


def epoch_iterator(dataset: LatentDataset, batch_size: int, seed: int = 0,
                   drop_last: bool = True) -> Iterator:
    """Infinite shuffled iterator of collated batches."""
    epoch = 0
    while True:
        order = np.random.default_rng(seed + epoch).permutation(len(dataset))
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            yield LatentDataset.collate([dataset[int(i)] for i in idx])
        epoch += 1
