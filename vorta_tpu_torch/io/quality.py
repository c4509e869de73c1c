"""Quality metrics of the baseline-vs-routed comparison (the port's own copy
of vorta_tpu/io/quality.py, the same numbers).

  * psnr      — on latents or decoded frames
  * ssim      — windowed SSIM (uniform 7x7 window) per 2-D plane, averaged
                over the leading axes
  * lpips     — perceptual distance through the ``lpips`` package's net when
                its weights are given (``weights_path``), else None
  * temporal_flicker / temporal_consistency / highfreq_energy_ratio — the
                weight-free video metrics reported beside PSNR / SSIM
  * routing_mix — expert usage fractions from per-step routing scores
  * vbench_scaffold — the VBench dimensions' schema, every value None until
                the official scorers and prompt suite are at hand

Everything is numpy in float64, as in the JAX package.  The functions also
take CPU or CUDA tensors, which they copy to the host first.  One quirk is
kept for parity: ``ssim`` moves a trailing channel axis first only when it
is smaller than 8, so 16-channel latents (B, T, H, W, 16) are averaged over
their (W, C) planes, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (a tensor on any device is copied to the host;
    bf16 and f16, which numpy lacks, as f32)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.dtype.is_floating_point and x.dtype.itemsize < 4:
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


def psnr(a, b) -> float:
    """PSNR in dB with the peak taken from the data range of the pair."""
    a, b = _host(a), _host(b)
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    peak = float(max(np.abs(a).max(), np.abs(b).max()))
    return 10.0 * np.log10(peak * peak / mse)


def _ssim_2d(a: np.ndarray, b: np.ndarray, win: int, data_range: float) -> float:
    """SSIM of two 2-D float64 images with a uniform ``win`` x ``win``
    window (the image's smaller side where it is smaller than ``win``)."""
    from numpy.lib.stride_tricks import sliding_window_view

    if a.shape[0] < win or a.shape[1] < win:
        win = min(a.shape[0], a.shape[1])
    wa = sliding_window_view(a, (win, win)).reshape(-1, win * win)
    wb = sliding_window_view(b, (win, win)).reshape(-1, win * win)
    mu_a = wa.mean(axis=1)
    mu_b = wb.mean(axis=1)
    var_a = wa.var(axis=1)
    var_b = wb.var(axis=1)
    cov = (wa * wb).mean(axis=1) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def ssim(a, b, win: int = 7) -> float:
    """Mean SSIM over the leading axes of two (..., H, W) arrays; a trailing
    axis smaller than 8 (channels) is moved first."""
    a = np.asarray(_host(a), np.float64)
    b = np.asarray(_host(b), np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if a.ndim >= 3 and a.shape[-1] < 8 <= a.shape[-2]:
        a = np.moveaxis(a, -1, 0)
        b = np.moveaxis(b, -1, 0)
    a2 = a.reshape((-1,) + a.shape[-2:])
    b2 = b.reshape((-1,) + b.shape[-2:])
    rng = float(max(a.max() - a.min(), b.max() - b.min(), 1e-8))
    vals = [_ssim_2d(a2[i], b2[i], win, rng) for i in range(a2.shape[0])]
    return float(np.mean(vals))


def lpips(a, b, weights_path: Optional[str] = None) -> Optional[float]:
    """LPIPS distance of (T, H, W, 3) frames in [0, 1] through the ``lpips``
    package's AlexNet with the weights at ``weights_path``; None without
    weights or without the package."""
    if weights_path is None:
        return None
    try:
        import lpips as lpips_pkg
    except ImportError:
        return None
    import torch

    net = lpips_pkg.LPIPS(net="alex", model_path=weights_path)
    ta = torch.from_numpy(np.moveaxis(_host(a), -1, 1).astype(np.float32)) * 2 - 1
    tb = torch.from_numpy(np.moveaxis(_host(b), -1, 1).astype(np.float32)) * 2 - 1
    with torch.no_grad():
        return float(net(ta, tb).mean())


def _video(x) -> np.ndarray:
    """(T, ...) float64: latents (B, T, H, W, C) give their first sample."""
    x = np.asarray(_host(x), np.float64)
    return x[0] if x.ndim == 5 else x


def temporal_flicker(x) -> float:
    """Mean |frame-to-frame difference| over the mean |value| (lower =
    smoother); latents (B, T, H, W, C) or frames (T, H, W, C)."""
    x = _video(x)
    d = np.abs(np.diff(x, axis=0)).mean()
    return float(d / (np.abs(x).mean() + 1e-12))


def temporal_consistency(a, b) -> float:
    """Pearson correlation of the two videos' per-step frame-difference
    energies; 1.0 where both are flat (or shorter than two steps), 0.0 where
    only one is."""
    def profile(x):
        x = _video(x)
        return np.abs(np.diff(x, axis=0)).mean(axis=tuple(range(1, x.ndim)))

    pa, pb = profile(a), profile(b)
    if pa.size < 2:
        return 1.0
    sa, sb = pa.std(), pb.std()
    if sa < 1e-12 or sb < 1e-12:
        return 1.0 if sa < 1e-12 and sb < 1e-12 else 0.0
    return float(np.corrcoef(pa, pb)[0, 1])


def highfreq_energy_ratio(a, b) -> float:
    """High-spatial-frequency energy of ``a`` over the baseline ``b``'s (the
    outer half of each frame's 2-D DFT radius; 1.0 = detail kept)."""
    def hf(x):
        x = _video(x)
        if x.ndim == 4:  # (T, H, W, C) -> C folded into T
            x = np.moveaxis(x, -1, 1).reshape(-1, x.shape[1], x.shape[2])
        f = np.fft.fftshift(np.fft.fft2(x, axes=(-2, -1)), axes=(-2, -1))
        h, w = x.shape[-2:]
        yy, xx = np.mgrid[:h, :w]
        r = np.hypot((yy - h / 2) / (h / 2), (xx - w / 2) / (w / 2))
        band = r >= 0.5
        return float((np.abs(f) ** 2)[..., band].sum())

    return float(hf(a) / max(hf(b), 1e-12))


def weightfree_video_metrics(sample, baseline) -> Dict[str, float]:
    """Flicker of both, temporal consistency and the high-frequency ratio,
    each rounded to 4 places."""
    return {
        "flicker_sample": round(temporal_flicker(sample), 4),
        "flicker_baseline": round(temporal_flicker(baseline), 4),
        "temporal_consistency": round(temporal_consistency(sample, baseline), 4),
        "highfreq_energy_ratio": round(highfreq_energy_ratio(sample, baseline), 4),
    }


def routing_mix(scores, tau: float) -> Dict[str, float]:
    """Expert usage fractions (full, lowres, sta) of the first batch row of
    (steps, layers, B, H, 3) routing scores: top-1 per (step, layer, head),
    full where the top score is under ``tau``."""
    s = _host(scores)
    s0 = s[..., 0, :, :]
    top = s0.max(axis=-1)
    idx = s0.argmax(axis=-1)
    idx = np.where(top < tau, 0, idx)
    n = idx.size
    return {
        "full": round(float((idx == 0).sum()) / n, 4),
        "lowres": round(float((idx == 1).sum()) / n, 4),
        "sta": round(float((idx == 2).sum()) / n, 4),
    }


def vbench_scaffold() -> Dict[str, Optional[float]]:
    """The VBench dimensions, each None (the scorers are not at hand)."""
    return {dim: None for dim in (
        "subject_consistency", "background_consistency", "motion_smoothness",
        "dynamic_degree", "aesthetic_quality", "imaging_quality",
    )}
