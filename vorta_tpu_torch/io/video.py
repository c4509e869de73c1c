"""Host-side video export (counterpart of vorta_tpu/io/video.py, a copy:
numpy only; imageio and PIL are imported where they are used).

Frames arrive as (T, H, W, 3) float in [-1, 1] (VAE output) or uint8.
Export prefers mp4 (imageio/ffmpeg), falls back to GIF (PIL), and always
supports raw .npy.  Loading supports mp4/gif/image-dir like the reference.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def to_uint8(frames: np.ndarray) -> np.ndarray:
    frames = np.asarray(frames)
    if frames.dtype == np.uint8:
        return frames
    frames = np.clip((frames + 1.0) / 2.0, 0.0, 1.0)
    return (frames * 255).round().astype(np.uint8)


def save_video(frames, path, fps: int = 16) -> Path:
    """Save (T, H, W, 3) frames; format chosen by extension (.mp4/.gif/.npy)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".npy":
        np.save(path, np.asarray(frames))
        return path
    u8 = to_uint8(frames)
    if path.suffix == ".mp4":
        try:
            import imageio.v3 as iio

            iio.imwrite(path, u8, fps=fps, codec="libx264", quality=8)
            return path
        except Exception:
            path = path.with_suffix(".gif")  # fall through
    if path.suffix == ".gif":
        from PIL import Image

        imgs = [Image.fromarray(f) for f in u8]
        imgs[0].save(
            path, save_all=True, append_images=imgs[1:],
            duration=int(1000 / fps), loop=0,
        )
        return path
    raise ValueError(f"unsupported video extension {path.suffix}")


def load_video(path) -> np.ndarray:
    """Load video frames as (T, H, W, 3) uint8 from mp4/gif/npy/image dir."""
    path = Path(path)
    if path.is_dir():
        from PIL import Image

        files = sorted(p for p in path.iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
        return np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])
    if path.suffix == ".npy":
        return np.load(path)
    if path.suffix == ".gif":
        from PIL import Image, ImageSequence

        im = Image.open(path)
        return np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])
    import imageio.v3 as iio

    return np.asarray(iio.imread(path))


def prompt_to_file_name(prompt: str, max_len: int = 64) -> str:
    """Slugify a prompt for output naming (reference: misc.py:26-37)."""
    keep = "".join(c if c.isalnum() or c in " _-" else "" for c in prompt)
    return "_".join(keep.split())[:max_len] or "sample"
