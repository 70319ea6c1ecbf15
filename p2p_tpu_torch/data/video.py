"""Video clips (counterpart of ``p2p_tpu/data/video.py:26
VideoClipDataset`` and ``:89 make_synthetic_video_dataset``).

Layout: ``<root>/<split>/{a,b}/<video>/<frame>.png``, per-video frame
directories paired by video and frame name. Items are windows of
``n_frames`` consecutive frames (stride ``n_frames`` unless given), as
(T, H, W, C) dicts, float32 [-1, 1] or uint8 with ``dtype="uint8"``,
each frame decoded and fitted by data/pipeline.py ``load_image``; the
loaders stack them into (N, T, H, W, C) batches (data/pipeline.py
``make_loader``, ``device_prefetch``), which the video step views as
channels_last_3d clips. The synthetic clips (moving discs over a gradient
background, quantized ``b/`` stream) are the JAX package's pixels for the
same seed, written by the port's PNG writer.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from p2p_tpu_torch.data.generate import is_image_file, write_png
from p2p_tpu_torch.data.pipeline import load_image
from p2p_tpu_torch.data.synthetic import compress_uint8


class VideoClipDataset:
    """Random-access dataset of fixed-length clip windows."""

    def __init__(self, root: str, split: str = "train",
                 direction: str = "b2a", image_size: int = 256,
                 image_width: Optional[int] = None, n_frames: int = 8,
                 stride: Optional[int] = None, dtype: str = "float32"):
        if dtype not in ("float32", "uint8"):
            raise ValueError(f"dtype must be float32|uint8, got {dtype!r}")
        self.as_uint8 = dtype == "uint8"
        self.a_dir = os.path.join(root, split, "a")
        self.b_dir = os.path.join(root, split, "b")
        self.direction = direction
        self.h = image_size
        self.w = image_width or image_size
        self.n_frames = n_frames
        stride = stride or n_frames
        self.windows: List[Tuple[str, List[str]]] = []
        if not os.path.isdir(self.a_dir):
            raise RuntimeError(f"no video dir {self.a_dir}")
        for vid in sorted(os.listdir(self.a_dir)):
            vdir = os.path.join(self.a_dir, vid)
            if not os.path.isdir(vdir):
                continue
            frames = sorted(f for f in os.listdir(vdir) if is_image_file(f))
            for s in range(0, len(frames) - n_frames + 1, stride):
                self.windows.append((vid, frames[s:s + n_frames]))
        if not self.windows:
            raise RuntimeError(f"no {n_frames}-frame windows under "
                               f"{self.a_dir}")

    def __len__(self) -> int:
        return len(self.windows)

    def _clip(self, base: str, vid: str, frames: List[str]) -> np.ndarray:
        return np.stack([load_image(os.path.join(base, vid, f), self.h,
                                    self.w, self.as_uint8) for f in frames])

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        vid, frames = self.windows[idx.__index__()]
        a = self._clip(self.a_dir, vid, frames)
        b = self._clip(self.b_dir, vid, frames)
        if self.direction == "a2b":
            return {"input": a, "target": b}
        return {"input": b, "target": a}


def make_synthetic_video_dataset(out_dir: str, n_videos: int = 2,
                                 n_frames: int = 10, size: int = 32,
                                 bits: int = 3, seed: int = 0,
                                 splits: Tuple[str, ...] = ("train", "test")
                                 ) -> str:
    """Moving-disc clips: ``a/`` the originals, ``b/`` quantized to
    ``bits`` (paired by name), ``n_videos`` a split of ``n_frames``
    frames of ``size``²."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for split in splits:
        for v in range(n_videos):
            base = np.zeros((size, size, 3), np.float32)
            for c in range(3):
                fx, fy = rng.uniform(0.5, 2.0, 2)
                base[:, :, c] = 0.5 + 0.5 * np.sin(
                    2 * np.pi * (fx * xx / size + fy * yy / size))
            cx, cy = rng.uniform(size * 0.2, size * 0.8, 2)
            dx, dy = rng.uniform(-2, 2, 2)
            r = rng.uniform(size * 0.1, size * 0.25)
            color = rng.uniform(0, 1, 3)
            for t in range(n_frames):
                img = base.copy()
                px, py = cx + dx * t, cy + dy * t
                img[(yy - py) ** 2 + (xx - px) ** 2 < r ** 2] = color
                u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
                for stream, arr in (("a", u8),
                                    ("b", compress_uint8(u8, bits))):
                    d = os.path.join(out_dir, split, stream, f"v{v:03d}")
                    os.makedirs(d, exist_ok=True)
                    write_png(os.path.join(d, f"f{t:04d}.png"), arr)
    return out_dir
