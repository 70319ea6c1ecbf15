"""Image helpers (counterpart of ``p2p_tpu/utils/images.py:15 ingest`` and
``:39 to_uint8_img``) and a PNG writer built on the standard library
(zlib + struct), so serving writes its outputs without PIL.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np
import torch

# 1/127.5 rounded to f32 once: the scalar the JAX package multiplies by
_INV_127_5 = float(np.float32(1.0 / 127.5))


def ingest(x: torch.Tensor, dtype: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """uint8 [0, 255] → f32 [-1, 1] by ``(f32(u8) − 127.5)·(1/127.5)``, the
    exact f32 expression of the JAX package and of its host decoders (an
    exact subtraction, then one rounding multiply); float input passes
    through. Then cast to ``dtype`` when given."""
    if x.dtype == torch.uint8:
        x = (x.to(torch.float32) - 127.5) * _INV_127_5
    if dtype is not None:
        x = x.to(dtype)
    return x


def to_uint8_img(x) -> np.ndarray:
    """[-1, 1] float HWC → uint8 HWC as (x+1)/2·255, rounded and clipped.
    uint8 input passes through; a batch of one is unwrapped."""
    arr = np.asarray(x)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            raise ValueError(f"expected single image, got batch {arr.shape}")
        arr = arr[0]
    if arr.dtype == np.uint8:
        return arr
    arr = (arr.astype(np.float32) + 1.0) * 0.5 * 255.0
    return np.clip(np.round(arr), 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 HW (grey), HWC with C=3 (RGB) or C=4 (RGBA) → PNG bytes: 8 bits
    per sample, no interlace, filter 0 on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}.get(c)
    if color is None:
        raise ValueError(f"encode_png wants 1, 3 or 4 channels, got {c}")
    rows = np.zeros((h, 1 + w * c), np.uint8)   # leading filter byte 0
    rows[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def save_img(x, path: str) -> None:
    """[-1, 1] float HWC (or uint8) → PNG file at ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8_img(x)))
