"""Synthetic paired data (counterpart of ``p2p_tpu/data/synthetic.py:21
_synthetic_image`` and ``:71 synthetic_batch``, with
``p2p_tpu/data/generate.py:33 compress_uint8``), numpy only.

Procedural RGB images (smooth gradients, rectangles and disks) and their
bit-depth-quantized copies, the same draws from the same seed as the JAX
package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def compress_uint8(img: np.ndarray, bits: int = 3) -> np.ndarray:
    """Bit-depth quantization of a uint8 image: x/255 → round(x·(2^b−1)) /
    (2^b−1) → ·255."""
    n = float(2 ** bits - 1)
    x = img.astype(np.float32) / 255.0
    q = np.round(np.clip(x, 0.0, 1.0) * n) / n
    return np.round(q * 255.0).astype(np.uint8)


def _synthetic_image(rng: np.random.Generator, size: Tuple[int, int]
                     ) -> np.ndarray:
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    # smooth background gradient with random orientation/phase per channel
    for c in range(3):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        phase = rng.uniform(0, 2 * np.pi)
        img[:, :, c] = 0.5 + 0.5 * np.sin(
            2 * np.pi * (fx * xx / w + fy * yy / h) + phase)
    for _ in range(rng.integers(3, 8)):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        y1, x1 = y0 + rng.integers(4, h // 2), x0 + rng.integers(4, w // 2)
        img[y0:y1, x0:x1] = rng.uniform(0, 1, 3)
    for _ in range(rng.integers(2, 6)):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(3, max(4, h // 6))
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        img[mask] = rng.uniform(0, 1, 3)
    return (img * 255).astype(np.uint8)


def synthetic_batch(batch_size: int = 1, size: int = 64, bits: int = 3,
                    seed: int = 0, width: Optional[int] = None,
                    dtype: str = "float32") -> Dict[str, np.ndarray]:
    """``{"input", "target"}`` NHWC batch in the b2a direction: the target
    is a procedural image, the input its quantized copy. float32 in
    [−1, 1] by ``(x − 127.5)·(1/127.5)``, or raw uint8 with
    ``dtype="uint8"``."""
    rng = np.random.default_rng(seed)
    targets = np.stack([_synthetic_image(rng, (size, width or size))
                        for _ in range(batch_size)])
    inputs = np.stack([compress_uint8(t, bits) for t in targets])
    if dtype == "uint8":
        return {"input": inputs, "target": targets}

    def to_f(x):
        return ((x.astype(np.float32) - np.float32(127.5))
                * np.float32(1.0 / 127.5))

    return {"input": to_f(inputs), "target": to_f(targets)}
