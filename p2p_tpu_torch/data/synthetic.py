"""Synthetic paired data (counterpart of ``p2p_tpu/data/synthetic.py:21
_synthetic_image``, ``:46 make_synthetic_dataset`` and ``:71
synthetic_batch``, with ``p2p_tpu/data/generate.py:33 compress_uint8``),
numpy and the port's PNG writer only.

Procedural RGB images (smooth gradients, rectangles and disks) and their
bit-depth-quantized copies, the same draws from the same seed as the JAX
package; and facades-shaped pairs (:func:`synthetic_facades_batch`): a
label map of a building front in flat class colours as the input, a
shaded photo-like rendering of it as the target, as the ``facades``
preset translates labels to photos; and street-scene pairs of the
``pix2pixhd`` preset's shape (:func:`synthetic_hd_batch`), a semantic
label map in Cityscapes class colours and its rendering, 512×1024.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from p2p_tpu_torch.utils.images import encode_png


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


def make_synthetic_dataset(out_dir: str, n_train: int = 8, n_test: int = 4,
                           size: int = 64, bits: int = 3, seed: int = 0
                           ) -> str:
    """Write ``<out_dir>/{train,test}/{a,b}/synth_<i>.png``: procedural
    images in ``a/`` and their quantized copies in ``b/``, the same images
    as the JAX package draws from the same seed (the PNG bytes may differ,
    the pixels do not). Returns ``out_dir``."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        a_dir = os.path.join(out_dir, split, "a")
        b_dir = os.path.join(out_dir, split, "b")
        os.makedirs(a_dir, exist_ok=True)
        os.makedirs(b_dir, exist_ok=True)
        for i in range(n):
            img = _synthetic_image(rng, (size, size))
            name = f"synth_{i:04d}.png"
            for d, arr in ((a_dir, img), (b_dir, compress_uint8(img, bits))):
                with open(os.path.join(d, name), "wb") as f:
                    f.write(encode_png(arr))
    return out_dir


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


# colours of the 12 CMP Facade classes in the label images: background,
# facade, window, door, cornice, sill, balcony, blind, deco, molding,
# pillar, shop
FACADE_PALETTE = np.array(
    [[0, 0, 170], [0, 0, 255], [0, 85, 255], [0, 170, 255], [0, 255, 255],
     [85, 255, 170], [170, 255, 85], [255, 255, 0], [255, 170, 0],
     [255, 85, 0], [255, 0, 0], [170, 0, 0]], np.uint8)


def _facade_labels(rng: np.random.Generator, size: int) -> np.ndarray:
    """(size, size) class indices: a facade with a cornice, rows of
    windows with sills and blinds, a door or a shop front, pillars."""
    lab = np.zeros((size, size), np.int64)
    top = int(rng.integers(0, size // 8))
    lab[top:, :] = 1
    lab[top:top + max(2, size // 32), :] = 4                 # cornice
    rows, cols = int(rng.integers(3, 6)), int(rng.integers(3, 6))
    cell_h = (size - top) // (rows + 1)
    cell_w = size // cols
    for r in range(rows):
        for c in range(cols):
            y0 = top + r * cell_h + cell_h // 4
            x0 = c * cell_w + cell_w // 4
            y1, x1 = y0 + cell_h // 2, x0 + cell_w // 2
            lab[y0:y1, x0:x1] = 2                            # window
            if rng.uniform() < 0.3:
                lab[y0:y0 + (y1 - y0) // 3, x0:x1] = 7       # blind
            lab[y1:y1 + max(1, size // 64), x0:x1] = 5       # sill
            if r == 1 and rng.uniform() < 0.4:
                lab[y1 - 2:y1 + 3, x0 - 2:x1 + 2] = 6        # balcony
    for c in range(1, cols):
        lab[top:, c * cell_w - 1:c * cell_w + 1] = 10        # pillar
    gy = top + rows * cell_h
    if rng.uniform() < 0.5:
        lab[gy:, :] = 11                                     # shop
    else:
        d0 = int(rng.integers(0, size - size // 6))
        lab[gy:, d0:d0 + size // 6] = 3                      # door
    lab[gy - 2:gy, :] = 9                                    # molding
    return lab


def synthetic_facades_batch(batch_size: int = 1, size: int = 256,
                            seed: int = 0) -> Dict[str, np.ndarray]:
    """``{"input", "target"}`` uint8 NHWC pairs at ``size``²: the input a
    label map in :data:`FACADE_PALETTE` colours, the target a rendering of
    it (a colour per class drawn from ``seed``, vertical light falloff,
    per-pixel noise)."""
    rng = np.random.default_rng(seed)
    inputs, targets = [], []
    yy = np.linspace(1.0, 0.7, size, dtype=np.float32)[:, None, None]
    for _ in range(batch_size):
        lab = _facade_labels(rng, size)
        colours = rng.uniform(40, 220, (len(FACADE_PALETTE), 3))
        photo = colours[lab] * yy + rng.normal(0, 6, (size, size, 3))
        inputs.append(FACADE_PALETTE[lab])
        targets.append(np.clip(np.round(photo), 0, 255).astype(np.uint8))
    return {"input": np.stack(inputs), "target": np.stack(targets)}


# Cityscapes colours of the classes a street scene draws: road, sidewalk,
# building, pole, vegetation, sky, person, car
STREET_PALETTE = np.array(
    [[128, 64, 128], [244, 35, 232], [70, 70, 70], [153, 153, 153],
     [107, 142, 35], [70, 130, 180], [220, 20, 60], [0, 0, 142]], np.uint8)


def _street_labels(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w) class indices: sky over a skyline of buildings and trees, a
    sidewalk and a road below the horizon, poles, cars and people."""
    lab = np.full((h, w), 5, np.int64)                       # sky
    horizon = int(rng.integers(h * 2 // 5, h // 2))
    x = 0
    while x < w:                                             # skyline
        bw = int(rng.integers(w // 16, w // 5))
        top = int(rng.integers(h // 16, horizon - h // 16))
        lab[top:horizon, x:x + bw] = 2 if rng.uniform() < 0.75 else 4
        x += bw
    lab[horizon:, :] = 0                                     # road
    lab[horizon:horizon + h // 10, :] = 1                    # sidewalk
    for _ in range(int(rng.integers(3, 8))):                 # poles
        px = int(rng.integers(0, w - 4))
        lab[int(rng.integers(h // 8, horizon)):horizon + h // 10,
            px:px + max(2, w // 256)] = 3
    for _ in range(int(rng.integers(2, 6))):                 # cars
        cy = int(rng.integers(horizon + h // 10, h - h // 8))
        cw = int(rng.integers(w // 12, w // 6))
        cx = int(rng.integers(0, w - cw))
        lab[cy:cy + cw * 2 // 5, cx:cx + cw] = 7
    for _ in range(int(rng.integers(2, 7))):                 # people
        py = int(rng.integers(horizon - h // 10, horizon + h // 20))
        px = int(rng.integers(0, w - w // 64))
        lab[py:py + h // 8, px:px + max(2, w // 80)] = 6
    return lab


def synthetic_hd_batch(batch_size: int = 1, height: int = 512,
                       width: int = 1024, seed: int = 0,
                       dtype: str = "uint8") -> Dict[str, np.ndarray]:
    """``{"input", "target"}`` NHWC street-scene pairs (the ``pix2pixhd``
    preset's 512×1024 by default): the input a label map in
    :data:`STREET_PALETTE` colours, the target a rendering of it (a colour
    per class drawn from ``seed``, vertical light falloff, per-pixel
    noise). uint8, or float32 in [−1, 1] with ``dtype="float32"``."""
    if dtype not in ("uint8", "float32"):
        raise ValueError(f"dtype must be 'uint8' or 'float32', got {dtype!r}")
    rng = np.random.default_rng(seed)
    inputs, targets = [], []
    shade = np.linspace(1.0, 0.75, height, dtype=np.float32)[:, None, None]
    for _ in range(batch_size):
        lab = _street_labels(rng, height, width)
        colours = rng.uniform(30, 230, (len(STREET_PALETTE), 3))
        photo = colours[lab] * shade + rng.normal(0, 6, (height, width, 3))
        inputs.append(STREET_PALETTE[lab])
        targets.append(np.clip(np.round(photo), 0, 255).astype(np.uint8))
    out = {"input": np.stack(inputs), "target": np.stack(targets)}
    if dtype == "uint8":
        return out
    return {k: (v.astype(np.float32) - np.float32(127.5))
            * np.float32(1.0 / 127.5) for k, v in out.items()}
