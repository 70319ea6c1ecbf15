"""Offline paired-dataset generation (counterpart of
``p2p_tpu/data/generate.py``): walk a source image directory, optionally
nearest-upsample each image, trim it to a multiple of the crop size, tile
it, and save each patch twice, the original to ``a/`` and its bit-depth
quantized copy to ``b/``, under ``<out>/<split>/{a,b}/``.

Images are read and written with the port's PNG codec (utils/images.py:
the C++ decoder, a stdlib writer; no Pillow), so the sources must be PNG
files; a file with another image extension raises with its name. The
patches hold the pixels the JAX package writes; the PNG bytes may
differ.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from typing import Optional

import numpy as np

from p2p_tpu_torch.data.synthetic import compress_uint8
from p2p_tpu_torch.utils.images import decode_png, encode_png

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def is_image_file(name: str) -> bool:
    """The JAX package's extension whitelist, case-insensitive."""
    return name.lower().endswith(IMG_EXTENSIONS)


def read_png(path: str) -> np.ndarray:
    """A PNG file as uint8 (h, w, 3) RGB; raises ``ValueError`` naming the
    file when it is not a PNG the port's decoder reads."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e} (the port reads PNG sources "
                         "only)") from None


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _tile(img: np.ndarray, crop: int, crop_w: Optional[int] = None
          ) -> np.ndarray:
    """Trim to a multiple of the crop and tile: (H, W, C) → (T, ch, cw,
    C), row-major over the tiles."""
    cw = crop_w or crop
    h, w, c = img.shape
    th, tw = (h // crop) * crop, (w // cw) * cw
    t = img[:th, :tw].reshape(th // crop, crop, tw // cw, cw, c)
    return t.transpose(0, 2, 1, 3, 4).reshape(-1, crop, cw, c)


def generate_patches(src_path: str, a_dir: str, b_dir: str,
                     crop_size: Optional[int] = 256, max_patches: int = 100,
                     bits: int = 3, upsample: int = 0, min_std: float = 0.0,
                     crop_width: Optional[int] = None) -> int:
    """Tile one source image into paired patches; returns how many were
    written. ``min_std`` (uint8 units) drops near-constant patches (under
    a per-sample norm a flat image has zero variance in every layer);
    ``crop_size=None`` keeps the whole image."""
    arr = read_png(src_path)
    if upsample > 0:
        # nearest ×upsample: Pillow's NEAREST at an integer factor
        scale = abs(upsample)
        arr = np.repeat(np.repeat(arr, scale, axis=0), scale, axis=1)
    if crop_size is None:
        tiles = [arr]
    else:
        cw = crop_width or crop_size
        if arr.shape[0] < crop_size or arr.shape[1] < cw:
            return 0
        tiles = _tile(arr, crop_size, crop_width)
        if min_std > 0:
            tiles = [t for t in tiles
                     if float(t.astype(np.float32).std()) >= min_std]
        tiles = tiles[:max_patches]
    stem = os.path.splitext(os.path.basename(src_path))[0]
    for i, patch in enumerate(tiles):
        name = f"{stem}_{i:04d}.png"
        write_png(os.path.join(a_dir, name), patch)
        write_png(os.path.join(b_dir, name), compress_uint8(patch, bits))
    return len(tiles)


def generate_dataset(src_dir: str, out_dir: str, split: str = "train",
                     crop_size: Optional[int] = 256, max_patches: int = 100,
                     bits: int = 3, upsample: int = 0, workers: int = 0,
                     min_std: float = 0.0,
                     crop_width: Optional[int] = None) -> int:
    """Generate ``<out_dir>/<split>/{a,b}/`` from every image in
    ``src_dir`` (sorted by name; ``workers`` processes when > 0); returns
    the number of pairs written."""
    a_dir = os.path.join(out_dir, split, "a")
    b_dir = os.path.join(out_dir, split, "b")
    os.makedirs(a_dir, exist_ok=True)
    os.makedirs(b_dir, exist_ok=True)
    if not os.path.isdir(src_dir):
        raise RuntimeError(f"source folder {src_dir!r} does not exist")
    sources = sorted(os.path.join(src_dir, f) for f in os.listdir(src_dir)
                     if is_image_file(f))
    args = [(s, a_dir, b_dir, crop_size, max_patches, bits, upsample,
             min_std, crop_width) for s in sources]
    if workers and len(sources) > 1:
        with ProcessPoolExecutor(max_workers=workers) as pool:
            counts = list(pool.map(_gen_star, args))
    else:
        counts = [_gen_star(a) for a in args]
    return int(sum(counts))


def _gen_star(args) -> int:
    return generate_patches(*args)
