"""Image helpers (counterpart of ``p2p_tpu/utils/images.py:15 ingest`` and
``:39 to_uint8_img``), a PNG writer and reader, and Pillow's bicubic
resize of ``p2p_tpu/data/pipeline.py:56-58 load_image``, byte for byte,
so serving and the data pipeline read and write images without Pillow.

:func:`decode_png` and :func:`resize_bicubic` run the C++ host image
library (``native/fastimage.cpp``). The decoder routes by format: an
8-bit RGB or RGBA PNG that is not interlaced (what the port's writer and
``generate_dataset`` write) is decoded in C++, every other PNG by the
numpy reader :func:`decode_png_plain`; the process registry
(obs/registry.py ``get_registry``) counts each route in
``png_decode_total{route="native"|"numpy"}``. :func:`decode_png_plain` and
:func:`resize_bicubic_plain` (numpy, standard library) are the plain
versions the tests hold the C++ code against.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np
import torch

from p2p_tpu_torch import native
from p2p_tpu_torch.obs.registry import get_registry

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


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each 8-bit colour type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunks(data: bytes):
    """Yield ``(type, payload)`` of every chunk, checking each CRC."""
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG truncated inside a chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"PNG truncated inside chunk {kind!r}")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} has a bad CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG truncated: no IEND chunk")


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth) of
    ``h`` rows of ``stride`` bytes, ``bpp`` bytes per pixel."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{h * (stride + 1)}")
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        ftype = raw[r * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, r * (stride + 1) + 1)
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: a running sum mod 256 per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its left
            cur = bytearray(line.tobytes())
            b = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + b[i]) >> 1
                else:
                    c = b[i - bpp] if i >= bpp else 0
                    p = a + b[i] - c
                    pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b[i] if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {r} has unknown filter type {ftype}")
        out[r] = cur
        prior = out[r]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 (h, w, 3) RGB, :func:`decode_png_plain`'s result:
    in C++ for an 8-bit RGB or RGBA, non-interlaced PNG, by the numpy
    reader for any other; each decode counted under its route. Raises
    ``ValueError`` on what neither reads."""
    arr = native.png_decode(data)
    route = "numpy" if arr is None else "native"
    get_registry().counter("png_decode_total", route=route).inc()
    return decode_png_plain(data) if arr is None else arr


def decode_png_plain(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 (h, w, 3) RGB: the inverse of :func:`encode_png`
    for every 8-bit non-interlaced colour type (0 grey, 2 RGB, 3 palette,
    4 grey + alpha, 6 RGBA), converted as Pillow's ``convert("RGB")`` does
    (grey repeated, alpha dropped, palette looked up). Raises
    ``ValueError`` on anything else: another bit depth, interlace, a
    truncated stream or a chunk with a bad CRC."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG (bad signature)")
    header, palette, idat = None, None, []
    for kind, payload in _png_chunks(data):
        if kind == b"IHDR":
            if len(payload) != 13:
                raise ValueError("PNG IHDR chunk is not 13 bytes")
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            if len(payload) % 3:
                raise ValueError("PNG PLTE chunk is not RGB triples")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{color} (only 8-bit types 0, 2, 3, 4, 6)")
    if interlace != 0 or compression != 0 or filt != 0:
        raise ValueError("unsupported PNG: interlaced or non-standard "
                         "compression/filter method")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    c = _PNG_CHANNELS[color]
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[img[:, :, 0]]
    if color in (0, 4):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


# fixed-point fraction bits of Pillow's 8-bit resampling weights
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel (a = −0.5), support 2."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resample_coeffs(in_size: int, out_size: int):
    """``(xmin, count, fixed)`` of one pass of Pillow's ``ImagingResample``
    from ``in_size`` to ``out_size`` (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): f64 weights of the kernel widened by the
    downscale factor, normalized to sum 1 in the kernel's order, rounded to
    22-bit fixed point; output j reads ``count[j]`` inputs from
    ``xmin[j]`` with the first ``count[j]`` entries of ``fixed[j]``."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64),
                       in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
                 / filterscale)
    w = np.where(taps[None, :] < count[:, None], w, 0.0)
    total = np.zeros(out_size)
    for k in range(ksize):            # Pillow's order of the f64 sum
        total += w[:, k]
    w = np.where(total[:, None] != 0.0,
                 w / np.where(total != 0.0, total, 1.0)[:, None], w)
    fixed = (w * (1 << _PRECISION_BITS)
             + np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    return xmin, count, fixed


def _resample_axis_plain(img: np.ndarray, axis: int, out_size: int
                         ) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` of a uint8 (H, W,
    C) image in numpy: the integer sums of :func:`_resample_coeffs`'
    windows rounded at the half and clamped to 0..255."""
    in_size = img.shape[axis]
    xmin, count, fixed = _resample_coeffs(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(fixed.shape[1])[None, :],
                     in_size - 1)
    src = np.take(img.astype(np.int64), idx, axis=axis)
    if axis == 1:                      # (H, out, k, C)
        acc = (src * fixed[None, :, :, None]).sum(axis=2)
    else:                              # (out, k, W, C)
        acc = (src * fixed[:, :, None, None]).sum(axis=1)
    acc += 1 << (_PRECISION_BITS - 1)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """:func:`_resample_axis_plain` with the integer loop in C++
    (``native.resample_axis``) on the same coefficients."""
    return native.resample_axis(img, axis,
                                *_resample_coeffs(img.shape[axis], out_size))


def _resize(img: np.ndarray, h: int, w: int, resample) -> np.ndarray:
    out = np.asarray(img, np.uint8)
    if out.shape[1] != w:
        out = resample(out, 1, w)
    if out.shape[0] != h:
        out = resample(out, 0, h)
    return np.ascontiguousarray(out)


def resize_bicubic(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 (H, W, C) → uint8 (h, w, C) with the same bytes as Pillow's
    ``Image.resize((w, h), Image.BICUBIC)``, which the JAX ``load_image``
    uses: the width is resampled first, then the height, each pass only
    where the size changes, the integer loop in C++
    (:func:`_resample_axis`)."""
    return _resize(img, h, w, _resample_axis)


def resize_bicubic_plain(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """:func:`resize_bicubic` in numpy (:func:`_resample_axis_plain`)."""
    return _resize(img, h, w, _resample_axis_plain)
