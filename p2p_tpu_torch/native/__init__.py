"""The host image path in C++ (counterpart of ``p2p_tpu/native``): PNG
decode, the 8-bit inner loop of Pillow's bicubic resample and the [-1, 1]
normalize of ``fastimage.cpp``, bound through :mod:`ctypes`.

The host ``g++`` (``-O3 -shared -fPIC``, linked with ``-lz``) builds the
library at first use into the kernel build directory
(``ops/cuda/build.build_dir()``: ``build/torch_ext/`` of the checkout, or the
``--compilation_cache`` directory), named by a hash of the source, the
compiler and the flags, and renamed into place when complete, so worker
processes that start together never load a half-written file. A failed
build or a library that does not load raises: nothing falls back to the
numpy versions of ``utils/images.py``, which are the plain versions the
tests hold these against.

``utils/images.decode_png`` and ``resize_bicubic`` call this module; a
PNG that :func:`png_decode` does not read (anything but 8-bit RGB/RGBA,
not interlaced) goes to the numpy reader there, by format.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastimage.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz",)

_P = ctypes.c_void_p
_L = ctypes.c_int64
_LP = ctypes.POINTER(ctypes.c_int64)
SIGNATURES = {
    "png_probe": ((_P, _L, _LP, _LP), ctypes.c_int),
    "png_decode": ((_P, _L, _P, _L, _L), ctypes.c_int),
    "resample_u8": ((_P, _L, _L, _L, ctypes.c_int, _L, _P, _P, _P, _L, _P),
                    ctypes.c_int),
    "normalize_f32": ((_P, _P, _L), None),
}
# png_decode's error codes (fastimage.cpp)
_ERRORS = {
    -2: "PNG IHDR chunk missing or changed",
    -4: "PNG image data does not inflate",
    -5: "PNG image data inflates to the wrong size",
    -6: "PNG row has an unknown filter type",
    -7: "PNG chunk has a bad CRC",
    -8: "PNG truncated inside a chunk or before its IEND chunk",
    -9: "PNG too large to decode (out of memory)",
    -10: "PNG header claims more pixels than its image data can hold",
}
# deflate's largest ratio of inflated to compressed bytes (fastimage.cpp)
MAX_INFLATE = 1032


def find_cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++) on PATH; the host "
                           "image library cannot be built")
    return cxx


def library_path(cxx: str, directory: Path) -> Path:
    """The library's file in ``directory``, named by a hash of the source,
    the compiler and its flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx,) + CXX_FLAGS + LIBS).encode())
    return directory / f"libfastimage-{h.hexdigest()[:16]}.so"


def build(cxx: str, out: Path) -> None:
    """Compile ``fastimage.cpp`` into ``out`` (through a private temporary
    file, renamed into place); raises ``RuntimeError`` with the compiler's
    output when it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                           *LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The host image library of the current build directory (built there
    on first use), its argtypes set. Locked: loader threads and serving
    threads may make the first call together."""
    from p2p_tpu_torch.ops.cuda.build import build_dir

    with _LOCK:
        return _library(str(build_dir()))


@functools.cache
def _library(directory: str) -> ctypes.CDLL:
    cxx = find_cxx()
    path = library_path(cxx, Path(directory))
    if not path.exists():
        build(cxx, path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def png_decode(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes → uint8 (h, w, 3) RGB, or None when this decoder does not
    read the format (anything but an 8-bit RGB or RGBA, non-interlaced PNG
    whose first chunk is its IHDR). Raises ``ValueError`` on a file it
    reads the header of and cannot decode (a bad CRC, truncation, data
    that does not inflate, or a header that claims more pixels than the
    file's bytes can inflate to, which is refused before anything of the
    claimed size is allocated)."""
    lib = library()
    buf = bytes(data)
    w, h = ctypes.c_int64(), ctypes.c_int64()
    if lib.png_probe(buf, len(buf), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    # the image data is part of the file, each row at least 3w + 1 bytes
    if (3 * w.value + 1) * h.value > MAX_INFLATE * len(buf):
        raise ValueError(_ERRORS[-10])
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.png_decode(buf, len(buf), _ptr(out), w.value, h.value)
    if rc != 0:
        raise ValueError(_ERRORS.get(rc, f"PNG decode error {rc}"))
    return out


def resample_axis(img: np.ndarray, axis: int, xmin: np.ndarray,
                  count: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` (0 or 1) of a
    uint8 (H, W, C) image, on the window starts ``xmin``, tap counts
    ``count`` and (out, ksize) fixed-point ``coeffs`` of
    ``utils/images._resample_coeffs``."""
    if img.dtype != np.uint8 or img.ndim != 3 or axis not in (0, 1):
        raise ValueError(f"resample_axis wants uint8 (H, W, C) and axis 0 "
                         f"or 1, got {img.dtype} {img.shape}, axis {axis}")
    img = np.ascontiguousarray(img)
    xmin = np.ascontiguousarray(xmin, np.int64)
    count = np.ascontiguousarray(count, np.int64)
    coeffs = np.ascontiguousarray(coeffs, np.int64)
    out_size, ksize = coeffs.shape
    in_size = img.shape[axis]
    if (xmin.shape != (out_size,) or count.shape != (out_size,)
            or (xmin < 0).any() or (count < 0).any() or (count > ksize).any()
            or (xmin + count > in_size).any()):
        raise ValueError("resample_axis: windows out of the image's bounds")
    h, w, c = img.shape
    shape = (h, out_size, c) if axis == 1 else (out_size, w, c)
    out = np.empty(shape, np.uint8)
    library().resample_u8(_ptr(img), h, w, c, axis, out_size, _ptr(xmin),
                          _ptr(count), _ptr(coeffs), ksize, _ptr(out))
    return out


def normalize_f32(img: np.ndarray) -> np.ndarray:
    """uint8 → float32 [-1, 1] as ``(x − 127.5)·(1/127.5)``."""
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.float32)
    library().normalize_f32(_ptr(img), _ptr(out), img.size)
    return out
