"""The port's host image path in C++ (p2p_tpu_torch/native/) against its
plain versions and Pillow, with no tolerance: PNG decode for every row
filter, RGB and RGBA, odd widths; the routing of the PNGs the C++ decoder
does not read to the numpy reader, counted per route; Pillow's bicubic
resize up and down; the [-1, 1] normalize; a build or load failure raises;
and the loader's worker processes give the batches of the in-process
loader, in order, skips included."""

import io
import os
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from chip_smoke import filtered_png
from p2p_tpu_torch import native
from p2p_tpu_torch.core import cache
from p2p_tpu_torch.ops.cuda.build import build_dir
from p2p_tpu_torch.data.pipeline import (LoaderWorkers, PairedImageDataset,
                                         make_loader)
from p2p_tpu_torch.obs.registry import get_registry
from p2p_tpu_torch.utils.images import (decode_png, decode_png_plain,
                                        encode_png, resize_bicubic,
                                        resize_bicubic_plain)

Image = pytest.importorskip("PIL.Image")

torch.set_num_threads(1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _routes():
    snap = get_registry().snapshot()
    return {r: snap.get(f"png_decode_total{{route={r}}}", {}).get("value", 0)
            for r in ("native", "numpy")}


def _smooth(shape, seed):
    """An image with the structure row filters are made for."""
    x = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    return np.cumsum(x, axis=1, dtype=np.uint8)


@pytest.mark.parametrize("filters,channels,width", [
    ((4,), 3, 64), ((3,), 3, 64), ((0, 1, 2, 3, 4), 3, 33),
    ((4, 3, 2, 1, 0), 4, 17), ((1,), 4, 1), ((2, 4), 3, 5)])
def test_native_decode_is_the_plain_decode_and_pillows(filters, channels,
                                                       width):
    img = _smooth((13, width, channels), seed=width + channels)
    data = filtered_png(img, filters)
    before = _routes()
    got = decode_png(data)
    assert _routes()["native"] == before["native"] + 1
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == img.shape[:2] + (3,)
    np.testing.assert_array_equal(got, decode_png_plain(data))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img[:, :, :3])


@pytest.mark.parametrize("mode,optimize", [("L", False), ("P", True),
                                           ("LA", False), ("RGB", True)])
def test_pillows_pngs_take_the_route_of_their_format(mode, optimize):
    img = Image.fromarray(_smooth((9, 11, 3), seed=3)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG", optimize=optimize)
    before = _routes()
    got = decode_png(buf.getvalue())
    route = "native" if mode == "RGB" else "numpy"
    after = _routes()
    assert after[route] == before[route] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    np.testing.assert_array_equal(got, np.asarray(img.convert("RGB")))


def test_pngs_neither_reader_reads_raise():
    def header(depth, interlace):
        ihdr = struct.pack(">IIBBBBB", 2, 2, depth, 2, 0, 0, interlace)
        return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(bytes(26)))
                + _chunk(b"IEND", b""))

    before = _routes()
    for data, match in ((header(16, 0), "bit depth 16"),
                        (header(8, 1), "interlaced")):
        with pytest.raises(ValueError, match=match):
            decode_png(data)
    assert _routes()["numpy"] == before["numpy"] + 2
    good = filtered_png(_smooth((4, 4, 3), 0), (4,))
    bad = bytearray(good)
    bad[45] ^= 0xFF                                   # inside IDAT
    for data, match in ((good[:-20], "truncated"), (bytes(bad), "CRC"),
                        (good[:-12], "IEND")):
        with pytest.raises(ValueError, match=match):
            decode_png(data)


# run in a process of its own: its address space capped 256 MiB above
# what it holds once the library is loaded, where an allocation of the
# claimed size fails; exit 0 when both refusals came, else which did not
_REFUSAL_CHILD = """
import os, resource, sys
import numpy as np
from p2p_tpu_torch import native
data, w, h = bytes.fromhex(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
lib = native._library(sys.argv[4])      # the parent's build directory, so
native.library = lambda: lib            # the child needs no torch import
assert "torch" not in sys.modules
with open("/proc/self/statm") as f:
    vm = int(f.read().split()[0]) * os.sysconf("SC_PAGE_SIZE")
resource.setrlimit(resource.RLIMIT_AS,
                   (vm + (256 << 20), resource.getrlimit(resource.RLIMIT_AS)[1]))
try:
    native.png_decode(data)
    sys.exit("png_decode read it")
except ValueError as e:
    if "claims more pixels" not in str(e):
        sys.exit(f"png_decode: {e}")
one = np.zeros(1, np.uint8)
rc = lib.png_decode(data, len(data), one.ctypes.data, w, h)
sys.exit(0 if rc == -10 else f"png_decode returned {rc}")
"""


@pytest.mark.parametrize("w,h,color", [(60000, 60000, 6),
                                       (2**32 - 1, 2**32 - 1, 2)])
def test_a_header_claiming_more_than_its_data_is_refused_unallocated(
        w, h, color):
    """A PNG of under 100 bytes whose IHDR claims up to 14.4 GB of rows is
    refused before anything of that size is allocated, both by
    ``native.png_decode`` (which ``decode_png`` calls first) and by the
    C++ ``png_decode`` alone (given a one-byte output), in a process whose
    address space leaves no room for such an allocation."""
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(64)))
            + _chunk(b"IEND", b""))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    native.library()                              # built here
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSAL_CHILD, data.hex(), str(w), str(h),
         str(build_dir())],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_the_densest_real_image_data_is_not_refused():
    """An all-zero 1200 × 1600 image deflates near zlib's largest ratio and
    still decodes (the refusal's bound is deflate's, with no margin
    taken from real files)."""
    img = np.zeros((1200, 1600, 3), np.uint8)
    data = zlib.compress(np.zeros(1200 * (1600 * 3 + 1), np.uint8), 9)
    ihdr = struct.pack(">IIBBBBB", 1600, 1200, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
           + _chunk(b"IDAT", data) + _chunk(b"IEND", b""))
    assert img.size / len(data) > 1000
    np.testing.assert_array_equal(decode_png(png), img)


@pytest.mark.parametrize("src,dst", [((512, 1024), (256, 512)),
                                     ((64, 32), (143, 286)),
                                     ((67, 91), (256, 256)),
                                     ((120, 170), (100, 300)),
                                     ((33, 17), (17, 33)), ((5, 7), (5, 3))])
def test_native_resize_is_the_plain_resize_and_pillows(src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,),
                                                   dtype=np.uint8)
    h, w = dst
    got = resize_bicubic(img, h, w)
    want = np.asarray(Image.fromarray(img).resize((w, h), Image.BICUBIC))
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, resize_bicubic_plain(img, h, w))
    np.testing.assert_array_equal(got, want)


def test_native_normalize_is_the_pipelines_expression():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = (u8.astype(np.float32) - np.float32(127.5)) * np.float32(1 / 127.5)
    np.testing.assert_array_equal(native.normalize_f32(u8).view(np.uint32),
                                  want.view(np.uint32))


def test_a_failed_build_or_load_raises(tmp_path, monkeypatch):
    data = encode_png(np.zeros((2, 2, 3), np.uint8))
    cxx = native.find_cxx()
    monkeypatch.setattr(cache, "_enabled_dir", str(tmp_path / "built"))
    with monkeypatch.context() as m:                  # a compiler that fails
        m.setattr(native, "find_cxx", lambda: shutil.which("false"))
        with pytest.raises(RuntimeError, match="failed for fastimage.cpp"):
            decode_png(data)
    monkeypatch.setattr(cache, "_enabled_dir", str(tmp_path / "none"))
    with monkeypatch.context() as m:                  # no compiler
        m.setattr(native.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="no host C"):
            decode_png(data)
    junk = tmp_path / "junk"
    junk.mkdir()
    native.library_path(cxx, junk).write_bytes(b"not a lib")
    monkeypatch.setattr(cache, "_enabled_dir", str(junk))
    with pytest.raises(OSError):
        decode_png(data)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k])


def test_loader_workers_give_the_in_process_batches_in_order(tmp_path):
    """A pool of worker processes kept across epochs (as the trainer keeps
    it) gives the in-process loader's batches, in order: over two epochs
    of one loader with a skip, through a pass left part way and a change
    of ``aug_seed`` between epochs, with the same processes throughout."""
    rng = np.random.default_rng(5)
    for side in "ab":
        os.makedirs(tmp_path / "train" / side)
    for i in range(70):
        for side in "ab":
            (tmp_path / "train" / side / f"{i:03d}.png").write_bytes(
                encode_png(rng.integers(0, 256, (9, 12, 3), np.uint8)))
    ds = PairedImageDataset(str(tmp_path), "train", image_size=8,
                            image_width=10, augment=True, cache=False)
    pool = LoaderWorkers(ds, 2)
    try:
        want = list(make_loader(ds, 4, seed=7, skip_samples=6,
                                num_epochs=2))
        got = list(make_loader(ds, 4, seed=7, skip_samples=6, num_epochs=2,
                               workers=pool))
        assert len(want) == 70 // 4 - 2 + 70 // 4
        _assert_batches_equal(got, want)
        left = make_loader(ds, 4, seed=1, workers=pool)
        next(left), next(left)
        left.close()
        pids = [w.pid for w in pool._loader._iterator._workers]
        for aug_seed in (1, 2):
            ds.aug_seed = aug_seed
            want = list(make_loader(ds, 4, seed=aug_seed))
            _assert_batches_equal(
                list(make_loader(ds, 4, seed=aug_seed, workers=pool)), want)
        assert [w.pid for w in pool._loader._iterator._workers] == pids
    finally:
        pool.close()
    with pytest.raises(ValueError, match="another dataset"):
        next(make_loader(PairedImageDataset(str(tmp_path), "train",
                                            cache=False), 4, workers=pool))
