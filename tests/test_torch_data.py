"""The port's data pipeline (``p2p_tpu_torch/data/{pipeline,generate,
synthetic}.py``) against the JAX package's (``p2p_tpu/data/``), with the
JAX loader on its in-process fallback, the loader the port mirrors
(forced with ``P2P_TPU_NO_GRAIN=1``: Grain is installed here):

- ``PairedImageDataset`` items on one directory written by the JAX
  package's ``make_synthetic_dataset`` (Pillow's PNGs, every filter type),
  a2b and b2a, float32 and uint8, at the files' size, at a size that
  forces the bicubic resize, and with the 286/256 crop-and-flip;
- ``make_loader``'s batches over 2 epochs, shuffled and not, with
  ``skip_batches``, ``skip_samples`` and ``drop_remainder`` both ways;
- ``shard_epoch_indices`` over a grid of lengths, batches, skips and
  remainders, at the JAX package's one-process arguments;
- ``generate_dataset`` (tiles, ``max_patches``, ``min_std``, ``upsample``,
  rectangular crops, whole images) and ``make_synthetic_dataset``: the
  files decode to the same pixels (the PNG bytes may differ).

Tolerance: none. Every comparison is bitwise (``np.array_equal`` and equal
dtypes).
"""

import os

import numpy as np
import pytest
from PIL import Image

from p2p_tpu.data import generate as jgen
from p2p_tpu.data import pipeline as jpipe
from p2p_tpu.data.synthetic import make_synthetic_dataset as jax_synth
from p2p_tpu_torch.data import generate as tgen
from p2p_tpu_torch.data import pipeline as tpipe
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset
from p2p_tpu_torch.utils.images import decode_png

SIZE = 24


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return jax_synth(str(tmp_path_factory.mktemp("jax_synth")), n_train=5,
                     n_test=2, size=SIZE, seed=3)


@pytest.fixture(scope="module", autouse=True)
def _no_grain():
    """The JAX loader on its in-process fallback (Grain is installed
    here), for the module-scoped fixtures too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("P2P_TPU_NO_GRAIN", "1")
        yield


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("direction", ["a2b", "b2a"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("size,width,augment", [
    (SIZE, None, False), (20, 30, False), (16, None, True),
    (SIZE, None, True)])
def test_dataset_items_are_the_jax_items(root, direction, dtype, size,
                                         width, augment):
    kw = dict(split="train", direction=direction, image_size=size,
              image_width=width, augment=augment, dtype=dtype)
    jds = jpipe.PairedImageDataset(root, **kw)
    tds = tpipe.PairedImageDataset(root, **kw)
    assert tds.names == jds.names and len(tds) == len(jds) == 5
    for seed in (0, 7):
        jds.aug_seed = tds.aug_seed = seed
        for i in range(len(jds)):
            _assert_items_equal(tds[np.int64(i)], jds[i])


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("skip", [{}, {"skip_batches": 1},
                                  {"skip_samples": 3}])
def test_loader_batches_are_the_jax_fallback_batches(root, shuffle,
                                                     drop_remainder, skip):
    jds = jpipe.PairedImageDataset(root, "train", image_size=SIZE,
                                   dtype="uint8")
    tds = tpipe.PairedImageDataset(root, "train", image_size=SIZE,
                                   dtype="uint8")
    kw = dict(batch_size=2, shuffle=shuffle, seed=11, num_epochs=2,
              drop_remainder=drop_remainder, **skip)
    want = list(jpipe.make_loader(jds, **kw))
    got = list(tpipe.make_loader(tds, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_items_equal(g, w)


def test_shard_epoch_indices_is_the_jax_arithmetic():
    """At the JAX package's one-process arguments (n_proc 1, pid 0)."""
    rng = np.random.default_rng(0)
    n_cases = 0
    for n in (1, 5, 7, 12):
        idx = rng.permutation(n)
        for bs in (1, 2, 3, 5):
            for skip in ({}, {"skip_batches": 1}, {"skip_batches": 2},
                         {"skip_samples": 1}, {"skip_samples": 4},
                         {"skip_samples": 13}):
                for drop in (True, False):
                    want = jpipe.shard_epoch_indices(
                        idx, bs, n_proc=1, pid=0, drop_remainder=drop,
                        **skip)
                    got = tpipe.shard_epoch_indices(
                        idx, bs, drop_remainder=drop, **skip)
                    assert [int(i) for i in got] == [int(i) for i in want], \
                        (n, bs, skip, drop)
                    n_cases += 1
    assert n_cases == 4 * 4 * 6 * 2
    with pytest.raises(ValueError):
        tpipe.shard_epoch_indices(np.arange(4), 1, skip_batches=1,
                                  skip_samples=1)


def _decoded_tree(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), top)] = \
                    decode_png(fh.read())
    return out


def _sources(tmp_path):
    """Three PNG sources written by Pillow: 40×56, 20×20 (too small for
    a 24 crop), and one with a flat half (dropped by min_std)."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(5)
    imgs = {"a.png": rng.integers(0, 256, (40, 56, 3), dtype=np.uint8),
            "b.png": rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)}
    flat = rng.integers(0, 256, (24, 48, 3), dtype=np.uint8)
    flat[:, :24] = 77
    imgs["c.png"] = flat
    for name, img in imgs.items():
        Image.fromarray(img).save(str(src / name))
    (src / "notes.txt").write_text("not an image")
    return str(src)


@pytest.mark.parametrize("kw", [
    dict(crop_size=24, max_patches=100),
    dict(crop_size=16, max_patches=3, bits=2),
    dict(crop_size=24, min_std=5.0),
    dict(crop_size=24, upsample=2, crop_width=32),
    dict(crop_size=None)])
def test_generate_dataset_writes_the_jax_pixels(tmp_path, kw):
    src = _sources(tmp_path)
    n_jax = jgen.generate_dataset(src, str(tmp_path / "jax"), "train", **kw)
    n_port = tgen.generate_dataset(src, str(tmp_path / "port"), "train",
                                   **kw)
    assert n_port == n_jax > 0
    want = _decoded_tree(str(tmp_path / "jax"))
    got = _decoded_tree(str(tmp_path / "port"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_generate_dataset_refuses_a_non_png_source(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(
        str(src / "x.jpg"))
    with pytest.raises(ValueError, match="x.jpg"):
        tgen.generate_dataset(str(src), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="does not exist"):
        tgen.generate_dataset(str(tmp_path / "missing"),
                              str(tmp_path / "out"))


def test_synthetic_dataset_has_the_jax_pixels(root, tmp_path):
    port = make_synthetic_dataset(str(tmp_path / "port"), n_train=5,
                                  n_test=2, size=SIZE, seed=3)
    want, got = _decoded_tree(root), _decoded_tree(port)
    assert sorted(got) == sorted(want) and len(want) == 14
    for k in want:
        assert np.array_equal(got[k], want[k]), k
