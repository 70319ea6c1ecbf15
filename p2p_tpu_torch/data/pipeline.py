"""Input pipeline: paired-image loading → host batches → device prefetch
(counterpart of ``p2p_tpu/data/pipeline.py``).

- :class:`PairedImageDataset`: ``<root>/<split>/a/<name>`` paired with
  ``b/<name>``, decoded by the port's PNG reader, resized bicubic to the
  target size when it differs (Pillow's bytes), and normalized to [-1, 1]
  or kept uint8, all three in the C++ host image library (utils/images.py,
  native/); the direction swap, the optional 286/256 crop-and-flip
  augmentation and the decode memo.
- :func:`make_loader`: the JAX package's in-process loader (its fallback
  when Grain is absent), order for order: one ``np.random.default_rng(seed)``
  shuffles ``arange(n)`` once per epoch, :func:`shard_epoch_indices` cuts
  the epoch, consecutive items stack into batches. Given a
  :class:`LoaderWorkers` pool, kept across epochs, the batches are read
  by its worker processes (``spawn``, through a
  ``torch.utils.data.DataLoader`` with persistent workers) and come out
  in the same order, the role Grain's workers play in JAX
  (``DataConfig.threads``).
- :func:`device_prefetch`: pinned host buffers and ``non_blocking`` copies
  to the card one batch ahead of the consumer.
"""

from __future__ import annotations

import collections
import functools
import io
import os
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from p2p_tpu_torch import native
from p2p_tpu_torch.data.generate import is_image_file, read_png
from p2p_tpu_torch.utils.images import (PNG_SIGNATURE, decode_png,
                                        resize_bicubic)


def _fit(arr: np.ndarray, h: int, w: int, as_uint8: bool) -> np.ndarray:
    """Resize to (h, w) only when the size differs, then float32 [-1, 1]
    by ``(x − 127.5)·(1/127.5)`` (the expression of the JAX package and of
    ``utils/images.ingest``; ``native.normalize_f32``), or the uint8 bytes
    with ``as_uint8``."""
    if arr.shape[:2] != (h, w):
        arr = resize_bicubic(arr, h, w)
    if as_uint8:
        return arr
    return native.normalize_f32(arr)


def load_image(path: str, h: int, w: int, as_uint8: bool = False
               ) -> np.ndarray:
    """Decode a PNG file, then resize and normalize (:func:`_fit`)."""
    return _fit(read_png(path), h, w, as_uint8)


def load_image_bytes(data: bytes, h: int, w: int, as_uint8: bool = False
                     ) -> np.ndarray:
    """:func:`load_image` over an in-memory body (counterpart of
    ``p2p_tpu/data/pipeline.py:70``, the HTTP request body). A PNG body is
    read by the port's PNG reader; any other (JPEG, ...) by Pillow's
    ``Image.open(...).convert("RGB")``, as the JAX function reads every
    body, where Pillow is installed. Without Pillow a body that is not a
    PNG raises ``ValueError`` naming the PNG reader, as does any body
    neither reads."""
    data = bytes(data)
    if data.startswith(PNG_SIGNATURE):
        try:
            arr = decode_png(data)
        except ValueError as e:
            raise ValueError(f"request body is not a PNG this decoder reads "
                             f"(the port's PNG decoder): {e}") from None
    else:
        arr = _decode_with_pillow(data)
    return _fit(arr, h, w, as_uint8)


def _decode_with_pillow(data: bytes) -> np.ndarray:
    """A non-PNG body → uint8 (h, w, 3) RGB through Pillow."""
    try:
        from PIL import Image, UnidentifiedImageError
    except ImportError:
        raise ValueError("request body is not a PNG, and without Pillow "
                         "the port reads PNG only") from None
    try:
        with Image.open(io.BytesIO(data)) as img:
            return np.asarray(img.convert("RGB"), np.uint8)
    except (UnidentifiedImageError, OSError, SyntaxError) as e:
        raise ValueError(f"request body is neither a PNG nor an image "
                         f"Pillow reads: {e}") from None


class PairedImageDataset:
    """Random-access paired dataset; items are dicts of HWC images,
    float32 [-1, 1] by default, uint8 with ``dtype="uint8"`` (normalized
    on the device by the steps). ``direction="b2a"`` makes ``b/`` the
    input. With ``augment`` each pair is loaded at 286/256 of the size,
    cropped at one random offset and flipped with probability 1/2, both a
    pure function of ``(aug_seed, index)``; the trainer sets ``aug_seed``
    once per epoch. Decoded images are memoized (before augmentation)
    when the split fits in 4 GB (``cache="auto"``)."""

    def __init__(self, root: str, split: str = "train",
                 direction: str = "b2a", image_size: int = 256,
                 image_width: Optional[int] = None, augment: bool = False,
                 aug_seed: int = 0, cache: Union[bool, str] = "auto",
                 dtype: str = "float32"):
        self.a_dir = os.path.join(root, split, "a")
        self.b_dir = os.path.join(root, split, "b")
        self.direction = direction
        self.h = image_size
        self.w = image_width or image_size
        self.augment = augment
        self.aug_seed = aug_seed
        self.names = sorted(f for f in os.listdir(self.a_dir)
                            if is_image_file(f))
        if not self.names:
            raise RuntimeError(f"no images in {self.a_dir}")
        if dtype not in ("float32", "uint8"):
            raise ValueError(f"dtype must be float32|uint8, got {dtype!r}")
        self.as_uint8 = dtype == "uint8"
        if cache == "auto":
            lh = (self.h * 286 // 256) if augment else self.h
            lw = (self.w * 286 // 256) if augment else self.w
            bpp = 1 if self.as_uint8 else 4
            cache = len(self.names) * lh * lw * 3 * bpp * 2 <= 4 << 30
        self.cache_enabled = bool(cache)
        self._memo: Dict = {}

    def __len__(self) -> int:
        return len(self.names)

    def _load(self, path: str, h: Optional[int] = None,
              w: Optional[int] = None) -> np.ndarray:
        h = h or self.h
        w = w or self.w
        if not self.cache_enabled:
            return load_image(path, h, w, self.as_uint8)
        key = (path, h, w)
        hit = self._memo.get(key)
        if hit is None:
            hit = load_image(path, h, w, self.as_uint8)
            hit.setflags(write=False)
            self._memo[key] = hit
        return hit

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        idx = idx.__index__()
        name = self.names[idx]
        if self.augment:
            lh = self.h * 286 // 256
            lw = self.w * 286 // 256
            a = self._load(os.path.join(self.a_dir, name), lh, lw)
            b = self._load(os.path.join(self.b_dir, name), lh, lw)
            rng = np.random.default_rng((0x9E3779B9, self.aug_seed, idx))
            oy = int(rng.integers(0, lh - self.h + 1))
            ox = int(rng.integers(0, lw - self.w + 1))
            a = a[oy:oy + self.h, ox:ox + self.w]
            b = b[oy:oy + self.h, ox:ox + self.w]
            if rng.random() < 0.5:
                a, b = a[:, ::-1], b[:, ::-1]
            a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        else:
            a = self._load(os.path.join(self.a_dir, name))
            b = self._load(os.path.join(self.b_dir, name))
        if self.direction == "a2b":
            return {"input": a, "target": b}
        return {"input": b, "target": a}


def shard_epoch_indices(idx: np.ndarray, batch_size: int,
                        skip_batches: int = 0, n_proc: Optional[int] = None,
                        pid: Optional[int] = None,
                        drop_remainder: bool = True,
                        skip_samples: int = 0) -> list:
    """One epoch's shuffled global index vector → this process's
    batch-aligned, post-skip slice: the JAX package's arithmetic
    (``p2p_tpu/data/pipeline.py:257 shard_epoch_indices``), ``n_proc``
    and ``pid`` defaulting to the default group's size and rank.

    Sharding is by stride: process ``p`` takes ``idx[p::n_proc]`` (after
    trimming ``len % n_proc`` with ``drop_remainder``), so its local batch
    ``i`` of ``batch_size`` rows holds flat positions ``i·B·… + p`` with
    ``B = batch_size·n_proc`` the global batch, and the union over the
    processes of local batch ``i`` is flat positions ``[i·B, (i+1)·B)``
    whatever ``n_proc`` is: a relaunch on another process count that skips
    the consumed prefix reads exactly the samples the dead run did not.
    ``skip_batches`` drops the first local batches; ``skip_samples`` drops
    the flat prefix ``[0, S)`` (process ``p`` drops its rows at flat
    positions below S) and, with ``drop_remainder``, keeps ``n_usable //
    B − ceil(S / B)`` batches on every process."""
    from p2p_tpu_torch.core.mesh import process_count, process_index

    idx = np.asarray(idx)
    if n_proc is None:
        n_proc = process_count()
    if pid is None:
        pid = process_index()
    if skip_batches and skip_samples:
        raise ValueError("pass skip_batches OR skip_samples, not both")
    n_usable = len(idx)
    if n_proc > 1:
        if drop_remainder:
            idx = idx[: len(idx) - len(idx) % n_proc]
            n_usable = len(idx)
        idx = idx[pid::n_proc]
    if skip_samples > 0:
        s = int(skip_samples)
        drop = (s - pid + n_proc - 1) // n_proc if s > pid else 0
        idx = idx[drop:]
        if drop_remainder:
            b = batch_size * n_proc
            n_b = max(0, n_usable // b - -(-s // b))
            idx = idx[: n_b * batch_size]
    elif skip_batches > 0:
        idx = idx[skip_batches * batch_size:]
    return list(idx)


def _stack(ds, indices) -> Dict[str, np.ndarray]:
    """The items of ``indices`` stacked into one batch."""
    items = [ds[j] for j in indices]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _batch_indices(n: int, batch_size: int, drop_remainder: bool):
    """``[start, end)`` of each batch of ``n`` items."""
    end = n - batch_size + 1 if drop_remainder else n
    return [(i, min(i + batch_size, n)) for i in range(0, max(end, 0),
                                                      batch_size)]


class _RunBatches(torch.utils.data.Dataset):
    """The worker processes' view of a dataset: key ``(aug_seed, indices)``
    is the batch of ``indices`` at that ``aug_seed``, the one attribute the
    trainer changes between epochs (None for a dataset without it)."""

    def __init__(self, ds):
        self.ds = ds

    def __getitem__(self, key) -> Dict[str, np.ndarray]:
        aug_seed, indices = key
        if aug_seed is not None:
            self.ds.aug_seed = aug_seed
        return _stack(self.ds, indices)


class _EpochKeys(torch.utils.data.Sampler):
    """The keys of the epoch being read, replaced before each pass."""

    def __init__(self):
        self.keys = []

    def __iter__(self):
        return iter(self.keys)

    def __len__(self) -> int:
        return len(self.keys)


def _as_is(batch):
    """The DataLoader's collate: the batch stays numpy."""
    return batch


def _worker_init(cache_dir: Optional[str], _worker_id: int) -> None:
    """A worker reads images on one thread and builds or loads the host
    image library where its parent does (the compilation cache)."""
    torch.set_num_threads(1)
    if cache_dir:
        from p2p_tpu_torch.core.cache import enable_compilation_cache

        enable_compilation_cache(cache_dir)


class LoaderWorkers:
    """``num_workers`` spawned processes that read ``dataset``'s batches
    for every epoch they are given: started by the first epoch and kept
    until :meth:`close` (a ``DataLoader`` with ``persistent_workers``), so
    a run starts them once, not once an epoch. They hold a copy of the
    dataset made when they start, return numpy arrays and touch no CUDA
    device. Each epoch's batches come out whole and in order; the rest of
    an epoch left part way is drained when the next one starts."""

    def __init__(self, dataset, num_workers: int):
        from p2p_tpu_torch.core.cache import compilation_cache_dir

        self.dataset = dataset
        self._keys = _EpochKeys()
        self._loader = torch.utils.data.DataLoader(
            _RunBatches(dataset), batch_size=None, sampler=self._keys,
            num_workers=num_workers, persistent_workers=True,
            collate_fn=_as_is, multiprocessing_context="spawn",
            worker_init_fn=functools.partial(_worker_init,
                                             compilation_cache_dir()))

    def epoch(self, indices, bounds) -> Iterator[Dict[str, np.ndarray]]:
        """The batches ``indices[lo:hi]`` of each ``(lo, hi)`` in
        ``bounds``, at the dataset's current ``aug_seed``."""
        seed = getattr(self.dataset, "aug_seed", None)
        self._keys.keys = [(seed, [int(i) for i in indices[lo:hi]])
                           for lo, hi in bounds]
        return iter(self._loader)

    def close(self) -> None:
        """Stop the worker processes (a later epoch starts new ones)."""
        it = self._loader._iterator
        self._loader._iterator = None
        if it is not None:
            it._shutdown_workers()


def _epoch_batches(ds, batch_size: int, indices, drop_remainder: bool,
                   workers: Optional[LoaderWorkers]):
    """One epoch's batches of ``indices`` in order, read in this process
    or by ``workers``."""
    bounds = _batch_indices(len(indices), batch_size, drop_remainder)
    if workers is None or not bounds:
        for lo, hi in bounds:
            yield _stack(ds, indices[lo:hi])
        return
    yield from workers.epoch(indices, bounds)


def make_loader(dataset: PairedImageDataset, batch_size: int,
                shuffle: bool = True, seed: int = 0,
                num_epochs: Optional[int] = 1, drop_remainder: bool = True,
                skip_batches: int = 0, skip_samples: int = 0,
                workers: Optional[LoaderWorkers] = None,
                n_proc: Optional[int] = None, pid: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
    """This process's host batches of ``dataset`` (``batch_size`` is the
    local batch) for ``num_epochs`` epochs (forever with None), in the JAX
    fallback loader's order: ``default_rng(seed)`` shuffles
    ``arange(len)`` at the start of every epoch, the same permutation on
    every process, and :func:`shard_epoch_indices` takes this process's
    stride of it (``n_proc`` processes, this one ``pid``: the default
    group's by default); ``skip_batches``/``skip_samples`` apply to the
    first epoch only.
    With ``workers`` (a pool over ``dataset`` that the caller keeps and
    closes) the batches are read by its processes: the same batches, in
    the same order."""
    if workers is not None and workers.dataset is not dataset:
        raise ValueError("make_loader: the workers read another dataset")
    rng = np.random.default_rng(seed)
    epoch = 0
    skip = max(0, int(skip_batches))
    skip_s = max(0, int(skip_samples))
    while num_epochs is None or epoch < num_epochs:
        idx = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(idx)
        local = shard_epoch_indices(idx, batch_size, skip_batches=skip,
                                    n_proc=n_proc, pid=pid,
                                    drop_remainder=drop_remainder,
                                    skip_samples=skip_s)
        skip = skip_s = 0
        yield from _epoch_batches(dataset, batch_size, local,
                                  drop_remainder, workers)
        epoch += 1


def device_prefetch(iterator, device: Union[str, torch.device]):
    """Host batches (dicts of numpy arrays) → dicts of tensors on
    ``device``, one batch ahead of the consumer. On the
    card each array is copied into pinned host memory and sent with a
    ``non_blocking`` copy on the current stream, so the copy overlaps the
    work queued before it and the steps that read the batch are ordered
    after it; each pinned buffer is kept until an event recorded after its
    copy has completed. On the CPU the batches pass through as they are."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    queue = collections.deque()
    in_flight = collections.deque()      # (event, pinned buffers)

    def put(batch):
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in batch.items()}
        out = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
        event = torch.cuda.Event()
        event.record()
        in_flight.append((event, pinned))
        while in_flight and in_flight[0][0].query():
            in_flight.popleft()
        return out

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) == 2:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
    for event, _ in in_flight:
        event.synchronize()
