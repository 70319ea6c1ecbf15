"""Serving host I/O (counterpart of ``p2p_tpu/serve/io.py``): batch
bucketing and threaded, atomic PNG output.

:func:`pick_bucket` + :func:`pad_batch` round every request batch up to
one of a few batch sizes warmed up at start; padding repeats the last row
and is sliced off, so it never reaches an output (instance norm is per
sample, so padded rows cannot perturb real ones). :class:`AsyncImageWriter`
moves the device→host copy and the PNG encode to a thread pool, so they
overlap the next batch's compute; every file is written to a temp name
and renamed into place, so a reader never sees a torn PNG.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from p2p_tpu_torch.utils.images import save_img


def save_img_atomic(arr, path: str) -> None:
    """``save_img`` via temp file + rename: the file appears at ``path``
    whole or not at all. The temp name starts with a dot, so directory
    watchers keyed on image extensions skip it."""
    d, base = os.path.split(path)
    tmp = os.path.join(d, f".tmp.{os.getpid()}.{base}")
    try:
        save_img(arr, tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets sorted ascending)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}; "
                     "chunk with chunk_batch first")


def pad_batch(batch: Dict[str, np.ndarray],
              bucket_bs: int) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad a host batch's leading dim up to ``bucket_bs`` by repeating the
    last row. Returns ``(padded, n_real)``."""
    n = next(iter(batch.values())).shape[0]
    if n == bucket_bs:
        return batch, n
    if n > bucket_bs:
        raise ValueError(f"batch {n} larger than bucket {bucket_bs}")
    pad = bucket_bs - n
    return ({k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
             for k, v in batch.items()}, n)


def chunk_batch(batch: Dict[str, np.ndarray], max_bs: int):
    """Split an oversize host batch into chunks of at most ``max_bs``."""
    n = next(iter(batch.values())).shape[0]
    for i in range(0, n, max_bs):
        yield {k: v[i:i + max_bs] for k, v in batch.items()}


def to_host(pred) -> np.ndarray:
    """A prediction batch (tensor on any device, or array) as f32 numpy."""
    if isinstance(pred, torch.Tensor):
        return pred.detach().float().cpu().numpy()
    return np.asarray(pred, np.float32)


class AsyncImageWriter:
    """Thread-pooled device→host fetch + PNG encode.

    ``submit_batch(pred, paths)`` queues one prediction batch (NHWC); a
    worker copies it to the host once and writes its first ``len(paths)``
    rows. At most ``max_pending`` batches wait; a further submit blocks on
    the oldest, so a backlog of encodes cannot pin unbounded device
    memory. ``drain()`` waits for everything and raises the first worker
    error. ``encode_sec`` sums the workers' time."""

    def __init__(self, workers: int = 4, max_pending: Optional[int] = None):
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers),
                                        thread_name_prefix="p2p-serve-io")
        self.max_pending = (max_pending if max_pending is not None
                            else 4 * max(1, workers))
        self._futures: List[Future] = []
        self._lock = threading.Lock()
        self.n_written = 0
        self.encode_sec = 0.0

    def _write_batch(self, pred: Any, paths: Sequence[str]) -> None:
        t0 = time.perf_counter()
        arr = to_host(pred)
        for i, path in enumerate(paths):
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            save_img_atomic(arr[i], path)
        dt = time.perf_counter() - t0
        with self._lock:
            self.n_written += len(paths)
            self.encode_sec += dt

    def submit_batch(self, pred: Any, paths: Sequence[str]) -> None:
        """Queue the first ``len(paths)`` rows of ``pred`` for writing.
        Called from one dispatch thread."""
        while len(self._futures) >= self.max_pending:
            self._futures.pop(0).result()
        self._futures.append(
            self._pool.submit(self._write_batch, pred, list(paths)))

    def drain(self) -> int:
        """Wait until every queued image is on disk; raise the first worker
        error; return the number written."""
        futures, self._futures = self._futures, []
        first_error = None
        for f in futures:
            try:
                f.result()
            except Exception as e:  # re-raised below, after every wait
                first_error = first_error or e
        if first_error is not None:
            raise first_error
        return self.n_written

    def close(self) -> None:
        try:
            self.drain()
        finally:
            self._pool.shutdown(wait=True)
