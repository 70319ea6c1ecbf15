"""Serving host I/O (counterpart of ``p2p_tpu/serve/io.py``): batch
bucketing, threaded atomic PNG output, and PNG response bodies.

:func:`pick_bucket` + :func:`pad_batch` round every request batch up to
one of a few batch sizes warmed up at start; padding repeats the last row
and is sliced off, so it never reaches an output (instance norm is per
sample, so padded rows cannot perturb real ones). :class:`AsyncImageWriter`
moves the device→host copy and the PNG encode to a thread pool, so they
overlap the next batch's compute; every file is written to a temp name
and renamed into place, so a reader never sees a torn PNG, under the
retry policy with a ``serve_write`` chaos seam. :func:`encode_png` is the
HTTP frontend's response body, encoded by the port's stdlib PNG writer:
its bytes may differ from Pillow's, its decoded pixels may not.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from p2p_tpu_torch.resilience.chaos import chaos_point
from p2p_tpu_torch.resilience.retry import RetryPolicy, retry_call
from p2p_tpu_torch.utils import images

# quick retries: a worker holds a whole prediction batch while it waits
WRITE_POLICY = RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=0.5)


def save_img_atomic(arr, path: str) -> None:
    """``save_img`` via temp file + rename: the file appears at ``path``
    whole or not at all. The temp name starts with a dot, so directory
    watchers keyed on image extensions skip it."""
    d, base = os.path.split(path)
    tmp = os.path.join(d, f".tmp.{os.getpid()}.{base}")
    try:
        chaos_point("serve_write")
        images.save_img(arr, tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def encode_png(arr) -> bytes:
    """One prediction image ([-1, 1] float HWC) as PNG bytes, with the
    uint8 conversion of ``save_img``: the pixels of the file the directory
    frontend writes for the same prediction."""
    return images.encode_png(images.to_uint8_img(arr))


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
    error. ``encode_sec`` sums the workers' time.

    Each write is retried (``WRITE_POLICY``, seam ``serve_write``). With
    ``fail_fast=False`` (the serving frontend) a write that exhausts its
    retries goes to ``write_errors`` as ``(path, error)`` and the batch
    goes on, so one bad output path never stops a server; with
    ``fail_fast=True`` (offline inference) ``drain()`` raises it."""

    def __init__(self, workers: int = 4, max_pending: Optional[int] = None,
                 fail_fast: bool = True):
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers),
                                        thread_name_prefix="p2p-serve-io")
        self.max_pending = (max_pending if max_pending is not None
                            else 4 * max(1, workers))
        self.fail_fast = fail_fast
        self._futures: List[Future] = []
        self._lock = threading.Lock()
        self.n_written = 0
        self.encode_sec = 0.0
        self.write_errors: List[Tuple[str, BaseException]] = []

    def _write_batch(self, pred: Any, paths: Sequence[str]) -> None:
        t0 = time.perf_counter()
        arr = to_host(pred)
        n_ok = 0
        for i, path in enumerate(paths):
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            try:
                retry_call(save_img_atomic, arr[i], path,
                           policy=WRITE_POLICY, seam="serve_write")
                n_ok += 1
            except BaseException as e:
                if self.fail_fast:
                    raise
                with self._lock:
                    self.write_errors.append((path, e))
        dt = time.perf_counter() - t0
        with self._lock:
            self.n_written += n_ok
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
