"""The historical-fake pool (counterpart of ``p2p_tpu/utils/pool.py``).

``pool_size == 0`` is a passthrough (the reference's ``ImagePool(0)``);
otherwise each incoming fake fills the pool until it is full, then with
probability 0.5 it swaps with a stored one (the stored one goes on, the
new one is kept) and with 0.5 passes through.

Two forms: :class:`ImagePool` on the host (numpy, the JAX class's
``default_rng`` draws in its order) and the device ring of the train step,
``(pool, pool_n)`` in the train state: :func:`pool_query_draws` is the
pure function of the draws, :func:`device_pool_query` draws them from a
``torch.Generator`` seeded from ``(seed, step)``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class ImagePool:
    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.images: list = []
        self.rng = np.random.default_rng(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        """images: (N, H, W, C) batch of fakes → same-shape batch drawn per
        the reference's 50% swap rule."""
        if self.pool_size == 0:
            return images
        out = []
        for img in np.asarray(images):
            if len(self.images) < self.pool_size:
                self.images.append(img.copy())
                out.append(img)
            elif self.rng.random() > 0.5:
                idx = int(self.rng.integers(0, self.pool_size))
                stored = self.images[idx]
                self.images[idx] = img.copy()
                out.append(stored)
            else:
                out.append(img)
        return np.stack(out)


def pool_query_draws(pool: torch.Tensor, pool_n: torch.Tensor,
                     pairs: torch.Tensor, rand_idx: torch.Tensor,
                     swap: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pool step given its draws (the JAX ``device_pool_query`` after
    its two ``jax.random`` calls).

    pool:     (P, H, W, C) stored pairs; pool_n: 0-d int32, slots filled
    pairs:    (N, H, W, C) incoming pairs
    rand_idx: (N,) integers in [0, P); swap: (N,) bool

    Per sample: while the pool is not full, store and pass through; once
    full, with ``swap`` exchange with slot ``rand_idx mod filled``, where
    ``filled`` counts the slots of the OLD pool (the pool before this
    batch), else pass through; with no filled slot a pair passes through
    (and is still stored). Only writing samples are scattered, in sample
    order, so of two swaps to one slot the last wins. Returns
    ``(pairs_for_D, new_pool, new_pool_n)``; the pool is not modified."""
    p_size, n = pool.shape[0], pairs.shape[0]
    dev = pairs.device
    offs = pool_n + torch.arange(n, dtype=torch.int32, device=dev)
    not_full = offs < p_size
    filled = torch.clamp(pool_n, max=p_size).expand(n)
    idx = rand_idx.to(torch.int32) % torch.clamp(filled, min=1)
    write_idx = torch.where(not_full, torch.clamp(offs, max=p_size - 1),
                            idx).long()
    use_stored = ~not_full & swap & (filled > 0)
    do_write = not_full | swap
    stored = pool[write_idx].to(pairs.dtype)
    out = torch.where(use_stored.view(n, 1, 1, 1), stored, pairs)
    new_pool = pool.clone()
    src = pairs.to(pool.dtype)
    for i in range(n):       # in sample order, with no host sync
        j = write_idx[i:i + 1]
        new_pool.index_copy_(0, j, torch.where(
            do_write[i], src[i:i + 1], new_pool.index_select(0, j)))
    new_n = torch.clamp(pool_n + not_full.sum(dtype=torch.int32),
                        max=p_size).to(torch.int32)
    return out, new_pool, new_n


def pool_generator(seed: int, step: int, device: torch.device
                   ) -> torch.Generator:
    """The generator of one step's pool draws on ``device``, seeded from a
    hash of ``(seed, step)`` (numpy's ``SeedSequence``; the CPU generator
    keeps only 32 bits of its seed), apart from the dropout stream."""
    mixed = np.random.SeedSequence([seed, step, 0x705501]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


def device_pool_query(pool: torch.Tensor, pool_n: torch.Tensor,
                      pairs: torch.Tensor, generator: torch.Generator
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`pool_query_draws` with ``rand_idx`` uniform in [0, P) and
    ``swap`` = (uniform > 0.5) drawn from ``generator``."""
    p_size, n = pool.shape[0], pairs.shape[0]
    rand_idx = torch.randint(0, p_size, (n,), generator=generator,
                             device=pairs.device, dtype=torch.int32)
    swap = torch.rand((n,), generator=generator, device=pairs.device) > 0.5
    return pool_query_draws(pool, pool_n, pairs, rand_idx, swap)
