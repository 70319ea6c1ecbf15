"""Named, step-indexed seed streams (counterpart of ``p2p_tpu/core/rng.py``
``RngStream``).

The JAX stream folds a step and a name into a threefry key. The port's
seed law is numpy's ``SeedSequence`` over the integers that name a draw
(``train/step.dropout_generator`` hashes ``(seed, step)``; the CPU
``torch.Generator`` keeps 32 bits of a plain seed, so the pair is hashed):
a stream is the tuple of those integers, ``at_step`` and ``key`` append
one, and a draw is a ``torch.Generator`` seeded from the tuple's hash.
The same stream gives the same draws, on any device and however steps are
resumed; streams of another step or name are independent. JAX's bits are
not reproduced (its threefry keys have no torch counterpart).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch


def _name_word(name: str) -> int:
    """The JAX stream's name hash: the name's first 4 bytes, little
    endian."""
    return int.from_bytes(name.encode()[:4].ljust(4, b"\0"), "little")


@dataclasses.dataclass(frozen=True)
class RngStream:
    """A named, step-indexed stream of seeds derived from one base seed."""

    entropy: Tuple[int, ...]

    @classmethod
    def from_seed(cls, seed: int) -> "RngStream":
        return cls((int(seed),))

    def at_step(self, step: int) -> "RngStream":
        return RngStream(self.entropy + (int(step),))

    def key(self, name: str) -> "RngStream":
        return RngStream(self.entropy + (_name_word(name),))

    def split(self, n: int = 2) -> List["RngStream"]:
        """``n`` independent child streams."""
        return [RngStream(self.entropy + (1 << 32, i)) for i in range(n)]

    def seed(self) -> int:
        """The 64-bit seed of this stream (``SeedSequence`` of its
        integers)."""
        return int(np.random.SeedSequence(list(self.entropy))
                   .generate_state(1, np.uint64)[0])

    def generator(self, device: Optional[Union[str, torch.device]] = None
                  ) -> torch.Generator:
        """A ``torch.Generator`` on ``device`` (the CPU by default) seeded
        from :meth:`seed`."""
        return torch.Generator(device=device or "cpu").manual_seed(
            self.seed())
