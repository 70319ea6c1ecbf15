"""BatchNorm's one-read channel moments: the Hopper kernel and its plain
version.

``batch_moments(xc)`` returns ``(Σxc, Σxc²)`` per channel of a contiguous
(M, C) tensor as two (C,) f32 tensors, accumulated in f32. BatchNorm
(ops/norm.py) calls it on the (M, C) view of its shifted channels_last
activation ``xc = x − running_mean``.

Replaces ``p2p_tpu/ops/pallas/batch_moments.py:76 pallas_dual_moments``
(kernel body ``_moments_kernel``). The kernel is ``csrc/batch_moments.cu``:
it is bound by device-memory bytes (xc read once, 2·C floats written; 3.35
TB/s on an H100 SXM), so it reads xc in 16-byte vectors along C, splits M
into chunks across blocks, and sums the per-chunk partials in a second
short pass in a fixed order: no float atomics, the same bits on every run.
The second launch is a programmatic dependent launch, which overlaps its
start with the first; where one chunk covers M there is none.
The TPU kernel's eligibility rules (VMEM block sizes) do not apply: every
shape takes the kernel.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from p2p_tpu_torch.ops.cuda import build
from p2p_tpu_torch.ops.cuda.instance_norm_kernel import stats_geometry

REPLACES = "p2p_tpu/ops/pallas/batch_moments.py:76 (pallas_dual_moments)"
SOURCE = "p2p_tpu_torch/ops/cuda/csrc/batch_moments.cu"


def batch_moments_plain(xc: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: the same two f32 sums."""
    xf = xc.float()
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def batch_moments(xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σxc, Σxc²) over the rows of an (M, C) tensor, each (C,) f32."""
    if xc.device.type == "cpu":
        return batch_moments_plain(xc)
    if xc.device.type != "cuda":
        raise ValueError(f"batch_moments: expected a CUDA tensor, got "
                         f"{xc.device}")
    if xc.dim() != 2 or not xc.is_contiguous() or xc.shape[0] == 0:
        raise ValueError(f"batch_moments: expected a contiguous (M, C) "
                         f"tensor with M > 0, got {tuple(xc.shape)}")
    if xc.dtype not in build.DTYPE_CODES:
        raise TypeError(f"batch_moments: dtype {xc.dtype} not supported "
                        f"(have {sorted(map(str, build.DTYPE_CODES))})")
    m, c = xc.shape
    g = stats_geometry(1, m, c, build.vector_width(c, xc))
    s1 = torch.empty((c,), device=xc.device, dtype=torch.float32)
    s2 = torch.empty_like(s1)
    # one chunk: pass 1 writes the sums, and there is no second launch
    part = (s1, s2) if g.num_p == 1 else torch.empty(
        (2, g.num_p, c), device=xc.device, dtype=torch.float32)
    lib, fn = build.load("batch_moments")
    with torch.cuda.device(xc.device):
        err = fn(xc.data_ptr(), build.DTYPE_CODES[xc.dtype], m, c, g.vec,
                 g.tx, g.ty, g.cblocks, g.num_p, g.chunk, part[0].data_ptr(),
                 part[1].data_ptr(), s1.data_ptr(), s2.data_ptr(),
                 build.stream_handle(xc.device))
    build.check(lib, err, "batch_moments")
    build.count_launch(batch_moments)
    return s1, s2


batch_moments.launches = 0
