"""The spatial axis: H split over ``spatial`` ranks (counterpart of
``p2p_tpu/parallel/spatial.py``: ``:43 conv2d_local``, ``:66
sharded_conv2d``, ``:86 make_sharded_conv``, ``:116
check_spatial_divisible``, and of what GSPMD inserts around every
windowed op of the JAX spatial step, ``p2p_tpu/parallel/dp.py:55-95``).

Under a mesh whose ``spatial`` axis is wider than one, every activation of
a step is this rank's block of rows of a map: rank ``i`` of ``n`` holds
rows ``[⌊i·H/n⌋, ⌊(i+1)·H/n⌋)`` of a map of global height ``H``
(``core/mesh.row_block``), whatever ``H`` is, and the map's ``H`` is
recorded on the tensor (``core/mesh.set_rows``; elementwise ops pass it
on with ``keep_rows``). A windowed op gives each of its output rows
exactly one owner by the same rule on its output height, and derives from
that which input rows each rank needs: its own, some of its neighbours'
(one :func:`~p2p_tpu_torch.parallel.halo.exchange_rows`), and the padding
rows at the outer edges. So uneven maps come out exact: the D's k4-s2-p2
convs take 512 rows to 257 to 129 to 65, its k4-s1-p2 convs 65 to 66 to
67, and each row is computed once, by its owner, as the unsharded op
computes it. The forms here:

- :func:`conv_rows`: a conv with reflect or zero padding, any kernel and
  stride (the reflect-padded ``ConvLayer`` k3/k7 at stride 1 and 2, the
  D's k4 convs, spectral-normed or not, VGG19's k3 convs); W is padded
  locally, H through the exchange;
- :func:`upsample_rows`: the nearest ×factor upsample of
  ``UpsampleConvLayer``;
- :func:`avg_pool_rows`: ``avg_pool_downsample`` (k3, s2, pad 1,
  ``count_include_pad=False``), pooled as a sum on an NCHW copy and
  divided by the window's count of real pixels;
- :func:`max_pool_rows`: VGG19's 2×2 max pool;
- :func:`mean_of`: a loss's mean over positions as this rank's exact
  share of the global mean (its sum over the global count);
- :func:`tv_rows`: the total-variation loss, which differences rows
  across the block boundary;
- :func:`gather_rows`: the whole map on every rank (the eval step's PSNR
  and SSIM), one ``all_reduce``;
- :func:`all_reduce_sum`: the differentiable sum over the spatial group
  (the plain instance norm's two-pass statistics).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from p2p_tpu_torch.core.mesh import (SPATIAL_AXIS, Mesh, row_block,
                                     rows_of, set_rows, spatial_mesh)
from p2p_tpu_torch.ops.conv import reflect_pad_w
from p2p_tpu_torch.parallel.halo import Ring, exchange_rows, halo_exchange


def spatial_ring(mesh: Mesh) -> Ring:
    """The ring of ``mesh``'s spatial group through this rank (cached on
    the mesh)."""
    ring = getattr(mesh, "_spatial_ring", None)
    if ring is None:
        ring = Ring(mesh.group(SPATIAL_AXIS),
                    tuple(mesh.group_ranks(SPATIAL_AXIS)), mesh.spatial_rank)
        mesh._spatial_ring = ring
    return ring


def _active(mesh: Optional[Mesh]) -> Mesh:
    mesh = mesh or spatial_mesh()
    if mesh is None:
        raise RuntimeError("no spatial mesh is active (core/mesh."
                           "mesh_context with spatial > 1)")
    return mesh


def window_halos(h: int, hout: int, k: int, s: int, p: int, n: int
                 ) -> Tuple[List[int], List[int]]:
    """Every rank's ``(lo, hi)``: the input rows before and after its block
    of a map of ``h`` rows that the owner of output rows ``row_block(hout,
    n, r)`` of a (k, s, p) window op reads (negative: rows it holds and
    does not read)."""
    lo, hi = [], []
    for r in range(n):
        ia, ib = row_block(h, n, r)
        oa, ob = row_block(hout, n, r)
        if ob <= oa:
            raise ValueError(
                f"a map of {hout} rows cannot give each of {n} spatial "
                "ranks an output row")
        lo.append(ia - (oa * s - p))
        hi.append((ob - 1) * s - p + k - ib)
    return lo, hi


def window_rows(x: torch.Tensor, hout: int, k: int, s: int, p: int,
                edge_mode: str, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """The rows of ``x`` (this rank's block of a map) that this rank's
    output rows of a (k, s, p) window op read, padding rows included,
    through one exchange."""
    mesh = _active(mesh)
    h = rows_of(x)
    lo, hi = window_halos(h, hout, k, s, p, mesh.spatial)
    return exchange_rows(x, 2, lo, hi, spatial_ring(mesh), edge_mode,
                         heights=block_sizes(h, mesh.spatial))


def block_sizes(h: int, n: int) -> List[int]:
    """Every rank's block size of a map of ``h`` rows."""
    return [b - a for a, b in (row_block(h, n, r) for r in range(n))]


def out_rows(h: int, k: int, s: int, p: int) -> int:
    return (h + 2 * p - k) // s + 1


def conv_rows(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], stride: int, pad: int,
              edge_mode: str, dtype: Optional[torch.dtype] = None,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's output rows of ``conv2d(pad(x), weight, bias, stride)``
    with ``pad`` rows and columns of ``edge_mode`` padding (``"reflect"``
    or ``"zero"``), in ``dtype`` (or the promoted type of x and the
    weight), as ``ops/conv.cast_conv`` computes it."""
    k = weight.shape[2]
    h = rows_of(x)
    hout = out_rows(h, k, stride, pad)
    xr = window_rows(x, hout, k, stride, pad, edge_mode, mesh)
    dt = dtype or torch.promote_types(x.dtype, weight.dtype)
    if edge_mode == "reflect":
        xr, pw = reflect_pad_w(xr, pad), 0
    else:
        pw = pad
    y = F.conv2d(xr.to(dt), weight.to(dt),
                 None if bias is None else bias.to(dt), stride, (0, pw))
    return set_rows(y, hout)


def upsample_rows(x: torch.Tensor, factor: int,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's rows of the nearest ×``factor`` upsample."""
    mesh = _active(mesh)
    h, n, i = rows_of(x), mesh.spatial, mesh.spatial_rank
    hu = h * factor
    lo, hi = [], []
    for r in range(n):
        ia, ib = row_block(h, n, r)
        ua, ub = row_block(hu, n, r)
        lo.append(ia - ua // factor)
        hi.append((ub - 1) // factor + 1 - ib)
    xr = exchange_rows(x, 2, lo, hi, spatial_ring(mesh), "zero",
                       heights=block_sizes(h, n))
    y = F.interpolate(xr, scale_factor=factor, mode="nearest")
    ua, ub = row_block(hu, n, i)
    skip = ua - (ua // factor) * factor
    if skip or y.shape[2] != ub - ua:
        y = y.narrow(2, skip, ub - ua)
    return set_rows(y, hu)


def _valid_counts(n_out: int, start: int, size: int) -> np.ndarray:
    """Real pixels of each k3-s2-p1 window along one axis of ``size``
    pixels, for output positions ``start .. start + n_out − 1``."""
    j = np.arange(start, start + n_out)
    return (np.minimum(2 * j + 1, size - 1) - np.maximum(2 * j - 1, 0)
            + 1).astype(np.float32)


def avg_pool_rows(x: torch.Tensor, mesh: Optional[Mesh] = None
                  ) -> torch.Tensor:
    """This rank's rows of ``AvgPool2d(3, 2, padding=1,
    count_include_pad=False)``, channels_last: the window sums of an NCHW
    f32 copy (the NCHW pooling kernel, whose backward is right on the
    card), divided by each window's count of real pixels, in x's dtype."""
    mesh = _active(mesh)
    h, w = rows_of(x), x.shape[3]
    hout, wout = out_rows(h, 3, 2, 1), out_rows(w, 3, 2, 1)
    xr = window_rows(x, hout, 3, 2, 1, "zero", mesh)
    sums = F.avg_pool2d(xr.float().contiguous(), 3, stride=2,
                        padding=(0, 1), divisor_override=1)
    oa, _ = row_block(hout, mesh.spatial, mesh.spatial_rank)
    rows = _valid_counts(sums.shape[2], oa, h)
    cols = _valid_counts(wout, 0, w)
    count = torch.from_numpy(np.outer(rows, cols)).to(sums.device)
    y = (sums / count).to(x.dtype)
    return set_rows(y.contiguous(memory_format=torch.channels_last), hout)


def max_pool_rows(x: torch.Tensor, k: int = 2,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's rows of ``max_pool2d(x, k, k)``."""
    hout = rows_of(x) // k
    xr = window_rows(x, hout, k, k, 0, "zero", mesh)
    return set_rows(F.max_pool2d(xr, k, k), hout)


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group; its cotangent is the sum of the ranks'
    cotangents (each rank's loss is its share of the global one)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh] = None
                   ) -> torch.Tensor:
    """``x`` summed over the spatial group, differentiably."""
    mesh = _active(mesh)
    return _AllReduceSum.apply(x, mesh.group(SPATIAL_AXIS))


def global_count(x: torch.Tensor, like: Optional[torch.Tensor] = None
                 ) -> int:
    """Elements of the whole map whose rows ``x`` holds (the layout read
    from ``like``, a tensor of x's rows that carries it, when given)."""
    return x.numel() // x.shape[2] * rows_of(x if like is None else like)


def mean_of(x: torch.Tensor, like: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """``x.mean()`` in x's dtype, or under a spatial mesh this rank's
    share of the global mean: its sum over the map's global count (the
    shares of the spatial group add up to the mean)."""
    if spatial_mesh() is None:
        return x.mean()
    return x.sum() / global_count(x, like)


def mean_f32(x: torch.Tensor, like: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """``torch.mean(x, dtype=float32)``, or this rank's share of it."""
    if spatial_mesh() is None:
        return torch.mean(x, dtype=torch.float32)
    return torch.sum(x, dtype=torch.float32) / global_count(x, like)


def tv_rows(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's share of ``ops/tv.total_variation_loss``: the
    differences along W of its rows, and along H of its rows and the next
    rank's first row (one exchange)."""
    mesh = _active(mesh)
    n, h = mesh.spatial, rows_of(x)
    x = x.float()
    dw = (x[:, :, :, :-1] - x[:, :, :, 1:]).abs().sum()
    xr = exchange_rows(x, 2, [0] * n, [1] * (n - 1) + [0],
                       spatial_ring(mesh), "zero",
                       heights=block_sizes(h, n))
    dh = (xr[:, :, :-1, :] - xr[:, :, 1:, :]).abs().sum()
    nc, w = x.shape[0] * x.shape[1], x.shape[3]
    return dw / (nc * h * (w - 1)) + dh / (nc * (h - 1) * w)


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """The whole (N, C, H, W) map on every rank of the spatial group, from
    each rank's block of rows (one ``all_reduce`` of a zeroed buffer that
    holds each block in place, summed as 32-bit integer words: exact
    bits, on every backend and device). Not differentiable."""
    mesh = _active(mesh)
    h = rows_of(x)
    a, b = row_block(h, mesh.spatial, mesh.spatial_rank)
    shape = (x.shape[0], x.shape[1], h, x.shape[3])
    nbytes = int(np.prod(shape)) * x.element_size()
    words = torch.zeros(-(-nbytes // 4), dtype=torch.int32, device=x.device)
    full = words.view(torch.uint8)[:nbytes].view(x.dtype).view(shape)
    full.narrow(2, a, b - a).copy_(x.detach())
    dist.all_reduce(words, group=mesh.group(SPATIAL_AXIS))
    return full


def take_rows(x, h: int, mesh: Mesh, dim: int = 1):
    """This rank's rows ``row_block(h, spatial, spatial_rank)`` of a map
    with all ``h`` rows along ``dim`` (a host batch's NHWC arrays: dim
    1)."""
    if x.shape[dim] != h:
        raise ValueError(f"expected {h} rows along dim {dim}, got "
                         f"{x.shape[dim]}")
    a, b = row_block(h, mesh.spatial, mesh.spatial_rank)
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(a, b)
    return x[tuple(idx)]


def check_spatial_divisible(h: int, mesh: Mesh,
                            n_downsamples: int = 2) -> None:
    """Validate that H stays divisible by the spatial axis through the
    generator's stride-2 encoder (the deepest feature map must still
    split)."""
    n_shards = mesh.shape[SPATIAL_AXIS]
    deepest = h >> n_downsamples
    if deepest % n_shards:
        raise ValueError(
            f"image height {h} → deepest feature height {deepest} is not "
            f"divisible by spatial={n_shards}"
        )


def conv2d_local(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                 w_pad_mode: str = "reflect") -> torch.Tensor:
    """Plain local conv, H already halo-padded; W padded locally by k//2
    in ``w_pad_mode`` (``"reflect"``, ``"zero"`` or ``"wrap"``)."""
    pw = weight.shape[3] // 2
    if pw:
        if w_pad_mode == "reflect":
            x = reflect_pad_w(x, pw)
        elif w_pad_mode == "zero":
            x = F.pad(x, (pw, pw, 0, 0))
        elif w_pad_mode == "wrap":
            x = F.pad(x, (pw, pw, 0, 0), mode="circular")
        else:
            raise ValueError(f"unknown w_pad_mode {w_pad_mode!r}")
    return F.conv2d(x, weight, None, stride)


def sharded_conv2d(x: torch.Tensor, weight: torch.Tensor, group=None,
                   edge_mode: str = "reflect") -> torch.Tensor:
    """Stride-1 'same' conv of this rank's block of rows over ``group``:
    one exchange of k//2 boundary rows, then a local VALID conv; the
    block's output rows equal the unsharded conv's."""
    halo = weight.shape[2] // 2
    x = halo_exchange(x, 2, halo, group, edge_mode)
    return conv2d_local(x, weight, 1, edge_mode)


def make_sharded_conv(mesh: Mesh, edge_mode: str = "reflect"):
    """``fn(x_global, weight) -> y_global``: :func:`sharded_conv2d` on this
    rank's block of a whole (N, C, H, W) tensor, the blocks gathered back
    into the whole output (the JAX ``shard_map`` wrapper's counterpart,
    for tests)."""
    def fn(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        h = x.shape[2]
        local = take_rows(x, h, mesh, dim=2).contiguous()
        y = set_rows(sharded_conv2d(local, weight,
                                    mesh.group(SPATIAL_AXIS), edge_mode), h)
        return gather_rows(y, mesh)

    return fn


__all__ = ["all_reduce_sum", "avg_pool_rows", "check_spatial_divisible",
           "conv2d_local", "conv_rows", "gather_rows", "global_count",
           "make_sharded_conv", "max_pool_rows", "mean_f32", "mean_of",
           "out_rows", "sharded_conv2d", "spatial_ring",
           "take_rows", "tv_rows", "upsample_rows", "window_halos",
           "window_rows"]
