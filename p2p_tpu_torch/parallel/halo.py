"""Halo exchange over a process group (counterpart of
``p2p_tpu/parallel/halo.py:38 halo_exchange`` and ``:92 ring_shift``).

Each rank of a group holds a contiguous block of rows of a tensor split
along one dimension, rank ``i`` the ``i``-th block. Before a windowed op
can produce its rows, each rank needs some rows owned by its neighbours.
:func:`exchange_rows` is that exchange in general form: rank ``i`` asks
for ``lo[i]`` rows before its block and ``hi[i]`` after it (a negative
count drops that many of its own rows instead), every rank knowing every
rank's counts (they follow from the row layout, core/mesh.row_block). At
the outer edges of the split dimension the rows are made by ``edge_mode``,
as the padding of the op being reproduced makes them: ``"reflect"`` (the
ReflectionPad convs), ``"zero"`` (the zero-padded convs and pools),
``"wrap"`` (periodic: the first rank's rows before come from the last
rank). :func:`halo_exchange` is the JAX function: ``halo`` rows on both
sides of every block.

The exchange is a ``torch.autograd.Function``. Its backward is the
adjoint exchange: the gradient of the rows a rank received goes back to
their owner, who adds it onto the rows it sent; the gradient of the rows
made by ``"reflect"`` is folded back onto the rows they copied, in the
fixed order of ``ops/conv._fold_reflected``; ``"zero"`` rows' gradient is
dropped. Every add is a plain add in one fixed order, so the backward
repeats its bits.

Two transports, picked by rule from the group's backend and the tensor's
device (:func:`route_for`), and counted by route (:data:`halo_stats`:
calls, and bytes this rank sent):

- ``"p2p"``: ``dist.batch_isend_irecv`` with each neighbour, under NCCL,
  and under gloo on CPU tensors;
- ``"slot"``: under gloo on CUDA tensors, whose collectives are only
  ``all_reduce`` and ``broadcast``: every rank writes the rows it sends
  into its own slot of a zeroed buffer, one ``all_reduce`` (SUM) over the
  group adds the slots, and each rank reads the slots addressed to it.
  The buffer is summed as 32-bit integer words, so a slot written by one
  rank and zero elsewhere comes back with its exact bits.

:func:`gather_blocks` is the same device for a whole tensor: each rank's
block in place in one zeroed buffer, one ``all_reduce``, the whole tensor
on every rank with exact bits (a map's rows, a clip's frames, a conv's
channel slices, a serving batch's rows).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

EDGE_MODES = ("reflect", "zero", "wrap")
ROUTES = ("p2p", "slot")
# tags of the two directions of a P2P swap (gloo matches on them)
_TO_NEXT, _TO_PREV = 0, 1

#: exchanges made (forward and backward each count one) and the bytes
#: this rank sent in them, by route
halo_stats: Dict[str, Dict[str, int]] = {r: {"calls": 0, "bytes": 0}
                                         for r in ROUTES}


def reset_halo_stats() -> None:
    for r in ROUTES:
        halo_stats[r]["calls"] = halo_stats[r]["bytes"] = 0


@dataclasses.dataclass(frozen=True)
class Ring:
    """The ranks of ``group`` in axis order (global ranks) and this rank's
    place among them; ``group`` None is the default group."""

    group: Optional[object]
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def ring_of(group=None) -> Ring:
    """The :class:`Ring` of ``group`` (None: the default group) through
    this rank."""
    ranks = tuple(dist.get_process_group_ranks(group)
                  if group is not None else range(dist.get_world_size()))
    return Ring(group, ranks, ranks.index(dist.get_rank()))


def route_for(x: torch.Tensor, group=None) -> str:
    """The transport of an exchange of ``x`` over ``group``: ``"p2p"``
    under NCCL or for a CPU tensor, ``"slot"`` for a CUDA tensor under
    gloo (which has no point-to-point ops on CUDA tensors)."""
    backend = dist.get_backend(group)
    if backend == "nccl" or x.device.type == "cpu":
        return "p2p"
    if backend == "gloo":
        return "slot"
    raise ValueError(f"no halo transport for backend {backend!r} on "
                     f"{x.device}")


def _swap(ring: Ring, route: str, to_next: Optional[torch.Tensor],
          to_prev: Optional[torch.Tensor], next_counts: Sequence[int],
          prev_counts: Sequence[int], row_shape: Tuple[int, ...],
          dtype: torch.dtype, device: torch.device, wrap: bool
          ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Send ``to_next`` to the next rank and ``to_prev`` to the previous
    one; return ``(from_prev, from_next)``. ``next_counts[r]`` /
    ``prev_counts[r]`` are the rows rank ``r`` sends each way (0: none),
    known alike on every rank; a piece is ``(rows,) + row_shape`` with the
    split dimension first."""
    n, i = ring.size, ring.index

    def peer(k):
        if 0 <= k < n:
            return k
        return k % n if wrap else None

    nxt, prv = peer(i + 1), peer(i - 1)
    n_from_prev = next_counts[prv] if prv is not None else 0
    n_from_next = prev_counts[nxt] if nxt is not None else 0
    if not any(next_counts) and not any(prev_counts):
        return None, None
    row_el = 1
    for d in row_shape:
        row_el *= d
    item = torch.empty((), dtype=dtype).element_size()
    sent = sum(t.numel() for t in (to_next, to_prev) if t is not None)
    halo_stats[route]["calls"] += 1
    halo_stats[route]["bytes"] += sent * item
    if route == "p2p":
        ops = []
        from_prev = from_next = None
        if to_next is not None:
            ops.append(dist.P2POp(dist.isend, to_next, ring.ranks[nxt],
                                  ring.group, _TO_NEXT))
        if n_from_prev:
            from_prev = torch.empty((n_from_prev,) + row_shape, dtype=dtype,
                                    device=device)
            ops.append(dist.P2POp(dist.irecv, from_prev, ring.ranks[prv],
                                  ring.group, _TO_NEXT))
        if to_prev is not None:
            ops.append(dist.P2POp(dist.isend, to_prev, ring.ranks[prv],
                                  ring.group, _TO_PREV))
        if n_from_next:
            from_next = torch.empty((n_from_next,) + row_shape, dtype=dtype,
                                    device=device)
            ops.append(dist.P2POp(dist.irecv, from_next, ring.ranks[nxt],
                                  ring.group, _TO_PREV))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_prev, from_next
    if route != "slot":
        raise ValueError(f"unknown halo route {route!r} (have {ROUTES})")
    got = _slots(ring, {(r, way): counts[r] * row_el * item
                        for r in range(n)
                        for way, counts in (("next", next_counts),
                                            ("prev", prev_counts))},
                 {"next": to_next, "prev": to_prev}, device)
    return (got(prv, "next", dtype, (n_from_prev,) + row_shape)
            if n_from_prev else None,
            got(nxt, "prev", dtype, (n_from_next,) + row_shape)
            if n_from_next else None)


def _slots(ring: Ring, sizes, mine, device: torch.device):
    """The slot transport: every rank's pieces (``sizes[(rank, key)]``
    bytes, known alike on every rank) laid out in one zeroed buffer of
    32-bit words, 16-byte aligned, in rank order; this rank writes
    ``mine[key]`` into its slots, one ``all_reduce`` (SUM) over the ring
    adds them, and the returned ``read(rank, key, dtype, shape)`` copies a
    slot out."""
    read, work = _slots_start(ring, sizes, mine, device)
    work.wait()
    return read


def _slots_start(ring: Ring, sizes, mine, device: torch.device):
    """:func:`_slots` with its ``all_reduce`` started asynchronously:
    ``(read, work)``, ``read`` valid after ``work.wait()``."""
    offsets, off = {}, 0
    for key in sorted(sizes):
        offsets[key] = (off, sizes[key])
        off += -(-sizes[key] // 16) * 16
    words = torch.zeros(off // 4, dtype=torch.int32, device=device)
    raw = words.view(torch.uint8)
    for key, piece in mine.items():
        if piece is not None:
            o, nb = offsets[ring.index, key]
            raw[o:o + nb].copy_(piece.contiguous().view(-1).view(torch.uint8))
    work = dist.all_reduce(words, group=ring.group, async_op=True)

    def read(r, key, dtype, shape):
        o, nb = offsets[r, key]
        return raw[o:o + nb].view(dtype).view(shape).clone()

    return read, work


def _rows_first(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with the split dimension first, contiguous (a piece to
    send)."""
    return t.movedim(dim, 0).contiguous()


def _rows_back(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.movedim(0, dim)


def _fold_lo(out: torch.Tensor, g: torch.Tensor, dim: int) -> None:
    """Add the gradient of reflect rows made before the first row (rows
    ``k..1`` reversed) onto rows ``1..k``."""
    k = g.shape[dim]
    out.narrow(dim, 1, k).add_(g.flip(dim))


def _fold_hi(out: torch.Tensor, g: torch.Tensor, dim: int) -> None:
    k = g.shape[dim]
    h = out.shape[dim]
    out.narrow(dim, h - 1 - k, k).add_(g.flip(dim))


class _Exchange(torch.autograd.Function):
    """The forward and adjoint exchange of :func:`exchange_rows`."""

    @staticmethod
    def forward(ctx, x, dim, lo, hi, ring, edge_mode, route):
        n, i = ring.size, ring.index
        h = x.shape[dim]
        wrap = edge_mode == "wrap"
        first, last = i == 0, i == n - 1
        a, b = max(0, -lo[i]), max(0, -hi[i])
        need_lo, need_hi = max(0, lo[i]), max(0, hi[i])
        if h - a - b < 0 or (edge_mode == "reflect" and (
                (first and need_lo >= h) or (last and need_hi >= h))):
            raise ValueError(f"local shard extent {h} along dim {dim} too "
                             f"small for halo ({lo[i]}, {hi[i]}) (need at "
                             "least halo+1 rows per shard)")
        # rows each rank sends its next / previous neighbour: what that
        # neighbour asks for, unless the edge makes it
        next_counts = [max(0, lo[r + 1]) if r + 1 < n else
                       (max(0, lo[0]) if wrap else 0) for r in range(n)]
        prev_counts = [max(0, hi[r - 1]) if r > 0 else
                       (max(0, hi[n - 1]) if wrap else 0) for r in range(n)]
        if next_counts[i] > h or prev_counts[i] > h:
            raise ValueError(f"local shard extent {h} along dim {dim} too "
                             "small for the halo a neighbour needs (need "
                             "at least halo+1 rows per shard)")
        to_next = (_rows_first(x.narrow(dim, h - next_counts[i],
                                         next_counts[i]), dim)
                   if next_counts[i] else None)
        to_prev = (_rows_first(x.narrow(dim, 0, prev_counts[i]), dim)
                   if prev_counts[i] else None)
        row_shape = tuple(x.movedim(dim, 0).shape[1:])
        from_prev, from_next = _swap(ring, route, to_next, to_prev,
                                     next_counts, prev_counts, row_shape,
                                     x.dtype, x.device, wrap)
        parts = []
        if need_lo:
            if first and not wrap:
                parts.append(x.narrow(dim, 1, need_lo).flip(dim)
                             if edge_mode == "reflect" else
                             x.new_zeros(_shape_with(x, dim, need_lo)))
            else:
                parts.append(_rows_back(from_prev, dim))
        parts.append(x.narrow(dim, a, h - a - b))
        if need_hi:
            if last and not wrap:
                parts.append(x.narrow(dim, h - 1 - need_hi, need_hi).flip(dim)
                             if edge_mode == "reflect" else
                             x.new_zeros(_shape_with(x, dim, need_hi)))
            else:
                parts.append(_rows_back(from_next, dim))
        y = torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0].clone()
        fmt = _dense_format(x)
        if fmt is not None:
            y = y.contiguous(memory_format=fmt)
        ctx.args = (dim, lo, hi, ring, edge_mode, route, h, next_counts,
                    prev_counts, row_shape)
        return y

    @staticmethod
    def backward(ctx, g):
        (dim, lo, hi, ring, edge_mode, route, h, next_counts, prev_counts,
         row_shape) = ctx.args
        n, i = ring.size, ring.index
        wrap = edge_mode == "wrap"
        first, last = i == 0, i == n - 1
        a, b = max(0, -lo[i]), max(0, -hi[i])
        need_lo, need_hi = max(0, lo[i]), max(0, hi[i])
        mid = h - a - b
        g_lo = g.narrow(dim, 0, need_lo) if need_lo else None
        g_hi = g.narrow(dim, need_lo + mid, need_hi) if need_hi else None
        dx = g.new_zeros(_shape_with(g, dim, h))
        fmt = _dense_format(g)
        if fmt is not None:
            dx = dx.contiguous(memory_format=fmt)
        dx.narrow(dim, a, mid).copy_(g.narrow(dim, need_lo, mid))
        # the adjoint swap: the rows received from the previous rank go
        # back to it, those from the next to it
        back_prev = (g_lo if g_lo is not None and (wrap or not first)
                     else None)
        back_next = (g_hi if g_hi is not None and (wrap or not last)
                     else None)
        if edge_mode == "reflect":
            if g_lo is not None and first:
                _fold_lo(dx, g_lo, dim)
            if g_hi is not None and last:
                _fold_hi(dx, g_hi, dim)
        # every rank sends back the rows it received: to the next rank
        # its rows after, to the previous its rows before
        back_next_counts = [max(0, hi[r]) if r < n - 1 or wrap else 0
                            for r in range(n)]
        back_prev_counts = [max(0, lo[r]) if r > 0 or wrap else 0
                            for r in range(n)]
        from_prev, from_next = _swap(
            ring, route,
            None if back_next is None else _rows_first(back_next, dim),
            None if back_prev is None else _rows_first(back_prev, dim),
            back_next_counts, back_prev_counts, row_shape, g.dtype,
            g.device, wrap)
        # what the next rank got from this one (its rows before) comes
        # back onto this rank's last rows; the previous rank's onto the
        # first
        if from_next is not None:
            dx.narrow(dim, h - next_counts[i], next_counts[i]).add_(
                _rows_back(from_next, dim))
        if from_prev is not None:
            dx.narrow(dim, 0, prev_counts[i]).add_(_rows_back(from_prev, dim))
        return dx, None, None, None, None, None, None


def _dense_format(x: torch.Tensor) -> Optional[torch.memory_format]:
    """``torch.channels_last`` for a channels_last 4-D tensor,
    ``torch.channels_last_3d`` for a channels_last_3d clip (the layouts an
    exchange keeps), else None."""
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    if x.dim() == 5 and x.is_contiguous(
            memory_format=torch.channels_last_3d):
        return torch.channels_last_3d
    return None


def _shape_with(x: torch.Tensor, dim: int, size: int) -> Tuple[int, ...]:
    shape = list(x.shape)
    shape[dim] = size
    return tuple(shape)


def gather_blocks(x: torch.Tensor, dim: int, full: int, start: int,
                  group=None) -> torch.Tensor:
    """The whole tensor, ``full`` long along ``dim``, on every rank of
    ``group`` from each rank's block ``x`` (its part ``[start, start +
    x.shape[dim])``): one ``all_reduce`` (SUM) of a zeroed buffer that
    holds each block in place, summed as 32-bit integer words, so the bits
    are exact on every backend and device. The layout is x's
    (channels_last and channels_last_3d kept). Not differentiable."""
    shape = _shape_with(x, dim, full)
    nbytes = math.prod(shape) * x.element_size()
    words = torch.zeros(-(-nbytes // 4), dtype=torch.int32, device=x.device)
    flat = words.view(torch.uint8)[:nbytes].view(x.dtype)
    if _dense_format(x) is None:
        out = flat.view(shape)
    else:                                   # stored N(T)HWC
        last = (0,) + tuple(range(2, x.dim())) + (1,)
        out = flat.view([shape[d] for d in last]).permute(
            (0, x.dim() - 1) + tuple(range(1, x.dim() - 1)))
    out.narrow(dim, start, x.shape[dim]).copy_(x.detach())
    dist.all_reduce(words, group=group)
    return out


def check_halos(heights: Sequence[int], lo: Sequence[int],
                hi: Sequence[int], edge_mode: str) -> None:
    """Raise, on every rank alike, when some rank's block is too small for
    what it or a neighbour needs (at least halo + 1 rows a block, as the
    JAX exchange requires): a rank's neighbours' rows must cover its halo,
    and a reflected edge must have a row to reflect about."""
    n = len(heights)
    wrap = edge_mode == "wrap"
    for r in range(n):
        h = heights[r]
        need = [max(0, lo[r + 1]) if r + 1 < n or wrap else 0,
                max(0, hi[r - 1]) if r > 0 or wrap else 0]
        if r + 1 == n and wrap:
            need[0] = max(0, lo[0])
        if r == 0 and wrap:
            need[1] = max(0, hi[n - 1])
        edge = [lo[r] if r == 0 and not wrap else 0,
                hi[r] if r == n - 1 and not wrap else 0]
        refl = edge_mode == "reflect" and max(edge) >= h
        if max(need) > h or refl or h - max(0, -lo[r]) - max(0, -hi[r]) < 0:
            raise ValueError(
                f"spatial block {r} has {h} rows, too few for halos "
                f"{list(zip(lo, hi))} (need at least halo+1 rows per "
                "shard)")


def exchange_rows(x: torch.Tensor, dim: int, lo: Sequence[int],
                  hi: Sequence[int], ring: Ring, edge_mode: str = "zero",
                  route: Optional[str] = None,
                  heights: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` grown by ``lo[i]`` rows
    before and ``hi[i]`` after (``i`` = ``ring.index``; a negative count
    drops rows), the outer edges made by ``edge_mode``. ``lo`` and ``hi``
    hold every rank's counts; ``heights``, every rank's block size when
    known, lets every rank refuse a layout alike before any transfer (a
    refusal on one rank alone would leave the others waiting). ``route``
    None picks the transport by rule (:func:`route_for`); a test names
    one."""
    if edge_mode not in EDGE_MODES:
        raise ValueError(f"unknown edge_mode {edge_mode!r}")
    if len(lo) != ring.size or len(hi) != ring.size:
        raise ValueError("lo and hi need one count per rank of the ring")
    if heights is not None:
        check_halos(heights, lo, hi, edge_mode)
    dim = dim % x.dim()
    if route is None:
        route = route_for(x, ring.group)
    elif route not in ROUTES:
        raise ValueError(f"unknown halo route {route!r} (have {ROUTES})")
    return _Exchange.apply(x, dim, tuple(int(v) for v in lo),
                           tuple(int(v) for v in hi), ring, edge_mode, route)


def halo_exchange(x: torch.Tensor, dim: int, halo: int, group=None,
                  edge_mode: str = "reflect",
                  route: Optional[str] = None) -> torch.Tensor:
    """This rank's block grown by ``halo`` neighbour rows on both sides of
    ``dim`` (the first and last blocks' outer rows made by ``edge_mode``),
    as the JAX function inside ``shard_map``. Raises when a block has fewer
    than ``halo + 1`` rows."""
    if halo == 0:
        return x
    if x.shape[dim] < halo + 1:
        raise ValueError(
            f"local shard extent {x.shape[dim]} along dim {dim} too small "
            f"for halo {halo} (need at least halo+1 rows per shard)")
    ring = ring_of(group)
    return exchange_rows(x, dim, [halo] * ring.size, [halo] * ring.size,
                         ring, edge_mode, route)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, shift, route):
        ctx.ring, ctx.shift, ctx.route = ring, shift, route
        return _shift(x, ring, shift, route)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.ring, -ctx.shift, ctx.route), None, None, None


def _shift(x: torch.Tensor, ring: Ring, shift: int, route: str
           ) -> torch.Tensor:
    return shift_start(x, ring, shift, route)()


def shift_start(x: torch.Tensor, ring: Ring, shift: int, route: str,
                stats: Optional[Dict[str, Dict[str, int]]] = None):
    """Start a cyclic shift of the ranks' ``x`` around ``ring`` (rank ``i``
    gets rank ``i − shift``'s) without waiting for it: returns ``wait()``,
    which waits and returns the received tensor in x's dense layout
    (channels_last kept; not differentiable). The transfer is counted in
    ``stats`` (:data:`halo_stats` by default) by route. Every rank of the
    ring must start the same shifts in one order."""
    n, i = ring.size, ring.index
    src, dst = (i - shift) % n, (i + shift) % n
    if src == i:
        out = x.clone()
        return lambda: out
    stats = halo_stats if stats is None else stats
    stats[route]["calls"] += 1
    stats[route]["bytes"] += x.numel() * x.element_size()
    fmt = _dense_format(x)

    def laid_out(t: torch.Tensor) -> torch.Tensor:
        return t if fmt is None else t.contiguous(memory_format=fmt)

    if route == "p2p":
        # gloo sends and receives dense row-major buffers only
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(), ring.ranks[dst],
                       ring.group, _TO_NEXT),
            dist.P2POp(dist.irecv, out, ring.ranks[src], ring.group,
                       _TO_NEXT)])

        def wait_p2p():
            for req in reqs:
                req.wait()
            return laid_out(out)

        return wait_p2p
    nbytes = x.numel() * x.element_size()
    read, work = _slots_start(
        ring, {(r, "x"): nbytes for r in range(n)}, {"x": x.contiguous()},
        x.device)

    def wait_slot():
        work.wait()
        return laid_out(read(src, "x", x.dtype, x.shape))

    return wait_slot


def ring_shift(x: torch.Tensor, group=None, shift: int = 1,
               route: Optional[str] = None) -> torch.Tensor:
    """Cyclically shift the ranks' tensors around the group's ring: rank
    ``i`` gets rank ``i − shift``'s (the JAX ``ppermute`` with pairs ``(i,
    i + shift)``); its gradient shifts back."""
    ring = ring_of(group)
    if route is None:
        route = route_for(x, group)
    return _RingShift.apply(x, ring, shift, route)
