"""Convolution layers on channels_last (N, C, H, W) tensors (counterparts
of ``p2p_tpu/ops/conv.py:104 reflect_pad_2d``, ``:116 ConvLayer``, ``:452
upsample_nearest``, ``:462 subpixel_interleave``, ``:478
_PallasHeadConv``, ``:516 SubpixelDeconv`` and ``:646
UpsampleConvLayer``, and of flax's ``nn.ConvTranspose``).

The reflect-padded layers are reflect pad + ``F.conv2d``, which PyTorch
hands to cuDNN on the card, as XLA computed these convolutions outside
any Pallas kernel; so are the U-Net's strided and transposed convs. The
one Pallas conv of the JAX package, the subpixel head's
(``SubpixelDeconv(pallas=True)``), runs through the Hopper kernels #6/#7.
The JAX package's automatic dispatch forms (``ThinHeadConv`` :375 and
``_NearestUp2Conv`` :583, gated at ``_THIN_DISPATCH_MIN_PIXELS`` :76) and
its opt-in ``PatchesConv`` (:253, the U-Net's ``thin_stem``) are exact
rewrites of this same convolution for the TPU's matrix unit, with the
same kernel parameters, so here they are this one conv. Parameter names
follow the flax tree (``conv`` holds ``Conv_0``), which keeps convert.py
a direct mapping.

``ConvLayer(int8=True)`` (``p2p_tpu/ops/conv.py:116-145``) runs its conv
on the int8 path of ops/int8.py.

``dtype`` is flax's ``dtype=``: the conv's input, weight and bias are cast
to it (bf16 compute on f32 master weights in training); ``None`` computes
in the promoted type of input and weight.

Rematerialization (``ParallelConfig.remat``; ``p2p_tpu/ops/conv.py:26
remat_wrap``): :func:`remat_call` runs a generator block's forward under
``torch.utils.checkpoint`` (non-reentrant). ``True``/``"full"`` keeps only
the block's input and recomputes the whole block in the backward (its
convs, #1, #3, #5 and sync-BatchNorm's all-reduce again); ``"conv"`` is a
selective policy: the conv outputs (``aten.convolution``) and the norm
statistics are kept and only the elementwise chain is recomputed (#3 and
the plain norms' elementwise ops again; #1's, #5's and the all-reduced
sums' results are replayed from a :class:`StatsTape`, and the plain
instance norm's means are kept as ``aten.mean`` outputs). The recompute
sees the block's buffers (BatchNorm running statistics, stored int8
scales) as the forward saw them, and puts back what the forward wrote, so
a buffer moves once a step, and it runs in the forward's context (the
active mesh and sync-BatchNorm setting), whatever thread the backward
recomputes on.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable, Iterator, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from p2p_tpu_torch.core.mesh import spatial_mesh
from p2p_tpu_torch.ops.cuda.subpixel_head import subpixel_head_conv


def cast_conv(conv: nn.Module, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``conv(x)`` for an ``nn.Conv2d`` or an ``nn.ConvTranspose2d``, with
    input, weight and bias cast to ``dtype`` (or to the promoted type of x
    and the weight), with the conv's own stride and zero padding. Flax's
    ``ConvTranspose(k4, s2, "SAME")`` is ``nn.ConvTranspose2d(k4, stride
    2, padding 1)`` with its kernel flipped in both spatial axes
    (``convert.py`` maps it)."""
    dt = dtype or torch.promote_types(x.dtype, conv.weight.dtype)
    bias = None if conv.bias is None else conv.bias.to(dt)
    fn = (F.conv_transpose2d if isinstance(conv, nn.ConvTranspose2d)
          else F.conv2d)
    return fn(x.to(dt), conv.weight.to(dt), bias, conv.stride, conv.padding)


def _fold_reflected(g: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """The gradient of a reflection pad of ``pad`` along ``dim``: the
    middle, then each border flipped and added onto the entries it
    copied, in that order."""
    n = g.shape[dim] - 2 * pad
    out = g.narrow(dim, pad, n).clone()
    out.narrow(dim, 1, pad).add_(g.narrow(dim, 0, pad).flip(dim))
    out.narrow(dim, n - 1 - pad, pad).add_(
        g.narrow(dim, n + pad, pad).flip(dim))
    return out


class _FixedOrderReflectPad(torch.autograd.Function):
    """``F.pad(mode="reflect")`` whose backward adds every entry's terms in
    one fixed order (W's borders, then H's)."""

    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad = pad
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")

    @staticmethod
    def backward(ctx, g):
        p = ctx.pad
        return _fold_reflected(_fold_reflected(g, p, -1), p, -2), None


class _FixedOrderReflectPadW(torch.autograd.Function):
    """The same along W only."""

    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad = pad
        return F.pad(x, (pad, pad, 0, 0), mode="reflect")

    @staticmethod
    def backward(ctx, g):
        return _fold_reflected(g, ctx.pad, -1), None


def _fixed_order(x: torch.Tensor) -> bool:
    """Whether a CUDA tensor's reflect pad should add its backward in a
    fixed order (the caller asks for reproducible runs)."""
    return x.is_cuda and (torch.backends.cudnn.deterministic
                          or torch.are_deterministic_algorithms_enabled())


def reflect_pad_2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection-pad H and W. PyTorch's CUDA backward of the reflect pad
    adds the borders onto the input's gradient with atomics, so two runs
    differ in their last bits; where the caller asks for reproducible runs
    (``torch.backends.cudnn.deterministic`` or PyTorch's deterministic
    algorithms), a CUDA tensor's backward adds them in a fixed order
    instead. The forward is the same either way. Under a spatial mesh
    (``x`` one rank's block of rows) H is padded through the halo
    exchange: ``pad`` neighbour rows on each side, reflected rows at the
    image's top and bottom (parallel/halo.py), W locally."""
    if pad == 0:
        return x
    if spatial_mesh() is not None:
        from p2p_tpu_torch.parallel.halo import halo_exchange
        from p2p_tpu_torch.parallel.spatial import spatial_ring

        ring = spatial_ring(spatial_mesh())
        return reflect_pad_w(halo_exchange(x, 2, pad, ring.group,
                                           "reflect"), pad)
    if _fixed_order(x):
        return _FixedOrderReflectPad.apply(x, pad)
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def reflect_pad_w(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection-pad W only (the local half of a spatial reflect pad),
    in a fixed order where :func:`reflect_pad_2d` uses one."""
    if pad == 0:
        return x
    if _fixed_order(x):
        return _FixedOrderReflectPadW.apply(x, pad)
    return F.pad(x, (pad, pad, 0, 0), mode="reflect")


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour ×factor upsample of H and W."""
    if factor == 1:
        return x
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class StatsTape:
    """The norm statistics of one remat'd block: recorded in its forward,
    replayed in order by its recompute (the ``"conv"`` policy)."""

    def __init__(self):
        self.records: List[Tuple[torch.Tensor, ...]] = []
        self.replay = False
        self._next = 0

    def take(self, compute: Callable[[], Tuple[torch.Tensor, ...]]
             ) -> Tuple[torch.Tensor, ...]:
        if self.replay:
            out = self.records[self._next]
            self._next += 1
            return tuple(t.detach() for t in out)
        out = compute()
        self.records.append(tuple(t.detach() for t in out))
        return out


_TAPE: contextvars.ContextVar[Optional[StatsTape]] = contextvars.ContextVar(
    "p2p_tpu_torch_stats_tape", default=None)


def taped(compute: Callable[[], Tuple[torch.Tensor, ...]]
          ) -> Tuple[torch.Tensor, ...]:
    """``compute()`` (a tuple of statistics tensors), or its recorded
    result while a ``"conv"`` recompute replays the block's tape."""
    tape = _TAPE.get()
    return compute() if tape is None else tape.take(compute)


@contextlib.contextmanager
def _taping(tape: Optional[StatsTape]) -> Iterator[None]:
    token = _TAPE.set(tape)
    try:
        yield
    finally:
        _TAPE.reset(token)


REMAT_MODES = (False, True, "full", "conv")


def _conv_policy(ctx, op, *args, **kwargs):
    """Keep the conv outputs and the plain norms' means; recompute the
    rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.convolution.default,
              torch.ops.aten.mean.dim):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def check_remat(mode: Union[bool, str]) -> None:
    if mode not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {mode!r}; expected False, "
                         "True/'full', or 'conv'")


def remat_call(module: nn.Module, fn: Callable[..., torch.Tensor],
               *args: torch.Tensor, mode: Union[bool, str] = False
               ) -> torch.Tensor:
    """``fn(*args)``, ``module``'s forward, rematerialized per ``mode``
    (module docstring); as it is when ``mode`` is off or no gradient is
    recorded."""
    check_remat(mode)
    if not mode or not torch.is_grad_enabled():
        return fn(*args)
    if spatial_mesh() is not None:
        raise NotImplementedError(
            "remat under a spatial mesh is not ported: the recompute would "
            "repeat the blocks' halo exchanges and statistics all-reduces "
            "out of order; set ParallelConfig.remat off")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    bufs = list(module.buffers())
    before = [b.detach().clone() for b in bufs]
    tape = StatsTape() if mode == "conv" else None
    forward_ctx = contextvars.copy_context()
    calls = [0]

    def put(values: List[torch.Tensor]) -> None:
        if bufs:
            with torch.no_grad():
                torch._foreach_copy_(bufs, values)

    def block(first: bool, *a):
        # the same ops in the forward and in the recompute (the selective
        # policy matches the two runs op by op): the recompute starts from
        # the buffers the forward saw and ends on those it wrote
        now = [b.detach().clone() for b in bufs]
        put(before)
        with _taping(tape):
            out = fn(*a)
        tail = [b.detach().clone() for b in bufs]
        put(tail if first else now)
        return out

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return block(True, *a)
        if tape is not None:
            tape.replay = True
        return forward_ctx.run(block, False, *a)

    kw = {}
    if mode == "conv":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _conv_policy)
    return checkpoint(run, *args, use_reentrant=False, **kw)


class ConvLayer(nn.Module):
    """ReflectionPad(k//2) + conv, no norm or activation. With ``int8``
    the conv is an ``ops.int8.QuantConv`` with zero padding 0 (stored
    scales with ``int8_delayed``) and the reflect pad stays outside; the
    state dict gains only ``conv.amax_x``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_delayed: bool = False):
        super().__init__()
        self.pad = kernel_size // 2
        self.dtype = dtype
        self.int8 = int8
        if int8:
            # ops/int8.py builds on this module's SubpixelConv
            from p2p_tpu_torch.ops.int8 import QuantConv

            self.conv = QuantConv(in_channels, features, kernel_size,
                                  stride=stride, padding=0, bias=use_bias,
                                  dtype=dtype, delayed=int8_delayed)
        else:
            self.conv = nn.Conv2d(in_channels, features, kernel_size,
                                  stride=stride, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial_mesh() is not None:
            return _conv_rows(self, x)
        x = reflect_pad_2d(x, self.pad)
        if self.int8:
            return self.conv(x)
        return cast_conv(self.conv, x, self.dtype)


class UpsampleConvLayer(nn.Module):
    """Optional nearest ×upsample → ReflectionPad(k//2) → conv."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, upsample: int = 0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.upsample = upsample
        self.pad = kernel_size // 2
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, features, kernel_size,
                              stride=stride, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial_mesh() is not None:
            if self.upsample:
                from p2p_tpu_torch.parallel.spatial import upsample_rows

                x = upsample_rows(x, self.upsample)
            return _conv_rows(self, x)
        if self.upsample:
            x = upsample_nearest(x, self.upsample)
        return cast_conv(self.conv, reflect_pad_2d(x, self.pad), self.dtype)


def _conv_rows(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer``'s reflect-padded conv on this rank's block of rows under a
    spatial mesh (parallel/spatial.py ``conv_rows``)."""
    from p2p_tpu_torch.parallel.spatial import conv_rows

    conv = layer.conv
    if not isinstance(conv, nn.Conv2d):
        raise NotImplementedError(
            f"{type(conv).__name__} has no form under a spatial mesh (the "
            "int8 convs are not ported to the spatial axis)")
    return conv_rows(x, conv.weight, conv.bias, conv.stride[0], layer.pad,
                     "reflect", layer.dtype)


def subpixel_interleave(out: torch.Tensor, features: int) -> torch.Tensor:
    """The shifted depth-to-space of :class:`SubpixelDeconv`: the k2-s1
    conv's (N, 4F, H+1, W+1) output → (N, F, 2H, 2W) with
    ``y[2i+u, 2j+v, f] = out[i+u, j+v, (2u+v)·F + f]``; pure indexing, so
    bitwise the JAX function."""
    n, _, h1, w1 = out.shape
    h, w, f = h1 - 1, w1 - 1, features
    o = out.reshape(n, 2, 2, f, h1, w1)
    rows = [torch.stack([o[:, u, v, :, u:u + h, v:v + w] for v in range(2)],
                        dim=-1) for u in range(2)]          # (N,F,H,W,2)
    y = torch.stack(rows, dim=3)                            # (N,F,H,2,W,2)
    return y.reshape(n, f, 2 * h, 2 * w).contiguous(
        memory_format=torch.channels_last)


class SubpixelConv(nn.Module):
    """The k2-s1 pad-1 conv inside :class:`SubpixelDeconv` (the flax
    ``Conv_0``): its kernel stays in flax's HWIO layout (2, 2, C, 4F),
    the layout kernel #6 reads."""

    def __init__(self, in_channels: int, features: int,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(2, 2, in_channels, features))
        nn.init.normal_(self.kernel, 0.0, 0.02)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None


class SubpixelDeconv(nn.Module):
    """ConvTranspose(k4, s2, "SAME") as a k2-s1 pad-1 conv to 4·F channels
    + :func:`subpixel_interleave`. ``pallas`` runs the conv through the
    Hopper kernels #6/#7 (the JAX ``_PallasHeadConv``): x and the kernel in
    the compute dtype (f32 when ``dtype`` is None), z in f32, the f32 bias
    added in f32, then cast to the compute dtype. Otherwise it is one
    library conv in the compute dtype with the bias, as flax's ``nn.Conv``.
    """

    def __init__(self, in_channels: int, features: int,
                 use_bias: bool = True, pallas: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.pallas = pallas
        self.dtype = dtype
        self.conv = SubpixelConv(in_channels, 4 * features, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.conv.kernel, self.conv.bias
        if self.pallas:
            dt = self.dtype or torch.float32
            # the kernels take x in channels_last and the HWIO kernel
            # dense (a module moved to channels_last relayouts its 4-D
            # parameters)
            z = subpixel_head_conv(
                x.to(dt).contiguous(memory_format=torch.channels_last),
                kernel.to(dt).contiguous())
            if bias is not None:
                z = z + bias.view(1, -1, 1, 1)
            out = z.to(dt)
        else:
            dt = self.dtype or torch.promote_types(x.dtype, kernel.dtype)
            out = F.conv2d(x.to(dt), kernel.to(dt).permute(3, 2, 0, 1),
                           None if bias is None else bias.to(dt), padding=1)
        return subpixel_interleave(out, self.features)
