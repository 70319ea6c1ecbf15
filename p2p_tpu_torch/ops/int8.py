"""int8 quantization-aware convolutions (counterpart of ``p2p_tpu/ops/
int8.py``: ``absmax_scale`` :76, ``quantize_int8`` :83, the int32 conv
:89, XLA's VJP paddings :102 and :114, the backward core :150,
``int8_conv`` :126, ``int8_conv_ds`` :280, the kn2row pair :350-471,
``int8_conv_pq`` :488, ``amax_update`` :568, the stored-scale plumbing
:586-631, ``surrogate_tap`` :606, ``QuantConv`` :634,
``QuantSubpixelDeconv`` :709 and ``QuantConvTranspose`` :738).

Scheme (per conv): a per-tensor activation scale ``sx`` and a per-output-
channel weight scale ``sw = max|w[o]| / 127`` taken on the weight cast to
the compute dtype; ``y = (Q(x) ⊛ Q(w))_int32 · (sx·sw)``. The backward is
the exact gradient of the dequantized surrogate (straight through both
quantizers), in the JAX package's per-form dispatch:

- dgrad of a stride-1 conv (a transposed conv's included): ``s_w`` folded
  into the cotangent, ``g̃ = g·s_w``, quantized with its own dynamic
  scale, and an int8 conv of ``Q(g̃)`` with the flipped, transposed
  ``Q(w)``, window strides = the forward's ``lhs_dilation``, padded as
  XLA's VJP pads it (:func:`_vjp_lhs_padding`); stride 2: a bf16 dgrad on
  the dequantized weight ``ŵ``;
- wgrad of a conv without ``lhs_dilation``: ``dw = sx·sg·(Q(x) ⊛ Q(g))``
  as one int8 product over ``N·Ho·Wo`` when ``Ho·Wo ≤ 4096``; above it,
  and for a transposed conv, a bf16 wgrad on the dequantized ``x̂``,
  zero-inserted and padded as :func:`_vjp_rhs_padding` says.

The bf16 forms round their operands to bf16 and run the library's f32
conv gradients (f32 accumulation, as ``preferred_element_type=f32``; on
the card TF32 holds bf16 values exactly). Padding is an int, an (h, w)
pair (both sides) or ((lo, hi), (lo, hi)); a negative pad crops.
``lhs_dilation`` inserts zeros between input pixels (a transposed conv,
:class:`QuantConvTranspose`); zero insertion of int8 values is exact.

The kn2row pair (:func:`int8_kn2row_conv`, :func:`int8_kn2row_conv_ds`,
D's thin logits head) has the forward of a stride-1 int8 conv with zero
padding ``pad``, computed here as one im2col product (the JAX tap
shift-adds sum the same integers), and a backward of its own: the dgrad
in bf16 (``bf16(g)`` against ``ŵ`` in bf16, f32 accumulation, cropped to
the input) and the wgrad always int8 (no 4096 window), its operand
``Q(bf16(g))`` at the scale ``absmax(bf16(g))``.

Every int8 contraction is an int8 im2col (pad and strided views on int8
tensors, no float round trip) and one ``torch._int_mm`` (s8 × s8 → s32,
cuBLASLt on the card). Its results are exact integers, so on the same
int8 operands the port equals the JAX package bit for bit. K and N are
zero-padded to multiples of 8 and M kept above 16 (cuBLASLt's limits;
zero padding is exact in int8), and the second operand is passed
column-major, the layout cuBLASLt's int8 GEMM takes.

Delayed scales: a module built with ``delayed=True`` holds a 0-d f32
buffer ``amax_x`` (the JAX ``quant`` collection's leaf). Its scale is
``max(amax_x, 1e-12) / 127``; each forward in training mode stores
``max(amax, 0.95·amax_x)`` in place, with no host read; in eval mode the
scale is read frozen. With an ``epilogue`` the previous conv's raw output
is normalized, activated and quantized by the fused epilogue (#1 + #4,
ops/instance_norm.py) and the conv takes it through :func:`int8_conv_pq`.
:class:`QuantScale` holds that plumbing once for every int8 module
(``QuantConv``, ``QuantKN2RowConv``, the subpixel and transposed forms,
and ``ops/spectral_norm.SpectralConv``).

Tensors are the port's: (N, C, H, W) activations (channels_last in
memory) and (O, I, kh, kw) weights; internally the products run on NHWC
views and HWIO weights, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from p2p_tpu_torch.ops.conv import SubpixelConv, subpixel_interleave

Pair = Tuple[int, int]
Pads = Tuple[Pair, Pair]

# the int8 wgrad's output-size window (ops/int8.py _INT8_WGRAD_SLICE_*):
# Ho·Wo in [MIN, MAX] takes the int8 product, the rest the bf16 wgrad
_INT8_WGRAD_SLICE_MIN = 0
_INT8_WGRAD_SLICE_MAX = 4096
# the delayed-scale update law: max(amax, AMAX_DECAY·stored)
AMAX_DECAY = 0.95


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` by true division: a CUDA tensor divided
    by a Python number is multiplied by its f32 reciprocal instead, one
    bit off the JAX package's quotient, so the divisor is a tensor."""
    return amax.clamp_min(1e-12) / amax.new_full((), 127.0)


def absmax_scale(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Symmetric scale max|x| / 127 in f32 (0-d, or keepdim over ``dim``)."""
    a = x.float().abs()
    return scale_of(a.amax() if dim is None else a.amax(dim=dim,
                                                         keepdim=True))


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def reshard_amax(amax: torch.Tensor, old_width: int, new_width: int
                 ) -> torch.Tensor:
    """The closed-form amax law of a TP-width change under delayed int8
    (``p2p_tpu/ops/int8.py:523``; the elastic ``tp_amax_recalibrate``): a
    per-tensor amax (0-d, or any leaf without a leading ``old_width``
    axis: every ``amax_x`` of the port, a max over the whole tensor on
    every rank) is width invariant; a per-shard amax (leading
    ``[old_width]``) repeats each shard's to its children when the width
    grows and takes the max over the shards a new one absorbs when it
    shrinks (widen-then-narrow round-trips bitwise). Widths that do not
    divide raise, naming both."""
    amax = torch.as_tensor(amax)
    old_width, new_width = int(old_width), int(new_width)
    if old_width == new_width or amax.dim() == 0 \
            or amax.shape[0] != old_width:
        return amax
    if new_width > old_width:
        if new_width % old_width:
            raise ValueError(f"cannot widen amax shards {old_width} -> "
                             f"{new_width}: widths must divide")
        return amax.repeat_interleave(new_width // old_width, dim=0)
    if old_width % new_width:
        raise ValueError(f"cannot narrow amax shards {old_width} -> "
                         f"{new_width}: widths must divide")
    k = old_width // new_width
    return amax.reshape((new_width, k) + tuple(amax.shape[1:])).amax(dim=1)


def amax_update(cur: torch.Tensor, stored: torch.Tensor) -> torch.Tensor:
    """The delayed-scale update: ``max(cur, AMAX_DECAY·stored)``."""
    return torch.maximum(cur, AMAX_DECAY * stored)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 (M, K) and (K, N) as exact int32 (M, N), through
    ``torch._int_mm``: K and N zero-padded to multiples of 8, M to at least
    17, ``b`` column-major."""
    m, k = a.shape
    n = b.shape[1]
    kp, np_, mp = _round_up(k, 8), _round_up(n, 8), max(m, 17)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n]


def as_pads(padding) -> Pads:
    """An int, an (h, w) pair (both sides) or ((lo, hi), (lo, hi))."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple((p, p) if isinstance(p, int) else tuple(p)
                 for p in padding)


def _pad_hw(x: torch.Tensor, pads: Pads) -> torch.Tensor:
    """Zero-pad H and W of an NHWC tensor; a negative pad crops."""
    (lh, hh), (lw, hw) = pads
    if lh == hh == lw == hw == 0:
        return x
    return F.pad(x, (0, 0, lw, hw, lh, hh))


def _zero_insert(x: torch.Tensor, dil: Pair) -> torch.Tensor:
    """An NHWC tensor with ``dil − 1`` zeros between neighbouring pixels
    in H and W (XLA's ``lhs_dilation``); exact in any dtype."""
    if tuple(dil) == (1, 1):
        return x
    n, h, w, c = x.shape
    dh, dw = dil
    out = x.new_zeros((n, (h - 1) * dh + 1, (w - 1) * dw + 1, c))
    out[:, ::dh, ::dw] = x
    return out


def _dilate(shape, dil):
    return tuple(0 if d == 0 else (d - 1) * r + 1 for d, r in zip(shape, dil))


def _vjp_lhs_padding(in_hw, k_hw, strides, out_hw, padding, lhs_dil, rhs_dil):
    """XLA's dgrad padding (jax._src.lax.convolution
    _conv_general_vjp_lhs_padding), as the JAX package inlines it."""
    lhs_d = _dilate(in_hw, lhs_dil)
    rhs_d = _dilate(k_hw, rhs_dil)
    out_d = _dilate(out_hw, strides)
    lo = tuple(r - p[0] - 1 for r, p in zip(rhs_d, padding))
    hi = tuple(l + r - 1 - o - b
               for l, r, o, b in zip(lhs_d, rhs_d, out_d, lo))
    return tuple(zip(lo, hi))


def _vjp_rhs_padding(in_hw, k_hw, strides, out_hw, padding, lhs_dil, rhs_dil):
    """XLA's wgrad padding (_conv_general_vjp_rhs_padding), as inlined."""
    lhs_d = _dilate(in_hw, lhs_dil)
    rhs_d = _dilate(k_hw, rhs_dil)
    out_d = _dilate(out_hw, strides)
    lo = tuple(p[0] for p in padding)
    hi = tuple((o - l) + (r - p - 1)
               for o, l, r, p in zip(out_d, lhs_d, rhs_d, lo))
    return tuple(zip(lo, hi))


def im2col(x8: torch.Tensor, k_hw: Pair, strides: Pair, padding,
           lhs_dilation: Pair = (1, 1)) -> Tuple[torch.Tensor, Pair]:
    """im2col of an NHWC tensor (int8, or float for the kn2row backward):
    ``(N·Ho·Wo, kh·kw·C)`` rows of the zero-inserted (``lhs_dilation``),
    zero-padded input under each output position, and ``(Ho, Wo)``."""
    xp = _pad_hw(_zero_insert(x8, lhs_dilation), as_pads(padding)
                 ).contiguous()
    n, _, _, c = xp.shape
    kh, kw = k_hw
    sh, sw = strides
    ho = (xp.shape[1] - kh) // sh + 1
    wo = (xp.shape[2] - kw) // sw + 1
    s = xp.stride()
    view = xp.as_strided((n, ho, wo, kh, kw, c),
                         (s[0], s[1] * sh, s[2] * sw, s[1], s[2], s[3]))
    return view.reshape(n * ho * wo, kh * kw * c), (ho, wo)


def conv_i32(x8: torch.Tensor, w8: torch.Tensor, strides: Pair,
             padding, lhs_dilation: Pair = (1, 1)) -> torch.Tensor:
    """NHWC int8 ⊛ HWIO int8 → NHWC int32, exact: im2col + ``int_mm``."""
    kh, kw, ci, co = w8.shape
    rows, (ho, wo) = im2col(x8, (kh, kw), strides, padding, lhs_dilation)
    y = int_mm(rows, w8.reshape(kh * kw * ci, co))
    return y.reshape(x8.shape[0], ho, wo, co)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as (N, C, H, W), channels_last in memory."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, carried in f32."""
    return t.to(torch.bfloat16).float()


def _undo_pad(x: torch.Tensor, pads: Pads, lhs_dil: Pair) -> torch.Tensor:
    """The gradient of ``_pad_hw(_zero_insert(·, lhs_dil), pads)``: the
    padding cut off (a crop's zeros put back), every ``lhs_dil``-th
    pixel."""
    x = _pad_hw(x, tuple((-lo, -hi) for lo, hi in pads))
    return x[:, ::lhs_dil[0], ::lhs_dil[1]]


def _group_max(t: torch.Tensor, tp) -> torch.Tensor:
    """``t`` max-reduced over the model group of a sharded conv's ``tp``
    (``parallel.tp.TPConv``; None: a whole conv, ``t`` as it is)."""
    if tp is None:
        return t
    from p2p_tpu_torch.parallel.tp import model_allreduce

    return model_allreduce(t, tp.group, "amax_max")


def _group_sum(t: torch.Tensor, tp) -> torch.Tensor:
    """``t`` summed over the model group of ``tp`` (exact for the int32
    accumulators)."""
    if tp is None:
        return t
    from p2p_tpu_torch.parallel.tp import model_allreduce

    return model_allreduce(t, tp.group, "int32_sum"
                           if t.dtype == torch.int32 else "reduce")


def _int8_bwd_core(strides: Pair, padding: Pads, lhs_dil: Pair, xq, sx,
                   wq, sw, x_dtype, w_dtype, g: torch.Tensor,
                   tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw in w's dtype) of the dequantized surrogate,
    from the saved int8 operands: ``xq`` NHWC, ``wq`` HWIO, ``sw`` (O,),
    and the NHWC cotangent ``g``. ``tp``: the shard of a conv whose C_out
    is sharded (``parallel.tp.TPConv``): the cotangent scales are maxed
    over its model group and the dgrad's partial sums (int32) added over
    it, so dx is the whole conv's on every rank."""
    k_hw = tuple(wq.shape[:2])
    in_hw, out_hw = tuple(xq.shape[1:3]), tuple(g.shape[1:3])
    gf = g.float()

    # ---- dgrad ----
    if strides == (1, 1):
        # the conv of g̃ with the flipped, transposed kernel, window
        # strides = the forward's lhs_dilation
        gt = gf * sw
        sgt = scale_of(_group_max(gt.abs().amax(), tp))
        gtq = quantize_int8(gt, sgt)
        w_t = wq.flip(0, 1).transpose(2, 3).contiguous()   # (kh, kw, O, I)
        pad_lhs = _vjp_lhs_padding(in_hw, k_hw, strides, out_hw, padding,
                                   lhs_dil, (1, 1))
        dx32 = _group_sum(conv_i32(gtq, w_t, lhs_dil, pad_lhs), tp)
        dx = (dx32.float() * sgt).to(x_dtype)
    else:
        # the library's conv input gradient on ŵ, taken w.r.t. the padded,
        # zero-inserted input and cut back
        w_hat = _bf16(wq.float() * sw).permute(3, 2, 0, 1)
        xe = _dilate(in_hw, lhs_dil)
        xe = tuple(d + lo + hi for d, (lo, hi) in zip(xe, padding))
        dxe = torch.nn.grad.conv2d_input(
            (xq.shape[0], xq.shape[3], *xe), w_hat, _nchw(_bf16(gf)),
            strides, 0)
        dx = _group_sum(_undo_pad(_nhwc(dxe), padding, lhs_dil).contiguous(),
                        tp).to(x_dtype)

    # ---- wgrad ----
    ho, wo = out_hw
    if lhs_dil == (1, 1) and \
            _INT8_WGRAD_SLICE_MIN <= ho * wo <= _INT8_WGRAD_SLICE_MAX:
        sg = scale_of(_group_max(gf.abs().amax(), tp))
        gq = quantize_int8(gf, sg)
        rows, _ = im2col(xq, k_hw, strides, padding)
        n_pos = rows.shape[0]
        dwk = int_mm(rows.t(), gq.reshape(n_pos, -1))   # (kh·kw·I, O)
        dw = (dwk.float() * (sx * sg)).reshape(*k_hw, xq.shape[3], -1)
        dw = dw.to(w_dtype)
    else:
        # the library's conv weight gradient on x̂, zero-inserted and
        # padded to exactly the extent the strided windows read
        pad_rhs = _vjp_rhs_padding(in_hw, k_hw, strides, out_hw, padding,
                                   lhs_dil, (1, 1))
        xe = _pad_hw(_zero_insert(_bf16(xq.float() * sx), lhs_dil), pad_rhs)
        dw = torch.nn.grad.conv2d_weight(
            _nchw(xe), (wq.shape[3], wq.shape[2], *k_hw),
            _nchw(_bf16(gf)), strides, 0)
        dw = dw.permute(2, 3, 1, 0).to(w_dtype)
    return dx, dw


def _forward(xq: torch.Tensor, sx: torch.Tensor, w: torch.Tensor,
             strides: Pair, padding: Pads, lhs_dil: Pair, out_dtype):
    """The int8 conv of NHWC ``xq`` with the (O, I, kh, kw) weight ``w``:
    returns (y NCHW in ``out_dtype``, wq HWIO, sw (O,))."""
    sw = absmax_scale(w, dim=(1, 2, 3)).reshape(-1)
    wq = quantize_int8(w.permute(2, 3, 1, 0), sw)
    y32 = conv_i32(xq, wq.contiguous(), strides, padding, lhs_dil)
    y = y32.float() * (sx * sw)
    return _nchw(y.to(out_dtype)), wq, sw


def _quantize_at(x: torch.Tensor, sx: torch.Tensor):
    """(NHWC int8 of x at the stored scale, f32 NHWC x, the clamped sx)."""
    sx = sx.float().clamp_min(1e-12)
    xf = _nhwc(x).float()
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), \
        xf, sx


def _backward(ctx, g):
    xq, sx, wq, sw = ctx.saved_tensors
    dx, dw = _int8_bwd_core(ctx.strides, ctx.padding, ctx.lhs_dil, xq, sx,
                            wq, sw, ctx.x_dtype, ctx.w_dtype, _nhwc(g))
    return _nchw(dx), dw.permute(3, 2, 0, 1)


def _save(ctx, xq, sx, wq, sw, x, w, strides, padding, lhs_dil=(1, 1)):
    ctx.save_for_backward(xq, sx, wq, sw)
    ctx.strides, ctx.padding, ctx.lhs_dil = strides, padding, lhs_dil
    ctx.x_dtype, ctx.w_dtype = x.dtype, w.dtype


class _Int8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, strides, padding, lhs_dil):
        sx = absmax_scale(x)
        xq = quantize_int8(_nhwc(x), sx)
        y, wq, sw = _forward(xq, sx, w, strides, padding, lhs_dil, x.dtype)
        _save(ctx, xq, sx, wq, sw, x, w, strides, padding, lhs_dil)
        return y

    @staticmethod
    def backward(ctx, g):
        return (*_backward(ctx, g), None, None, None)


class _Int8ConvDS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sx, strides, padding, lhs_dil):
        xq, xf, sx = _quantize_at(x, sx)
        amax = xf.abs().amax()
        y, wq, sw = _forward(xq, sx, w, strides, padding, lhs_dil, x.dtype)
        _save(ctx, xq, sx, wq, sw, x, w, strides, padding, lhs_dil)
        ctx.mark_non_differentiable(amax)
        return y, amax

    @staticmethod
    def backward(ctx, g, _g_amax):
        # the amax output feeds a state update, never a loss
        return (*_backward(ctx, g), None, None, None, None)


class _Int8ConvPQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xi, w, sx, strides, padding, lhs_dil):
        sx = sx.float().clamp_min(1e-12)
        xq = _nhwc(xi).to(torch.int8)    # values already on the int8 grid
        y, wq, sw = _forward(xq, sx, w, strides, padding, lhs_dil, xi.dtype)
        _save(ctx, xq, sx, wq, sw, xi, w, strides, padding, lhs_dil)
        return y

    @staticmethod
    def backward(ctx, g):
        return (*_backward(ctx, g), None, None, None, None)


def int8_conv(x: torch.Tensor, w: torch.Tensor, strides: Pair = (1, 1),
              padding=0, lhs_dilation: Pair = (1, 1)) -> torch.Tensor:
    """(N, C, H, W) ⊛ (O, I, kh, kw) on the int8 path with a dynamic
    per-tensor activation scale, zero ``padding`` (:func:`as_pads`) and
    ``lhs_dilation`` (a transposed conv: zeros between input pixels). The
    output has x's dtype."""
    return _Int8Conv.apply(x, w, tuple(strides), as_pads(padding),
                           tuple(lhs_dilation))


def int8_conv_ds(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                 strides: Pair = (1, 1), padding=0,
                 lhs_dilation: Pair = (1, 1)
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_conv` with a stored activation scale ``sx`` (0-d f32);
    returns ``(y, amax)``, amax = max|x| measured in the quantize pass
    (no gradient)."""
    return _Int8ConvDS.apply(x, w, sx, tuple(strides), as_pads(padding),
                             tuple(lhs_dilation))


def int8_conv_pq(xi: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                 strides: Pair = (1, 1), padding=0,
                 lhs_dilation: Pair = (1, 1)) -> torch.Tensor:
    """:func:`int8_conv_ds` whose input is already on the int8 grid
    (integers in [-127, 127] in a float tensor, scale ``sx``). Its input
    cotangent is w.r.t. the dequantized surrogate ``sx·xi``."""
    return _Int8ConvPQ.apply(xi, w, sx, tuple(strides), as_pads(padding),
                             tuple(lhs_dilation))


class _TPInt8Conv(torch.autograd.Function):
    """The Megatron form of an int8 conv whose weight holds a channel
    shard (``tp``, parallel/tp.py): role "out" (C_out sliced: x whole, the
    output this rank's channels) or "in" (C_in sliced: x and the output's
    partial contraction this rank's). The scales are the whole conv's:
    under "in" the input's amax and each output channel's weight amax are
    maxed over the model group and the int32 accumulators are summed over
    it before the dequantize; under "out" the backward's cotangent scales
    are maxed and the dgrad's int32 partial sums added. Every sum is of
    integers, so the forward, the amax and both gradients are the one-rank
    conv's bit for bit. ``mode``: "dynamic" (x's own scale), "stored"
    (``sx`` given, returns the measured amax too) or "prequant" (x on the
    int8 grid at ``sx``)."""

    @staticmethod
    def forward(ctx, x, w, sx, mode, tp, strides, padding, lhs_dil):
        inner = tp if tp.role == "in" else None
        amax = torch.zeros((), device=x.device)
        if mode == "dynamic":
            sx = scale_of(_group_max(x.float().abs().amax(), inner))
            xq = quantize_int8(_nhwc(x), sx)
        elif mode == "stored":
            xq, xf, sx = _quantize_at(x, sx)
            amax = _group_max(xf.abs().amax(), inner)
        else:
            sx = sx.float().clamp_min(1e-12)
            xq = _nhwc(x).to(torch.int8)
        sw = scale_of(_group_max(w.float().abs().amax(
            dim=(1, 2, 3), keepdim=True), inner)).reshape(-1)
        wq = quantize_int8(w.permute(2, 3, 1, 0), sw)
        y32 = _group_sum(conv_i32(xq, wq.contiguous(), strides, padding,
                                  lhs_dil), inner)
        y = _nchw((y32.float() * (sx * sw)).to(x.dtype))
        _save(ctx, xq, sx, wq, sw, x, w, strides, padding, lhs_dil)
        ctx.outer = tp if tp.role == "out" else None
        ctx.mark_non_differentiable(amax)
        return y, amax

    @staticmethod
    def backward(ctx, g, _g_amax):
        xq, sx, wq, sw = ctx.saved_tensors
        dx, dw = _int8_bwd_core(ctx.strides, ctx.padding, ctx.lhs_dil, xq,
                                sx, wq, sw, ctx.x_dtype, ctx.w_dtype,
                                _nhwc(g), ctx.outer)
        return (_nchw(dx), dw.permute(3, 2, 0, 1), None, None, None, None,
                None, None)


def tp_conv_forms(tp):
    """:data:`CONV_FORMS` of a sharded int8 conv (:class:`_TPInt8Conv`;
    ``tp`` its ``parallel.tp.TPConv``)."""

    def call(mode, x, w, sx, strides=(1, 1), padding=0, lhs=(1, 1)):
        return _TPInt8Conv.apply(x, w, sx, mode, tp, tuple(strides),
                                 as_pads(padding), tuple(lhs))

    return (lambda x, w, *a: call("dynamic", x, w, None, *a)[0],
            lambda x, w, sx, *a: call("stored", x, w, sx, *a),
            lambda x, w, sx, *a: call("prequant", x, w, sx, *a)[0])


# ------------------------------------------------------------- kn2row

def _kn2row_bwd(ctx, g):
    """The patches-of-dz backward (``p2p_tpu/ops/int8.py:391``): ``pz``,
    the im2col of ``bf16(g)`` padded k − 1, spans the padded input; the
    dgrad is ``pz @ ŵ`` in bf16 values with f32 sums, cropped to the
    input; the wgrad is the int8 product ``pad(Q(x))ᵀ · Q(pz)``."""
    xq, sx, wq, sw = ctx.saved_tensors
    pad = ctx.pad
    k, _, cin, o = wq.shape
    n, h, w, _ = xq.shape
    dzp = _pad_hw(_bf16(_nhwc(g).float()), as_pads(k - 1))
    pz, (hp, wp) = im2col(dzp, (k, k), (1, 1), 0)      # (N·Hp·Wp, k²·O)
    # ---- dgrad (bf16: the k²·O contraction is tiny) ----
    w_hat = _bf16(wq.float() * sw)
    wd = w_hat.flip(0, 1).permute(0, 1, 3, 2).reshape(k * k * o, cin)
    dxp = (pz @ wd).reshape(n, hp, wp, cin)
    dx = dxp[:, pad:pad + h, pad:pad + w].to(ctx.x_dtype)
    # ---- wgrad (int8 over N·Hp·Wp) ----
    xpq = _pad_hw(xq, as_pads(pad)).reshape(-1, cin)
    spz = absmax_scale(pz)
    dwm = int_mm(xpq.t(), quantize_int8(pz, spz)).float() * (sx * spz)
    dw = dwm.reshape(cin, k, k, o).flip(1, 2).permute(3, 0, 1, 2)
    return _nchw(dx), dw.to(ctx.w_dtype)


class _Int8KN2Row(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, pad):
        sx = absmax_scale(x)
        xq = quantize_int8(_nhwc(x), sx)
        y, wq, sw = _forward(xq, sx, w, (1, 1), as_pads(pad), (1, 1),
                             x.dtype)
        _save(ctx, xq, sx, wq, sw, x, w, (1, 1), as_pads(pad))
        ctx.pad = pad
        return y

    @staticmethod
    def backward(ctx, g):
        return (*_kn2row_bwd(ctx, g), None)


class _Int8KN2RowDS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sx, pad):
        xq, xf, sx = _quantize_at(x, sx)
        amax = xf.abs().amax()
        y, wq, sw = _forward(xq, sx, w, (1, 1), as_pads(pad), (1, 1),
                             x.dtype)
        _save(ctx, xq, sx, wq, sw, x, w, (1, 1), as_pads(pad))
        ctx.pad = pad
        ctx.mark_non_differentiable(amax)
        return y, amax

    @staticmethod
    def backward(ctx, g, _g_amax):
        return (*_kn2row_bwd(ctx, g), None, None)


def int8_kn2row_conv(x: torch.Tensor, w: torch.Tensor, pad: int
                     ) -> torch.Tensor:
    """Stride-1 thin-output conv on the int8 kn2row path (dynamic
    per-tensor activation scale), zero padding ``pad`` on both sides."""
    return _Int8KN2Row.apply(x, w, int(pad))


def int8_kn2row_conv_ds(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                        pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_kn2row_conv` with a stored activation scale: returns
    ``(y, amax)`` like :func:`int8_conv_ds`."""
    return _Int8KN2RowDS.apply(x, w, sx, int(pad))


def surrogate_tap(q: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """The feature tap of a fused epilogue in f32: value ``q + (q·sx −
    q)`` (the JAX expression), cotangent passed to ``q`` unscaled (the
    epilogue's backward reads it in the surrogate frame)."""
    q32 = q.float()
    return q32 + (q32 * sx - q32).detach()


# (dynamic, stored-scale, prequantized) forms of a conv family
CONV_FORMS = (int8_conv, int8_conv_ds, int8_conv_pq)
KN2ROW_FORMS = (int8_kn2row_conv, int8_kn2row_conv_ds, None)


class QuantScale:
    """The activation-scale plumbing of an int8 module (the JAX
    ``_delayed_scale`` and ``_fused_epilogue_scale``), mixed into an
    ``nn.Module``: with ``delayed`` the 0-d f32 buffer ``amax_x``, read as
    this forward's scale and updated in training mode; ``epilogue``
    (needs ``delayed``) a callable ``(y_raw, sx) -> (q, amax)`` applied to
    the previous conv's raw output, whose ``q`` the conv then takes
    through the prequantized form; with ``epilogue_tap`` the forward also
    returns the dequantized surrogate.

    ``init_amax`` (set by ``train.state.init_amax``) makes the next
    forward set ``amax_x`` from its own input first, as flax init does:
    max|x|, or under an epilogue its amax at sx = 1. ``pp_proposal``, set
    by a pipelined stage, collects ``max(amax_update(amax, amax_x))`` over
    the stage's microbatches in place of the store (the JAX stacked
    ``quant`` proposal)."""

    def _init_scale(self, delayed: bool, epilogue: Optional[Callable] = None,
                    epilogue_tap: bool = False) -> None:
        if epilogue is not None and not delayed:
            raise ValueError(f"{type(self).__name__}(epilogue=...) needs "
                             "delayed=True: the fused quantize reads this "
                             "module's stored amax")
        self.delayed = delayed
        self.epilogue = epilogue
        self.epilogue_tap = epilogue_tap
        self.init_amax = False
        # a pipelined stage's running max of this module's update
        # proposals (parallel/pp.py start_proposals / take_proposals):
        # while set, the scale stays frozen and nothing is stored
        self.pp_proposal: Optional[torch.Tensor] = None
        if delayed:
            self.register_buffer("amax_x", torch.zeros(()))

    @torch.no_grad()
    def _store(self, amax: torch.Tensor) -> None:
        if self.pp_proposal is not None:
            self.pp_proposal = torch.maximum(
                self.pp_proposal, amax_update(amax, self.amax_x))
        elif self.training:
            self.amax_x.copy_(amax_update(amax, self.amax_x))

    def quant_conv(self, x: torch.Tensor, w: torch.Tensor, forms, *args
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(y, tap)`` of the int8 conv of ``x`` with ``w`` (already in
        the compute dtype) by ``forms`` (:data:`CONV_FORMS` or
        :data:`KN2ROW_FORMS`, each called with ``*args`` after its
        operands); ``tap`` is None without ``epilogue_tap``."""
        tp = getattr(self, "p2p_tp", None)
        if tp is not None:
            from p2p_tpu_torch.parallel.tp import tp_int8_input

            if forms is not CONV_FORMS:
                raise NotImplementedError(
                    f"a sharded {type(self).__name__} has no tensor-parallel "
                    "form (model > 1)")
            forms = tp_conv_forms(tp)
        dynamic, stored, prequant = forms
        dt = w.dtype
        tap = None
        if self.epilogue is not None:
            if self.init_amax:
                with torch.no_grad():
                    self.amax_x.copy_(self.epilogue(
                        x, torch.ones((), device=x.device))[1])
            sx = scale_of(self.amax_x)
            q, amax = self.epilogue(x, sx)
            if tp is not None and tp.role == "in" \
                    and x.shape[1] < self.p2p_tp_io[0]:
                # the epilogue saw this rank's channels only
                amax = _group_max(amax, tp)
            self._store(amax)
            if tp is not None:
                q = tp_int8_input(q, self)
            y = prequant(q.to(dt), w, sx, *args)
            if self.epilogue_tap:
                tap = surrogate_tap(q.to(dt), sx).to(dt)
        else:
            if tp is not None:
                x = tp_int8_input(x, self)
            if self.delayed:
                if self.init_amax:
                    with torch.no_grad():
                        self.amax_x.copy_(x.detach().float().abs().amax())
                y, amax = stored(x.to(dt), w, scale_of(self.amax_x), *args)
                self._store(amax)
            else:
                y = dynamic(x.to(dt), w, *args)
        if tp is not None:
            from p2p_tpu_torch.parallel.tp import tp_int8_output

            y = tp_int8_output(y, self)
        return y, tap


def quant_modules(net: nn.Module) -> List[QuantScale]:
    """The int8 modules of ``net`` that hold a stored scale."""
    return [m for m in net.modules()
            if isinstance(m, QuantScale) and m.delayed]


def stored_scales(net: Optional[nn.Module]) -> List[torch.Tensor]:
    """Every ``amax_x`` buffer of ``net`` (none for None)."""
    return [] if net is None else [m.amax_x for m in quant_modules(net)]


def _compute_dtype(mod, x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    """flax's ``dtype=``, or the promoted type of input and weight (a
    module served as a copy cast to the serving dtype takes none)."""
    return mod.compute_dtype or torch.promote_types(x.dtype, w.dtype)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    if bias is None:
        return y
    return y + bias.to(y.dtype).view(1, -1, 1, 1)


class QuantConv(QuantScale, nn.Conv2d):
    """``nn.Conv2d`` (zero padding, bias) on the int8 path, the flax
    ``QuantConv``: its ``weight``/``bias`` are the conv's, so the state
    dict matches a plain conv's plus, with ``delayed``, the 0-d f32 buffer
    ``amax_x``. ``dtype`` is the compute dtype (None: the promoted type of
    input and weight). ``padding`` is an int or per-side pairs
    (:func:`as_pads`). With ``epilogue_tap`` the forward returns ``(y,
    tap)`` (:class:`QuantScale`)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int = 4, stride: int = 1, padding=1,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 delayed: bool = False, epilogue: Optional[Callable] = None,
                 epilogue_tap: bool = False):
        super().__init__(in_channels, features, kernel_size, stride=stride,
                         padding=padding if isinstance(padding, int) else 0,
                         bias=bias)
        self.pads = as_pads(padding)
        self.compute_dtype = dtype
        self._init_scale(delayed, epilogue, epilogue_tap)

    def forward(self, x: torch.Tensor):
        w = self.weight.to(_compute_dtype(self, x, self.weight))
        y, tap = self.quant_conv(x, w, CONV_FORMS, tuple(self.stride),
                                 self.pads)
        if getattr(self, "p2p_tp", None) is None:   # else added by the TP form
            y = _add_bias(y, self.bias)
        return (y, tap) if self.epilogue_tap else y


class QuantKN2RowConv(QuantScale, nn.Conv2d):
    """The JAX ``KN2RowConv(int8=True)`` (``p2p_tpu/ops/conv.py:399``):
    a stride-1 thin-output conv (D's logits head) on the int8 kn2row path,
    with a plain conv's parameters (plus ``amax_x`` with ``delayed``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 padding: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, delayed: bool = False):
        super().__init__(in_channels, features, kernel_size, bias=bias)
        self.pad = padding
        self.compute_dtype = dtype
        self._init_scale(delayed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(_compute_dtype(self, x, self.weight))
        y, _ = self.quant_conv(x, w, KN2ROW_FORMS, self.pad)
        return _add_bias(y, self.bias)


class QuantSubpixelConv(QuantScale, SubpixelConv):
    """The k2-s1 pad-1 conv of :class:`QuantSubpixelDeconv` (the flax
    ``Conv_0`` QuantConv): ``SubpixelConv``'s HWIO ``kernel`` and ``bias``,
    plus ``amax_x`` with ``delayed``."""

    def __init__(self, in_channels: int, features: int,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 delayed: bool = False):
        super().__init__(in_channels, features, use_bias)
        self.compute_dtype = dtype
        self._init_scale(delayed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(_compute_dtype(self, x, self.kernel))
        y, _ = self.quant_conv(x, w.permute(3, 2, 0, 1), CONV_FORMS, (1, 1),
                               1)
        return _add_bias(y, self.bias)


class QuantSubpixelDeconv(nn.Module):
    """``SubpixelDeconv`` (ops/conv.py: ConvTranspose k4 s2 as a k2-s1
    pad-1 conv to 4·F channels + the shifted interleave) with its conv on
    the int8 path: the U-Net's int8 decoder (``int8_decoder``). Its state
    dict is ``SubpixelDeconv``'s plus ``conv.amax_x``."""

    def __init__(self, in_channels: int, features: int,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 delayed: bool = False):
        super().__init__()
        self.features = features
        self.conv = QuantSubpixelConv(in_channels, 4 * features, use_bias,
                                      dtype, delayed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return subpixel_interleave(self.conv(x), self.features)


def conv_transpose_pads(k: int, s: int) -> Pair:
    """``lax._conv_transpose_padding`` for 'SAME': total k + s − 2, lo =
    k − 1 when s > k − 1, else ⌈total / 2⌉."""
    total = k + s - 2
    lo = k - 1 if s > k - 1 else -(-total // 2)
    return lo, total - lo


class QuantConvTranspose(QuantScale, nn.ConvTranspose2d):
    """flax ``ConvTranspose(k, s, 'SAME')`` on the int8 path: the
    lhs-dilated int8 conv (``lhs_dilation = s``, window stride 1) of the
    un-flipped flax kernel, padded as 'SAME' pads it. Its parameters are
    ``nn.ConvTranspose2d``'s, the flax kernel flipped in both spatial axes
    (``weight[i, o, a, b] = kernel[k−1−a, k−1−b, i, o]``, as convert.py
    maps it), plus ``amax_x`` with ``delayed``. No model of the JAX
    package builds it."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int = 4, stride: int = 2, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, delayed: bool = False):
        pads = conv_transpose_pads(kernel_size, stride)
        super().__init__(in_channels, features, kernel_size, stride=stride,
                         padding=kernel_size - 1 - pads[0], bias=bias)
        self.pads = (pads, pads)
        self.compute_dtype = dtype
        self._init_scale(delayed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(_compute_dtype(self, x, self.weight))
        # (I, O, kh, kw) flipped → (O, I, kh, kw) of the lhs-dilated conv
        w = w.flip(2, 3).permute(1, 0, 2, 3)
        y, _ = self.quant_conv(x, w, CONV_FORMS, (1, 1), self.pads,
                               tuple(self.stride))
        return _add_bias(y, self.bias)
