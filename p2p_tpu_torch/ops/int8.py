"""int8 quantization-aware convolutions (counterpart of ``p2p_tpu/ops/
int8.py``: ``absmax_scale`` :76, ``quantize_int8`` :83, the int32 conv
:89, the stride-1 dgrad's padding :102, the backward core :150,
``int8_conv`` :126, ``int8_conv_ds`` :280, ``int8_conv_pq`` :488,
``amax_update`` :568, ``surrogate_tap`` :606 and ``QuantConv`` :634).

Scheme (per conv): a per-tensor activation scale ``sx`` and a per-output-
channel weight scale ``sw = max|w[o]| / 127`` taken on the weight cast to
the compute dtype; ``y = (Q(x) ⊛ Q(w))_int32 · (sx·sw)``. The backward is
the exact gradient of the dequantized surrogate (straight through both
quantizers), in the JAX package's per-form dispatch:

- dgrad of a stride-1 conv: ``s_w`` folded into the cotangent, ``g̃ =
  g·s_w``, quantized with its own dynamic scale, and an int8 conv of
  ``Q(g̃)`` with the flipped, transposed ``Q(w)``; stride 2: a bf16
  dgrad on the dequantized weight ``ŵ``;
- wgrad: ``dw = sx·sg·(Q(x) ⊛ Q(g))`` as one int8 product over
  ``N·Ho·Wo`` when ``Ho·Wo ≤ 4096``; above it, a bf16 wgrad on the
  dequantized ``x̂``.

The bf16 forms round their operands to bf16 and run the library's f32
conv gradients (f32 accumulation, as ``preferred_element_type=f32``; on
the card TF32 holds bf16 values exactly). Padding is symmetric, as in
every conv of the discriminator; the transposed (lhs-dilated) form of the
int8 decoder is not ported.

Every int8 contraction is an int8 im2col (pad and strided views on int8
tensors, no float round trip) and one ``torch._int_mm`` (s8 × s8 → s32,
cuBLASLt on the card). Its results are exact integers, so on the same
int8 operands the port equals the JAX package bit for bit. K and N are
zero-padded to multiples of 8 and M kept above 16 (cuBLASLt's limits;
zero padding is exact in int8), and the second operand is passed
column-major, the layout cuBLASLt's int8 GEMM takes.

Delayed scales: ``QuantConv(delayed=True)`` holds a 0-d f32 buffer
``amax_x`` (the JAX ``quant`` collection's leaf). Its scale is
``max(amax_x, 1e-12) / 127``; each forward in training mode stores
``max(amax, 0.95·amax_x)`` in place, with no host read. With an
``epilogue`` the previous conv's raw output is normalized, activated and
quantized by the fused epilogue (#1 + #4, ops/instance_norm.py) and the
conv takes it through :func:`int8_conv_pq`.

Tensors are the port's: (N, C, H, W) activations (channels_last in
memory) and (O, I, kh, kw) weights; internally the products run on NHWC
views and HWIO weights, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Pair = Tuple[int, int]

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


def im2col(x8: torch.Tensor, k_hw: Pair, strides: Pair, padding: Pair
           ) -> Tuple[torch.Tensor, Pair]:
    """im2col of an int8 NHWC tensor: ``(N·Ho·Wo, kh·kw·C)`` rows of the
    zero-padded input under each output position, and ``(Ho, Wo)``.
    ``padding`` is (ph, pw) on both sides; negative padding crops."""
    n, h, w, c = x8.shape
    ph, pw = padding
    xp = F.pad(x8, (0, 0, pw, pw, ph, ph)).contiguous()
    kh, kw = k_hw
    sh, sw = strides
    ho = (xp.shape[1] - kh) // sh + 1
    wo = (xp.shape[2] - kw) // sw + 1
    s = xp.stride()
    view = xp.as_strided((n, ho, wo, kh, kw, c),
                         (s[0], s[1] * sh, s[2] * sw, s[1], s[2], s[3]))
    return view.reshape(n * ho * wo, kh * kw * c), (ho, wo)


def conv_i32(x8: torch.Tensor, w8: torch.Tensor, strides: Pair,
             padding: Pair) -> torch.Tensor:
    """NHWC int8 ⊛ HWIO int8 → NHWC int32, exact: im2col + ``int_mm``."""
    kh, kw, ci, co = w8.shape
    rows, (ho, wo) = im2col(x8, (kh, kw), strides, padding)
    y = int_mm(rows, w8.reshape(kh * kw * ci, co))
    return y.reshape(x8.shape[0], ho, wo, co)


def _pair(padding) -> Pair:
    """An int or an (h, w) pair of ints: the padding on both sides."""
    if isinstance(padding, int):
        return (padding, padding)
    return tuple(padding)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as (N, C, H, W), channels_last in memory."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, carried in f32."""
    return t.to(torch.bfloat16).float()


def _int8_bwd_core(strides: Pair, padding: Pair, xq, sx, wq, sw, x_dtype,
                   w_dtype, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw in w's dtype) of the dequantized surrogate,
    from the saved int8 operands: ``xq`` NHWC, ``wq`` HWIO, ``sw`` (O,),
    and the NHWC cotangent ``g``."""
    k_hw = wq.shape[:2]
    gf = g.float()

    # ---- dgrad ----
    if strides == (1, 1):
        # stride 1: the input gradient is the conv of g̃ with the flipped,
        # transposed kernel, padded k − 1 − p on both sides
        gt = gf * sw
        sgt = absmax_scale(gt)
        gtq = quantize_int8(gt, sgt)
        w_t = wq.flip(0, 1).transpose(2, 3).contiguous()   # (kh, kw, O, I)
        pad_t = tuple(k - 1 - p for k, p in zip(k_hw, padding))
        dx32 = conv_i32(gtq, w_t, (1, 1), pad_t)
        dx = (dx32.float() * sgt).to(x_dtype)
    else:
        # the library's conv input gradient on ŵ, the same function
        w_hat = _bf16(wq.float() * sw).permute(3, 2, 0, 1)
        dx = _nhwc(torch.nn.grad.conv2d_input(
            (xq.shape[0], xq.shape[3], *xq.shape[1:3]), w_hat,
            _nchw(_bf16(gf)), strides, padding)).to(x_dtype)

    # ---- wgrad ----
    ho, wo = g.shape[1:3]
    if _INT8_WGRAD_SLICE_MIN <= ho * wo <= _INT8_WGRAD_SLICE_MAX:
        sg = absmax_scale(gf)
        gq = quantize_int8(gf, sg)
        rows, _ = im2col(xq, k_hw, strides, padding)
        n_pos = rows.shape[0]
        dwk = int_mm(rows.t(), gq.reshape(n_pos, -1))   # (kh·kw·I, O)
        dw = (dwk.float() * (sx * sg)).reshape(*k_hw, xq.shape[3], -1)
        dw = dw.to(w_dtype)
    else:
        # the library's conv weight gradient on x̂, the same function
        x_hat = _bf16(xq.float() * sx)
        dw = torch.nn.grad.conv2d_weight(
            _nchw(x_hat), (wq.shape[3], wq.shape[2], *k_hw),
            _nchw(_bf16(gf)), strides, padding)
        dw = dw.permute(2, 3, 1, 0).to(w_dtype)
    return dx, dw


def _forward(xq: torch.Tensor, sx: torch.Tensor, w: torch.Tensor,
             strides: Pair, padding: Pair, out_dtype):
    """The int8 conv of NHWC ``xq`` with the (O, I, kh, kw) weight ``w``:
    returns (y NCHW in ``out_dtype``, wq HWIO, sw (O,))."""
    sw = absmax_scale(w, dim=(1, 2, 3)).reshape(-1)
    wq = quantize_int8(w.permute(2, 3, 1, 0), sw)
    y32 = conv_i32(xq, wq.contiguous(), strides, padding)
    y = y32.float() * (sx * sw)
    return _nchw(y.to(out_dtype)), wq, sw


def _backward(ctx, g):
    xq, sx, wq, sw = ctx.saved_tensors
    dx, dw = _int8_bwd_core(ctx.strides, ctx.padding, xq, sx, wq, sw,
                            ctx.x_dtype, ctx.w_dtype, _nhwc(g))
    return _nchw(dx), dw.permute(3, 2, 0, 1)


def _save(ctx, xq, sx, wq, sw, x, w, strides, padding):
    ctx.save_for_backward(xq, sx, wq, sw)
    ctx.strides, ctx.padding = strides, padding
    ctx.x_dtype, ctx.w_dtype = x.dtype, w.dtype


class _Int8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, strides, padding):
        sx = absmax_scale(x)
        xq = quantize_int8(_nhwc(x), sx)
        y, wq, sw = _forward(xq, sx, w, strides, padding, x.dtype)
        _save(ctx, xq, sx, wq, sw, x, w, strides, padding)
        return y

    @staticmethod
    def backward(ctx, g):
        return (*_backward(ctx, g), None, None)


class _Int8ConvDS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sx, strides, padding):
        sx = sx.float().clamp_min(1e-12)
        xf = _nhwc(x).float()
        xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
        amax = xf.abs().amax()
        y, wq, sw = _forward(xq, sx, w, strides, padding, x.dtype)
        _save(ctx, xq, sx, wq, sw, x, w, strides, padding)
        ctx.mark_non_differentiable(amax)
        return y, amax

    @staticmethod
    def backward(ctx, g, _g_amax):
        # the amax output feeds a state update, never a loss
        return (*_backward(ctx, g), None, None, None)


class _Int8ConvPQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xi, w, sx, strides, padding):
        sx = sx.float().clamp_min(1e-12)
        xq = _nhwc(xi).to(torch.int8)    # values already on the int8 grid
        y, wq, sw = _forward(xq, sx, w, strides, padding, xi.dtype)
        _save(ctx, xq, sx, wq, sw, xi, w, strides, padding)
        return y

    @staticmethod
    def backward(ctx, g):
        return (*_backward(ctx, g), None, None, None)


def int8_conv(x: torch.Tensor, w: torch.Tensor, strides: Pair = (1, 1),
              padding=0) -> torch.Tensor:
    """(N, C, H, W) ⊛ (O, I, kh, kw) on the int8 path with a dynamic
    per-tensor activation scale, zero ``padding`` (an int or an (h, w)
    pair) on both sides. The output has x's dtype."""
    return _Int8Conv.apply(x, w, tuple(strides), _pair(padding))


def int8_conv_ds(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                 strides: Pair = (1, 1), padding=0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_conv` with a stored activation scale ``sx`` (0-d f32);
    returns ``(y, amax)``, amax = max|x| measured in the quantize pass
    (no gradient)."""
    return _Int8ConvDS.apply(x, w, sx, tuple(strides), _pair(padding))


def int8_conv_pq(xi: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                 strides: Pair = (1, 1), padding=0) -> torch.Tensor:
    """:func:`int8_conv_ds` whose input is already on the int8 grid
    (integers in [-127, 127] in a float tensor, scale ``sx``). Its input
    cotangent is w.r.t. the dequantized surrogate ``sx·xi``."""
    return _Int8ConvPQ.apply(xi, w, sx, tuple(strides), _pair(padding))


def surrogate_tap(q: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """The feature tap of a fused epilogue in f32: value ``q + (q·sx −
    q)`` (the JAX expression), cotangent passed to ``q`` unscaled (the
    epilogue's backward reads it in the surrogate frame)."""
    q32 = q.float()
    return q32 + (q32 * sx - q32).detach()


class QuantConv(nn.Conv2d):
    """``nn.Conv2d`` (zero padding, bias) on the int8 path, the flax
    ``QuantConv``: its ``weight``/``bias`` are the conv's, so the state
    dict matches a plain conv's plus, with ``delayed``, the 0-d f32 buffer
    ``amax_x``. ``dtype`` is the compute dtype (f32 when None).

    ``epilogue`` (needs ``delayed``) is a callable ``(y_raw, sx) -> (q,
    amax)`` applied to the previous conv's raw output; the conv then takes
    ``q`` through :func:`int8_conv_pq`. With ``epilogue_tap`` the forward
    returns ``(y, tap)``, the tap being the dequantized surrogate.

    ``init_amax`` (set by ``train.state.init_amax``) makes the next
    forward set ``amax_x`` from its own input first, as flax init does:
    max|x|, or under an epilogue its amax at sx = 1.
    """

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int = 4, stride: int = 1, padding: int = 1,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 delayed: bool = False, epilogue: Optional[Callable] = None,
                 epilogue_tap: bool = False):
        super().__init__(in_channels, features, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        if epilogue is not None and not delayed:
            raise ValueError("QuantConv(epilogue=...) needs delayed=True: "
                             "the fused quantize reads this module's stored "
                             "amax")
        self.compute_dtype = dtype
        self.delayed = delayed
        self.epilogue = epilogue
        self.epilogue_tap = epilogue_tap
        self.init_amax = False
        if delayed:
            self.register_buffer("amax_x", torch.zeros(()))

    def _scale(self) -> torch.Tensor:
        return scale_of(self.amax_x)

    @torch.no_grad()
    def _store(self, amax: torch.Tensor) -> None:
        if self.training:
            self.amax_x.copy_(amax_update(amax, self.amax_x))

    def forward(self, x: torch.Tensor):
        dt = self.compute_dtype or torch.float32
        w = self.weight.to(dt)
        strides, pads = tuple(self.stride), _pair(self.padding)
        tap = None
        if self.epilogue is not None:
            if self.init_amax:
                with torch.no_grad():
                    self.amax_x.copy_(self.epilogue(
                        x, torch.ones((), device=x.device))[1])
            sx = self._scale()
            q, amax = self.epilogue(x, sx)
            self._store(amax)
            y = int8_conv_pq(q.to(dt), w, sx, strides, pads)
            if self.epilogue_tap:
                tap = surrogate_tap(q.to(dt), sx).to(dt)
        elif self.delayed:
            if self.init_amax:
                with torch.no_grad():
                    self.amax_x.copy_(x.detach().float().abs().amax())
            sx = self._scale()
            y, amax = int8_conv_ds(x.to(dt), w, sx, strides, pads)
            self._store(amax)
        else:
            y = int8_conv(x.to(dt), w, strides, pads)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(1, -1, 1, 1)
        if self.epilogue_tap:
            return y, tap
        return y
