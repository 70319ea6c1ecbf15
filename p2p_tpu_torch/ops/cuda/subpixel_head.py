"""The subpixel image head's k2-s1 pad-1 conv: the Hopper kernels #6
(forward) and #7 (input gradient), their plain versions, and the autograd
function that joins them.

``subpixel_head_conv(x, w)`` takes a channels_last (N, C, H, W) x and an
HWIO (2, 2, C, F4) weight in the same compute dtype and returns the conv
with one zero ring of padding as an f32 channels_last (N, F4, H+1, W+1)
tensor, ``z[h, w, f] = Σ_{dh,dw,c} xpad[h+dh, w+dw, c]·w[dh, dw, c, f]``,
which ``ops/conv.subpixel_interleave`` turns into the ×2 upsample. Its
backward is #7 for dx (dz in f32, the weight upcast to f32, dx in x's
dtype) and, for dW, the library's conv weight gradient of the same conv on
``dz`` cast to x's dtype, as the JAX ``_bwd`` takes XLA's.

Replaces ``p2p_tpu/ops/pallas/subpixel_head.py:165 _fwd`` and ``:200
_bwd`` (the dx ``pallas_call``). The kernels are
``csrc/subpixel_head.cu``. Both are bound by bytes: about 5.0 MB per call
at the facades head (x or dx 128×128×128 bf16, F4 = 12, N = 1), 1.49 µs
at 3.35 TB/s, against 0.2 GFLOP, 0.2 µs on the bf16 tensor cores (#7 in
bf16 does three times that, 0.6 µs: still under the bytes bound). #6 in
bf16 is an implicit GEMM on the tensor cores (``mma.sync`` m16n8k16, bf16
× bf16 → f32): a grid of one wave, each block with the zero-padded weight
resident in shared memory as the B operand and a ring of three input-row
slots over a band of output rows, the next row's ``cp.async`` load
(zero-filled for the pad ring) in flight while the current one computes,
and the f32 tile stored as one contiguous run of z. The launch plan and
its shared memory are the CUDA source's (``p2p_subpixel_head_fwd_smem``
reports the bytes). #6 in f32 keeps full f32 products on the CUDA cores
(two input rows and the weight staged in shared memory, the channel sum
split over eight warps): TF32 would keep about three decimal digits.

#7 in bf16 is the same kind of implicit GEMM: M = dx positions, N = C,
K = the four taps × F4 (``k = tap·F4 + f``, 16 to 64, never padded). A
block takes a band of dx rows of one sample over a tile of positions and
all C channels, in a grid of one wave: the bf16 weight resident in shared
memory as B, the two f32 dz rows a dx row reads in a ring of three
``cp.async`` row slots (the next one loading while the current row
computes), tiles of at most 64 positions, one warp per m16 tile of
positions over 64 channels, and the tile rounded once to bf16 and stored
as one contiguous run of the dx row in 16-byte stores. dz is f32, so each
value is cut into three bf16 pieces as the A fragments are built, ``v = hi + mid + lo`` exactly (hi and mid cut
toward zero from v and from the remainder, lo what is left, at most 8
significant bits). Each piece times a bf16 weight is exact in f32, so the
kernel forms the plain version's products; per k16 step the lo, mid and hi
products go into the same f32 accumulators in that order, the steps in
order of k. Only the order of the f32 sums differs from the plain version.
A dz of ±inf or NaN makes dx NaN where the plain version gives ±inf or
NaN. ``p2p_subpixel_head_dx_smem`` reports its shared memory. #7 in f32
keeps each channel's weights in registers and reads the two dz rows it
needs from shared memory on the CUDA cores. No atomics, and a fixed order
of sums: two runs give the same bits.

On CPU tensors the wrappers compute the plain versions; on CUDA tensors
they launch the kernels or raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from p2p_tpu_torch.ops.cuda import build

REPLACES_FWD = "p2p_tpu/ops/pallas/subpixel_head.py:165 (_fwd)"
REPLACES_DX = "p2p_tpu/ops/pallas/subpixel_head.py:200 (_bwd)"
SOURCE = "p2p_tpu_torch/ops/cuda/csrc/subpixel_head.cu"
# 4·F for 1-4 output channels (the kernels' template instances)
F4_SUPPORTED = (4, 8, 12, 16)
# an H100's shared memory per block (the opt-in maximum)
_MAX_SMEM = 232448


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def subpixel_head_fwd_plain(x: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version of #6: an f32 conv of the upcast operands."""
    return F.conv2d(x.float(), _oihw(w).float(), padding=1)


def subpixel_head_dx_plain(dz: torch.Tensor, w: torch.Tensor
                           ) -> torch.Tensor:
    """The plain version of #7: the f32 transposed conv of dz with the
    upcast weight, cast to the weight's (= x's) dtype."""
    return F.conv_transpose2d(dz.float(), _oihw(w).float(),
                              padding=1).to(w.dtype)


def subpixel_head_dw(x: torch.Tensor, dz: torch.Tensor, w: torch.Tensor
                     ) -> torch.Tensor:
    """dW of the conv (HWIO, w's dtype): the library's weight gradient on
    dz cast to x's dtype. Not a port of a kernel: the JAX ``_bwd`` leaves
    this contraction to XLA's conv weight gradient too."""
    dw = torch.ops.aten.convolution_backward(
        dz.to(x.dtype), x, _oihw(w), None, [1, 1], [1, 1], [1, 1], False,
        [0, 0], 1, [False, True, False])[1]
    return dw.permute(2, 3, 1, 0).to(w.dtype)


def _check_weight(w: torch.Tensor, c: int, x: torch.Tensor,
                  what: str) -> int:
    if (w.dim() != 4 or tuple(w.shape[:3]) != (2, 2, c)
            or w.shape[3] not in F4_SUPPORTED):
        raise ValueError(f"{what}: weight must be (2, 2, {c}, F4) with F4 "
                         f"in {F4_SUPPORTED}, got {tuple(w.shape)}")
    if w.device != x.device or w.dtype != x.dtype or not w.is_contiguous():
        raise ValueError(f"{what}: weight must be contiguous, on {x.device} "
                         f"in {x.dtype}; got {w.dtype} on {w.device}")
    return w.shape[3]


def subpixel_head_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """#6: z = conv(x, w, pad 1) in f32, channels_last (N, F4, H+1, W+1):
    on the tensor cores for bf16 operands, on the CUDA cores for f32."""
    if x.device.type == "cpu":
        return subpixel_head_fwd_plain(x, w)
    build.check_activation(x, "subpixel_head_fwd")
    n, c, h, wd = x.shape
    f4 = _check_weight(w, c, x, "subpixel_head_fwd")
    code = build.DTYPE_CODES[x.dtype]
    lib, fn = build.load("subpixel_head", "p2p_subpixel_head_fwd")
    smem = lib.p2p_subpixel_head_fwd_smem(code, wd, c, f4)
    if smem > _MAX_SMEM:
        raise ValueError(f"subpixel_head_fwd: C = {c} needs {smem} bytes of "
                         f"shared memory per block (at most {_MAX_SMEM})")
    z = torch.empty((n, f4, h + 1, wd + 1), device=x.device,
                    dtype=torch.float32, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), z.data_ptr(), code, n, h, wd, c,
                 f4, build.stream_handle(x.device))
    build.check(lib, err, "subpixel_head_fwd")
    build.count_launch(subpixel_head_fwd)
    return z


def subpixel_head_dx(dz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """#7: dx of the conv from an f32 channels_last dz (N, F4, H+1, W+1),
    channels_last (N, C, H, W) in w's dtype (the forward's x dtype): on
    the tensor cores for a bf16 weight, on the CUDA cores for f32."""
    if dz.device.type == "cpu":
        return subpixel_head_dx_plain(dz, w)
    build.check_activation(dz, "subpixel_head_dx")
    if dz.dtype != torch.float32:
        raise TypeError(f"subpixel_head_dx: dz must be f32, got {dz.dtype}")
    n, f4, ho, wo = dz.shape
    if w.dim() != 4 or w.shape[:2] != (2, 2) or w.shape[3] != f4 \
            or w.dtype not in build.DTYPE_CODES or w.device != dz.device \
            or not w.is_contiguous() or f4 not in F4_SUPPORTED:
        raise ValueError(f"subpixel_head_dx: weight must be a contiguous "
                         f"(2, 2, C, {f4}) f32/bf16 tensor on {dz.device}, "
                         f"got {w.dtype} {tuple(w.shape)} on {w.device}")
    c = w.shape[2]
    code = build.DTYPE_CODES[w.dtype]
    lib, fn = build.load("subpixel_head", "p2p_subpixel_head_dx")
    smem = lib.p2p_subpixel_head_dx_smem(code, wo - 1, c, f4)
    if smem > _MAX_SMEM:
        raise ValueError(f"subpixel_head_dx: C = {c} needs {smem} bytes of "
                         f"shared memory per block (at most {_MAX_SMEM})")
    dx = torch.empty((n, c, ho - 1, wo - 1), device=dz.device, dtype=w.dtype,
                     memory_format=torch.channels_last)
    with torch.cuda.device(dz.device):
        err = fn(dz.data_ptr(), w.data_ptr(), dx.data_ptr(), code, n, ho - 1,
                 wo - 1, c, f4, build.stream_handle(dz.device))
    build.check(lib, err, "subpixel_head_dx")
    build.count_launch(subpixel_head_dx)
    return dx


subpixel_head_fwd.launches = 0
subpixel_head_dx.launches = 0


class SubpixelHeadConv(torch.autograd.Function):
    """The conv with #6 as its forward and #7 + the library wgrad as its
    backward (the JAX ``subpixel_head_conv`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return subpixel_head_fwd(x, w)

    @staticmethod
    def backward(ctx, dz):
        x, w = ctx.saved_tensors
        dz = dz.float().contiguous(memory_format=torch.channels_last)
        dx = subpixel_head_dx(dz, w) if ctx.needs_input_grad[0] else None
        dw = subpixel_head_dw(x, dz, w) if ctx.needs_input_grad[1] else None
        return dx, dw


def subpixel_head_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv(x, w, pad 1) → f32 z through #6, differentiable through #7."""
    return SubpixelHeadConv.apply(x, w)
