"""The reflect pad of the port's conv layers (``ops/conv.reflect_pad_2d``)
and its fixed-order backward (``_FixedOrderReflectPad``, which a CUDA
tensor takes under ``torch.backends.cudnn.deterministic``): on the CPU,
its forward bitwise ``F.pad(mode="reflect")`` and its input gradient
exactly autograd's of ``F.pad`` (f64 with integer cotangents, so every
sum is exact whatever its order), at every pad the port's layers use, a
pad as wide as the input allows, NCHW and channels_last; and a CPU tensor
keeps PyTorch's own pad under the flag. The card's case (bitwise
repeatable and against f64) is in ``test_torch_cuda_kernels.py``.
"""

import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from p2p_tpu_torch.ops import conv  # noqa: E402


def _input(shape, channels_last):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-8, 9, shape, generator=g).double()
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x.requires_grad_(True)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape,pad", [((2, 3, 9, 11), 1), ((1, 4, 8, 8), 2),
                                       ((1, 2, 12, 10), 4),
                                       ((1, 1, 5, 6), 4)])
def test_fixed_order_reflect_pad_is_f_pad_forward_and_backward(
        shape, pad, channels_last):
    x = _input(shape, channels_last)
    z = x.detach().clone().requires_grad_(True)
    y = conv._FixedOrderReflectPad.apply(x, pad)
    want = F.pad(z, (pad,) * 4, mode="reflect")
    assert torch.equal(y, want)
    cot = torch.randint(-64, 65, want.shape, generator=torch.Generator(
    ).manual_seed(7)).double()
    (y * cot).sum().backward()
    (want * cot).sum().backward()
    assert torch.equal(x.grad, z.grad)


def test_cpu_tensor_keeps_pytorchs_pad_under_the_flag():
    x = _input((1, 2, 6, 6), False)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        y = conv.reflect_pad_2d(x, 2)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert "ReflectionPad2D" in y.grad_fn.name()
    assert conv.reflect_pad_2d(x, 0) is x
