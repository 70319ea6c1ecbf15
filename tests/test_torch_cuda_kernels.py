"""The port's CUDA kernels against their plain versions on the card, at
shapes chip_smoke.py does not reach: odd channel counts (one element per
access), a misaligned view, N > 1 and a residual with an affine. Runs only
where there is a CUDA device (``-m gpu`` on the card); skips elsewhere.

Tolerance: f32 atol 1e-4 (order of partial sums); bf16 atol 1e-2 + rtol
2⁻⁷ (one rounding of the stored value).
"""

import pytest

torch = pytest.importorskip("torch")

from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (  # noqa: E402
    instance_norm_stats, instance_norm_stats_plain)
from p2p_tpu_torch.ops.cuda.norm_act import (  # noqa: E402
    norm_act, norm_act_plain)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _x(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(
        dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (2, 24, 33, 17),
                                   (1, 64, 1, 1), (4, 32, 40, 40)])
def test_kernels_match_plain_versions(cuda, dtype, shape):
    x = _x(shape, dtype, cuda, 0)
    r = _x(shape, dtype, cuda, 1)
    c = shape[1]
    g = torch.Generator(device=cuda).manual_seed(2)
    scale = torch.randn(c, generator=g, device=cuda) * 0.1 + 1
    bias = torch.randn(c, generator=g, device=cuda) * 0.1
    mean, rstd = instance_norm_stats(x)
    pmean, prstd = instance_norm_stats_plain(x)
    torch.testing.assert_close(mean, pmean, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(rstd, prstd, atol=1e-4, rtol=1e-4)
    atol, rtol = TOL[dtype]
    for act in ("none", "relu", "leaky"):
        for kw in ({}, {"residual": r}, {"scale": scale, "bias": bias,
                                         "residual": r}):
            y = norm_act(x, pmean, prstd, act=act, **kw)
            want = norm_act_plain(x, pmean, prstd, act=act, **kw)
            assert y.is_contiguous(memory_format=torch.channels_last)
            torch.testing.assert_close(y.float(), want.float(), atol=atol,
                                       rtol=rtol)
    torch.cuda.synchronize()


def test_kernels_take_a_misaligned_view_one_element_at_a_time(cuda):
    base = torch.randn(1 + 2 * 8 * 6 * 6, device=cuda)
    x = base[1:].view(2, 6, 6, 8).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.data_ptr() % 16
    mean, rstd = instance_norm_stats(x)
    pmean, prstd = instance_norm_stats_plain(x)
    torch.testing.assert_close(mean, pmean, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(norm_act(x, pmean, prstd, act="relu"),
                               norm_act_plain(x, pmean, prstd, act="relu"),
                               atol=1e-4, rtol=0)


def test_kernels_are_reproducible_and_count_launches(cuda):
    x = _x((2, 32, 64, 64), torch.bfloat16, cuda, 3)
    n0, m0 = instance_norm_stats.launches, norm_act.launches
    a = instance_norm_stats(x)
    b = instance_norm_stats(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    norm_act(x, *a, act="relu")
    assert (instance_norm_stats.launches - n0, norm_act.launches - m0) \
        == (2, 1)


def test_wrappers_raise_on_a_layout_they_do_not_take(cuda):
    x = torch.randn((1, 8, 4, 4), device=cuda)          # NCHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        instance_norm_stats(x)
    xh = x.half().contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError, match="not supported"):
        instance_norm_stats(xh)
