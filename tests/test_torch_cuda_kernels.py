"""The port's CUDA kernels against their plain versions on the card, at
shapes chip_smoke.py does not reach: odd channel counts (one element per
access), a misaligned view, N > 1, a residual with an affine, for the
BatchNorm moments kernel (#5) ragged M, C = 3, M = 1, many chunks, the
same bits on a side stream and in a CUDA graph, and the autograd
backward,
for the subpixel head's forward (#6) and dx (#7) the path's shapes,
ragged widths, every F4 and the autograd function, and for the act-free
normalize kernel (#2) the ExpandNetwork's shapes (C = 3 one element at a
time), an affine, a misaligned view, its launch count, #3 and #2 bitwise
against their plain versions in every form at ragged pixel counts, C = 3
and with a misaligned operand, and the two
instance-norm autograd Functions (kernels forward, closed-form backward)
against autograd of the plain chain; for the quantize-fused epilogue (#4)
the facades_int8 D's shapes and odd ones, bitwise against its plain
version (q and amax) given the same statistics, with rounding ties, NaN
propagation, a grid of many blocks, its launch count and its refusals;
and every int8 contraction of that D (im2col + ``torch._int_mm``) exact
against an f64 conv or product of the same int8 operands, and the int8
conv Functions and the quantize-fused Function on the card against the
CPU. The tensor-core forward of the subpixel head (#6, bf16) and its
f32 form at every F4, C = 5, 8, 40, 128 and 256, a ragged and a square
head, N = 1, 2 and 3 (bands of one to four rows), every output written
and bitwise repeatable, and its launch plan within an H100's shared
memory for every C the head takes. The tensor-core dx of the subpixel
head (#7, bf16; dz cut into three bf16 pieces): a sum that cancels down
to the last bits of dz exact, NaN, ±inf and −0 in dz non-finite exactly
where the plain version is, every F4 at C = 5, 8, 40, 128 and 256 with
every output written and bitwise repeatable, misaligned dz and w, and its
launch plan within an H100's shared memory. #2 and #4 as the main path launches
them (programmatic dependents of #1's finalize, x read before the wait):
bitwise their plain versions on #1's statistics over 50 launches back to
back at every path shape, with a PyTorch kernel writing x right before
each #1, and replayed in a CUDA graph; #3 as the main path launches it
(a programmatic dependent of #1's finalize, x and the residual read before
the wait) the same way, with a PyTorch kernel writing x and the residual
right before each #1, at path shapes of every form and one of more than a
wave; #1 (its finalize a programmatic dependent of its pass 1) the same
bits for the same input over 50 launches on alternating inputs; #2 at C = 3
on 16-byte vectors across pixels where H·W·3 divides into them; #4 with
NaN, ±inf and −0 in x, its arrival counter and max word left at 0.
The temporal 3-D discriminator of the video slice (split stem,
``SpectralConv3D``, both scales) in f32 with TF32 off on the card against
itself in f64 on the CPU (its stem as one f64 ``F.conv3d``): features,
input and parameter gradients within 1e-4 of each tensor's largest (f32
sums of up to 12,288 products, about √n·2⁻²⁴ ≈ 7e-6 of the largest),
the advanced ``u`` within 1e-5; and a clip sent to the card
(``to_device_clip``) is channels_last_3d, its frames a view, G's frames a
view of the fake clip. The discriminators' pooling
(``models/patchgan.avg_pool_downsample``, AvgPool 3 s2 p1 without the
padding in the count) on a channels_last input: output and input gradient
within 1e-6 of their largest against f64 on the CPU (sums of 9 terms),
output channels_last.
The conv layers' reflect pad (``ops/conv.reflect_pad_2d``) under
``torch.backends.cudnn.deterministic`` at the reference G's k9 stem and
residual blocks: its fixed-order backward the same bits over 20
backward passes, and within 1e-6 of the largest entry of the f64 CPU
gradient (sums of up to 4 terms).
SSIM (``losses/metrics.ssim``, the eval's metric) on the card: exactly 1
for an image against itself, and within 1e-5 of a float64 numpy SSIM
(its window sums on the CUDA cores are exact integers, so no TF32 enters).
Runs only where there is a CUDA device (``-m gpu`` on the card); skips
elsewhere.

Tolerance: f32 atol 1e-4 (order of partial sums); bf16 atol 1e-2 + rtol
2⁻⁷ (one rounding of the stored value); #4, the int8 contractions, #2
and #4 after #1, #3 after #1, and #3 and #2 in their every-form test
exact; #5's f32 sums within 1e-5 of the
sum of |terms| (the same terms summed in two orders); #6's f32 output
within 1e-4 + 1e-4 relative in both input types (bf16 products are exact
in f32), #7's dx in f32 as the other f32 outputs and in bf16 within
``HEAD_DX_TOL``. The plain versions run with TF32 off.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (  # noqa: E402
    instance_norm_apply, instance_norm_apply_plain, instance_norm_stats,
    instance_norm_stats_plain)
from p2p_tpu_torch.ops.instance_norm import (  # noqa: E402
    instance_norm_act, instance_norm_fused)
from p2p_tpu_torch.ops.cuda.batch_moments import (  # noqa: E402
    batch_moments, batch_moments_plain)
from p2p_tpu_torch.ops.cuda.norm_act import (  # noqa: E402
    norm_act, norm_act_plain)
from p2p_tpu_torch.ops.norm import dual_moments  # noqa: E402
from p2p_tpu_torch.ops.cuda.subpixel_head import (  # noqa: E402
    subpixel_head_conv, subpixel_head_dx, subpixel_head_dx_plain,
    subpixel_head_fwd, subpixel_head_fwd_plain)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0 ** -7)}


def _smoke():
    """chip_smoke.py (where #7's bf16 band and the float64 SSIM are)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_tol", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HEAD_DX_TOL = _smoke().HEAD_DX_TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def no_tf32(cuda):
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = saved


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


def _rows(m, c, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    mean = torch.linspace(-2.0, 2.0, c, device=device)
    mean[0] = 40.0
    return (torch.randn((m, c), generator=g, device=device) + mean).to(dtype)


def _assert_moments_close(got, want, x):
    scale = (x.float().abs().sum(0), want[1])
    for a, b, s in zip(got, want, scale):
        assert bool(((a - b).abs() <= 1e-5 * s + 1e-6).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", [(1, 3), (291, 3), (1000, 8), (777, 128),
                                 (4096, 128), (100, 24), (65536, 64),
                                 (1, 512), (257, 512), (4097, 128),
                                 (65539, 32), (65536, 3), (300001, 64)])
def test_batch_moments_matches_plain_version(cuda, dtype, m, c):
    x = _rows(m, c, dtype, cuda, m + c)
    _assert_moments_close(batch_moments(x), batch_moments_plain(x), x)


def test_batch_moments_is_reproducible_counts_and_takes_a_misaligned_view(
        cuda):
    x = _rows(4096, 32, torch.bfloat16, cuda, 4)
    n = batch_moments.launches
    a, b = batch_moments(x), batch_moments(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert batch_moments.launches - n == 2
    base = _rows(1 + 64 * 8, 1, torch.float32, cuda, 5).reshape(-1)
    xm = base[1:].view(64, 8)
    assert xm.data_ptr() % 16
    _assert_moments_close(batch_moments(xm), batch_moments_plain(xm), xm)
    with pytest.raises(ValueError, match="contiguous"):
        batch_moments(x.t())


# one chunk (no second launch), partials + finalize, one element an access,
# many chunks
MOMENT_BITS_SHAPES = [(16, 512), (4096, 128), (65536, 64), (65536, 3),
                      (300001, 64)]


@pytest.mark.parametrize("m,c", MOMENT_BITS_SHAPES)
def test_batch_moments_gives_the_same_bits_on_a_side_stream_and_in_a_graph(
        cuda, m, c):
    """Two runs, a run on a side stream and the replay of a CUDA graph that
    captured the launches (the finalize's programmatic dependent launch
    becomes a programmatic edge of the graph) give the same bits."""
    x = _rows(m, c, torch.bfloat16, cuda, m + c)
    a, b = batch_moments(x), batch_moments(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        s = batch_moments(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g = batch_moments(x)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got in (b, s, g):
            assert torch.equal(got[0], a[0]) and torch.equal(got[1], a[1])
    _assert_moments_close(a, batch_moments_plain(x), x)


def test_dual_moments_backward_on_the_card(cuda):
    x = _rows(300, 16, torch.float32, cuda, 6).requires_grad_(True)
    ds, dss = torch.randn(16, device=cuda), torch.randn(16, device=cuda)
    s1, s2 = dual_moments(x)
    (got,) = torch.autograd.grad((s1 * ds).sum() + (s2 * dss).sum(), x)
    torch.testing.assert_close(got, ds + 2 * x.detach() * dss, atol=1e-5,
                               rtol=1e-6)
    torch.cuda.synchronize()


def _head(n, c, h, w, f4, dtype, device, seed):
    x = _x((n, c, h, w), dtype, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    wt = (torch.randn((2, 2, c, f4), generator=g, device=device) * 0.05).to(
        dtype)
    dz = _x((n, f4, h + 1, w + 1), torch.float32, device, seed + 2)
    return x, wt, dz


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,f4", [
    (1, 128, 128, 128, 12), (2, 128, 128, 128, 12), (4, 128, 128, 128, 12),
    (2, 32, 12, 10, 12), (3, 5, 7, 33, 4), (1, 64, 1, 1, 8),
    (2, 24, 31, 65, 16), (1, 300, 9, 40, 12)])
def test_subpixel_head_kernels_match_plain_versions(no_tf32, dtype, n, c, h,
                                                    w, f4):
    x, wt, dz = _head(n, c, h, w, f4, dtype, no_tf32, n + c + h)
    z = subpixel_head_fwd(x, wt)
    assert z.dtype == torch.float32 and z.shape == (n, f4, h + 1, w + 1)
    assert z.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(z, subpixel_head_fwd_plain(x, wt), atol=1e-4,
                               rtol=1e-4)
    dx = subpixel_head_dx(dz, wt)
    assert dx.dtype == dtype and dx.shape == x.shape
    assert dx.is_contiguous(memory_format=torch.channels_last)
    atol, rtol = HEAD_DX_TOL if dtype == torch.bfloat16 else TOL[dtype]
    torch.testing.assert_close(dx.float(),
                               subpixel_head_dx_plain(dz, wt).float(),
                               atol=atol, rtol=rtol)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f4", [4, 8, 12, 16])
@pytest.mark.parametrize("c", [5, 8, 40, 128, 256])
def test_subpixel_head_fwd_every_f4_and_c(no_tf32, dtype, f4, c):
    """#6 (tensor cores in bf16, CUDA cores in f32) against its plain
    version within HEAD_Z_TOL at a ragged and a square head, N = 1, 2 and
    3 (at C = 128, bands of 1, 2 and 3 rows, the last one clipped at
    N = 2), and the same bits from a second launch; C = 5 takes element loads.
    z is allocated where a NaN tensor of its size was just freed (the
    caching allocator hands the block back), so an output no block wrote
    shows."""
    for n, h, w in ((1, 5, 37), (2, 128, 128), (3, 128, 128)):
        x, wt, _ = _head(n, c, h, w, f4, dtype, no_tf32, c + f4 + n)
        torch.full((n, f4, h + 1, w + 1), float("nan"), device=no_tf32)
        z = subpixel_head_fwd(x, wt)
        assert z.shape == (n, f4, h + 1, w + 1)
        torch.testing.assert_close(z, subpixel_head_fwd_plain(x, wt),
                                   atol=1e-4, rtol=1e-4)
        assert torch.equal(subpixel_head_fwd(x, wt), z), (n, h, w)
    torch.cuda.synchronize()


def test_subpixel_head_fwd_takes_misaligned_operands(no_tf32):
    """x and w views off their 16- and 8-byte alignment: element loads."""
    x, wt, _ = _head(2, 64, 9, 20, 12, torch.bfloat16, no_tf32, 60)
    xb = torch.empty(x.numel() + 1, dtype=x.dtype, device=no_tf32)
    xm = xb[1:].view(2, 9, 20, 64).permute(0, 3, 1, 2)
    xm.copy_(x)
    wb = torch.empty(wt.numel() + 1, dtype=wt.dtype, device=no_tf32)
    wm = wb[1:].view(wt.shape)
    wm.copy_(wt)
    assert xm.data_ptr() % 16 and wm.data_ptr() % 8
    torch.testing.assert_close(subpixel_head_fwd(xm, wm),
                               subpixel_head_fwd_plain(x, wt), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("f4", [4, 8, 12, 16])
def test_subpixel_head_fwd_plan_fits_every_c_the_head_takes(cuda, f4):
    """The head takes C = 2·ngf ≥ 16·F (U-Net, F = F4 / 4 output
    channels): every such C up to 512 has a bf16 plan within an H100's
    232,448 bytes per block at the widths of 256² to 2048² images (the
    plan is the CUDA source's; its library reports the bytes); C = 1024
    does not, and the wrapper raises."""
    from p2p_tpu_torch.ops.cuda import build

    lib = build.library("subpixel_head")
    bf16 = build.DTYPE_CODES[torch.bfloat16]
    for c in range(4 * f4, 513, 8):
        for w in (128, 256, 512, 1024):
            assert 0 < lib.p2p_subpixel_head_fwd_smem(bf16, w, c, f4) \
                <= 232448, (c, w)
    x, wt, _ = _head(1, 1024, 4, 4, f4, torch.bfloat16, cuda, 11)
    with pytest.raises(ValueError, match="shared memory"):
        subpixel_head_fwd(x, wt)


def _dx_close(dx, dz, wt):
    atol, rtol = HEAD_DX_TOL if wt.dtype == torch.bfloat16 else TOL[wt.dtype]
    torch.testing.assert_close(dx.float(),
                               subpixel_head_dx_plain(dz, wt).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f4", [4, 8, 12, 16])
@pytest.mark.parametrize("c", [5, 8, 40, 128, 256])
def test_subpixel_head_dx_every_f4_and_c(no_tf32, dtype, f4, c):
    """#7 against its plain version at a ragged and a square head, N = 1,
    2 and 3 (bands of one or two rows), and the same bits from a second
    launch; C = 5 and 40 leave n8 tiles past C, C = 256 takes four
    64-channel slices a tile. dx is allocated where a NaN tensor of its
    size was just freed, so an output no block wrote shows."""
    for n, h, w in ((1, 5, 37), (2, 128, 128), (3, 128, 128)):
        _, wt, dz = _head(n, c, h, w, f4, dtype, no_tf32, c + f4 + n)
        torch.full((n, c, h, w), float("nan"), dtype=dtype, device=no_tf32)
        dx = subpixel_head_dx(dz, wt)
        assert dx.shape == (n, c, h, w)
        _dx_close(dx, dz, wt)
        assert torch.equal(subpixel_head_dx(dz, wt), dx), (n, h, w)
    torch.cuda.synchronize()


def test_subpixel_head_dx_keeps_every_bit_of_dz(no_tf32):
    """w = +1 on tap (0, 0) and -1 on tap (1, 1) of one (c, f) per
    channel, so dx[r, s, c] = dz[r+1, s+1, f] - dz[r, s, f]; dz = b·(1 +
    (i + j)·2^-21) with b of 2 significant bits, exact in f32, so every dx
    is b·2^-20, which a bf16 holds: it lives in the last 4 bits of dz's 24,
    which a two-piece bf16 split drops. dx must be that exactly, as the
    plain version gives it with TF32 off."""
    n, c, h, w, f4 = 2, 24, 9, 33, 12
    wt = torch.zeros((2, 2, c, f4), dtype=torch.bfloat16)
    for cc in range(c):
        wt[0, 0, cc, cc % f4] = 1.0
        wt[1, 1, cc, cc % f4] = -1.0
    rng = np.random.default_rng(3)
    b = rng.choice([-3.0, -1.5, -0.75, 0.75, 1.5, 3.0], size=(n, 1, 1, f4))
    ij = np.arange(h + 1)[:, None, None] + np.arange(w + 1)[None, :, None]
    dz64 = b * (1.0 + ij * 2.0 ** -21)
    assert np.array_equal(dz64.astype(np.float32).astype(np.float64), dz64)
    dz = torch.from_numpy(dz64.astype(np.float32)).permute(0, 3, 1, 2).to(
        no_tf32)
    wt = wt.to(no_tf32)
    want = torch.from_numpy(np.broadcast_to(
        b[..., [cc % f4 for cc in range(c)]] * 2.0 ** -20,
        (n, h, w, c)).astype(np.float32)).permute(0, 3, 1, 2).to(
            device=no_tf32, dtype=torch.bfloat16)
    dx = subpixel_head_dx(dz, wt)
    assert torch.equal(dx, want)
    assert torch.equal(subpixel_head_dx_plain(dz, wt), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subpixel_head_dx_is_non_finite_where_the_plain_version_is(
        no_tf32, dtype):
    """NaN, +inf, -inf and -0 in dz (a -0 row too), and zeros in w (inf ·
    0 is NaN): dx is non-finite exactly where the plain version's is (the
    bf16 kernel may give NaN where it gives ±inf: the remainder inf - inf
    is NaN), and elsewhere within the band."""
    _, wt, dz = _head(2, 40, 9, 20, 12, dtype, no_tf32, 21)
    wt[0, 1, 3, :] = 0
    wt[1, 0, :, 5] = 0
    v = dz.permute(0, 2, 3, 1)             # NHWC view of the same memory
    v[0, 3, 4, 5] = float("nan")
    v[0, 7, 7, 0] = float("inf")
    v[1, 2, 10, 11] = float("-inf")
    v[1, 8, 3, 5] = float("inf")
    v[0, 5, 5, 2] = -0.0
    v[1, 4] = -0.0
    dx = subpixel_head_dx(dz, wt).float()
    pdx = subpixel_head_dx_plain(dz, wt).float()
    bad = ~torch.isfinite(pdx)
    assert 0 < int(bad.sum()) < bad.numel()
    assert torch.equal(~torch.isfinite(dx), bad)
    atol, rtol = HEAD_DX_TOL if dtype == torch.bfloat16 else TOL[dtype]
    torch.testing.assert_close(dx[~bad], pdx[~bad], atol=atol, rtol=rtol)


def test_subpixel_head_dx_takes_misaligned_operands(no_tf32):
    """dz and w views off their 16- and 4-byte alignment, each alone and
    both: element loads and stores."""
    _, wt, dz = _head(2, 64, 9, 20, 12, torch.bfloat16, no_tf32, 61)
    zb = torch.empty(dz.numel() + 1, dtype=dz.dtype, device=no_tf32)
    dzm = zb[1:].view(2, 10, 21, 12).permute(0, 3, 1, 2)
    dzm.copy_(dz)
    wb = torch.empty(wt.numel() + 1, dtype=wt.dtype, device=no_tf32)
    wm = wb[1:].view(wt.shape)
    wm.copy_(wt)
    assert dzm.data_ptr() % 16 and wm.data_ptr() % 4
    want = subpixel_head_dx(dz, wt)
    for d, ww in ((dzm, wt), (dz, wm), (dzm, wm)):
        got = subpixel_head_dx(d, ww)
        _dx_close(got, dz, wt)
        assert torch.equal(got, want)


@pytest.mark.parametrize("f4", [4, 8, 12, 16])
def test_subpixel_head_dx_plan_fits_every_c_the_head_takes(cuda, f4):
    """Every C up to 1024 has a bf16 #7 plan within an H100's 232,448
    bytes per block at the widths of 256² to 2048² images (the plan is the
    CUDA source's); C = 4096 does not, and the wrapper raises."""
    from p2p_tpu_torch.ops.cuda import build

    lib = build.library("subpixel_head")
    bf16 = build.DTYPE_CODES[torch.bfloat16]
    for c in range(4 * f4, 1025, 8):
        for w in (128, 256, 512, 1024):
            assert 0 < lib.p2p_subpixel_head_dx_smem(bf16, w, c, f4) \
                <= 232448, (c, w)
    _, wt, dz = _head(1, 4096, 4, 4, f4, torch.bfloat16, cuda, 11)
    with pytest.raises(ValueError, match="shared memory"):
        subpixel_head_dx(dz, wt)


def test_subpixel_head_kernels_are_reproducible_and_count_launches(cuda):
    x, wt, dz = _head(2, 128, 64, 64, 12, torch.bfloat16, cuda, 7)
    n_fwd, n_dx = subpixel_head_fwd.launches, subpixel_head_dx.launches
    assert torch.equal(subpixel_head_fwd(x, wt), subpixel_head_fwd(x, wt))
    assert torch.equal(subpixel_head_dx(dz, wt), subpixel_head_dx(dz, wt))
    assert (subpixel_head_fwd.launches - n_fwd,
            subpixel_head_dx.launches - n_dx) == (2, 2)


def test_subpixel_head_conv_backward_on_the_card(no_tf32):
    """The autograd function: #7 for dx, the library's wgrad for dW, each
    against autograd of the plain forward."""
    x, wt, _ = _head(2, 32, 12, 10, 12, torch.float32, no_tf32, 8)
    x.requires_grad_(True)
    wt.requires_grad_(True)
    z = subpixel_head_conv(x, wt)
    r = torch.randn(z.shape, device=no_tf32)
    dx, dw = torch.autograd.grad((z * r).sum(), (x, wt))
    x2 = x.detach().requires_grad_(True)
    w2 = wt.detach().requires_grad_(True)
    pdx, pdw = torch.autograd.grad(
        (subpixel_head_fwd_plain(x2, w2) * r).sum(), (x2, w2))
    torch.testing.assert_close(dx, pdx, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dw, pdw, atol=1e-4, rtol=1e-4)


def test_subpixel_head_wrappers_raise_on_what_they_do_not_take(cuda):
    x, wt, dz = _head(1, 16, 8, 8, 12, torch.float32, cuda, 9)
    with pytest.raises(ValueError, match="channels_last"):
        subpixel_head_fwd(x.contiguous(), wt)
    with pytest.raises(ValueError, match="F4"):
        subpixel_head_fwd(x, wt[..., :6].contiguous())
    with pytest.raises(ValueError, match="weight"):
        subpixel_head_fwd(x, wt.to(torch.bfloat16))
    with pytest.raises(TypeError, match="f32"):
        subpixel_head_dx(dz.to(torch.bfloat16), wt)
    with pytest.raises(ValueError, match="shared memory"):
        xs, ws, _ = _head(1, 1024, 4, 4, 16, torch.float32, cuda, 10)
        subpixel_head_fwd(xs, ws)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32, 256, 256), (1, 3, 256, 256),
                                   (2, 64, 33, 17), (1, 5, 7, 9)])
def test_instance_norm_apply_matches_plain_version(cuda, dtype, shape):
    x = _x(shape, dtype, cuda, 11)
    c = shape[1]
    g = torch.Generator(device=cuda).manual_seed(12)
    scale = torch.randn(c, generator=g, device=cuda) * 0.1 + 1
    bias = torch.randn(c, generator=g, device=cuda) * 0.1
    mean, rstd = instance_norm_stats_plain(x)
    atol, rtol = TOL[dtype]
    n0 = instance_norm_apply.launches
    for kw in ({}, {"scale": scale, "bias": bias}):
        y = instance_norm_apply(x, mean, rstd, **kw)
        assert y.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(
            y.float(), instance_norm_apply_plain(x, mean, rstd, **kw).float(),
            atol=atol, rtol=rtol)
    assert instance_norm_apply.launches - n0 == 2
    torch.cuda.synchronize()


def test_instance_norm_apply_takes_a_misaligned_view(cuda):
    base = torch.randn(1 + 2 * 8 * 6 * 6, device=cuda)
    x = base[1:].view(2, 6, 6, 8).permute(0, 3, 1, 2)
    assert x.data_ptr() % 16
    mean, rstd = instance_norm_stats_plain(x)
    torch.testing.assert_close(instance_norm_apply(x, mean, rstd),
                               instance_norm_apply_plain(x, mean, rstd),
                               atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="channels_last"):
        instance_norm_apply(x.contiguous(), mean, rstd)


def _aligned_views(x):
    """x as it is, and the same values in a channels_last view whose data
    starts 4 bytes past a 16-byte boundary."""
    n, c, h, w = x.shape
    base = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    off = 4 // x.element_size()
    xm = base[off:off + x.numel()].view(n, h, w, c).permute(0, 3, 1, 2)
    xm.copy_(x)
    assert xm.data_ptr() % 16 and xm.is_contiguous(
        memory_format=torch.channels_last)
    return x, xm


def _misaligned_f32(t):
    base = torch.empty(t.numel() + 1, device=t.device)
    v = base[1:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,where", [
    ((2, 64, 33, 17), "x"), ((1, 128, 7, 9), "x"), ((1, 3, 40, 40), "x"),
    ((2, 64, 33, 17), "misaligned x"), ((2, 64, 33, 17), "misaligned stats"),
    ((1, 32, 29, 31), "misaligned residual")])
def test_norm_act_and_apply_are_bitwise_the_plain_versions(cuda, dtype,
                                                           shape, where):
    """#3 in every act/residual/affine form and #2 with and without the
    affine, bitwise against their plain versions: at ragged pixel counts
    (the tiled pass's last rows), at C = 3 and with one misaligned operand
    (the one-element pass)."""
    x = _x(shape, dtype, cuda, 21)
    r = _x(shape, dtype, cuda, 22)
    c = shape[1]
    g = torch.Generator(device=cuda).manual_seed(23)
    scale = torch.randn(c, generator=g, device=cuda) * 0.1 + 1
    bias = torch.randn(c, generator=g, device=cuda) * 0.1
    mean, rstd = instance_norm_stats_plain(x)
    if where == "misaligned x":
        x = _aligned_views(x)[1]
    elif where == "misaligned residual":
        r = _aligned_views(r)[1]
    elif where == "misaligned stats":
        mean, rstd = _misaligned_f32(mean), _misaligned_f32(rstd)
    for affine in ({}, {"scale": scale, "bias": bias}):
        y = instance_norm_apply(x, mean, rstd, **affine)
        assert torch.equal(y, instance_norm_apply_plain(x, mean, rstd,
                                                        **affine))
        for act in ("none", "relu", "leaky"):
            for res in ({}, {"residual": r}):
                y = norm_act(x, mean, rstd, act=act, **affine, **res)
                want = norm_act_plain(x, mean, rstd, act=act, **affine, **res)
                assert torch.equal(y, want), (act, affine.keys(), res.keys())
    torch.cuda.synchronize()


def _plain_chain(x, scale, bias, residual, act):
    """Autograd through the plain versions of the kernels."""
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act_plain

    mean, rstd = instance_norm_stats_plain(x)
    return norm_act_plain(x, mean, rstd, scale, bias, residual, act)


@pytest.mark.parametrize("act,res,affine", [
    ("apply", False, True), ("relu", True, False), ("leaky", False, False),
    ("none", True, True)])
def test_instance_norm_functions_backward_on_the_card(no_tf32, act, res,
                                                      affine):
    shape = (2, 64, 40, 40)
    x = _x(shape, torch.float32, no_tf32, 13).requires_grad_(True)
    r = _x(shape, torch.float32, no_tf32, 14).requires_grad_(True) \
        if res else None
    g = torch.Generator(device=no_tf32).manual_seed(15)
    scale = (torch.randn(64, generator=g, device=no_tf32) * 0.1 + 1
             ).requires_grad_(True) if affine else None
    bias = (torch.randn(64, generator=g, device=no_tf32) * 0.1
            ).requires_grad_(True) if affine else None
    up = torch.randn(shape, generator=g, device=no_tf32)
    leaves = [t for t in (x, r, scale, bias) if t is not None]
    if act == "apply":
        y = instance_norm_fused(x, scale, bias)
    else:
        y = instance_norm_act(x, scale, bias, r, act=act)
    got = torch.autograd.grad((y * up).sum(), leaves)
    want = torch.autograd.grad(
        (_plain_chain(x, scale, bias, r, "none" if act == "apply" else act)
         * up).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    torch.cuda.synchronize()


# the facades_int8 D's #4 shapes (N, C, H, W), and odd ones: one element
# per access, N > 1, a grid of many blocks
QUANT_SHAPES = [(1, 128, 65, 65), (1, 256, 33, 33), (2, 24, 33, 17),
                (4, 64, 128, 128)]


def _quant_args(x, seed, affine, tie):
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_stats_plain)

    c = x.shape[1]
    g = torch.Generator(device=x.device).manual_seed(seed)
    mean, rstd = instance_norm_stats_plain(x)
    if tie:     # binary grids: activations over 2^-4 hit rounding ties
        mean, rstd = (mean * 16).round() / 16, (rstd * 4).round() / 4
    scale = bias = None
    if affine:
        scale = ((torch.rand(c, generator=g, device=x.device) + 0.5) * 16
                 ).round() / 16
        bias = (torch.randn(c, generator=g, device=x.device) * 3).round() / 16
    sx = torch.tensor(2.0 ** -4 if tie else 2.5 / 127.0, device=x.device)
    return mean, rstd, scale, bias, sx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", QUANT_SHAPES)
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_norm_act_quant_is_bitwise_the_plain_version(cuda, dtype, shape,
                                                     act):
    from p2p_tpu_torch.ops.cuda.norm_act import (norm_act_quant,
                                                 norm_act_quant_plain)

    x = _x(shape, torch.float32, cuda, 20)
    for affine in (False, True):
        for tie in (False, True):
            xx = ((x * 16).round() / 16 if tie else x).to(dtype)
            mean, rstd, scale, bias, sx = _quant_args(xx, 21, affine, tie)
            q, amax = norm_act_quant(xx, mean, rstd, scale, bias, sx, act)
            pq, pamax = norm_act_quant_plain(xx, mean, rstd, scale, bias, sx,
                                             act)
            assert q.dtype == dtype and amax.shape == ()
            assert q.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(q, pq), (affine, tie)
            assert torch.equal(amax, pamax), (affine, tie)
    torch.cuda.synchronize()


def test_norm_act_quant_propagates_nan_and_counts_launches(cuda):
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act_quant

    x = _x((4, 64, 128, 128), torch.bfloat16, cuda, 22)
    mean, rstd, _, _, sx = _quant_args(x, 23, False, False)
    n0 = norm_act_quant.launches
    a = norm_act_quant(x, mean, rstd, sx=sx, act="leaky")
    b = norm_act_quant(x, mean, rstd, sx=sx, act="leaky")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    x[3, 5, 127, 127] = float("nan")
    _, amax = norm_act_quant(x, mean, rstd, sx=sx, act="leaky")
    assert torch.isnan(amax)
    _, after = norm_act_quant(x[:3], mean[:3], rstd[:3], sx=sx, act="leaky")
    assert torch.isfinite(after)
    assert norm_act_quant.launches - n0 == 4


def test_norm_act_quant_leaves_its_arrival_counter_at_zero(cuda):
    """Launches of other grid sizes, one after another and on a second
    stream, each reduce their own amax: the last block sets the shared
    counter back to 0."""
    from p2p_tpu_torch.ops.cuda.norm_act import (_arrival_counter,
                                                 norm_act_quant,
                                                 norm_act_quant_plain)

    side = torch.cuda.Stream(cuda)
    for shape in ((4, 64, 128, 128), (1, 8, 4, 4), (1, 256, 33, 33)) * 2:
        x = _x(shape, torch.float32, cuda, 26)
        mean, rstd, _, _, sx = _quant_args(x, 27, False, False)
        want = norm_act_quant_plain(x, mean, rstd, sx=sx, act="relu")[1]
        assert torch.equal(norm_act_quant(x, mean, rstd, sx=sx,
                                          act="relu")[1], want), shape
        side.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):
            got = norm_act_quant(x, mean, rstd, sx=sx, act="relu")[1]
        torch.cuda.current_stream(cuda).wait_stream(side)
        assert torch.equal(got, want), shape
    torch.cuda.synchronize()
    for stream in (torch.cuda.current_stream(cuda), side):
        counter = _arrival_counter(x.device, stream.cuda_stream)
        assert counter.tolist() == [0, 0]      # the counter and the max word


def _special(x, kind):
    """x with NaN, ±inf or −0 written into some elements."""
    x = x.clone(memory_format=torch.channels_last)
    flat = x.permute(0, 2, 3, 1).reshape(-1)
    values = {"nan": (float("nan"), 1.0), "inf": (float("inf"),
                                                  float("-inf")),
              "negzero": (-0.0, -0.0)}[kind]
    flat[7::97] = values[0]
    flat[50::131] = values[1]
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["nan", "inf", "negzero"])
def test_norm_act_quant_special_values_and_a_clean_next_launch(cuda, dtype,
                                                               kind):
    """NaN, ±inf and −0 in x: q as the plain version's (NaN where it has
    one), amax NaN, +inf or the plain amax; the arrival counter and the max
    word are 0 after the launch, so the next launch's amax does not see
    this one's."""
    from p2p_tpu_torch.ops.cuda.norm_act import (_arrival_counter,
                                                 norm_act_quant,
                                                 norm_act_quant_plain)

    clean = _x((1, 128, 65, 65), dtype, cuda, 28)
    mean, rstd, _, _, sx = _quant_args(clean, 29, False, False)
    if kind == "negzero":       # yc = −0 where x = −0: mean 0, rstd 1
        mean, rstd = torch.zeros_like(mean), torch.ones_like(rstd)
    x = _special(clean, kind)
    q, amax = norm_act_quant(x, mean, rstd, sx=sx, act="leaky")
    pq, pamax = norm_act_quant_plain(x, mean, rstd, sx=sx, act="leaky")
    torch.testing.assert_close(q, pq, atol=0, rtol=0, equal_nan=True)
    if kind == "nan":
        assert torch.isnan(amax) and torch.isnan(pamax)
    else:
        assert torch.equal(amax, pamax)
        assert (kind == "inf") == bool(torch.isinf(amax))
    sync = _arrival_counter(x.device, torch.cuda.current_stream(
        cuda).cuda_stream)
    assert sync.tolist() == [0, 0]
    _, after = norm_act_quant(clean, mean, rstd, sx=sx, act="leaky")
    assert torch.equal(after, norm_act_quant_plain(clean, mean, rstd, sx=sx,
                                                   act="leaky")[1])
    assert bool(torch.isfinite(after))


def test_norm_act_quant_raises_on_what_it_does_not_take(cuda):
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act_quant

    x = _x((1, 8, 4, 4), torch.float32, cuda, 24)
    mean, rstd, _, _, sx = _quant_args(x, 25, False, False)
    with pytest.raises(ValueError, match="channels_last"):
        norm_act_quant(x.contiguous(), mean, rstd, sx=sx)
    with pytest.raises(ValueError, match="sx"):
        norm_act_quant(x, mean, rstd, sx=sx.cpu())
    with pytest.raises(ValueError, match="sx"):
        norm_act_quant(x, mean, rstd, sx=sx.reshape(1))


def _int8(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, device=device,
                         dtype=torch.int8)


# (x NHWC, w (kh, kw, I, O), strides, padding): the facades_int8 D's three
# inner convs at 256², and the dgrad of the stride-1 one
INT8_FORMS = [
    ("forward 1", (1, 129, 129, 64), (4, 4, 64, 128), (2, 2), 2),
    ("forward 2", (1, 65, 65, 128), (4, 4, 128, 256), (2, 2), 2),
    ("forward 3", (1, 33, 33, 256), (4, 4, 256, 512), (1, 1), 2),
    ("dgrad 3", (1, 34, 34, 512), (4, 4, 512, 256), (1, 1), 1),
]


@pytest.mark.parametrize("what,xs,ws,strides,pad", INT8_FORMS)
def test_int8_conv_forms_are_exact_on_the_card(cuda, what, xs, ws, strides,
                                               pad):
    import torch.nn.functional as F

    from p2p_tpu_torch.ops.int8 import conv_i32

    x8, w8 = _int8(xs, 30, cuda), _int8(ws, 31, cuda)
    got = conv_i32(x8, w8, strides, (pad, pad))
    want = F.conv2d(x8.double().permute(0, 3, 1, 2),
                    w8.double().permute(3, 2, 0, 1), stride=strides,
                    padding=pad).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), want), what


@pytest.mark.parametrize("xs,o,strides", [((1, 65, 65, 128), 256, (2, 2)),
                                          ((1, 33, 33, 256), 512, (1, 1))])
def test_int8_wgrad_is_exact_on_the_card(cuda, xs, o, strides):
    """The int8 wgrad of inner convs 2 and 3: K = N·Ho·Wo = 1089, 1156."""
    from p2p_tpu_torch.ops.int8 import im2col, int_mm

    x8 = _int8(xs, 32, cuda)
    rows, (ho, wo) = im2col(x8, (4, 4), strides, (2, 2))
    g8 = _int8((ho * wo, o), 33, cuda)
    got = int_mm(rows.t(), g8)
    assert torch.equal(got.double(), rows.t().double() @ g8.double())


def _cpu_and_card(fn, *tensors):
    out = []
    for dev in ("cpu", "cuda"):
        ins = [t.detach().to(dev).requires_grad_(t.requires_grad)
               if t.is_floating_point() else t.to(dev) for t in tensors]
        if ins[0].dim() == 4:
            ins[0] = ins[0].contiguous(memory_format=torch.channels_last
                                       ).detach().requires_grad_()
        y = fn(*ins)
        ys = y if isinstance(y, tuple) else (y,)
        g = torch.Generator().manual_seed(40)
        up = torch.randn(ys[0].shape, generator=g).to(dev)
        grads = torch.autograd.grad((ys[0].float() * up).sum(),
                                    [t for t in ins if t.requires_grad])
        out.append(([t.detach().cpu() for t in ys],
                    [t.cpu() for t in grads]))
    return out


@pytest.mark.parametrize("strides", [(2, 2), (1, 1)])
def test_int8_conv_ds_on_the_card_is_the_cpu_function(no_tf32, strides):
    """Forward and the int8 gradient forms bitwise; the bf16 forms (stride
    2's dgrad) within f32 sums of bf16 products in another order."""
    from p2p_tpu_torch.ops.int8 import int8_conv_ds

    g = torch.Generator().manual_seed(41)
    x = torch.randn((1, 64, 33, 33), generator=g).requires_grad_()
    w = (torch.randn((128, 64, 4, 4), generator=g) * 0.05).requires_grad_()
    sx = torch.tensor(3.0 / 127.0)
    (ycpu, gcpu), (ycard, gcard) = _cpu_and_card(
        lambda a, b, s: int8_conv_ds(a, b, s, strides, 2), x, w, sx)
    assert torch.equal(ycpu[0], ycard[0]) and torch.equal(ycpu[1], ycard[1])
    assert torch.equal(gcpu[1], gcard[1])          # wgrad: 17² ≤ 4096 int8
    if strides == (1, 1):
        assert torch.equal(gcpu[0], gcard[0])
    else:
        torch.testing.assert_close(gcard[0], gcpu[0], atol=1e-5, rtol=1e-5)


def test_instance_norm_act_quant_on_the_card_is_the_cpu_function(no_tf32):
    """#1 + #4 forward against the CPU's plain route (q within one step
    where the statistics' last bits move yc/sx across a tie, amax within
    1e-6), the straight-through backward within f32 rounding."""
    from p2p_tpu_torch.ops.instance_norm import instance_norm_act_quant

    x = _x((1, 128, 65, 65), torch.float32, torch.device("cpu"), 42)
    sx = torch.tensor(2.0 / 127.0)
    (qc, gc), (qg, gg) = _cpu_and_card(
        lambda a, s: instance_norm_act_quant(a, s, act="leaky"),
        x.requires_grad_(), sx)
    dq = (qc[0] - qg[0]).abs()
    assert float(dq.max()) <= 1 and float((dq > 0).float().mean()) < 1e-3
    torch.testing.assert_close(qg[1], qc[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(gg[0], gc[0], atol=1e-4, rtol=1e-4)


# the main path's sites of #2 (path A's ExpandNetwork) and #4 (the
# facades_int8 D): (kernel, (N, C, H, W))
SITES = [("apply", (1, 32, 256, 256)), ("apply", (1, 64, 128, 128)),
         ("apply", (1, 128, 64, 64)), ("apply", (1, 3, 256, 256)),
         ("quant", (1, 128, 65, 65)), ("quant", (1, 256, 33, 33))]


def _site_args(kernel, x, rep):
    """Keyword arguments of rep ``rep`` of a site: odd reps with an affine,
    #4 with its scale and the facades D's leaky activation."""
    c = x.shape[1]
    g = torch.Generator(device=x.device).manual_seed(40 + rep % 2)
    kw = {}
    if rep % 2:
        kw = {"scale": torch.randn(c, generator=g, device=x.device) * 0.1 + 1,
              "bias": torch.randn(c, generator=g, device=x.device) * 0.1}
    if kernel == "quant":
        kw.update(sx=torch.tensor(2.5 / 127.0, device=x.device), act="leaky")
    return kw


def _site(kernel, x, kw):
    """#1, then #2 or #4 as ops/instance_norm.py launches them (x read
    before the wait): (mean, rstd, outputs)."""
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act_quant

    mean, rstd = instance_norm_stats(x)
    if kernel == "apply":
        return mean, rstd, (instance_norm_apply(x, mean, rstd, x_ready=True,
                                                **kw),)
    return mean, rstd, norm_act_quant(x, mean, rstd, x_ready=True, **kw)


def _plain_site(kernel, x, mean, rstd, kw):
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act_quant_plain

    if kernel == "apply":
        return (instance_norm_apply_plain(x, mean, rstd, **kw),)
    return norm_act_quant_plain(x, mean, rstd, **kw)


def _assert_site_runs(kernel, sources, runs):
    """Each run (rep, mean, rstd, outputs) bitwise the plain version on the
    kernel's own statistics of the x it was given (``sources[rep % 2]``),
    and those statistics those of #1 on that x."""
    for rep, mean, rstd, outs in runs:
        x = sources[rep % 2]
        want_mean, want_rstd = instance_norm_stats(x)
        assert torch.equal(mean, want_mean) and torch.equal(rstd, want_rstd)
        want = _plain_site(kernel, x, mean, rstd, _site_args(kernel, x, rep))
        for got, w in zip(outs, want):
            assert torch.equal(got, w), (rep, kernel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("writer", ["none", "torch"])
@pytest.mark.parametrize("kernel,shape", SITES)
def test_apply_and_quant_after_stats_are_bitwise_over_50_launches(
        cuda, dtype, writer, kernel, shape):
    """#2 and #4 launched right after #1's finalize, reading x before the
    wait, 50 times back to back: bitwise their plain versions on the same
    statistics every time. With writer "torch" a PyTorch kernel writes x
    immediately before each #1, alternating between two inputs, so a read
    of x before it was complete shows as a mismatch."""
    sources = (_x(shape, dtype, cuda, 30), _x(shape, dtype, cuda, 31))
    x = sources[0].clone(memory_format=torch.channels_last)
    runs = []
    for rep in range(50):
        if writer == "torch":
            x.copy_(sources[rep % 2])
        kw = _site_args(kernel, x, rep)
        runs.append((rep, *_site(kernel, x, kw)))
    if writer == "none":
        sources = (x, x)
    _assert_site_runs(kernel, sources, runs)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,shape", SITES)
def test_apply_and_quant_after_stats_replay_in_a_cuda_graph(cuda, dtype,
                                                            kernel, shape):
    """The same site captured in a CUDA graph (the dependent launch becomes
    a programmatic edge) and replayed 10 times, x rewritten between
    replays: bitwise the plain version each time."""
    sources = (_x(shape, dtype, cuda, 32), _x(shape, dtype, cuda, 33))
    x = sources[0].clone(memory_format=torch.channels_last)
    kw = _site_args(kernel, x, 1)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        _site(kernel, x, kw)            # loads the library, makes #4's pair
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        mean, rstd, outs = _site(kernel, x, kw)
    runs = []
    for rep in range(10):
        x.copy_(sources[rep % 2])
        graph.replay()
        runs.append((rep, mean.clone(), rstd.clone(),
                     tuple(o.clone() for o in outs)))
    torch.cuda.synchronize()
    for rep, m, r, o in runs:
        x = sources[rep % 2]
        assert torch.equal(m, instance_norm_stats(x)[0])
        for got, w in zip(o, _plain_site(kernel, x, m, r, kw)):
            assert torch.equal(got, w), rep


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 3, 256, 256), (2, 3, 4, 4),
                                   (3, 3, 16, 17), (1, 3, 5, 7)])
def test_apply_at_c3_takes_the_vector_path_where_it_can(cuda, dtype, shape):
    """#2 at C = 3 reads 16-byte vectors across pixels where H·W·3 divides
    into them (N > 1: one sample a vector), one element at a time where it
    does not (5·7·3 = 105), and is bitwise its plain version either way,
    with and without the affine."""
    from p2p_tpu_torch.ops.cuda.norm_act import plan_for

    x = _x(shape, dtype, cuda, 34)
    n, c, h, w = shape
    vec = 16 // x.element_size()
    want = "flat3" if (h * w * c) % vec == 0 else "element"
    assert plan_for(x, torch.empty_like(x)).path == want
    mean, rstd = instance_norm_stats_plain(x)
    g = torch.Generator(device=cuda).manual_seed(35)
    scale = torch.randn(c, generator=g, device=cuda) * 0.1 + 1
    bias = torch.randn(c, generator=g, device=cuda) * 0.1
    for kw in ({}, {"scale": scale, "bias": bias}):
        for x_ready in (False, True):
            y = instance_norm_apply(x, mean, rstd, x_ready=x_ready, **kw)
            assert torch.equal(y, instance_norm_apply_plain(x, mean, rstd,
                                                            **kw))
    torch.cuda.synchronize()


# #3's sites on the main paths: (form, (N, C, H, W)): path A's residual
# block, pix2pixHD G1's residual block at N = 4, the D's leaky epilogue,
# pix2pixHD's 1/2-resolution relu (K = 4 in one wave) and its local
# residual block at N = 2 (more than one wave)
NORM_ACT_SITES = [("relu+residual", (1, 128, 64, 64)),
                  ("none+residual", (4, 1024, 16, 32)),
                  ("leaky", (1, 256, 33, 33)), ("relu", (1, 64, 256, 512)),
                  ("none+residual", (2, 64, 256, 512))]


def _norm_act_args(form, x, r, rep):
    """Keyword arguments of #3 in ``form`` (r the residual where it has
    one), odd reps with an affine."""
    act, _, res = form.partition("+")
    kw = {"act": act, "residual": r if res else None}
    if rep % 2:
        c = x.shape[1]
        g = torch.Generator(device=x.device).manual_seed(41)
        kw.update(scale=torch.randn(c, generator=g, device=x.device) * 0.1
                  + 1, bias=torch.randn(c, generator=g, device=x.device)
                  * 0.1)
    return kw


def _norm_act_site(x, kw):
    """#1, then #3 as ops/instance_norm.py launches them (x and the
    residual read before the wait): (mean, rstd, y, kwargs)."""
    mean, rstd = instance_norm_stats(x)
    return mean, rstd, norm_act(x, mean, rstd, x_ready=True, **kw), kw


def _assert_norm_act_runs(xs, rs, runs):
    """Each run (i, mean, rstd, y, kwargs) bitwise the plain version on its
    own statistics of the x and r it was given (``xs[i]``, ``rs[i]``), and
    those statistics #1's on that x."""
    for i, mean, rstd, y, kw in runs:
        want_mean, want_rstd = instance_norm_stats(xs[i])
        assert torch.equal(mean, want_mean) and torch.equal(rstd, want_rstd)
        if kw["residual"] is not None:
            kw = dict(kw, residual=rs[i])
        assert torch.equal(y, norm_act_plain(xs[i], mean, rstd, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("writer", ["none", "torch"])
@pytest.mark.parametrize("form,shape", NORM_ACT_SITES)
def test_norm_act_after_stats_is_bitwise_over_50_launches(cuda, dtype,
                                                          writer, form,
                                                          shape):
    """#3 launched right after #1's finalize, reading x and the residual
    before the wait, 50 times back to back: bitwise its plain version on
    the same statistics every time. With writer "torch" PyTorch kernels
    write the residual and x immediately before each #1, alternating
    between two inputs each, so a read of either before it was complete
    shows as a mismatch."""
    xs = (_x(shape, dtype, cuda, 50), _x(shape, dtype, cuda, 51))
    rs = (_x(shape, dtype, cuda, 52), _x(shape, dtype, cuda, 53))
    x = xs[0].clone(memory_format=torch.channels_last)
    r = rs[0].clone(memory_format=torch.channels_last)
    runs = []
    for rep in range(50):
        if writer == "torch":
            r.copy_(rs[rep % 2])
            x.copy_(xs[rep % 2])
        runs.append((rep % 2,
                     *_norm_act_site(x, _norm_act_args(form, x, r, rep))))
    if writer == "none":
        xs, rs = (x, x), (r, r)
    _assert_norm_act_runs(xs, rs, runs)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form,shape", NORM_ACT_SITES)
def test_norm_act_after_stats_replays_in_a_cuda_graph(cuda, dtype, form,
                                                      shape):
    """#1 then #3 captured in a CUDA graph (both dependent launches become
    programmatic edges) and replayed 10 times, x and the residual rewritten
    between replays: bitwise the plain version each time."""
    xs = (_x(shape, dtype, cuda, 54), _x(shape, dtype, cuda, 55))
    rs = (_x(shape, dtype, cuda, 56), _x(shape, dtype, cuda, 57))
    x = xs[0].clone(memory_format=torch.channels_last)
    r = rs[0].clone(memory_format=torch.channels_last)
    kw = _norm_act_args(form, x, r, 1)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        _norm_act_site(x, kw)               # loads the library
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        mean, rstd, y, _ = _norm_act_site(x, kw)
    runs = []
    for rep in range(10):
        r.copy_(rs[rep % 2])
        x.copy_(xs[rep % 2])
        graph.replay()
        runs.append((rep % 2, mean.clone(), rstd.clone(), y.clone(), kw))
    torch.cuda.synchronize()
    _assert_norm_act_runs(xs, rs, runs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32, 512, 1024), (4, 1024, 16, 32),
                                   (1, 128, 64, 64), (1, 3, 256, 256)])
def test_stats_gives_the_same_bits_over_50_launches(cuda, dtype, shape):
    """#1 with its finalize a programmatic dependent of its pass 1, run 50
    times back to back on two alternating inputs (a PyTorch kernel writes x
    right before each): the same bits for the same input every time, and
    within the stats tolerance of the plain version."""
    sources = (_x(shape, dtype, cuda, 60), _x(shape, dtype, cuda, 61))
    x = sources[0].clone(memory_format=torch.channels_last)
    runs = []
    for rep in range(50):
        x.copy_(sources[rep % 2])
        runs.append(instance_norm_stats(x))
    torch.cuda.synchronize()
    for rep, (mean, rstd) in enumerate(runs):
        assert torch.equal(mean, runs[rep % 2][0]), rep
        assert torch.equal(rstd, runs[rep % 2][1]), rep
    for i in (0, 1):
        pmean, prstd = instance_norm_stats_plain(sources[i])
        torch.testing.assert_close(runs[i][0], pmean, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(runs[i][1], prstd, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("size", [32, 256])
def test_ssim_on_the_card_is_exact_for_equal_images_and_matches_float64(
        cuda, size):
    from p2p_tpu_torch.data.synthetic import synthetic_batch
    from p2p_tpu_torch.losses.metrics import ssim, to_uint8_space

    b = synthetic_batch(3, size, seed=size)
    t = torch.from_numpy(b["target"]).to(cuda)
    p = torch.from_numpy(b["input"]).to(cuda)
    noisy = torch.clamp(t + 0.05 * torch.randn(
        t.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1)),
        -1, 1)
    assert bool((ssim(t, t, per_image=True) == 1.0).all())
    assert float(ssim(t, t)) == 1.0
    ssim_f64 = _smoke().ssim_f64
    for pred in (p, noisy):
        got = ssim(t, pred, per_image=True).cpu().numpy()
        want = ssim_f64(to_uint8_space(t).cpu().numpy(),
                        to_uint8_space(pred).cpu().numpy())
        assert np.abs(got - want).max() <= 1e-5, (got, want)


def test_quantize_epilogue_behind_a_spectral_conv_on_the_card(no_tf32):
    """#1 + #4 as path A int8's D launches them: the fused input epilogue
    of a spectral-norm int8 conv (65² × 128 → 256, k4 s2), one #4 launch a
    forward; against the same module on the CPU (the plain versions) the
    stored amax and ``u`` within 1e-6, q (the tap over sx) within one step
    on under 1e-3 of its elements (the statistics' last bits move yc/sx
    across a tie), the conv's output within the quanta those flips move."""
    import copy

    from p2p_tpu_torch.ops.cuda.norm_act import norm_act_quant
    from p2p_tpu_torch.ops.int8 import scale_of
    from p2p_tpu_torch.ops.norm import make_norm_act
    from p2p_tpu_torch.ops.spectral_norm import (SpectralConv,
                                                 spectral_normalize)

    na = make_norm_act("pallas_instance")
    conv = SpectralConv(128, 256, 4, stride=2, padding=2, int8=True,
                        int8_delayed=True, epilogue=lambda y, sx: na(
                            y, act="leaky", slope=0.2, quant_scale=sx),
                        epilogue_tap=True)
    g = torch.Generator().manual_seed(43)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.02, generator=g)
        conv.amax_x.fill_(3.0)
    x = torch.randn((1, 128, 65, 65), generator=g)
    sx = scale_of(torch.tensor(3.0))
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(conv).to(dev).train()
        before = norm_act_quant.launches
        y, tap = m(x.to(dev).contiguous(memory_format=torch.channels_last))
        out[dev] = (y.detach().cpu(), torch.round(tap.detach().cpu() / sx),
                    m.amax_x.cpu(), m.u.cpu(),
                    norm_act_quant.launches - before)
    (yc, qc, ac, uc, nc), (yg, qg, ag, ug, ng) = out["cpu"], out["cuda"]
    assert (nc, ng) == (0, 1)
    dq = (qc - qg).abs()
    assert float(dq.max()) <= 1 and float((dq > 0).float().mean()) < 1e-3
    torch.testing.assert_close(ag, ac, rtol=1e-6, atol=0)
    torch.testing.assert_close(ug, uc, rtol=0, atol=1e-6)
    # each flip moves an output by at most sx·max|w/σ| (plus the
    # dequantization's own rounding)
    w = conv.weight
    sigma = spectral_normalize(w.permute(0, 2, 3, 1).reshape(w.shape[0], -1),
                               conv.u)[0]
    bound = (int((dq > 0).sum()) + 1) * float(sx) * float(
        (w / sigma).detach().abs().max())
    assert float((yg - yc).abs().max()) <= bound


def test_batch_moments_under_the_int8_net_c_of_a_unet_preset(no_tf32):
    """#5 at net_c's BatchNorm in ``facades_int8_full`` (int8 convs, 256²:
    M = 65,536, C = 64): one launch a training forward, and the running
    statistics it leaves within f32 rounding of the plain version's."""
    from unittest import mock

    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.models.registry import define_C, init_weights
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.ops.cuda.batch_moments import (batch_moments,
                                                      batch_moments_plain)

    net = define_C(get_preset("facades_int8_full").model)
    init_weights(net, torch.Generator().manual_seed(44))
    net = net.to(no_tf32, memory_format=torch.channels_last).train()
    x = _x((1, 3, 256, 256), torch.float32, no_tf32, 44).clamp(-1, 1)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    before = batch_moments.launches
    with torch.no_grad():
        net(x)
    assert batch_moments.launches - before == 1
    got = {k: v.clone() for k, v in net.state_dict().items()}
    net.load_state_dict(state)
    with torch.no_grad(), mock.patch.object(norm, "batch_moments",
                                            batch_moments_plain):
        net(x)
    want = net.state_dict()
    for k in ("BatchNorm_0.mean", "BatchNorm_0.var"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_nan_sentinel_queues_without_a_host_sync_and_reads_late(cuda):
    """The trainer's NaN sentinel (obs/taps.py) and its health staging
    (train/loop.stage_metrics) on the card: queueing the per-leaf counts
    (device sums, a ``non_blocking`` copy to a pinned buffer, an event)
    and staging the step's metrics make no host sync: under
    ``torch.cuda.set_sync_debug_mode("error")`` any sync raises, which
    ``.item()`` in the same region shows. The counts are read after, one
    call later, and are right."""
    from p2p_tpu_torch.obs import taps
    from p2p_tpu_torch.train.loop import stage_metrics

    taps.read_sentinels()
    got = []
    taps.add_sentinel_handler(got.append)
    x = torch.randn(1 << 22, device=cuda)
    grad = torch.ones(1000, device=cuda)
    grad[3] = float("inf")
    grad[7:10] = float("nan")
    metrics = {"loss_g": (x * float("nan")).mean(), "loss_d": (x * x).mean(),
               "grad": grad, "steps": torch.arange(3, device=cuda)}
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            taps.nan_sentinel({**metrics, "lr_scale": 0.5},
                              tag="train_step")
            staged = stage_metrics({k: metrics[k]
                                    for k in ("loss_g", "loss_d")})
            y = (x * 3).sum()                # the next step's work
            with pytest.raises(RuntimeError):
                y.item()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert got == []
        taps.read_sentinels()
    finally:
        taps.remove_sentinel_handler(got.append)
    assert [(e["nan"], e["inf"], e["leaves"]) for e in got] == [
        (4, 1, {"loss_g": {"nan": 1, "inf": 0},
                "grad": {"nan": 3, "inf": 1}})]
    keys, buf, event = staged
    event.synchronize()
    assert keys == ["loss_g", "loss_d"] and buf.is_pinned()
    vals = buf.tolist()
    assert np.isnan(vals[0]) and vals[1] == pytest.approx(
        float((x * x).mean()), rel=1e-6)


def test_memory_watchdog_reads_the_card(cuda):
    """``MemoryWatchdog`` on the card: the JAX record's four keys from
    ``torch.cuda.memory_stats`` and ``mem_get_info``, a live 256 MiB
    allocation inside them, the gauges and the ``memory`` record."""
    from p2p_tpu_torch.obs import MemoryWatchdog, MetricsRegistry

    big = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    reg = MetricsRegistry()
    logged = []

    class _Log:
        def log(self, rec, force=False):
            logged.append(rec)

    out = MemoryWatchdog(reg, [cuda]).sample(_Log())
    (stats,) = out.values()
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use",
                          "bytes_limit", "largest_alloc_size"}
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"] \
        >= big.numel()
    assert stats["largest_alloc_size"] >= big.numel()
    assert stats["bytes_limit"] > stats["bytes_in_use"]
    assert logged == [{"kind": "memory", "n_devices": 1, **stats}]
    idx = torch.cuda.current_device()
    assert reg.gauge("hbm_bytes_in_use", device=idx).value == \
        stats["bytes_in_use"]


def test_temporal_d_on_the_card_matches_f64(no_tf32):
    import copy

    from p2p_tpu_torch.models import temporal_d
    from p2p_tpu_torch.models.registry import init_weights

    d = temporal_d.MultiscaleTemporalDiscriminator(6, 64, 3, 2)
    init_weights(d, torch.Generator().manual_seed(5))
    x = torch.rand((1, 8, 32, 32, 6), generator=torch.Generator(
        ).manual_seed(6)).permute(0, 4, 1, 2, 3) * 2 - 1
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dev, dtype, thin in (("cuda", torch.float32, 8),
                                 ("cpu", torch.float64, 0)):
            m = copy.deepcopy(d).to(dev, dtype,
                                    memory_format=torch.channels_last_3d)
            xx = x.to(dev, dtype).detach().requires_grad_(True)
            with pytest.MonkeyPatch.context() as mp:
                # the reference's stem is one f64 conv3d
                mp.setattr(temporal_d, "THIN_STEM_CHANNELS", thin)
                feats = [f for scale in m.train()(xx) for f in scale]
            sum((f * f).mean() for f in feats).backward()
            out[dev] = ([f.detach() for f in feats] + [xx.grad]
                        + [p.grad for p in m.parameters()],
                        [b for b in m.buffers()])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    (got, got_u), (want, want_u) = out["cuda"], out["cpu"]
    assert len(got) == len(want) == 10 + 1 + 20
    for g, w in zip(got, want):
        err = float((g.cpu().double() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (tuple(w.shape), err)
    assert len(got_u) == 6
    for g, w in zip(got_u, want_u):
        assert float((g.cpu().double() - w).abs().max()) <= 1e-5


def test_clip_and_fake_frames_are_views_on_the_card(cuda):
    from p2p_tpu_torch.models.temporal_d import fold_frames, unfold_frames
    from p2p_tpu_torch.models.unet import UNetGenerator
    from p2p_tpu_torch.train.video_step import to_device_clip

    host = np.random.default_rng(0).integers(0, 256, (2, 8, 32, 32, 3),
                                             dtype=np.uint8)
    clip = to_device_clip(host, cuda, torch.bfloat16)
    assert clip.is_contiguous(memory_format=torch.channels_last_3d)
    frames = fold_frames(clip)
    assert frames.data_ptr() == clip.data_ptr()
    assert frames.is_contiguous(memory_format=torch.channels_last)
    g = UNetGenerator(in_channels=3, ngf=8, out_channels=3,
                      image_hw=(32, 32), norm="instance",
                      dtype=torch.bfloat16).to(
        cuda, memory_format=torch.channels_last)
    fake = g(frames)
    fake_clip = unfold_frames(fake, 2)
    assert fake_clip.data_ptr() == fake.data_ptr()
    assert fake_clip.is_contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("shape", [(8, 16, 33, 33), (8, 6, 256, 256)])
def test_avg_pool_downsample_and_its_gradient_on_the_card(cuda, shape):
    from p2p_tpu_torch.models.patchgan import avg_pool_downsample

    g = torch.Generator().manual_seed(2)
    x = torch.randn(shape, generator=g)
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        z = x.to(dev, dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        y = avg_pool_downsample(z)
        assert y.is_contiguous(memory_format=torch.channels_last)
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(
            3)).to(dev, dtype)
        (y * cot).sum().backward()
        out[dev] = (y.detach(), z.grad)
    for got, want in zip(out["cuda"], out["cpu"]):
        err = float((got.cpu().double() - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("shape,pad", [((1, 3, 256, 256), 4),
                                       ((1, 128, 64, 64), 1)])
def test_reflect_pad_backward_repeats_its_bits_on_the_card(cuda, shape,
                                                           pad):
    import torch.nn.functional as F

    from p2p_tpu_torch.ops.conv import reflect_pad_2d

    g = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=g)
    x_gpu = x.to("cuda").contiguous(memory_format=torch.channels_last)
    cot = torch.randn([shape[0], shape[1], shape[2] + 2 * pad,
                       shape[3] + 2 * pad], generator=g)
    cot_gpu = cot.to("cuda")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        grads = []
        for _ in range(20):
            z = x_gpu.detach().requires_grad_(True)
            y = reflect_pad_2d(z, pad)
            assert y.grad_fn.name() == "_FixedOrderReflectPadBackward"
            (y * cot_gpu).sum().backward()
            grads.append(z.grad)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert all(torch.equal(gr, grads[0]) for gr in grads[1:])
    z = x.double().requires_grad_(True)
    (F.pad(z, (pad,) * 4, mode="reflect") * cot.double()).sum().backward()
    err = float((grads[0].cpu().double() - z.grad).abs().max())
    assert err <= 1e-6 * float(z.grad.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (1, 64, 257, 64),
                                   (1, 1024, 8, 64), (2, 32, 13, 40)])
def test_sharded_stats_entries_match_plain_versions(cuda, dtype, shape):
    """#1's sums entry against its plain version (the fixed-order sums of
    pass 1: the same bits as #1's own finalize reads), and the finalize
    fed those sums and the count against #1 on the whole tensor: the
    sharded route with one rank is #1, bitwise."""
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_finalize, instance_norm_finalize_plain,
        instance_norm_sums, instance_norm_sums_plain)

    x = _x(shape, dtype, cuda, 5)
    n0 = (instance_norm_sums.launches, instance_norm_finalize.launches)
    s1, s2 = instance_norm_sums(x)
    p1, p2 = instance_norm_sums_plain(x)
    torch.testing.assert_close(s1, p1, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(s2, p2, atol=1e-3, rtol=1e-5)
    count = float(shape[2] * shape[3])
    mean, rstd = instance_norm_finalize(s1, s2, count)
    want = instance_norm_stats(x)
    assert torch.equal(mean, want[0]) and torch.equal(rstd, want[1])
    pm, pr = instance_norm_finalize_plain(s1, s2, count)
    torch.testing.assert_close(mean, pm, atol=0, rtol=2e-7)
    torch.testing.assert_close(rstd, pr, atol=0, rtol=2e-7)
    assert (instance_norm_sums.launches - n0[0],
            instance_norm_finalize.launches - n0[1]) == (1, 1)
    again = instance_norm_sums(x)
    assert torch.equal(again[0], s1) and torch.equal(again[1], s2)


def test_sharded_stats_entries_raise_on_what_they_do_not_take(cuda):
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_finalize, instance_norm_sums)

    with pytest.raises(ValueError):
        instance_norm_sums(torch.randn(2, 8, 4, 4, device=cuda))  # NCHW
    s = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError):
        instance_norm_finalize(s.double(), s, 16.0)
    with pytest.raises(ValueError):
        instance_norm_finalize(s, s.t().contiguous().t(), 16.0)


@pytest.mark.parametrize("pad", [1, 3])
def test_reflect_pad_w_backward_repeats_its_bits_on_the_card(cuda, pad):
    """The W half of a spatial reflect pad: fixed-order backward under
    cuDNN deterministic, against f64 on the CPU."""
    import torch.nn.functional as F

    from p2p_tpu_torch.ops.conv import reflect_pad_w

    g = torch.Generator().manual_seed(6)
    x = torch.randn((1, 64, 40, 96), generator=g)
    cot = torch.randn((1, 64, 40, 96 + 2 * pad), generator=g)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        grads = []
        for _ in range(5):
            z = x.to(cuda).contiguous(
                memory_format=torch.channels_last).requires_grad_(True)
            y = reflect_pad_w(z, pad)
            assert y.grad_fn.name() == "_FixedOrderReflectPadWBackward"
            (y * cot.to(cuda)).sum().backward()
            grads.append(z.grad)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert all(torch.equal(gr, grads[0]) for gr in grads[1:])
    z = x.double().requires_grad_(True)
    (F.pad(z, (pad, pad, 0, 0), mode="reflect") * cot.double()).sum(
        ).backward()
    err = float((grads[0].cpu().double() - z.grad).abs().max())
    assert err <= 1e-6 * float(z.grad.abs().max())
