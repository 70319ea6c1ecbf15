"""The launch plan of kernels #2 (instance-norm apply), #3 (the fused
norm-act epilogue) and #4 (the quantize-fused epilogue), and the property
#4's amax tail relies on, on the CPU with no JAX and no card.

``apply_plan`` (``p2p_tpu_torch/ops/cuda/norm_act.py``) sizes the three
dependent launches: at every shape of #2 and #4 on the main path it must
fit one wave of an H100 (every block resident, so every load of x is issued
before the grid-dependency wait), and so must #3 wherever its vectors fit
one wave of threads taking one each; beyond that #3 still takes one a
thread and its later blocks run after the first wave. Thread t of block b
must
take the vectors (b·K + k)·256 + t, k < K, so that every vector is covered
exactly once, at every #3 shape of the main paths up to 4×512×1024×32;
#2 at C = 3 must read 16-byte vectors across pixels exactly where H·W·C
divides into them and x and y are aligned, and #3 must read 16-byte
vectors only where its residual is aligned too. #4 folds every block's max|yc|
into one 32-bit word with ``atomicMax`` on the float's bits: for floats
that are non-negative or NaN with the sign cleared, the max of the bits is
the max of the floats, a NaN above +inf; checked here in numpy on random f32
with NaN, ±inf, −0 and subnormals. Exact comparisons throughout.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2p_tpu_torch.ops.cuda.norm_act import (  # noqa: E402
    APPLY_PATHS, NORM_ACT_MAX_PER_THREAD, PER_THREAD, RESIDENT_THREADS, SMS,
    THREADS, apply_plan, plan_for)

WAVE_BLOCKS = SMS * RESIDENT_THREADS // THREADS
ELEMENT_SIZES = {"f32": 4, "bf16": 2}
# (kernel, H, W, C) of #2 on path A's ExpandNetwork (reference at 256²) and
# of #4 on the facades_int8 D, as chip_smoke.py plans them
PATH_SITES = [("apply", 256, 256, 32), ("apply", 128, 128, 64),
              ("apply", 64, 64, 128), ("apply", 256, 256, 3),
              ("quant", 65, 65, 128), ("quant", 33, 33, 256)]
# (N, H, W, C, form) of #3 on the main paths (pix2pixHD serving at N = 1,
# 2, 4, path A, path B and the facades_int8 D), as chip_smoke.py counts
# them
NORM_ACT_SITES = [
    (1, 9, 9, 256, "leaky"), (1, 10, 10, 512, "leaky"),
    (1, 16, 32, 1024, "none+residual"), (1, 16, 32, 1024, "relu"),
    (1, 17, 17, 128, "leaky"), (1, 17, 17, 256, "leaky"),
    (1, 18, 18, 512, "leaky"), (1, 32, 64, 512, "relu"),
    (1, 33, 33, 128, "leaky"), (1, 33, 33, 256, "leaky"),
    (1, 34, 34, 512, "leaky"), (1, 64, 64, 128, "relu"),
    (1, 64, 64, 128, "relu+residual"), (1, 64, 128, 256, "relu"),
    (1, 65, 65, 128, "leaky"), (1, 128, 256, 128, "relu"),
    (1, 256, 512, 64, "none+residual"), (1, 256, 512, 64, "relu"),
    (1, 512, 1024, 32, "relu"),
    (2, 16, 32, 1024, "none+residual"), (2, 16, 32, 1024, "relu"),
    (2, 32, 64, 512, "relu"), (2, 64, 128, 256, "relu"),
    (2, 128, 256, 128, "relu"), (2, 256, 512, 64, "none+residual"),
    (2, 256, 512, 64, "relu"), (2, 512, 1024, 32, "relu"),
    (4, 16, 32, 1024, "none+residual"), (4, 16, 32, 1024, "relu"),
    (4, 32, 64, 512, "relu"), (4, 64, 128, 256, "relu"),
    (4, 128, 256, 128, "relu"), (4, 256, 512, 64, "none+residual"),
    (4, 256, 512, 64, "relu"), (4, 512, 1024, 32, "relu")]


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_plans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_path_sites_are_the_main_paths():
    smoke = _smoke()
    a_plan = smoke.path_a_step_plan(smoke.instance_config())
    i8_plan = smoke.int8_d_plan(smoke.int8_config())
    sites = {("apply", h, w, c) for h, w, c, form in a_plan
             if form == "apply"}
    sites |= {("quant", h, w, c) for h, w, c, form in i8_plan
              if form.endswith("+quant")}
    assert sites == set(PATH_SITES)


def test_norm_act_sites_are_the_main_paths():
    from p2p_tpu_torch.core.config import get_preset

    smoke = _smoke()
    cfg = get_preset("pix2pixhd")
    plan = smoke.epilogue_plan(cfg.model.ngf, cfg.model.n_blocks, 3,
                               *cfg.image_hw)
    a_plan = smoke.path_a_step_plan(smoke.instance_config())
    sites = {key for key in smoke.instance_launches(plan, a_plan, 1, 1)
             if key[4] != "apply"}
    sites |= {(1, h, w, c, form) for h, w, c, form
              in smoke.int8_d_plan(smoke.int8_config())
              if not form.endswith("+quant")}
    assert sorted(sites) == NORM_ACT_SITES


def _plan(kernel, n, h, w, c, dtype, aligned=True):
    return apply_plan(n * h * w * c, h * w * c, c, ELEMENT_SIZES[dtype],
                      aligned, flat3=kernel == "apply",
                      max_per_thread=NORM_ACT_MAX_PER_THREAD
                      if kernel == "norm_act" else max(PER_THREAD))


def _covered(plan, numel):
    """How often each vector index is taken by the kernel's mapping."""
    vecs = numel // plan.vec
    b = np.arange(plan.blocks, dtype=np.int32)[:, None, None]
    k = np.arange(plan.per_thread, dtype=np.int32)[None, :, None]
    t = np.arange(THREADS, dtype=np.int32)[None, None, :]
    v = ((b * plan.per_thread + k) * THREADS + t).ravel()
    return vecs, np.bincount(v[v < vecs], minlength=vecs)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("kernel,h,w,c", PATH_SITES)
def test_plan_is_one_wave_covering_every_vector_once_at_path_shapes(
        kernel, h, w, c, dtype):
    plan = _plan(kernel, 1, h, w, c, dtype)
    assert plan.path == ("channels" if c % plan.vec == 0 else "flat3")
    assert plan.vec == 16 // ELEMENT_SIZES[dtype]
    assert plan.blocks <= WAVE_BLOCKS
    assert plan.per_thread == (2 if (dtype, c) == ("f32", 32) else 1)
    vecs, hits = _covered(plan, h * w * c)
    assert vecs * plan.vec == h * w * c
    assert hits.min() == hits.max() == 1
    # no block that takes no vector at all
    assert (plan.blocks - 1) * plan.per_thread * THREADS < vecs


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("n,h,w,c,form", NORM_ACT_SITES)
def test_norm_act_plan_at_every_main_path_shape(n, h, w, c, form, dtype):
    """#3: 16-byte vectors along C, one a thread; one wave wherever the
    vectors fit one wave of threads, more blocks beyond it; every vector
    covered exactly once."""
    plan = _plan("norm_act", n, h, w, c, dtype)
    assert (plan.path, plan.vec) == ("channels", 16 // ELEMENT_SIZES[dtype])
    assert plan.per_thread == NORM_ACT_MAX_PER_THREAD == 1
    vecs, hits = _covered(plan, n * h * w * c)
    assert (plan.blocks <= WAVE_BLOCKS) == (vecs <= SMS * RESIDENT_THREADS)
    assert hits.min() == hits.max() == 1
    assert (plan.blocks - 1) * plan.per_thread * THREADS < vecs


@pytest.mark.parametrize("n,h,w,c,dtype,per_thread", [
    (2, 512, 512, 32, "f32", 4),        # beyond four waves: K = 4
    (2, 512, 512, 32, "bf16", 4),
    (1, 256, 512, 32, "bf16", 2),
    (1, 256, 512, 32, "f32", 4),
    (1, 128, 256, 32, "f32", 1),
    (1, 5, 7, 9, "bf16", 1),            # one element at a time
    (3, 33, 17, 24, "f32", 1)])
def test_plan_covers_every_vector_once_beyond_one_wave(n, h, w, c, dtype,
                                                       per_thread):
    plan = _plan("apply", n, h, w, c, dtype)
    assert plan.per_thread == per_thread
    vecs, hits = _covered(plan, n * h * w * c)
    assert hits.min() == hits.max() == 1
    if vecs <= max(PER_THREAD) * SMS * RESIDENT_THREADS:
        assert plan.blocks <= WAVE_BLOCKS


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("flat3", [True, False])
def test_c3_vector_path_is_chosen_exactly_when_its_conditions_hold(
        dtype, aligned, flat3):
    vec = 16 // ELEMENT_SIZES[dtype]
    for c in (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 64):
        for hw in (1, 4, 8, 35, 40, 64 * 64, 255 * 17):
            plan = apply_plan(2 * hw * c, hw * c, c, ELEMENT_SIZES[dtype],
                              aligned, flat3)
            if aligned and c % vec == 0:
                want = "channels"
            elif aligned and flat3 and c == 3 and (hw * c) % vec == 0:
                want = "flat3"
            else:
                want = "element"
            assert plan.path == want, (c, hw)
            assert plan.path in APPLY_PATHS
            assert plan.vec == (1 if want == "element" else vec)
            vecs, hits = _covered(plan, 2 * hw * c)
            assert hits.min() == hits.max() == 1


def test_plan_for_reads_alignment_and_refuses_2_to_the_31_elements():
    x = torch.zeros((1, 3, 16, 16)).contiguous(
        memory_format=torch.channels_last)
    assert plan_for(x, torch.empty_like(x)).path == "flat3"
    base = torch.zeros(1 + 3 * 16 * 16)
    xm = base[1:].view(1, 16, 16, 3).permute(0, 3, 1, 2)
    assert plan_for(xm, torch.empty_like(x)).path == "element"
    assert plan_for(x, torch.empty_like(x), flat3=False).path == "element"
    big = torch.empty((2, 32, 32768, 1024), device="meta").contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="2\\^31"):
        plan_for(big, big)


@pytest.mark.parametrize("misaligned", ["none", "x", "y", "residual"])
def test_plan_for_takes_vectors_only_where_the_residual_is_aligned(
        misaligned):
    """#3's plan: 16-byte vectors along C only where x, y and the residual
    all start on a 16-byte boundary; one element at a time otherwise."""
    def tensor(off):
        base = torch.zeros(off + 2 * 16 * 6 * 5, dtype=torch.bfloat16)
        return base[off:].view(2, 6, 5, 16).permute(0, 3, 1, 2)

    x, y, r = (tensor(1 if misaligned == which else 0)
               for which in ("x", "y", "residual"))
    assert all(t.is_contiguous(memory_format=torch.channels_last)
               for t in (x, y, r))
    want = "channels" if misaligned == "none" else "element"
    assert plan_for(x, y, flat3=False, residual=r).path == want
    assert plan_for(x, y, flat3=False).path == (
        "element" if misaligned in ("x", "y") else "channels")


def _abs_values(kind, rng):
    y = (rng.standard_normal(4099) * 10.0 ** rng.integers(-3, 4, 4099)
         ).astype(np.float32)
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    if kind in ("subnormal", "everything"):
        y[::7] = tiny * rng.integers(-2 ** 20, 2 ** 20, y[::7].size)
    if kind == "subnormal":
        y = y[::7]
    if kind in ("inf", "everything"):
        y[5::311] = np.inf
        y[9::313] = -np.inf
    if kind in ("negzero", "zeros", "everything"):
        y[3::17] = -0.0
    if kind == "zeros":
        y[:] = np.where(np.arange(y.size) % 2, -0.0, 0.0)
    if kind in ("nan", "everything"):
        y[11::401] = np.nan
        y[12::409] = -np.nan
    return np.abs(y)


@pytest.mark.parametrize("kind", ["finite", "subnormal", "inf", "negzero",
                                  "zeros", "nan", "everything"])
def test_max_of_the_bits_of_abs_is_the_max_of_abs(kind):
    """#4's tail: max over the uint32 bits of |y| (canonical NaN where it
    lies above +inf) against ``np.max(np.abs(y))``, and over blocks folded
    in any order."""
    rng = np.random.default_rng(7)
    a = _abs_values(kind, rng)
    bits = a.view(np.uint32)
    assert not (bits >> 31).any()                  # every sign cleared
    folded = np.maximum.reduce(bits)
    blocks = [bits[i::5].max() for i in (3, 0, 4, 1, 2)]
    assert np.maximum.reduce(np.array(blocks, np.uint32)) == folded
    got = np.array(folded if folded <= 0x7F800000 else 0x7FFFFFFF,
                   np.uint32).view(np.float32)
    want = np.max(a)
    if np.isnan(want):
        assert np.isnan(got) and kind in ("nan", "everything")
    else:
        assert got == want and got.view(np.uint32) == want.view(np.uint32)
        assert kind not in ("nan", "everything")
