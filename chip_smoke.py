#!/usr/bin/env python3
"""Drive the p2p_tpu_torch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # one card; exits 0 only if all passes
    python3 chip_smoke.py --profile  # also prints a torch.profiler table

Phases, each of which fails the run (nothing is caught, nothing falls back
to the CPU or to a plain version):

1. device and build: the card's name and power limit (nvidia-smi), then the
   port's CUDA kernels built from the sources in this checkout;
2. kernels: at every shape of the main paths each kernel is held against
   its plain PyTorch version on the card, in bf16 and f32, and timed with
   CUDA events (median of 20 cold-L2 runs) beside its plain version, a
   PyTorch library yardstick and its bound (the larger of the bytes moved
   over the card's memory rate and the operations over its peak rate for
   the operands' type): #1 and #3 at every epilogue shape of the
   full-width pix2pixHD generator at each batch size serving uses (N = 1,
   2, 4) and each activation/residual form; #5 at the (M, C) shapes of
   the reference and facades train steps; #6 and #7 at the facades image
   head's shapes (N = 1, 2, 4 serving, N = 1 training);
3. pix2pixHD serving: the full-width generator (random weights from a
   seed) served through ``InferenceEngine`` in bf16 on synthetic 512×1024
   requests; the launch counts of that run must be exactly 36 + 36 per
   forward batch (and nothing else); the f32 generator through the kernels
   must match the f32 generator through the plain versions within 1e-3 on
   a batch of 4;
4. reference training: the full-width ``reference`` preset (net_c,
   ExpandNetwork, 3-scale spectral-norm PatchGAN, VGG19; random weights
   from a seed) trained through ``create_train_state`` /
   ``build_train_step`` in bf16 on synthetic 256² batches: 2 warm-up and 8
   timed steps with finite losses and exactly 50 launches of #5 per step
   (and nothing else); then in f32 with TF32 off, 2 steps through the
   kernel against 2 through the plain version from the same state, losses
   and running statistics within the stated bands;
5. facades serving: the full-width ``facades`` U-Net with the subpixel
   head on #6 (``thin_head``, ``head_pallas``) served in bf16 on synthetic
   256² label maps: exactly one #6 per forward batch and nothing else; the
   f32 U-Net through #6 against it through the plain version within 1e-3;
6. facades training: the same U-Net with the 70×70 PatchGAN, dropout on,
   bf16: 2 warm-up and 8 timed steps with finite losses and exactly 13
   #5, one #6 and one #7 per step; then in f32 with TF32 off, 2 steps
   through the kernels against 2 through the plain versions from the same
   state and dropout seed, losses within the stated bands;
7. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

SEED = 0
N_REQUESTS = 6
BUCKETS = (1, 2, 4)
# the main path: engine.run over these batches, then every request alone
RUN_BATCHES = (4, 2)
NORMS_PER_FORWARD = 36
# published H100 SXM peaks: HBM3 bytes/s, and FLOP/s for the operands'
# type (bf16 on the tensor cores, f32 outside them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version: f32 differs only in the order of partial sums;
# bf16 outputs may differ by one rounding of the stored value
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0 ** -7)}
STATS_TOL = (1e-4, 1e-4)   # (atol, rtol): f32 outputs from either input type
SLICE_F32_TOL = 1e-3
TIMING_REPS = 20
# #5 vs plain: f32 sums of the same terms in two orders; the error of
# either is a small multiple of 2^-24 times the sum of |terms|
MOMENTS_RTOL_OF_ABS_SUM = 1e-5
# the train phase: batch 1 at 256² (the preset's shape), bf16 steps
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
# f32 train steps through #5 vs through its plain version, from one state.
# Step 1's losses differ only by the order of f32 sums (and cuDNN's
# algorithm choices): rtol 1e-4. Adam's first update moves every weight by
# exactly +-lr (m/sqrt(v) = sign(g)), so weights whose gradient is near 0
# and flips sign between the routes end 2 lr = 4e-4 apart; step 2's losses
# then differ by up to 2% (the band of tests/test_torch_train_step.py), and
# a running statistic, which takes 0.1 of a batch statistic of activations
# that sum up to 1,152 such weights (a k3 conv over 128 channels), by up to
# 0.05 plus 2% of its value.
TRAIN_F32_STEPS = 2
TRAIN_STEP1_RTOL, TRAIN_LATER_RTOL = 1e-4, 2e-2
TRAIN_STATS_ATOL = 5e-2
LOSS_KEYS = ("loss_g", "loss_d", "loss_c", "g_gan", "g_feat", "g_vgg",
             "g_tv")
# #6 and #7: z (f32) differs from the plain version only by the order of
# f32 sums of 512 products of magnitude ~0.1; dx is stored in x's dtype
HEAD_Z_TOL = (1e-4, 1e-4)
# the facades train check: f32 steps through #5/#6/#7 vs through their
# plain versions from one state and one dropout seed. Step 1 differs only
# by the order of f32 sums (rtol 1e-4); from step 2 Adam's sign-like first
# update moves weights whose gradient is near 0 by ±lr on either route
# (tests/test_torch_facades_step.py measured 8.5e-7 between the two
# packages on the CPU at step 3): rtol 1e-3.
FACADES_STEP1_RTOL, FACADES_LATER_RTOL = 1e-4, 1e-3
FACADES_LOSS_KEYS = ("loss_g", "loss_d", "g_gan", "g_l1")


def epilogue_plan(ngf: int, n_global: int, n_local: int, h: int, w: int):
    """(H, W, C, act, residual) of every norm epilogue of one
    Pix2PixHDGenerator forward, in order (models/pix2pixhd.py)."""
    plan = []
    hh, ww, c = h // 2, w // 2, ngf          # G1 runs at half resolution
    plan.append((hh, ww, c, "relu", False))
    for i in range(4):
        hh, ww, c = hh // 2, ww // 2, min(ngf * 2 ** (i + 1), 1024)
        plan.append((hh, ww, c, "relu", False))
    plan += [(hh, ww, c, "relu", False), (hh, ww, c, "none", True)] * n_global
    for i in reversed(range(4)):
        hh, ww, c = hh * 2, ww * 2, min(ngf * 2 ** i, 1024)
        plan.append((hh, ww, c, "relu", False))
    plan.append((h, w, ngf // 2, "relu", False))             # G2 stem
    plan.append((h // 2, w // 2, ngf, "relu", False))        # G2 down
    plan += [(h // 2, w // 2, ngf, "relu", False),
             (h // 2, w // 2, ngf, "none", True)] * n_local
    plan.append((h, w, ngf // 2, "relu", False))             # G2 up
    return plan


class Timer:
    """Device time of a callable with CUDA events: the stream is held by a
    sleep kernel while the host enqueues the timed work, so host launch
    overhead is not counted; the L2 cache is evicted before every run."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int = TIMING_REPS) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_row(nbytes: int, flops: float, dtype: torch.dtype):
    """``bound_ms``, the larger of the bytes over the memory rate and the
    operations over the peak rate for the operands' type, and
    ``bound_by``, which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def batchnorm_plan(ngf: int, n_blocks: int, h: int, w: int):
    """(M, C) of every BatchNorm of one reference train step at batch 1, in
    order: G twice (the G step, then the net_c branch), each with 3
    encoder, 2·n_blocks trunk, 2 decoder and the head's BatchNorm
    (models/expand.py), and net_c twice with one (models/compression.py)."""
    p = h * w
    g = ([(p, ngf), (p // 4, 2 * ngf), (p // 16, 4 * ngf)]
         + [(p // 16, 4 * ngf)] * (2 * n_blocks)
         + [(p // 4, 2 * ngf), (p, ngf), (p, 3)])
    return 2 * g + 2 * [(p, 64)]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(what, got, want, atol, rtol):
    excess = ((got.float() - want.float()).abs()
              - (atol + rtol * want.float().abs())).max()
    if not bool(excess <= 0):
        raise AssertionError(f"{what}: kernel differs from plain version by "
                             f"{max_err(got, want):.3g} (atol {atol}, "
                             f"rtol {rtol})")


def main_path_forwards():
    """Forward batches of the main path by batch size (each batch size is
    a bucket, so N of every kernel launch equals it)."""
    return collections.Counter(RUN_BATCHES) + collections.Counter(
        {1: N_REQUESTS})


def make_input(gen, n, c, h, w, dtype, device):
    """channels_last (n, c, h, w) with a different mean and spread per
    sample, so a kernel that mixes samples up disagrees."""
    i = torch.arange(n, device=device, dtype=torch.float32).view(n, 1, 1, 1)
    x = torch.randn((n, c, h, w), generator=gen, device=device)
    return (x * (1.5 + 0.5 * i) + 0.25 - 0.5 * i).to(dtype).contiguous(
        memory_format=torch.channels_last)


def kernel_phase(device, plan):
    import torch.nn.functional as F

    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_stats, instance_norm_stats_plain)
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act, norm_act_plain

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    per_shape = collections.Counter((h, w, c) for h, w, c, _, _ in plan)
    per_form = collections.Counter(plan)
    forwards = main_path_forwards()
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.tensor([], dtype=dtype).element_size()
        atol, rtol = TOL[dtype]
        for n, (h, w, c) in sorted(
                (n, shape) for n in main_path_forwards() for shape in per_shape):
            where = f"{str(dtype)[6:]} N={n} {h}x{w}x{c}"
            x = make_input(gen, n, c, h, w, dtype, device)
            numel = x.numel()
            mean, rstd = instance_norm_stats(x)
            pmean, prstd = instance_norm_stats_plain(x)
            assert_close(f"stats {where} mean", mean, pmean, *STATS_TOL)
            assert_close(f"stats {where} rstd", rstd, prstd, *STATS_TOL)
            rows.append(dict(
                kernel="instance_norm_stats", dtype=str(dtype)[6:], n=n,
                shape=(h, w, c), form="-", per_forward=per_shape[(h, w, c)],
                launches=per_shape[(h, w, c)] * forwards[n],
                max_abs_err=max(max_err(mean, pmean), max_err(rstd, prstd)),
                ms=timer(lambda: instance_norm_stats(x)),
                plain_ms=timer(lambda: instance_norm_stats_plain(x)),
                library_ms=timer(lambda: torch.var_mean(
                    x, dim=(2, 3), correction=0)),
                **bound_row(numel * elt + 2 * n * c * 4, 3 * numel, dtype)))
            for (fh, fw, fc, act, has_res), n_form in sorted(per_form.items()):
                if (fh, fw, fc) != (h, w, c):
                    continue
                r = make_input(gen, n, c, h, w, dtype, device) if has_res \
                    else None
                y = norm_act(x, pmean, prstd, residual=r, act=act)
                py = norm_act_plain(x, pmean, prstd, residual=r, act=act)
                form = act + ("+residual" if has_res else "")
                assert_close(f"norm_act {where} {form}", y, py, atol, rtol)
                rows.append(dict(
                    kernel="norm_act", dtype=str(dtype)[6:], n=n,
                    shape=(h, w, c), form=form, per_forward=n_form,
                    launches=n_form * forwards[n],
                    max_abs_err=max_err(y, py),
                    ms=timer(lambda: norm_act(x, pmean, prstd, residual=r,
                                              act=act)),
                    plain_ms=timer(lambda: norm_act_plain(
                        x, pmean, prstd, residual=r, act=act)),
                    library_ms=timer(lambda: F.instance_norm(x)),
                    **bound_row(numel * elt * (3 if has_res else 2)
                                + 2 * n * c * 4, 4 * numel, dtype)))
    print("kernel phase (device ms, median of "
          f"{TIMING_REPS} cold-L2 runs; tolerance passed):")
    for row in rows:
        print("  " + json.dumps(row))
    return rows


def moments_phase(device, launches):
    """#5 at every (M, C) of the reference and facades train steps
    (``launches``: their count on the main paths): kernel vs plain version
    (per channel, within MOMENTS_RTOL_OF_ABS_SUM of Σ|x| and Σx²), and
    times. Channel 0 of each input has a large mean and a small spread;
    the others differ in mean and spread."""
    from p2p_tpu_torch.ops.cuda.batch_moments import (
        batch_moments, batch_moments_plain)

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.tensor([], dtype=dtype).element_size()
        for m, c in sorted(launches):
            mean = torch.linspace(-2.0, 2.0, c, device=device)
            spread = torch.linspace(3.0, 0.1, c, device=device)
            mean[0], spread[0] = 40.0, 0.01
            x = (torch.randn((m, c), generator=gen, device=device) * spread
                 + mean).to(dtype)
            s1, s2 = batch_moments(x)
            p1, p2 = batch_moments_plain(x)
            abs_sum = x.float().abs().sum(dim=0)
            where = f"batch_moments {str(dtype)[6:]} M={m} C={c}"
            for what, got, want, scale in (("sum", s1, p1, abs_sum),
                                           ("sum of squares", s2, p2, p2)):
                excess = ((got - want).abs()
                          - MOMENTS_RTOL_OF_ABS_SUM * scale).max()
                if not bool(excess <= 0):
                    raise AssertionError(
                        f"{where} {what}: kernel differs from plain version "
                        f"by {max_err(got, want):.3g}")
            rows.append(dict(
                kernel="batch_moments", dtype=str(dtype)[6:], n=1,
                shape=(m, c), form="-", launches=launches[(m, c)],
                max_abs_err=max(max_err(s1, p1), max_err(s2, p2)),
                max_rel_err=max(float(((s1 - p1).abs() / abs_sum).max()),
                                float(((s2 - p2).abs() / p2).max())),
                ms=timer(lambda: batch_moments(x)),
                plain_ms=timer(lambda: batch_moments_plain(x)),
                library_ms=timer(lambda: torch.var_mean(x, dim=0)),
                **bound_row(m * c * elt + 2 * c * 4, 3 * m * c, dtype)))
    print("moments phase (#5; device ms, median of "
          f"{TIMING_REPS} cold-L2 runs; tolerance passed):")
    for row in rows:
        print("  " + json.dumps(row))
    return rows


def subpixel_phase(device, fwd_launches, dx_launches):
    """#6 and #7 at the facades image head's shapes, x (N, 128, 128, 128)
    and w (2, 2, 128, 12) (``*_launches``: N → launches on the main
    paths), in bf16 and f32 against their plain versions (TF32 off), and
    times beside the library's conv (#6) and conv input gradient (#7)."""
    import torch.nn.functional as F

    from p2p_tpu_torch.ops.cuda.subpixel_head import (
        subpixel_head_dx, subpixel_head_dx_plain, subpixel_head_fwd,
        subpixel_head_fwd_plain)

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    c, h, w, f4 = 128, 128, 128, 12
    rows = []
    with tf32_off():
        for dtype in (torch.bfloat16, torch.float32):
            elt = torch.tensor([], dtype=dtype).element_size()
            atol, rtol = TOL[dtype]
            wt = (torch.randn((2, 2, c, f4), generator=gen, device=device)
                  * 0.05).to(dtype)
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            for n in sorted(set(fwd_launches) | set(dx_launches)):
                where = f"{str(dtype)[6:]} N={n}"
                x = make_input(gen, n, c, h, w, dtype, device)
                dz = make_input(gen, n, f4, h + 1, w + 1, torch.float32,
                                device)
                z_bytes = n * (h + 1) * (w + 1) * f4 * 4
                flops = 2 * n * (h + 1) * (w + 1) * f4 * 4 * c
                z = subpixel_head_fwd(x, wt)
                pz = subpixel_head_fwd_plain(x, wt)
                assert_close(f"subpixel_head_fwd {where}", z, pz,
                             *HEAD_Z_TOL)
                dx = subpixel_head_dx(dz, wt)
                pdx = subpixel_head_dx_plain(dz, wt)
                assert_close(f"subpixel_head_dx {where}", dx, pdx, atol,
                             rtol)
                common = dict(dtype=str(dtype)[6:], n=n, shape=(h, w, c),
                              form=f"F4={f4}")
                rows.append(dict(
                    kernel="subpixel_head_fwd", **common,
                    launches=fwd_launches.get(n, 0), max_abs_err=max_err(
                        z, pz),
                    ms=timer(lambda: subpixel_head_fwd(x, wt)),
                    plain_ms=timer(lambda: subpixel_head_fwd_plain(x, wt)),
                    library_ms=timer(lambda: F.conv2d(x, w_oihw,
                                                      padding=1)),
                    flop_ms_cuda_cores=flops / PEAK_FLOP_PER_S[
                        torch.float32] * 1e3,
                    **bound_row(x.numel() * elt + wt.numel() * elt + z_bytes,
                                flops, dtype)))
                dz_in = dz.to(dtype)
                rows.append(dict(
                    kernel="subpixel_head_dx", **common,
                    launches=dx_launches.get(n, 0), max_abs_err=max_err(
                        dx, pdx),
                    ms=timer(lambda: subpixel_head_dx(dz, wt)),
                    plain_ms=timer(lambda: subpixel_head_dx_plain(dz, wt)),
                    library_ms=timer(lambda: torch.nn.grad.conv2d_input(
                        x.shape, w_oihw, dz_in, padding=1)),
                    flop_ms_cuda_cores=flops / PEAK_FLOP_PER_S[
                        torch.float32] * 1e3,
                    **bound_row(z_bytes + wt.numel() * elt + x.numel() * elt,
                                flops, dtype)))
    print("subpixel head phase (#6, #7; device ms, median of "
          f"{TIMING_REPS} cold-L2 runs; tolerance passed):")
    for row in rows:
        print("  " + json.dumps(row))
    return rows


def totals(rows, kernel, dtype="bfloat16"):
    """A kernel's launches on its main paths at their dtype (bf16): each
    (N, shape, form) time weighted by how often the paths launched it;
    ``bound_by`` is what bounds the launch-weighted sum."""
    sel = [r for r in rows if r["kernel"] == kernel and r["dtype"] == dtype]
    out = {k: sum(r[k] * r["launches"] for r in sel)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["launches"] = sum(r["launches"] for r in sel)
    out["max_abs_err"] = max(r["max_abs_err"] for r in sel)
    by = collections.Counter()
    for r in sel:
        by[r["bound_by"]] += r["bound_ms"] * r["launches"]
    out["bound_by"] = max(by, key=by.get)
    return out


def _wrappers():
    from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import instance_norm_stats
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act
    from p2p_tpu_torch.ops.cuda.subpixel_head import (subpixel_head_dx,
                                                      subpixel_head_fwd)

    return {"instance_norm_stats": instance_norm_stats, "norm_act": norm_act,
            "batch_moments": batch_moments,
            "subpixel_head_fwd": subpixel_head_fwd,
            "subpixel_head_dx": subpixel_head_dx}


def only(**counts):
    """The launch counts of a run that launched these kernels, and no
    other."""
    return {name: counts.get(name, 0) for name in _wrappers()}


def launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def check_png(path: str, h: int, w: int) -> None:
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    pw, ph = int.from_bytes(head[16:20], "big"), int.from_bytes(
        head[20:24], "big")
    if (ph, pw) != (h, w):
        raise AssertionError(f"{path} is {pw}x{ph}, expected {w}x{h}")


def slice_phase(device, card, profile: bool):
    import p2p_tpu_torch.ops.instance_norm as seam
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.models.registry import define_G, init_weights
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_stats_plain)
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act_plain
    from p2p_tpu_torch.serve.engine import InferenceEngine

    cfg = get_preset("pix2pixhd")
    h, w = cfg.image_hw
    t0 = time.perf_counter()
    generator = init_weights(define_G(cfg.model),
                             torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in generator.parameters())
    engine = InferenceEngine(cfg, generator, buckets=BUCKETS, dtype="bf16")
    engine.warmup()
    print(f"slice: pix2pixhd generator, {n_params} parameters, ngf "
          f"{cfg.model.ngf}, {h}x{w}; built and warmed {BUCKETS} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    reqs = np.random.default_rng(SEED).integers(
        0, 256, (N_REQUESTS, h, w, 3), dtype=np.uint8)
    names = [f"req{i}.png" for i in range(N_REQUESTS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        reset_launch_counts()
        # the main path: RUN_BATCHES through the serving pipeline (PNG
        # files), then every request alone for its latency
        starts = np.cumsum((0,) + RUN_BATCHES)
        stats, _ = engine.run([{"input": reqs[a:b]}
                               for a, b in zip(starts[:-1], starts[1:])],
                              names=names, out_dir=out_dir)
        latencies, preds = [], []
        for i in range(N_REQUESTS):
            t = time.perf_counter()
            pred, _, n_real = engine.infer_batch({"input": reqs[i:i + 1]})
            engine.synchronize()
            latencies.append((time.perf_counter() - t) * 1e3)
            preds.append(pred[:n_real])
        counts = launch_counts()
        n_forwards = stats.n_batches + N_REQUESTS
        for path in names:
            check_png(os.path.join(out_dir, path), h, w)
    want = NORMS_PER_FORWARD * n_forwards
    print(f"slice: launches over {n_forwards} forward batches: {counts} "
          f"(want {want} of #1 and #3, nothing else)")
    if counts != only(instance_norm_stats=want, norm_act=want):
        raise AssertionError(f"launch counts {counts} != {want} of #1, #3")
    pred = torch.cat(preds)
    if tuple(pred.shape) != (N_REQUESTS, h, w, 3):
        raise AssertionError(f"pred shape {tuple(pred.shape)}")
    if not bool(torch.isfinite(pred).all()) or float(pred.abs().max()) > 1:
        raise AssertionError("pred is not finite within [-1, 1]")
    print(f"slice: served {stats.n_images} requests in {stats.n_batches} "
          f"batches: {stats.img_per_sec:.3f} img/s end to end, "
          f"{stats.device_img_per_sec:.3f} img/s to the last device result; "
          f"latency alone (bucket 1) median "
          f"{statistics.median(latencies):.2f} ms, min {min(latencies):.2f}, "
          f"max {max(latencies):.2f} ms; on {card}", flush=True)

    # f32: the kernels against the plain versions on the same weights and
    # the largest bucket's batch
    n32 = max(BUCKETS)
    with tf32_off():
        eng32 = InferenceEngine(cfg, generator, buckets=(n32,), dtype="f32")
        eng32.warmup()
        before = launch_counts()
        y_kernel, _, _ = eng32.infer_batch({"input": reqs[:n32]})
        with mock.patch.object(seam, "instance_norm_stats",
                               instance_norm_stats_plain), \
                mock.patch.object(seam, "norm_act", norm_act_plain):
            mid = launch_counts()
            y_plain, _, _ = eng32.infer_batch({"input": reqs[:n32]})
        after = launch_counts()
    if any(mid[k] - before[k] != NORMS_PER_FORWARD
           for k in ("instance_norm_stats", "norm_act")) or after != mid:
        raise AssertionError(f"f32 check did not take the intended routes: "
                             f"{before} {mid} {after}")
    diff = max_err(y_kernel, y_plain)
    print(f"slice: f32 (TF32 off) kernels vs plain versions on a batch of "
          f"{n32}: max abs diff "
          f"{diff:.3g} on the tanh output (limit {SLICE_F32_TOL})")
    if not diff <= SLICE_F32_TOL:
        raise AssertionError(f"f32 slice diff {diff} > {SLICE_F32_TOL}")
    del eng32

    if profile:
        profile_forward(engine, reqs[:1])
    return counts, stats, latencies


@contextlib.contextmanager
def tf32_off():
    """f32 convolutions and matmuls in full f32 (no TF32) inside."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def profile_call(what: str, fn) -> None:
    """torch.profiler over one call: device time by kernel, then the
    call's wall time, the device's busy time and the kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    table = prof.key_averages()
    print(table.table(sort_by="cuda_time_total", row_limit=30))
    # the table's own "Self CUDA time total": device events only
    busy = sum(e.self_device_time_total for e in table
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3
    launches = sum(e.count for e in table
                   if e.key.startswith("cudaLaunchKernel"))
    print(f"profile {what}: wall {wall:.3f} ms (profiler on), device busy "
          f"{busy:.3f} ms, {launches} kernel launches")


def profile_forward(engine, batch):
    """One bf16 bucket-1 forward of the serving engine."""
    def fwd():
        engine.infer_batch({"input": batch})
        engine.synchronize()

    profile_call("serving forward", fwd)


def train_phase(device, card, profile: bool):
    """The reference preset's training slice: bf16 steps with their times,
    losses and #5 launch counts, then the f32 kernel-vs-plain check."""
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_batch
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.ops.cuda.batch_moments import (
        batch_moments, batch_moments_plain)
    from p2p_tpu_torch.train.state import create_train_state, load_vgg19
    from p2p_tpu_torch.train.step import build_train_step

    cfg = get_preset("reference")
    h, w = cfg.image_hw
    m = cfg.model
    per_step = len(batchnorm_plan(m.ngf, m.n_blocks, h, w))
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    host = synthetic_batch(n_steps * cfg.data.batch_size, h, m.quant_bits,
                           seed=SEED, width=w)
    bs = cfg.data.batch_size
    batches = [{k: v[i * bs:(i + 1) * bs] for k, v in host.items()}
               for i in range(n_steps)]
    dtype = train_dtype(cfg.train.mixed_precision)
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    vgg = load_vgg19(device=device)
    step = build_train_step(cfg, vgg, dtype)
    sizes = {k: sum(p.numel() for p in net.parameters()) for k, net in (
        ("G", state.net_g), ("D", state.net_d), ("C", state.net_c))}
    print(f"train: reference preset, {h}x{w}, batch {bs}, {dtype}, ngf "
          f"{m.ngf}, ndf {m.ndf}, {m.n_blocks} blocks, {m.num_D} D scales, "
          f"parameters {sizes}; built in {time.perf_counter() - t0:.1f}s",
          flush=True)

    reset_launch_counts()
    times = []
    for i, batch in enumerate(batches):
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses = {k: float(metrics[k]) for k in LOSS_KEYS}
        print(f"train: step {i + 1} {times[-1]:.2f} ms {json.dumps(losses)}")
        if not all(np.isfinite(v) for v in losses.values()) \
                or float(metrics["health_ok"]) != 1.0:
            raise AssertionError(f"step {i + 1}: non-finite losses {losses}")
    counts = launch_counts()
    want = only(batch_moments=per_step * n_steps)
    print(f"train: launches over {n_steps} steps: {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    timed = times[TRAIN_WARMUP:]
    med = statistics.median(timed)
    print(f"train: {TRAIN_STEPS} timed bf16 steps (after {TRAIN_WARMUP} "
          f"warm-up): median {med:.2f} ms/step, min {min(timed):.2f}, max "
          f"{max(timed):.2f}; {bs * 1e3 / med:.2f} img/s; on {card}",
          flush=True)
    if profile:
        profile_call("train step", lambda: step(state, batches[0]))
    del state, step

    # f32, TF32 off: the same state through #5 and through its plain version
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  mixed_precision=False))
    runs = {}
    with tf32_off():
        for route in ("kernel", "plain"):
            st = create_train_state(cfg32, SEED)
            stp = build_train_step(cfg32, vgg)
            plain = mock.patch.object(norm, "batch_moments",
                                      batch_moments_plain)
            before = batch_moments.launches
            with plain if route == "plain" else contextlib.nullcontext():
                losses = [{k: float(v) for k, v in stp(st, b)[1].items()}
                          for b in batches[:TRAIN_F32_STEPS]]
            launched = batch_moments.launches - before
            if launched != (per_step * TRAIN_F32_STEPS
                            if route == "kernel" else 0):
                raise AssertionError(f"f32 {route} run launched #5 "
                                     f"{launched} times")
            stats = torch.cat([b.reshape(-1) for net in (st.net_g, st.net_c)
                               for b in net.buffers()])
            runs[route] = (losses, stats)
    worst = 0.0
    for i, (lk, lp) in enumerate(zip(runs["kernel"][0], runs["plain"][0])):
        rtol = TRAIN_STEP1_RTOL if i == 0 else TRAIN_LATER_RTOL
        for k in LOSS_KEYS:
            rel = abs(lk[k] - lp[k]) / abs(lp[k])
            worst = max(worst, rel)
            if not rel <= rtol:
                raise AssertionError(f"f32 step {i + 1} {k}: kernel "
                                     f"{lk[k]} vs plain {lp[k]} (rtol {rtol})")
    sk, sp = runs["kernel"][1], runs["plain"][1]
    print(f"train: f32 (TF32 off) {TRAIN_F32_STEPS} steps through #5 vs its "
          f"plain version: losses max rel diff {worst:.3g} (step 1 limit "
          f"{TRAIN_STEP1_RTOL}, later {TRAIN_LATER_RTOL}); running stats "
          f"max abs diff {max_err(sk, sp):.3g} (limit {TRAIN_STATS_ATOL} + "
          f"{TRAIN_LATER_RTOL} of the value)")
    assert_close("f32 running stats", sk, sp, TRAIN_STATS_ATOL,
                 TRAIN_LATER_RTOL)
    return counts, med


def facades_config():
    """The ``facades`` preset with the subpixel head on #6/#7."""
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset("facades")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, thin_head=True, head_pallas=True))


def facades_bn_plan(ngf: int, h: int, w: int, num_downs: int = 8):
    """(M, C) of every BatchNorm of one facades U-Net forward at batch 1,
    in order (models/unet.py): encoder levels 1…num_downs−2, then decoder
    levels num_downs−1…1."""
    feats = [min(ngf * 2 ** i, ngf * 8) for i in range(num_downs)]
    enc = [(h * w >> 2 * (i + 1), feats[i]) for i in range(1, num_downs - 1)]
    dec = [(h * w >> 2 * i, feats[i - 1])
           for i in reversed(range(1, num_downs))]
    return enc + dec


def facades_serving_phase(device, card, profile: bool):
    """The full-width facades U-Net with the subpixel head served in bf16:
    exactly one #6 per forward batch, then the f32 U-Net through #6
    against it through the plain version."""
    from p2p_tpu_torch.data.synthetic import synthetic_facades_batch
    from p2p_tpu_torch.models.registry import define_G, init_weights
    from p2p_tpu_torch.ops.cuda import subpixel_head
    from p2p_tpu_torch.serve.engine import InferenceEngine

    cfg = facades_config()
    h, w = cfg.image_hw
    t0 = time.perf_counter()
    generator = init_weights(define_G(cfg.model, None, (h, w)),
                             torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in generator.parameters())
    engine = InferenceEngine(cfg, generator, buckets=BUCKETS, dtype="bf16")
    engine.warmup()
    print(f"facades serving: U-Net, {n_params} parameters, ngf "
          f"{cfg.model.ngf}, {h}x{w}, subpixel head on #6; built and warmed "
          f"{BUCKETS} in {time.perf_counter() - t0:.1f}s", flush=True)
    reqs = synthetic_facades_batch(N_REQUESTS, h, seed=SEED)["input"]
    names = [f"req{i}.png" for i in range(N_REQUESTS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        reset_launch_counts()
        starts = np.cumsum((0,) + RUN_BATCHES)
        stats, _ = engine.run([{"input": reqs[a:b]}
                               for a, b in zip(starts[:-1], starts[1:])],
                              names=names, out_dir=out_dir)
        latencies, preds = [], []
        for i in range(N_REQUESTS):
            t = time.perf_counter()
            pred, _, n_real = engine.infer_batch({"input": reqs[i:i + 1]})
            engine.synchronize()
            latencies.append((time.perf_counter() - t) * 1e3)
            preds.append(pred[:n_real])
        counts = launch_counts()
        for path in names:
            check_png(os.path.join(out_dir, path), h, w)
    n_forwards = stats.n_batches + N_REQUESTS
    print(f"facades serving: launches over {n_forwards} forward batches: "
          f"{counts} (want {n_forwards} of #6, nothing else)")
    if counts != only(subpixel_head_fwd=n_forwards):
        raise AssertionError(f"launch counts {counts}")
    pred = torch.cat(preds)
    if tuple(pred.shape) != (N_REQUESTS, h, w, 3):
        raise AssertionError(f"pred shape {tuple(pred.shape)}")
    if not bool(torch.isfinite(pred).all()) or float(pred.abs().max()) > 1:
        raise AssertionError("pred is not finite within [-1, 1]")
    print(f"facades serving: {stats.n_images} requests in {stats.n_batches} "
          f"batches: {stats.img_per_sec:.3f} img/s end to end, "
          f"{stats.device_img_per_sec:.3f} img/s to the last device result; "
          f"latency alone (bucket 1) median "
          f"{statistics.median(latencies):.2f} ms, min {min(latencies):.2f}, "
          f"max {max(latencies):.2f} ms; on {card}", flush=True)

    n32 = max(BUCKETS)
    with tf32_off():
        eng32 = InferenceEngine(cfg, generator, buckets=(n32,), dtype="f32")
        eng32.warmup()
        before = subpixel_head.subpixel_head_fwd.launches
        y_kernel, _, _ = eng32.infer_batch({"input": reqs[:n32]})
        with mock.patch.object(subpixel_head, "subpixel_head_fwd",
                               subpixel_head.subpixel_head_fwd_plain):
            y_plain, _, _ = eng32.infer_batch({"input": reqs[:n32]})
        launched = subpixel_head.subpixel_head_fwd.launches - before
    if launched != 1:
        raise AssertionError(f"f32 check launched #6 {launched} times")
    diff = max_err(y_kernel, y_plain)
    print(f"facades serving: f32 (TF32 off) U-Net through #6 vs its plain "
          f"version on a batch of {n32}: max abs diff {diff:.3g} on the "
          f"tanh output (limit {SLICE_F32_TOL})")
    if not diff <= SLICE_F32_TOL:
        raise AssertionError(f"f32 facades diff {diff} > {SLICE_F32_TOL}")
    del eng32
    if profile:
        profile_forward(engine, reqs[:1])
    return counts, stats, latencies


def facades_train_phase(device, card, profile: bool):
    """The facades preset's training with the subpixel head: bf16 steps
    with dropout, their times, losses and launch counts (13 #5, one #6,
    one #7 per step), then the f32 kernels-vs-plain check."""
    from p2p_tpu_torch.core.dtypes import train_dtype
    from p2p_tpu_torch.data.synthetic import synthetic_facades_batch
    from p2p_tpu_torch.ops import norm
    from p2p_tpu_torch.ops.cuda import subpixel_head
    from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments_plain
    from p2p_tpu_torch.train.state import create_train_state
    from p2p_tpu_torch.train.step import build_train_step

    cfg = facades_config()
    h, w = cfg.image_hw
    m = cfg.model
    per_step = len(facades_bn_plan(m.ngf, h, w))
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    bs = cfg.data.batch_size
    host = synthetic_facades_batch(n_steps * bs, h, seed=SEED)
    batches = [{k: v[i * bs:(i + 1) * bs] for k, v in host.items()}
               for i in range(n_steps)]
    dtype = train_dtype(cfg.train.mixed_precision)
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, train_dtype=dtype)
    step = build_train_step(cfg, None, dtype)
    sizes = {k: sum(p.numel() for p in net.parameters()) for k, net in (
        ("G", state.net_g), ("D", state.net_d))}
    print(f"facades train: {h}x{w}, batch {bs}, {dtype}, ngf {m.ngf}, ndf "
          f"{m.ndf}, dropout {m.use_dropout}, subpixel head on #6/#7, "
          f"parameters {sizes}; built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    reset_launch_counts()
    times = []
    for i, batch in enumerate(batches):
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses = {k: float(metrics[k]) for k in FACADES_LOSS_KEYS}
        print(f"facades train: step {i + 1} {times[-1]:.2f} ms "
              f"{json.dumps(losses)}")
        if not all(np.isfinite(v) for v in losses.values()) \
                or float(metrics["health_ok"]) != 1.0:
            raise AssertionError(f"step {i + 1}: non-finite losses {losses}")
    counts = launch_counts()
    want = only(batch_moments=per_step * n_steps,
                subpixel_head_fwd=n_steps, subpixel_head_dx=n_steps)
    print(f"facades train: launches over {n_steps} steps: {counts} (want "
          f"{want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    timed = times[TRAIN_WARMUP:]
    med = statistics.median(timed)
    print(f"facades train: {TRAIN_STEPS} timed bf16 steps (after "
          f"{TRAIN_WARMUP} warm-up): median {med:.2f} ms/step, min "
          f"{min(timed):.2f}, max {max(timed):.2f}; {bs * 1e3 / med:.2f} "
          f"img/s; on {card}", flush=True)
    if profile:
        profile_call("facades train step", lambda: step(state, batches[0]))
    del state, step

    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  mixed_precision=False))
    plain = (mock.patch.object(norm, "batch_moments", batch_moments_plain),
             mock.patch.object(subpixel_head, "subpixel_head_fwd",
                               subpixel_head.subpixel_head_fwd_plain),
             mock.patch.object(subpixel_head, "subpixel_head_dx",
                               subpixel_head.subpixel_head_dx_plain))
    runs = {}
    with tf32_off():
        for route in ("kernel", "plain"):
            st = create_train_state(cfg32, SEED)
            stp = build_train_step(cfg32)
            before = launch_counts()
            with contextlib.ExitStack() as stack:
                if route == "plain":
                    for patch in plain:
                        stack.enter_context(patch)
                runs[route] = [{k: float(v) for k, v in stp(st, b)[1].items()}
                               for b in batches[:TRAIN_F32_STEPS]]
            launched = {k: launch_counts()[k] - before[k] for k in before}
            n = TRAIN_F32_STEPS if route == "kernel" else 0
            if launched != only(batch_moments=per_step * n,
                                subpixel_head_fwd=n, subpixel_head_dx=n):
                raise AssertionError(f"f32 {route} run launched {launched}")
    worst = 0.0
    for i, (lk, lp) in enumerate(zip(runs["kernel"], runs["plain"])):
        rtol = FACADES_STEP1_RTOL if i == 0 else FACADES_LATER_RTOL
        for k in FACADES_LOSS_KEYS:
            rel = abs(lk[k] - lp[k]) / abs(lp[k])
            worst = max(worst, rel)
            if not rel <= rtol:
                raise AssertionError(f"f32 facades step {i + 1} {k}: kernel "
                                     f"{lk[k]} vs plain {lp[k]} (rtol {rtol})")
    print(f"facades train: f32 (TF32 off) {TRAIN_F32_STEPS} steps through "
          f"#5/#6/#7 vs their plain versions, same dropout seed: losses max "
          f"rel diff {worst:.3g} (step 1 limit {FACADES_STEP1_RTOL}, later "
          f"{FACADES_LATER_RTOL})")
    return counts, med


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of one forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.ops.cuda import (
        batch_moments, build, instance_norm_kernel, norm_act, subpixel_head)

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.KERNELS:
        build.library(name)
    print(f"build: {built or 'all cached'}; {time.perf_counter() - t0:.1f}s "
          "wall", flush=True)

    cfg = get_preset("pix2pixhd")
    h, w = cfg.image_hw
    plan = epilogue_plan(cfg.model.ngf, cfg.model.n_blocks, 3, h, w)
    if len(plan) != NORMS_PER_FORWARD:
        raise AssertionError(f"plan has {len(plan)} epilogues")
    if sum(RUN_BATCHES) != N_REQUESTS or not set(RUN_BATCHES) <= set(BUCKETS):
        raise AssertionError("RUN_BATCHES must split the requests into buckets")
    ref = get_preset("reference")
    bn_plan = batchnorm_plan(ref.model.ngf, ref.model.n_blocks,
                             *ref.image_hw)
    fac = facades_config()
    fac_bn_plan = facades_bn_plan(fac.model.ngf, *fac.image_hw)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    bn_launches = collections.Counter()
    for shape in bn_plan + fac_bn_plan:
        bn_launches[shape] += steps
    head_fwd = main_path_forwards() + collections.Counter({1: steps})
    head_dx = collections.Counter({1: steps})
    rows = (kernel_phase(device, plan) + moments_phase(device, bn_launches)
            + subpixel_phase(device, head_fwd, head_dx))
    serve_counts, _, _ = slice_phase(device, card, args.profile)
    train_counts, _ = train_phase(device, card, args.profile)
    fac_serve_counts, _, _ = facades_serving_phase(device, card,
                                                   args.profile)
    fac_train_counts, _ = facades_train_phase(device, card, args.profile)
    counts = collections.Counter()
    for c in (serve_counts, train_counts, fac_serve_counts,
              fac_train_counts):
        counts.update(c)

    kernels = []
    for name, source, replaces in (
            ("instance_norm_stats", instance_norm_kernel.SOURCE,
             instance_norm_kernel.REPLACES),
            ("norm_act", norm_act.SOURCE, norm_act.REPLACES),
            ("batch_moments", batch_moments.SOURCE, batch_moments.REPLACES),
            ("subpixel_head_fwd", subpixel_head.SOURCE,
             subpixel_head.REPLACES_FWD),
            ("subpixel_head_dx", subpixel_head.SOURCE,
             subpixel_head.REPLACES_DX)):
        tot = totals(rows, name)
        if tot["launches"] != counts[name]:
            raise AssertionError(f"{name}: timed rows cover {tot['launches']} "
                                 f"launches, the main paths made "
                                 f"{counts[name]}")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces.split(" ")[0],
            "launches": counts[name], "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"]})
    bf16 = {(r["kernel"], r["n"], tuple(r["shape"])): r for r in rows
            if r["dtype"] == "bfloat16" and r["kernel"] in (
                "batch_moments", "subpixel_head_fwd", "subpixel_head_dx")}
    for what, kernel, keys in (
            ("#5 per reference train step", "batch_moments",
             [(1, shape) for shape in bn_plan]),
            ("#5 per facades train step", "batch_moments",
             [(1, shape) for shape in fac_bn_plan]),
            ("#6 per facades forward at N=1", "subpixel_head_fwd",
             [(1, (128, 128, 128))]),
            ("#7 per facades train step", "subpixel_head_dx",
             [(1, (128, 128, 128))])):
        sel = [bf16[(kernel,) + key] for key in keys]
        print(f"{what} (bf16, {len(sel)} launches): " + ", ".join(
            f"{k} {sum(r[k] for r in sel):.4f}" for k in (
                "ms", "bound_ms", "plain_ms", "library_ms")))
    print("per-kernel numbers are the main paths' bf16 launches (#1, #3: "
          f"pix2pixHD serving at {h}x{w}; #5: {steps} reference and {steps} "
          f"facades train steps at 256x256; #6: facades serving and "
          f"training; #7: facades training): per-(N, shape, form) device "
          "times weighted by launches")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
