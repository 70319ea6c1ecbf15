#!/usr/bin/env python3
"""Drive the p2p_tpu_torch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # one card; exits 0 only if all passes
    python3 chip_smoke.py --profile  # also prints a torch.profiler table

Phases, each of which fails the run (nothing is caught, nothing falls back
to the CPU or to a plain version):

1. device and build: the card's name and power limit (nvidia-smi), then the
   port's CUDA kernels built from the sources in this checkout;
2. kernels: at every epilogue shape of the full-width pix2pixHD generator
   at each batch size the main path serves (N = 1, 2, 4), in bf16 and f32,
   with each activation/residual form the path uses) each kernel is held
   against its plain PyTorch version on the card and timed
   with CUDA events (median of 20 cold-L2 runs) beside its plain version,
   a PyTorch library yardstick and its bound from bytes and operations;
3. slice: the full-width pix2pixHD generator (random weights from a seed)
   served through ``InferenceEngine`` in bf16 on synthetic 512×1024
   requests; the kernel launch counts of that run must be exactly 36 + 36
   per forward batch; the f32 generator through the kernels must match the
   f32 generator through the plain versions within 1e-3 on a batch of 4;
4. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
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
EPILOGUES_PER_FORWARD = 36
# published H100 SXM peaks: HBM3 bytes/s and non-tensor-core f32 flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# kernel vs plain version: f32 differs only in the order of partial sums;
# bf16 outputs may differ by one rounding of the stored value
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0 ** -7)}
STATS_TOL = (1e-4, 1e-4)   # (atol, rtol): f32 outputs from either input type
SLICE_F32_TOL = 1e-3
TIMING_REPS = 20


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


def bound_ms(nbytes: int, flops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            b, by = bound_ms(numel * elt + 2 * n * c * 4, 3 * numel)
            rows.append(dict(
                kernel="instance_norm_stats", dtype=str(dtype)[6:], n=n,
                shape=(h, w, c), form="-", per_forward=per_shape[(h, w, c)],
                max_abs_err=max(max_err(mean, pmean), max_err(rstd, prstd)),
                ms=timer(lambda: instance_norm_stats(x)),
                plain_ms=timer(lambda: instance_norm_stats_plain(x)),
                library_ms=timer(lambda: torch.var_mean(
                    x, dim=(2, 3), correction=0)),
                bound_ms=b, bound_by=by))
            for (fh, fw, fc, act, has_res), n_form in sorted(per_form.items()):
                if (fh, fw, fc) != (h, w, c):
                    continue
                r = make_input(gen, n, c, h, w, dtype, device) if has_res \
                    else None
                y = norm_act(x, pmean, prstd, residual=r, act=act)
                py = norm_act_plain(x, pmean, prstd, residual=r, act=act)
                form = act + ("+residual" if has_res else "")
                assert_close(f"norm_act {where} {form}", y, py, atol, rtol)
                b, by = bound_ms(numel * elt * (3 if has_res else 2)
                                 + 2 * n * c * 4, 5 * numel)
                rows.append(dict(
                    kernel="norm_act", dtype=str(dtype)[6:], n=n,
                    shape=(h, w, c), form=form, per_forward=n_form,
                    max_abs_err=max_err(y, py),
                    ms=timer(lambda: norm_act(x, pmean, prstd, residual=r,
                                              act=act)),
                    plain_ms=timer(lambda: norm_act_plain(
                        x, pmean, prstd, residual=r, act=act)),
                    library_ms=timer(lambda: F.instance_norm(x)),
                    bound_ms=b, bound_by=by))
    print("kernel phase (device ms, median of "
          f"{TIMING_REPS} cold-L2 runs; tolerance passed):")
    for row in rows:
        print("  " + json.dumps(row))
    return rows


def totals(rows, kernel, dtype="bfloat16"):
    """A kernel's launches on the main path at the serving dtype: each
    (N, shape, form) time weighted by how often the main path launched it."""
    forwards = main_path_forwards()
    sel = [(r, r["per_forward"] * forwards[r["n"]]) for r in rows
           if r["kernel"] == kernel and r["dtype"] == dtype]
    out = {k: sum(r[k] * m for r, m in sel)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["launches"] = sum(m for _, m in sel)
    out["max_abs_err"] = max(r["max_abs_err"] for r, _ in sel)
    by = collections.Counter()
    for r, m in sel:
        by[r["bound_by"]] += r["bound_ms"] * m
    out["bound_by"] = by.most_common(1)[0][0]
    return out


def launch_counts():
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import instance_norm_stats
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act

    return {"instance_norm_stats": instance_norm_stats.launches,
            "norm_act": norm_act.launches}


def reset_launch_counts():
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import instance_norm_stats
    from p2p_tpu_torch.ops.cuda.norm_act import norm_act

    instance_norm_stats.launches = 0
    norm_act.launches = 0


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
    want = EPILOGUES_PER_FORWARD * n_forwards
    print(f"slice: launches over {n_forwards} forward batches: {counts} "
          f"(want {want} each)")
    if any(v != want for v in counts.values()):
        raise AssertionError(f"launch counts {counts} != {want} each")
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n32 = max(BUCKETS)
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
    if any(mid[k] - before[k] != EPILOGUES_PER_FORWARD for k in mid) \
            or after != mid:
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


def profile_forward(engine, batch):
    """torch.profiler over one bf16 bucket-1 forward: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.infer_batch({"input": batch})
        engine.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of one forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from p2p_tpu_torch.core.config import get_preset
    from p2p_tpu_torch.ops.cuda import build, instance_norm_kernel, norm_act

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
        build.load(name)
    print(f"build: {built or 'all cached'}; {time.perf_counter() - t0:.1f}s "
          "wall", flush=True)

    cfg = get_preset("pix2pixhd")
    h, w = cfg.image_hw
    plan = epilogue_plan(cfg.model.ngf, cfg.model.n_blocks, 3, h, w)
    if len(plan) != EPILOGUES_PER_FORWARD:
        raise AssertionError(f"plan has {len(plan)} epilogues")
    if sum(RUN_BATCHES) != N_REQUESTS or not set(RUN_BATCHES) <= set(BUCKETS):
        raise AssertionError("RUN_BATCHES must split the requests into buckets")
    rows = kernel_phase(device, plan)
    counts, _, _ = slice_phase(device, card, args.profile)

    kernels = []
    for name, mod in (("instance_norm_stats", instance_norm_kernel),
                      ("norm_act", norm_act)):
        tot = totals(rows, name)
        if tot["launches"] != counts[name]:
            raise AssertionError(f"{name}: timed rows cover {tot['launches']} "
                                 f"launches, the main path made {counts[name]}")
        kernels.append({
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES.split(" ")[0],
            "launches": counts[name], "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"]})
    print("per-kernel numbers are the main path's bf16 launches at "
          f"{h}x{w}: per-(N, shape, form) device times weighted by launches")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
