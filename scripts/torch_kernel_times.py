#!/usr/bin/env python3
"""Device time per launch of the port's norm and moments kernels and of the
subpixel head's forward and input gradient, from one checkout, at the
main paths' bf16 shapes, with a cold and with a warm L2 cache; and the
comparison of such runs.

    python3 scripts/torch_kernel_times.py <checkout> [out.json]
    python3 scripts/torch_kernel_times.py --compare a1.json b1.json \\
        b2.json a2.json

Imports ``p2p_tpu_torch`` from ``<checkout>`` (so two trees are compared
by running this once per tree in one call on one card: A, B, B, A) and
times, each at every shape and form the main paths launch it with (the
launch counts chip_smoke.py's main paths make):
- #1 ``instance_norm_stats(x)`` at every (N, H, W, C);
- #3 ``norm_act``, #2 ``instance_norm_apply`` and #4 ``norm_act_quant``
  at every (N, H, W, C, form) of chip_smoke.py's kernel phase, given the
  plain statistics, each beside a yardstick that moves the same bytes in
  one PyTorch elementwise kernel (``y.copy_(x)``, or ``torch.add(x, r,
  out=y)`` where the form reads a residual); each also as a site, #1 then
  the kernel (with its residual), as ``ops/instance_norm.py`` launches
  them (with ``x_ready=True`` where the tree's wrapper takes it);
- #5 ``batch_moments`` at every (M, C) of the reference, facades, path A
  and facades_int8 train steps, beside one read of the same bytes by
  PyTorch's reduction (``x.sum(dtype=torch.float32)``);
- #6 ``subpixel_head_fwd(x, w)`` and #7 ``subpixel_head_dx(dz, w)`` at
  the facades head (x N×128×128×128, dz N×12×129×129 f32, F4 = 12, N = 1,
  2, 4), #6 beside ``F.conv2d``, #7 beside ``torch.nn.grad.conv2d_input``
  and beside a yardstick of about its bytes in one PyTorch kernel (dx's
  4.19 MB a sample written in bf16 from an f32 read of one value per 8
  channels, 1.05 MB a sample, against #7's 0.80 MB of dz);
- the timer's floor: one and two ``torch.cuda._sleep(1)`` launches;
- with ``torch.profiler``, #5's launches at (4096, 128) and (65536, 64),
  #6 and #7 at N = 1, and the sites of #2 at 1×256×256×32, #4 at 1×65×65×128 and #3 at
  1×64×64×128 relu+residual and 1×256×512×64 relu: each kernel's mean
  device µs (#1's pass 1 and finalize apart) and the span from the first
  one's start to the last one's end (cold L2; a dependent launch that
  starts before the launch it follows has ended shows as a span shorter
  than the sum).
Cold: chip_smoke.py's Timer (the L2 cache evicted before every run,
median of 20). Warm: the same without the eviction, so the inputs are in
L2 as they are right after the op that wrote them on the main path.
Prints and writes one JSON object; needs a card.

``--compare`` reads such files (the order of the runs in the call) and
prints, for each kernel (#6 and #7 weighted by their launches on the main
paths, so N = 2 and 4 count 0 for #7) and for the sites of #2, #3 and #4, the
launch-weighted sum of cold and warm µs of each run, each shape's times
and the first run's yardstick, and every shape whose time in a later tree
is more than 3% above its time in the first file's tree (runs of one tree
averaged).
"""

from __future__ import annotations

import collections
import importlib.util
import inspect
import json
import os
import re
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_SHAPES = ((4096, 128), (65536, 64))
PROFILE_SITES = ("1x256x256x32 apply", "1x65x65x128 leaky+quant",
                 "1x64x64x128 relu+residual", "1x256x512x64 relu")


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def norm_launches(smoke):
    """{(N, H, W, C, form): launches of #2 ("apply"), #4 ("+quant") or #3
    (the other forms) on the main paths}, as chip_smoke.py (the module
    ``smoke``) counts them."""
    from p2p_tpu_torch.core.config import get_preset

    cfg = get_preset("pix2pixhd")
    h, w = cfg.image_hw
    plan = smoke.epilogue_plan(cfg.model.ngf, cfg.model.n_blocks, 3, h, w)
    a_plan = smoke.path_a_step_plan(smoke.instance_config())
    steps = smoke.TRAIN_WARMUP + smoke.TRAIN_STEPS
    hd_steps = smoke.HD_TRAIN_WARMUP + smoke.HD_TRAIN_STEPS
    norms = smoke.instance_launches(plan, a_plan, steps, hd_steps)
    for hh, ww, c, form in 2 * smoke.int8_d_plan(smoke.int8_config()):
        norms[(1, hh, ww, c, form)] += steps
    return norms


def stats_launches(smoke):
    """{(N, H, W, C): launches of #1 on the main paths}: one before each
    norm epilogue."""
    out = collections.Counter()
    for (n, hh, ww, c, _), count in norm_launches(smoke).items():
        out[(n, hh, ww, c)] += count
    return out


def moments_launches(smoke):
    """{(M, C): launches of #5 on the main paths}, as chip_smoke.py counts
    them: the reference, facades and path A (net_c's BatchNorm twice)
    train steps, the fused facades_int8 steps and those of the preset as
    it is."""
    from p2p_tpu_torch.core.config import get_preset

    ref = get_preset("reference")
    fac = smoke.facades_config()
    i8 = smoke.int8_config()
    steps = smoke.TRAIN_WARMUP + smoke.TRAIN_STEPS
    out = collections.Counter()
    for shape in (smoke.batchnorm_plan(ref.model.ngf, ref.model.n_blocks,
                                       *ref.image_hw)
                  + smoke.facades_bn_plan(fac.model.ngf, *fac.image_hw)
                  + [(ref.image_hw[0] * ref.image_hw[1], 64)] * 2):
        out[shape] += steps
    for shape in smoke.facades_bn_plan(i8.model.ngf, *i8.image_hw):
        out[shape] += steps + smoke.INT8_AS_IS_STEPS
    return out


def head_launches(smoke):
    """({N: launches of #6}, {N: launches of #7}) on the main paths, as
    chip_smoke.py counts them: #6 once a facades forward (serving at N =
    1, 2, 4 and each facades train step), #7 once a facades train step."""
    steps = smoke.TRAIN_WARMUP + smoke.TRAIN_STEPS
    fwd = smoke.main_path_forwards() + collections.Counter({1: steps})
    return fwd, collections.Counter({1: steps})


def warm_ms(fn, reps: int = 20) -> float:
    """Device ms of ``fn`` with its inputs left in L2 by the runs before."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def both(timer, fn):
    return {"cold_us": timer(fn) * 1e3, "warm_us": warm_ms(fn) * 1e3}


def kernel_spans(timer, fn, reps: int = 20):
    """torch.profiler over ``reps`` cold-L2 runs of ``fn``: the mean device
    µs of each kernel ``fn`` launches, and of the span from the first
    kernel's start to the last one's end; None where the profiler shows
    no device kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            torch.cuda._sleep(2_000_000)
            fn()
        torch.cuda.synchronize()
    skip = ("spin_kernel", "elementwise", "Fill", "Memset", "memset")
    kernels = sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not any(s in e.name for s in skip)),
        key=lambda e: e.time_range.start)
    if not kernels or len(kernels) % reps:
        return None
    per = len(kernels) // reps
    out = {"kernels": per, "span_us": statistics.mean(
        kernels[i + per - 1].time_range.end - kernels[i].time_range.start
        for i in range(0, len(kernels), per))}
    for j in range(per):
        runs = kernels[j::per]
        name = re.search(r"(\w+)\s*[<(]", runs[0].name.replace(
            "(anonymous namespace)", ""))
        out[name.group(1) if name else runs[0].name] = statistics.mean(
            e.time_range.end - e.time_range.start for e in runs)
    return out


def _site(stats, kernel, x, **kw):
    """#1 then ``kernel`` on x, as ops/instance_norm.py launches them:
    ``x_ready=True`` where the tree's wrapper takes it (x read before the
    dependent launch's wait)."""
    if "x_ready" in inspect.signature(kernel).parameters:
        kw["x_ready"] = True

    def run():
        mean, rstd = stats(x)
        kernel(x, mean, rstd, **kw)

    return run


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    from p2p_tpu_torch.ops.cuda.batch_moments import batch_moments
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (
        instance_norm_apply, instance_norm_stats, instance_norm_stats_plain)
    from p2p_tpu_torch.ops.cuda.norm_act import (norm_act, norm_act_quant,
                                                 norm_act_quant_plain)
    from p2p_tpu_torch.ops.cuda.subpixel_head import (subpixel_head_dx,
                                                      subpixel_head_fwd)

    smoke = _module("smoke_here", os.path.join(HERE, "chip_smoke.py"))
    device = torch.device("cuda")
    timer = smoke.Timer(device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = {"tree": tree, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), "floor": {}, "stats": {}, "norm": {},
        "moments": {}, "head": {}, "head_dx": {}, "profile": {}}
    out["floor"]["sleep1"] = both(timer, lambda: torch.cuda._sleep(1))
    out["floor"]["sleep1x2"] = both(
        timer, lambda: (torch.cuda._sleep(1), torch.cuda._sleep(1)))
    launches = stats_launches(smoke)
    for key in sorted(launches):
        n, h, w, c = key
        x = smoke.make_input(gen, n, c, h, w, torch.bfloat16, device)
        out["stats"]["x".join(map(str, key))] = {
            "launches": launches[key],
            **both(timer, lambda: instance_norm_stats(x))}
    norms = norm_launches(smoke)
    for key in sorted(norms):
        n, h, w, c, form = key
        x = smoke.make_input(gen, n, c, h, w, torch.bfloat16, device)
        mean, rstd = instance_norm_stats_plain(x)
        if form == "apply":
            kernel, fn = "instance_norm_apply", (
                lambda: instance_norm_apply(x, mean, rstd))
            site = _site(instance_norm_stats, instance_norm_apply, x)
        elif form.endswith("+quant"):
            act = form.split("+")[0]
            sx = norm_act_quant_plain(
                x, mean, rstd, sx=torch.ones((), device=device),
                act=act)[1] / 127.0
            kernel, fn = "norm_act_quant", (
                lambda: norm_act_quant(x, mean, rstd, sx=sx, act=act))
            site = _site(instance_norm_stats, norm_act_quant, x, sx=sx,
                         act=act)
        else:
            act, _, res = form.partition("+")
            r = smoke.make_input(gen, n, c, h, w, torch.bfloat16, device) \
                if res else None
            kernel, fn = "norm_act", (
                lambda: norm_act(x, mean, rstd, residual=r, act=act))
            site = _site(instance_norm_stats, norm_act, x, residual=r,
                         act=act)
        # the same bytes moved by one PyTorch elementwise kernel: a copy
        # (an add where the form reads a residual)
        y = torch.empty_like(x)
        copy = (lambda: torch.add(x, r, out=y)) if form.endswith(
            "residual") else (lambda: y.copy_(x))
        name = f"{'x'.join(map(str, key[:4]))} {form}"
        out["norm"][name] = {
            "kernel": kernel, "launches": norms[key], **both(timer, fn),
            "copy": both(timer, copy), "site": both(timer, site)}
        if name in PROFILE_SITES:
            out["profile"][f"site {name}"] = kernel_spans(timer, site)
    moments = moments_launches(smoke)
    for m, c in sorted(moments):
        x = (torch.randn((m, c), generator=gen, device=device)
             + torch.linspace(-2.0, 2.0, c, device=device)).to(
                 torch.bfloat16)
        # one read of the same bytes by PyTorch's reduction kernel
        out["moments"][f"{m}x{c}"] = {
            "launches": moments[(m, c)],
            **both(timer, lambda: batch_moments(x)),
            "sum": both(timer, lambda: x.sum(dtype=torch.float32))}
        if (m, c) in PROFILE_SHAPES:
            out["profile"][f"{m}x{c}"] = kernel_spans(
                timer, lambda: batch_moments(x))
    fwd_launches, dx_launches = head_launches(smoke)
    c, f4 = 128, 12
    wt = (torch.randn((2, 2, c, f4), generator=gen, device=device)
          * 0.05).to(torch.bfloat16)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous()
    for n in (1, 2, 4):
        x = smoke.make_input(gen, n, c, 128, 128, torch.bfloat16, device)
        dz = smoke.make_input(gen, n, f4, 129, 129, torch.float32, device)
        dz_in = dz.to(torch.bfloat16)
        out["head"][str(n)] = {
            "launches": fwd_launches[n],
            **both(timer, lambda: subpixel_head_fwd(x, wt)),
            "library": both(timer, lambda: torch.nn.functional.conv2d(
                x, w_oihw, padding=1))}
        # dx's bytes written in bf16 from one f32 read per 8 channels
        y = torch.empty(x.numel() // 8, 8, dtype=torch.bfloat16,
                        device=device)
        src = torch.randn((x.numel() // 8, 1), generator=gen, device=device)
        out["head_dx"][str(n)] = {
            "launches": dx_launches[n],
            **both(timer, lambda: subpixel_head_dx(dz, wt)),
            "copy": both(timer, lambda: y.copy_(src.expand(-1, 8))),
            "library": both(timer, lambda: torch.nn.grad.conv2d_input(
                x.shape, w_oihw, dz_in, padding=1))}
        if n == 1:
            out["profile"]["head N=1"] = kernel_spans(
                timer, lambda: subpixel_head_fwd(x, wt))
            out["profile"]["head_dx N=1"] = kernel_spans(
                timer, lambda: subpixel_head_dx(dz, wt))
    return out


def _groups(run):
    """{kernel: {shape key: row}} of one run's rows that carry launches."""
    out = collections.defaultdict(dict)
    for key, row in run["stats"].items():
        out["instance_norm_stats"][key] = row
    for key, row in run["norm"].items():
        out[row["kernel"]][key] = row
        out[f"{row['kernel']} site (#1 then it)"][key] = {
            "launches": row["launches"], **row["site"]}
    for key, row in run["moments"].items():
        out["batch_moments"][key] = row
    for key, row in run["head"].items():
        out["subpixel_head_fwd"][f"N={key}"] = row
    for key, row in run["head_dx"].items():
        out["subpixel_head_dx"][f"N={key}"] = row
    return out


def compare(paths) -> int:
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append(json.load(f))
    groups = [_groups(r) for r in runs]
    base = runs[0]["tree"]
    print(f"card: {runs[0]['card']}")
    print("runs: " + ", ".join(os.path.basename(r["tree"].rstrip("/"))
                               or r["tree"] for r in runs))
    print("floor (one, two _sleep(1)), cold/warm us: " + "; ".join(
        f"{r['floor']['sleep1']['cold_us']:.2f}/"
        f"{r['floor']['sleep1']['warm_us']:.2f}, "
        f"{r['floor']['sleep1x2']['cold_us']:.2f}/"
        f"{r['floor']['sleep1x2']['warm_us']:.2f}" for r in runs))
    for kernel in sorted(groups[0]):
        sums = [{k: sum(row[k] * row["launches"] for row in g[kernel].values())
                 / 1e3 for k in ("cold_us", "warm_us")} for g in groups]
        launches = sum(row["launches"] for row in groups[0][kernel].values())
        print(f"{kernel} ({launches} launches) cold ms: "
              + " ".join(f"{s['cold_us']:.4f}" for s in sums)
              + "; warm ms: " + " ".join(f"{s['warm_us']:.4f}" for s in sums))
        for key in sorted(groups[0][kernel]):
            row = groups[0][kernel][key]
            yard = row.get("copy") or row.get("sum")
            lib = row.get("library")
            print(f"  {key} ({row['launches']}): cold "
                  + " ".join(f"{g[kernel][key]['cold_us']:.2f}"
                             for g in groups) + " | warm "
                  + " ".join(f"{g[kernel][key]['warm_us']:.2f}"
                             for g in groups)
                  + (f" | yardstick {yard['cold_us']:.2f} cold, "
                     f"{yard['warm_us']:.2f} warm" if yard else "")
                  + (f" | library {lib['cold_us']:.2f} cold, "
                     f"{lib['warm_us']:.2f} warm" if lib else ""))
            mean = collections.defaultdict(list)
            for r, g in zip(runs, groups):
                mean[r["tree"]].append(g[kernel][key])
            ref = {k: statistics.mean(row[k] for row in mean[base])
                   for k in ("cold_us", "warm_us")}
            for tree, rows in mean.items():
                if tree == base:
                    continue
                for k in ("cold_us", "warm_us"):
                    got = statistics.mean(row[k] for row in rows)
                    if got > 1.03 * ref[k]:
                        print(f"  slower: {key} {k} {got:.2f} against "
                              f"{ref[k]:.2f}")
    for r in runs:
        print(f"profile {r['tree']}: {json.dumps(r['profile'])}")
    return 0


def main(argv) -> int:
    if len(argv) > 1 and argv[1] == "--compare":
        return compare(argv[2:])
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    out = measure(os.path.abspath(argv[1]))
    text = json.dumps(out)
    print(text)
    if len(argv) > 2:
        with open(argv[2], "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
