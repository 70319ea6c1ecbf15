#!/usr/bin/env python3
"""Device time per launch of kernels #1 (instance-norm statistics) and #6
(the subpixel head's forward) from one checkout of the port, at the main
paths' bf16 shapes, with a cold and with a warm L2 cache.

    python3 scripts/torch_kernel_times.py <checkout> [out.json]

Imports ``p2p_tpu_torch`` from ``<checkout>`` (so two trees are compared
by running this once per tree in one call on one card: A, B, B, A) and
times ``instance_norm_stats(x)`` at every (N, H, W, C) of the main paths
and ``subpixel_head_fwd(x, w)`` at the facades head (x N×128×128×128, F4 =
12, N = 1, 2, 4). Cold: chip_smoke.py's Timer (the L2 cache evicted
before every run, median of 20). Warm: the same without the eviction, so
x is in L2 as it is right after the conv that wrote it on the main path.
Prints and writes one JSON object; needs a card.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stats_launches(smoke):
    """{(N, H, W, C): launches of #1 on the main paths}, as chip_smoke.py
    (the module ``smoke``) counts them."""
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
    out = collections.Counter()
    for (n, hh, ww, c, _), count in norms.items():
        out[(n, hh, ww, c)] += count
    return out


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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(argv[1])
    sys.path.insert(0, tree)
    from p2p_tpu_torch.ops.cuda.instance_norm_kernel import \
        instance_norm_stats
    from p2p_tpu_torch.ops.cuda.subpixel_head import subpixel_head_fwd

    smoke = _module("smoke_here", os.path.join(HERE, "chip_smoke.py"))
    device = torch.device("cuda")
    timer = smoke.Timer(device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = {"tree": tree, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), "stats": {}, "head": {}}
    launches = stats_launches(smoke)
    for key in sorted(launches):
        n, h, w, c = key
        x = smoke.make_input(gen, n, c, h, w, torch.bfloat16, device)
        out["stats"]["x".join(map(str, key))] = {
            "launches": launches[key],
            "cold_us": timer(lambda: instance_norm_stats(x)) * 1e3,
            "warm_us": warm_ms(lambda: instance_norm_stats(x)) * 1e3}
    wt = (torch.randn((2, 2, 128, 12), generator=gen, device=device)
          * 0.05).to(torch.bfloat16)
    for n in (1, 2, 4):
        x = smoke.make_input(gen, n, 128, 128, 128, torch.bfloat16, device)
        out["head"][str(n)] = {
            "cold_us": timer(lambda: subpixel_head_fwd(x, wt)) * 1e3,
            "warm_us": warm_ms(lambda: subpixel_head_fwd(x, wt)) * 1e3}
    text = json.dumps(out)
    print(text)
    if len(argv) > 2:
        with open(argv[2], "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
