"""The spread of the fused ``facades_int8`` path's f32 kernels-vs-plain
check over seeds, on one CUDA card: for each seed, 2 f32 (TF32 off) train
steps at 256² from the state and synthetic batches made from that seed,
through every kernel, with #1 on its plain version, with #1 and #5 on
theirs, and through every plain version (``chip_smoke.int8_f32_routes``),
once with cuDNN's deterministic algorithms (as ``chip_smoke.py`` runs its
check) and once with its default choice. Prints each route's largest
relative loss difference against the plain route at step 1 and at step 2,
the elements of q that differ from the plain route's at each #4 call of
step 1, and the card's name and power limit. Run from the root of the
checkout:

    python3 scripts/torch_int8_f32_spread.py [n_seeds]
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_facades_batch  # noqa: E402

n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip())
cfg = chip_smoke.int8_config()
h = cfg.image_hw[0]
for deterministic in (True, False):
    worst = {}
    for seed in range(n_seeds):
        host = synthetic_facades_batch(2, h, seed=seed)
        batches = [{k: v[i:i + 1] for k, v in host.items()}
                   for i in range(2)]
        runs, flips = chip_smoke.int8_f32_routes(cfg, batches, seed,
                                                 deterministic)
        row = {"deterministic": deterministic, "seed": seed,
               "q_flips_step1": flips}
        for route in ("kernel", "#1 plain", "#1 #5 plain"):
            for i, (lk, lp) in enumerate(zip(runs[route], runs["plain"])):
                rel = max(abs(lk[k] - lp[k]) / abs(lp[k])
                          for k in chip_smoke.FACADES_LOSS_KEYS)
                row[f"{route} step {i + 1}"] = rel
                worst[route, i] = max(worst.get((route, i), 0.0), rel)
        print(json.dumps(row), flush=True)
    print(json.dumps({"deterministic": deterministic, "largest": {
        f"{route} step {i + 1}": v for (route, i), v in worst.items()}}),
        flush=True)
