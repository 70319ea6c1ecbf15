"""The spread of ``chip_smoke.py``'s ``edges2shoes_dp`` f32 check over
seeds, on one CUDA card: for each seed, 2 f32 (TF32 off, cuDNN
deterministic) train steps of the preset at 256², batch 64, from the
state and synthetic batches made from that seed, with BatchNorm's moments
through kernel #5, through its plain version and through the same
function summed in f64 and rounded once (``chip_smoke.e2s_f32_routes``).
Prints, per seed and as the largest over the seeds, each route's relative
difference against the plain route of every loss of
``chip_smoke.FACADES_LOSS_KEYS`` at step 1 and at step 2, then the card's
name and power limit. ``chip_smoke.E2S_STEP1_RTOL`` and
``E2S_LATER_RTOL`` are set from it. Run from the root of the checkout:

    python3 scripts/torch_edges2shoes_f32_spread.py [n_seeds]
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402

n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
cfg = get_preset("edges2shoes_dp")
worst = {}
for seed in range(n_seeds):
    batches = chip_smoke.e2s_batches(cfg, chip_smoke.TRAIN_F32_STEPS, seed)
    runs = chip_smoke.e2s_f32_routes(cfg, batches, seed,
                                     ("kernel", "plain", "f64"))
    row = {"seed": seed}
    for route in ("kernel", "f64"):
        for i, (lk, lp) in enumerate(zip(runs[route], runs["plain"])):
            key = f"{route} step {i + 1}"
            rels = {k: abs(lk[k] - lp[k]) / abs(lp[k])
                    for k in chip_smoke.FACADES_LOSS_KEYS}
            row[key] = rels
            big = worst.setdefault(key, dict.fromkeys(rels, 0.0))
            for k, rel in rels.items():
                big[k] = max(big[k], rel)
    print(json.dumps(row), flush=True)
print(json.dumps({"largest": worst}))
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip())
