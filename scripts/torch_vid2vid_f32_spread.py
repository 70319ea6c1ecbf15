"""The spread of ``chip_smoke.py``'s video f32 check over seeds, on one
CUDA card: for each seed, one f32 (TF32 off, cuDNN deterministic) train
step of ``vid2vid_temporal`` with ``pallas_instance`` norms in the U-Net
and the spatial D (``chip_smoke.vid_kernel_config``, full width, 8 frames
of 256²) from the state and a synthetic clip made from that seed, with
the instance norms through kernels #1, #2 and #3, through their plain
versions, and through the plain versions with #1's sums in f64 rounded
once (``chip_smoke.vid_f32_routes``). Prints, per seed and as the largest
over the seeds, each route's relative difference against the plain route
of every loss of ``chip_smoke.VID_LOSS_KEYS``, then the card's name and
power limit. ``chip_smoke.VID_F32_RTOL`` is set from it. Run from the root
of the checkout:

    python3 scripts/torch_vid2vid_f32_spread.py [n_seeds]
"""

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
cfg = chip_smoke.vid_kernel_config()
worst = {}
with tempfile.TemporaryDirectory(prefix="vid_spread_") as tmp:
    for seed in range(n_seeds):
        batch = chip_smoke.vid_clips(tmp, cfg, 1, seed)[0]
        runs = chip_smoke.vid_f32_routes(cfg, batch, seed,
                                         ("kernel", "plain", "f64"))
        row = {"seed": seed}
        for route in ("kernel", "f64"):
            rels = {k: abs(runs[route][k] - runs["plain"][k])
                    / abs(runs["plain"][k]) for k in chip_smoke.VID_LOSS_KEYS}
            row[route] = rels
            big = worst.setdefault(route, dict.fromkeys(rels, 0.0))
            for k, rel in rels.items():
                big[k] = max(big[k], rel)
        print(json.dumps(row), flush=True)
print(json.dumps({"largest": worst}))
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip())
