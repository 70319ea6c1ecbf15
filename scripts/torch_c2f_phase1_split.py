"""Splits the phase-1 ms/step that ``chip_smoke.py``'s coarse-to-fine
phase reads from ``cli.train --preset pix2pixhd --phase global``, on one
CUDA card. From 4 pairs of 512x1024 cut out of synthetic 1024² sources
as that phase cuts them, it times:

- the loader's host time per pair (``PairedImageDataset[i]``, no memo):
  at phase 1's 256x512, PNG decode and bicubic resize, and at the full
  512x1024, PNG decode alone; median over 3 reads of each pair;
- the G1 (``pix2pixhd_global``) bf16 train step alone at 256x512 on
  batches already loaded: median, min and max of 8 steps after 2 warm-up
  steps (host clock around ``step`` + ``torch.cuda.synchronize()``).

Then prints the card's name and power limit. Run from the root of the
checkout:

    python3 scripts/torch_c2f_phase1_split.py
"""

import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from p2p_tpu_torch.cli import generate_dataset  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.core.dtypes import train_dtype  # noqa: E402
from p2p_tpu_torch.data.pipeline import PairedImageDataset  # noqa: E402
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from p2p_tpu_torch.train.graft import g1_phase_config  # noqa: E402
from p2p_tpu_torch.train.state import (  # noqa: E402
    create_train_state, load_vgg19)
from p2p_tpu_torch.train.step import build_train_step  # noqa: E402

N_PAIRS, READS, WARMUP, STEPS = 4, 3, 2, 8


def read_ms(ds):
    times = []
    for _ in range(READS):
        for i in range(len(ds)):
            t = time.perf_counter()
            ds[i]
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


full = get_preset("pix2pixhd")
cfg = g1_phase_config(full)
dtype = train_dtype(cfg.train.mixed_precision)
ds_dtype = "uint8" if cfg.data.uint8_pipeline else "float32"
with tempfile.TemporaryDirectory(prefix="c2f_split_") as tmp:
    src, data = os.path.join(tmp, "src"), os.path.join(tmp, "data")
    make_synthetic_dataset(src, N_PAIRS, 0, size=1024, seed=0)
    if generate_dataset.main([
            "--dataset_path", os.path.join(src, "train", "a"),
            "--target_dataset_folder", data, "--split", "train",
            "--crop_size", "512", "--crop_width", "1024",
            "--max_patches", "1"]):
        raise SystemExit("generate_dataset failed")
    sets = {c.data.image_size: PairedImageDataset(
        data, "train", c.data.direction, c.data.image_size,
        c.data.image_width, cache=False, dtype=ds_dtype)
        for c in (cfg, full)}
    phase1 = sets[cfg.data.image_size]
    ms = {size: read_ms(ds) for size, ds in sets.items()}
    items = [phase1[i] for i in range(len(phase1))]
batches = [{k: v[None] for k, v in items[i % len(items)].items()}
           for i in range(WARMUP + STEPS)]
vgg = (load_vgg19(device=torch.device("cuda"),
                  imagenet_norm=cfg.loss.vgg_imagenet_norm)
       if cfg.loss.lambda_vgg > 0 else None)
state = create_train_state(cfg, cfg.train.seed, len(items), dtype)
step = build_train_step(cfg, vgg, dtype)
times = []
for b in batches:
    t = time.perf_counter()
    state, m = step(state, b)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t) * 1e3)
timed = times[WARMUP:]
if not np.isfinite(float(m["loss_g"])):
    raise SystemExit(f"loss_g {float(m['loss_g'])}")
h, w = cfg.image_hw
print(f"loader per pair: {ms[cfg.data.image_size]:.3f} ms at {h}x{w} "
      f"(decode + bicubic resize), {ms[full.data.image_size]:.3f} ms at "
      f"{full.image_hw[0]}x{full.image_hw[1]} (decode); G1 step alone at "
      f"{h}x{w}, {dtype}: median {statistics.median(timed):.3f} ms min "
      f"{min(timed):.3f} max {max(timed):.3f}", flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip())
