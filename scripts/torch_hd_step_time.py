"""Times the port's ``pix2pixhd`` bf16 train step at 1024x512 on one CUDA
card, for the checkout whose root is given as the first argument: the
median, min and max of 8 steps after 2 warm-up steps (host clock around
``step`` + ``torch.cuda.synchronize()``), the peak device memory, whether
that checkout's D has a split-stem form, and the card's name and power
limit. Run one process per checkout, in the order A, B, B, A, to compare
two trees on one card:

    python3 scripts/torch_hd_step_time.py path/to/checkout
"""

import statistics
import subprocess
import sys
import time

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

import p2p_tpu_torch.models.patchgan as pg  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.core.dtypes import train_dtype  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_hd_batch  # noqa: E402
from p2p_tpu_torch.train.state import (  # noqa: E402
    create_train_state, load_vgg19)
from p2p_tpu_torch.train.step import build_train_step  # noqa: E402

cfg = get_preset("pix2pixhd")
h, w = cfg.image_hw
host = synthetic_hd_batch(10, h, w, seed=0)
batches = [{k: v[i:i + 1] for k, v in host.items()} for i in range(10)]
dtype = train_dtype(cfg.train.mixed_precision)
state = create_train_state(cfg, 0, train_dtype=dtype)
step = build_train_step(cfg, load_vgg19(device=torch.device("cuda")), dtype)
torch.cuda.reset_peak_memory_stats()
times = []
for b in batches:
    t = time.perf_counter()
    state, m = step(state, b)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t) * 1e3)
timed = times[2:]
card = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip()
print(f"{sys.argv[1]} split_stem_code={hasattr(pg._PlainConv, '_split')} "
      f"split_d_pairs={cfg.model.split_d_pairs}: median "
      f"{statistics.median(timed):.3f} ms/step min {min(timed):.3f} max "
      f"{max(timed):.3f} peak "
      f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB loss_g "
      f"{float(m['loss_g']):.4f} on {card}", flush=True)
