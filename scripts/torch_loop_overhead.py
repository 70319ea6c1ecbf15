"""What the trainer's epoch loop adds to the step, on one CUDA card: the
full-width ``reference`` preset (bf16 on f32 masters, batch 1, VGG19 from
its seed) on a dataset of 256² pairs generated by the port from synthetic
512² sources, one ``Trainer`` in one process. After a warm-up epoch, each
round times three things over one epoch's batches, each ending in a
``torch.cuda.synchronize()``:

- ``data``: the loader and the pinned one-ahead copies alone
  (``device_prefetch(make_loader(...))``), no step;
- ``steps``: ``Trainer.train_step`` over the same batches already on the
  card, as a user who drives the step would;
- ``loop``: ``Trainer.train_epoch`` (loader, copies, steps, the device-side
  metric sums and their one fetch), split by its step calls
  (``chip_smoke.loop_split``): ms a step inside the calls, ms a gap
  between calls, ms at the epoch's ends.

Rounds alternate the order (data steps loop, loop steps data, ...). Prints
each round's ms per step with the host's speed before it
(``chip_smoke.host_yardstick_ms``), the medians over the rounds, and the
card's name and power limit. Run from the root of the checkout:

    python3 scripts/torch_loop_overhead.py [n_train] [rounds]
"""

import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from chip_smoke import (host_yardstick_ms, loop_split,  # noqa: E402
                        timed_step_calls)
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.data.generate import generate_dataset  # noqa: E402
from p2p_tpu_torch.data.pipeline import (device_prefetch,  # noqa: E402
                                         make_loader)
from p2p_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from p2p_tpu_torch.train.loop import Trainer  # noqa: E402

n_train = int(sys.argv[1]) if len(sys.argv) > 1 else 16
rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 6
cfg = get_preset("reference")
h = cfg.image_hw[0]
bs = cfg.data.batch_size

with tempfile.TemporaryDirectory(prefix="loop_overhead_") as tmp:
    src, data = os.path.join(tmp, "src"), os.path.join(tmp, "data")
    make_synthetic_dataset(src, n_train, 1, size=2 * h, seed=0)
    for split in ("train", "test"):
        generate_dataset(os.path.join(src, split, "a"), data, split,
                         crop_size=h, max_patches=1)
    tr = Trainer(cfg, data_root=data, workdir=tmp)
    tr.train_epoch(seed=0)                      # warm-up
    torch.cuda.synchronize()

    def loader(seed):
        return make_loader(tr.train_ds, bs, shuffle=True,
                           seed=cfg.train.seed + seed)

    def run(what, seed):
        t = time.perf_counter()
        if what == "data":
            for _ in device_prefetch(loader(seed), tr.device):
                pass
        elif what == "steps":
            for b in batches:
                tr.state, _ = tr.train_step(tr.state, b)
        else:
            with timed_step_calls(tr) as calls:
                tr.train_epoch(seed=seed)
                torch.cuda.synchronize()
            split.append(loop_split(calls, t, time.perf_counter()))
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / tr.steps_per_epoch

    batches = list(device_prefetch(loader(1), tr.device))
    times = {"data": [], "steps": [], "loop": []}
    split = []
    for r in range(rounds):
        order = ("data", "steps", "loop") if r % 2 == 0 else (
            "loop", "steps", "data")
        host = host_yardstick_ms()
        row = {what: run(what, r + 1) for what in order}
        for what, ms in row.items():
            times[what].append(ms)
        print(f"round {r + 1} ({' '.join(order)}): "
              + ", ".join(f"{k} {v:.2f}" for k, v in row.items())
              + " ms/step (loop: calls {:.2f}, between {:.2f}, ends {:.2f} "
              "ms)".format(*split[-1])
              + f"; host yardstick {host:.2f} ms", flush=True)
    med = {k: statistics.median(v) for k, v in times.items()}
    calls = statistics.median([c for c, _, _ in split])
    print(f"medians over {rounds} rounds of {tr.steps_per_epoch} steps: "
          + ", ".join(f"{k} {v:.2f} ms/step" for k, v in med.items())
          + f"; loop / steps {med['loop'] / med['steps']:.3f}; the loop's "
          f"step calls / steps {calls / med['steps']:.3f}")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip())
