"""Whether full-width ``reference`` training repeats its bits on one CUDA
card under ``torch.backends.cudnn.deterministic``, as ``chip_smoke.py``'s
slice-10 resume check runs it. From the state and synthetic batches of
``chip_smoke.SEED``, ``n_steps`` bf16 train steps (f32 masters) run twice
with each route of the reflect pad's backward: the port's
(``ops/conv.reflect_pad_2d``, which adds in a fixed order under the flag)
and PyTorch's own (``F.pad(mode="reflect")``, whose CUDA backward adds
with atomics). Prints, per route, whether the two runs' losses and
networks (parameters and buffers) are bitwise equal, how many of their
elements differ and by how much; then the ops that PyTorch's
deterministic mode (``torch.use_deterministic_algorithms(True,
warn_only=True)``) flags over one more step of the port's route; then the
card's name and power limit. Run from the root of the checkout:

    python3 scripts/torch_reference_determinism.py [n_steps]
"""

import contextlib
import json
import os
import subprocess
import sys
import warnings
from unittest import mock

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.core.dtypes import train_dtype  # noqa: E402
from p2p_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from p2p_tpu_torch.ops import conv  # noqa: E402
from p2p_tpu_torch.ops.cuda import build  # noqa: E402
from p2p_tpu_torch.train.state import (  # noqa: E402
    create_train_state, load_vgg19)
from p2p_tpu_torch.train.step import build_train_step  # noqa: E402


def torch_pad(x, pad):
    return F.pad(x, (pad,) * 4, mode="reflect") if pad else x


def run(cfg, vgg, batches):
    """The losses of each step and every network tensor after the steps."""
    dtype = train_dtype(cfg.train.mixed_precision)
    state = create_train_state(cfg, chip_smoke.SEED, train_dtype=dtype)
    step = build_train_step(cfg, vgg, dtype)
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append({k: float(metrics[k]) for k in chip_smoke.LOSS_KEYS})
    nets = {f"{name}.{k}": t.detach().clone() for name in chip_smoke.RES_NETS
            for k, t in getattr(state, name).state_dict().items()}
    return losses, nets


def apart(a, b):
    (la, na), (lb, nb) = a, b
    n_diff = n_all = 0
    largest = 0.0
    for k, x in na.items():
        y = nb[k]
        n_all += x.numel()
        ne = x != y
        n_diff += int(ne.sum())
        if ne.any() and x.is_floating_point():
            largest = max(largest, float((x.double() - y.double()).abs().max()))
    return {"losses_bitwise": la == lb, "nets_bitwise": n_diff == 0,
            "elements_differing": n_diff, "elements": n_all,
            "largest_abs_difference": largest,
            "losses": [la, lb] if la != lb else la}


def main():
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    build.build_all()
    cfg = get_preset("reference")
    h, w = cfg.image_hw
    host = synthetic_batch(n_steps + 1, h, cfg.model.quant_bits,
                           seed=chip_smoke.SEED, width=w)
    batches = [{k: v[i:i + 1] for k, v in host.items()}
               for i in range(n_steps + 1)]
    vgg = load_vgg19(device=torch.device("cuda"))
    with chip_smoke.cudnn_deterministic():
        for route, patch in (("fixed order", None),
                             ("PyTorch's", mock.patch.object(
                                 conv, "reflect_pad_2d", torch_pad))):
            with patch or contextlib.nullcontext():
                runs = [run(cfg, vgg, batches[:n_steps]) for _ in range(2)]
            print(json.dumps({"reflect pad backward": route,
                              "steps": n_steps, **apart(*runs)}), flush=True)
        flagged = set()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                run(cfg, vgg, batches[n_steps:])
            flagged.update(str(m.message).split(". ")[0] for m in seen
                           if "deterministic" in str(m.message))
        finally:
            torch.use_deterministic_algorithms(False)
    print(json.dumps({"flagged by torch.use_deterministic_algorithms":
                      sorted(flagged)}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
