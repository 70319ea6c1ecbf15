"""The input gradient of the discriminators' pooling on one CUDA card:
``F.avg_pool2d`` (k3, s2, pad 1, with and without the padding in the
count) in f32 on a channels_last input and on an NCHW one, and the port's
``models/patchgan.avg_pool_downsample`` (which pools an NCHW copy) on a
channels_last input, each against the same pool in f64 on the CPU, at the
shapes of a video step's D input (8 frames of 6-channel 256² pairs) and
of an inner feature map. Prints, per case, the largest difference of the
output and of the input gradient (for a fixed random cotangent), each
over the reference's largest |entry|, then the card's name and power
limit. Run from the root of the checkout:

    python3 scripts/torch_pool_backward_check.py
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from p2p_tpu_torch.models.patchgan import avg_pool_downsample  # noqa: E402


def run(fn, x, cot, device, dtype, fmt):
    z = x.to(device, dtype).contiguous(memory_format=fmt).requires_grad_(True)
    y = fn(z)
    (y * cot.to(device, dtype)).sum().backward()
    return y.detach().cpu().double(), z.grad.cpu().double()


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


cases = {
    "avg_pool2d count_include_pad=False": lambda z: F.avg_pool2d(
        z, 3, 2, 1, count_include_pad=False),
    "avg_pool2d count_include_pad=True": lambda z: F.avg_pool2d(
        z, 3, 2, 1, count_include_pad=True),
    "avg_pool_downsample": avg_pool_downsample,
}
gen = torch.Generator().manual_seed(0)
for shape in ((8, 6, 256, 256), (8, 16, 33, 33)):
    x = torch.randn(shape, generator=gen)
    for name, fn in cases.items():
        y64, g64 = run(fn, x, torch.zeros(()), "cpu", torch.float64,
                       torch.contiguous_format)
        cot = torch.randn(y64.shape, generator=gen)
        y64, g64 = run(fn, x, cot, "cpu", torch.float64,
                       torch.contiguous_format)
        for layout, fmt in (("channels_last", torch.channels_last),
                            ("nchw", torch.contiguous_format)):
            if name == "avg_pool_downsample" and layout == "nchw":
                continue
            y, g = run(fn, x, cot, "cuda", torch.float32, fmt)
            print(json.dumps({"shape": shape, "op": name, "input": layout,
                              "output_rel_err": rel(y, y64),
                              "grad_rel_err": rel(g, g64)}), flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip())
