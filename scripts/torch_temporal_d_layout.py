"""Device time of the video step's temporal discriminator by memory layout,
on one CUDA card: the full-width 2-scale temporal D of ``vid2vid_temporal``
(ndf 64, n_layers 3, bf16 compute on f32 parameters) on one (input ‖ clip)
pair of 8 frames of 256², forward and backward (input and parameter
gradients), with the clip and the parameters in ``channels_last_3d`` (as
the video step runs it) and in the default NCDHW layout, each with
``torch.backends.cudnn.benchmark`` off (the step's setting) and on. CUDA
events around each call, median of 10 after 3 warm-up calls. Prints one
JSON line per case, then the card's name and power limit. Run from the
root of the checkout:

    python3 scripts/torch_temporal_d_layout.py
"""

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from p2p_tpu_torch.core.config import get_preset  # noqa: E402
from p2p_tpu_torch.models.registry import init_weights  # noqa: E402
from p2p_tpu_torch.train.video_step import build_video_models  # noqa: E402


def timed(fn, reps=10):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


cfg = get_preset("vid2vid_temporal")
h, w = cfg.image_hw
t = cfg.data.n_frames
dt = build_video_models(cfg, torch.bfloat16)[2]
init_weights(dt, torch.Generator().manual_seed(0))
x = torch.rand((1, 6, t, h, w), generator=torch.Generator().manual_seed(1))
for layout, fmt in (("channels_last_3d", torch.channels_last_3d),
                    ("ncdhw", torch.contiguous_format)):
    net = dt.to("cuda", memory_format=fmt).train()
    xx = (x.to("cuda", torch.bfloat16) * 2 - 1).contiguous(memory_format=fmt)
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        xin = xx.detach().requires_grad_(True)

        def fwd():
            return [f for scale in net(xin) for f in scale]

        def fwd_bwd():
            sum(f.float().mean() for f in fwd()).backward()

        with torch.no_grad():
            f_ms = timed(fwd)
        fb_ms = timed(fwd_bwd)
        print(json.dumps({"layout": layout, "cudnn_benchmark": bench,
                          "forward_ms": f_ms, "forward_backward_ms": fb_ms}),
              flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip())
