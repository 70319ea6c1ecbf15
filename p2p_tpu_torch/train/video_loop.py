"""The video trainer and its eval step (counterpart of
``p2p_tpu/train/video_loop.py:57 build_video_eval_step`` and ``:86
VideoTrainer``, single device).

:class:`VideoTrainer` is train/loop.py's ``Trainer`` on clips: the
splits are ``data/video.VideoClipDataset`` windows of ``n_frames``, the
state and the step are train/video_step.py's (G, the spatial D and the
temporal D with their three optimizers), and the eval scores every frame
of every test clip (``n_frames_scored`` in the ``eval`` record; no
sample PNGs, no masks and no VFID, as in JAX: its video trainer loads
VGG19 only for ``lambda_vgg``). Everything else is the image trainer's
own code: the epochs and their shuffle, ``data.threads`` loader workers
for a split of more than 64 clips, the per-epoch eval gated by
``train.eval_every_epoch`` (``p2p_tpu/train/video_loop.py:475``), the
metric sums, ``frames_per_sec`` (clip frames a second after the first
step), the checkpoints (``net_dt.pt`` and ``opt_dt.pt`` beside G's and
D's, train/checkpoint.py) with their iterator sidecar, ``mark_good`` on
a finite PSNR, exact-step preemption (exit 75 in ``cli/train.py``), the
sentinel, the ladder and rollback (exit 76), the spans, records and
memory samples, and the elastic reconciliation of a resume (train/loop.py
``plan_elastic_restore``). Under a process group of one rank it runs its
one-device step and records the mesh; on more ranks it trains through
``train/video_step.make_parallel_video_step``: each rank loads its batch
slot's clips (the image trainer's stride loader) and, under a ``time``
axis wider than one, only its block of each clip's frames, so the clips'
global order is the one-rank order and the iterator sidecar's exact-step
resume holds; rank 0 writes the one-device checkpoints, the ranks agree
on preemption (exit 75), and the eval sums each rank's per-frame PSNR and
SSIM over the world (time peers score distinct frames). A relaunch across
data or time widths is a ``reshard``. Tensor parallelism (``model``)
has no video form here and is refused by name; on a ``pipe`` axis it
runs flat, the pipe ranks as replicas, as the image trainer does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.data.video import VideoClipDataset
from p2p_tpu_torch.train.loop import Trainer
from p2p_tpu_torch.train.step import make_infer_forward
from p2p_tpu_torch.core.mesh import frame_block
from p2p_tpu_torch.train.video_step import (build_video_train_step,
                                            create_video_train_state,
                                            make_parallel_video_step)


def build_video_eval_step(cfg: Config,
                          dtype: Optional[torch.dtype] = None):
    """``eval_step(net_g, batch) -> (pred, metrics)``: G in eval mode on
    every frame of NTHWC ``batch`` (train/step.py ``make_infer_forward``
    on the folded frames), ``pred`` (N, T, H, W, C) on the device and
    per-frame ``psnr`` and ``ssim`` vectors of length N·T against the
    target clip."""
    fwd = make_infer_forward(cfg, dtype, with_metrics=True)

    def eval_step(net_g: nn.Module, batch: Dict[str, np.ndarray]):
        n, t = batch["input"].shape[:2]
        frames = {k: v.reshape((n * t,) + tuple(v.shape[2:]))
                  for k, v in batch.items()}
        mode = net_g.training
        net_g.eval()
        try:
            pred, metrics = fwd(net_g, frames)
        finally:
            net_g.train(mode)
        return pred.reshape((n, t) + tuple(pred.shape[1:])), metrics

    return eval_step


class VideoTrainer(Trainer):
    """Train a video config (``cfg.data.n_frames > 1``) on
    ``<data_root>/{train,test}/{a,b}/<video>/<frame>.png``; the arguments
    and protocol of :class:`~p2p_tpu_torch.train.loop.Trainer`."""

    RATE_KEY = "frames_per_sec"
    EVAL_COUNT_KEY = "n_frames_scored"
    SCORES_FID = False

    def _needs_vgg(self) -> bool:
        return self.cfg.loss.lambda_vgg > 0

    def _datasets(self, root: str):
        d = self.cfg.data
        kw = dict(direction=d.direction, image_size=d.image_size,
                  image_width=d.image_width, n_frames=d.n_frames,
                  dtype="uint8" if d.uint8_pipeline else "float32")
        mesh = self.mesh
        if mesh is not None and mesh.time > 1:
            # this rank reads and decodes its block of each clip only
            kw["frames"] = frame_block(d.n_frames, mesh.time,
                                       mesh.time_rank)
        return (VideoClipDataset(root, "train", **kw),
                VideoClipDataset(root, "test", **kw))

    def _create_state(self):
        return create_video_train_state(self.cfg, self.cfg.train.seed,
                                        self.steps_per_epoch, self.dtype,
                                        self.device)

    def _build_steps(self):
        eval_step = build_video_eval_step(self.cfg, self.dtype)
        if self.mesh is not None and self.mesh.size > 1:
            # the loader hands each rank its clips and frames already
            return (make_parallel_video_step(self.cfg, self.mesh, self.vgg,
                                             self.dtype), eval_step)
        return (build_video_train_step(self.cfg, self.vgg, self.dtype),
                eval_step)

    def _eval_weights(self):
        """G's own weights (the video state carries no EMA)."""
        return contextlib.nullcontext()

    def _eval_batch(self, batch):
        return self.eval_step(self.state.net_g, batch)

    def _save_samples(self, batch, pred) -> None:
        """The JAX video trainer writes no sample images."""
