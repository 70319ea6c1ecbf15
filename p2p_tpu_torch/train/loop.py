"""The trainer: epochs of train steps, per-epoch eval and checkpoints
(counterpart of the single-device core of ``p2p_tpu/train/loop.py:853
Trainer``: ``__init__``, ``train_epoch``, ``evaluate``, ``maybe_resume``
and ``fit``).

Each epoch shuffles the train split with ``default_rng(seed + epoch)``
(and crops with ``aug_seed = seed + epoch``), runs one train step per
batch with the batches sent to the card one ahead (data/pipeline.py), and
keeps the metrics as device-side running sums fetched once at the epoch's
end, so the only host syncs of a step are the skip guard's two (and one
per ``log_every`` steps for the ``train`` record). The eval scores every
test image (per-image PSNR/SSIM in eval mode, no moments kernel) and
writes the first batch's ``e{epoch}_{input,target,pred,comp}.png`` under
``<workdir>/<result_dir>/<dataset>/``. A checkpoint is saved every
``epoch_save`` epochs and at the last one. ``metrics_<name>.jsonl`` in the
workdir receives the JAX trainer's ``{"kind": "epoch", ...}`` and
``{"kind": "eval", ...}`` records under the same keys.

With ``lr_policy="plateau"`` a :class:`~p2p_tpu_torch.train.schedules.
PlateauController` is fed each epoch's ``loss_g`` after the epoch record
and before the checkpoint; its scale is the state's ``lr_scale``, which
multiplies every update, is saved with the checkpoint and seeds the
controller on resume. The logged ``lr`` includes it. With an EMA
generator (``ema_decay``) the eval scores the EMA weights (bitwise G's
at decay 0).

Not ported yet: the health ladder (the in-step skip guard is the train
step's), preemption, exact-step and elastic resume, obs, scan steps,
meshes and FID.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.core.device import resolve_device
from p2p_tpu_torch.core.dtypes import train_dtype
from p2p_tpu_torch.data.pipeline import (PairedImageDataset, device_prefetch,
                                         make_loader)
from p2p_tpu_torch.train.checkpoint import (CheckpointCorrupt,
                                            CheckpointManager)
from p2p_tpu_torch.train.schedules import PlateauController, make_schedule
from p2p_tpu_torch.train.state import (TrainState, create_train_state,
                                       load_vgg19)
from p2p_tpu_torch.train.step import (build_eval_step, build_train_step,
                                      compressed_input, to_device_image)
from p2p_tpu_torch.utils.images import ingest, save_img


class MetricsLogger:
    """Records as JSON lines (``metrics_<name>.jsonl``) and on stdout, as
    the JAX ``MetricsLogger`` writes them: numbers as floats, a ``ts``
    wall-clock stamp; printed when forced, for ``eval`` records and every
    ``print_every`` steps."""

    def __init__(self, path: str, print_every: int = 50):
        self.path = path
        self.print_every = max(1, print_every)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def log(self, record: Dict, force: bool = False) -> None:
        rec = {k: float(v) if isinstance(v, (int, float)) else v
               for k, v in record.items()}
        rec.setdefault("ts", round(time.time(), 3))
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        step = rec.get("step", 0)
        if force or rec.get("kind") == "eval" or step % self.print_every == 0:
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in rec.items()
                           if k != "ts"), flush=True)


def metrics_path(workdir: str, name: str) -> str:
    return os.path.join(workdir, f"metrics_{name}.jsonl")


def epoch_metric_means(host_sums: Dict[str, float], count: int
                       ) -> Dict[str, float]:
    """Per-step means of the epoch sums: losses over the applied steps
    (the ``health_ok`` sum), ``health_ok`` over all steps."""
    n_ok = host_sums.get("health_ok")
    denom = max(float(n_ok) if n_ok is not None else count, 1.0)
    return {k: float(v) / (count if k == "health_ok" else denom)
            for k, v in host_sums.items()}


def mask_skipped(metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """A step's metrics as the epoch sums take them: every loss of a step
    the guard skipped (``health_ok`` 0) zeroed (``where``: NaN·0 is NaN)."""
    ok = metrics.get("health_ok")
    if ok is None:
        return metrics
    keep = ok >= 0.5
    return {k: v if k == "health_ok" else torch.where(keep, v,
                                                      torch.zeros_like(v))
            for k, v in metrics.items()}


@contextlib.contextmanager
def eval_weights(state: TrainState) -> Iterator[None]:
    """G's parameters are the EMA's for the duration, when the state
    carries one (the JAX ``eval_state_of``); its buffers stay G's."""
    if state.ema_g is None:
        yield
        return
    params = dict(state.net_g.named_parameters())
    raw = {k: p.data for k, p in params.items()}
    try:
        for k, p in params.items():
            p.data = state.ema_g[k]
        yield
    finally:
        for k, p in params.items():
            p.data = raw[k]


class Trainer:
    """Train ``cfg`` on ``<data_root>/{train,test}/{a,b}/`` (default
    ``<cfg.data.root>/<cfg.data.dataset>``) on one device (``cuda`` unless
    the caller asks for the CPU), writing under ``workdir``."""

    def __init__(self, cfg: Config, data_root: Optional[str] = None,
                 workdir: str = ".",
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        root = data_root or os.path.join(cfg.data.root, cfg.data.dataset)
        ds_dtype = "uint8" if cfg.data.uint8_pipeline else "float32"
        self.train_ds = PairedImageDataset(
            root, "train", cfg.data.direction, cfg.data.image_size,
            cfg.data.image_width, augment=cfg.data.augment, dtype=ds_dtype)
        self.test_ds = PairedImageDataset(
            root, "test", cfg.data.direction, cfg.data.image_size,
            cfg.data.image_width, dtype=ds_dtype)
        self.steps_per_epoch = max(1, len(self.train_ds)
                                   // cfg.data.batch_size)
        self.dtype = train_dtype(cfg.train.mixed_precision)
        self.vgg = (load_vgg19(device=self.device,
                               imagenet_norm=cfg.loss.vgg_imagenet_norm)
                    if cfg.loss.lambda_vgg > 0 else None)
        sample = None
        if cfg.model.int8_delayed:
            item = self.train_ds[0]
            sample = {k: np.broadcast_to(v, (cfg.data.batch_size,) + v.shape
                                         ).copy() for k, v in item.items()}
        self.state = create_train_state(
            cfg, cfg.train.seed, self.steps_per_epoch, self.dtype,
            self.device, sample_batch=sample)
        self.train_step = build_train_step(cfg, self.vgg, self.dtype)
        self.eval_step = build_eval_step(cfg, self.dtype)
        self.ckpt = CheckpointManager(os.path.join(
            workdir, cfg.train.checkpoint_dir, cfg.data.dataset, cfg.name))
        self.logger = MetricsLogger(metrics_path(workdir, cfg.name),
                                    cfg.train.log_every)
        self.plateau = (PlateauController()
                        if cfg.optim.lr_policy == "plateau" else None)
        self.epoch = cfg.train.epoch_count
        self._resume_skip = 0
        self._samples_seen = 0     # this process's, for the train records

    # ------------------------------------------------------------ resume
    def maybe_resume(self) -> bool:
        """Restore the newest intact checkpoint, if there is one: the
        next epoch is the one after the restored step's. Returns whether
        one was restored."""
        if self.ckpt.latest_step() is None:
            return False
        try:
            step, _ = self.ckpt.restore(self.state)
        except CheckpointCorrupt as e:
            if self.cfg.health.ema_decay is not None:
                raise RuntimeError(
                    "restore failed with --ema_decay set: if these "
                    "checkpoints were saved WITHOUT the EMA generator, "
                    "resume without --ema_decay (EMA can only start on a "
                    f"fresh run); underlying: {e}") from e
            raise
        if self.plateau is not None:
            # the scale only ever falls: a resume keeps the reductions
            self.plateau.scale = self.state.lr_scale
        done, mid = divmod(step, self.steps_per_epoch)
        # a step inside an epoch (the dataset or the batch changed under
        # the checkpoint) resumes that epoch after its first `mid` batches
        self._resume_skip = mid
        self.epoch = max(self.cfg.train.epoch_count, 1 + done)
        # the restored schedulers count `done` epochs already: an epoch
        # label given with --epoch_count must not count them again
        eff = max(1, self.cfg.train.epoch_count - done)
        if eff != self.cfg.train.epoch_count:
            schedule = make_schedule(self.cfg.optim, self.steps_per_epoch,
                                     eff)
            for opt in (self.state.opt_g, self.state.opt_d,
                        self.state.opt_c):
                if opt is not None:
                    opt[1].lr_lambdas = [schedule]
        return True

    # ------------------------------------------------------------- train
    def current_lr(self) -> float:
        """G's effective learning rate of the last applied step: the
        schedule's value (the JAX state's ``inject_hyperparams``) times the
        plateau scale."""
        _, scheduler = self.state.opt_g
        return (scheduler.base_lrs[0]
                * scheduler.lr_lambdas[0](max(scheduler.last_epoch - 1, 0))
                * self.state.lr_scale)

    def train_epoch(self, seed: Optional[int] = None,
                    skip_batches: int = 0) -> Dict[str, float]:
        """One pass over the train split; returns the epoch's metric means
        and ``img_per_sec`` over the steps after the first."""
        cfg = self.cfg
        seed = self.epoch if seed is None else seed
        self.train_ds.aug_seed = cfg.train.seed + seed
        loader = make_loader(self.train_ds, cfg.data.batch_size,
                             shuffle=True, seed=cfg.train.seed + seed,
                             skip_batches=skip_batches)
        sums: Optional[Dict[str, torch.Tensor]] = None
        count = last_logged = 0
        t0 = time.perf_counter()
        for batch in device_prefetch(loader, self.device):
            self.state, metrics = self.train_step(self.state, batch)
            self._samples_seen += cfg.data.batch_size
            masked = mask_skipped(metrics)
            sums = (dict(masked) if sums is None
                    else {k: sums[k] + v for k, v in masked.items()})
            count += 1
            if count == 1:
                t0 = time.perf_counter()
            if count - last_logged >= cfg.train.log_every:
                last_logged = count
                self.logger.log({"kind": "train", "epoch": self.epoch,
                                 "step": self.state.step,
                                 "samples": self._samples_seen,
                                 **{k: float(v) for k, v in metrics.items()}},
                                force=True)
        if sums is None:
            return {}
        keys = list(sums)
        host = torch.stack([sums[k].float() for k in keys]).cpu().tolist()
        elapsed = time.perf_counter() - t0
        out = epoch_metric_means(dict(zip(keys, host)), count)
        if count > 1:
            out["img_per_sec"] = ((count - 1) * cfg.data.batch_size
                                  / max(elapsed, 1e-9))
        return out

    # -------------------------------------------------------------- eval
    def evaluate(self, save_samples: bool = False) -> Dict[str, float]:
        """Score every test image; with ``save_samples`` write the first
        batch's first input, target, prediction and (with a compression
        net) G's quantized input as PNGs."""
        cfg = self.cfg
        loader = make_loader(self.test_ds, cfg.data.test_batch_size,
                             shuffle=False, num_epochs=1,
                             drop_remainder=False)
        psnrs: List[torch.Tensor] = []
        ssims: List[torch.Tensor] = []
        saved = False
        for batch in device_prefetch(loader, self.device):
            with eval_weights(self.state):
                pred, metrics = self.eval_step(self.state, batch)
            psnrs.append(metrics["psnr"])
            ssims.append(metrics["ssim"])
            if save_samples and not saved:
                self._save_samples(batch, pred)
                saved = True
        p = torch.cat(psnrs).cpu().numpy()
        s = torch.cat(ssims).cpu().numpy()
        result = {"psnr_mean": float(np.mean(p)), "psnr_max": float(np.max(p)),
                  "ssim_mean": float(np.mean(s)), "ssim_max": float(np.max(s)),
                  "n_images": len(p)}
        self.logger.log({"kind": "eval", "epoch": self.epoch, **result})
        return result

    def _save_samples(self, batch, pred: torch.Tensor) -> None:
        out_dir = os.path.join(self.workdir, self.cfg.train.result_dir,
                               self.cfg.data.dataset)
        os.makedirs(out_dir, exist_ok=True)

        def first(x) -> np.ndarray:
            return ingest(torch.as_tensor(x[:1]))[0].float().cpu().numpy()

        images = {"input": first(batch["input"]),
                  "target": first(batch["target"]), "pred": first(pred)}
        net_c = self.state.net_c
        if net_c is not None:
            net_c.eval()
            try:
                with torch.inference_mode():
                    real_b = to_device_image(batch["target"][:1],
                                             self.device, self.dtype)
                    comp = compressed_input(net_c, real_b,
                                            self.cfg.model.quant_bits)
            finally:
                net_c.train()
            images["comp"] = first(comp.permute(0, 2, 3, 1))
        for k, img in images.items():
            save_img(img, os.path.join(out_dir, f"e{self.epoch}_{k}.png"))

    # --------------------------------------------------------------- fit
    def fit(self, nepoch: Optional[int] = None) -> List[Dict[str, float]]:
        """Epochs ``self.epoch`` through ``nepoch`` (default
        ``cfg.train.nepoch``): train, eval, log, checkpoint."""
        cfg = self.cfg
        nepoch = nepoch or cfg.train.nepoch
        history = []
        while self.epoch <= nepoch:
            t0 = time.time()
            skip, self._resume_skip = self._resume_skip, 0
            record = {"epoch": self.epoch}
            train_metrics = self.train_epoch(seed=self.epoch,
                                             skip_batches=skip)
            record.update({"sec": time.time() - t0, **train_metrics,
                           "lr": self.current_lr()})
            record.update(self.evaluate(save_samples=True))
            history.append(record)
            self.logger.log({"kind": "epoch", **record}, force=True)
            if self.plateau is not None and "loss_g" in record:
                self.state.lr_scale = self.plateau.update(record["loss_g"])
            if self.epoch % cfg.train.epoch_save == 0 \
                    or self.epoch == nepoch:
                self.ckpt.save(self.state.step, self.state, self.epoch)
            self.epoch += 1
        return history
