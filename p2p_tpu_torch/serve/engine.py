"""The inference engine: bucket-batched generator serving (counterpart of
``p2p_tpu/serve/engine.py:81 InferenceEngine`` and ``ServeStats``).

Every request batch is padded up to one of a few batch buckets; start-up
runs one forward per bucket (the warm-up that the JAX engine spends on
ahead-of-time compiles), so cuDNN's algorithm choice and the kernel build
are paid before the first request. Dispatch is asynchronous on the card;
the device→host copy and the PNG encode run on the
:class:`~p2p_tpu_torch.serve.io.AsyncImageWriter` threads, overlapping the
next batch's compute. :meth:`InferenceEngine.run` reports a fenced timing
breakdown (``torch.cuda.synchronize``), so img/s is measured, not
asserted. ``dtype="bf16"`` (the default, as in the JAX engine) serves the
generator in bf16: the served-only families (pix2pixHD, ResNet) as a bf16
copy; the trained families (U-Net, ExpandNetwork) and net_c as they
train, f32 parameters and BatchNorm statistics computing in bf16
(``define_G(cfg, dtype)``, the JAX serving forward's ``train_dtype``).
A delayed-int8 checkpoint is served with its stored activation scales
frozen (the networks run in eval mode, which reads ``amax_x`` and writes
nothing), in f32 in either kind of copy.

A preset with a compression net (``reference``) is served with its net_c:
each request then carries its ``target``, and G runs on ``quantize(net_c(
target))``, as the reference's eval does. With ``with_metrics`` every
request is scored (per-image PSNR/SSIM against its target), and
:meth:`InferenceEngine.run` collects the scores with
``collect_metrics=True``.

The served G and net_c are one bundle that a forward reads once, and
:meth:`InferenceEngine.swap_state` replaces it whole (checkpoint hot-swap,
serve/tenancy.py), so no request runs a new G on an old net_c.
:func:`engine_from_checkpoint` builds an engine from the port's own
checkpoints, reading only G and net_c.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import (Any, Dict, Iterable, Iterator, List, NamedTuple,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch
from torch import nn

from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.core.device import resolve_device
from p2p_tpu_torch.core.dtypes import resolve_dtype
from p2p_tpu_torch.models.registry import (COMPUTE_DTYPE_GENERATORS,
                                           define_C, define_G)
from p2p_tpu_torch.ops.int8 import stored_scales
from p2p_tpu_torch.serve.io import (AsyncImageWriter, chunk_batch, pad_batch,
                                    pick_bucket)
from p2p_tpu_torch.train.step import make_infer_forward

IO_WORKERS = 4   # writer threads: device→host fetch + PNG encode


class Served(NamedTuple):
    """The modules a forward runs: G and net_c (None without one)."""

    model: nn.Module
    net_c: Optional[nn.Module]


@dataclasses.dataclass
class ServeStats:
    """Fenced timing breakdown for one :meth:`InferenceEngine.run`."""

    n_images: int = 0
    n_batches: int = 0
    infer_sec: float = 0.0    # first dispatch → last result on the device
    encode_sec: float = 0.0   # summed writer-thread fetch + encode time
    wall_sec: float = 0.0     # end to end, writer drain included
    img_per_sec: float = 0.0  # n_images / wall_sec
    device_img_per_sec: float = 0.0  # n_images / infer_sec
    overlap_sec: float = 0.0  # encode time hidden under device compute
    n_warmups: int = 0
    buckets: Tuple[int, ...] = ()

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["buckets"] = list(self.buckets)
        return d


class InferenceEngine:
    """Bucket-batched generator inference on one device.

    ``generator`` is the port's generator for ``cfg`` (any device and
    dtype; the engine serves its own copy on ``device`` in ``dtype``, in
    channels_last), ``net_c`` its compression net, required when the
    preset has one and served the same way. ``buckets`` are the batch
    sizes warmed up at start (default: ``cfg.data.test_batch_size``).
    ``device`` defaults to ``cuda`` and raises when there is none; pass
    ``"cpu"`` to serve with the plain PyTorch versions of the kernels.
    ``with_metrics`` scores every request against its ``target``;
    ``io_workers`` is the number of PNG writer threads.
    """

    def __init__(self, cfg: Config, generator: nn.Module,
                 buckets: Optional[Sequence[int]] = None,
                 dtype: Optional[str] = "bf16",
                 device: Union[str, torch.device, None] = None,
                 net_c: Optional[nn.Module] = None,
                 with_metrics: bool = False, io_workers: int = IO_WORKERS):
        if cfg.data.n_frames > 1:
            raise NotImplementedError(
                "InferenceEngine serves image presets; video inference "
                "stays on cli/infer.py's clip path")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.buckets: Tuple[int, ...] = tuple(sorted(set(
            int(b) for b in (buckets or (cfg.data.test_batch_size,)))))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad buckets {self.buckets}")
        use_c = cfg.model.use_compression_net
        if use_c != (net_c is not None):
            raise ValueError(f"preset {cfg.name!r} "
                             + ("needs its net_c" if use_c
                                else "has no compression net"))
        self._served = self._serving_bundle(generator, net_c)
        self.with_metrics = with_metrics
        self.io_workers = io_workers
        # the batch keys each request must carry
        self._keys = ("input",) + (("target",) if use_c or with_metrics
                                   else ())
        self._fwd = make_infer_forward(cfg, self.dtype, with_metrics)
        h, w = cfg.image_hw
        self._input_shape = (h, w, cfg.model.input_nc)
        self._input_dtype = (np.uint8 if cfg.data.uint8_pipeline
                             else np.float32)
        self._warm: set = set()
        self.n_warmups = 0

    @property
    def model(self) -> nn.Module:
        return self._served.model

    @property
    def net_c(self) -> Optional[nn.Module]:
        return self._served.net_c

    @property
    def batch_keys(self) -> Tuple[str, ...]:
        """The batch keys each request must carry."""
        return self._keys

    def _serving_bundle(self, generator: nn.Module,
                        net_c: Optional[nn.Module]) -> Served:
        """The engine's own copies of G and net_c on its device, in
        channels_last and eval mode."""
        def place(m: nn.Module) -> nn.Module:
            return m.to(device=self.device,
                        memory_format=torch.channels_last).eval()

        c = None
        if net_c is not None:
            c = place(self._copy_into(
                define_C(self.cfg.model, self._compute_dtype()), net_c))
        return Served(place(self._serving_copy(generator)), c)

    def _compute_dtype(self) -> Optional[torch.dtype]:
        return None if self.dtype == torch.float32 else self.dtype

    @staticmethod
    def _copy_into(model: nn.Module, trained: nn.Module) -> nn.Module:
        model.load_state_dict(trained.state_dict(), strict=True)
        return model

    def _serving_copy(self, generator: nn.Module) -> nn.Module:
        m = self.cfg.model
        if m.generator not in COMPUTE_DTYPE_GENERATORS:
            served = copy.deepcopy(generator).to(dtype=self.dtype)
            # the stored int8 scales stay f32, as they were trained
            with torch.no_grad():
                for s, t in zip(stored_scales(served),
                                stored_scales(generator)):
                    s.data = t.detach().to(s.device, torch.float32).clone()
            return served
        return self._copy_into(
            define_G(m, self._compute_dtype(), self.cfg.image_hw), generator)

    def synchronize(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _zeros(self, bucket: int) -> Dict[str, np.ndarray]:
        zeros = np.zeros((bucket,) + self._input_shape, self._input_dtype)
        return {k: zeros for k in self._keys}

    def warmup(self) -> "InferenceEngine":
        """One forward per bucket not yet warmed (idempotent)."""
        for b in self.buckets:
            if b not in self._warm:
                served = self._served
                self._fwd(served.model, self._zeros(b), served.net_c)
                self._warm.add(b)
                self.n_warmups += 1
        self.synchronize()
        return self

    def swap_state(self, new_g: nn.Module,
                   new_c: Optional[nn.Module] = None,
                   warm: bool = True) -> None:
        """Serve ``new_g`` (and ``new_c``) in place of the live weights
        (counterpart of ``p2p_tpu/serve/engine.py:202-253``):

        1. raises ``ValueError`` when their state_dict keys or shapes
           differ from the live bundle's; the old weights keep serving
           (dtypes need not match: the serving copy casts to the engine's
           dtype, as at construction);
        2. builds the new serving copies on the device, never loading
           into the live modules;
        3. with ``warm``, runs one zero batch through the smallest warmed
           bucket and synchronizes, so the new weights have run before
           any request sees them (no new warm-up is counted);
        4. swaps the bundle reference: a forward in flight finishes on the
           old bundle, the next one reads the new.
        """
        live = self._served
        if (new_c is None) != (live.net_c is None):
            raise ValueError("hot-swap rejected: "
                             + ("net_c missing" if new_c is None
                                else "this preset has no net_c"))
        for old, new in zip(live, (new_g, new_c)):
            if old is not None:
                _check_swappable(old.state_dict(), new.state_dict())
        served = self._serving_bundle(new_g, new_c)
        if warm and self._warm:
            self._fwd(served.model, self._zeros(min(self._warm)),
                      served.net_c)
            self.synchronize()
        self._served = served

    def infer_batch(self, host_batch: Dict[str, np.ndarray]):
        """Pad one NHWC host batch (``input``, and ``target`` with a
        compression net or metrics) to its bucket and dispatch
        (asynchronous on the card). Returns ``(pred, metrics, n_real)``
        with ``pred`` an NHWC device tensor and ``metrics`` per-image
        device vectors; rows from ``n_real`` on are padding."""
        if not self._warm:
            self.warmup()
        n = host_batch["input"].shape[0]
        padded, n_real = pad_batch(
            {k: np.asarray(host_batch[k]) for k in self._keys},
            pick_bucket(n, self.buckets))
        served = self._served      # one read: G and net_c of one version
        pred, metrics = self._fwd(served.model, padded, served.net_c)
        return pred, metrics, n_real

    def stream(self, host_batches: Iterable[Dict[str, np.ndarray]]
               ) -> Iterator[Tuple[Any, Any, int]]:
        """:meth:`infer_batch` over an iterator, one dispatch ahead of the
        consumer, chunking batches larger than the largest bucket."""
        pending = None
        for host_batch in host_batches:
            for chunk in chunk_batch(host_batch, self.buckets[-1]):
                out = self.infer_batch(chunk)
                if pending is not None:
                    yield pending
                pending = out
        if pending is not None:
            yield pending

    def run(self, host_batches: Iterable[Dict[str, np.ndarray]],
            names: Optional[Sequence[str]] = None,
            out_dir: Optional[str] = None,
            collect_metrics: bool = False
            ) -> Tuple[ServeStats, Dict[str, List[float]]]:
        """Serve every batch: bucket → dispatch → threaded fetch + PNG
        write. ``names[i]`` names the i-th real image's file under
        ``out_dir`` (default ``<i>.png``); with ``out_dir=None`` nothing is
        written. Returns ``(stats, metrics)``: with ``collect_metrics`` (an
        engine built ``with_metrics``) ``metrics`` maps ``psnr`` and
        ``ssim`` to one float per real image, in order, fetched after the
        last batch; otherwise it is empty."""
        if collect_metrics and not self.with_metrics:
            raise ValueError("collect_metrics needs an engine built "
                             "with_metrics=True")
        self.warmup()
        writer = AsyncImageWriter(self.io_workers) if out_dir else None
        stats = ServeStats(buckets=self.buckets, n_warmups=self.n_warmups)
        pending: List[Tuple[Dict[str, torch.Tensor], int]] = []
        t0 = time.perf_counter()
        n_saved = 0
        try:
            for pred, metrics, n_real in self.stream(host_batches):
                if collect_metrics:
                    pending.append((metrics, n_real))
                if writer is not None:
                    paths: List[str] = []
                    for _ in range(n_real):
                        name = (names[n_saved]
                                if names and n_saved < len(names)
                                else f"{n_saved}.png")
                        paths.append(f"{out_dir}/{name}")
                        n_saved += 1
                    writer.submit_batch(pred, paths)
                stats.n_images += n_real
                stats.n_batches += 1
            self.synchronize()
            stats.infer_sec = max(time.perf_counter() - t0, 1e-9)
            if writer is not None:
                writer.drain()
                stats.encode_sec = writer.encode_sec
        finally:
            if writer is not None:
                writer.close()
        stats.wall_sec = max(time.perf_counter() - t0, 1e-9)
        stats.img_per_sec = stats.n_images / stats.wall_sec
        stats.device_img_per_sec = stats.n_images / stats.infer_sec
        stats.overlap_sec = max(
            0.0, stats.infer_sec + stats.encode_sec - stats.wall_sec)
        out: Dict[str, List[float]] = {}
        if pending:
            for k in pending[0][0]:
                out[k] = torch.cat([m[k][:n] for m, n in pending]).float(
                    ).cpu().tolist()
        return stats, out


def _check_swappable(live: Dict[str, torch.Tensor],
                     new: Dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` at the first key or shape by which ``new``
    differs from ``live``."""
    if list(live) != list(new):
        missing = sorted(set(live) - set(new))
        extra = sorted(set(new) - set(live))
        raise ValueError(f"hot-swap rejected: keys differ (missing "
                         f"{missing[:3]}, unexpected {extra[:3]})")
    for k, t in live.items():
        if new[k].shape != t.shape:
            raise ValueError(
                f"hot-swap rejected: {k} is {tuple(new[k].shape)}, the "
                f"serving weights have {tuple(t.shape)}")


def serving_restore_template(cfg: Config
                             ) -> Tuple[nn.Module, Optional[nn.Module]]:
    """The modules a serving restore fills (counterpart of
    ``p2p_tpu/serve/engine.py:359``): G, and net_c when the preset has one,
    as the trainer builds them (f32 masters; the serving dtype is the
    engine's)."""
    m = cfg.model
    return (define_G(m, image_hw=cfg.image_hw),
            define_C(m) if m.use_compression_net else None)


def engine_from_checkpoint(cfg: Config, ckpt_dir: str,
                           step: Optional[int] = None, **engine_kw
                           ) -> Tuple[InferenceEngine, int]:
    """G (and net_c) restored from the newest step under ``ckpt_dir``
    whose files verify (or exactly ``step``), reading no discriminator or
    optimizer file (``CheckpointManager.restore_nets``), served by a new
    engine (``engine_kw``: buckets, dtype, device, ...). With
    ``cfg.health.ema_decay`` set the engine serves the smoothed G: the
    step's EMA parameters (which it must carry) with G's own running
    statistics, bitwise the raw G when it was trained at decay 0. Returns
    ``(engine, step)``."""
    from p2p_tpu_torch.train.checkpoint import CheckpointManager

    net_g, net_c = serving_restore_template(cfg)
    step = CheckpointManager(ckpt_dir).restore_nets(
        net_g, net_c, step, ema=cfg.health.ema_decay is not None)
    return InferenceEngine(cfg, net_g, net_c=net_c, **engine_kw), step
