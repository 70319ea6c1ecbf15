"""The train step of the registered presets, generator inference and the
eval step (counterparts
of ``p2p_tpu/train/step.py:79 single_forward_d_losses``, ``:140
make_g_loss_fn``, ``:209 build_train_step``, ``:600
build_pp_train_step``, ``:940 make_infer_forward`` and ``:995
build_eval_step``).

``build_train_step(cfg, vgg)`` returns ``step(state, batch) -> (state,
metrics)`` in the order of the JAX step (``step.py:277-597``):

1. with a compression net, ``compressed = quantize(net_c(real_b), bits)``,
   no gradient; without one (``facades``), G's input is ``real_a``;
2. ``fake_b = G(compressed or real_a)``, with the step's dropout noise
   when ``use_dropout`` (a ``torch.Generator`` seeded from
   ``(cfg.train.seed, step)``, so a rerun of a step draws the same masks);
3. ONE D(fake) forward on (real_a ‖ fake_b) that serves both the D loss
   (gradient to D's parameters only: the reference's ``fake_b.detach()``)
   and the G loss (gradient through D to fake_b only: the reference's
   ``zero_grad`` before the D step), then D(real); the pairs are
   concatenated on channels whatever ``split_d_pairs`` says (the JAX
   split stem computes the same function, models/patchgan.py). With the
   historical-fake pool (``pool_size > 0``) D's fake branch takes the
   pooled concatenated pair instead (utils/pool.py, draws from a
   generator seeded from ``(seed, step)``), so the step keeps the
   reference's three D forwards: D(pooled) and D(real) for the D loss,
   then D(real_a ‖ fake_b) for the G loss, gradient to fake_b only;
4. the G loss: GAN + feature matching + VGG + style + TV + angular +
   Sobel + L1 per the config (:func:`make_g_loss_fn`);
5. G's update, then D's, each scaled by ``state.lr_scale`` and, with
   ``grad_clip``, on gradients with their non-finite entries zeroed and
   clipped to that global norm (train/state.py ``clip_grads_``); then the
   EMA generator, when carried, moves towards the updated G;
6. with a compression net, the net_c branch against the UPDATED G:
   MSE(G(cq), real_b) + λ_vgg·VGG(cq, real_b), ``cq =
   quantize_ste(net_c(real_b))``, the gradient reaching net_c through the
   straight-through quantizer (no style, angular or Sobel term: the JAX
   branch has none); without one, ``loss_c`` is a 0-d zero.

Running statistics, spectral ``u`` and the delayed-int8 ``amax_x`` are
buffers that each forward in training mode advances in place, so they
move as the JAX collections are threaded: net_c's statistics and scales
from its first run (the net_c branch reruns it from the step's starting
buffers and drops that update, as the JAX branch reads
``state.batch_stats_c`` and ``state.quant_c``), G's statistics twice (the
G step, then the net_c branch: the stored value is the second; once
without net_c), G's scales once (the net_c branch reads the updated
``quant_g1`` and drops its own proposal), D's ``u`` and ``amax_x`` once
per D forward (fake, then real: the JAX ``dvars0 → dvars1 → dvars2``).

The skip guard (``health.enabled``, ``step.py:442-481``): when the G or D
loss is not finite, no optimizer steps, D's buffers (``u``, ``amax_x``),
G's scales and all running statistics return to the step's start, and
the pool, its count and the EMA keep their values of the step's start
(the step holds their new values until the verdict); when the net_c loss
is not finite, net_c does not step and the running statistics and
net_c's scales return to the start. The verdicts are read on the host
(two synchronizations per step). With ``grad_clip`` the metrics also
count the non-finite gradient entries the clip zeroed (``nonfinite_g``,
``nonfinite_d`` and, with net_c, ``nonfinite_c``), on a step the guard
dropped too, as JAX counts them.

The telemetry taps (``p2p_tpu/train/step.py:563-577``): with
``debug.grad_norms`` the metrics carry ``grad_norm_g``/``grad_norm_d``
(and ``grad_norm_c``), the global norms of each optimizer's raw
gradients; with ``debug.nan_sentinel`` the metrics (and the LR scale)
get per-leaf NaN/Inf counts queued to a pinned host buffer and read one
step later (obs/taps.py), which adds no host sync.

int8 QAT runs wherever the config puts it (``p2p_tpu/train/step.py:
223-300``): D's inner convs (``int8``), under spectral norm too, with the
quantize-fused epilogue (``int8_fused_epilogue``), D's stem and logits
head (``int8_stem``, ``int8_head``), G (``int8_generator``: the U-Net
encoder and, with ``int8_decoder``, its decoder; the ResNet-family
trunks) and net_c (``int8_compression``), with dynamic or stored
(``int8_delayed``) activation scales. The eval step and the serving
forward run the networks in eval mode, which reads the stored scales
frozen. :func:`build_train_step` refuses norms the port does not have,
and ``split_d_pairs`` with the pool, as JAX does.

Data parallel (parallel/dp.py ``make_parallel_train_step``): with ``dp``
the step runs on this rank's rows and calls ``dp`` at four points: the
split parameters are re-formed at its start (``fsdp_params``), G's and
D's gradients are all-reduced after G's backward (G's, then D's) and
net_c's after its own, each before its optimizer step, the guard's
verdicts are agreed over the ranks, the split parameters are freed at
its end, and the metrics are their means over the ranks (one all-reduce).
Under a spatial split (``spatial`` > 1, parallel/spatial.py) the step
takes this rank's rows of its batch slot's images (``parallel.dp.
shard_batch``) of the configured height, records that height on them,
and runs every op in its sharded form; its losses are this rank's shares
(``parallel.dp.check_spatial_config`` names what is not covered). The
eval and serving forward under a spatial mesh takes whole images, runs G
on this rank's rows and gathers the prediction's rows on every rank
(``parallel/spatial.gather_rows``), so PSNR and SSIM, whose windows cross
the blocks, are the whole image's.

:func:`build_pp_train_step` is the step with G's residual trunk on the
GPipe schedule over a pipe mesh (parallel/pp.py): its own function, as in
JAX, over a state split by ``parallel.pp.pp_split_state``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.core.mesh import (keep_rows, row_block, set_rows,
                                     spatial_mesh)
from p2p_tpu_torch.losses.feature_matching import feature_matching_loss
from p2p_tpu_torch.losses.gan import gan_loss
from p2p_tpu_torch.losses.l1 import l1_loss
from p2p_tpu_torch.losses.metrics import psnr, ssim
from p2p_tpu_torch.losses.perceptual import (perceptual_distance,
                                             target_features, vgg_loss)
from p2p_tpu_torch.losses.style import style_loss
from p2p_tpu_torch.models.patchgan import check_norm_d
from p2p_tpu_torch.obs.taps import grad_norm_taps, nan_sentinel
from p2p_tpu_torch.ops.int8 import stored_scales
from p2p_tpu_torch.ops.norm import NORM_KINDS
from p2p_tpu_torch.ops.quantize import quantize, quantize_ste
from p2p_tpu_torch.ops.sobel import angular_loss, sobel_edges
from p2p_tpu_torch.ops.tv import total_variation_loss
from p2p_tpu_torch.train.state import (TrainState, clip_grads_,
                                       ema_update_)
from p2p_tpu_torch.utils import pool as pool_lib
from p2p_tpu_torch.utils.images import ingest

GENERATORS = ("expand", "unet", "pix2pixhd", "pix2pixhd_global", "resnet")

InferFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
Metrics = Dict[str, torch.Tensor]


def make_infer_forward(cfg: Config, dtype: Optional[torch.dtype] = None,
                       with_metrics: bool = False) -> InferFn:
    """``fwd(generator, batch, net_c=None) -> (pred, metrics)``, the one
    inference definition of the eval step and the serving engine. The
    batch holds NHWC host arrays or device tensors (uint8 [0, 255] or
    float [-1, 1]); each goes to the generator's device, is normalized
    there and cast to ``dtype``, and runs as a channels_last (N, C, H, W)
    tensor. With a compression net G runs on ``quantize(net_c(target),
    quant_bits)`` and the stored input is unused (the reference's eval);
    without one, on ``batch["input"]``. The networks run as they are
    given: eval mode reads BatchNorm's running statistics, so no moments
    kernel is launched. ``pred`` is NHWC on the device; with
    ``with_metrics``, ``metrics`` holds per-image ``psnr`` and ``ssim``
    vectors against ``batch["target"]``, else it is empty."""
    bits = cfg.model.quant_bits
    use_c = cfg.model.use_compression_net

    def fwd(generator: nn.Module, batch: Dict[str, np.ndarray],
            net_c: Optional[nn.Module] = None):
        device = next(generator.parameters()).device
        if use_c and net_c is None:
            raise ValueError(f"preset {cfg.name!r} has a compression net: "
                             "pass net_c")
        with torch.inference_mode():
            real_b = (to_device_image(batch["target"], device, dtype)
                      if use_c or with_metrics else None)
            mesh = spatial_mesh()
            if mesh is not None:
                pred = _rows_forward(generator, batch["input"], device,
                                     dtype, mesh, use_c)
            else:
                g_in = (compressed_input(net_c, real_b, bits) if use_c else
                        to_device_image(batch["input"], device, dtype))
                pred = generator(g_in).permute(0, 2, 3, 1)
            metrics = {}
            if with_metrics:
                real_b = real_b.permute(0, 2, 3, 1)
                metrics = {"psnr": psnr(real_b, pred, per_image=True),
                           "ssim": ssim(real_b, pred, per_image=True)}
        return pred, metrics

    return fwd


def _rows_forward(generator: nn.Module, images, device: torch.device,
                  dtype: Optional[torch.dtype], mesh, use_c: bool
                  ) -> torch.Tensor:
    """G's prediction (NHWC, whole images) under a spatial mesh: G on this
    rank's rows of the whole input images, the rows gathered on every
    rank."""
    from p2p_tpu_torch.parallel.spatial import gather_rows, take_rows

    if use_c:
        raise NotImplementedError("the compression net has no form under "
                                  "a spatial mesh")
    h = images.shape[1]
    g_in = set_rows(to_device_image(take_rows(images, h, mesh), device,
                                    dtype), h)
    return gather_rows(generator(g_in), mesh).permute(0, 2, 3, 1)


def compressed_input(net_c: nn.Module, real_b: torch.Tensor, bits: int
                     ) -> torch.Tensor:
    """G's input at inference: ``quantize(net_c(real_b), bits)``, the
    round with no straight-through gradient."""
    return quantize(net_c(real_b), bits)


def build_eval_step(cfg: Config, dtype: Optional[torch.dtype] = None):
    """``eval_step(state, batch) -> (pred, metrics)``, the trainer's
    per-epoch eval: :func:`make_infer_forward` with metrics on the train
    state's G and net_c, both switched to eval mode for the call and back
    after it."""
    fwd = make_infer_forward(cfg, dtype, with_metrics=True)

    def eval_step(state: TrainState, batch: Dict[str, np.ndarray]):
        with _eval_mode(state.net_g, state.net_c):
            return fwd(state.net_g, batch, state.net_c)

    return eval_step


def to_device_image(x: np.ndarray, device: torch.device,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An NHWC host batch → a channels_last (N, C, H, W) tensor on
    ``device``, normalized there (utils/images.ingest) and cast to
    ``dtype``. An NHWC tensor viewed as (N, C, H, W) is channels_last
    already."""
    t = torch.as_tensor(x).to(device, non_blocking=True)
    return ingest(t.permute(0, 3, 1, 2), dtype)


def single_forward_d_losses(net_d: nn.Module, fake_pair: torch.Tensor,
                            real_pair: torch.Tensor, gan_mode: str):
    """ONE D(fake) forward for both losses, then D(real). Accumulates the
    D-loss gradient into D's ``.grad`` and returns ``(loss_d, pred_fake,
    pred_real)``: ``pred_fake`` keeps its graph (through D to the fake
    pair) for the G loss; ``pred_real`` is detached."""
    d_params = list(net_d.parameters())
    pred_fake = net_d(fake_pair)
    loss_fake = 0.5 * gan_loss(pred_fake, False, gan_mode)
    loss_fake.backward(inputs=d_params, retain_graph=True)
    pred_real = net_d(real_pair)
    loss_real = 0.5 * gan_loss(pred_real, True, gan_mode)
    loss_real.backward(inputs=d_params)
    pred_real = [[t.detach() for t in scale] for scale in pred_real]
    return (loss_fake + loss_real).detach(), pred_fake, pred_real


def make_g_loss_fn(cfg: Config, vgg: Optional[nn.Module],
                   steps_per_epoch: int = 1):
    """``g_losses(fake_b, pred_fake, pred_real, real_a, real_b, real_feats,
    step) -> (total, parts)``: GAN + feature matching + VGG + style + TV +
    angular + Sobel + L1 per the config, summed in that order, with
    ``parts`` holding each term under the JAX metric keys (``p2p_tpu/
    train/step.py:140 make_g_loss_fn``). ``real_a`` is the batch's input
    (not net_c's output), ``real_feats`` the VGG taps of ``real_b`` (when
    VGG or style is on; the fake's taps are computed once for both),
    ``step`` the step count before this step's increment.

    - style: ``lambda_style`` × :func:`~p2p_tpu_torch.losses.style.
      style_loss`, whenever ``vgg`` is given (``lambda_vgg`` may be 0);
    - angular: ``lambda_angular`` × the angular error between the
      illumination quotients ``real_a / max(real_b, 1e-4)`` and
      ``real_a / max(fake_b, 1e-4)``;
    - Sobel: the mean |sobel(fake_b) − sobel(real_b)| times
      ``lambda_sobel`` · min((1 + step // steps_per_epoch) /
      sobel_warmup_epochs, 1) (the plain weight without a warm-up)."""
    L = cfg.loss
    need_vgg = L.lambda_vgg > 0 and vgg is not None
    need_style = L.lambda_style > 0 and vgg is not None

    def g_losses(fake_b, pred_fake, pred_real, real_a, real_b, real_feats,
                 step: int):
        parts = {"g_gan": gan_loss(pred_fake, True, L.gan_mode,
                                   for_discriminator=False)}
        if L.lambda_feat > 0:
            parts["g_feat"] = feature_matching_loss(
                pred_fake, pred_real, cfg.model.n_layers_D, L.lambda_feat)
        fake_feats = vgg(fake_b) if need_vgg or need_style else None
        if need_vgg:
            parts["g_vgg"] = (perceptual_distance(fake_feats, real_feats)
                              * L.lambda_vgg)
        if need_style:
            parts["g_style"] = (style_loss(fake_feats, real_feats)
                                * L.lambda_style)
        if L.lambda_tv > 0:
            parts["g_tv"] = total_variation_loss(fake_b) * L.lambda_tv
        if L.lambda_angular > 0:
            eps = torch.tensor(1e-4, dtype=real_b.dtype, device=real_b.device)
            parts["g_angular"] = angular_loss(
                real_a / torch.maximum(real_b, eps),
                real_a / torch.maximum(fake_b, eps)) * L.lambda_angular
        if L.lambda_sobel > 0:
            lam = np.float32(L.lambda_sobel)     # the ramp in f32, as JAX
            if L.sobel_warmup_epochs > 0:
                epoch = 1 + step // max(steps_per_epoch, 1)
                lam = lam * np.minimum(
                    np.float32(epoch) / np.float32(L.sobel_warmup_epochs),
                    np.float32(1.0))
            parts["g_sobel"] = (sobel_edges(fake_b) - sobel_edges(real_b)
                                ).abs().mean() * float(lam)
        if L.lambda_l1 > 0:
            parts["g_l1"] = l1_loss(fake_b, real_b) * L.lambda_l1
        total = parts["g_gan"]
        for k in ("g_feat", "g_vgg", "g_style", "g_tv", "g_angular",
                  "g_sobel", "g_l1"):
            if k in parts:
                total = total + parts[k]
        return total, parts

    return g_losses


def _check_supported(cfg: Config) -> None:
    m = cfg.model
    if m.norm not in NORM_KINDS:
        raise ValueError(f"norm {m.norm!r} is not a norm of the port "
                         f"(have {NORM_KINDS})")
    check_norm_d(m.norm_d)
    if m.generator not in GENERATORS:
        raise ValueError(f"unknown generator {m.generator!r} (have "
                         f"{GENERATORS})")
    if m.split_d_pairs and cfg.train.pool_size > 0:
        raise ValueError(
            "split_d_pairs is incompatible with pool_size > 0 (the fake "
            "pool stores concatenated pairs); set one of them off")


class _Snapshot:
    """Flat copies of a set of buffers (one concatenation), to put them
    back when the skip guard drops a step."""

    def __init__(self, buffers: List[torch.Tensor]):
        self.buffers = buffers
        self.flat = torch.cat([b.reshape(-1) for b in buffers]) \
            if buffers else None

    def restore(self) -> None:
        if not self.buffers:
            return
        parts = self.flat.split([b.numel() for b in self.buffers])
        with torch.no_grad():
            for b, p in zip(self.buffers, parts):
                b.copy_(p.view_as(b))


def _grads(opt) -> List[torch.Tensor]:
    return [p.grad for g in opt[0].param_groups for p in g["params"]
            if p.grad is not None]


def _apply(opt, grads_ok: bool, clip: float = 0.0,
           lr_scale: float = 1.0) -> Optional[torch.Tensor]:
    """One update of ``opt`` = (optimizer, scheduler) unless the guard
    dropped the step: the gradients clipped (``clip > 0``), the
    scheduler's lr times ``lr_scale``, then the scheduler's step. Returns
    the clip's count of non-finite entries (None without a clip)."""
    optimizer, scheduler = opt
    zeroed = clip_grads_(_grads(opt), clip) if clip > 0 else None
    if grads_ok:
        if lr_scale != 1.0:
            for group, lr in zip(optimizer.param_groups,
                                 scheduler.get_last_lr()):
                group["lr"] = lr * lr_scale
        optimizer.step()
        scheduler.step()
    optimizer.zero_grad(set_to_none=True)
    return zeroed


def _finite(*losses: torch.Tensor, dp=None) -> bool:
    """Whether the losses are finite (on every rank, under ``dp``)."""
    if dp is not None:
        return dp.agree(*losses)
    return bool(torch.isfinite(torch.stack(losses)).all())


def dropout_generator(seed: int, step: int, device: torch.device
                      ) -> torch.Generator:
    """The generator of one step's dropout noise on ``device``, seeded from
    ``(seed, step)``: the same step draws the same masks. The pair is
    hashed (numpy's ``SeedSequence``, core/rng.py ``RngStream``), since the
    CPU generator keeps only 32 bits of its seed."""
    from p2p_tpu_torch.core.rng import RngStream

    return RngStream.from_seed(seed).at_step(step).generator(device)


def build_train_step(cfg: Config, vgg: Optional[nn.Module] = None,
                     train_dtype: Optional[torch.dtype] = None,
                     steps_per_epoch: int = 1, dp=None):
    """``step(state, batch) -> (state, metrics)`` for ``cfg``; ``vgg`` is
    the frozen VGG19 trunk (needed when ``lambda_vgg`` or ``lambda_style``
    is above 0), ``train_dtype`` the dtype the images enter in (bf16 under
    mixed precision, None for f32), ``steps_per_epoch`` the epoch length
    the Sobel warm-up counts in. ``batch`` holds NHWC
    host arrays ``"input"`` and ``"target"``; ``state`` is advanced in
    place; ``metrics`` are 0-d f32 tensors on the device under the JAX
    keys. ``dp`` is a ``parallel.dp.DataParallel`` (module docstring)."""
    _check_supported(cfg)
    L = cfg.loss
    bits = cfg.model.quant_bits
    quant = quantize_ste if cfg.model.quant_ste else quantize
    use_c = cfg.model.use_compression_net
    # dropout lives in the U-Net only (the JAX ExpandNetwork has none)
    use_dropout = cfg.model.use_dropout and cfg.model.generator == "unet"
    need_vgg = L.lambda_vgg > 0 and vgg is not None
    need_feats = vgg is not None and (L.lambda_vgg > 0 or L.lambda_style > 0)
    if need_feats and vgg.imagenet_norm != L.vgg_imagenet_norm:
        raise ValueError("vgg.imagenet_norm must equal "
                         "cfg.loss.vgg_imagenet_norm")
    g_losses = make_g_loss_fn(cfg, vgg, steps_per_epoch)
    guard = cfg.health.enabled
    use_pool = cfg.train.pool_size > 0
    ema_decay = cfg.health.ema_decay
    clip = cfg.optim.grad_clip
    grad_norms = cfg.debug.grad_norms
    sentinel = cfg.debug.nan_sentinel
    if dp is not None and use_pool and dp.mesh.batch_shards > 1:
        raise NotImplementedError(
            "pool_size > 0 under data parallelism is not ported: the JAX "
            "pool holds the global batch's pairs; leave --pool_size 0")
    rows = None
    if dp is not None and dp.mesh.spatial > 1:
        from p2p_tpu_torch.parallel.dp import check_spatial_config

        check_spatial_config(cfg, dp.mesh)
        rows = cfg.data.image_size

    def images(x, device):
        t = to_device_image(x, device, train_dtype)
        if rows is not None:
            a, b = row_block(rows, dp.mesh.spatial, dp.mesh.spatial_rank)
            if t.shape[2] != b - a:
                raise ValueError(
                    f"spatial rank {dp.mesh.spatial_rank} got {t.shape[2]} "
                    f"rows of an image of {rows}: expected {b - a} "
                    "(parallel.dp.shard_batch)")
            set_rows(t, rows)
        return t

    def step(state: TrainState, batch: Dict[str, np.ndarray]
             ) -> Tuple[TrainState, Metrics]:
        if dp is not None:
            dp.before_step(state)
        net_g, net_d, net_c = state.net_g, state.net_d, state.net_c
        real_a = images(batch["input"], state.device)
        real_b = images(batch["target"], state.device)
        # G's scales follow the G/D verdict, its statistics and all of
        # net_c's buffers the verdict with the net_c loss (JAX quant_g1
        # against bs_g2, bs_c1 and quant_c1)
        scales_g = stored_scales(net_g)
        ids_g = {id(b) for b in scales_g}
        stats = [b for net in (net_g, net_c) if net is not None
                 for b in net.buffers() if id(b) not in ids_g]
        snap_stats = _Snapshot(stats) if guard else None
        snap_u = (_Snapshot(list(net_d.buffers()) + scales_g) if guard
                  else None)
        gen = (dropout_generator(cfg.train.seed, state.step, state.device)
               if use_dropout else None)

        def g_forward(x):
            return net_g(x) if gen is None else net_g(x, generator=gen)

        # ---- 1. net_c + quantizer (its statistics update is kept) -------
        if use_c:
            # net_c's statistics at the step's start, for the net_c branch
            stats_c0 = {k: v.clone() for k, v in net_c.named_buffers()}
            with torch.no_grad():
                g_input = quant(net_c(real_b), bits)
        else:
            g_input = real_a

        # ---- 2-4. G, D's forwards, G loss ---------------------------------
        fake_b = g_forward(g_input)
        real_pair = keep_rows(torch.cat([real_a, real_b], dim=1), real_a)
        if use_pool:
            pooled, pool1, pool_n1 = pool_lib.device_pool_query(
                state.pool, state.pool_n,
                torch.cat([real_a, fake_b.detach()], dim=1).permute(
                    0, 2, 3, 1),
                pool_lib.pool_generator(cfg.train.seed, state.step,
                                        state.device))
            loss_d, _, pred_real = single_forward_d_losses(
                net_d, pooled.permute(0, 3, 1, 2), real_pair, L.gan_mode)
            pred_fake = net_d(torch.cat([real_a, fake_b], dim=1))
        else:
            loss_d, pred_fake, pred_real = single_forward_d_losses(
                net_d, keep_rows(torch.cat([real_a, fake_b], dim=1), real_a),
                real_pair, L.gan_mode)
        real_feats = target_features(vgg, real_b) if need_feats else None
        loss_g, parts = g_losses(fake_b, pred_fake, pred_real, real_a,
                                 real_b, real_feats, state.step)
        loss_g.backward(inputs=list(net_g.parameters()))
        if dp is not None:
            dp.sync_grads(state.opt_g)
            dp.sync_grads(state.opt_d)

        # ---- 5. G then D updates, unless the guard drops the step --------
        # the grad-norm taps read the raw gradients, before any clip
        norms = (grad_norm_taps({}, g=_grads(state.opt_g),
                                d=_grads(state.opt_d))
                 if grad_norms else {})
        ok = _finite(loss_g, loss_d, dp=dp) if guard else True
        counts = {"nonfinite_g": _apply(state.opt_g, ok, clip,
                                         state.lr_scale),
                  "nonfinite_d": _apply(state.opt_d, ok, clip,
                                         state.lr_scale)}
        if not ok:
            snap_u.restore()
        else:
            if use_pool:
                state.pool, state.pool_n = pool1, pool_n1
            if ema_decay is not None:
                ema_update_(state.ema_g, net_g, ema_decay)

        # ---- 6. net_c branch against the updated G -----------------------
        ok_all = ok
        if use_c:
            cq = quant(functional_call(net_c, stats_c0, (real_b,)), bits)
            # G reads its updated scales and drops this run's proposal
            snap_g = _Snapshot(scales_g)
            fake_ac = g_forward(cq)
            snap_g.restore()
            loss_c = ((fake_ac.float() - real_b.float()) ** 2).mean()
            if need_vgg:
                loss_c = loss_c + vgg_loss(vgg, cq, real_feats) * L.lambda_vgg
            ok_all = ok and (_finite(loss_c, dp=dp) if guard else True)
            if cfg.optim.train_compression_net:
                loss_c.backward(inputs=list(net_c.parameters()))
                if dp is not None:
                    dp.sync_grads(state.opt_c)
                if grad_norms:
                    grad_norm_taps(norms, c=_grads(state.opt_c))
                counts["nonfinite_c"] = _apply(state.opt_c, ok_all, clip,
                                               state.lr_scale)
        else:
            loss_c = torch.zeros((), device=state.device)
        if not ok_all:
            snap_stats.restore()

        state.step += 1
        if dp is not None:
            dp.after_step(state)
        metrics = {"loss_d": loss_d, "loss_g": loss_g.detach(),
                   "loss_c": loss_c.detach(),
                   **{k: v.detach() for k, v in parts.items()},
                   **{k: v.to(state.device, torch.float32)
                      for k, v in counts.items() if v is not None}}
        if guard:
            metrics["health_ok"] = torch.tensor(float(ok_all),
                                                device=state.device)
        metrics.update(norms)
        if dp is not None:
            metrics = dp.mean_metrics(
                metrics, ("loss_d", "loss_g", "loss_c", *parts))
        if sentinel:
            # per-leaf NaN/Inf counts, copied to a pinned buffer behind an
            # event and read one step later (obs/taps.py): no host sync;
            # the effective LR scale rides along, as in JAX
            nan_sentinel({**metrics, "lr_scale": float(state.lr_scale)},
                         tag="train_step")
        return state, metrics

    return step


@contextlib.contextmanager
def _eval_mode(*nets: Optional[nn.Module]) -> Iterator[None]:
    """``nets`` in eval mode for the duration, their modes put back
    after."""
    nets = [n for n in nets if n is not None]
    modes = [n.training for n in nets]
    for n in nets:
        n.eval()
    try:
        yield
    finally:
        for n, mode in zip(nets, modes):
            n.train(mode)


def build_pp_train_step(cfg: Config, mesh, n_micro: int,
                        vgg: Optional[nn.Module] = None,
                        steps_per_epoch: int = 1,
                        train_dtype: Optional[torch.dtype] = None):
    """``step(state, batch) -> (state, metrics)``: the alternating G/D(/C)
    step with the generator's residual trunk on the GPipe schedule over
    ``mesh``'s ``pipe`` axis (counterpart of ``p2p_tpu/train/step.py:600
    build_pp_train_step``; parallel/pp.py). ``state`` is split by
    ``parallel.pp.pp_split_state`` (after ``parallel.place_state`` on a
    mesh); ``batch`` is this rank's rows (``parallel.shard_batch``: pipe
    peers read the same rows), carved into ``n_micro`` microbatches
    mb-major. ``mesh`` None runs the microbatches in sequence on one
    process (a stack holding every stage).

    The loss surface, the single D(fake) forward and the update order are
    :func:`build_train_step`'s. G runs in eval mode (``p2p_tpu/parallel/
    pp.py:392-397``): BatchNorm reads its running statistics and G's are
    not advanced; the instance-norm family is exact against the one-rank
    step. net_c runs in training mode (its BatchNorm through #5, its
    stored scales updated). The trunk's stored int8 scales are frozen for
    the step's microbatches and take the max-combined proposals after the
    G/D verdict (``gpipe_trunk``'s ``quant``). One backward of the G loss
    reaches ``net_g`` and the stage blocks; the skip guard drops every
    update, stage stack included, by a verdict agreed over the world. The
    compression branch runs a second pipelined forward through the
    updated G and stages (the new scales frozen, its proposals dropped),
    whose backward crosses the ring shifts again. Refused with JAX's
    messages: ``health.ema_decay``, ``pool_size > 0`` and a generator
    without a pipelined trunk; with more than one stage also
    ``grad_clip`` and ``grad_norms`` (their global norms would span the
    stages: not ported)."""
    from p2p_tpu_torch.core.mesh import mesh_context
    from p2p_tpu_torch.ops.norm import sync_batchnorm
    from p2p_tpu_torch.parallel.dp import DataParallel
    from p2p_tpu_torch.parallel.pp import (mb_major_flatten,
                                           mb_major_unflatten,
                                           pp_generator_forward,
                                           start_proposals, take_proposals,
                                           trunk_prefix)

    if cfg.health.ema_decay is not None:
        raise ValueError(
            "health.ema_decay is not supported on the pipelined step "
            "(v1 bound: the trunk lives in pp_stages); run EMA configs "
            "unpipelined")
    trunk_prefix(cfg.model)
    if cfg.train.pool_size > 0:
        raise ValueError(
            "build_pp_train_step does not support the historical-fake "
            "pool (pool_size > 0); run pooled configs unpipelined")
    _check_supported(cfg)
    wide = mesh is not None and mesh.pipe > 1
    if wide and (cfg.optim.grad_clip > 0 or cfg.debug.grad_norms):
        raise NotImplementedError(
            "grad_clip and grad_norms on the pipelined step over more than "
            "one stage are not ported (their global norms span the "
            "stages)")
    L = cfg.loss
    bits = cfg.model.quant_bits
    quant = quantize_ste if cfg.model.quant_ste else quantize
    use_c = cfg.model.use_compression_net
    need_vgg = L.lambda_vgg > 0 and vgg is not None
    need_feats = vgg is not None and (L.lambda_vgg > 0 or L.lambda_style > 0)
    g_losses = make_g_loss_fn(cfg, vgg, steps_per_epoch)
    guard = cfg.health.enabled
    clip = cfg.optim.grad_clip
    grad_norms = cfg.debug.grad_norms
    sentinel = cfg.debug.nan_sentinel
    overlap = cfg.parallel.pp_overlap
    dp = DataParallel(mesh) if mesh is not None and mesh.size > 1 else None

    def body(state: TrainState, batch: Dict[str, np.ndarray]):
        net_g, net_d, net_c = state.net_g, state.net_d, state.net_c
        stages = state.pp_stages
        real_a = to_device_image(batch["input"], state.device, train_dtype)
        real_b = to_device_image(batch["target"], state.device, train_dtype)
        n = int(real_a.shape[0])
        if n % n_micro:
            raise ValueError(f"batch {n} not divisible by n_micro={n_micro}")
        scales_s = stored_scales(stages)
        snap_stats = (_Snapshot(list(net_c.buffers())) if guard
                      and net_c is not None else None)
        snap_u = _Snapshot(list(net_d.buffers())) if guard else None

        def g_pp(x):
            with _eval_mode(net_g, stages):
                y = pp_generator_forward(
                    net_g, stages, mb_major_unflatten(x, n_micro), mesh,
                    overlap)
            return mb_major_flatten(y).contiguous(
                memory_format=torch.channels_last)

        # ---- 1. net_c + quantizer (its statistics update is kept) -------
        if use_c:
            stats_c0 = {k: v.clone() for k, v in net_c.named_buffers()}
            with torch.no_grad():
                g_input = quant(net_c(real_b), bits)
        else:
            g_input = real_a

        # ---- 2-4. the pipelined G, D's forwards, G loss -----------------
        start_proposals(stages)
        fake_b = g_pp(g_input)
        proposals = take_proposals(stages, mesh)
        loss_d, pred_fake, pred_real = single_forward_d_losses(
            net_d, torch.cat([real_a, fake_b], dim=1),
            torch.cat([real_a, real_b], dim=1), L.gan_mode)
        real_feats = target_features(vgg, real_b) if need_feats else None
        loss_g, parts = g_losses(fake_b, pred_fake, pred_real, real_a,
                                 real_b, real_feats, state.step)
        loss_g.backward(inputs=list(net_g.parameters())
                        + list(stages.parameters()))
        if dp is not None:
            dp.sync_grads(state.opt_g)
            dp.sync_grads(state.opt_s)
            dp.sync_grads(state.opt_d)

        # ---- 5. G (rest, then stages) and D updates, unless dropped ------
        norms = (grad_norm_taps({}, g=_grads(state.opt_g)
                                + _grads(state.opt_s),
                                d=_grads(state.opt_d))
                 if grad_norms else {})
        ok = _finite(loss_g, loss_d, dp=dp) if guard else True
        zg = _apply(state.opt_g, ok, clip, state.lr_scale)
        zs = _apply(state.opt_s, ok, clip, state.lr_scale)
        counts = {"nonfinite_g": None if zg is None else zg + zs,
                  "nonfinite_d": _apply(state.opt_d, ok, clip,
                                        state.lr_scale)}
        snap_q = _Snapshot(scales_s)
        with torch.no_grad():
            for s, p in zip(scales_s, proposals):
                s.copy_(p)
        if not ok:
            snap_u.restore()

        # ---- 6. net_c branch against the updated G and stages ------------
        ok_all = ok
        if use_c:
            cq = quant(functional_call(net_c, stats_c0, (real_b,)), bits)
            fake_ac = g_pp(cq)
            loss_c = ((fake_ac.float() - real_b.float()) ** 2).mean()
            if need_vgg:
                loss_c = loss_c + vgg_loss(vgg, cq, real_feats) * L.lambda_vgg
            ok_all = ok and (_finite(loss_c, dp=dp) if guard else True)
            if cfg.optim.train_compression_net:
                loss_c.backward(inputs=list(net_c.parameters()))
                if dp is not None:
                    dp.sync_grads(state.opt_c)
                if grad_norms:
                    grad_norm_taps(norms, c=_grads(state.opt_c))
                counts["nonfinite_c"] = _apply(state.opt_c, ok_all, clip,
                                               state.lr_scale)
        else:
            loss_c = torch.zeros((), device=state.device)
        if not ok:
            snap_q.restore()
        if not ok_all and snap_stats is not None:
            snap_stats.restore()

        state.step += 1
        metrics = {"loss_d": loss_d, "loss_g": loss_g.detach(),
                   "loss_c": loss_c.detach(),
                   **{k: v.detach() for k, v in parts.items()},
                   **{k: v.to(state.device, torch.float32)
                      for k, v in counts.items() if v is not None}}
        if guard:
            metrics["health_ok"] = torch.tensor(float(ok_all),
                                                device=state.device)
        metrics.update(norms)
        if dp is not None:
            metrics = dp.mean_metrics(metrics)
        if sentinel:
            nan_sentinel({**metrics, "lr_scale": float(state.lr_scale)},
                         tag="pp_train_step")
        return state, metrics

    def step(state: TrainState, batch: Dict[str, np.ndarray]
             ) -> Tuple[TrainState, Metrics]:
        if state.pp_stages is None:
            raise ValueError(
                "state has no pp_stages — prepare it with "
                "parallel.pp.pp_split_state(state, cfg, mesh)")
        with mesh_context(mesh), \
                sync_batchnorm(cfg.parallel.sync_batchnorm):
            return body(state, batch)

    return step
