"""The video train step (counterpart of ``p2p_tpu/train/video_step.py``:
``:39 VideoTrainState``, ``:63 build_video_models``, ``:83
create_video_train_state`` and ``:128 build_video_train_step``).

Clips travel as (N, T, H, W, C) host batches and run as (N, C, T, H, W)
tensors in ``torch.channels_last_3d`` (memory NTHWC), so the N·T frames
that G and the spatial D take are a view of the clip (models/temporal_d.py
``fold_frames``), and G's frames view back as the fake clip; the pairs
are concatenated on channels, as JAX concatenates them.

``build_video_train_step(cfg, vgg)`` returns ``step(state, batch) ->
(state, metrics)`` in the order of the JAX step:

1. ONE G forward on the folded frames (with the step's dropout noise
   when ``use_dropout``, as train/step.py draws it);
2. train/step.py ``single_forward_d_losses`` for the spatial D on the
   (input ‖ frame) pairs, then for the temporal D on the (input ‖ clip)
   pairs: one D(fake) forward each serves the D loss (gradient to that
   D's parameters only) and the G loss, so each D's ``u`` advances twice
   a step, fake first;
3. the G loss ``g_gan + g_gan_t + g_feat`` (spatial and temporal feature
   matching) with ``g_vgg``, ``g_tv`` and ``g_l1`` under their weights,
   back-propagated through both retained D(fake) graphs into G's
   parameters only;
4. G's, D's and the temporal D's updates, each scaled by
   ``state.lr_scale`` (and clipped with ``grad_clip``, as the JAX
   optimizers clip), unless the skip guard (``health.enabled``) finds
   ``loss_g``, ``loss_d`` or ``loss_dt`` not finite: then no optimizer
   steps and G's running statistics and both Ds' ``u`` return to the
   step's start.

The metrics are the JAX keys: ``loss_d``, ``loss_dt``, ``loss_g``,
``g_gan``, ``g_gan_t``, ``g_feat`` (and ``g_vgg``, ``g_tv``, ``g_l1``
when weighted; no style, angular or Sobel term, as the JAX video step
has none), ``health_ok`` under the guard. The video state has no
compression net, fake pool, EMA generator or stored int8 scales: the
port refuses ``int8_delayed`` and ``ema_decay`` with the JAX messages,
and ``cli/train.py`` a pool.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.core.device import resolve_device
from p2p_tpu_torch.losses.feature_matching import feature_matching_loss
from p2p_tpu_torch.losses.gan import gan_loss
from p2p_tpu_torch.losses.l1 import l1_loss
from p2p_tpu_torch.losses.perceptual import target_features, vgg_loss
from p2p_tpu_torch.models.registry import (apply_init_type, define_D,
                                           define_G, init_weights)
from p2p_tpu_torch.models.temporal_d import (MultiscaleTemporalDiscriminator,
                                             fold_frames, unfold_frames)
from p2p_tpu_torch.ops.tv import total_variation_loss
from p2p_tpu_torch.train.state import Optimizer, make_optimizers
from p2p_tpu_torch.train.step import (Metrics, _apply, _check_supported,
                                      _finite, _Snapshot, dropout_generator,
                                      single_forward_d_losses)
from p2p_tpu_torch.utils.images import ingest


@dataclasses.dataclass
class VideoTrainState:
    step: int
    net_g: nn.Module
    net_d: nn.Module
    net_dt: nn.Module
    opt_g: Optimizer
    opt_d: Optimizer
    opt_dt: Optimizer
    lr_scale: float = 1.0

    @property
    def device(self) -> torch.device:
        return next(self.net_g.parameters()).device


def _refuse_int8_delayed(cfg: Config) -> None:
    if cfg.model.int8_delayed:
        raise ValueError(
            "--int8_delayed is supported on image presets only "
            "(the video step does not thread the 'quant' collection); "
            "use dynamic-scale --int8 for video presets")


def build_video_models(cfg: Config, train_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[nn.Module, nn.Module, nn.Module]:
    """G, the spatial D and the temporal D (``num_D - 1`` scales, at least
    one) of ``cfg`` on the CPU in f32, computing in ``train_dtype``."""
    _refuse_int8_delayed(cfg)
    m = cfg.model
    dt = MultiscaleTemporalDiscriminator(
        in_channels=m.input_nc + m.output_nc, ndf=m.ndf,
        n_layers=m.n_layers_D, num_D=max(1, m.num_D - 1),
        use_spectral_norm=m.use_spectral_norm, dtype=train_dtype)
    return (define_G(m, train_dtype, cfg.image_hw,
                     remat=cfg.parallel.remat), define_D(m, train_dtype), dt)


def create_video_train_state(cfg: Config, seed: int = 0,
                             steps_per_epoch: int = 1,
                             train_dtype: Optional[torch.dtype] = None,
                             device: Union[str, torch.device, None] = None
                             ) -> VideoTrainState:
    """The networks of ``cfg`` with the reference init drawn from ``seed``
    (G, then D, then the temporal D), the kernels re-drawn per
    ``model.init_type`` (net streams 0, 1 and 3), as f32 masters on ``device``
    (``cuda`` unless the caller asks for the CPU), G and D in
    channels_last and the temporal D in channels_last_3d, and fresh
    optimizers."""
    if cfg.health.ema_decay is not None:
        raise ValueError(
            "health.ema_decay is supported on image presets only (the "
            "VideoTrainState carries no EMA tree); unset it for video")
    dev = resolve_device(device)
    g, d, dt = build_video_models(cfg, train_dtype)
    gen = torch.Generator().manual_seed(seed)
    for i, (net, fmt) in enumerate(((g, torch.channels_last),
                                    (d, torch.channels_last),
                                    (dt, torch.channels_last_3d))):
        init_weights(net, gen)
        net.to(dev, memory_format=fmt).train()
        # the temporal D's kernels draw from net stream 3 (net_c's is 2)
        apply_init_type(net, seed, i if i < 2 else 3, cfg.model.init_type,
                        cfg.model.init_gain)
    opts = make_optimizers(cfg, [g, d, dt], steps_per_epoch)
    return VideoTrainState(0, g, d, dt, *opts)


def to_device_clip(x: np.ndarray, device: torch.device,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An NTHWC host batch → a channels_last_3d (N, C, T, H, W) tensor on
    ``device``, normalized there (utils/images.ingest) and cast to
    ``dtype``; an NTHWC tensor viewed as (N, C, T, H, W) is
    channels_last_3d already."""
    t = torch.as_tensor(x).to(device, non_blocking=True)
    return ingest(t.permute(0, 4, 1, 2, 3), dtype)


def build_video_train_step(cfg: Config, vgg: Optional[nn.Module] = None,
                           train_dtype: Optional[torch.dtype] = None):
    """``step(state, batch) -> (state, metrics)`` for ``cfg``; ``vgg`` is
    the frozen VGG19 trunk (needed when ``lambda_vgg > 0``),
    ``train_dtype`` the dtype the clips enter in. ``batch`` holds NTHWC
    host arrays ``"input"`` and ``"target"``; ``state`` is advanced in
    place; ``metrics`` are 0-d f32 tensors on the device under the JAX
    keys."""
    _check_supported(cfg)
    _refuse_int8_delayed(cfg)
    L = cfg.loss
    use_dropout = cfg.model.use_dropout and cfg.model.generator == "unet"
    need_vgg = L.lambda_vgg > 0 and vgg is not None
    if need_vgg and vgg.imagenet_norm != L.vgg_imagenet_norm:
        raise ValueError("vgg.imagenet_norm must equal "
                         "cfg.loss.vgg_imagenet_norm")
    guard = cfg.health.enabled
    clip = cfg.optim.grad_clip
    n_layers = cfg.model.n_layers_D

    def g_losses(fake, pred_fake, pred_real, pred_fake_t, pred_real_t,
                 real_b, real_feats):
        l_gan = gan_loss(pred_fake, True, L.gan_mode,
                         for_discriminator=False)
        l_gan_t = gan_loss(pred_fake_t, True, L.gan_mode,
                           for_discriminator=False)
        parts = {"g_gan": l_gan, "g_gan_t": l_gan_t}
        total = l_gan + l_gan_t
        if L.lambda_feat > 0:
            parts["g_feat"] = (
                feature_matching_loss(pred_fake, pred_real, n_layers,
                                      L.lambda_feat)
                + feature_matching_loss(pred_fake_t, pred_real_t, n_layers,
                                        L.lambda_feat))
        if need_vgg:
            parts["g_vgg"] = vgg_loss(vgg, fake, real_feats) * L.lambda_vgg
        if L.lambda_tv > 0:
            parts["g_tv"] = total_variation_loss(fake) * L.lambda_tv
        if L.lambda_l1 > 0:
            parts["g_l1"] = l1_loss(fake, real_b) * L.lambda_l1
        for k in ("g_feat", "g_vgg", "g_tv", "g_l1"):
            if k in parts:
                total = total + parts[k]
        return total, parts

    def step(state: VideoTrainState, batch: Dict[str, np.ndarray]
             ) -> Tuple[VideoTrainState, Metrics]:
        net_g, net_d, net_dt = state.net_g, state.net_d, state.net_dt
        real_a = to_device_clip(batch["input"], state.device, train_dtype)
        real_b = to_device_clip(batch["target"], state.device, train_dtype)
        n = real_a.shape[0]
        a_f, b_f = fold_frames(real_a), fold_frames(real_b)
        snap = (_Snapshot(list(net_g.buffers()) + list(net_d.buffers())
                          + list(net_dt.buffers())) if guard else None)

        # ---- 1. ONE G forward on the folded frames -----------------------
        if use_dropout:
            fake_f = net_g(a_f, generator=dropout_generator(
                cfg.train.seed, state.step, state.device))
        else:
            fake_f = net_g(a_f)
        fake_clip = unfold_frames(fake_f, n)

        # ---- 2. spatial D, then temporal D: one D(fake) forward each ----
        loss_d, pred_fake, pred_real = single_forward_d_losses(
            net_d, torch.cat([a_f, fake_f], dim=1),
            torch.cat([a_f, b_f], dim=1), L.gan_mode)
        loss_dt, pred_fake_t, pred_real_t = single_forward_d_losses(
            net_dt, torch.cat([real_a, fake_clip], dim=1),
            torch.cat([real_a, real_b], dim=1), L.gan_mode)

        # ---- 3. the G loss, into G's parameters only ---------------------
        real_feats = target_features(vgg, b_f) if need_vgg else None
        loss_g, parts = g_losses(fake_f, pred_fake, pred_real, pred_fake_t,
                                 pred_real_t, b_f, real_feats)
        loss_g.backward(inputs=list(net_g.parameters()))

        # ---- 4. the three updates, unless the guard drops the step -------
        ok = _finite(loss_g, loss_d, loss_dt) if guard else True
        for opt in (state.opt_g, state.opt_d, state.opt_dt):
            _apply(opt, ok, clip, state.lr_scale)
        if not ok:
            snap.restore()

        state.step += 1
        metrics = {"loss_d": loss_d, "loss_dt": loss_dt,
                   "loss_g": loss_g.detach(),
                   **{k: v.detach() for k, v in parts.items()}}
        if guard:
            metrics["health_ok"] = torch.tensor(float(ok),
                                                device=state.device)
        return state, metrics

    return step

