"""Train state (counterpart of ``p2p_tpu/train/state.py:22 TrainState``,
``:283 make_optimizers`` and ``:342 create_train_state``).

The JAX state is one immutable pytree of parameters, collections and
optimizer states. Here it holds the networks (net_c and its optimizer are
``None`` when the preset has no compression net), whose running
statistics (BatchNorm ``mean``/``var``, the flax ``batch_stats``) and
spectral-norm ``u`` (flax ``spectral``) are buffers that a train step
updates in place, and one ``torch.optim.Adam`` with a ``LambdaLR`` per
network. Adam with β = (0.5, 0.999) and ε = 1e-8 is ``optax.adam``'s
update, and the scheduler's count of applied updates is optax's count.
The JAX state's ``lr_scale`` (the plateau policy's knob) has no
counterpart: the port has the lambda policy only.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.core.device import resolve_device
from p2p_tpu_torch.models.registry import define_C, define_D, define_G, \
    init_weights
from p2p_tpu_torch.models.vgg import VGG19Features, init_vgg19
from p2p_tpu_torch.train.schedules import make_schedule

Optimizer = Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]


@dataclasses.dataclass
class TrainState:
    step: int
    net_g: nn.Module
    net_d: nn.Module
    net_c: Optional[nn.Module]
    opt_g: Optimizer
    opt_d: Optimizer
    opt_c: Optional[Optimizer]

    @property
    def device(self) -> torch.device:
        return next(self.net_g.parameters()).device


def build_models(cfg: Config, train_dtype: Optional[torch.dtype] = None
                 ) -> Tuple[nn.Module, nn.Module, Optional[nn.Module]]:
    """G, D and C of ``cfg`` on the CPU in f32, computing in
    ``train_dtype``; C is None without a compression net."""
    net_c = (define_C(cfg.model, train_dtype)
             if cfg.model.use_compression_net else None)
    return (define_G(cfg.model, train_dtype, cfg.image_hw),
            define_D(cfg.model, train_dtype), net_c)


def make_optimizers(cfg: Config, nets: List[nn.Module],
                    steps_per_epoch: int) -> List[Optimizer]:
    """One Adam (the reference's lr and betas, ε 1e-8 as optax) with the
    configured schedule per network."""
    schedule = make_schedule(cfg.optim, steps_per_epoch,
                             cfg.train.epoch_count)
    out = []
    for net in nets:
        opt = torch.optim.Adam(net.parameters(), lr=cfg.optim.lr,
                               betas=(cfg.optim.beta1, cfg.optim.beta2),
                               eps=1e-8)
        out.append((opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)))
    return out


def create_train_state(cfg: Config, seed: int = 0, steps_per_epoch: int = 1,
                       train_dtype: Optional[torch.dtype] = None,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> TrainState:
    """The networks of ``cfg`` with the reference init drawn from ``seed``
    (G, then D, then C), as f32 masters on ``device`` (``cuda`` unless the
    caller asks for the CPU) in channels_last, and fresh optimizers."""
    dev = resolve_device(device)
    g, d, c = build_models(cfg, train_dtype)
    nets = [g, d] if c is None else [g, d, c]
    gen = torch.Generator().manual_seed(seed)
    for net in nets:
        init_weights(net, gen)
        net.to(dev, memory_format=torch.channels_last).train()
    opts = make_optimizers(cfg, nets, steps_per_epoch)
    if c is None:
        return TrainState(0, g, d, None, *opts, None)
    return TrainState(0, g, d, c, *opts)


def load_vgg19(seed: int = 190,
               device: Optional[Union[str, torch.device]] = None,
               imagenet_norm: bool = False) -> VGG19Features:
    """The frozen VGG19 trunk with random weights from ``seed``
    (models/vgg.py init_vgg19), on ``device`` in channels_last."""
    vgg = init_vgg19(VGG19Features(imagenet_norm),
                     torch.Generator().manual_seed(seed))
    return vgg.to(resolve_device(device),
                  memory_format=torch.channels_last).eval()
