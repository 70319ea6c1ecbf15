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
``lr_scale`` is the JAX state's host-controlled multiplier of every update
(the ``plateau`` policy's scale; 1 otherwise). With
``OptimConfig.moment_dtype`` the optimizer is :class:`AdamLP` (``p2p_tpu/
train/state.py:238 scale_by_adam_lp``): both moments stored in that dtype,
the arithmetic in f32. With ``OptimConfig.grad_clip`` each optimizer's
gradients first have their non-finite entries zeroed and are then clipped
to that global norm (:func:`clip_grads_`, optax's ``_zero_nonfinite`` then
``clip_by_global_norm``).

With ``TrainConfig.pool_size`` the state carries the historical-fake ring
``pool`` (P, H, W, C) in the images' dtype and its fill count ``pool_n``
(utils/pool.py); with ``HealthConfig.ema_decay`` it carries ``ema_g``,
smoothed f32 copies of G's parameters (not of its running statistics),
seeded with the initial parameters and moved by :func:`ema_update_`.
Split over a pipe mesh (parallel/pp.py ``pp_split_state``) it carries
``pp_stages``, this rank's trunk blocks, and their optimizer ``opt_s``
(``p2p_tpu/train/state.py`` ``pp_stages``/``opt_s``); both are None when
the state is flat.

Under ``int8_delayed`` the JAX state's ``quant_g``, ``quant_d`` and
``quant_c`` collections are the ``amax_x`` buffers of G's, D's and net_c's
int8 modules (ops/int8.py ``stored_scales``); ``create_train_state``
initializes them as flax init does (:func:`init_amax`): G and net_c from
one forward each on the sample batch's ``input`` in eval mode (flax's
``train=False``: BatchNorm reads its fresh running statistics, no
dropout), D from one forward on the (input ‖ target) pair.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from p2p_tpu_torch.core.config import Config
from p2p_tpu_torch.core.device import resolve_device
from p2p_tpu_torch.models.registry import (apply_init_type, define_C,
                                           define_D, define_G, init_weights)
from p2p_tpu_torch.models.vgg import (VGG19Features, init_vgg19,
                                      load_vgg19_npz, vgg19_npz_path)
from p2p_tpu_torch.ops.int8 import quant_modules
from p2p_tpu_torch.train.schedules import make_schedule
from p2p_tpu_torch.utils.images import ingest

Optimizer = Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]


@dataclasses.dataclass
class TrainState:
    step: int
    net_g: nn.Module
    net_d: nn.Module
    net_c: Optional[nn.Module]
    opt_g: Optimizer
    opt_d: Optimizer
    opt_c: Optional[Optimizer]
    lr_scale: float = 1.0
    pool: Optional[torch.Tensor] = None
    pool_n: Optional[torch.Tensor] = None
    ema_g: Optional[Dict[str, torch.Tensor]] = None
    # the pipe split (parallel/pp.py pp_split_state): this rank's trunk
    # stage and its optimizer; None when flat
    pp_stages: Optional[nn.Module] = None
    opt_s: Optional[Optimizer] = None

    @property
    def device(self) -> torch.device:
        return next(self.net_g.parameters()).device


def build_models(cfg: Config, train_dtype: Optional[torch.dtype] = None
                 ) -> Tuple[nn.Module, nn.Module, Optional[nn.Module]]:
    """G, D and C of ``cfg`` on the CPU in f32, computing in
    ``train_dtype``; C is None without a compression net."""
    net_c = (define_C(cfg.model, train_dtype)
             if cfg.model.use_compression_net else None)
    return (define_G(cfg.model, train_dtype, cfg.image_hw,
                     remat=cfg.parallel.remat),
            define_D(cfg.model, train_dtype), net_c)


class AdamLP(torch.optim.Optimizer):
    """Adam whose two moments are stored in ``moment_dtype`` while the
    arithmetic runs in f32, in optax's order (``scale_by_adam_lp`` then
    ``scale_by_learning_rate``): ``mu = β1·m + (1−β1)·g``, ``nu = β2·v +
    (1−β2)·g²``, ``u = (mu / (1−β1^t)) / (sqrt(nu / (1−β2^t)) + ε)``,
    ``p ← p − lr·u``, then the moments are stored rounded. The state keeps
    torch's names (``step``, ``exp_avg``, ``exp_avg_sq``); ``lr`` follows a
    ``LambdaLR``."""

    def __init__(self, params, lr: float, betas: Tuple[float, float],
                 eps: float = 1e-8,
                 moment_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        self.moment_dtype = moment_dtype

    def load_state_dict(self, state_dict) -> None:
        """torch's load casts floating state to the parameter's dtype: the
        moments go back to ``moment_dtype`` (exact, as they were stored
        in it)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k] = st[k].to(self.moment_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(
                        p, dtype=self.moment_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=self.moment_dtype)
                st["step"] += 1
            t = self.state[params[0]]["step"]
            grads = [p.grad.float() for p in params]
            ms = [self.state[p]["exp_avg"] for p in params]
            vs = [self.state[p]["exp_avg_sq"] for p in params]
            mu = [m.float() for m in ms]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            nu = [v.float() for v in vs]
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            den = torch._foreach_div(nu, 1 - b2 ** t)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mu, 1 - b1 ** t)
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
            torch._foreach_copy_(ms, mu)
            torch._foreach_copy_(vs, nu)


@torch.no_grad()
def clip_grads_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """In place, optax's ``chain(_zero_nonfinite(), clip_by_global_norm(
    max_norm))``: every non-finite entry set to 0, then with the global
    norm ‖g‖ of what remains, g unchanged when ‖g‖ < max_norm, else
    ``g / ‖g‖ · max_norm`` (two roundings, no ε: not torch's
    ``clip_grad_norm_``). Returns the number of entries zeroed (0-d
    int32). No host sync."""
    if not grads:
        return torch.zeros((), dtype=torch.int32)
    zeroed = []
    for g in grads:
        bad = ~torch.isfinite(g)
        zeroed.append(bad.sum(dtype=torch.int32))
        g.masked_fill_(bad, 0.0)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return sum(zeroed)


@torch.no_grad()
def ema_update_(ema: Dict[str, torch.Tensor], net: nn.Module,
                decay: float) -> None:
    """``e ← e·d + p·(1−d)`` for each of ``net``'s parameters, in the
    EMA's dtype (the JAX ``ema_update``): at d = 0 the EMA equals the
    parameters bitwise. A ZeRO-sharded EMA (parallel/rules.py) moves its
    range the same way."""
    if hasattr(ema, "update_"):
        ema.update_(decay)
        return
    names = list(ema)
    params = dict(net.named_parameters())
    es = [ema[k] for k in names]
    ps = [params[k].detach().to(ema[k].dtype) for k in names]
    torch._foreach_mul_(es, float(decay))
    torch._foreach_add_(es, torch._foreach_mul(ps, 1.0 - float(decay)))


def make_optimizers(cfg: Config, nets: List[nn.Module],
                    steps_per_epoch: int) -> List[Optimizer]:
    """One Adam (the reference's lr and betas, ε 1e-8 as optax; an
    :class:`AdamLP` with ``moment_dtype``) with the configured schedule
    per network."""
    schedule = make_schedule(cfg.optim, steps_per_epoch,
                             cfg.train.epoch_count)
    betas = (cfg.optim.beta1, cfg.optim.beta2)
    out = []
    for net in nets:
        if cfg.optim.moment_dtype:
            opt = AdamLP(net.parameters(), lr=cfg.optim.lr, betas=betas,
                         eps=1e-8, moment_dtype=getattr(
                             torch, cfg.optim.moment_dtype))
        else:
            opt = torch.optim.Adam(net.parameters(), lr=cfg.optim.lr,
                                   betas=betas, eps=1e-8)
        out.append((opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)))
    return out


@torch.no_grad()
def init_amax(net: nn.Module, x: torch.Tensor, train: bool = True) -> None:
    """Set every stored activation scale (``amax_x``) of ``net`` as flax
    init does: one forward on ``x`` (in training mode, or in eval mode
    with ``train=False``), in which each int8 module with a stored scale
    first stores max|x| of its own input (under a fused epilogue: the
    epilogue's amax at sx = 1) and then runs with it. ``net`` is left in
    its mode."""
    quants = quant_modules(net)
    if not quants:
        return
    mode = net.training
    net.train(train)
    for m in quants:
        m.init_amax = True
    try:
        net(x)
    finally:
        for m in quants:
            m.init_amax = False
        net.train(mode)


def create_train_state(cfg: Config, seed: int = 0, steps_per_epoch: int = 1,
                       train_dtype: Optional[torch.dtype] = None,
                       device: Optional[Union[str, torch.device]] = None,
                       sample_batch: Optional[Dict[str, np.ndarray]] = None
                       ) -> TrainState:
    """The networks of ``cfg`` with the reference init drawn from ``seed``
    (G, then D, then C) and, with ``model.init_type`` other than
    ``normal``, every kernel re-drawn from that law (models/registry.py
    ``apply_init_type``, net streams 0, 1, 2), as f32 masters on ``device``
    (``cuda`` unless the caller asks for the CPU) in channels_last, and
    fresh optimizers. Under
    ``int8_delayed`` the stored activation scales are initialized from
    ``sample_batch`` (NHWC host arrays ``"input"`` and ``"target"``, as a
    train step takes), which is then required."""
    if cfg.model.int8_delayed and sample_batch is None:
        raise ValueError("int8_delayed needs a sample_batch: the stored "
                         "activation scales are initialized from it")
    dev = resolve_device(device)
    g, d, c = build_models(cfg, train_dtype)
    nets = [g, d] if c is None else [g, d, c]
    gen = torch.Generator().manual_seed(seed)
    for i, net in enumerate(nets):
        init_weights(net, gen)
        net.to(dev, memory_format=torch.channels_last).train()
        apply_init_type(net, seed, i, cfg.model.init_type,
                        cfg.model.init_gain)
    if cfg.model.int8_delayed:
        x = _image(sample_batch["input"], dev)
        init_amax(g, x, train=False)
        init_amax(d, torch.cat([x, _image(sample_batch["target"], dev)],
                               dim=1))
        if c is not None:
            init_amax(c, x, train=False)
    opts = make_optimizers(cfg, nets, steps_per_epoch)
    if c is None:
        opts.append(None)
    pool = pool_n = None
    if cfg.train.pool_size > 0:
        h, w = cfg.image_hw
        pool = torch.zeros((cfg.train.pool_size, h, w, cfg.model.input_nc
                            + cfg.model.output_nc),
                           dtype=train_dtype or torch.float32, device=dev)
        pool_n = torch.zeros((), dtype=torch.int32, device=dev)
    ema = ({k: p.detach().clone() for k, p in g.named_parameters()}
           if cfg.health.ema_decay is not None else None)
    return TrainState(0, g, d, c, *opts, pool=pool, pool_n=pool_n, ema_g=ema)


def _image(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """An NHWC host batch as a channels_last f32 (N, C, H, W) tensor on
    ``device``, normalized there (the step's ``to_device_image`` in f32)."""
    return ingest(torch.as_tensor(x).to(device).permute(0, 3, 1, 2))


def load_vgg19(seed: int = 190,
               device: Optional[Union[str, torch.device]] = None,
               imagenet_norm: bool = False) -> VGG19Features:
    """The frozen VGG19 trunk on ``device`` in channels_last: the
    pretrained ``.npz`` when there is one (models/vgg.py
    vgg19_npz_path), else random weights from ``seed`` (init_vgg19)."""
    path = vgg19_npz_path()
    if path is not None:
        vgg = load_vgg19_npz(VGG19Features(imagenet_norm), path)
    else:
        vgg = init_vgg19(VGG19Features(imagenet_norm),
                         torch.Generator().manual_seed(seed))
    return vgg.to(resolve_device(device),
                  memory_format=torch.channels_last).eval()
