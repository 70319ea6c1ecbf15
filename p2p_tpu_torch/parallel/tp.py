"""Tensor parallelism over the ``model`` mesh axis (counterpart of
``p2p_tpu/parallel/tp.py``: ``:112-155 _pair_spec/_tp_spec``, ``:157
tp_leaf_spec``, ``:183 place_state_tp``).

The JAX package annotates Megatron-style channel shards on the widest
conv pairs and GSPMD inserts the collectives. Here each rank of a model
group holds only its shard of such a conv's weight and the collectives
are written out, as four autograd Functions over the model group:

- *copy to model ranks* (forward identity, backward all-reduce): the
  replicated input of a C_out-sharded conv;
- *reduce from model ranks* (forward all-reduce, backward identity): the
  partial outputs of a C_in-sharded conv, its bias added once after;
- *gather from model ranks* (forward all-gather of the channel slices,
  backward this rank's slice): a C_out-sharded output that something
  other than its C_in-sharded partner reads (a discriminator's feature
  tap, a U-Net skip);
- *scatter to model ranks* (forward this rank's slice, backward
  all-gather): the whole input of a C_in-sharded conv whose producer did
  not keep a slice.

A Megatron pair whose in-between is per-channel and parameter-free (the
residual blocks', the ResNet encoder's and decoder's pairs with an
instance norm or none) keeps the slice: the out conv's output stays this
rank's channels, the norm and activation run on them (kernels #1 and #3
on the local C, one contiguous channels_last tensor), and the in conv
contracts them, one all-reduce a pair. Everything else gathers and
scatters, which is exact and costs a collective a conv.

A spectral-normed conv's power iteration all-reduces its partial products
and norms over the model group (:func:`tp_spectral_sigma`), so σ and
``u`` are the one-device values to rounding, ``u`` whole on every rank.

The assignment is the tables of parallel/rules.py (:func:`tp_assignment`);
:func:`tp_leaf_spec` is the same tables in the JAX reference's form.
:func:`place_state_tp` cuts every sharded parameter of a train state
(replicated from rank 0 first) to this rank's shard, with its Adam
moments (created on the shard by the first step) and its EMA;
:func:`tp_full` gathers the whole tensors for a save or a restore and
cuts them again after, so checkpoints stay in the one-device format.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from p2p_tpu_torch.core.mesh import MODEL_AXIS, Mesh
from p2p_tpu_torch.parallel.halo import gather_blocks

#: the conv pairs whose in-between keeps the slice: (parent class name,
#: out child, in child)
_SLICE_PAIRS = (
    ("ResnetBlock", "ConvLayer_0", "ConvLayer_1"),
    ("ResnetGenerator", "ConvLayer_3", "ConvLayer_4"),
    ("ResnetGenerator", "UpsampleConvLayer_0", "UpsampleConvLayer_1"),
)


# ------------------------------------------------- the reference assignment
def conv_io(name: str, shape) -> Optional[Tuple[int, ...]]:
    """The channel counts of a parameter of the port: ``(c_in, c_out)`` of
    a 2-D conv kernel read from its layout (a layer's own ``kernel`` HWIO,
    a U-Net ``up{i}`` transposed conv's weight (I, O, kh, kw), any other
    conv's OIHW), ``(c,)`` of a bias, None for anything else (3-D kernels
    included: no rule shards them)."""
    shape = tuple(int(d) for d in shape)
    if name.endswith(".bias") and len(shape) == 1:
        return shape
    if len(shape) != 4:
        return None
    if name.endswith(".kernel"):
        return shape[2], shape[3]
    if not name.endswith(".weight"):
        return None
    if re.search(r"(?:^|\.)up\d+\.weight$", name):
        return shape[0], shape[1]
    return shape[1], shape[0]


def tp_leaf_spec(name: str, shape, axis_size: int,
                 min_ch: int = 512) -> Optional[str]:
    """The role of ONE parameter of the port (``name`` as in its network's
    ``named_parameters``, ``shape`` the port's) at a (possibly
    hypothetical) model-axis width: ``"out"``, ``"in"`` or None
    (replicated), by the JAX ``tp_leaf_spec`` law: the tables of
    parallel/rules.py in their reference form (``make_tp_rules(leaf=
    True)``). No mesh, no devices."""
    from p2p_tpu_torch.parallel.rules import make_tp_rules, match_rules

    io = conv_io(name, shape)
    if io is None:
        return None
    return match_rules(make_tp_rules(axis_size, min_ch, leaf=True), name, io)


def tp_assignment(net: nn.Module, axis_size: int, min_ch: int = 512,
                  rules=None) -> Dict[str, Optional[str]]:
    """Every parameter of ``net`` → its role: by ``rules`` (parallel/
    rules.py; the ``model`` entry of ``trainstate_rules`` by default)."""
    from p2p_tpu_torch.parallel.rules import match_rules, trainstate_rules

    rules = rules or trainstate_rules({MODEL_AXIS: axis_size}, min_ch)
    out = {}
    for name, p in net.named_parameters():
        io = conv_io(name, p.shape)
        out[name] = None if io is None else match_rules(rules, name, io)
    return out


# ------------------------------------------------------------ collectives
@dataclasses.dataclass
class TPConv:
    """A conv's shard: ``role`` (``"out"`` or ``"in"``), the model group,
    this rank's index and the group's size; ``keep`` (an out conv) leaves
    its output as this rank's channels for its in partner."""

    role: str
    group: Optional[object]
    index: int
    size: int
    keep: bool = False

    def block(self, c: int) -> Tuple[int, int]:
        """This rank's channels ``[a, b)`` of ``c``."""
        return self.index * c // self.size, (self.index + 1) * c // self.size


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_channels(x: torch.Tensor, tp: TPConv, c: int) -> torch.Tensor:
    """The whole ``c`` channels on every rank of the model group from each
    rank's block of ``x``'s dim 1 (parallel/halo.py ``gather_blocks``:
    exact bits, x's layout)."""
    return gather_blocks(x, 1, c, tp.block(c)[0], tp.group)


def _slice(x: torch.Tensor, tp: TPConv) -> torch.Tensor:
    a, b = tp.block(x.shape[1])
    y = x.narrow(1, a, b - a)
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return y.contiguous(memory_format=torch.channels_last)
    return y.contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, c):
        ctx.tp = tp
        return gather_channels(x, tp, c)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.tp), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.c = tp, x.shape[1]
        return _slice(x, tp)

    @staticmethod
    def backward(ctx, g):
        return gather_channels(g.contiguous(), ctx.tp, ctx.c), None


def copy_to_model(x: torch.Tensor, tp: TPConv) -> torch.Tensor:
    return _Copy.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TPConv) -> torch.Tensor:
    return _Reduce.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, tp: TPConv, c: int) -> torch.Tensor:
    return _Gather.apply(x, tp, c)


def scatter_to_model(x: torch.Tensor, tp: TPConv) -> torch.Tensor:
    return _Scatter.apply(x, tp)


#: the TP layers' forward collectives (each one's adjoint runs in the
#: backward): calls and bytes of the tensor each takes, by kind; the
#: int8 convs' model-group all-reduces (parallel ops/int8.py
#: ``_TPInt8Conv``) count forward and backward alike: ``int32_sum`` (the
#: accumulators) and ``amax_max`` (the input, weight and cotangent amax)
tp_stats: Dict[str, Dict[str, int]] = {
    k: {"calls": 0, "bytes": 0}
    for k in ("copy", "reduce", "gather", "scatter", "sigma", "int32_sum",
              "amax_max")}


def reset_tp_stats() -> None:
    for v in tp_stats.values():
        v["calls"] = v["bytes"] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    tp_stats[kind]["calls"] += 1
    tp_stats[kind]["bytes"] += t.numel() * t.element_size()


def model_allreduce(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``t`` all-reduced over a model group, MAX for ``kind`` "amax_max"
    and SUM otherwise (not differentiable), counted in :data:`tp_stats`
    under ``kind``."""
    out = t.detach().clone()
    _count(kind, out)
    dist.all_reduce(out, op=dist.ReduceOp.MAX if kind == "amax_max"
                    else dist.ReduceOp.SUM, group=group)
    return out


def tp_int8_input(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """The input of a sharded int8 conv: an "in" conv given the whole
    channels takes this rank's (scatter); otherwise x as it is (an "out"
    conv's input is whole, an "in" conv's kept slice is this rank's)."""
    tp: TPConv = conv.p2p_tp
    if tp.role == "in" and x.shape[1] == conv.p2p_tp_io[0]:
        _count("scatter", x)
        return scatter_to_model(x, tp)
    return x


def tp_int8_output(y: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """The output of a sharded int8 conv (the int32 sums done inside it)
    with its bias: an "out" conv's channels get this rank's slice of the
    bias and are gathered unless the pair keeps the slice; an "in" conv's
    whole output gets the whole bias."""
    tp: TPConv = conv.p2p_tp
    bias = getattr(conv, "bias", None)
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, *([1] * (y.dim() - 2)))
    if tp.role == "out" and not tp.keep:
        _count("gather", y)
        return gather_from_model(y, tp, conv.p2p_tp_io[1])
    return y


def tp_conv(tp: TPConv, fn, x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor], c_in: int, c_out: int,
            **kw) -> torch.Tensor:
    """``fn(x, weight, bias, **kw)`` (``F.conv2d`` or
    ``F.conv_transpose2d``, x and the weight already in the compute dtype)
    of a sharded conv of ``c_in`` → ``c_out`` channels: the copy, the
    conv on this rank's shard and the gather of an out conv (the slice
    kept with ``tp.keep``); the scatter (unless x is the slice already),
    the partial conv, the reduce and the bias of an in conv."""
    if tp.role == "out":
        _count("copy", x)
        y = fn(copy_to_model(x, tp), weight, bias, **kw)
        if tp.keep:
            return y
        _count("gather", y)
        return gather_from_model(y, tp, c_out)
    if x.shape[1] == c_in:
        _count("scatter", x)
        x = scatter_to_model(x, tp)
    y = fn(x, weight, None, **kw)
    _count("reduce", y)
    y = reduce_from_model(y, tp)
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, *([1] * (y.dim() - 2)))
    return y


def tp_cast_conv(conv: nn.Module, x: torch.Tensor,
                 dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``ops/conv.cast_conv`` of an ``nn.Conv2d`` / ``nn.ConvTranspose2d``
    that holds its shard (``conv.p2p_tp``)."""
    tp: TPConv = conv.p2p_tp
    dt = dtype or torch.promote_types(x.dtype, conv.weight.dtype)
    bias = None if conv.bias is None else conv.bias.to(dt)
    transpose = isinstance(conv, nn.ConvTranspose2d)
    fn = F.conv_transpose2d if transpose else F.conv2d
    return tp_conv(tp, fn, x.to(dt), conv.weight.to(dt), bias,
                   conv.p2p_tp_io[0], conv.p2p_tp_io[1],
                   stride=conv.stride, padding=conv.padding)


class _SumGrad(torch.autograd.Function):
    """The sum over the model group; its cotangent is the sum of the
    ranks' cotangents (σ: each rank's output depends on the global σ)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _sum(t: torch.Tensor, tp: TPConv) -> torch.Tensor:
    t = t.clone()
    dist.all_reduce(t, group=tp.group)
    return t


def _normalized(x: torch.Tensor, sq: torch.Tensor, eps: float = 1e-12
                ) -> torch.Tensor:
    return x / (torch.sqrt(sq) + eps)


def tp_spectral_sigma(w_mat: torch.Tensor, u: torch.Tensor, tp: TPConv
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power-iteration step of a sharded (rows, cols) kernel matrix —
    rows (C_out) split for an out conv, columns (C_in) for an in conv —
    from the whole ``u``: (σ, the whole new u), with the partial products
    and squared norms all-reduced over the model group; σ carries the
    gradient to this rank's shard."""
    wm = w_mat.detach()
    _count("sigma", u)
    if tp.role == "out":
        a, b = tp.block(u.shape[0])
        u_r = u[a:b]
        v = _sum(wm.t() @ u_r, tp)
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        un = wm @ v
        un = _normalized(un, _sum(un.dot(un), tp))
        sigma = _SumGrad.apply(un @ w_mat @ v, tp.group)
        u_new = torch.zeros_like(u)
        u_new[a:b] = un
        return sigma, _sum(u_new, tp)
    v = wm.t() @ u
    v = _normalized(v, _sum(v.dot(v), tp))
    un = _sum(wm @ v, tp)
    un = un / (torch.linalg.vector_norm(un) + 1e-12)
    sigma = _SumGrad.apply(un @ w_mat @ v, tp.group)
    return sigma, un


# -------------------------------------------------------------- placement
def _layout_dim(module: nn.Module, pname: str, role: str) -> int:
    """The dimension of ``module``'s parameter ``pname`` that a role
    splits."""
    if pname == "bias":
        return 0
    if pname == "kernel":                               # HWIO
        return 3 if role == "out" else 2
    if isinstance(module, nn.ConvTranspose2d):          # (I, O, kh, kw)
        return 1 if role == "out" else 0
    return 0 if role == "out" else 1                    # (O, I, kh, kw)


def _cut(t: torch.Tensor, dim: int, tp: TPConv) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``, dense, in t's layout."""
    a, b = tp.block(t.shape[dim])
    piece = t.narrow(dim, a, b - a)
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last) \
            and not t.is_contiguous():
        return piece.contiguous(memory_format=torch.channels_last)
    return piece.contiguous()


def _gather_dim(t: torch.Tensor, dim: int, full: int, tp: TPConv
                ) -> torch.Tensor:
    """The whole tensor (``full`` along ``dim``) from each rank's block."""
    return gather_blocks(t, dim, full, tp.block(full)[0], tp.group)


@dataclasses.dataclass
class Shard:
    """One sharded parameter: its network field and name, the module and
    the attribute holding it, the split dimension and its whole size."""

    net: str
    name: str
    module: nn.Module
    attr: str
    dim: int
    full: int


def _module_of(net: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, attr = name.rpartition(".")
    return (net.get_submodule(path) if path else net), attr


def _keeps_slice(net: nn.Module, roles: Dict[str, Optional[str]]
                 ) -> List[str]:
    """The out convs (their module paths) whose in partner is sharded and
    whose in-between is per-channel and parameter-free."""
    kept = []
    for path, mod in net.named_modules():
        for parent, a, b in _SLICE_PAIRS:
            if type(mod).__name__ != parent:
                continue
            if isinstance(getattr(mod, "na", None), nn.Module):
                continue                     # a norm with parameters
            pre = f"{path}." if path else ""
            wa, wb = f"{pre}{a}.conv.weight", f"{pre}{b}.conv.weight"
            if roles.get(wa) == "out" and roles.get(wb) == "in":
                kept.append(f"{pre}{a}.conv")
    return kept


def shard_module(net: nn.Module, mesh: Mesh, min_ch: int, field: str = ""
                 ) -> List[Shard]:
    """Cut ``net``'s sharded parameters (its :func:`tp_assignment` on
    ``mesh``'s model axis) to this rank's shard in place, mark each
    sharded conv (``p2p_tp``, ``p2p_tp_io``) and return the shards.
    Raises for a sharded parameter of a module with no TP form."""
    from p2p_tpu_torch.ops.int8 import QuantConv
    from p2p_tpu_torch.ops.spectral_norm import SpectralConv

    if mesh.model == 1:
        return []
    roles = tp_assignment(net, mesh.model, min_ch)
    kept = set(_keeps_slice(net, roles))
    group = mesh.group(MODEL_AXIS)
    shards = []
    for name, role in roles.items():
        if role is None:
            continue
        module, attr = _module_of(net, name)
        if type(module) not in (nn.Conv2d, nn.ConvTranspose2d,
                                SpectralConv, QuantConv):
            raise NotImplementedError(
                f"{field}.{name}: a {type(module).__name__} has no tensor-"
                "parallel form in the port (model > 1)")
        p = getattr(module, attr)
        path = name.rpartition(".")[0]
        wname, bname = path + ".weight", path + ".bias"
        if attr == "weight":
            module.p2p_tp = TPConv(role, group, mesh.model_rank, mesh.model,
                                   keep=path in kept)
            module.p2p_tp_io = conv_io(name, p.shape)
        if roles.get(wname) != role or (
                role == "out" and roles.get(bname, role) != role):
            raise NotImplementedError(
                f"{field}.{name}: a bias sharded apart from its kernel")
        dim = _layout_dim(module, attr, role)
        tp = TPConv(role, group, mesh.model_rank, mesh.model)
        shards.append(Shard(field, name, module, attr, dim, p.shape[dim]))
        with torch.no_grad():
            p.data = _cut(p.data, dim, tp)
        # parallel/dp.py reduces a shard's gradient over its data line only
        p.p2p_tp_role = role
    return shards


def check_tp_config(cfg, mesh: Mesh) -> None:
    """Raise ``NotImplementedError`` for what the TP step does not cover,
    by name: remat (the recompute would repeat the model group's
    collectives), the global-norm clip and the gradient-norm taps (both
    read every shard), a video preset. int8 runs in the Megatron forms of
    ops/int8.py (``_TPInt8Conv``); a sharded kn2row, subpixel or
    transposed int8 conv has none and raises when it runs."""
    if mesh.model == 1:
        return
    refused = []
    if cfg.parallel.remat:
        refused.append("remat")
    if cfg.optim.grad_clip > 0:
        refused.append("grad_clip")
    if cfg.debug.grad_norms:
        refused.append("grad_norms")
    if cfg.data.n_frames > 1:
        refused.append("a video preset")
    if refused:
        raise NotImplementedError(
            f"model={mesh.model} (tensor parallelism) is not ported with "
            + ", ".join(refused))


def place_state_tp(state, mesh: Mesh, min_ch: int = 512):
    """Cut a replicated train state's networks to this rank's shards
    (``state.tp_shards`` lists them), and the EMA generator with G. The
    optimizers hold no moments yet (a fresh state), so the first step
    creates them on the shards. Returns ``state``."""
    if mesh.model == 1:
        return state
    if any(opt is not None and opt[0].state for opt in (
            getattr(state, f, None) for f in ("opt_g", "opt_d", "opt_c"))):
        raise ValueError("place_state_tp takes a fresh state (no optimizer "
                         "moments yet); restore a checkpoint after it")
    shards = []
    for field in ("net_g", "net_d", "net_c"):
        net = getattr(state, field, None)
        if net is not None:
            shards += shard_module(net, mesh, min_ch, field)
    ema = getattr(state, "ema_g", None)
    if ema is not None:
        for s in shards:
            if s.net == "net_g":
                tp = TPConv("out", mesh.group(MODEL_AXIS), mesh.model_rank,
                            mesh.model)
                ema[s.name] = _cut(ema[s.name], s.dim, tp)
    state.tp_shards = shards
    state.tp_group = TPConv("out", mesh.group(MODEL_AXIS), mesh.model_rank,
                            mesh.model)
    return state


def _opt_of(state, field: str):
    opt = getattr(state, "opt_" + field[4:], None)
    return None if opt is None else opt[0]


@contextlib.contextmanager
def tp_full(state) -> Iterator[None]:
    """The whole parameters, Adam moments and EMA of every sharded tensor
    for the duration (collective over the model group); after, each is
    cut again to this rank's shard from its value then, so a restore
    inside the context lands on the shards. A no-op without shards."""
    shards: List[Shard] = getattr(state, "tp_shards", None) or []
    if not shards:
        yield
        return
    tp = state.tp_group
    ema = getattr(state, "ema_g", None)

    def moments(s: Shard, p: torch.Tensor):
        opt = _opt_of(state, s.net)
        st = opt.state.get(p, {}) if opt is not None else {}
        return st, [k for k, v in st.items()
                    if torch.is_tensor(v) and v.shape == p.shape]

    with torch.no_grad():
        for s in shards:
            p = getattr(s.module, s.attr)
            st, keys = moments(s, p)
            for k in keys:
                st[k] = _gather_dim(st[k], s.dim, s.full, tp)
            if ema is not None and s.net == "net_g":
                ema[s.name] = _gather_dim(ema[s.name], s.dim, s.full, tp)
            p.data = _gather_dim(p.data, s.dim, s.full, tp)
    try:
        yield
    finally:
        with torch.no_grad():
            for s in shards:
                p = getattr(s.module, s.attr)
                p.data = _cut(p.data, s.dim, tp)
                opt = _opt_of(state, s.net)
                if opt is not None and p in opt.state:
                    # a new dict: a state_dict taken inside holds the old
                    opt.state[p] = {
                        k: _cut(v, s.dim, tp) if torch.is_tensor(v)
                        and v.dim() == p.dim() and v.shape[s.dim] == s.full
                        else v for k, v in opt.state[p].items()}
                if ema is not None and s.net == "net_g" \
                        and ema[s.name].shape[s.dim] == s.full:
                    ema[s.name] = _cut(ema[s.name], s.dim, tp)


__all__ = ["TPConv", "check_tp_config", "conv_io", "copy_to_model",
           "gather_channels", "gather_from_model", "model_allreduce",
           "place_state_tp", "tp_int8_input", "tp_int8_output",
           "reduce_from_model", "reset_tp_stats", "scatter_to_model",
           "shard_module", "tp_assignment", "tp_cast_conv", "tp_conv",
           "tp_full", "tp_leaf_spec", "tp_spectral_sigma", "tp_stats"]
