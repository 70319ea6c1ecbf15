"""ZeRO state sharding over the ``fsdp`` mesh axis (counterpart of the
``fsdp`` half of ``p2p_tpu/parallel/rules.py``: ``:311 make_fsdp_rules``
and the ``fsdp`` rows of ``:346 trainstate_rules``).

The JAX package partitions the Adam moments and the EMA generator (and,
behind ``ParallelConfig.fsdp_params``, the parameters) over ``fsdp`` with
a rule table, and GSPMD inserts the gathers. Here the split is by FLAT
PARAMETER RANGE: each network's parameters become views of one f32 buffer
in their memory order (:class:`FlatParams`), cut into ``fsdp`` contiguous
ranges, one a rank.

- :class:`ShardedOptimizer` is the network's optimizer: the same Adam (or
  ``AdamLP`` with its bf16 moments) over this rank's range only, its
  gradient the range of the all-reduced gradient buffer
  (parallel/dp.py); after the update every rank's range is broadcast from
  its owner into the others' buffers (an all-gather written as one
  broadcast a rank, which NCCL and gloo both take on a card). Adam is
  elementwise, so the parameters are BITWISE those of the replicated
  step (``tests/test_parallel.py:493`` pins the same in JAX).
- :class:`ShardedEMA` keeps this rank's range of the EMA generator and
  moves it from the updated range.
- With ``fsdp_params`` the buffer's storage is freed between uses and the
  rank keeps its range as the update's master: :meth:`FlatParams.gather`
  re-forms the parameters on use (the step's start, the eval, a save or a
  restore) and :meth:`FlatParams.release` frees them again.

``state_dict`` of a sharded optimizer or EMA gathers the ranges and
returns the one-device format (per-parameter moments in the parameter's
layout, torch's keys), so rank 0 writes the checkpoint a one-device run
writes, and ``load_state_dict`` cuts a one-device state to this rank's
range: a reshard across process counts or ``fsdp`` widths is a plain
load. Both are collective over the ``fsdp`` group.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from p2p_tpu_torch.core.mesh import FSDP_AXIS, Mesh

#: the optimizer fields a ZeRO layout shards (the JAX ``FSDP_STATE_RE``:
#: opt_g/d/c and ema_g; ``FSDP_PARAMS_RE`` adds the networks)
SHARDED_OPTS = ("opt_g", "opt_d", "opt_c")


def mem_flat(t: torch.Tensor) -> torch.Tensor:
    """The 1-D view of a dense tensor's elements in memory order (any of
    the contiguous, channels_last and channels_last_3d layouts)."""
    dense = (t.is_contiguous()
             or (t.dim() == 4
                 and t.is_contiguous(memory_format=torch.channels_last))
             or (t.dim() == 5
                 and t.is_contiguous(memory_format=torch.channels_last_3d)))
    if not dense:
        raise ValueError(f"tensor of shape {tuple(t.shape)} and strides "
                         f"{t.stride()} is not dense in memory")
    return t.as_strided((t.numel(),), (1,))


def in_layout_of(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` with ``like``'s strides (itself when it has them)."""
    if t.stride() == like.stride():
        return t
    return torch.empty_like(like).copy_(t)


class FlatParams:
    """A network's parameters as views of one buffer (memory order, in
    parameter order) and this rank's range ``[lo, hi)`` of it over the
    mesh's ``fsdp`` group. With ``split`` the buffer is released outside
    :meth:`full` and ``shard`` is the rank's master copy of its range;
    else ``shard`` is a view of the buffer."""

    def __init__(self, params: List[nn.Parameter], mesh: Mesh,
                 split: bool = False):
        if not params:
            raise ValueError("FlatParams: no parameters")
        dtypes = {p.dtype for p in params}
        if len(dtypes) != 1:
            raise ValueError(f"FlatParams: mixed dtypes {dtypes}")
        self.params = params
        self.offsets = []
        total = 0
        for p in params:
            self.offsets.append(total)
            total += p.numel()
        self.total = total
        dev = params[0].device
        self.flat = torch.empty(total, dtype=params[0].dtype, device=dev)
        with torch.no_grad():
            for p, o in zip(params, self.offsets):
                self.flat[o:o + p.numel()].copy_(mem_flat(p.data))
                p.data = self.flat.as_strided(p.shape, p.stride(), o)
        width = mesh.shape[FSDP_AXIS]
        self.group = mesh.group(FSDP_AXIS)
        self.ranks = mesh.group_ranks(FSDP_AXIS)
        self.bounds = [(total * i // width, total * (i + 1) // width)
                       for i in range(width)]
        self.index = mesh.coords[FSDP_AXIS]
        self.lo, self.hi = self.bounds[self.index]
        self.split = split
        self._nbytes = self.flat.untyped_storage().nbytes()
        self._full = True
        self.shard = (self.flat[self.lo:self.hi].clone() if split
                      else self.flat[self.lo:self.hi])
        if split:
            self.release()

    def broadcast_ranges(self, buf: torch.Tensor) -> None:
        """Every rank's range of ``buf`` (a flat tensor laid out as the
        parameters) from its owner into the others' ``buf``."""
        for (lo, hi), src in zip(self.bounds, self.ranks):
            if hi > lo:
                dist.broadcast(buf[lo:hi], src=src, group=self.group)

    def gather(self) -> None:
        """The whole parameters on every rank: after an update of the
        ranges, or (``split``) re-formed from the masters."""
        if self.split:
            if not self._full:
                self.flat.untyped_storage().resize_(self._nbytes)
                self._full = True
            with torch.no_grad():
                self.flat[self.lo:self.hi].copy_(self.shard)
        self.broadcast_ranges(self.flat)

    def release(self) -> None:
        """(``split``) keep only this rank's range: the master takes the
        buffer's range, then the buffer's storage is freed."""
        if not self.split or not self._full:
            return
        with torch.no_grad():
            self.shard.copy_(self.flat[self.lo:self.hi])
        self.flat.untyped_storage().resize_(0)
        self._full = False

    @contextlib.contextmanager
    def full(self) -> Iterator[None]:
        """The whole parameters for the duration (a no-op unless
        ``split``)."""
        if not self.split:
            yield
            return
        self.gather()
        try:
            yield
        finally:
            self.release()

    def flat_of(self, tensors: List[torch.Tensor],
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Per-parameter tensors (any layout) as one flat buffer laid out
        as the parameters."""
        return torch.cat([mem_flat(in_layout_of(t, p)).to(dtype or t.dtype)
                          for t, p in zip(tensors, self.params)])

    def views_of(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Per-parameter views of a flat buffer laid out as the
        parameters."""
        return [flat.as_strided(p.shape, p.stride(), o)
                for p, o in zip(self.params, self.offsets)]

    def full_of(self, own: torch.Tensor) -> torch.Tensor:
        """A flat buffer with this rank's range ``own`` and every other
        rank's range from its owner."""
        buf = torch.empty(self.total, dtype=own.dtype, device=own.device)
        buf[self.lo:self.hi].copy_(own)
        self.broadcast_ranges(buf)
        return buf


class ShardedOptimizer(torch.optim.Optimizer):
    """``inner`` (Adam or ``AdamLP``) over this rank's range of ``flat``;
    ``param_groups`` are the network's whole parameters (the learning
    rate the scheduler and the step's ``lr_scale`` set reaches the inner
    optimizer at each step). The step's gradient is ``grad_flat``, the
    all-reduced gradient buffer parallel/dp.py sets."""

    def __init__(self, flat: FlatParams, inner_cls, **hyper):
        self.flat_params = flat
        self.shadow = nn.Parameter(flat.shard, requires_grad=True)
        self.inner = inner_cls([self.shadow], **hyper)
        super().__init__(flat.params, dict(self.inner.defaults))
        self.grad_flat: Optional[torch.Tensor] = None

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none=set_to_none)
        self.grad_flat = None

    @torch.no_grad()
    def step(self, closure=None):
        if self.grad_flat is None:
            raise RuntimeError("ShardedOptimizer.step without the "
                               "all-reduced gradient (parallel/dp.py "
                               "sync_grads)")
        f = self.flat_params
        self.shadow.grad = self.grad_flat[f.lo:f.hi]
        for mine, outer in zip(self.inner.param_groups, self.param_groups):
            mine["lr"] = outer["lr"]
        self.inner.step()
        self.shadow.grad = None
        f.gather()

    def _moment_keys(self) -> List[str]:
        st = self.inner.state.get(self.shadow, {})
        return [k for k, v in st.items() if torch.is_tensor(v)
                and v.numel() == self.shadow.numel()]

    def state_dict(self) -> Dict:
        """The one-device optimizer state (collective over ``fsdp``)."""
        sd = super().state_dict()
        st = self.inner.state.get(self.shadow)
        if not st:
            return sd
        f = self.flat_params
        full = {k: f.views_of(f.full_of(st[k])) for k in self._moment_keys()}
        step = st["step"]
        sd["state"] = {
            i: {"step": step.clone() if torch.is_tensor(step) else step,
                **{k: v[i] for k, v in full.items()}}
            for i in range(len(f.params))}
        return sd

    def load_state_dict(self, state_dict: Dict) -> None:
        """Cut a one-device optimizer state to this rank's range."""
        outer = dict(state_dict)
        per_param = outer.pop("state")
        super().load_state_dict({**outer, "state": {}})
        self.inner.state.clear()
        if not per_param:
            return
        f = self.flat_params
        first = per_param[0]
        st = {"step": (first["step"].clone() if torch.is_tensor(
            first["step"]) else first["step"])}
        for k, v in first.items():
            if k == "step":
                continue
            moments = [per_param[i][k].to(f.flat.device)
                       for i in range(len(f.params))]
            dtype = getattr(self.inner, "moment_dtype", f.flat.dtype)
            st[k] = f.flat_of(moments, dtype)[f.lo:f.hi].clone()
        self.inner.state[self.shadow] = st


class ShardedEMA:
    """This rank's range of the EMA generator (``HealthConfig.ema_decay``),
    f32, laid out as G's :class:`FlatParams`. :meth:`state_dict` gathers
    it into the one-device ``{name: tensor}`` form (collective)."""

    def __init__(self, flat: FlatParams, names: List[str],
                 ema: Dict[str, torch.Tensor]):
        self.flat_params = flat
        self.names = names
        with torch.no_grad():
            self.own = flat.flat_of([ema[k] for k in names],
                                    torch.float32)[flat.lo:flat.hi].clone()

    def update_(self, decay: float) -> None:
        """``e ← e·d + p·(1−d)`` on this rank's range, from the updated
        parameters (ops as ``train/state.ema_update_``)."""
        src = self.flat_params.shard.detach().to(self.own.dtype)
        with torch.no_grad():
            torch._foreach_mul_([self.own], float(decay))
            torch._foreach_add_([self.own], torch._foreach_mul(
                [src], 1.0 - float(decay)))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        f = self.flat_params
        views = f.views_of(f.full_of(self.own))
        return dict(zip(self.names, views))

    def load_state_dict(self, saved: Dict[str, torch.Tensor]) -> None:
        if set(saved) != set(self.names):
            raise ValueError("ema_g: the checkpoint's names differ from "
                             "the state's")
        f = self.flat_params
        with torch.no_grad():
            self.own.copy_(f.flat_of(
                [saved[k].to(self.own.device) for k in self.names],
                torch.float32)[f.lo:f.hi])


def shard_state(state, mesh: Mesh, fsdp_params: bool = False):
    """Put ``state`` (replicated on every rank) into the ZeRO layout of
    ``mesh``'s ``fsdp`` axis: each optimizer of ``SHARDED_OPTS`` becomes a
    :class:`ShardedOptimizer` with its scheduler's schedule, the EMA a
    :class:`ShardedEMA`; with ``fsdp_params`` the parameters are split
    too. Returns ``state``; ``state.flat`` maps each sharded network's
    field to its :class:`FlatParams`."""
    from p2p_tpu_torch.train.state import AdamLP

    if mesh.shape[FSDP_AXIS] < 2:
        return state
    state.flat = {}
    for opt_name in SHARDED_OPTS:
        opt = getattr(state, opt_name, None)
        if opt is None:
            continue
        net_name = "net_" + opt_name[4:]
        net = getattr(state, net_name)
        optimizer, scheduler = opt
        group = optimizer.param_groups[0]
        flat = FlatParams(list(net.parameters()), mesh, split=fsdp_params)
        state.flat[net_name] = flat
        hyper = dict(lr=group["lr"], betas=group["betas"], eps=group["eps"])
        if isinstance(optimizer, AdamLP):
            inner_cls = AdamLP
            hyper["moment_dtype"] = optimizer.moment_dtype
        elif type(optimizer) is torch.optim.Adam:
            inner_cls = torch.optim.Adam
        else:
            raise TypeError(f"{opt_name}: no ZeRO form of "
                            f"{type(optimizer).__name__}")
        sharded = ShardedOptimizer(flat, inner_cls, **hyper)
        sched = torch.optim.lr_scheduler.LambdaLR(
            sharded, list(scheduler.lr_lambdas))
        setattr(state, opt_name, (sharded, sched))
    if state.ema_g is not None:
        names = [k for k, _ in state.net_g.named_parameters()]
        state.ema_g = ShardedEMA(state.flat["net_g"], names, state.ema_g)
    return state


@contextlib.contextmanager
def full_params(state) -> Iterator[None]:
    """Every network's whole parameters for the duration (a no-op unless
    ``fsdp_params`` split them)."""
    flats = list((getattr(state, "flat", None) or {}).values())
    with contextlib.ExitStack() as stack:
        for f in flats:
            stack.enter_context(f.full())
        yield


def gather_params(state) -> None:
    """Re-form split parameters for a step (``fsdp_params``)."""
    for f in (getattr(state, "flat", None) or {}).values():
        if f.split:
            f.gather()


def release_params(state) -> None:
    """Free split parameters after a step (``fsdp_params``)."""
    for f in (getattr(state, "flat", None) or {}).values():
        f.release()


def ema_state(ema) -> Optional[Dict[str, torch.Tensor]]:
    """The one-device ``{name: tensor}`` form of an EMA generator (a dict,
    or a :class:`ShardedEMA`, gathered: collective)."""
    if ema is None:
        return None
    return ema.state_dict() if isinstance(ema, ShardedEMA) else dict(ema)
