"""Pipeline parallelism (GPipe) over the ``pipe`` mesh axis (counterpart of
``p2p_tpu/parallel/pp.py``).

- **Stage unit**: the generator's residual trunk (ExpandNetwork's
  ``ResidualBlock_i``, the ResNet family's ``ResnetBlock_i``;
  :func:`trunk_prefix` refuses every other family with JAX's message).
  Each of the S pipe ranks holds ``n_blocks / S`` consecutive blocks as a
  :class:`StageStack` in ``state.pp_stages`` with its own Adam in
  ``state.opt_s`` (:func:`pp_split_state`): stage weights live on their
  stage only. The encoder, the decoder and the shared PReLU stay in
  ``state.net_g``, replicated over ``pipe``. The ``[S, B, ...]`` stack of
  JAX (:func:`stack_trunk`; block ``s·B + j`` at ``[s, j]``) is the layout
  of converted and migrated states, not a live tensor.
- **Schedule**: JAX's fill/drain over M microbatches
  (:func:`gpipe_trunk`): ``M + lag·(S−1)`` ticks, lag 1 for the serial
  schedule and 2 for ``overlap=True``; stage 0 is fed microbatch ``t``,
  stage ``s`` holds microbatch ``t − lag·s`` at tick ``t``, the last
  stage retires ``t − lag·(S−1)``. A stage computes on its valid ticks
  only: at a bubble tick it sends zeros (JAX computes there on zeros or a
  re-fed microbatch and masks the result, which no output or amax reads).
  The hand-off is the ring shift of ``parallel/halo.py`` (rank ``i`` to
  ``i + 1``: JAX's ``ppermute``), on its routes (``"slot"``: CUDA tensors
  under gloo, exact 32-bit words; ``"p2p"``: NCCL or CPU tensors),
  counted in :data:`pp_stats`. Under ``overlap`` the shift of the previous
  tick's output is started before this tick's blocks run and waited on at
  the tick's end (``async_op=True``): the same blocks on the same
  microbatches, so the numerics are the serial schedule's bit for bit.
- **The end of the schedule** is JAX's masked ``psum`` of the last
  stage's outputs over ``pipe``: the retired outputs are broadcast from
  the last stage (a slot all-reduce where the other ranks add zeros, so
  every rank holds the last stage's bits). Its transpose under
  ``shard_map`` hands each rank its own cotangent (the result is
  replicated over ``pipe``), so in the backward the last stage retires
  its own cotangent and the others drop theirs: no all-reduce, which
  would multiply every trunk gradient by S.
- **Backward**: the whole schedule is one ``torch.autograd.Function``
  whose backward runs the reverse schedule (the transpose of the forward's
  scan): at each tick in reverse a stage takes the cotangent of its output
  (the next stage's input cotangent, shifted back, plus its retired
  output's on the last stage), backpropagates its blocks' graph of that
  tick and shifts its input cotangent back, in the forward's overlap
  mode. Every rank runs every collective in one order, which autograd's
  reachability alone would not give (stage 0 never reads what it
  receives). The stage parameters' gradients add over the microbatches
  from the last to the first, in both schedules. The cotangent of the
  trunk's input (stage 0's) is broadcast to every pipe rank, as the
  transpose of an input replicated over ``pipe`` sums the ranks' (the
  others' are zero).
- **Norm semantics**: the pipelined generator runs in eval mode
  (``p2p_tpu/parallel/pp.py:392-397``): BatchNorm reads its running
  statistics; the instance-norm family is per-sample, so exact against
  the train-mode unpipelined model.
- **The delayed-int8 trunk** (``quant``): every microbatch quantizes with
  the start-of-step stored scales; each int8 module of a stage
  max-combines ``amax_update(amax, stored)`` over its valid ticks
  (``ops/int8.QuantScale.pp_proposal``, armed by :func:`start_proposals`),
  :func:`take_proposals` max-reduces the result over the data line, the
  step stores it, and no amax enters autograd.

:func:`pp_merge_state` folds a split state back (gathering the other
stages' blocks and moments over ``pipe``, exact), :func:`pp_full` holds
the flat form for a save or a restore (checkpoints stay in the one-device
format), and :func:`pp_width_of` is the stacking a state carries.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from p2p_tpu_torch.core.mesh import PIPE_AXIS, Mesh
from p2p_tpu_torch.ops.int8 import quant_modules
from p2p_tpu_torch.parallel.halo import (ROUTES, Ring, _slots, ring_of,
                                         route_for, shift_start)

_TRUNK_PREFIX = {"expand": "ResidualBlock_", "resnet": "ResnetBlock_"}

#: the pipe axis's transfers: the ring shifts by route (forward and
#: backward each count), and the broadcasts of the retired outputs and
#: of the trunk input's cotangent (``bcast``); calls and bytes this rank
#: sent
pp_stats: Dict[str, Dict[str, int]] = {
    k: {"calls": 0, "bytes": 0} for k in ROUTES + ("bcast",)}


def reset_pp_stats() -> None:
    for v in pp_stats.values():
        v["calls"] = v["bytes"] = 0


def trunk_prefix(model_cfg) -> str:
    """The trunk blocks' name prefix of ``model_cfg.generator``; raises
    for a family with no pipelined trunk."""
    try:
        return _TRUNK_PREFIX[model_cfg.generator]
    except KeyError:
        raise NotImplementedError(
            f"pp pipelines the expand/resnet trunk families, not "
            f"{model_cfg.generator!r} (docs/PARALLELISM.md v2 boundaries)"
        ) from None


def _trunk_names(names: Sequence[str], prefix: str) -> List[str]:
    out = [n for n in names if n.startswith(prefix)]
    out.sort(key=lambda n: int(n[len(prefix):]))
    return out


# ---------------------------------------------------------------- stacking
def _gather_stack(tree: Mapping[str, Mapping[str, torch.Tensor]],
                  prefix: str, n_stages: int,
                  names: Optional[Sequence[str]] = None
                  ) -> Dict[str, torch.Tensor]:
    """{block name: {leaf: tensor}} → {leaf: [S, B, ...] tensor}: THE
    stacking law, block ``s·B + j`` at ``[s, j]``. ``names`` (the
    parameters' block list) makes a collection missing a block fail."""
    if names is None:
        names = _trunk_names(list(tree), prefix)
    per = len(names) // n_stages
    leaves = list(tree[names[0]])
    return {k: torch.stack([tree[n][k] for n in names]).reshape(
        (n_stages, per) + tuple(tree[names[0]][k].shape)) for k in leaves}


def stack_trunk(tree: Mapping[str, Mapping[str, torch.Tensor]],
                n_stages: int, prefix: str = "ResidualBlock_"
                ) -> Dict[str, torch.Tensor]:
    """Stack the trunk's per-block tensors (``{"ResidualBlock_i": block
    state_dict}``; other entries ignored) into stage-major ``[S, B, ...]``
    tensors (:func:`_gather_stack`). Raises for no blocks and for a block
    count S does not divide, with JAX's messages."""
    names = _trunk_names(list(tree), prefix)
    if not names:
        raise ValueError(f"no {prefix}* blocks in variables")
    if len(names) % n_stages:
        raise ValueError(
            f"{len(names)} trunk blocks not divisible by {n_stages} stages")
    return _gather_stack(tree, prefix, n_stages, names)


def unstack_trunk(stacked: Mapping[str, torch.Tensor], prefix: str
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Inverse of :func:`stack_trunk`: ``{leaf: [S, B, ...]}`` →
    ``{f"{prefix}{i}": {leaf: tensor}}``, block ``s·B + j`` read from
    ``[s, j]`` (works on numpy arrays too)."""
    if not stacked:
        return {}
    first = next(iter(stacked.values()))
    s, b = first.shape[:2]
    return {f"{prefix}{i}": {k: v[i // b, i % b] for k, v in stacked.items()}
            for i in range(s * b)}


def mb_major_flatten(t: torch.Tensor) -> torch.Tensor:
    """[M, mb, ...] → [mb·M, ...] with the (data-sharded) mb axis
    outermost: row ``j·M + m`` is microbatch m's row j. The one carve
    order (its inverse below)."""
    n_micro, mb = t.shape[0], t.shape[1]
    return t.transpose(0, 1).reshape((mb * n_micro,) + tuple(t.shape[2:]))


def mb_major_unflatten(t: torch.Tensor, n_micro: int) -> torch.Tensor:
    """Inverse of :func:`mb_major_flatten`: [mb·M, ...] → [M, mb, ...] (a
    view)."""
    mb = t.shape[0] // n_micro
    return t.reshape((mb, n_micro) + tuple(t.shape[1:])).transpose(0, 1)


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last) \
        if t.dim() == 4 else t.contiguous()


# ------------------------------------------------------------ stage stack
class StageStack(nn.Module):
    """The trunk blocks one pipe rank holds: stage ``stage`` of
    ``n_stages`` (blocks ``stage·B … stage·B + B − 1`` of ``names``, B =
    ``len(names) / n_stages``), or every block (``stage`` None: a state
    split on one process, the template form of a migration). Calling it
    runs its blocks in order (one stage's)."""

    def __init__(self, blocks: Sequence[nn.Module], names: Sequence[str],
                 n_stages: int, stage: Optional[int]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.names = list(names)
        self.n_stages = int(n_stages)
        self.stage = stage
        self.per = len(self.names) // self.n_stages

    def held(self) -> List[str]:
        """The names of the blocks this stack holds, in trunk order."""
        if self.stage is None:
            return list(self.names)
        return self.names[self.stage * self.per:(self.stage + 1) * self.per]

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            y = block(y)
        return y


def pp_width_of(state) -> int:
    """Stage count of a (possibly) pipe-split train state, 1 when flat
    (the sidecar's ``pp_stages``: the stacking the state carries; the CLI
    trainer runs flat even on a pipe mesh)."""
    stack = getattr(state, "pp_stages", None)
    return 1 if stack is None else int(stack.n_stages)


def _move_optimizer(cfg, module: nn.Module, old, steps_per_epoch: int):
    """A fresh (optimizer, scheduler) of ``cfg`` over ``module``'s
    parameters carrying ``old``'s per-parameter state (the moment dicts,
    moved), its learning rates and its scheduler's count; ``old`` may be a
    list of pairs, searched in order for each parameter's state (the
    first one's hyperparameters are kept)."""
    from p2p_tpu_torch.train.state import make_optimizers

    olds = old if isinstance(old, list) else [old]
    (new,) = make_optimizers(cfg, [module], steps_per_epoch)
    optimizer, scheduler = new
    for p in module.parameters():
        for o in olds:
            if p in o[0].state:
                optimizer.state[p] = o[0].state[p]
                break
    scheduler.load_state_dict(olds[0][1].state_dict())
    for group, og in zip(optimizer.param_groups, olds[0][0].param_groups):
        for k in ("lr", "initial_lr"):
            if k in og:
                group[k] = og[k]
    return new


def pp_split_state(state, cfg, mesh: Optional[Mesh] = None,
                   steps_per_epoch: int = 1,
                   n_stages: Optional[int] = None,
                   init_opt: bool = True, place: bool = True):
    """Move the generator trunk out of a flat train state into
    ``state.pp_stages`` (a :class:`StageStack`) with its own optimizer
    ``state.opt_s``; returns ``state`` (changed in place).

    With a mesh (and ``place``) the rank keeps its stage's blocks only; on
    one process (``mesh`` None or ``place=False``) the stack holds every
    stage. The trunk's slots in ``net_g`` become None (the module then
    runs with a ``trunk_fn``), keeping their place in its parameter
    order. ``init_opt=True`` (training start): ``opt_g`` and ``opt_s``
    are fresh; ``init_opt=False`` (the pipe-width migration): the live
    moments, learning rates and schedule count are carried over, the
    trunk's into ``opt_s``. ``n_stages`` defaults to the mesh's pipe
    width."""
    prefix = trunk_prefix(cfg.model)
    if n_stages is None:
        n_stages = mesh.pipe if mesh is not None else 1
    net = state.net_g
    names = _trunk_names([k for k, m in net.named_children()
                          if m is not None], prefix)
    if not names:
        raise ValueError(f"no {prefix}* blocks in variables")
    if len(names) % n_stages:
        raise ValueError(
            f"{len(names)} trunk blocks not divisible by {n_stages} stages")
    stage = mesh.pipe_rank if (place and mesh is not None) else None
    stack = StageStack([], names, n_stages, stage)
    held = stack.held()
    stack.blocks.extend(getattr(net, k) for k in held)
    for k in names:
        setattr(net, k, None)
    for p in stack.parameters():
        p.p2p_pp_stage = True
    if init_opt:
        from p2p_tpu_torch.train.state import make_optimizers

        state.opt_g, state.opt_s = make_optimizers(
            cfg, [net, stack], steps_per_epoch)
    else:
        old = state.opt_g
        state.opt_g = _move_optimizer(cfg, net, old, steps_per_epoch)
        state.opt_s = _move_optimizer(cfg, stack, old, steps_per_epoch)
    state.pp_stages = stack
    return state


def _stage_ring(mesh: Optional[Mesh]) -> Optional[Ring]:
    if mesh is None or mesh.pipe == 1:
        return None
    return ring_of(mesh.group(PIPE_AXIS))


def _gather_stages(tensors: List[torch.Tensor], ring: Ring
                   ) -> List[List[torch.Tensor]]:
    """Every pipe rank's ``tensors`` (the same count, shapes and dtypes on
    each): ``out[i][r]`` is rank ``r``'s i-th (exact: one slot
    all-reduce)."""
    n = ring.size
    sizes = {(r, i): t.numel() * t.element_size()
             for r in range(n) for i, t in enumerate(tensors)}
    read = _slots(ring, sizes, dict(enumerate(tensors)),
                  tensors[0].device)
    return [[read(r, i, t.dtype, t.shape) for r in range(n)]
            for i, t in enumerate(tensors)]


def pp_merge_state(state, cfg, steps_per_epoch: int = 1,
                   mesh: Optional[Mesh] = None):
    """Inverse of :func:`pp_split_state`: fold the stage blocks back into
    ``net_g`` (in their places) and rebuild ``opt_g`` over the whole
    generator with the trunk's moments from ``opt_s``; returns ``state``
    (changed in place). A stack holding one stage gathers the others'
    blocks and Adam state over the mesh's pipe group (collective: every
    pipe rank calls it), exact bits."""
    stack = state.pp_stages
    if stack is None:
        return state
    net = state.net_g
    held = stack.held()
    blocks = dict(zip(held, stack.blocks))
    moments: Dict[nn.Parameter, dict] = {}
    if stack.stage is not None and len(held) != len(stack.names):
        ring = _stage_ring(mesh)
        if ring is None:
            raise ValueError("merging one stage's blocks needs the mesh of "
                             "its pipe group")
        opt = state.opt_s[0]
        local = []
        keys = []
        for name in held:
            b = blocks[name]
            sd = b.state_dict()
            keys.append(list(sd))
            local += [sd[k] for k in sd]
            for p in b.parameters():
                st = opt.state.get(p, {})
                local += [st[k] for k in ("exp_avg", "exp_avg_sq")
                          if torch.is_tensor(st.get(k))]
        got = _gather_stages(local, ring)
        per = stack.per
        for r in range(stack.n_stages):
            if r == stack.stage:
                continue
            i = 0
            for j, name in enumerate(stack.names[r * per:(r + 1) * per]):
                b = copy.deepcopy(stack.blocks[j])
                sd = {k: got[i + n][r] for n, k in enumerate(keys[j])}
                i += len(keys[j])
                b.load_state_dict(sd)
                for p, own in zip(b.parameters(),
                                  stack.blocks[j].parameters()):
                    st = opt.state.get(own, {})
                    if torch.is_tensor(st.get("exp_avg")):
                        moments[p] = {
                            "step": copy.deepcopy(st["step"]),
                            "exp_avg": got[i][r], "exp_avg_sq": got[i + 1][r]}
                        i += 2
                blocks[name] = b
    for name in stack.names:
        setattr(net, name, blocks[name])
    for p in net.parameters():
        if hasattr(p, "p2p_pp_stage"):
            del p.p2p_pp_stage
    new = _move_optimizer(cfg, net, [state.opt_g, state.opt_s],
                          steps_per_epoch)
    for p, st in moments.items():
        new[0].state[p] = st
    state.opt_g = new
    state.pp_stages = None
    state.opt_s = None
    return state


@contextlib.contextmanager
def pp_full(state, cfg, mesh: Optional[Mesh] = None,
            steps_per_epoch: int = 1) -> Iterator[None]:
    """The flat state (every block in ``net_g``, one ``opt_g``) for the
    duration, then split again at the same width from its values then
    (so a restore inside lands on the stages). Collective over the pipe
    group when the stack holds one stage. A no-op for a flat state."""
    stack = getattr(state, "pp_stages", None)
    if stack is None:
        yield
        return
    n_stages, place = stack.n_stages, stack.stage is not None
    pp_merge_state(state, cfg, steps_per_epoch, mesh)
    try:
        yield
    finally:
        pp_split_state(state, cfg, mesh, steps_per_epoch, n_stages,
                       init_opt=False, place=place)


# ---------------------------------------------------------------- schedule
def _bcast(t: torch.Tensor, ring: Ring, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank of the ring (a slot all-reduce
    where the others add zeros: exact bits)."""
    nb = t.numel() * t.element_size()
    if ring.index == src:
        pp_stats["bcast"]["calls"] += 1
        pp_stats["bcast"]["bytes"] += nb
    read = _slots(ring, {(src, "x"): nb},
                  {"x": t} if ring.index == src else {}, t.device)
    return read(src, "x", t.dtype, t.shape)


def _shift(x: torch.Tensor, ring: Optional[Ring], shift: int):
    """Start a ring shift of ``x`` (counted in :data:`pp_stats`): returns
    ``wait()``."""
    if ring is None:
        out = x.clone()
        return lambda: out
    return shift_start(x, ring, shift, route_for(x, ring.group),
                       stats=pp_stats)


def _stack_nhwc(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.permute(0, 2, 3, 1).contiguous() if t.dim() == 4
                        else t.contiguous() for t in ts])


def _unstack_nhwc(t: torch.Tensor, like: torch.Tensor) -> List[torch.Tensor]:
    if like.dim() == 4:
        return [u.permute(0, 3, 1, 2) for u in t.unbind(0)]
    return list(t.unbind(0))


class _Schedule:
    """One GPipe run's bookkeeping: ticks, lag and which microbatch a
    stage holds at a tick."""

    def __init__(self, n_micro: int, n_stages: int, idx: int, overlap: bool):
        self.m, self.s, self.idx = n_micro, n_stages, idx
        self.lag = 2 if overlap else 1
        self.overlap = overlap
        self.ticks = n_micro + self.lag * (n_stages - 1)

    def micro(self, t: int) -> Optional[int]:
        """The microbatch this stage computes at tick ``t`` (None: a
        bubble tick)."""
        m = t - self.lag * self.idx
        return m if 0 <= m < self.m else None

    def retired(self, t: int) -> Optional[int]:
        """The microbatch the last stage retires at tick ``t``."""
        if self.idx != self.s - 1:
            return None
        return self.micro(t)

    def shifts_at(self, t: int) -> bool:
        """Whether a shift starts at tick ``t`` (the one whose result some
        later tick reads): serial ticks 0..T−2 (this tick's output),
        overlap ticks 1..T−2 (the previous tick's)."""
        if self.s == 1 or t > self.ticks - 2:
            return False
        return t >= 1 if self.overlap else True


class _GPipe(torch.autograd.Function):
    """The schedule of :func:`gpipe_trunk` as one Function: inputs the M
    microbatches and the stage's parameters, outputs the M trunk outputs
    (every pipe rank's the last stage's)."""

    @staticmethod
    def forward(ctx, meta, *tensors):
        stage, ring, sched = meta
        m = sched.m
        xs, params = tensors[:m], tensors[m:]
        like = xs[0]
        zero = torch.zeros_like(like)
        recv = None           # what this rank received for the next tick
        prev_out = zero       # overlap: the previous tick's output
        saved: Dict[int, tuple] = {}
        outs: List[Optional[torch.Tensor]] = [None] * m
        for t in range(sched.ticks):
            wait = None
            if sched.overlap and sched.shifts_at(t):
                wait = _shift(prev_out, ring, 1)
            mi = sched.micro(t)
            out = zero
            if mi is not None:
                src = xs[mi] if sched.idx == 0 else recv
                inp = src.detach().requires_grad_(src.requires_grad
                                                  or sched.idx > 0)
                with torch.enable_grad():
                    y = stage(inp)
                saved[t] = (inp, y)
                out = y.detach()
                r = sched.retired(t)
                if r is not None:
                    outs[r] = out
            if not sched.overlap and sched.shifts_at(t):
                wait = _shift(out, ring, 1)
            recv = wait() if wait is not None else None
            prev_out = out
        if ring is not None:
            full = _bcast(_stack_nhwc(outs) if sched.idx == sched.s - 1
                          else _stack_nhwc([zero] * m), ring, sched.s - 1)
            outs = [_channels_last(u) for u in _unstack_nhwc(full, like)]
        ctx.meta, ctx.saved, ctx.params = meta, saved, params
        ctx.like = like
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        stage, ring, sched = ctx.meta
        m = sched.m
        want_params = any(ctx.needs_input_grad[1 + m:])
        params = [p for p in ctx.params]
        zero = torch.zeros_like(ctx.like)
        acc: List[Optional[torch.Tensor]] = [None] * len(params)
        gx: List[Optional[torch.Tensor]] = [None] * m
        g_for_out: Dict[int, torch.Tensor] = {}
        g_in_prev = zero
        for t in reversed(range(sched.ticks)):
            wait = None
            if sched.overlap and sched.shifts_at(t):
                wait = _shift(g_in_prev, ring, -1)
            g_in = zero
            mi = sched.micro(t)
            if mi is not None:
                inp, y = ctx.saved.pop(t)
                g_out = g_for_out.pop(t, None)
                r = sched.retired(t)
                if r is not None and grads[r] is not None:
                    g_out = grads[r] if g_out is None else g_out + grads[r]
                if g_out is None:
                    g_out = torch.zeros_like(y)
                needs = [inp] if inp.requires_grad else []
                if want_params:
                    needs += [p for p in params if p.requires_grad]
                got = torch.autograd.grad(y, needs, g_out.to(y.dtype),
                                          allow_unused=True)
                k = 0
                if inp.requires_grad:
                    g_in = got[0] if got[0] is not None else zero
                    k = 1
                    if sched.idx == 0:
                        gx[mi] = g_in
                if want_params:
                    i = 0
                    for j, p in enumerate(params):
                        if not p.requires_grad:
                            continue
                        g = got[k + i]
                        i += 1
                        if g is not None:
                            acc[j] = g if acc[j] is None else acc[j] + g
            if not sched.overlap and t >= 1 and sched.shifts_at(t - 1):
                wait = _shift(g_in, ring, -1)
            if wait is not None:
                # serial: the cotangent of this rank's output at tick
                # t − 1; overlap: of its output at t − 1 from tick t + 1
                # (the last stage's comes round from stage 0: dropped, as
                # stage 0 drops what it receives in the forward)
                got_g = wait()
                if sched.idx != sched.s - 1:
                    g_for_out[t - 1] = got_g
            g_in_prev = g_in
        ctx.saved = None
        gx = [zero if g is None else g for g in gx]
        if ring is not None:
            full = _bcast(_stack_nhwc(gx), ring, 0)
            gx = [_channels_last(u) for u in _unstack_nhwc(full, ctx.like)]
        return (None, *gx, *acc)


def gpipe_trunk(stage: nn.Module, xs: Sequence[torch.Tensor],
                mesh: Optional[Mesh] = None, overlap: bool = False
                ) -> List[torch.Tensor]:
    """Run ``stage`` (this pipe rank's blocks, a :class:`StageStack` or
    any module whose parameters it uses) over the M microbatches ``xs``
    (4-D channels_last tensors of one shape) on the GPipe schedule over
    the mesh's ``pipe`` axis (module docstring); returns the M trunk
    outputs on every pipe rank. With no mesh (or ``pipe`` 1) it is the
    sequential microbatch loop. The stored-scale int8 modules of
    ``stage`` max-combine their proposals (``pp_proposal``) over the
    computed ticks; read them with :func:`take_proposals`."""
    ring = _stage_ring(mesh)
    idx = mesh.pipe_rank if ring is not None else 0
    n_stages = ring.size if ring is not None else 1
    sched = _Schedule(len(xs), n_stages, idx, overlap)
    params = [p for p in stage.parameters()]
    xs = [_channels_last(x) for x in xs]
    return list(_GPipe.apply((stage, ring, sched), *xs, *params))


def start_proposals(stage: nn.Module) -> None:
    """Arm the stored-scale int8 modules of ``stage`` to max-combine their
    amax proposals (from zeros: proposals are ≥ 0) instead of storing."""
    for q in quant_modules(stage):
        q.pp_proposal = torch.zeros_like(q.amax_x)


def take_proposals(stage: nn.Module, mesh: Optional[Mesh] = None
                   ) -> List[torch.Tensor]:
    """The combined proposals of ``stage``'s int8 modules (in module
    order), max-reduced over the mesh's data line, and disarm them."""
    quants = quant_modules(stage)
    props = [q.pp_proposal for q in quants]
    for q in quants:
        q.pp_proposal = None
    if props and mesh is not None and mesh.batch_shards > 1:
        flat = torch.stack(props)
        dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=mesh.batch_group)
        props = list(flat.unbind())
    return props


def pp_generator_forward(net_g: nn.Module, stage: nn.Module,
                         x_mb: torch.Tensor, mesh: Optional[Mesh] = None,
                         overlap: bool = False) -> torch.Tensor:
    """The pipelined generator forward (expand and resnet families):
    ``x_mb`` [M, mb, C, H, W] (mb this rank's rows) → G's output [M, mb,
    ...]. The encoder and decoder run on the mb-major flat batch through
    the real module (its ``trunk_fn`` hook), replicated over ``pipe``;
    the trunk runs :func:`gpipe_trunk`. The caller sets the modules' modes
    (the PP step runs G in eval mode)."""
    n_micro = int(x_mb.shape[0])

    def trunk_fn(y):
        ys = mb_major_unflatten(y, n_micro)
        outs = gpipe_trunk(stage, [ys[m] for m in range(n_micro)], mesh,
                           overlap)
        return _channels_last(mb_major_flatten(torch.stack(outs)))

    y = net_g(_channels_last(mb_major_flatten(x_mb)), trunk_fn=trunk_fn)
    return mb_major_unflatten(y, n_micro)


__all__ = ["StageStack", "gpipe_trunk", "mb_major_flatten",
           "mb_major_unflatten", "pp_full", "pp_generator_forward",
           "pp_merge_state", "pp_split_state", "pp_stats", "pp_width_of",
           "reset_pp_stats", "stack_trunk", "start_proposals",
           "take_proposals", "trunk_prefix", "unstack_trunk"]
