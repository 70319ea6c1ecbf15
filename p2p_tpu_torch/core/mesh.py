"""The mesh of the port's data axis and its process groups (counterpart of
``p2p_tpu/core/mesh.py``).

The JAX package lays every device into one ``jax.sharding.Mesh`` with the
named axes ``data``, ``fsdp``, ``spatial``, ``time``, ``model`` and
``pipe``, and GSPMD inserts the collectives. Here one process drives one
device (rank ``r`` on ``cuda:LOCAL_RANK``), the processes are started by
``torchrun`` (``python -m torch.distributed.run``), and every collective is
written out: :class:`Mesh` holds the world size and rank, the resolved
axis sizes and one ``torch.distributed`` group per axis that is wider than
one (``data``; ``fsdp`` when > 1; an axis as wide as the world is the
default group). :func:`distributed_init` forms the default group from the
``torchrun`` environment, NCCL on the card and gloo on the CPU; a group
that fails to form raises, and nothing falls back to one process.

The port has the data axis and ZeRO state sharding over ``fsdp``
(parallel/dp.py, parallel/rules.py), the spatial axis (slice 13b:
parallel/halo.py, parallel/spatial.py): H split over ``spatial`` ranks,
each rank holding a contiguous block of rows of every activation; the
time axis (parallel/temporal.py): a clip's T split over ``time`` ranks,
each rank holding a contiguous block of frames (:func:`frame_block`, the
clip layout of ``p2p_tpu/core/mesh.py:412 video_sharding``: N over data ×
fsdp, T over time); the model axis (parallel/tp.py): Megatron tensor
parallelism, each conv of a pair holding its channel shard; and the pipe
axis (parallel/pp.py): the generator's residual trunk on the GPipe
schedule, each pipe rank holding one stage's blocks, the rest replicated
over ``pipe``. :func:`check_ported_axes` refuses by name the axis
combinations the port does not compose (time with spatial on one clip;
model with spatial, time or fsdp; pipe with spatial, time, model or fsdp:
JAX's ``gpipe_trunk`` shards only ``data`` and ``pipe``).

Ported as they are, as pure functions: :class:`MeshSpec` and its
``resolve`` diagnostics, the ``--mesh`` grammar (:func:`parse_mesh_arg`),
:class:`TopologyMismatch`, the sidecar topology block
(:func:`mesh_topology`, :func:`describe_topology`), the elastic
classification (:class:`TopologyDelta`, :func:`classify_topology_delta`)
and :func:`local_batch_size`. The JAX ``mesh_context`` / ``current_mesh``
pair makes the mesh visible to the layers that need it (sync-BatchNorm,
dropout, ops/norm.py and models/unet.py) for the duration of a parallel
step; :func:`process_count`, :func:`process_index` and
:func:`process_allgather` are the port's ``jax.process_count``,
``jax.process_index`` and ``multihost_utils.process_allgather``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SPATIAL_AXIS = "spatial"
TIME_AXIS = "time"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
ALL_AXES = (DATA_AXIS, FSDP_AXIS, SPATIAL_AXIS, TIME_AXIS, MODEL_AXIS,
            PIPE_AXIS)
#: the axes a batch's leading dimension shards over
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)
#: the axes of a later slice, and which (none: every axis is ported)
LATER_AXES: Dict[str, str] = {}
#: the axes a one-process run resolves as 1 (the presets' own meshes)
ONE_DEVICE_AXES = (SPATIAL_AXIS, TIME_AXIS, MODEL_AXIS, PIPE_AXIS)
#: pairs of axes the port does not compose on one mesh
UNCOMPOSED_AXES = ((TIME_AXIS, SPATIAL_AXIS), (MODEL_AXIS, SPATIAL_AXIS),
                   (MODEL_AXIS, TIME_AXIS), (MODEL_AXIS, FSDP_AXIS),
                   (PIPE_AXIS, SPATIAL_AXIS), (PIPE_AXIS, TIME_AXIS),
                   (PIPE_AXIS, MODEL_AXIS), (PIPE_AXIS, FSDP_AXIS))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. -1 on the data axis means "all remaining
    devices"."""

    data: int = -1
    spatial: int = 1
    time: int = 1
    model: int = 1
    pipe: int = 1
    fsdp: int = 1

    def resolve(self, n_devices: int,
                context: str = "") -> Tuple[int, int, int, int, int, int]:
        """Concrete per-axis sizes ``(data, fsdp, spatial, time, model,
        pipe)`` for ``n_devices``; ``context`` is appended to the failure
        diagnostics (the elastic relaunch passes the saved topology)."""
        d, f, s, t, m, p = (self.data, self.fsdp, self.spatial, self.time,
                            self.model, self.pipe)
        fixed = f * s * t * m * p
        suffix = f"; {context}" if context else ""
        if d == -1:
            if n_devices % fixed:
                raise ValueError(
                    f"mesh data=-1,fsdp={f},spatial={s},time={t},model={m},"
                    f"pipe={p} cannot resolve: {n_devices} device(s) not "
                    f"divisible by fsdp*spatial*time*model*pipe={fixed} — "
                    f"pick axes whose product divides the device "
                    f"count{suffix}"
                )
            d = n_devices // fixed
        if d * fixed > n_devices:
            raise ValueError(
                f"mesh data={d},fsdp={f},spatial={s},time={t},model={m},"
                f"pipe={p} needs {d * fixed} devices but only {n_devices} "
                f"are available — shrink an axis or use data=-1 (all "
                f"remaining devices){suffix}"
            )
        return d, f, s, t, m, p


def parse_mesh_arg(text: str) -> MeshSpec:
    """The ``--mesh`` flag grammar: positional ``data,spatial,time[,model[,
    pipe]]`` or named ``axis=size[,axis=size...]`` over every axis (unnamed
    axes 1, data -1 when omitted; the only way to name ``fsdp``). Raises
    ``ValueError`` with the offending text."""
    text = text.strip()
    if "=" in text:
        sizes = {}
        for part in text.split(","):
            if not part.strip():
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key not in ALL_AXES:
                raise ValueError(
                    f"unknown mesh axis {key!r} (have {ALL_AXES})")
            if key in sizes:
                raise ValueError(f"mesh axis {key!r} named twice")
            sizes[key] = int(val)
        spec = MeshSpec(data=sizes.pop(DATA_AXIS, -1), **sizes)
    else:
        vals = [int(v) for v in text.split(",")]
        if len(vals) < 3:   # only model/pipe are optional
            raise ValueError("too few axes")
        while len(vals) < 5:
            vals.append(1)
        if len(vals) > 5:
            raise ValueError("too many axes (use the named form for fsdp)")
        d, s, t, m, p = vals
        spec = MeshSpec(data=d, spatial=s, time=t, model=m, pipe=p)
    for axis in ALL_AXES:
        size = getattr(spec, axis)
        if size < 1 and not (axis == DATA_AXIS and size == -1):
            raise ValueError(
                f"mesh axis {axis}={size}: axes must be >=1 (data may be "
                "-1 = all remaining devices)")
    return spec


def check_ported_axes(spec: MeshSpec) -> None:
    """Raise ``NotImplementedError`` naming the later slice when ``spec``
    widens an axis of :data:`LATER_AXES` (none now), or widens two axes
    the port does not compose (:data:`UNCOMPOSED_AXES`)."""
    wide = [f"{a}={getattr(spec, a)}" for a in LATER_AXES
            if getattr(spec, a) > 1]
    if wide:
        slices = sorted({LATER_AXES[w.split("=")[0]] for w in wide})
        raise NotImplementedError(
            f"mesh axes {', '.join(wide)} are not ported yet (this mesh "
            f"needs slice {' and '.join(slices)})")
    for a, b in UNCOMPOSED_AXES:
        if getattr(spec, a) > 1 and getattr(spec, b) > 1:
            raise NotImplementedError(
                f"mesh axes {a}={getattr(spec, a)} and {b}="
                f"{getattr(spec, b)} together are not ported: the port "
                f"runs the {a} axis with the data axis only here")


class TopologyMismatch(ValueError):
    """An elastic relaunch hit a topology delta the resharded resume cannot
    reconcile (``abort``), or elastic resume was disabled; the message
    names the saved and current topologies and what to change."""


# ------------------------------------------------------------- processes
def process_count() -> int:
    """Processes of the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def collective_device() -> torch.device:
    """Where a host-side collective's tensor lives: the current card under
    NCCL (which takes no CPU tensor), the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(x: np.ndarray) -> np.ndarray:
    """Every process's ``x`` (one shape and dtype on all), stacked along a
    new leading axis in rank order; ``x[None]`` on one process."""
    x = np.asarray(x)
    if process_count() == 1:
        return x[None]
    t = torch.from_numpy(np.ascontiguousarray(x)).to(collective_device())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out])


def distributed_init(device: Optional[torch.device] = None) -> bool:
    """Form the default process group from the ``torchrun`` environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL when
    ``device`` is a card (after ``torch.cuda.set_device``), gloo on the
    CPU. Returns False with no ``torchrun`` environment (one process, no
    group: the plain run), True when a group is up (also one formed by
    the caller before). A group that fails to form raises, and NCCL
    missing on a card raises."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    cuda = device is not None and torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    if cuda:
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA run needs NCCL, and this PyTorch "
                               "has no NCCL backend")
        torch.cuda.set_device(torch.device(device))
    elif not dist.is_gloo_available():
        raise RuntimeError("a CPU run needs gloo, and this PyTorch has none")
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return True


def rank_device(device: Optional[torch.device] = None) -> torch.device:
    """Rank ``r``'s device: ``cuda:LOCAL_RANK`` for a card (the default)
    under ``torchrun``, else ``device`` as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None \
            and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


# ------------------------------------------------------------------ mesh
class Mesh:
    """The processes of the default group laid out as the JAX mesh: axis
    order (data, fsdp, spatial, time, model, pipe), data outermost, one
    process per device, every process in the mesh. ``shape`` maps every
    axis to its size (as ``jax.sharding.Mesh.shape``); :meth:`group` is the
    process group of an axis through this rank (None: the default group,
    for an axis as wide as the world); ``batch_group`` is the group the
    batch splits over (the data × fsdp line through this rank; None when
    that is the whole world), ``batch_rank`` this rank's slot in it. With
    ``spatial`` > 1,
    ``spatial``/``spatial_rank`` are the axis size and this rank's
    coordinate, and :meth:`group` of ``"spatial"`` the ranks that hold one
    batch slot's rows; ``time``/``time_rank`` and ``model``/``model_rank``
    likewise (a slot's frames; a conv pair's channel shards).
    ``reduce_group`` is the line over data × fsdp × spatial × time through
    this rank (None when that is the world: with ``model`` and ``pipe`` at
    1), the ranks whose gradients of one parameter shard (a Megatron
    shard, a pipe stage's blocks) add up. ``pipe``/``pipe_rank`` are the
    pipe axis's size and this rank's stage. Every rank builds every
    group, in one order."""

    def __init__(self, spec: MeshSpec = MeshSpec()):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs a process group: call "
                               "distributed_init under torchrun first")
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        check_ported_axes(spec)
        sizes = spec.resolve(self.world_size)
        if int(np.prod(sizes)) != self.world_size:
            raise ValueError(
                f"mesh {dict(zip(ALL_AXES, sizes))} covers "
                f"{int(np.prod(sizes))} of {self.world_size} processes: "
                "every process of the group must be in the mesh")
        self.spec = spec
        self.shape: Dict[str, int] = dict(zip(ALL_AXES, map(int, sizes)))
        self.size = self.world_size
        coords = np.unravel_index(self.rank, sizes)
        self.coords = dict(zip(ALL_AXES, map(int, coords)))
        self._groups = {}
        grid = np.arange(self.world_size).reshape(sizes)
        for i, axis in enumerate(ALL_AXES):
            if self.shape[axis] > 1:
                self._groups[axis] = self._line_group(grid, (i,))
        self.batch_shards = self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]
        self.batch_rank = (self.coords[DATA_AXIS] * self.shape[FSDP_AXIS]
                           + self.coords[FSDP_AXIS])
        # the data x fsdp line through this rank: the world only while
        # every other axis is 1
        self.batch_group = self._line_group(grid, (0, 1))
        self.reduce_group = self._line_group(grid, (0, 1, 2, 3))
        self.spatial = self.shape[SPATIAL_AXIS]
        self.spatial_rank = self.coords[SPATIAL_AXIS]
        self.time = self.shape[TIME_AXIS]
        self.time_rank = self.coords[TIME_AXIS]
        self.model = self.shape[MODEL_AXIS]
        self.model_rank = self.coords[MODEL_AXIS]
        self.pipe = self.shape[PIPE_AXIS]
        self.pipe_rank = self.coords[PIPE_AXIS]

    def _line_group(self, grid: np.ndarray, dims: Tuple[int, ...]):
        """The group of the ranks that differ from this one only along the
        mesh dimensions ``dims`` (None: the default group, when that is
        every rank). Every rank creates every line's group, in order."""
        n = int(np.prod([grid.shape[d] for d in dims]))
        if n == self.world_size:
            return None
        rest = [d for d in range(grid.ndim) if d not in dims]
        lines = np.transpose(grid, rest + list(dims)).reshape(-1, n)
        mine = None
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if self.rank in line:
                mine = g
        return mine

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None: the
        default group). Raises for an axis of size 1."""
        if axis not in self._groups:
            raise ValueError(f"mesh axis {axis!r} has size 1: no group")
        return self._groups[axis]

    def group_ranks(self, axis: str):
        """The global ranks of ``axis``'s group through this rank, in
        axis order."""
        grid = np.arange(self.world_size).reshape(
            [self.shape[a] for a in ALL_AXES])
        idx = tuple(slice(None) if a == axis else self.coords[a]
                    for a in ALL_AXES)
        return [int(r) for r in grid[idx]]


_ACTIVE_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "p2p_tpu_torch_active_mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Expose ``mesh`` to the layers that run inside this context (the
    parallel step builders enter it around the step body)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def current_mesh() -> Optional[Mesh]:
    """The mesh made visible by :func:`mesh_context`, or None."""
    return _ACTIVE_MESH.get()


# -------------------------------------------------------------- topology
def mesh_topology(mesh: Optional[Mesh]) -> dict:
    """The recorded topology block of the checkpoint sidecar: process and
    device counts and the mesh's axis sizes (empty without a mesh)."""
    return {
        "process_count": process_count(),
        "device_count": int(mesh.size) if mesh is not None else 1,
        "mesh": dict(mesh.shape) if mesh is not None else {},
    }


def describe_topology(topo: dict) -> str:
    """One-line human form of a topology block."""
    mesh = topo.get("mesh") or {}
    axes = ",".join(f"{a}={mesh[a]}" for a in mesh) or "none"
    return (f"{topo.get('process_count', '?')} process(es) x "
            f"{topo.get('device_count', '?')} device(s), mesh [{axes}], "
            f"global_batch={topo.get('global_batch', '?')}")


@dataclasses.dataclass(frozen=True)
class TopologyDelta:
    """A saved-vs-current topology difference: ``kind`` is ``"same"``,
    ``"reshard"`` (process count, data/fsdp/spatial/time widths, device
    count: a plain load onto the new world, every checkpoint being in the
    one-device format), ``"migrate"`` (through the
    restore-time transforms ``chain`` names, in order: ``batch_rebase``,
    ``pp_restructure``, ``tp_amax_recalibrate``, ``dtype_cast``) or
    ``"abort"``."""

    kind: str
    reason: str
    chain: tuple = ()


def classify_topology_delta(saved: dict, current: dict,
                            has_quant_state: bool = False,
                            cast_on_restore: bool = False) -> TopologyDelta:
    """Reconcile a checkpoint's recorded topology block with the
    relaunch's, by the JAX rules (``p2p_tpu/core/mesh.py:241``): a global
    batch change migrates through ``batch_rebase``; a mixed-precision or
    moment-dtype change through ``dtype_cast`` with ``cast_on_restore``,
    else aborts; an ``int8_delayed`` change aborts; a pipe-width change
    migrates through ``pp_restructure``, a model-width change under
    delayed-int8 state through ``tp_amax_recalibrate``; any other mesh,
    process-count or device-count change reshards. Keys absent from
    ``saved`` match."""
    def differs(key):
        if key not in saved:
            return False
        a, b = saved[key], current.get(key)
        if key == "moment_dtype":
            a, b = a or "float32", b or "float32"
        return a != b

    chain = []
    reasons = []
    if differs("global_batch"):
        chain.append("batch_rebase")
        reasons.append(
            f"the global batch size changed "
            f"({saved.get('global_batch')} -> "
            f"{current.get('global_batch')}) — step/epoch position and "
            "the LR-schedule basis re-derive from cumulative samples")
    for key, what in (("mixed_precision", "the mixed-precision policy"),
                      ("moment_dtype", "the Adam moment storage dtype")):
        if differs(key):
            if not cast_on_restore:
                return TopologyDelta(
                    "abort",
                    f"{what} changed ({saved.get(key)} -> "
                    f"{current.get(key)}) — restore would silently cast "
                    "the state; relaunch with the original dtype flags, "
                    "or opt in to an explicit, logged cast with "
                    "--cast_on_restore")
            if "dtype_cast" not in chain:
                chain.append("dtype_cast")
            reasons.append(
                f"{what} changed ({saved.get(key)} -> "
                f"{current.get(key)}) — cast on restore "
                "(--cast_on_restore)")
    if differs("int8_delayed"):
        return TopologyDelta(
            "abort",
            "the delayed-int8 policy changed — the TrainState tree "
            "differs (quant collections), which no cast reconciles; "
            "relaunch with the original --int8_delayed")
    has_saved_mesh = "mesh" in saved
    saved_mesh = saved.get("mesh") or {}
    cur_mesh = current.get("mesh") or {}

    def axis(block, name):
        return int(block.get(name, 1))

    if has_saved_mesh:
        if axis(saved_mesh, PIPE_AXIS) != axis(cur_mesh, PIPE_AXIS):
            chain.append("pp_restructure")
            reasons.append(
                f"the pipeline-parallel width changed "
                f"({axis(saved_mesh, PIPE_AXIS)} -> "
                f"{axis(cur_mesh, PIPE_AXIS)}) — the stacked trunk "
                "merges and re-splits at the new width")
        if axis(saved_mesh, MODEL_AXIS) != axis(cur_mesh, MODEL_AXIS) \
                and has_quant_state:
            chain.append("tp_amax_recalibrate")
            reasons.append(
                f"the tensor-parallel width changed "
                f"({axis(saved_mesh, MODEL_AXIS)} -> "
                f"{axis(cur_mesh, MODEL_AXIS)}) under delayed-int8 amax "
                "state — stored scales remap by the closed-form max law")
    changed = [k for k in ("process_count", "device_count")
               if differs(k)]
    if has_saved_mesh:
        changed += [f"mesh.{a}" for a in set(saved_mesh) | set(cur_mesh)
                    if axis(saved_mesh, a) != axis(cur_mesh, a)]
    if chain:
        if changed:
            reasons.append("topology delta: " + ", ".join(sorted(changed)))
        return TopologyDelta("migrate", "; ".join(reasons),
                             chain=tuple(chain))
    if changed:
        return TopologyDelta(
            "reshard", "topology delta: " + ", ".join(sorted(changed)))
    return TopologyDelta("same", "identical topology")


def local_batch_size(global_batch: int, mesh: Optional[Mesh] = None) -> int:
    """Per-process batch of the input pipeline: the global batch over the
    mesh's batch slots (spatial, model and pipe peers load the same
    samples), or over the processes without a mesh."""
    n_proc = mesh.batch_shards if mesh is not None else process_count()
    if global_batch % n_proc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n_proc} processes")
    return global_batch // n_proc


# ----------------------------------------------------------- spatial rows
def spatial_mesh() -> Optional[Mesh]:
    """The active mesh when its ``spatial`` axis is wider than one (every
    activation of the step is then this rank's block of rows), else
    None."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.spatial > 1 else None


def row_block(h: int, n: int, i: int) -> Tuple[int, int]:
    """Rows ``[start, stop)`` of ``h`` that rank ``i`` of ``n`` owns: the
    balanced split, ``start = ⌊i·h/n⌋``. Every map of a spatial step is laid
    out so, whatever its height, and each output row of a windowed op has
    exactly this one owner."""
    return (i * h) // n, ((i + 1) * h) // n


def set_rows(x: torch.Tensor, h: int) -> torch.Tensor:
    """Record on ``x`` (this rank's rows of a map) the map's global height
    ``h``; returns ``x``."""
    x.p2p_rows = int(h)
    return x


def rows_of(x: torch.Tensor) -> int:
    """The global height of the map whose rows ``x`` holds. Raises for a
    tensor no spatial op or caller recorded it on: an op the spatial step
    does not cover (nothing computes on rows it cannot place)."""
    h = getattr(x, "p2p_rows", None)
    if h is None:
        raise RuntimeError(
            f"a tensor of shape {tuple(x.shape)} reached a spatial op with "
            "no row layout recorded: this op or model has no sharded form "
            "under a spatial mesh (parallel/spatial.py)")
    return h


def keep_rows(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` with ``x``'s recorded height, under a spatial mesh, when y has
    x's rows (an elementwise op, a channel concat); returns ``y``."""
    h = getattr(x, "p2p_rows", None)
    if h is not None and y.dim() == 4 and y.shape[2] == x.shape[2]:
        y.p2p_rows = h
    return y


# ------------------------------------------------------------ clip frames
def time_mesh() -> Optional[Mesh]:
    """The active mesh when its ``time`` axis is wider than one (every clip
    of the step is then this rank's block of frames), else None."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.time > 1 else None


def frame_block(t: int, n: int, i: int) -> Tuple[int, int]:
    """Frames ``[start, stop)`` of a clip of ``t`` frames that time rank
    ``i`` of ``n`` owns (the split of :func:`row_block`; the clip layouts
    of a time step need ``t`` divisible by ``n``, as the JAX clip sharding
    does)."""
    if t % n:
        raise ValueError(f"a clip of {t} frames does not split over {n} "
                         "time ranks")
    return row_block(t, n, i)


def set_frames(x: torch.Tensor, t: int) -> torch.Tensor:
    """Record on ``x`` (this rank's frames of a (N, C, T, H, W) clip) the
    clip's global frame count ``t``; returns ``x``."""
    x.p2p_frames = int(t)
    return x


def frames_of(x: torch.Tensor) -> int:
    """The global frame count of the clip whose frames ``x`` holds. Raises
    for a tensor nothing recorded it on: an op that needs the global T
    given a clip of unknown layout (nothing computes on frames it cannot
    place)."""
    t = getattr(x, "p2p_frames", None)
    if t is None:
        raise RuntimeError(
            f"a clip of shape {tuple(x.shape)} reached a time-sharded op "
            "with no frame layout recorded: this op or model has no "
            "sharded form under a time mesh (parallel/temporal.py)")
    return t


_CLIP_FRAMES: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "p2p_tpu_torch_clip_frames", default=None)


@contextlib.contextmanager
def clip_context(t: int) -> Iterator[None]:
    """Frames of a folded clip batch: within, a network given folded
    frames (N·T_local of them) under a time mesh knows they are this
    rank's frames of clips of ``t`` frames (the U-Net's global dropout
    draw)."""
    token = _CLIP_FRAMES.set(int(t))
    try:
        yield
    finally:
        _CLIP_FRAMES.reset(token)


def clip_frames() -> Optional[int]:
    """The global clip length :func:`clip_context` set, or None."""
    return _CLIP_FRAMES.get()
