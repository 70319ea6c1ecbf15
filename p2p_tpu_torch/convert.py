"""Weights across frameworks: flax variable trees → torch state_dicts
(generators, net_c, the discriminators, VGG19, a whole train state), and
``.npz`` files of flax parameter trees.

A flax tree is a nested dict of arrays; every parameter and buffer of the
port's modules sits at the same path as its flax counterpart, with the
inner ``Conv_0`` renamed ``conv``, the kernel moved from HWIO to OIHW, and
BatchNorm's doubled level dropped:

    global/ResnetBlock_0/ConvLayer_1/Conv_0/kernel (3,3,I,O)
      → global.ResnetBlock_0.ConvLayer_1.conv.weight (O,I,3,3)
    ResidualBlock_0/BatchNorm_1/BatchNorm_0/mean → ResidualBlock_0.BatchNorm_1.mean
    scale2/SpectralConv_0/kernel, …/u → scale2.SpectralConv_0.weight, ….u

Given the port's module, two kernel layouts follow its layer types: a
flax ``ConvTranspose`` kernel (kh,kw,I,O) becomes the ``weight`` of an
``nn.ConvTranspose2d`` (I,O,kh,kw) flipped in both spatial axes, and a
layer that holds a ``kernel`` parameter (the subpixel head's conv, which
kernel #6 reads in HWIO) keeps it as it is:

    up3/kernel (4,4,I,O) → up3.weight (I,O,4,4), [i,o,a,b] = [3-a,3-b,i,o]
    up0/Conv_0/kernel (2,2,C,4F) → up0.conv.kernel (2,2,C,4F)

A 3-D kernel (the temporal D's, DHWIO) goes to torch's OIDHW:

    tscale1/_Conv3D_0/Conv_0/kernel (3,4,4,I,O)
      → tscale1._Conv3D_0.conv.weight (O,I,3,4,4)

Networks whose flax tree has no leaf for a module carry none here
either: an ExpandNetwork with ``norm="pallas_instance"`` (affine-free
norms, no conv biases) has no ``BatchNorm_k`` leaves, and the
pix2pixHD ``TrainState`` (G, the 3-scale D with its spectral ``u``, two
Adams) has empty ``batch_stats`` and no net_c. Flax's ``_SplitStemConv``
keeps its stem kernel whole, so a JAX D on split pairs has the tree of the
port's D, which always takes concatenated pairs.

A delayed-int8 network's ``quant`` collection (the JAX state's
``quant_g``, ``quant_d`` and ``quant_c``) holds one 0-d ``amax_x`` per
quantized conv, at the conv's own path; it is the buffer of the port's
int8 module there (a ``QuantConv`` named ``down{i}``, the ``Conv_0`` of a
``ConvLayer``, of a ``_PlainConv``'s ``QuantConv`` or ``KN2RowConv`` and
of a ``QuantSubpixelDeconv``, a ``SpectralConv`` itself):

    scale0/_PlainConv_2/Conv_0/amax_x () → scale0._PlainConv_2.conv.amax_x
    up3/Conv_0/amax_x () → up3.conv.amax_x
    scale0/SpectralConv_1/amax_x () → scale0.SpectralConv_1.amax_x

A ``QuantSubpixelDeconv``'s (2, 2, C, 4F) kernel stays HWIO, as
``SubpixelDeconv``'s; a ``QuantConvTranspose``'s is flipped into
``nn.ConvTranspose2d``'s layout, as ``ConvTranspose``'s.

A JAX train state split over a pipe mesh (``p2p_tpu/parallel/pp.py
pp_split_state``) holds its trunk as ``pp_stages``, each collection one
block's tree with ``[S, B]`` leading axes, and the trunk's Adam state as
``opt_s``; :func:`unstack_flax` reads block ``s·B + j`` at ``[s, j]`` (the
law of parallel/pp.py ``stack_trunk``) back into per-block subtrees, and
:func:`load_pp_train_state` loads such a state into the port's flat one,
which ``parallel.pp.pp_split_state`` then puts on the stage ranks under
the same law.

An ``.npz`` file holds one array per leaf under its ``/``-joined path (a
generator's parameters and running statistics side by side).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def flatten_tree(tree: Mapping[str, Any], prefix: str = ""
                 ) -> Dict[str, np.ndarray]:
    """Nested dict → ``{"a/b/c": array}``."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """``{"a/b/c": array}`` → nested dict."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_npz(path: str, *trees: Mapping[str, Any]) -> None:
    """Write flax variable trees of one module (its ``params``, and its
    ``batch_stats`` where it has BatchNorms) as one ``.npz`` of
    ``/``-joined keys; the trees must not share a leaf."""
    flat: Dict[str, np.ndarray] = {}
    for tree in trees:
        leaves = flatten_tree(tree)
        shared = sorted(set(leaves) & set(flat))
        if shared:
            raise ValueError(f"trees share leaves {shared[:3]}")
        flat.update(leaves)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> Dict[str, Any]:
    """Read an ``.npz`` written by :func:`save_npz` back into a tree."""
    with np.load(path, allow_pickle=False) as z:
        return unflatten_tree({k: z[k] for k in z.files})


# leaves that keep their flax name (every other leaf must be a conv kernel)
_KEPT_LEAVES = ("bias", "scale", "mean", "var", "alpha", "u", "amax_x")


def kernel_to_port(w: torch.Tensor, owner: Optional[torch.nn.Module]
                   ) -> torch.Tensor:
    """A flax conv kernel (HWIO, or DHWIO in 3-D) → the layout of the
    port's parameter of ``owner``: a layer's own ``kernel`` parameter keeps
    HWIO, an ``nn.ConvTranspose2d``'s weight is (I, O, kh, kw) flipped in
    both spatial axes, any other conv's weight OIHW (OIDHW). A view where
    no flip is needed."""
    if isinstance(getattr(owner, "kernel", None), torch.nn.Parameter):
        return w
    if isinstance(owner, torch.nn.ConvTranspose2d):
        return w.flip(0, 1).permute(2, 3, 0, 1)
    return w.permute(w.dim() - 1, w.dim() - 2, *range(w.dim() - 2))


def kernel_to_flax(p: torch.Tensor, owner: Optional[torch.nn.Module]
                   ) -> torch.Tensor:
    """The inverse of :func:`kernel_to_port`: the port's kernel parameter
    ``p`` of ``owner`` in its flax layout."""
    if isinstance(getattr(owner, "kernel", None), torch.nn.Parameter):
        return p
    if isinstance(owner, torch.nn.ConvTranspose2d):
        return p.permute(2, 3, 0, 1).flip(0, 1)
    return p.permute(*range(2, p.dim()), 1, 0)


def state_from_flax(*trees: Mapping[str, Any],
                    module: Optional[torch.nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flax variable trees of one module (its ``params`` and any
    collections: ``batch_stats``, ``spectral``) → the state_dict of the
    port's module of the same config. Raises on a leaf with no counterpart.

    Conv kernels go HWIO → OIHW (3-D ones DHWIO → OIDHW) and are named
    ``weight`` (under ``conv`` where flax has an inner ``Conv_0``); with
    ``module``, transposed-conv
    kernels are flipped into ``nn.ConvTranspose2d``'s layout and a layer's
    own ``kernel`` parameter stays HWIO. BatchNorm's inner
    ``BatchNorm_0`` level goes (its ``scale``/``bias``/``mean``/``var``
    keep their names); the PReLU ``alpha``, the spectral-norm ``u`` and
    the delayed-int8 ``amax_x`` keep theirs."""
    state = {}
    for tree in trees:
        for key, arr in flatten_tree(tree).items():
            *path, leaf = key.split("/")
            if path and path[-1] == "Conv_0":
                path[-1] = "conv"
            if path[-1:] == ["BatchNorm_0"] and len(path) > 1 \
                    and path[-2].startswith("BatchNorm_"):
                path.pop()
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
            if leaf == "kernel":
                if arr.ndim not in (4, 5):
                    raise ValueError(f"{key}: expected an HWIO or DHWIO "
                                     f"kernel, got shape {arr.shape}")
                owner = _owner(module, path) if arr.ndim == 4 else None
                t = kernel_to_port(t, owner).contiguous()
                if not isinstance(getattr(owner, "kernel", None),
                                  torch.nn.Parameter):
                    leaf = "weight"
            elif leaf not in _KEPT_LEAVES:
                raise ValueError(f"no torch counterpart for flax leaf "
                                 f"{key!r}")
            state[".".join(path + [leaf])] = t
    return state


def _owner(module: Optional[torch.nn.Module], path) -> Any:
    """The submodule of ``module`` at ``path``, or None."""
    if module is None:
        return None
    try:
        return module.get_submodule(".".join(path))
    except AttributeError:
        return None


def load_flax(net: torch.nn.Module, *trees: Mapping[str, Any]
              ) -> torch.nn.Module:
    """Load flax variable trees into ``net`` (every parameter and buffer
    must be present, and nothing else)."""
    net.load_state_dict(state_from_flax(*trees, module=net), strict=True)
    return net


def load_train_state(state, flax_state: Mapping[str, Any]):
    """Load a JAX ``TrainState``'s networks into the port's ``state``
    (train/state.py): ``flax_state`` maps the JAX field names
    ``params_g``, ``batch_stats_g``, ``quant_g``, ``params_d``,
    ``spectral_d``, ``quant_d``, ``params_c``, ``batch_stats_c`` and
    ``quant_c`` to numpy trees (the ``_c`` fields None or absent for a
    state without net_c, the ``quant_`` ones for a network without
    delayed int8). Every parameter and buffer
    must be present, and nothing else; the optimizers stay fresh, as the
    JAX state's are at creation. The optional fields ``ema_g`` (a params
    tree of G), ``pool``, ``pool_n`` and ``lr_scale`` are carried into the
    state's EMA, fake pool and plateau scale, which must exist in the port's
    state when given (and the other way round)."""
    _load_extras(state, flax_state)
    for net, fields in ((state.net_g, ("params_g", "batch_stats_g",
                                       "quant_g")),
                        (state.net_d, ("params_d", "spectral_d",
                                       "quant_d")),
                        (state.net_c, ("params_c", "batch_stats_c",
                                       "quant_c"))):
        trees = [flax_state.get(f) for f in fields]
        if net is None:
            if any(trees):
                raise ValueError(f"the JAX state has {fields[0]} but the "
                                 "port's state has no such network")
            continue
        load_flax(net, *(t for t in trees if t is not None))
    return state


def unstack_flax(stacked: Mapping[str, Any], prefix: str
                 ) -> Dict[str, Any]:
    """A flax tree shaped like one trunk block with ``[S, B]`` leading axes
    (a collection of JAX's ``pp_stages``, or a moment tree of its
    ``opt_s``) → ``{f"{prefix}{i}": block subtree}``, block ``s·B + j``
    from ``[s, j]``."""
    from p2p_tpu_torch.parallel.pp import unstack_trunk

    per_block = unstack_trunk(flatten_tree(stacked), prefix)
    return {k: unflatten_tree(v) for k, v in per_block.items()}


def load_pp_train_state(state, flax_state: Mapping[str, Any], prefix: str):
    """:func:`load_train_state` of a JAX state split over a pipe mesh: its
    ``pp_stages`` collections (``params``, ``batch_stats``, ``quant``)
    unstacked (:func:`unstack_flax`) into ``params_g``, ``batch_stats_g``
    and ``quant_g`` under the trunk blocks' names (``prefix``, parallel/
    pp.py ``trunk_prefix``), then loaded into the port's flat ``state``.
    The optimizers stay fresh, as :func:`load_train_state` leaves them
    (``opt_s``'s moment trees unstack under the same law)."""
    fs = {k: v for k, v in flax_state.items() if k not in ("pp_stages",
                                                          "opt_s")}
    stages = flax_state.get("pp_stages") or {}
    for coll, field in (("params", "params_g"),
                        ("batch_stats", "batch_stats_g"),
                        ("quant", "quant_g")):
        if stages.get(coll):
            fs[field] = {**(fs.get(field) or {}),
                         **unstack_flax(stages[coll], prefix)}
    return load_train_state(state, fs)


def load_video_train_state(state, flax_state: Mapping[str, Any]):
    """Load a JAX ``VideoTrainState``'s networks into the port's ``state``
    (train/video_step.py): ``flax_state`` maps ``params_g``,
    ``batch_stats_g``, ``params_d``, ``spectral_d``, ``params_dt`` and
    ``spectral_dt`` to numpy trees (``batch_stats_g`` empty for an
    instance-norm U-Net), and ``lr_scale`` when given to the state's
    scale. Every parameter and buffer must be present, and nothing else;
    the optimizers stay fresh."""
    for net, fields in ((state.net_g, ("params_g", "batch_stats_g")),
                        (state.net_d, ("params_d", "spectral_d")),
                        (state.net_dt, ("params_dt", "spectral_dt"))):
        load_flax(net, *(flax_state[f] for f in fields
                         if flax_state.get(f) is not None))
    if flax_state.get("lr_scale") is not None:
        state.lr_scale = float(np.asarray(flax_state["lr_scale"]))
    return state


def _load_extras(state, flax_state: Mapping[str, Any]) -> None:
    """``ema_g``, ``pool``, ``pool_n`` and ``lr_scale`` of a JAX state."""
    for name in ("ema_g", "pool"):
        theirs, ours = flax_state.get(name), getattr(state, name)
        if (theirs is None) != (ours is None):
            raise ValueError(f"{name}: the JAX state "
                             f"{'lacks' if theirs is None else 'has'} it, "
                             "the port's state does not agree")
    with torch.no_grad():
        if state.ema_g is not None:
            ema = state_from_flax(flax_state["ema_g"], module=state.net_g)
            if set(ema) != set(state.ema_g):
                raise ValueError("ema_g: leaves differ from G's parameters")
            for k, t in state.ema_g.items():
                t.copy_(ema[k])
        if state.pool is not None:
            state.pool.copy_(torch.from_numpy(np.array(
                flax_state["pool"], dtype=np.float32)))
            state.pool_n.fill_(int(np.asarray(flax_state["pool_n"])))
    if flax_state.get("lr_scale") is not None:
        state.lr_scale = float(np.asarray(flax_state["lr_scale"]))


def graft_flax_g1(net_g: torch.nn.Module, g1_params: Mapping[str, Any],
                  verbose: bool = True) -> torch.nn.Module:
    """Seed the port's full pix2pixHD generator ``net_g`` with a JAX
    ``pix2pixhd_global`` parameter tree (phase 1 of the coarse-to-fine
    schedule) through train/graft.py's ``graft_global_into_full``: G1's
    image head is dropped, every other leaf must match."""
    from p2p_tpu_torch.train.graft import graft_into

    graft_into(net_g, state_from_flax(g1_params), verbose)
    return net_g


def load_generator(generator: torch.nn.Module, npz_path: str
                   ) -> torch.nn.Module:
    """Load a flax generator tree from ``npz_path`` into ``generator``
    (every parameter must be present, and nothing else)."""
    return load_flax(generator, load_npz(npz_path))
