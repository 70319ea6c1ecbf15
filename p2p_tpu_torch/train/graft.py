"""The coarse-to-fine parameter graft of pix2pixHD's schedule (counterpart
of ``p2p_tpu/train/graft.py``).

pix2pixHD trains in two phases: G1 (``pix2pixhd_global``) alone at half
resolution, then the full generator (``pix2pixhd``) at full resolution
with G1's weights carried into its ``global`` submodule. The one
structural difference is G1's image head (its last ``ConvLayer``), which
the embedded G1 (``return_features=True``) lacks: it is dropped on graft,
as the paper discards G1's output layer when it attaches the enhancer.

Trees here are G's parameters nested by the port's module path (the
``state_dict`` names split at ``.``); paths are reported with ``.``. As in
JAX only parameters are grafted: the instance-norm generators have no
running statistics.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a.b.c": t}`` → ``{"a": {"b": {"c": t}}}``."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The inverse of :func:`nest`."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def graft_tree(dst: Dict[str, Any], src: Dict[str, Any], path: str = ""
               ) -> Tuple[Dict[str, Any], List[str], List[str]]:
    """Copy every leaf of ``src`` that exists (same path, same shape) in
    ``dst``. Returns ``(new_dst, grafted_paths, dropped_paths)``; a subtree
    of ``src`` with no counterpart is dropped as one path. A leaf of
    another shape raises ``ValueError``."""
    out = dict(dst)
    grafted: List[str] = []
    dropped: List[str] = []
    for k, v in src.items():
        p = f"{path}.{k}" if path else k
        if k not in dst:
            dropped.append(p)
            continue
        if isinstance(v, dict) and isinstance(dst[k], dict):
            out[k], g, d = graft_tree(dst[k], v, p)
            grafted += g
            dropped += d
        elif getattr(dst[k], "shape", None) == getattr(v, "shape", None):
            out[k] = v
            grafted.append(p)
        else:
            raise ValueError(
                f"graft shape mismatch at {p}: "
                f"{tuple(getattr(dst[k], 'shape', ()))} vs "
                f"{tuple(getattr(v, 'shape', ()))}")
    return out, grafted, dropped


def graft_global_into_full(full_params_g: Dict[str, Any],
                           g1_params: Dict[str, Any],
                           verbose: bool = True) -> Dict[str, Any]:
    """``full_params_g`` (nested) with the phase-1 G1 parameters grafted
    into its ``global`` submodule. G1's image head is dropped; every
    other leaf must match by path and shape; a graft that copies nothing
    raises."""
    if "global" not in full_params_g:
        raise ValueError(
            "full generator params carry no 'global' submodule — is the "
            "generator family 'pix2pixhd'?")
    new_global, grafted, dropped = graft_tree(
        full_params_g["global"], g1_params, "global")
    if not grafted:
        raise ValueError("graft copied nothing — wrong phase-1 checkpoint?")
    if verbose:
        print(f"coarse-to-fine graft: {len(grafted)} leaves into 'global', "
              f"{len(dropped)} head leaves dropped "
              f"({', '.join(dropped) if dropped else 'none'})", flush=True)
    out = dict(full_params_g)
    out["global"] = new_global
    return out


def g1_phase_config(cfg):
    """The phase-1 config implied by a full pix2pixHD config: the G1
    family, half resolution, the ``<name>_g1`` checkpoint namespace."""
    name = cfg.name if cfg.name.endswith("_g1") else cfg.name + "_g1"
    return dataclasses.replace(
        cfg, name=name,
        model=dataclasses.replace(cfg.model, generator="pix2pixhd_global"),
        data=dataclasses.replace(
            cfg.data, image_size=cfg.data.image_size // 2,
            image_width=(cfg.data.image_width // 2
                         if cfg.data.image_width else None)))


@torch.no_grad()
def graft_into(net_g: nn.Module, g1_params: Mapping[str, torch.Tensor],
               verbose: bool = True) -> None:
    """Graft G1 parameters (``{state_dict name: tensor}``) into the full
    generator ``net_g`` in place (its device and layout kept)."""
    params = dict(net_g.named_parameters())
    new = flatten(graft_global_into_full(
        nest(params), nest(dict(g1_params)), verbose))
    for k, p in params.items():
        if new[k] is not p:
            p.copy_(new[k])


def load_and_graft_g1(state, cfg, workdir: str = ".",
                      g1_dir: Optional[str] = None):
    """Restore the phase-1 (``pix2pixhd_global``) generator from the
    newest intact step under ``g1_dir`` (default ``<workdir>/
    <checkpoint_dir>/<dataset>/<name>_g1``; only its ``net_g`` file is
    read) and graft it into ``state.net_g``. Returns the state. Raises
    ``FileNotFoundError`` when there is no such directory, before anything
    is created on disk."""
    from p2p_tpu_torch.models.registry import define_G
    from p2p_tpu_torch.train.checkpoint import CheckpointManager

    g1_cfg = g1_phase_config(cfg)
    g1_dir = g1_dir or os.path.join(workdir, cfg.train.checkpoint_dir,
                                    cfg.data.dataset, g1_cfg.name)
    if not os.path.isdir(g1_dir):
        raise FileNotFoundError(
            f"no phase-1 checkpoint directory at {g1_dir}; run "
            "--phase global first or pass --init_g1_from")
    g1 = define_G(g1_cfg.model, image_hw=g1_cfg.image_hw)
    step = CheckpointManager(g1_dir).restore_nets(g1, None)
    print(f"phase-1 G1 restored from {g1_dir} (step {step})", flush=True)
    graft_into(state.net_g, dict(g1.named_parameters()))
    return state
