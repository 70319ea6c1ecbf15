"""Weights across frameworks: flax generator params → a torch state_dict,
and ``.npz`` files of flax parameter trees.

A flax tree is a nested dict of arrays; every conv of the port's
generators sits at the same path as its flax counterpart, with the inner
``Conv_0`` renamed ``conv`` and the kernel moved from HWIO to OIHW:

    global/ResnetBlock_0/ConvLayer_1/Conv_0/kernel (3,3,I,O)
      → global.ResnetBlock_0.ConvLayer_1.conv.weight (O,I,3,3)

An ``.npz`` file holds one array per leaf under its ``/``-joined path.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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


def save_npz(path: str, params: Mapping[str, Any]) -> None:
    """Write a flax parameter tree as an ``.npz`` of ``/``-joined keys."""
    with open(path, "wb") as f:
        np.savez(f, **flatten_tree(params))


def load_npz(path: str) -> Dict[str, Any]:
    """Read an ``.npz`` written by :func:`save_npz` back into a tree."""
    with np.load(path, allow_pickle=False) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def generator_state_from_flax(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """A flax generator tree (the ``params`` collection) → the state_dict
    of the port's generator of the same config. Raises on a leaf that is
    not a conv kernel or bias."""
    state = {}
    for key, arr in flatten_tree(params).items():
        *path, module, leaf = key.split("/")
        if module != "Conv_0" or leaf not in ("kernel", "bias"):
            raise ValueError(f"no torch counterpart for flax leaf {key!r}")
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{key}: expected an HWIO kernel, got "
                                 f"shape {arr.shape}")
            name, value = "weight", arr.transpose(3, 2, 0, 1)
        else:
            name, value = "bias", arr
        state[".".join(path + ["conv", name])] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C"))
    return state


def load_generator(generator: torch.nn.Module, npz_path: str
                   ) -> torch.nn.Module:
    """Load a flax generator tree from ``npz_path`` into ``generator``
    (every parameter must be present, and nothing else)."""
    generator.load_state_dict(
        generator_state_from_flax(load_npz(npz_path)), strict=True)
    return generator
