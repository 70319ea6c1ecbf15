"""Helpers shared by the port's command-line entry points."""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Dict, Sequence, Tuple

# an unported flag: (name, JAX default, argparse keyword arguments)
Unported = Tuple[str, Any, Dict[str, Any]]


def apply_overrides(obj, **kw):
    """``dataclasses.replace`` with the unset (None) flags dropped."""
    kw = {k: v for k, v in kw.items() if v is not None}
    return dataclasses.replace(obj, **kw) if kw else obj


def add_unported(parser: argparse.ArgumentParser,
                 flags: Sequence[Unported]) -> None:
    """Register flags of the JAX CLI that the port does not have, so that
    :func:`refuse_unported` can name them."""
    group = parser.add_argument_group(
        "flags of the JAX package the port does not have yet (refused "
        "unless left at their default)")
    for name, _, kw in flags:
        group.add_argument(f"--{name}", default=None,
                           help="not ported", **kw)


def refuse_unported(args: argparse.Namespace,
                    flags: Sequence[Unported]) -> int:
    """0 when every unported flag is unset or at the JAX default; else
    name them on stderr and return the exit code 2."""
    bad = [f"--{name}" for name, default, _ in flags
           if getattr(args, name) is not None
           and getattr(args, name) != default]
    if not bad:
        return 0
    print(f"not ported yet: {', '.join(bad)} (the PyTorch port does not "
          "have these features; leave them unset)", file=sys.stderr)
    return 2
