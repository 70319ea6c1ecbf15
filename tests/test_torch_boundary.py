"""The port's boundary: nothing under p2p_tpu_torch/ (nor chip_smoke.py)
imports JAX or the JAX package, and a kernel wrapper given a CPU tensor
computes the plain version without launching (its count stays put)."""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2p_tpu_torch.ops.cuda.instance_norm_kernel import (  # noqa: E402
    instance_norm_stats, instance_norm_stats_plain)
from p2p_tpu_torch.ops.cuda.norm_act import (  # noqa: E402
    norm_act, norm_act_plain)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "p2p_tpu"}


def _port_files():
    files = sorted((ROOT / "p2p_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert bad == []


def _x(shape=(2, 8, 5, 3), seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                            ).to(memory_format=torch.channels_last)


def test_cpu_tensor_takes_the_plain_version_without_a_launch():
    x, r = _x(seed=0), _x(seed=1)
    n_stats, n_norm = instance_norm_stats.launches, norm_act.launches
    mean, rstd = instance_norm_stats(x)
    pmean, prstd = instance_norm_stats_plain(x)
    torch.testing.assert_close(mean, pmean, atol=0, rtol=0)
    torch.testing.assert_close(rstd, prstd, atol=0, rtol=0)
    y = norm_act(x, mean, rstd, residual=r, act="relu")
    torch.testing.assert_close(
        y, norm_act_plain(x, mean, rstd, residual=r, act="relu"),
        atol=0, rtol=0)
    assert (instance_norm_stats.launches, norm_act.launches) == (n_stats,
                                                                n_norm)


def test_wrappers_refuse_a_device_they_have_no_route_for():
    x = torch.empty((1, 8, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        instance_norm_stats(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        norm_act(x, torch.empty((1, 8), device="meta"),
                 torch.empty((1, 8), device="meta"))


SLICE_12 = ("native/__init__.py", "ops/sobel.py", "losses/style.py",
            "losses/fid.py", "models/compression_ae.py")


@pytest.mark.parametrize("module", SLICE_12)
def test_slice_12_modules_are_inside_the_boundary(module):
    path = ROOT / "p2p_tpu_torch" / module
    assert path in _port_files()
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_the_host_image_library_includes_only_the_standard_library_and_zlib():
    src = (ROOT / "p2p_tpu_torch" / "native" / "fastimage.cpp").read_text()
    headers = {line.split()[1] for line in src.splitlines()
               if line.startswith("#include")}
    assert headers == {"<algorithm>", "<cstdint>", "<cstring>", "<new>",
                       "<vector>", "<zlib.h>"}
