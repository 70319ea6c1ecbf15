"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`. There is
no PyTorch header in the sources, so a build takes seconds. The libraries go
to ``build/torch_ext/`` at the root of the checkout (listed in
``.gitignore``), or to the directory ``core/cache.enable_compilation_cache``
names (``--compilation_cache``), named by a hash of their sources and
flags, so a changed source is rebuilt and an unchanged one is reused. The
first use of any kernel builds all of them, one ``nvcc`` per source, all
started together. Each build and each reuse of a built library is an
event for the listeners of :func:`add_build_listener` (the build
watchdog, obs/watchdogs.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from p2p_tpu_torch.core.cache import compilation_cache_dir

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
KERNELS = ("instance_norm_stats", "norm_act", "batch_moments",
           "subpixel_head")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# dtype codes of csrc/common.cuh (p2p::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# argtypes of each library's entry points (the C signatures in csrc/)
SIGNATURES = {
    "instance_norm_stats": {
        "p2p_instance_norm_stats": (_P, _I, _I, _L, _I, _I, _I, _I, _I, _I,
                                    _L, _P, _P, _P, _P, _F, _P),
        "p2p_instance_norm_sums": (_P, _I, _I, _L, _I, _I, _I, _I, _I, _I,
                                   _L, _P, _P, _P, _P, _P),
        "p2p_instance_norm_finalize": (_P, _P, _P, _P, _L, _F, _F, _P)},
    "norm_act": {
        "p2p_norm_act": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I,
                         _I, _F, _I, _I, _I, _P),
        "p2p_instance_norm_apply": (_P, _P, _P, _P, _P, _P, _I, _L, _L, _I,
                                    _I, _I, _I, _I, _I, _P),
        "p2p_norm_act_quant": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L,
                               _L, _I, _I, _I, _I, _F, _I, _I, _I, _P)},
    "batch_moments": {
        "p2p_batch_moments": (_P, _I, _L, _I, _I, _I, _I, _I, _I, _L, _P, _P,
                              _P, _P, _P)},
    "subpixel_head": {
        "p2p_subpixel_head_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "p2p_subpixel_head_dx": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "p2p_subpixel_head_fwd_smem": (_I, _I, _I, _I),
        "p2p_subpixel_head_dx_smem": (_I, _I, _I, _I)},
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "$CUDA_HOME/bin); the CUDA kernels cannot be built")
    return nvcc


_listeners: List[Callable[[str, str, float], None]] = []
_LISTEN_LOCK = threading.Lock()


def add_build_listener(fn: Callable[[str, str, float], None]) -> None:
    """Call ``fn(event, library, seconds)`` on every ``"compile"`` (an
    ``nvcc`` build) and ``"cache_hit"`` (a built library reused)."""
    with _LISTEN_LOCK:
        if fn not in _listeners:
            _listeners.append(fn)


def remove_build_listener(fn) -> None:
    with _LISTEN_LOCK:
        if fn in _listeners:
            _listeners.remove(fn)


def _emit(event: str, name: str, seconds: float = 0.0) -> None:
    with _LISTEN_LOCK:
        listeners = list(_listeners)
    for fn in listeners:
        fn(event, name, seconds)


def build_dir() -> Path:
    """Where the libraries are built and reused from: the compilation
    cache directory when one is enabled, else ``build/torch_ext/``."""
    d = compilation_cache_dir()
    return Path(d) if d else BUILD_DIR


def _library_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every kernel library that is missing, all in parallel.
    Returns ``{name: seconds}`` for the libraries built by this call;
    raises ``RuntimeError`` with the compiler's output if one fails."""
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS:
        out = _library_path(name, nvcc)
        if out.exists():
            continue
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {}
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        _emit("compile", name, seconds[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


_LOAD_LOCK = threading.Lock()
_LAUNCH_LOCK = threading.Lock()


def library(name: str) -> ctypes.CDLL:
    """Kernel library ``name`` (built on first use), with the argtypes of
    its entry points set. Locked: serving threads may make the first
    call together."""
    with _LOAD_LOCK:
        return _library(name)


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    path = _library_path(name, find_nvcc())
    if path.exists():
        _emit("cache_hit", name)
    else:
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.p2p_error_string.argtypes = [ctypes.c_int]
    lib.p2p_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str, fn_name: Optional[str] = None):
    """``(library, entry point)`` of kernel library ``name``; ``fn_name``
    picks the entry point where the library has more than one."""
    lib = library(name)
    if fn_name is None:
        (fn_name,) = SIGNATURES[name]
    return lib, getattr(lib, fn_name)


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel (``wrapper.launches``),
    under a lock: serving launches from several threads at once."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def check(lib, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.p2p_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_activation(x: torch.Tensor, what: str) -> None:
    """The layout every kernel takes: a 4-D CUDA tensor in f32 or bf16,
    dense in ``torch.channels_last`` (NHWC in memory). Raises on anything
    else; the wrappers never copy to fix a layout."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dim() != 4:
        raise ValueError(
            f"{what}: expected (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        f"(have {sorted(map(str, DTYPE_CODES))})")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: tensor must be contiguous in "
                         "torch.channels_last (NHWC in memory)")


def vector_width(c: int, *tensors: torch.Tensor) -> int:
    """Elements per 16-byte access along C: the full vector when C divides
    into it and every tensor is 16-byte aligned, else one element."""
    vec = 16 // tensors[0].element_size()
    if c % vec or any(t.data_ptr() % 16 for t in tensors):
        return 1
    return vec
