#!/usr/bin/env python3
"""Registers, stack and spills of each kernel instance of one of the port's
CUDA sources, as ``nvcc -Xptxas -v`` reports them with the build's flags.

    python3 scripts/torch_kernel_registers.py <checkout> <name>

Compiles ``<checkout>/p2p_tpu_torch/ops/cuda/csrc/<name>.cu`` to a
throwaway file and prints ptxas's lines for each kernel (names demangled
where ``c++filt`` is found). Needs ``nvcc`` (the machine with the card).
"""

import os
import shutil
import subprocess
import sys
import tempfile

tree, name = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path.insert(0, tree)
from p2p_tpu_torch.ops.cuda import build  # noqa: E402

with tempfile.TemporaryDirectory() as tmp:
    log = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(tmp, "lib.so"),
         os.path.join(tree, "p2p_tpu_torch/ops/cuda/csrc", f"{name}.cu")],
        capture_output=True, text=True, check=True)
lines = "\n".join(line for line in (log.stdout + log.stderr).splitlines()
                  if "Function properties" in line or "spill" in line
                  or "Used" in line)
filt = shutil.which("cu++filt") or shutil.which("c++filt")
if filt:
    lines = subprocess.run([filt], input=lines, text=True,
                           capture_output=True, check=True).stdout
print(lines)
