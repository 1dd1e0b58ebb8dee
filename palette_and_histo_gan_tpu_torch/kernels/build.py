"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled from `csrc/` at its first use in a process, into
`build/torch_kernels/` at the repository root, for Hopper (`sm_90a`), with
the common flags plus its own. The library's file name carries a hash of
its sources and all its flags, so an edited source or flag is rebuilt and
an unchanged one is loaded as it is. The sources have a plain C interface
and include no PyTorch header, which keeps a build at a few seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
)
# for a library whose float arithmetic must round op for op like its plain
# PyTorch version: no multiply-add contraction anywhere
NO_FMA = ("-fmad=false",)

# seconds spent in nvcc by this process, and ptxas' report (-v), per
# library name
build_seconds: dict[str, float] = {}
build_reports: dict[str, str] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or the PATH; raises if absent."""
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "the PATH); the CUDA kernels of palette_and_histo_gan_tpu_torch need "
        "the CUDA toolkit"
    )


def load_library(name: str, sources: tuple[str, ...],
                 flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) with NVCC_FLAGS plus
    `flags` into lib<name>-<hash>.so, unless that file exists, and load it."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    nvcc_flags = (*NVCC_FLAGS, *flags)
    digest = hashlib.sha256(" ".join(nvcc_flags).encode())
    for path in paths:
        with open(path, "rb") as f:
            digest.update(f.read())
    target = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # compile to a private file and rename, so concurrent builds never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *nvcc_flags, "-o", tmp, *paths]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        build_reports[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed building {name} ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, target)
    return ctypes.CDLL(target)
