"""Build a CUDA source of ``csrc/`` into a shared library and load it.

The route is nvcc by hand into a library with a plain C interface, bound
with ctypes: it builds in seconds, where an extension that includes
PyTorch's headers takes minutes. The library lands in
``realsensetracker_tpu_torch/_build/<stem>-<hash>/``, keyed by a hash of
the source and the flags, so an unchanged tree never rebuilds. Nothing
happens at import time: kernels build at their first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false",  # round like the plain torch versions (see level_kernel.cu)
    "-Xptxas", "-v",  # registers / spills per kernel, kept in build.log
)


def _nvcc() -> str:
    # CUDA_HOME as torch resolves it: $CUDA_HOME / $CUDA_PATH, then the
    # nvcc on PATH, then /usr/local/cuda.
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: keyed by its content and flags."""
    src = CSRC_DIR / source
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = src.stem
    return BUILD_DIR / f"{stem}-{key}" / f"lib{stem}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its keyed library exists; return it.

    Raises RuntimeError with nvcc's output when the build fails. The
    library is written under a temporary name and renamed into place, so
    concurrent builders never load a half-written file.
    """
    lib = library_path(source)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    (lib.parent / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
