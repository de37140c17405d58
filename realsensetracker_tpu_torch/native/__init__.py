"""The port's own build and ctypes loader of the native host library.

Port of realsensetracker_tpu/native/__init__.py. The same C++ sources,
``native/src/{clip_codec,png16,voxel_map}.cpp`` at the repository root
(the clip codec, the thread-pooled 16-bit PNG decoder and the voxel-hash
world model), are compiled by the host compiler directly, without cmake,
into ``realsensetracker_tpu_torch/_build/native-<hash>/librstpu_native.so``,
keyed by a hash of the sources and the flags, so an unchanged tree never
rebuilds. It needs ``c++`` (or ``$CXX``) and zlib's header and library.

Concurrent first loads, from threads or processes, are safe: the build
runs under an ``fcntl.flock`` on a lock file beside the library, writes a
temporary file and renames it into place, so no loader sees a half-written
library. This loader never reads or writes ``native/build/``, where the
JAX package builds its copy.

Nothing happens at import time: the library builds at the first ``load()``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR.parent / "native" / "src"
SOURCES = ("clip_codec.cpp", "png16.cpp", "voxel_map.cpp")
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "librstpu_native.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LINK_FLAGS = ("-lz", "-pthread")
MIN_ABI = 5

_LIB = None
_LOCK = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "c++"
    path = shutil.which(cxx)
    if path is None:
        raise OSError(f"no C++ compiler: {cxx!r} is not on PATH (needed to build {LIB_NAME})")
    return path


def library_path() -> Path:
    """Where the sources build to: keyed by their content and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (SOURCE_DIR / name).read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the library unless its keyed copy exists; return its path.

    Raises OSError naming what is missing (the compiler, or zlib.h) or with
    the compiler's output when the build fails otherwise.
    """
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while this one waited
            return lib
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, *(str(SOURCE_DIR / s) for s in SOURCES), *LINK_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            out = proc.stdout + proc.stderr
            if "zlib.h" in out:
                raise OSError(f"zlib.h not found: install zlib's development headers to build {LIB_NAME}")
            raise OSError(f"building {LIB_NAME} failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        os.replace(tmp, lib)
    return lib


def _declare(lib) -> None:
    """The exported functions' signatures (native/src/*.cpp)."""
    c_int, c_i32, c_i64, c_f32 = ctypes.c_int, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    ptr, path = ctypes.c_void_p, ctypes.c_char_p
    sigs = {
        "rstpu_abi_version": (c_int, []),
        "rsc_read_header": (c_int, [path, ptr, ptr]),
        "rsc_read_frames": (c_int, [path, ptr, ptr, c_int]),
        "rsc_read_colors": (c_int, [path, ptr]),
        "rsc_write_clip": (c_int, [path, ptr, ptr, c_i32, c_i32, c_i32, ptr, ptr]),
        "png16_read_header": (c_int, [path, ptr]),
        "png16_decode": (c_int, [path, ptr]),
        "png16_decode_batch": (c_int, [path, c_i32, c_i32, c_i32, ptr, ptr, c_f32]),
        "voxel_map_create": (ptr, [c_f32]),
        "voxel_map_destroy": (None, [ptr]),
        "voxel_map_add": (None, [ptr, ptr, ptr, c_i64]),
        "voxel_map_size": (c_i64, [ptr]),
        "voxel_map_extract": (c_i64, [ptr, ptr, c_i64]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def load():
    """Load the native library, building it first if needed; raises OSError
    when it cannot be built or reports an ABI older than MIN_ABI."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            if not hasattr(lib, "rstpu_abi_version") or lib.rstpu_abi_version() < MIN_ABI:
                raise OSError(f"{LIB_NAME}: ABI older than {MIN_ABI}")
            _declare(lib)
            _LIB = lib
        return _LIB
