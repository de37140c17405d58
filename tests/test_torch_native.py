"""The port's native loader (realsensetracker_tpu_torch/native) and its
ctypes front-ends on the CPU.

The loader compiles native/src/*.cpp with the host compiler into
realsensetracker_tpu_torch/_build/native-<hash>/ under a file lock; it never
touches native/build/, the JAX package's cmake directory. Concurrent first
loads (threads and processes) all succeed against one fresh build
directory. An audit hook checks that the loader's process names no path
under native/build/, so the JAX package's own tests building there at
the same time cannot confuse the check. The clip codec and the PNG16
decoder are held bit for bit to the JAX package's Python clip reader and
to PIL, which the JAX package uses when its own library is absent (these
tests keep it absent: torch_parity.block_jax_native).
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from realsensetracker_tpu.data import recorded as jrecorded
from realsensetracker_tpu.geometry import camera as jcam
from realsensetracker_tpu_torch import native
from realsensetracker_tpu_torch.data import recorded
from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.native import clip_io, png_io
from realsensetracker_tpu_torch.native.voxel_map import NativeVoxelMap
from tests.torch_parity import block_jax_native

REPO = Path(__file__).resolve().parent.parent
JAX_BUILD = REPO / "native" / "build"


@pytest.fixture(scope="module", autouse=True)
def _jax_without_native():
    mp = pytest.MonkeyPatch()
    block_jax_native(mp)
    yield
    mp.undo()


# An audit hook that records every event of its process naming a path
# under native/build/: opens (reads and writes), renames and replaces,
# directory calls (mkdir, listdir, scandir, remove), dlopen, and a
# subprocess's arguments and working directory. It sees this
# process (its threads included) and nothing else, so the JAX package's
# tests building native/build/ in other workers at the same time do not
# show in it. Kept as source so a child process can install it too.
_WATCH_SRC = """
import os, sys

def watch_jax_build(build):
    touched, on = [], [True]

    def strings(x):
        if isinstance(x, (str, bytes, os.PathLike)):
            yield os.fsdecode(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                yield from strings(y)

    def hook(event, args):
        if not on[0] or event in ("compile", "exec", "import"):
            return
        for s in strings(args):
            if "native/build" in s or os.path.abspath(s).startswith(build):
                touched.append((event, s))

    sys.addaudithook(hook)
    return touched, on
"""


def _watch_jax_build():
    """(touched, on): what this process names under native/build/ from
    now until on[0] is set False (an audit hook cannot be removed)."""
    scope = {}
    exec(_WATCH_SRC, scope)
    return scope["watch_jax_build"](str(JAX_BUILD))


def test_loader_builds_into_the_package_build_dir():
    touched, on = _watch_jax_build()
    lib = native.load()
    path = native.library_path()
    assert path.exists() and path.name == "librstpu_native.so"
    assert path.parent.parent == native.BUILD_DIR == REPO / "realsensetracker_tpu_torch" / "_build"
    assert path.parent.name.startswith("native-")
    assert lib.rstpu_abi_version() >= native.MIN_ABI
    assert native.load() is lib  # loaded once
    on[0] = False
    assert touched == []  # nothing under native/build/ opened, listed or written


def test_concurrent_first_loads_in_threads(tmp_path, monkeypatch):
    """Four threads build into one fresh build directory at once: one
    compiles under the lock, the others wait for it; every one gets the
    same complete library, and native/build/ is untouched."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    touched, on = _watch_jax_build()
    paths, errors = [], []

    def first_load():
        try:
            paths.append(native.build())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=first_load) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    on[0] = False
    assert not any(t.is_alive() for t in threads) and not errors
    assert touched == []
    assert len(set(paths)) == 1 and paths[0].parent.parent == tmp_path
    import ctypes

    assert ctypes.CDLL(str(paths[0])).rstpu_abi_version() >= native.MIN_ABI
    assert not [p for p in paths[0].parent.iterdir() if p.suffix == ".so" and p != paths[0]]  # no leftovers


def test_concurrent_first_loads_in_processes(tmp_path):
    """Three processes load at once from one fresh build directory; none
    of them names a path under native/build/."""
    code = _WATCH_SRC + (
        "from pathlib import Path; from realsensetracker_tpu_torch import native\n"
        "touched, on = watch_jax_build(sys.argv[2])\n"
        "native.BUILD_DIR = Path(sys.argv[1]); lib = native.load(); on[0] = False\n"
        "print(native.library_path(), lib.rstpu_abi_version(), len(touched))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), str(JAX_BUILD)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [err for _, err in outs]
    rows = [out.strip().rsplit(" ", 2) for out, _ in outs]
    # Nothing under native/build/ opened, listed or written, in any process.
    assert [int(touched) for _, _, touched in rows] == [0, 0, 0]
    assert len({(path, abi) for path, abi, _ in rows}) == 1
    path, abi, _ = rows[0]
    assert Path(path).parent.parent == tmp_path and int(abi) >= native.MIN_ABI


def test_missing_compiler_raises_oserror(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    with pytest.raises(OSError, match="no C\\+\\+ compiler"):
        native.build()


def test_missing_zlib_header_raises_oserror(tmp_path, monkeypatch):
    """A compiler that cannot find zlib.h: the error names the header."""
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'png16.cpp:8:10: fatal error: zlib.h: No such file or directory' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(OSError, match="zlib.h not found"):
        native.build()


def _clip_arrays(seed, f=3, h=24, w=32):
    rng = np.random.default_rng(seed)
    depths = rng.uniform(0.5, 3.0, (f, h, w)).astype(np.float32)
    depths[:, :2, :3] = 0.0  # invalid pixels
    colors = rng.integers(0, 256, (f, h, w, 3), dtype=np.uint8)
    stamps = np.arange(f, dtype=np.float64) / 30.0 + 1e9
    args = dict(fx=30.5, fy=31.0, cx=15.5, cy=11.25, width=w, height=h)
    return depths, colors, stamps, jcam.Intrinsics(**args), camera.Intrinsics(**args)


def _same_clip(a, b):
    np.testing.assert_array_equal(a.depths, b.depths)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert tuple(a.intrinsics) == tuple(b.intrinsics)
    assert (a.colors is None) == (b.colors is None)
    if a.colors is not None:
        np.testing.assert_array_equal(a.colors, b.colors)


@pytest.mark.parametrize("color", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("dtype", [0, 1], ids=["u16mm", "f32m"])
def test_native_clip_reader_matches_jax_python_reader(tmp_path, color, dtype):
    depths, colors, stamps, jintr, _ = _clip_arrays(1)
    path = str(tmp_path / "j.rsc")
    jrecorded.write_clip(path, depths, stamps, jintr, dtype=dtype, colors=colors if color else None)
    _same_clip(clip_io.read_clip(path), jrecorded.read_clip_py(path))


@pytest.mark.parametrize("color", [None, "u8", "float"])
def test_native_clip_writer_read_by_jax(tmp_path, color):
    depths, colors, stamps, jintr, intr = _clip_arrays(2)
    cols = {None: None, "u8": colors, "float": colors / 255.0}[color]
    nat, py = str(tmp_path / "n.rsc"), str(tmp_path / "j.rsc")
    clip_io.write_clip(nat, depths, stamps, intr, colors=cols)
    jrecorded.write_clip(py, depths, stamps, jintr, colors=cols)
    _same_clip(jrecorded.read_clip_py(nat), jrecorded.read_clip_py(py))
    assert Path(nat).read_bytes() == Path(py).read_bytes()


def test_read_clip_takes_the_native_codec():
    assert recorded.backend() == ("native", "")


def _pil_png(path, arr):
    Image.fromarray(arr).save(path)
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("kind", ["u16-random", "u16-depth", "u8-gray"])
def test_png16_decoder_matches_pil(tmp_path, kind):
    rng = np.random.default_rng(3)
    if kind == "u16-random":
        arr = rng.integers(0, 65536, (37, 53), dtype=np.uint16)
    elif kind == "u16-depth":
        arr = np.round(rng.uniform(0.4, 4.0, (48, 64)) * 5000).astype(np.uint16)
        arr[10:20, 5:30] = 0
    else:
        arr = rng.integers(0, 256, (31, 45), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    ref = _pil_png(p, arr).astype(np.uint16)
    np.testing.assert_array_equal(png_io.read_png16(p), ref)


def test_png16_batch_decoder_matches_pil(tmp_path):
    rng = np.random.default_rng(4)
    paths, refs = [], []
    for i in range(5):
        arr = np.round(rng.uniform(0.4, 4.0, (24, 31)) * 5000).astype(np.uint16)
        p = str(tmp_path / f"b{i}.png")
        refs.append(_pil_png(p, arr).astype(np.uint16))
        paths.append(p)
    np.testing.assert_array_equal(png_io.read_png16_batch(paths, 24, 31), np.stack(refs))
    np.testing.assert_array_equal(png_io.read_png16_batch(paths, 24, 31, scale=5000.0),
                                  np.stack(refs).astype(np.float32) / 5000.0)


def test_voxel_map_first_insert_wins():
    """Truncation keys (int32 casts of world / voxel) and first-insert-wins
    (rs_replay_app.cpp:76-129); padded rows and non-finite rows are dropped."""
    vm = NativeVoxelMap(voxel_size=0.5)
    pts = np.array([[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [0.6, 0.1, 0.1], [-0.1, 0.1, 0.1],
                    [np.nan, 0.0, 0.0], [9.0, 9.0, 9.0]], np.float32)
    mask = np.array([True, True, True, True, True, False])
    vm.add_cloud(np.eye(4, dtype=np.float32), pts, mask)
    # (-0.1 truncates to voxel 0 like 0.1: C casts round toward zero.)
    assert len(vm) == 2
    got = {tuple(p) for p in vm.extract().tolist()}
    assert got == {tuple(np.float32([0.1, 0.1, 0.1]).tolist()), tuple(np.float32([0.6, 0.1, 0.1]).tolist())}
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [1.0, 0.0, 0.0]
    vm.add_cloud(T, pts[:1])
    assert len(vm) == 3 and len(vm.extract(capacity=2)) == 2
