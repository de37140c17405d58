"""Every coarse level of a depth pyramid from one launch.

``downsample_levels`` launches the CUDA kernel of ``csrc/downsample.cu``
(the Hopper port of the TPU's stride-2 probes stride2_slice and
stride2_reshape, tools/tpu/mosaic_probe5.py:99-119) for a CUDA tensor, and
runs ``downsample_levels_reference``, a loop of
``ops.pyramid.downsample_depth``, for a CPU tensor. There is no fallback: a
CUDA tensor either goes through the kernel or raises. The two are
bit-identical: the kernel sums the four children in the plain version's
order and divides exactly.

``LAUNCHES`` counts kernel launches (never reference runs).
"""

from __future__ import annotations

import ctypes

import torch

from realsensetracker_tpu_torch.kernels import build

SOURCE = "downsample.cu"
LAUNCHES = 0
LEVELS_PER_LAUNCH = 5  # the kernel's 32x16 level-1 tile halves five times
_MAX_BATCH = 65535  # gridDim.z limit: one z-slice of blocks per frame

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rst_downsample_levels.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.rst_downsample_levels.restype = i32
        lib.rst_downsample_error_string.argtypes = [i32]
        lib.rst_downsample_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def level_shapes(height: int, width: int, num_levels: int) -> list[tuple[int, int]]:
    """(H_l, W_l) of levels 1..num_levels-1: each floors the one above."""
    shapes = []
    for _ in range(num_levels - 1):
        height, width = height // 2, width // 2
        shapes.append((height, width))
    return shapes


def downsample_levels_reference(depth: torch.Tensor, num_levels: int):
    """Plain torch version: downsample_depth applied num_levels - 1 times,
    validity d > 0. Returns [(depth_l (B,H_l,W_l) f32, valid_l bool)] for
    levels 1..num_levels-1."""
    from realsensetracker_tpu_torch.ops.pyramid import downsample_depth

    out = []
    d, valid = depth, depth > 0
    for _ in range(num_levels - 1):
        d, valid = downsample_depth(d, valid)
        out.append((d, valid))
    return out


def _check(depth: torch.Tensor, num_levels: int, min_depth: float) -> None:
    if depth.dim() != 3:
        raise ValueError(f"depth must be (B, H, W), got shape {tuple(depth.shape)}")
    if depth.dtype != torch.float32:
        raise TypeError(f"depth must be float32, got {depth.dtype}")
    if not depth.is_contiguous():
        raise ValueError("depth must be contiguous")
    if num_levels < 1:
        raise ValueError(f"num_levels must be >= 1, got {num_levels}")
    if min_depth < 0:
        raise ValueError(
            f"min_depth {min_depth} < 0: validity is read as depth > 0, which is exact "
            "only for depth masked with min_depth >= 0"
        )
    if depth.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {depth.device}")


def downsample_levels(depth: torch.Tensor, num_levels: int, min_depth: float = 0.0):
    """Masked depth (B, H, W) f32, 0 = invalid, masked with ``min_depth``
    (>= 0) -> [(depth_l (B,H_l,W_l) f32, valid_l (B,H_l,W_l) bool)] for
    levels 1..num_levels-1.

    CUDA tensors launch the kernel on the current stream without
    synchronizing, one launch per five coarse levels (none for
    num_levels = 1 or an empty level 1); the levels are views of two
    buffers. CPU tensors run downsample_levels_reference.
    """
    _check(depth, num_levels, min_depth)
    if depth.device.type == "cpu":
        return downsample_levels_reference(depth, num_levels)
    b, h, w = depth.shape
    if b > _MAX_BATCH:
        raise ValueError(f"batch {b} exceeds {_MAX_BATCH}")
    shapes = level_shapes(h, w, num_levels)
    sizes = [b * lh * lw for lh, lw in shapes]
    out_d = torch.empty(sum(sizes), dtype=torch.float32, device=depth.device)
    out_v = torch.empty(sum(sizes), dtype=torch.bool, device=depth.device)
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    levels = [(out_d[o : o + n].view(b, *s), out_v[o : o + n].view(b, *s))
              for o, n, s in zip(offsets, sizes, shapes)]
    src, sh, sw = depth, h, w
    for first in range(0, len(shapes), LEVELS_PER_LAUNCH):
        count = min(LEVELS_PER_LAUNCH, len(shapes) - first)
        if sh // 2 == 0 or sw // 2 == 0:
            break  # level `first + 1` and all below it are empty
        _launch(src, out_d, out_v, offsets[first], b, sh, sw, count)
        src = levels[first + count - 1][0]
        sh, sw = shapes[first + count - 1]
    return levels


def _launch(src, out_d, out_v, offset, b, h, w, count) -> None:
    global LAUNCHES
    lib = _library()
    dev = src.device
    with torch.cuda.device(dev):
        err = lib.rst_downsample_levels(
            src.data_ptr(), out_d.data_ptr() + 4 * offset, out_v.data_ptr() + offset,
            b, h, w, count, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"downsample kernel launch failed: {lib.rst_downsample_error_string(err).decode()} ({err})"
        )
    LAUNCHES += 1
