"""Fused pyramid-level builder: depth -> planar plane table [n | d = n . q].

``build_level_packed`` launches the CUDA kernel of
``csrc/level_kernel.cu`` (the Hopper port of the Pallas kernel
realsensetracker_tpu/kernels/level_kernel.py:build_level_packed) for a
CUDA tensor, and runs ``build_level_packed_reference``, the plain torch
composition, for a CPU tensor. There is no fallback: a CUDA tensor either
goes through the kernel or raises.

``LAUNCHES`` counts kernel launches (never reference runs), so a caller can
show that a run went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.kernels import build
from realsensetracker_tpu_torch.ops import normals as normals_mod

SOURCE = "level_kernel.cu"
LAUNCHES = 0
_MAX_BATCH = 65535  # gridDim.z limit: one z-slice of blocks per frame

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.rst_level_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.rst_level_packed.restype = ctypes.c_int
        lib.rst_error_string.argtypes = [ctypes.c_int]
        lib.rst_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_level_packed_reference(depth: torch.Tensor, intr: camera.Intrinsics) -> torch.Tensor:
    """Plain torch version: masked depth (B, H, W), 0 = invalid ->
    plane table (B, 4, H, W), by unprojection + ops.normals.grid_normals."""
    vmap = camera.unproject_depth(depth, intr)
    n, _ = normals_mod.grid_normals(vmap, depth > 0)
    d_plane = (vmap * n).sum(-1)  # n . q; 0 where invalid (n = 0)
    return torch.cat([n.permute(0, 3, 1, 2), d_plane[:, None]], dim=1)


def build_level_packed(depth: torch.Tensor, intr: camera.Intrinsics) -> torch.Tensor:
    """Masked depth (B, H, W) f32, 0 = invalid -> plane table (B, 4, H, W).

    CUDA tensors launch the kernel on the current stream without
    synchronizing; CPU tensors run the plain reference.
    """
    if depth.dim() != 3:
        raise ValueError(f"depth must be (B, H, W), got shape {tuple(depth.shape)}")
    if depth.dtype != torch.float32:
        raise TypeError(f"depth must be float32, got {depth.dtype}")
    if not depth.is_contiguous():
        raise ValueError("depth must be contiguous")
    b, h, w = depth.shape
    if (h, w) != (intr.height, intr.width):
        raise ValueError(f"depth is {h}x{w} but intrinsics are {intr.height}x{intr.width}")
    if depth.device.type == "cpu":
        return build_level_packed_reference(depth, intr)
    if depth.device.type != "cuda":
        raise ValueError(f"unsupported device {depth.device}")
    if b > _MAX_BATCH:
        raise ValueError(f"batch {b} exceeds {_MAX_BATCH}")
    out = torch.empty((b, 4, h, w), dtype=torch.float32, device=depth.device)
    lib = _library()
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    with torch.cuda.device(depth.device):
        err = lib.rst_level_packed(
            depth.data_ptr(), out.data_ptr(), b, h, w,
            intr.fx, intr.fy, intr.cx, intr.cy, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"level kernel launch failed: {lib.rst_error_string(err).decode()} ({err})"
        )
    global LAUNCHES
    LAUNCHES += 1
    return out
