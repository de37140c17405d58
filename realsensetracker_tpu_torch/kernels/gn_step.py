"""Fused Gauss-Newton step of projective ICP: association + 6x6 reduction.

``gn_associate_reduce`` and ``gn_reduce_fixed`` launch the CUDA kernels of
``csrc/gn_step.cu`` for CUDA tensors and run their plain torch versions
(``gn_step_reference``, ``gn_reduce_fixed_reference``: the port's
associate_planes_t + normal_equations_fixed_t) for CPU tensors. There is no
fallback: a CUDA tensor either goes through the kernel or raises. The TPU
had no such kernel -- Mosaic could not lower the plane-table gather or the
reduction layout (tools/tpu/mosaic_probe5.py) -- so JAX ran the step as
plain XLA.

A system is packed as (B, 30) f32: the 21 upper-triangle terms of J^T W J
(row-major), the 6 of J^T W r, then wsse, wsum and the matched count;
``unpack_system`` turns it into solve_update's (H, b, aux).

``LAUNCHES`` counts kernel launches per entry (never reference runs).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.kernels import build

SOURCE = "gn_step.cu"
SYSTEM_SIZE = 30
LAUNCHES = {"gn_associate_reduce": 0, "gn_reduce_fixed": 0}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rst_gn_associate_reduce.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32,
            f32, f32, f32, f32, f32, f32, f32,
            ptr, ptr, ptr, ptr, ptr,
        ]
        lib.rst_gn_associate_reduce.restype = i32
        lib.rst_gn_reduce_fixed.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, f32, f32, ptr, ptr]
        lib.rst_gn_reduce_fixed.restype = i32
        lib.rst_gn_error_string.argtypes = [i32]
        lib.rst_gn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_TRIU = torch.triu_indices(6, 6)  # row-major upper triangle, the packed order


@functools.lru_cache(maxsize=None)
def _symmetric_index(device: torch.device) -> torch.Tensor:
    """(36,) index of each H[i, j] into the packed upper triangle."""
    pos = torch.empty((6, 6), dtype=torch.long)
    pos[_TRIU[0], _TRIU[1]] = torch.arange(_TRIU.shape[1])
    pos[_TRIU[1], _TRIU[0]] = torch.arange(_TRIU.shape[1])
    return pos.reshape(36).to(device)


def pack_system(H: torch.Tensor, b: torch.Tensor, aux) -> torch.Tensor:
    """(H (B,6,6), b (B,6), (wsse, wsum, count)) -> (B, 30)."""
    wsse, wsum, count = aux
    upper = H[:, _TRIU[0], _TRIU[1]]
    return torch.cat([upper, b, torch.stack([wsse, wsum, count.to(H.dtype)], dim=1)], dim=1)


def unpack_system(system: torch.Tensor):
    """(B, 30) -> (H (B,6,6) symmetric, b (B,6), aux (wsse, wsum, count int32))."""
    H = system[:, _symmetric_index(system.device)].reshape(-1, 6, 6)
    aux = (system[:, 27], system[:, 28], system[:, 29].to(torch.int32))
    return H, system[:, 21:27], aux


def gn_step_reference(T, src_pts_t, src_ok, packed, intr: camera.Intrinsics, cfg):
    """Plain torch version of gn_associate_reduce: associate_planes_t, then
    normal_equations_fixed_t at the same poses, packed.
    Returns (system (B,30), n_t (B,3,P), d_plane (B,P), ok (B,P))."""
    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.ops.pyramid import PyramidLevel

    level = PyramidLevel(None, None, None, None, packed)  # association reads only the table
    n_t, d_plane, ok = projective.associate_planes_t(T, src_pts_t, src_ok, level, intr, cfg)
    system = gn_reduce_fixed_reference(T, src_pts_t, n_t, d_plane, ok, cfg)
    return system, n_t, d_plane, ok


def gn_reduce_fixed_reference(T, src_pts_t, n_t, d_plane, ok, cfg):
    """Plain torch version of gn_reduce_fixed: normal_equations_fixed_t, packed."""
    from realsensetracker_tpu_torch.align import projective

    return pack_system(*projective.normal_equations_fixed_t(T, src_pts_t, n_t, d_plane, ok, cfg))


def _require(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_points(T, src_pts_t):
    if src_pts_t.dim() != 3 or src_pts_t.shape[1] != 3:
        raise ValueError(f"src_pts_t must be (B, 3, P), got {tuple(src_pts_t.shape)}")
    b, _, p = src_pts_t.shape
    dev = src_pts_t.device
    _require("src_pts_t", src_pts_t, (b, 3, p), torch.float32, dev)
    _require("T", T, (b, 4, 4), torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return b, p, dev


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.rst_gn_error_string(err).decode()} ({err})")


def gn_associate_reduce(T, src_pts_t, src_ok, packed, intr: camera.Intrinsics, cfg):
    """Association at poses T (B,4,4) of lane-major points src_pts_t
    (B,3,P) into the plane tables packed (B,4,H,W), and the GN system at
    the same poses. cfg supplies min_depth, dist_threshold and gnc_mu.

    Returns (system (B,30), n_t (B,3,P), d_plane (B,P), ok (B,P)). CUDA
    tensors launch the kernel on the current stream without
    synchronizing; CPU tensors run gn_step_reference.
    """
    b, p, dev = _check_points(T, src_pts_t)
    h, w = intr.height, intr.width
    _require("src_ok", src_ok, (b, p), torch.bool, dev)
    _require("packed", packed, (b, 4, h, w), torch.float32, dev)
    if dev.type == "cpu":
        return gn_step_reference(T, src_pts_t, src_ok, packed, intr, cfg)
    system = torch.empty((b, SYSTEM_SIZE), dtype=torch.float32, device=dev)
    n_t = torch.empty((b, 3, p), dtype=torch.float32, device=dev)
    d_plane = torch.empty((b, p), dtype=torch.float32, device=dev)
    ok = torch.empty((b, p), dtype=torch.bool, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rst_gn_associate_reduce(
            T.data_ptr(), src_pts_t.data_ptr(), src_ok.data_ptr(), packed.data_ptr(),
            b, p, h, w, intr.fx, intr.fy, intr.cx, intr.cy,
            cfg.min_depth, cfg.dist_threshold, cfg.gnc_mu,
            n_t.data_ptr(), d_plane.data_ptr(), ok.data_ptr(), system.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "gn_associate_reduce")
    LAUNCHES["gn_associate_reduce"] += 1
    return system, n_t, d_plane, ok


def gn_reduce_fixed(T, src_pts_t, n_t, d_plane, ok, cfg):
    """The GN system (B, 30) at poses T against FIXED planes (n_t, d_plane,
    ok from gn_associate_reduce). CUDA tensors launch the kernel; CPU
    tensors run gn_reduce_fixed_reference."""
    b, p, dev = _check_points(T, src_pts_t)
    _require("n_t", n_t, (b, 3, p), torch.float32, dev)
    _require("d_plane", d_plane, (b, p), torch.float32, dev)
    _require("ok", ok, (b, p), torch.bool, dev)
    if dev.type == "cpu":
        return gn_reduce_fixed_reference(T, src_pts_t, n_t, d_plane, ok, cfg)
    system = torch.empty((b, SYSTEM_SIZE), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rst_gn_reduce_fixed(
            T.data_ptr(), src_pts_t.data_ptr(), n_t.data_ptr(), d_plane.data_ptr(), ok.data_ptr(),
            b, p, cfg.dist_threshold, cfg.gnc_mu, system.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "gn_reduce_fixed")
    LAUNCHES["gn_reduce_fixed"] += 1
    return system
