"""Projective point-to-plane Gauss-Newton on the card: two kernel entries.

``gn_round``: one association round of projective ICP in one launch;
its plain torch version ``gn_round_reference`` is the port's
associate_planes_t, then inner_iters x (normal_equations_fixed_t ->
solve_update). ``gn_system``: one association and the 6x6 system at the
poses T, unsolved, for the joint RGB-D step that adds its photometric block
before the solve and for the point-sharded registration that all-reduces
it over its point ranks first (there the association runs at the round's
pose ``T_assoc`` and the reduction at the inner step's T); its plain
version ``gn_system_reference`` is associate_planes_t ->
normal_equations_fixed_t. Both launch the CUDA
kernels of ``csrc/gn_step.cu`` for CUDA tensors and run the plain version
for CPU tensors. There is no fallback: a CUDA tensor either goes through a
kernel or raises. The TPU had no such kernel -- Mosaic could not lower the
plane-table gather or the reduction layout (tools/tpu/mosaic_probe5.py) --
so JAX runs both as plain XLA.

``LAUNCHES`` counts kernel launches per entry (never reference runs).
"""

from __future__ import annotations

import ctypes

import torch

from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.kernels import build

SOURCE = "gn_step.cu"
# gn_round keeps up to this many points per pair in registers (8 CTAs x
# 256 threads x 4 points); above it, it streams each point's plane row
# through a scratch buffer of P float4 per pair.
REGISTER_POINTS = 8192
LAUNCHES = {"gn_round": 0, "gn_system": 0}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rst_gn_round.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32,
            f32, f32, f32, f32, f32, f32, f32, f32, i32,
            ptr, ptr, ptr, ptr, ptr, ptr,
        ]
        lib.rst_gn_round.restype = i32
        lib.rst_gn_system.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
            f32, f32, f32, f32, f32, f32, f32,
            ptr, ptr, ptr, ptr, ptr, ptr,
        ]
        lib.rst_gn_system.restype = i32
        lib.rst_gn_error_string.argtypes = [i32]
        lib.rst_gn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def gn_round_reference(T, src_pts_t, src_ok, packed, intr: camera.Intrinsics, cfg):
    """Plain torch version of gn_round: one plane gather at the poses T,
    then max(cfg.inner_iters, 1) GN updates against those fixed planes.
    Returns (T_new (B,4,4), (rmse (B,), inlier_fraction (B,), matched (B,) int32))."""
    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.ops.pyramid import PyramidLevel

    level = PyramidLevel(None, None, None, None, packed)  # association reads only the table
    n_t, d_plane, ok = projective.associate_planes_t(T, src_pts_t, src_ok, level, intr, cfg)
    num_samples = src_pts_t.shape[-1]
    stats = None
    for _ in range(max(cfg.inner_iters, 1)):
        H, b, aux = projective.normal_equations_fixed_t(T, src_pts_t, n_t, d_plane, ok, cfg)
        T, stats = projective.solve_update(T, H, b, aux, num_samples, cfg)
    return T, stats


def gn_system_reference(T, src_pts_t, src_ok, packed, intr: camera.Intrinsics, cfg, T_assoc=None):
    """Plain torch version of gn_system: the association at the poses
    T_assoc (None: T), then the gated GNC system against those planes at T.
    Returns (H (B,6,6), b (B,6), (wsse (B,), wsum (B,), ok_count (B,) int32))."""
    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.ops.pyramid import PyramidLevel

    level = PyramidLevel(None, None, None, None, packed)  # association reads only the table
    at = T if T_assoc is None else T_assoc
    n_t, d_plane, ok = projective.associate_planes_t(at, src_pts_t, src_ok, level, intr, cfg)
    return projective.normal_equations_fixed_t(T, src_pts_t, n_t, d_plane, ok, cfg)


def _require(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(T, src_pts_t, src_ok, packed, intr):
    if src_pts_t.dim() != 3 or src_pts_t.shape[1] != 3:
        raise ValueError(f"src_pts_t must be (B, 3, P), got {tuple(src_pts_t.shape)}")
    b, _, p = src_pts_t.shape
    dev = src_pts_t.device
    _require("src_pts_t", src_pts_t, (b, 3, p), torch.float32, dev)
    _require("T", T, (b, 4, 4), torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _require("src_ok", src_ok, (b, p), torch.bool, dev)
    _require("packed", packed, (b, 4, intr.height, intr.width), torch.float32, dev)
    return b, p, dev


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_library().rst_gn_error_string(err).decode()} ({err})")


def gn_round(T, src_pts_t, src_ok, packed, intr: camera.Intrinsics, cfg):
    """One association round at poses T (B,4,4) of lane-major points
    src_pts_t (B,3,P) into the plane tables packed (B,4,H,W): associate,
    then max(cfg.inner_iters, 1) damped GN updates against those planes.
    cfg supplies min_depth, dist_threshold, gnc_mu, damping and inner_iters.

    Returns (T_new (B,4,4), (rmse (B,), inlier_fraction (B,), matched (B,)
    int32)), the stats of the last step. CUDA tensors launch the kernel on
    the current stream without synchronizing, with a (B, P, 4) scratch
    buffer above REGISTER_POINTS; CPU tensors run gn_round_reference.
    """
    b, p, dev = _check_inputs(T, src_pts_t, src_ok, packed, intr)
    h, w = intr.height, intr.width
    if dev.type == "cpu":
        return gn_round_reference(T, src_pts_t, src_ok, packed, intr, cfg)
    T_new = torch.empty((b, 4, 4), dtype=torch.float32, device=dev)
    rmse = torch.empty((b,), dtype=torch.float32, device=dev)
    frac = torch.empty((b,), dtype=torch.float32, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return T_new, (rmse, frac, count)
    scratch = torch.empty((b, p, 4), dtype=torch.float32, device=dev) if p > REGISTER_POINTS else None
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rst_gn_round(
            T.data_ptr(), src_pts_t.data_ptr(), src_ok.data_ptr(), packed.data_ptr(),
            b, p, h, w, intr.fx, intr.fy, intr.cx, intr.cy,
            cfg.min_depth, cfg.dist_threshold, cfg.gnc_mu, cfg.damping, max(cfg.inner_iters, 1),
            T_new.data_ptr(), rmse.data_ptr(), frac.data_ptr(), count.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "gn_round")
    LAUNCHES["gn_round"] += 1
    return T_new, (rmse, frac, count)


def gn_system(T, src_pts_t, src_ok, packed, intr: camera.Intrinsics, cfg, T_assoc=None):
    """The 6x6 Gauss-Newton systems at poses T (B,4,4) of lane-major points
    src_pts_t (B,3,P) against the plane tables packed (B,4,H,W): one
    association at T_assoc (B,4,4) (None: at T), then the gated,
    GNC-weighted reduction at T. cfg supplies min_depth, dist_threshold
    and gnc_mu.

    Returns (H (B,6,6), b (B,6), (wsse (B,), wsum (B,), ok_count (B,)
    int32)), as projective.normal_equations_fixed_t. CUDA tensors launch
    the kernel on the current stream without synchronizing, any P; CPU
    tensors run gn_system_reference.
    """
    b, p, dev = _check_inputs(T, src_pts_t, src_ok, packed, intr)
    if T_assoc is not None:
        _require("T_assoc", T_assoc, (b, 4, 4), torch.float32, dev)
    if dev.type == "cpu":
        return gn_system_reference(T, src_pts_t, src_ok, packed, intr, cfg, T_assoc)
    H = torch.empty((b, 6, 6), dtype=torch.float32, device=dev)
    bvec = torch.empty((b, 6), dtype=torch.float32, device=dev)
    wsse = torch.empty((b,), dtype=torch.float32, device=dev)
    wsum = torch.empty((b,), dtype=torch.float32, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return H, bvec, (wsse, wsum, count)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rst_gn_system(
            T.data_ptr(), None if T_assoc is None else T_assoc.data_ptr(),
            src_pts_t.data_ptr(), src_ok.data_ptr(), packed.data_ptr(),
            b, p, intr.height, intr.width, intr.fx, intr.fy, intr.cx, intr.cy,
            cfg.min_depth, cfg.dist_threshold, cfg.gnc_mu,
            H.data_ptr(), bvec.data_ptr(), wsse.data_ptr(), wsum.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "gn_system")
    LAUNCHES["gn_system"] += 1
    return H, bvec, (wsse, wsum, count)
