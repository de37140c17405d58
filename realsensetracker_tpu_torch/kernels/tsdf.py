"""The TSDF volume's two per-frame passes: integrate and the raycast march.

The port's own kernels: the JAX package computes both in plain XLA
(realsensetracker_tpu/mapping/tsdf.py:277 _fuse_block, :446 _march and
:548 _refine_subvoxel), which carried over op for op would cost eager
PyTorch ~15 launches per march step (over a thousand per render) and a
dozen V^3 temporaries per integrate.

* ``fuse_block`` launches csrc/tsdf_integrate.cu: one thread per voxel of
  the whole V^3 grid, consecutive threads along z. It reads three gates
  from device memory -- the caller's ``gate`` (the tracker's
  failure hold and integrate_every cadence), the slab window's ``fits``
  flag and its ``start`` -- and a thread outside the active region exits
  before touching memory, so the slab and the full pass give the same
  volume and no frame waits on the host. The volume updates in place. Its
  arrays may hold an x-slab of the grid, (nx, V, V) from global plane
  ``x0`` (mapping/sharded.py's layout); voxel centres come from the global
  index, so slabs round as the whole volume does.
* ``march`` launches csrc/tsdf_raycast.cu: one thread per ray marches the
  field from its z_start for n_steps, stops at the first crossing (JAX's
  fixed trip count latches ``found`` and never moves the hit after it),
  then runs ``subvoxel_iters`` trilinear refinements; a ray the gate
  closes is not marched. ``raycast`` and both phases of
  ``raycast_coarse_to_fine`` use it.

CPU tensors run the plain versions, ``fuse_block_reference`` (the
mapping/tsdf._fuse_block pass, torch.where-gated) and ``march_reference``
(mapping/tsdf._march and _refine_subvoxel). There is no fallback: a CUDA
tensor either goes through the kernel or raises. Kernel and plain version
compute the same operations in the same order (the fused multiply-adds of
compiled JAX as an f64 product and sum rounded to f32, -fmad=false), so
they agree bit for bit.

``LAUNCHES`` counts kernel launches per entry (never reference runs).
"""

from __future__ import annotations

import ctypes

import torch

from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.kernels import build

INTEGRATE_SOURCE = "tsdf_integrate.cu"
RAYCAST_SOURCE = "tsdf_raycast.cu"
SOURCES = (INTEGRATE_SOURCE, RAYCAST_SOURCE)
LAUNCHES = {"tsdf_integrate": 0, "tsdf_raycast": 0}
MAX_RESOLUTION = 1290  # (ix * V + iy) * V + iz stays inside int32

_libs: dict[str, ctypes.CDLL] = {}


def _library(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        lib = build.load(source)
        ptr, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if source == INTEGRATE_SOURCE:
            lib.rst_tsdf_integrate.argtypes = [
                ptr, ptr, ptr, ptr,  # tsdf, weight, color, color_weight (in place)
                ptr, ptr, ptr,  # depth (H, W), color frame (H, W, 3), pose_cam_from_world (4, 4)
                ptr, ptr, ptr,  # gate, start (3,), fits: device, nullable
                i32, i32, i32, i32, i32, i32,  # V, slab x0 and nx, H, W, window edge S
                f, f, f, f,  # fx, fy, cx, cy
                f, f, f, f,  # origin, voxel size
                f, f, f, f, f,  # trunc, 1/trunc, min_depth, max_depth, max_weight
                ptr,
            ]
            lib.rst_tsdf_integrate.restype = i32
            lib.rst_tsdf_integrate_error_string.argtypes = [i32]
            lib.rst_tsdf_integrate_error_string.restype = ctypes.c_char_p
        else:
            lib.rst_tsdf_raycast.argtypes = [
                ptr, ptr, ptr, f, ptr, ptr,  # field, pose (4, 4), z_start (nullable), z0, gate (nullable), depth out
                i32, i32,  # H, W
                f, f, f, f,  # cx, cy, 1/fx, 1/fy
                i32, f, f, f, f,  # V, origin, 1/voxel size
                f, i32, i32, f,  # step, n_steps, subvoxel_iters, delta
                ptr,
            ]
            lib.rst_tsdf_raycast.restype = i32
            lib.rst_tsdf_raycast_error_string.argtypes = [i32]
            lib.rst_tsdf_raycast_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, dev: torch.device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the volume on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ---- integrate --------------------------------------------------------------


def active_region(v: int, gate, start, fits, size: int, device, x0: int, nx: int):
    """The (nx, V, V) bool mask of the voxels of planes x0 .. x0+nx-1 that
    the gates open (None: all): ``gate`` and, where the window ``fits``,
    the window start..start+size."""
    active = None
    if start is not None:
        idx = torch.arange(v, device=device)
        lines = (idx[x0 : x0 + nx], idx, idx)
        inside = [(lines[a] >= start[a]) & (lines[a] < start[a] + size) for a in range(3)]
        in_slab = inside[0][:, None, None] & inside[1][None, :, None] & inside[2][None, None, :]
        active = in_slab | ~fits
    if gate is not None:
        active = gate if active is None else active & gate
    return active


def fuse_block_reference(vol, depth, color, pose_cam_from_world, intr: camera.Intrinsics, cfg,
                         gate=None, start=None, fits=None, x0: int = 0) -> None:
    """Plain torch version: mapping/tsdf._fuse_block over the volume's
    planes (from global plane ``x0``), then copied into ``vol`` where the
    gates open (torch.where)."""
    from realsensetracker_tpu_torch.mapping.tsdf import _fuse_block

    nx = vol.tsdf.shape[0]
    new = _fuse_block(tuple(vol), depth, color, pose_cam_from_world, intr, cfg, x0=x0)
    active = active_region(cfg.resolution, gate, start, fits, int(cfg.integrate_slab), vol.tsdf.device, x0, nx)
    for arr, upd in zip(vol, new):
        if arr is None:
            continue
        if active is not None:
            upd = torch.where(active[..., None] if arr.dim() == 4 else active, upd, arr)
        arr.copy_(upd)


def fuse_block(vol, depth, color, pose_cam_from_world, intr: camera.Intrinsics, cfg,
               gate=None, start=None, fits=None, x0: int = 0) -> None:
    """Fuse ``depth`` (H, W) f32 (and ``color`` (H, W, 3) f32 on a colored
    volume) into ``vol`` in place, seen from ``pose_cam_from_world`` (4, 4).
    ``vol``'s arrays hold planes x0 .. x0+nx-1 of the V^3 grid ((nx, V, V);
    x0 = 0, nx = V: the whole volume).
    ``gate`` () bool, ``start`` (3,) int32 and ``fits`` () bool are device
    tensors (None: open; start and fits come together, for the slab window
    of edge cfg.integrate_slab). CUDA tensors launch the kernel on the
    current stream without synchronizing; CPU tensors run
    fuse_block_reference."""
    dev = vol.tsdf.device
    v = cfg.resolution
    nx = vol.tsdf.shape[0]
    h, w = depth.shape
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if (start is None) != (fits is None):
        raise ValueError("start and fits come together")
    if not (0 <= x0 and nx >= 1 and x0 + nx <= v):
        raise ValueError(f"slab of {nx} planes from x0={x0} lies outside a grid of {v}")
    if dev.type == "cpu":
        return fuse_block_reference(vol, depth, color, pose_cam_from_world, intr, cfg, gate, start, fits, x0)
    if v > MAX_RESOLUTION:
        raise ValueError(f"resolution {v} > {MAX_RESOLUTION}")
    for name, t in (("tsdf", vol.tsdf), ("weight", vol.weight)):
        _check(name, t, (nx, v, v), torch.float32, dev)
    if vol.color is not None:
        _check("color", vol.color, (nx, v, v, 3), torch.float32, dev)
        _check("color_weight", vol.color_weight, (nx, v, v), torch.float32, dev)
        _check("color frame", color, (h, w, 3), torch.float32, dev)
    _check("depth", depth, (h, w), torch.float32, dev)
    _check("pose", pose_cam_from_world, (4, 4), torch.float32, dev)
    if gate is not None:
        _check("gate", gate, (), torch.bool, dev)
    if start is not None:
        _check("start", start, (3,), torch.int32, dev)
        _check("fits", fits, (), torch.bool, dev)
    from realsensetracker_tpu_torch.mapping.tsdf import f32

    lib = _library(INTEGRATE_SOURCE)
    o = cfg.origin
    with torch.cuda.device(dev):
        err = lib.rst_tsdf_integrate(
            vol.tsdf.data_ptr(), vol.weight.data_ptr(), _ptr(vol.color), _ptr(vol.color_weight),
            depth.data_ptr(), _ptr(color), pose_cam_from_world.data_ptr(),
            _ptr(gate), _ptr(start), _ptr(fits),
            v, int(x0), nx, h, w, int(cfg.integrate_slab),
            f32(intr.fx), f32(intr.fy), f32(intr.cx), f32(intr.cy),
            f32(o[0]), f32(o[1]), f32(o[2]), f32(cfg.voxel_size),
            f32(cfg.trunc), f32(1.0 / cfg.trunc), f32(cfg.min_depth), f32(cfg.max_depth), f32(cfg.max_weight),
            _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"tsdf_integrate launch failed: {lib.rst_tsdf_integrate_error_string(err).decode()} ({err})")
    LAUNCHES["tsdf_integrate"] += 1


# ---- raycast ----------------------------------------------------------------


def march_reference(field, pose_world_from_cam, intr: camera.Intrinsics, cfg, n_steps: int, z_start=None,
                    gate=None, subvoxel_iters: int = 0) -> torch.Tensor:
    """Plain torch version: mapping/tsdf._march from ``z_start`` (None:
    cfg.min_depth), then _refine_subvoxel on the hits that ``gate`` keeps;
    (H, W) depth, 0 where no kept hit."""
    from realsensetracker_tpu_torch.mapping.tsdf import _march, _ray_dirs, _refine_subvoxel, f32

    t = pose_world_from_cam[:3, 3]
    dirs = _ray_dirs(pose_world_from_cam, intr)
    z0 = f32(cfg.min_depth) if z_start is None else z_start
    z_hit, found = _march(field, t, dirs, z0, n_steps, cfg)
    if gate is not None:
        found = found & gate
    z_hit = _refine_subvoxel(field, t, dirs, z_hit, found, cfg, subvoxel_iters)
    return torch.where(found, z_hit, 0.0)


def march(field, pose_world_from_cam, intr: camera.Intrinsics, cfg, n_steps: int, z_start=None, gate=None,
          subvoxel_iters: int = 0) -> torch.Tensor:
    """March every ray of ``intr`` through the flat (V^3,) ``field`` seen
    from ``pose_world_from_cam`` (4, 4) f32: from per-ray ``z_start``
    ((H, W) f32, None: cfg.min_depth) for ``n_steps`` steps, then
    ``subvoxel_iters`` trilinear refinements of the hits ``gate`` ((H, W)
    bool, None: all) keeps. Returns (H, W) depth, 0 where no kept hit. CUDA
    tensors launch the kernel on the current stream without synchronizing;
    CPU tensors run march_reference."""
    dev = field.device
    h, w = int(intr.height), int(intr.width)
    v = cfg.resolution
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return march_reference(field, pose_world_from_cam, intr, cfg, n_steps, z_start, gate, subvoxel_iters)
    if v > MAX_RESOLUTION:
        raise ValueError(f"resolution {v} > {MAX_RESOLUTION}")
    _check("field", field, (v * v * v,), torch.float32, dev)
    _check("pose", pose_world_from_cam, (4, 4), torch.float32, dev)
    if z_start is not None:
        _check("z_start", z_start, (h, w), torch.float32, dev)
    if gate is not None:
        _check("gate", gate, (h, w), torch.bool, dev)
    from realsensetracker_tpu_torch.mapping.tsdf import f32

    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    lib = _library(RAYCAST_SOURCE)
    o = cfg.origin
    with torch.cuda.device(dev):
        err = lib.rst_tsdf_raycast(
            field.data_ptr(), pose_world_from_cam.data_ptr(), _ptr(z_start), f32(cfg.min_depth), _ptr(gate),
            out.data_ptr(), h, w,
            f32(intr.cx), f32(intr.cy), camera.reciprocal(intr.fx), camera.reciprocal(intr.fy),
            v, f32(o[0]), f32(o[1]), f32(o[2]), f32(1.0 / cfg.voxel_size),
            f32(cfg.step_frac * cfg.trunc), int(n_steps), int(subvoxel_iters), f32(0.6 * cfg.voxel_size),
            _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"tsdf_raycast launch failed: {lib.rst_tsdf_raycast_error_string(err).decode()} ({err})")
    LAUNCHES["tsdf_raycast"] += 1
    return out
