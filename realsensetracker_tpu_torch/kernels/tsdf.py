"""The TSDF volume's two per-frame passes: integrate and the raycast march.

The port's own kernels: the JAX package computes both in plain XLA
(realsensetracker_tpu/mapping/tsdf.py:277 _fuse_block, :446 _march and
:548 _refine_subvoxel), which carried over op for op would cost eager
PyTorch ~15 launches per march step (over a thousand per render) and a
dozen V^3 temporaries per integrate.

* ``fuse_blocks`` fuses S slots' frames into (S, nx, V, V) planes with
  one call of csrc/tsdf_integrate.cu's rst_tsdf_fuse, three launches
  whatever S: a map of each frame's largest valid depth per TILE x TILE
  pixels; a cull that tests every brick of BRICK voxels against its slot's
  frustum and tile map (the update needs a voxel in front of the observed
  surface plus trunc) and lists the kept ones on the device; and the
  update of the listed bricks, with the plain version's per-voxel
  arithmetic, unchanged. ``fuse_block`` is the one-slot case;
  ``depth_tiles`` and ``cull_bricks`` launch the first two kernels alone.
  The kernels read three gates from device memory -- the caller's
  ``gate`` (the tracker's failure hold and integrate_every cadence), the
  slab window's ``fits`` flag and its ``start`` -- so the slab and the
  full pass give the same volume and no frame waits on the host. The
  volume updates in place. Its arrays may hold an x-slab of the grid, (nx,
  V, V) from global plane ``x0`` (mapping/sharded.py's layout); voxel
  centres come from the global index, so slabs round as the whole volume
  does.
* ``march`` launches csrc/tsdf_raycast.cu: one thread per ray marches the
  field from its z_start for n_steps, stops at the first crossing (JAX's
  fixed trip count latches ``found`` and never moves the hit after it),
  then runs ``subvoxel_iters`` trilinear refinements; a ray the gate
  closes is not marched. The field is either the flat march field or the
  volume itself: given a volume, the kernel computes each sample's field
  value from its tsdf and weight planes where it reads it, so no V^3 field
  is built per render, and the depth is the same to the bit. ``raycast``
  and both phases of ``raycast_coarse_to_fine`` use it.

CPU tensors run the plain versions, ``fuse_block_reference`` (the
mapping/tsdf._fuse_block pass, torch.where-gated; per slot for
``fuse_blocks_reference``) and ``march_reference`` (mapping/tsdf._march
and _refine_subvoxel). There is no fallback: a CUDA tensor either goes
through the kernel or raises. Kernel and plain version compute the same
operations in the same order (the fused multiply-adds of compiled JAX as
an f64 product and sum rounded to f32, -fmad=false), so they agree bit for
bit. The cull has a plain twin too, ``brick_mask_reference`` over
``depth_tiles_reference``, in the kernel's f64 operations: the tests hold
it sound against _fuse_block's update predicate on the CPU and equal to
cull_bricks' list on the card.

``LAUNCHES`` counts kernel launches per entry (never reference runs):
``tsdf_raycast`` every march, ``tsdf_raycast_planes`` the marches of them
that read a volume's planes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.kernels import build

INTEGRATE_SOURCE = "tsdf_integrate.cu"
RAYCAST_SOURCE = "tsdf_raycast.cu"
SOURCES = (INTEGRATE_SOURCE, RAYCAST_SOURCE)
LAUNCHES = {"tsdf_depth_tiles": 0, "tsdf_cull": 0, "tsdf_integrate": 0, "tsdf_raycast": 0, "tsdf_raycast_planes": 0}
MAX_RESOLUTION = 1290  # (ix * V + iy) * V + iz stays inside int32 within a slot
MAX_SLOTS = 65535  # the slot is the launch grid's y
BRICK = (8, 8, 32)  # voxels per brick along x, y, z (csrc/tsdf_integrate.cu kBx, kBy, kBz)
TILE = 16  # depth-tile edge in pixels (kTile)
EPS_SCALE = 2.0**-16  # the cull's margin per unit of the largest coordinate (kEpsScale)

_libs: dict[str, ctypes.CDLL] = {}


def _library(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        lib = build.load(source)
        ptr, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if source == INTEGRATE_SOURCE:
            lib.rst_tsdf_fuse.argtypes = [
                ptr, ptr, ptr, ptr,  # tsdf, weight, color, color_weight (in place)
                ptr, ptr, ptr,  # depth (S, H, W), color frame (S, H, W, 3), pose_cam_from_world (S, 4, 4)
                ptr, ptr, ptr,  # gate (S,), start (S, 3), fits (S,): nullable
                ptr, ptr, ptr,  # the workspace, the _Config (host), the stream
            ]
            lib.rst_tsdf_work_bytes.argtypes = [ptr]
            lib.rst_tsdf_work_bytes.restype = ctypes.c_longlong
            lib.rst_tsdf_depth_tiles.argtypes = [ptr, ptr, ptr, i32, i32, i32, f, f, ptr]  # depth, tiles, count
            lib.rst_tsdf_cull.argtypes = [
                ptr, ptr,  # pose_cam_from_world (S, 4, 4), tiles
                ptr, ptr, ptr,  # gate (S,), start (S, 3), fits (S,): nullable
                ptr, ptr, ptr, ptr,  # brick list out, its count, the _Config (host), the stream
            ]
            for fn in (lib.rst_tsdf_fuse, lib.rst_tsdf_depth_tiles, lib.rst_tsdf_cull):
                fn.restype = i32
            lib.rst_tsdf_integrate_error_string.argtypes = [i32]
            lib.rst_tsdf_integrate_error_string.restype = ctypes.c_char_p
        else:
            march_args = [
                ptr, ptr, f, ptr, ptr,  # pose (4, 4), z_start (nullable), z0, gate (nullable), depth out
                i32, i32,  # H, W
                f, f, f, f,  # cx, cy, 1/fx, 1/fy
                i32, f, f, f, f,  # V, origin, 1/voxel size
                f, i32, i32, f,  # step, n_steps, subvoxel_iters, delta
                ptr,
            ]
            lib.rst_tsdf_raycast.argtypes = [ptr, *march_args]  # the flat field
            lib.rst_tsdf_raycast_planes.argtypes = [ptr, ptr, *march_args]  # the tsdf and weight planes
            for fn in (lib.rst_tsdf_raycast, lib.rst_tsdf_raycast_planes):
                fn.restype = i32
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


def fuse_blocks_reference(vols, depths, colors, poses_cam_from_world, intr: camera.Intrinsics, cfg,
                          gates=None, starts=None, fits=None, x0: int = 0) -> None:
    """Plain version of the slot entry: fuse_block_reference on each slot
    in turn (``vols``' arrays (S, nx, V, V), one frame, pose and gates per
    slot)."""
    for i in range(depths.shape[0]):
        fuse_block_reference(
            type(vols)(*(None if a is None else a[i] for a in vols)), depths[i],
            None if colors is None else colors[i], poses_cam_from_world[i], intr, cfg,
            None if gates is None else gates[i], None if starts is None else starts[i],
            None if fits is None else fits[i], x0)


def brick_grid(v: int, nx: int) -> tuple[int, int, int]:
    """Bricks along x (of the nx planes), y and z of a V^3 grid."""
    bx, by, bz = BRICK
    return -(-nx // bx), -(-v // by), -(-v // bz)


def bricks_holding(mask: torch.Tensor) -> torch.Tensor:
    """(nbx, nby, nbz) bool: the bricks of an (nx, V, V) voxel mask that
    hold a True (the bricks an update touched, to hold against a cull)."""
    nb = brick_grid(mask.shape[1], mask.shape[0])
    m = torch.nn.functional.pad(mask.float(), (0, nb[2] * BRICK[2] - mask.shape[2], 0, nb[1] * BRICK[1] - mask.shape[1],
                                               0, nb[0] * BRICK[0] - mask.shape[0]))
    return m.reshape(nb[0], BRICK[0], nb[1], BRICK[1], nb[2], BRICK[2]).amax((1, 3, 5)) > 0


def depth_tiles_reference(depths: torch.Tensor, cfg) -> torch.Tensor:
    """Plain version of the depth-tile map: per TILE x TILE pixels of each
    (S, H, W) frame the largest valid depth (finite, min_depth < d <
    max_depth, as the integrate reads it), -inf where none; (S, ceil(H/TILE),
    ceil(W/TILE)) f32."""
    from realsensetracker_tpu_torch.mapping.tsdf import f32

    s, h, w = depths.shape
    nty, ntx = -(-h // TILE), -(-w // TILE)
    ok = torch.isfinite(depths) & (depths > f32(cfg.min_depth)) & (depths < f32(cfg.max_depth))
    d = torch.where(ok, depths, float("-inf"))
    d = torch.nn.functional.pad(d, (0, ntx * TILE - w, 0, nty * TILE - h), value=float("-inf"))
    return d.reshape(s, nty, TILE, ntx, TILE).amax(dim=(2, 4))


class _Cull(NamedTuple):
    """The cull's per-launch constants, f64 (the kernel takes the same)."""

    kl: float  # left side: fx X + kl Z >= 0 where a voxel can update (u >= -1.5)
    kr: float  # right side: kr Z - fx X >= 0 (u < W + 0.5)
    kt: float  # top: fy Y + kt Z >= 0
    kb: float  # bottom: kb Z - fy Y >= 0
    far: float  # max_depth + trunc
    zpos: float  # a brick wholly beyond it projects: max(min_depth, 1e-6)
    base: float  # |ox| + |oy| + |oz| + 3 V vs: with |t|, the largest coordinate's scale
    sides: bool  # the side planes hold (min_depth >= 1e-6: every voxel that can update has z > 0)


def _cull_constants(intr: camera.Intrinsics, cfg, h: int, w: int) -> _Cull:
    from realsensetracker_tpu_torch.mapping.tsdf import f32

    cx, cy, md, vs = f32(intr.cx), f32(intr.cy), f32(cfg.min_depth), f32(cfg.voxel_size)
    o = [f32(a) for a in cfg.origin]
    return _Cull(cx + 1.5, w + 0.5 - cx, cy + 1.5, h + 0.5 - cy, f32(cfg.max_depth) + f32(cfg.trunc),
                 max(md, 1e-6), abs(o[0]) + abs(o[1]) + abs(o[2]) + 3.0 * cfg.resolution * vs, md >= 1e-6)


def brick_mask_reference(poses_cam_from_world, intr: camera.Intrinsics, cfg, tiles, h: int, w: int,
                         x0: int = 0, nx: int | None = None, gates=None, starts=None, fits=None) -> torch.Tensor:
    """Plain twin of the kernel's cull: (S, nbx, nby, nbz) bool, True where
    the brick is visited. Decides as csrc/tsdf_integrate.cu's
    brick_visible does, in the same f64 operations, so the two agree bit
    for bit: a brick is culled where the slot's gate is closed, where the
    slab window fits and misses it, where the pose is not finite, where
    all 8 corners of its box (the voxel cells' outer faces, widened by eps)
    fail one frustum half-space (near, far, the four sides with a pixel of
    slack), where the box lies beyond zpos and its pixel rectangle
    (projected corners widened by a pixel, clamped to the frame) is empty,
    or where every depth tile of that rectangle (of the whole frame when
    the box reaches zpos) holds less than (z_min - trunc) - eps. ``tiles``: depth_tiles_reference of the frames
    (S, H/TILE, W/TILE)."""
    from realsensetracker_tpu_torch.mapping.tsdf import f32

    s, v = poses_cam_from_world.shape[0], cfg.resolution
    nx = v if nx is None else nx
    dev, f64 = poses_cam_from_world.device, torch.float64
    c = _cull_constants(intr, cfg, h, w)
    fx, fy, cx, cy = (f32(a) for a in (intr.fx, intr.fy, intr.cx, intr.cy))
    vs, md, trunc = f32(cfg.voxel_size), f32(cfg.min_depth), f32(cfg.trunc)
    nb = brick_grid(v, nx)
    P = poses_cam_from_world.to(f64)
    finite = torch.isfinite(poses_cam_from_world[:, :3, :]).all(-1).all(-1)
    P = torch.where(finite[:, None, None], P, 0.0)
    eps = (((c.base + P[:, 0, 3].abs()) + P[:, 1, 3].abs()) + P[:, 2, 3].abs()) * EPS_SCALE  # (S,)
    los, his, box = [], [], []
    for a in range(3):
        lo = (x0 if a == 0 else 0) + BRICK[a] * torch.arange(nb[a], device=dev)
        hi = torch.clamp(lo + BRICK[a] - 1, max=(x0 + nx if a == 0 else v) - 1)
        o = f32(cfg.origin[a])
        face_lo = (o + lo.to(f64) * vs)[None] - eps[:, None]
        face_hi = (o + (hi + 1).to(f64) * vs)[None] + eps[:, None]
        corner = torch.stack([face_lo, face_hi], -1)[..., [(k >> a) & 1 for k in range(8)]]  # (S, nb_a, 8)
        shape = [s, 1, 1, 1, 8]
        shape[1 + a] = nb[a]
        los.append(lo), his.append(hi), box.append(corner.reshape(shape))
    X, Y, Z = (((P[:, a, 0, None, None, None, None] * box[0] + P[:, a, 1, None, None, None, None] * box[1])
                + P[:, a, 2, None, None, None, None] * box[2]) + P[:, a, 3, None, None, None, None]
               for a in range(3))
    cull = (Z <= md).all(-1) | (Z > c.far).all(-1)
    if c.sides:
        for side in (fx * X + c.kl * Z, c.kr * Z - fx * X, fy * Y + c.kt * Z, c.kb * Z - fy * Y):
            cull = cull | (side < 0.0).all(-1)
    front = (Z > c.zpos).all(-1)
    zs = torch.where(front[..., None], Z, 1.0)
    u, vv = (fx * X) / zs + cx, (fy * Y) / zs + cy
    rect = []
    for q, edge in ((u, w), (vv, h)):
        q_lo = torch.floor((q - 1.0).clamp(-1.0, float(edge))).amin(-1).clamp(min=0.0).long()
        q_hi = torch.ceil((q + 1.0).clamp(-1.0, float(edge))).amax(-1).clamp(max=float(edge - 1)).long()
        rect.append((q_lo, q_hi))
    (ulo, uhi), (vlo, vhi) = rect
    empty = front & ((ulo > uhi) | (vlo > vhi))
    ulo, vlo = torch.where(front, ulo, 0), torch.where(front, vlo, 0)  # else the whole frame
    uhi, vhi = torch.where(front, uhi, w - 1), torch.where(front, vhi, h - 1)
    thr = (Z.amin(-1) - trunc) - eps[:, None, None, None]
    nty, ntx = tiles.shape[1:]
    tx, ty = torch.arange(ntx, device=dev), torch.arange(nty, device=dev)
    hit = torch.zeros_like(front)
    for i in range(s):  # (bricks, nty, ntx) per slot
        in_x = (tx >= (ulo[i] // TILE)[..., None]) & (tx <= (uhi[i] // TILE)[..., None])
        in_y = (ty >= (vlo[i] // TILE)[..., None]) & (ty <= (vhi[i] // TILE)[..., None])
        deep = tiles[i].to(f64) >= thr[i][..., None, None]
        hit[i] = (deep & in_y[..., :, None] & in_x[..., None, :]).any(-1).any(-1)
    cull = cull | empty | ~hit | ~finite[:, None, None, None]
    if gates is not None:
        cull = cull | ~gates.reshape(s, 1, 1, 1)
    if starts is not None:
        e = int(cfg.integrate_slab) - 1
        apart = torch.zeros_like(cull)
        for a in range(3):
            st = starts[:, a].reshape(s, 1, 1, 1)
            shape = [1, 1, 1, 1]
            shape[1 + a] = nb[a]
            lo, hi = los[a].reshape(shape), his[a].reshape(shape)
            apart = apart | (hi < st) | (lo > st + e)
        cull = cull | (fits.reshape(s, 1, 1, 1) & apart)
    return ~cull


def _check_fuse(vols, depths, colors, poses, cfg, gates, starts, fits, lead: tuple, dev) -> None:
    """Shapes, types and devices of one fuse: ``lead`` is (S,) with the slot
    axis, () for one volume."""
    nx, v = vols.tsdf.shape[len(lead)], cfg.resolution
    h, w = depths.shape[len(lead):]
    if v > MAX_RESOLUTION:
        raise ValueError(f"resolution {v} > {MAX_RESOLUTION}")
    for name, t in (("tsdf", vols.tsdf), ("weight", vols.weight)):
        _check(name, t, (*lead, nx, v, v), torch.float32, dev)
    if vols.color is not None:
        _check("color", vols.color, (*lead, nx, v, v, 3), torch.float32, dev)
        _check("color_weight", vols.color_weight, (*lead, nx, v, v), torch.float32, dev)
        _check("color frame", colors, (*lead, h, w, 3), torch.float32, dev)
    _check("depth", depths, (*lead, h, w), torch.float32, dev)
    _check("pose", poses, (*lead, 4, 4), torch.float32, dev)
    if gates is not None:
        _check("gate", gates, lead, torch.bool, dev)
    if starts is not None:
        _check("start", starts, (*lead, 3), torch.int32, dev)
        _check("fits", fits, lead, torch.bool, dev)


def depth_tiles(depths: torch.Tensor, cfg, count: torch.Tensor | None = None) -> torch.Tensor:
    """The depth-tile map of (S, H, W) f32 frames: (S, ceil(H/TILE),
    ceil(W/TILE)) f32, each tile's largest valid depth, -inf where none (the
    brick cull's input); the same launch zeroes ``count`` ((1,) int32 on the
    card, the cull's list count) when given. The integrate's first launch
    alone, for cull_bricks and for timing. CUDA tensors launch the kernel
    on the current stream without synchronizing; CPU tensors run
    depth_tiles_reference."""
    from realsensetracker_tpu_torch.mapping.tsdf import f32

    dev = depths.device
    if dev.type == "cpu":
        return depth_tiles_reference(depths, cfg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    s, h, w = depths.shape
    if not 1 <= s <= MAX_SLOTS:
        raise ValueError(f"{s} slots outside 1..{MAX_SLOTS}")
    _check("depth", depths, (s, h, w), torch.float32, dev)
    if count is not None:
        _check("count", count, (1,), torch.int32, dev)
    tiles = torch.empty((s, -(-h // TILE), -(-w // TILE)), dtype=torch.float32, device=dev)
    lib = _library(INTEGRATE_SOURCE)
    with torch.cuda.device(dev):
        err = lib.rst_tsdf_depth_tiles(depths.data_ptr(), tiles.data_ptr(), _ptr(count), s, h, w, f32(cfg.min_depth),
                                       f32(cfg.max_depth), _stream(dev))
    _raise("tsdf_depth_tiles", lib, err)
    LAUNCHES["tsdf_depth_tiles"] += 1
    return tiles


def _raise(name: str, lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.rst_tsdf_integrate_error_string(err).decode()} ({err})")


class _Config(ctypes.Structure):
    """One launch's sizes and constants (csrc/tsdf_integrate.cu Config)."""

    _fields_ = ([(n, ctypes.c_int) for n in ("s", "v", "x0", "nx", "h", "w", "slab")]
                + [(n, ctypes.c_float) for n in ("fx", "fy", "cx", "cy", "ox", "oy", "oz", "vs", "trunc", "inv_trunc",
                                                 "min_depth", "max_depth", "max_weight")]
                + [(n, ctypes.c_double) for n in _Cull._fields[:-1]] + [("sides", ctypes.c_int)])


@functools.lru_cache(maxsize=64)
def _config(intr: camera.Intrinsics, cfg, s: int, x0: int, nx: int, h: int, w: int) -> tuple[_Config, int]:
    """The launch's _Config and the bytes of rst_tsdf_fuse's workspace."""
    from realsensetracker_tpu_torch.mapping.tsdf import f32

    if s * math.prod(brick_grid(cfg.resolution, nx)) >= 2**31:
        raise ValueError(f"{s} slots of {brick_grid(cfg.resolution, nx)} bricks: the brick list's count is 32 bits")
    c = _cull_constants(intr, cfg, h, w)
    o = cfg.origin
    conf = _Config(s, cfg.resolution, x0, nx, h, w, int(cfg.integrate_slab),
                   f32(intr.fx), f32(intr.fy), f32(intr.cx), f32(intr.cy), f32(o[0]), f32(o[1]), f32(o[2]),
                   f32(cfg.voxel_size), f32(cfg.trunc), f32(1.0 / cfg.trunc), f32(cfg.min_depth),
                   f32(cfg.max_depth), f32(cfg.max_weight), *c[:-1], int(c.sides))
    work = _library(INTEGRATE_SOURCE).rst_tsdf_work_bytes(ctypes.addressof(conf))
    if work <= 0:
        raise ValueError(f"no launch of {s} slots, planes {x0}..{x0 + nx - 1} of {cfg.resolution}^3, {h}x{w}")
    return conf, work


def cull_bricks(poses_cam_from_world, tiles, count, intr: camera.Intrinsics, cfg, h: int, w: int, x0: int = 0,
                nx: int | None = None, gates=None, starts=None, fits=None) -> torch.Tensor:
    """The integrate's second launch alone, to hold it against its plain
    twin (brick_mask_reference) and to time it: S slots' bricks against
    their poses ((S, 4, 4) f32), gates, windows and ``tiles`` (depth_tiles
    of their (H, W) frames, which zeroed ``count``). Returns the (S nbx nby
    nbz,) int64 list whose first ``count`` entries are the kept bricks,
    (slot << 32) | (bx nby + by) nbz + bz, in no fixed order. One launch on
    the current stream, no sync."""
    dev = poses_cam_from_world.device
    s = poses_cam_from_world.shape[0]
    nx = cfg.resolution if nx is None else nx
    _check("pose", poses_cam_from_world, (s, 4, 4), torch.float32, dev)
    _check("tiles", tiles, (s, -(-h // TILE), -(-w // TILE)), torch.float32, dev)
    _check("count", count, (1,), torch.int32, dev)
    if gates is not None:
        _check("gate", gates, (s,), torch.bool, dev)
    if starts is not None:
        _check("start", starts, (s, 3), torch.int32, dev)
        _check("fits", fits, (s,), torch.bool, dev)
    conf, _ = _config(intr, cfg, s, int(x0), nx, h, w)
    bricks = torch.empty((s * math.prod(brick_grid(cfg.resolution, nx)),), dtype=torch.int64, device=dev)
    lib = _library(INTEGRATE_SOURCE)
    with torch.cuda.device(dev):
        err = lib.rst_tsdf_cull(poses_cam_from_world.data_ptr(), tiles.data_ptr(), _ptr(gates), _ptr(starts),
                                _ptr(fits), bricks.data_ptr(), count.data_ptr(), ctypes.addressof(conf), _stream(dev))
    _raise("tsdf_cull", lib, err)
    LAUNCHES["tsdf_cull"] += 1
    return bricks


def _fuse(vols, depths, colors, poses, intr: camera.Intrinsics, cfg, gates, starts, fits, x0: int, s: int) -> None:
    """fuse_block(s) on the card: one call of rst_tsdf_fuse, three launches
    on the current stream (the tile map, the cull into a device list of
    bricks, the update of the listed bricks) and no sync. ``s`` slots; the
    tensors carry the slot axis unless s is 1 and they have none."""
    dev = vols.tsdf.device
    h, w = depths.shape[-2:]
    conf, work_bytes = _config(intr, cfg, s, int(x0), vols.tsdf.shape[-3], h, w)
    work = torch.empty((work_bytes,), dtype=torch.uint8, device=dev)
    lib = _library(INTEGRATE_SOURCE)
    with torch.cuda.device(dev):
        err = lib.rst_tsdf_fuse(
            vols.tsdf.data_ptr(), vols.weight.data_ptr(), _ptr(vols.color), _ptr(vols.color_weight),
            depths.data_ptr(), _ptr(colors), poses.data_ptr(), _ptr(gates), _ptr(starts), _ptr(fits),
            work.data_ptr(), ctypes.addressof(conf), _stream(dev))
    _raise("tsdf_integrate", lib, err)
    LAUNCHES["tsdf_depth_tiles"] += 1
    LAUNCHES["tsdf_cull"] += 1
    LAUNCHES["tsdf_integrate"] += 1


def _check_planes(dev, starts, fits, nx: int, x0: int, cfg) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if (starts is None) != (fits is None):
        raise ValueError("start and fits come together")
    if not (0 <= x0 and nx >= 1 and x0 + nx <= cfg.resolution):
        raise ValueError(f"slab of {nx} planes from x0={x0} lies outside a grid of {cfg.resolution}")


def fuse_blocks(vols, depths, colors, poses_cam_from_world, intr: camera.Intrinsics, cfg,
                gates=None, starts=None, fits=None, x0: int = 0) -> None:
    """Fuse S slots' frames with one launch of each of the three kernels
    (tile map, cull, update): slot i's ``depths[i]`` (H, W) f32 (and
    ``colors[i]`` (H, W, 3) on colored volumes) into its planes ``vols``'
    arrays [i] ((S, nx, V, V)) in place, seen from
    ``poses_cam_from_world[i]``, gated by ``gates[i]`` and, where
    ``fits[i]``, the window from ``starts[i]`` (device tensors; None:
    open). Each slot's result is that of fuse_block on it alone. CUDA
    tensors launch the kernels on the current stream without
    synchronizing; CPU tensors run fuse_blocks_reference."""
    dev = vols.tsdf.device
    _check_planes(dev, starts, fits, vols.tsdf.shape[1], x0, cfg)
    if dev.type == "cpu":
        return fuse_blocks_reference(vols, depths, colors, poses_cam_from_world, intr, cfg, gates, starts, fits, x0)
    s = depths.shape[0]
    if not 1 <= s <= MAX_SLOTS:
        raise ValueError(f"{s} slots outside 1..{MAX_SLOTS}")
    _check_fuse(vols, depths, colors, poses_cam_from_world, cfg, gates, starts, fits, (s,), dev)
    _fuse(vols, depths, colors, poses_cam_from_world, intr, cfg, gates, starts, fits, x0, s)


def fuse_block(vol, depth, color, pose_cam_from_world, intr: camera.Intrinsics, cfg,
               gate=None, start=None, fits=None, x0: int = 0) -> None:
    """Fuse ``depth`` (H, W) f32 (and ``color`` (H, W, 3) f32 on a colored
    volume) into ``vol`` in place, seen from ``pose_cam_from_world`` (4, 4).
    ``vol``'s arrays hold planes x0 .. x0+nx-1 of the V^3 grid ((nx, V, V);
    x0 = 0, nx = V: the whole volume).
    ``gate`` () bool, ``start`` (3,) int32 and ``fits`` () bool are device
    tensors (None: open; start and fits come together, for the slab window
    of edge cfg.integrate_slab). fuse_blocks with one slot: CUDA tensors
    launch the kernels on the current stream without synchronizing; CPU
    tensors run fuse_block_reference."""
    dev = vol.tsdf.device
    _check_planes(dev, start, fits, vol.tsdf.shape[0], x0, cfg)
    if dev.type == "cpu":
        return fuse_block_reference(vol, depth, color, pose_cam_from_world, intr, cfg, gate, start, fits, x0)
    _check_fuse(vol, depth, color, pose_cam_from_world, cfg, gate, start, fits, (), dev)
    _fuse(vol, depth, color, pose_cam_from_world, intr, cfg, gate, start, fits, x0, 1)


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


def march(source, pose_world_from_cam, intr: camera.Intrinsics, cfg, n_steps: int, z_start=None, gate=None,
          subvoxel_iters: int = 0) -> torch.Tensor:
    """March every ray of ``intr`` through ``source`` seen from
    ``pose_world_from_cam`` (4, 4) f32: from per-ray ``z_start`` ((H, W)
    f32, None: cfg.min_depth) for ``n_steps`` steps, then
    ``subvoxel_iters`` trilinear refinements of the hits ``gate`` ((H, W)
    bool, None: all) keeps. ``source`` is the flat (V^3,) march field
    (mapping/tsdf.march_field) or a volume (a TsdfVolume, or anything with
    its ``tsdf`` and ``weight``) whose planes are contiguous (V, V, V) f32:
    the kernel then reads each sample's field value from the planes, and
    the depth is the same to the bit. Returns (H, W) depth, 0 where no kept
    hit. CUDA tensors launch the kernel on the current stream without
    synchronizing; CPU tensors run march_reference (a volume's field built
    first)."""
    from realsensetracker_tpu_torch.mapping.tsdf import f32, march_field

    planes = not isinstance(source, torch.Tensor)
    dev = (source.tsdf if planes else source).device
    h, w = int(intr.height), int(intr.width)
    v = cfg.resolution
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return march_reference(march_field(source) if planes else source, pose_world_from_cam, intr, cfg, n_steps,
                               z_start, gate, subvoxel_iters)
    if v > MAX_RESOLUTION:
        raise ValueError(f"resolution {v} > {MAX_RESOLUTION}")
    if planes:
        _check("tsdf", source.tsdf, (v, v, v), torch.float32, dev)
        _check("weight", source.weight, (v, v, v), torch.float32, dev)
    else:
        _check("field", source, (v * v * v,), torch.float32, dev)
    _check("pose", pose_world_from_cam, (4, 4), torch.float32, dev)
    if z_start is not None:
        _check("z_start", z_start, (h, w), torch.float32, dev)
    if gate is not None:
        _check("gate", gate, (h, w), torch.bool, dev)

    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    lib = _library(RAYCAST_SOURCE)
    o = cfg.origin
    args = (pose_world_from_cam.data_ptr(), _ptr(z_start), f32(cfg.min_depth), _ptr(gate), out.data_ptr(), h, w,
            f32(intr.cx), f32(intr.cy), camera.reciprocal(intr.fx), camera.reciprocal(intr.fy),
            v, f32(o[0]), f32(o[1]), f32(o[2]), f32(1.0 / cfg.voxel_size),
            f32(cfg.step_frac * cfg.trunc), int(n_steps), int(subvoxel_iters), f32(0.6 * cfg.voxel_size),
            _stream(dev))
    with torch.cuda.device(dev):
        if planes:
            err = lib.rst_tsdf_raycast_planes(source.tsdf.data_ptr(), source.weight.data_ptr(), *args)
        else:
            err = lib.rst_tsdf_raycast(source.data_ptr(), *args)
    if err != 0:
        raise RuntimeError(f"tsdf_raycast launch failed: {lib.rst_tsdf_raycast_error_string(err).decode()} ({err})")
    LAUNCHES["tsdf_raycast"] += 1
    LAUNCHES["tsdf_raycast_planes"] += int(planes)
    return out
