"""Truncated signed distance function (TSDF) volume on a dense grid.

Port of realsensetracker_tpu/mapping/tsdf.py: KinectFusion-style dense
fusion. Every depth frame carves free space and refines the zero-level
surface by a weighted running average; raycasting the volume renders a
synthetic low-noise depth frame to track against
(tracking/tsdf_tracker.py).

* ``integrate`` fuses a frame into the volume in place. On CUDA tensors it
  is kernels/tsdf.fuse_block (csrc/tsdf_integrate.cu): a depth-tile map,
  a cull of the grid's bricks against the frustum and the frame's depth,
  and the update of the kept bricks, three launches; the slab window
  (TsdfConfig.integrate_slab) and the caller's gate are device tensors
  the kernels read, so no frame waits on the host to decide whether or
  where it fuses. ``integrate_slots`` fuses S slots' frames with the same
  three launches (the dense serving slots).
* ``raycast`` and ``raycast_coarse_to_fine`` march every ray through the
  fused march field, nearest-neighbour, to its first +/- crossing, then
  refine it trilinearly. On CUDA tensors each march is one launch of
  kernels/tsdf.march (csrc/tsdf_raycast.cu), one thread per ray. A whole
  volume on the card with contiguous planes is marched as it is: the
  kernel reads each sample's field value from the tsdf and weight planes,
  and no V^3 field is built (``march_source``). A sharded volume's field
  is still built and gathered along x, and a CPU volume's field feeds the
  plain version.
* ``extract_surface*`` emit the zero crossings between axis-adjacent
  voxels as a fixed-capacity masked Cloud: plain torch, run on demand.

CPU tensors take the plain torch versions below (``_fuse_block``,
``_march``, ``_refine_subvoxel``).

Rounding. Every function here is compiled by XLA in the JAX package, and
XLA on the CPU contracts a product that feeds a sum into one fused
multiply-add. Integration picks a pixel by rounding, and the march picks a
voxel by rounding at every step: a last-ulp difference there changes which
sample is read. So the arithmetic that feeds those choices takes compiled
JAX's form here, ``fma`` where XLA contracts and ``reciprocal``-style f32
constants where XLA folds a division by a constant; the CUDA kernels
repeat it operation for operation. Distances are projective (along the
camera z axis): sdf = depth(pixel) - z_cam, truncated to [-trunc, trunc]
and scaled to [-1, 1].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.ops import cloud as cloud_mod
from realsensetracker_tpu_torch.utils.tracing import span


class TsdfConfig(NamedTuple):
    """Static volume + raycast configuration (hashable: compiled programs
    and caches key on it). The default 128^3 x 4 cm grid spans a 5.12 m
    cube centred on x/y with the camera (world origin, looking down +z)
    near the z = 0 face."""

    resolution: int = 128  # voxels per axis (V)
    voxel_size: float = 0.04  # meters
    origin: tuple[float, float, float] = (-2.56, -2.56, -0.56)
    trunc: float = 0.12  # truncation band (meters); >= 2-3 voxels
    max_weight: float = 64.0  # running-average cap
    min_depth: float = 0.05
    max_depth: float = 10.0
    max_range: float = 4.5  # raycast march range (meters)
    step_frac: float = 0.5  # march step = step_frac * trunc (< 1: no crossing is stepped over)
    raycast_coarse: int = 1  # > 1: coarse-to-fine raycast (the tracker's render path)
    refine_steps: int = 8  # full-resolution march steps when raycast_coarse > 1
    track_scale: int = 1  # frame-to-model tracking resolution divisor (power of two);
    # read by tracking/tsdf_tracker.py: the model renders and the ICP runs at
    # (H/s, W/s) while integration still fuses the full-resolution frame
    integrate_every: int = 1  # fuse every Nth tracked frame (frames 0, N, 2N, ... since the seed)
    integrate_slab: int = 0  # edge (voxels) of the frustum-restricted update window; 0 = whole volume
    subvoxel_iters: int = 1  # trilinear secant refinements of each ray hit after the march

    @property
    def num_steps(self) -> int:
        step = self.step_frac * self.trunc
        return int(math.ceil((self.max_range - self.min_depth) / step))


def sized_config(resolution: int = 0, voxel_size: float = 0.0, base: TsdfConfig | None = None) -> TsdfConfig:
    """A TsdfConfig resized to ``resolution``/``voxel_size`` (0 keeps the
    base value), x/y centred on the camera and the z = 0 face at the same
    fractional inset."""
    base = base or TsdfConfig()
    res = resolution or base.resolution
    vox = voxel_size or base.voxel_size
    extent = res * vox
    z_frac = base.origin[2] / (base.resolution * base.voxel_size)
    return base._replace(resolution=res, voxel_size=vox, origin=(-extent / 2, -extent / 2, z_frac * extent))


class TsdfVolume(NamedTuple):
    """Dense TSDF grid, [x, y, z] with z fastest.

    ``tsdf`` holds the truncated signed distance in units of ``cfg.trunc``
    ([-1, 1]); unobserved voxels stay at +1 with weight 0. ``color`` /
    ``color_weight`` exist only on colored volumes: RGB in [0, 1] fused by
    its own running average over the near-surface band."""

    tsdf: torch.Tensor  # (V, V, V) f32
    weight: torch.Tensor  # (V, V, V) f32 >= 0
    color: torch.Tensor | None = None  # (V, V, V, 3) f32
    color_weight: torch.Tensor | None = None  # (V, V, V) f32

    @property
    def resolution(self) -> int:
        return self.tsdf.shape[-1]


def init_volume(cfg: TsdfConfig, with_color: bool = False, device=device_mod.DEFAULT) -> TsdfVolume:
    dev = device_mod.resolve(device)
    v = cfg.resolution
    z = lambda *s: torch.zeros((v, v, v) + s, dtype=torch.float32, device=dev)  # noqa: E731
    return TsdfVolume(
        tsdf=torch.ones((v, v, v), dtype=torch.float32, device=dev),
        weight=z(),
        color=z(3) if with_color else None,
        color_weight=z() if with_color else None,
    )


def clone_volume(vol: TsdfVolume) -> TsdfVolume:
    return TsdfVolume(*(None if a is None else a.clone() for a in vol))


# ---- compiled-JAX arithmetic ----------------------------------------------


def f32(x: float) -> float:
    """A Python constant rounded to f32, as jnp.float32(x) makes it."""
    return float(np.float32(x))


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) else f32(x)


def fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32, as XLA on the CPU contracts it and as
    the CUDA kernels compute it: the f32 product is exact in f64 and the f64
    sum rounds to f32 (a second rounding that can differ from a single one
    only when the f64 sum lies exactly half-way between two f32 values)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def _grid_lines(cfg: TsdfConfig, device, x0: int = 0, nx: int | None = None) -> tuple[torch.Tensor, ...]:
    """World coordinate of every voxel centre along each axis, (V,) each
    (x: the nx planes from global plane x0; nx None: V):
    origin + (idx + 0.5) * voxel_size, in the form compiled JAX's integrate
    takes on the CPU (XLA contracts the x and y lines into fused
    multiply-adds and computes the z line, its vectorized inner loop, in
    two roundings; measured at V = 48). The slab path reads the same lines,
    so a voxel's coordinate never depends on the window it is updated in,
    nor the x line on the slab that holds it."""
    idx = torch.arange(cfg.resolution, dtype=torch.float32, device=device) + 0.5
    vs = f32(cfg.voxel_size)
    ox, oy, oz = (f32(o) for o in cfg.origin)
    xs = idx[x0 : x0 + (cfg.resolution if nx is None else nx)]
    return fma(xs, vs, ox), fma(idx, vs, oy), oz + idx * vs


def _grid_cam_coords(pose_cam_from_world: torch.Tensor, cfg: TsdfConfig, x0: int = 0, nx: int | None = None):
    """Camera-frame coordinates of every voxel centre (of the nx planes from
    global plane x0) as three (nx, V, V) tensors:
    cam_a = ((R_a0 wx + R_a1 wy) + R_a2 wz) + t_a, affine per axis,
    assembled from broadcast (V,) lines; the y product is contracted onto
    the x product, as compiled JAX computes it on the CPU."""
    R = pose_cam_from_world[:3, :3].to(torch.float32)
    t = pose_cam_from_world[:3, 3].to(torch.float32)
    wx, wy, wz = _grid_lines(cfg, pose_cam_from_world.device, x0, nx)
    wx, wy, wz = wx[:, None, None], wy[None, :, None], wz[None, None, :]
    return tuple((fma(R[a, 1], wy, R[a, 0] * wx) + R[a, 2] * wz) + t[a] for a in range(3))


# ---- integrate ------------------------------------------------------------


def _fuse_block(block, depth, color, pose_cam_from_world, intr: camera.Intrinsics, cfg: TsdfConfig, x0: int = 0):
    """Plain torch version of the KinectFusion running-average update of
    the whole volume (JAX _fuse_block), or of the x-slab ``block`` holds
    from global plane ``x0``: returns the updated (tsdf, weight, color,
    color_weight) tensors. Voxels in front of or at most trunc behind the
    observed surface update; deeper ones keep their state."""
    tsdf_b, weight_b, color_b, cw_b = block
    h, w = depth.shape
    cx_, cy_, cz_ = _grid_cam_coords(pose_cam_from_world, cfg, x0, tsdf_b.shape[0])
    z_safe = torch.where(cz_ > 1e-6, cz_, f32(1e-6))
    u = intr.fx * cx_ / z_safe + intr.cx
    v_ = intr.fy * cy_ / z_safe + intr.cy
    ui = torch.round(u).to(torch.int32).clamp(0, w - 1)
    vi = torch.round(v_).to(torch.int32).clamp(0, h - 1)
    inb = (cz_ > cfg.min_depth) & (u >= -0.5) & (u < w - 0.5) & (v_ >= -0.5) & (v_ < h - 0.5)
    pix = (vi * w + ui).long()
    d = depth.reshape(-1)[pix]  # the one (V, V, V) gather
    d_ok = torch.isfinite(d) & (d > cfg.min_depth) & (d < cfg.max_depth)
    d = torch.where(d_ok, d, 0.0)
    sdf = d - cz_
    upd = inb & d_ok & (sdf >= -f32(cfg.trunc))
    obs = torch.clamp(sdf * f32(1.0 / cfg.trunc), max=1.0)  # XLA folds sdf / trunc into this
    m = upd.to(torch.float32)
    w_new = weight_b + m
    tsdf_new = torch.where(upd, fma(tsdf_b, weight_b, obs * m) / torch.clamp(w_new, min=1.0), tsdf_b)
    new_color, new_cw = color_b, cw_b
    if color_b is not None:
        band = upd & (sdf <= f32(cfg.trunc))
        mc = band.to(torch.float32)
        cw_new = cw_b + mc
        rgb = color.to(torch.float32).reshape(-1, 3)[pix]  # (V, V, V, 3)
        new_color = torch.where(
            band[..., None],
            fma(color_b, cw_b[..., None], rgb * mc[..., None]) / torch.clamp(cw_new, min=1.0)[..., None],
            color_b,
        )
        new_cw = torch.clamp(cw_new, max=cfg.max_weight)
    return tsdf_new, torch.clamp(w_new, max=cfg.max_weight), new_color, new_cw


def slab_bound_ok(intr: camera.Intrinsics, cfg: TsdfConfig) -> bool:
    """Whether the slab window's fixed 2-voxel rounding margin covers the
    worst lateral gap between a voxel and the centre ray of the pixel it
    rounds to: half a pixel at the deepest depth a voxel can update from,
    (max_depth + trunc) * 0.5 * hypot(1/fx, 1/fy)."""
    gap = (cfg.max_depth + cfg.trunc) * 0.5 * math.hypot(1.0 / intr.fx, 1.0 / intr.fy)
    return gap <= 2.0 * cfg.voxel_size


def slab_window(depth: torch.Tensor, pose_world_from_cam: torch.Tensor, intr: camera.Intrinsics,
                cfg: TsdfConfig):
    """(start (3,) int32, fits () bool) of the S^3 update window over this
    frame's update support (JAX _integrate_slab): the world AABB of the
    camera-to-surface segments extended trunc past the surface, on the
    device. fits is False when the AABB exceeds S voxels on an axis or the
    frame has no valid depth; the whole volume then updates."""
    v, s = cfg.resolution, int(cfg.integrate_slab)
    dirs = _ray_dirs(pose_world_from_cam, intr)
    t = pose_world_from_cam[:3, 3].to(torch.float32)
    d_ok = torch.isfinite(depth) & (depth > cfg.min_depth) & (depth < cfg.max_depth)
    d = torch.where(d_ok, depth, 0.0)
    big = f32(3.0e38)
    mu = max(abs(0.0 - intr.cx), abs(intr.width - 1.0 - intr.cx)) / intr.fx
    mv = max(abs(0.0 - intr.cy), abs(intr.height - 1.0 - intr.cy)) / intr.fy
    margin = f32(cfg.trunc * math.sqrt(mu * mu + mv * mv + 1.0) + 2.0 * cfg.voxel_size)
    inv_vs = f32(1.0 / cfg.voxel_size)
    starts, fits = [], d_ok.any()
    for a, dir_a in enumerate(dirs):
        pts = fma(d, dir_a, t[a])  # surface endpoints (world axis a)
        lo = torch.minimum(torch.where(d_ok, pts, big).amin(), t[a])
        hi = torch.maximum(torch.where(d_ok, pts, -big).amax(), t[a])
        o = f32(cfg.origin[a])
        i_lo = torch.floor(fma((lo - margin) - o, inv_vs, -0.5)).to(torch.int32).clamp(0, v - 1)
        i_hi = torch.ceil(fma((hi + margin) - o, inv_vs, -0.5)).to(torch.int32).clamp(0, v - 1)
        fits = fits & (i_hi - i_lo + 1 <= s)
        starts.append(i_lo.clamp(0, v - s))
    return torch.stack(starts), fits


def integrate(vol: TsdfVolume, depth: torch.Tensor, pose_world_from_cam: torch.Tensor,
              intr: camera.Intrinsics, cfg: TsdfConfig = TsdfConfig(), color: torch.Tensor | None = None,
              gate: torch.Tensor | None = None) -> TsdfVolume:
    """Fuse one depth frame (H, W) meters taken at ``pose_world_from_cam``
    into ``vol`` IN PLACE (weighted running average, KinectFusion eq.
    11-13) and return it.

    ``color`` ((H, W, 3) RGB in [0, 1]) is required iff the volume is
    colored; it fuses over the near-surface band |sdf| <= trunc. ``gate``
    (a () bool tensor on the volume's device, None = True) skips the whole
    update where False, read on the device (the tracker's failure hold and
    integrate_every cadence). With TsdfConfig.integrate_slab = S (0 < S < V)
    only the S^3 window over the frame's update support updates, which
    gives the same volume as the whole pass (voxels outside it cannot meet
    the update predicate); the window's rounding margin is checked here
    (slab_bound_ok) and a configuration it does not cover raises. A volume
    sharded in x-slabs (mapping/sharded.py) goes to sharded.integrate."""
    from realsensetracker_tpu_torch.mapping import sharded

    if sharded.is_sharded(vol):
        return sharded.integrate(vol, depth, pose_world_from_cam, intr, cfg, color=color, gate=gate)
    _integrate_planes(vol, depth, pose_world_from_cam, intr, cfg, color, gate, 0)
    return vol


def integrate_slots(volume: TsdfVolume, depths: torch.Tensor, poses_world_from_cam: torch.Tensor,
                    intr: camera.Intrinsics, cfg: TsdfConfig = TsdfConfig(),
                    gates: torch.Tensor | None = None) -> TsdfVolume:
    """Fuse S slots' depth frames ((S, H, W) meters, taken at
    ``poses_world_from_cam`` (S, 4, 4)) into the (S, V, V, V) tsdf and
    weight planes of ``volume`` IN PLACE, gated per slot by ``gates`` ((S,)
    bool on the volume's device, None = all open), and return it. One
    kernels/tsdf.fuse_blocks call: three launches on the card whatever S
    (tile map, cull, update). Slot i ends bit-identical to integrate() on
    its planes alone (its pose is inverted alone, as there). The dense
    serving slots' integrate (parallel/streams.py): depth-only, and without
    the slab window, which the slots force off as JAX does under vmap."""
    from realsensetracker_tpu_torch.kernels import tsdf as tsdf_kernels

    with span("rst.tsdf.integrate"):
        if 0 < int(cfg.integrate_slab) < cfg.resolution:
            raise ValueError("integrate_slots has no slab window: set integrate_slab=0 (parallel/streams.py does)")
        poses_world_from_cam = poses_world_from_cam.to(torch.float32)
        pose_cfw = torch.stack([se3.inverse(P) for P in poses_world_from_cam]).contiguous()
        tsdf_kernels.fuse_blocks(volume, depths.to(torch.float32).contiguous(), None, pose_cfw, intr, cfg,
                                 gates=gates)
        return volume


def _integrate_planes(vol, depth, pose_world_from_cam, intr, cfg, color, gate, x0: int) -> None:
    """integrate on the planes x0 .. x0+nx-1 that ``vol``'s tensors hold
    (the whole volume, or one rank's slab of a sharded one)."""
    from realsensetracker_tpu_torch.kernels import tsdf as tsdf_kernels

    if (vol.color is not None) != (color is not None):
        raise ValueError(
            "colored volume needs a color frame (and vice versa): "
            f"vol.color={'set' if vol.color is not None else 'None'}, color={'set' if color is not None else 'None'}"
        )
    depth = depth.to(torch.float32).contiguous()
    color = None if color is None else color.to(torch.float32).contiguous()
    pose_world_from_cam = pose_world_from_cam.to(torch.float32)
    pose_cfw = se3.inverse(pose_world_from_cam).contiguous()
    s = int(cfg.integrate_slab)
    start = fits = None
    if 0 < s < cfg.resolution:
        if not slab_bound_ok(intr, cfg):
            raise ValueError(
                f"integrate_slab={s}: the window's 2-voxel rounding margin ({2 * cfg.voxel_size} m) does not "
                f"cover half a pixel at max_depth + trunc ({cfg.max_depth + cfg.trunc} m) for fx={intr.fx}, "
                f"fy={intr.fy}; lower max_depth, raise voxel_size or set integrate_slab=0"
            )
        start, fits = slab_window(depth, pose_world_from_cam, intr, cfg)
    tsdf_kernels.fuse_block(vol, depth, color, pose_cfw, intr, cfg, gate=gate, start=start, fits=fits, x0=x0)


# ---- raycast --------------------------------------------------------------


def _ray_dirs(pose_world_from_cam: torch.Tensor, intr: camera.Intrinsics):
    """World-frame ray direction per unit z-depth of every pixel,
    R @ [(u-cx)/fx, (v-cy)/fy, 1], as three (H, W) planes."""
    h, w = int(intr.height), int(intr.width)
    dev = pose_world_from_cam.device
    R = pose_world_from_cam[:3, :3].to(torch.float32)
    uu = (torch.arange(w, dtype=torch.float32, device=dev) - intr.cx) * camera.reciprocal(intr.fx)
    vv = (torch.arange(h, dtype=torch.float32, device=dev) - intr.cy) * camera.reciprocal(intr.fy)
    return tuple(fma(R[a, 0], uu[None, :], R[a, 1] * vv[:, None]) + R[a, 2] for a in range(3))


UNOBSERVED = 2.0  # march-field value of weight == 0 voxels: observed values lie in [-1, 1]


def march_field(vol: TsdfVolume) -> torch.Tensor:
    """Flat (V^3,) march field: clip(tsdf, -1, 1) where observed, UNOBSERVED
    elsewhere; every march and refinement sample reads it once. A sharded
    volume's field is gathered along x (sharded.gather_march_field)."""
    from realsensetracker_tpu_torch.mapping import sharded

    if sharded.is_sharded(vol):
        return sharded.gather_march_field(vol)
    return torch.where(vol.weight > 0, vol.tsdf.clamp(-1.0, 1.0), UNOBSERVED).reshape(-1)


def march_source(vol: TsdfVolume):
    """What the renders march (kernels/tsdf.march's ``source``): ``vol``
    itself where the kernel can read its planes -- a whole volume on the
    card, tsdf and weight contiguous -- else its march_field (a sharded
    volume's gathered, a CPU volume's for the plain version, a strided
    plane's: never copied behind the caller's back)."""
    from realsensetracker_tpu_torch.mapping import sharded

    if (not sharded.is_sharded(vol) and vol.tsdf.is_cuda and vol.tsdf.is_contiguous()
            and vol.weight.is_contiguous()):
        return vol
    return march_field(vol)


class _Grid(NamedTuple):
    v: int
    origin: tuple[float, float, float]  # f32 values
    inv_vs: float
    step: float


def _grid(cfg: TsdfConfig) -> _Grid:
    return _Grid(cfg.resolution, tuple(f32(o) for o in cfg.origin), f32(1.0 / cfg.voxel_size),
                 f32(cfg.step_frac * cfg.trunc))


def _grid_coord(p: torch.Tensor, a: int, g: _Grid) -> torch.Tensor:
    return fma(p - g.origin[a], g.inv_vs, -0.5)  # (p - o_a) * inv_vs - 0.5


def _march(field, t, dirs, z_start, n_steps: int, cfg: TsdfConfig):
    """Plain torch version of the lockstep ray march (JAX _march): from
    per-ray depth ``z_start`` (a tensor shaped like the rays, or a float)
    for ``n_steps`` fixed steps, nearest-neighbour samples of the march
    field, the first observed + -> - crossing interpolated linearly.
    Returns (z_hit, found)."""
    g = _grid(cfg)
    v = g.v
    shape = dirs[0].shape
    z_start = torch.broadcast_to(torch.as_tensor(z_start, dtype=torch.float32, device=dirs[0].device), shape)

    def sample(z):
        gs = [_grid_coord(fma(z, dirs[a], t[a]), a, g) for a in range(3)]
        ix, iy, iz = (torch.round(c).to(torch.int32).clamp(0, v - 1) for c in gs)
        inside = torch.ones(shape, dtype=torch.bool, device=z.device)
        for c in gs:
            inside = inside & (c > -0.5) & (c < v - 0.5)
        raw = field[((ix * v + iy) * v + iz).long()]
        seen = inside & (raw < 1.5)
        return torch.where(inside, raw, 1.0), seen

    prev_val, prev_seen = sample(z_start)
    z_hit = torch.zeros(shape, dtype=torch.float32, device=z_start.device)
    found = torch.zeros(shape, dtype=torch.bool, device=z_start.device)
    for k in range(n_steps):
        z = fma(float(k + 1), g.step, z_start)
        val, seen = sample(z)
        cross = ~found & prev_seen & seen & (prev_val > 0) & (val <= 0)
        denom = prev_val - val
        frac = prev_val / torch.where(denom.abs() > 1e-12, denom, f32(1e-12))
        z_cross = fma(g.step, frac.clamp(0.0, 1.0), z - g.step)
        z_hit = torch.where(cross, z_cross, z_hit)
        found = found | cross
        prev_val, prev_seen = val, seen
    return z_hit, found


def _trilinear_tsdf(field, px, py, pz, cfg: TsdfConfig):
    """Observation-gated trilinear sample of the march field at world
    points: the weighted mean over the observed corners (field < 1.5) of
    the surrounding cell. Returns (value, valid = any observed mass)."""
    g = _grid(cfg)
    v = g.v
    gs = [_grid_coord(p, a, g) for a, p in enumerate((px, py, pz))]
    i0 = [torch.floor(c).to(torch.int32).clamp(0, v - 2) for c in gs]
    fr = [(c - i).clamp(0.0, 1.0) for c, i in zip(gs, i0)]
    acc = w_acc = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((fr[0] if dx else 1.0 - fr[0]) * (fr[1] if dy else 1.0 - fr[1])) * (fr[2] if dz else 1.0 - fr[2])
                lin = ((i0[0] + dx) * v + i0[1] + dy) * v + i0[2] + dz
                cval = field[lin.long()]
                w = w * (cval < 1.5).to(torch.float32)
                if acc is None:
                    acc, w_acc = w * cval, w
                else:
                    acc, w_acc = fma(w, cval, acc), w_acc + w
    return acc / torch.clamp(w_acc, min=f32(1e-12)), w_acc > 1e-6


def _refine_subvoxel(field, t, dirs, z_hit, found, cfg: TsdfConfig, iters: int | None = None):
    """Plain torch version of the trilinear secant refinement of march hits
    (JAX _refine_subvoxel): each pass brackets the hit by two trilinear
    samples at +-0.6 voxel along the ray and moves it to the bracket's
    linear zero crossing; an invalid or degenerate bracket leaves it."""
    iters = cfg.subvoxel_iters if iters is None else iters
    if iters <= 0:
        return z_hit
    delta = f32(0.6 * cfg.voxel_size)
    z = z_hit
    for _ in range(iters):
        zm, zp = z - delta, z + delta
        pm, okm = _trilinear_tsdf(field, *(fma(zm, dirs[a], t[a]) for a in range(3)), cfg)
        pp, okp = _trilinear_tsdf(field, *(fma(zp, dirs[a], t[a]) for a in range(3)), cfg)
        denom = pm - pp  # > 0 through a front-facing crossing
        ok = okm & okp & (denom > 1e-6)
        frac = (pm / torch.where(ok, denom, 1.0)).clamp(0.0, 1.0)
        z = torch.where(ok, fma(2.0 * delta, frac, zm), z)
    return torch.where(found, z, z_hit)


def raycast(vol: TsdfVolume, pose_world_from_cam: torch.Tensor, intr: camera.Intrinsics,
            cfg: TsdfConfig = TsdfConfig()) -> torch.Tensor:
    """Synthetic (H, W) depth of the zero-level surface seen from
    ``pose_world_from_cam``: a full-budget march from min_depth and the
    trilinear refinement; 0 where a ray crosses no observed surface."""
    from realsensetracker_tpu_torch.kernels import tsdf as tsdf_kernels

    return tsdf_kernels.march(march_source(vol), pose_world_from_cam.to(torch.float32).contiguous(), intr, cfg,
                              cfg.num_steps, subvoxel_iters=cfg.subvoxel_iters)


def coarse_intrinsics(intr: camera.Intrinsics, coarse: int) -> camera.Intrinsics:
    return camera.Intrinsics(
        fx=intr.fx / coarse, fy=intr.fy / coarse,
        cx=(intr.cx + 0.5) / coarse - 0.5, cy=(intr.cy + 0.5) / coarse - 0.5,
        width=int(intr.width) // coarse, height=int(intr.height) // coarse,
    )


def coarse_seeds(depth_c: torch.Tensor, coarse: int, cfg: TsdfConfig):
    """(z_start, seeded) at full resolution from a coarse render: each ray
    starts 2 steps before the minimum coarse hit of its 3x3 coarse
    neighbourhood; rays with no hit in it are not seeded."""
    z_inf = torch.where(depth_c > 0, depth_c, math.inf)
    pooled = -F.max_pool2d(-z_inf[None, None], 3, stride=1, padding=1)[0, 0]
    hc, wc = pooled.shape
    # Each coarse value repeated coarse x coarse times; expand, not
    # repeat_interleave, which reads its output size back from the card.
    up = pooled[:, None, :, None].expand(hc, coarse, wc, coarse).reshape(hc * coarse, wc * coarse)
    seeded_up = torch.isfinite(up)
    step2 = 2.0 * f32(cfg.step_frac * cfg.trunc)
    z_start = torch.clamp(torch.where(seeded_up, up, f32(cfg.min_depth)) - step2, min=f32(cfg.min_depth))
    return z_start, seeded_up


def raycast_coarse_to_fine(vol: TsdfVolume, pose_world_from_cam: torch.Tensor, intr: camera.Intrinsics,
                           cfg: TsdfConfig = TsdfConfig(), coarse: int = 4, refine_steps: int = 8) -> torch.Tensor:
    """Two-phase raycast: the full-budget march at 1/coarse resolution, then
    a ``refine_steps`` full-resolution march seeded 2 steps before the
    minimum coarse hit of each ray's 3x3 coarse neighbourhood (misses stay
    0). Requires intr.height/width divisible by ``coarse``."""
    from realsensetracker_tpu_torch.kernels import tsdf as tsdf_kernels

    h, w = int(intr.height), int(intr.width)
    if h % coarse or w % coarse:
        raise ValueError(f"{h}x{w} not divisible by coarse={coarse}")
    pose = pose_world_from_cam.to(torch.float32).contiguous()
    source = march_source(vol)  # both phases march the same planes or field
    depth_c = tsdf_kernels.march(source, pose, coarse_intrinsics(intr, coarse), cfg, cfg.num_steps, subvoxel_iters=0)
    z_start, seeded_up = coarse_seeds(depth_c, coarse, cfg)
    return tsdf_kernels.march(source, pose, intr, cfg, refine_steps, z_start=z_start, gate=seeded_up,
                              subvoxel_iters=cfg.subvoxel_iters)


def render_model_depth(vol: TsdfVolume, pose_world_from_cam: torch.Tensor, intr: camera.Intrinsics,
                       cfg: TsdfConfig = TsdfConfig()) -> torch.Tensor:
    """The config's model render: the full march, or coarse-to-fine when
    cfg.raycast_coarse > 1 (the tracker's hot path)."""
    with span("rst.tsdf.render"):
        if cfg.raycast_coarse > 1:
            return raycast_coarse_to_fine(vol, pose_world_from_cam, intr, cfg, coarse=cfg.raycast_coarse,
                                          refine_steps=cfg.refine_steps)
        return raycast(vol, pose_world_from_cam, intr, cfg)


LUMA = (0.299, 0.587, 0.114)  # BT.601


def render_model_rgbd(vol: TsdfVolume, pose_world_from_cam: torch.Tensor, intr: camera.Intrinsics,
                      cfg: TsdfConfig = TsdfConfig()):
    """(depth, gray) render of a colored volume: the depth render plus the
    fused color at each hit, trilinear over the color-observed corners,
    reduced to BT.601 luma in [0, 1]; misses are (0, 0)."""
    if vol.color is None:
        raise ValueError("render_model_rgbd needs a with_color volume")
    vol = whole(vol)
    pose = pose_world_from_cam.to(torch.float32)
    depth = render_model_depth(vol, pose, intr, cfg)
    t = pose[:3, 3]
    dirs = _ray_dirs(pose, intr)
    g = _grid(cfg)
    v = g.v
    gs = [_grid_coord(fma(depth, dirs[a], t[a]), a, g) for a in range(3)]
    i0 = [torch.floor(c).to(torch.int32).clamp(0, v - 2).long() for c in gs]
    fr = [(c - i).clamp(0.0, 1.0) for c, i in zip(gs, i0)]
    rgb_acc = torch.zeros(depth.shape + (3,), dtype=torch.float32, device=depth.device)
    w_acc = torch.zeros(depth.shape, dtype=torch.float32, device=depth.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((fr[0] if dx else 1.0 - fr[0]) * (fr[1] if dy else 1.0 - fr[1])) * (fr[2] if dz else 1.0 - fr[2])
                ix, iy, iz = i0[0] + dx, i0[1] + dy, i0[2] + dz
                w = w * (vol.color_weight[ix, iy, iz] > 0).to(torch.float32)
                rgb_acc = rgb_acc + w[..., None] * vol.color[ix, iy, iz]
                w_acc = w_acc + w
    rgb = rgb_acc / torch.clamp(w_acc, min=f32(1e-12))[..., None]
    gray = (rgb[..., 0] * LUMA[0] + rgb[..., 1] * LUMA[1]) + rgb[..., 2] * LUMA[2]
    valid = (depth > 0) & (w_acc > 0)
    return depth, torch.where(valid, gray, 0.0)


# ---- surface extraction (plain torch, on demand) -------------------------


def whole(vol: TsdfVolume) -> TsdfVolume:
    """``vol`` itself, or a sharded volume's planes gathered on every rank
    (sharded.gather_volume): the input of the on-demand passes below and
    of the colored render and mesh extraction."""
    from realsensetracker_tpu_torch.mapping import sharded

    return sharded.gather_volume(vol) if sharded.is_sharded(vol) else vol


def _shift(a: torch.Tensor, ax: int, d: int, fill) -> torch.Tensor:
    """a moved one voxel along ``ax`` (d > 0: a[i-1] lands at i), the
    vacated face filled with ``fill``."""
    n = a.shape[ax]
    pad_shape = list(a.shape)
    pad_shape[ax] = 1
    pad = torch.full(pad_shape, fill, dtype=a.dtype, device=a.device)
    if d > 0:
        return torch.cat([pad, a.narrow(ax, 0, n - 1)], dim=ax)
    return torch.cat([a.narrow(ax, 1, n - 1), pad], dim=ax)


def _masked_gradient(t: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """(V, V, V, 3) TSDF gradient that never reads unseen voxels: central
    differences where both axis neighbours are observed, one-sided toward
    the observed side otherwise, zero when isolated."""
    axes = []
    for ax in range(3):
        tf, sf = _shift(t, ax, -1, 1.0), _shift(seen, ax, -1, False)
        tb, sb = _shift(t, ax, +1, 1.0), _shift(seen, ax, +1, False)
        g = torch.where(sf & sb, 0.5 * (tf - tb), torch.where(sf, tf - t, torch.where(sb, t - tb, 0.0)))
        axes.append(g)
    return torch.stack(axes, dim=-1)


def _surface_candidates(vol: TsdfVolume, cfg: TsdfConfig, with_normals: bool = False):
    """Zero crossings between axis-adjacent voxel pairs: (pts (M, 3), mask
    (M,), colors (M, 3) | None, normals (M, 3) | None), M = 3 V^2 (V-1), in
    JAX's order (axis, then x, y, z). A zero value counts as a sign
    change, as jnp.sign does."""
    vol = whole(vol)
    v = cfg.resolution
    vs = f32(cfg.voxel_size)
    dev = vol.tsdf.device
    wx, wy, wz = _grid_lines(cfg, dev)
    centers = [c.expand(v, v, v) for c in (wx[:, None, None], wy[None, :, None], wz[None, None, :])]
    seen = vol.weight > 0
    grad = _masked_gradient(vol.tsdf, seen) if with_normals else None

    pts_parts, mask_parts, col_parts, nrm_parts = [], [], [], []
    for axis in range(3):
        lo = lambda a: a.narrow(axis, 0, v - 1)  # noqa: E731
        hi = lambda a: a.narrow(axis, 1, v - 1)  # noqa: E731
        a, b = lo(vol.tsdf), hi(vol.tsdf)
        ok = lo(seen) & hi(seen) & (torch.sign(a) != torch.sign(b))
        denom = a - b
        frac = (a / torch.where(denom.abs() > 1e-12, denom, f32(1e-12))).clamp(0.0, 1.0)
        coords = [lo(c) for c in centers]
        coords[axis] = fma(frac, vs, coords[axis])
        pts_parts.append(torch.stack([c.reshape(-1) for c in coords], dim=-1))
        mask_parts.append(ok.reshape(-1))
        if vol.color is not None:
            ca, cb = lo(vol.color), hi(vol.color)
            col_parts.append(fma(frac[..., None], cb - ca, ca).reshape(-1, 3))
        if with_normals:
            ga, gb = lo(grad), hi(grad)
            gv = fma(frac[..., None], gb - ga, ga)
            gv = gv / torch.clamp(torch.linalg.vector_norm(gv, dim=-1, keepdim=True), min=f32(1e-12))
            nrm_parts.append(gv.reshape(-1, 3))
    pts = torch.cat(pts_parts)
    mask = torch.cat(mask_parts)
    cols = torch.cat(col_parts) if vol.color is not None else None
    nrms = torch.cat(nrm_parts) if with_normals else None
    return pts, mask, cols, nrms


def _compact_to_capacity(pts: torch.Tensor, mask: torch.Tensor, capacity: int) -> cloud_mod.Cloud:
    """Valid rows first in their original order (a stable sort on ~mask),
    then ops.cloud.subsample_to_capacity."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    return cloud_mod.subsample_to_capacity(cloud_mod.Cloud(points=pts[order], mask=mask[order]), capacity)


def extract_surface(vol: TsdfVolume, cfg: TsdfConfig = TsdfConfig(), capacity: int = 65536) -> cloud_mod.Cloud:
    """Zero-level surface as a fixed-capacity masked point cloud: one
    linearly interpolated point per observed axis-adjacent voxel pair whose
    values straddle zero."""
    pts, mask, _, _ = _surface_candidates(vol, cfg)
    return _compact_to_capacity(pts, mask, capacity)


def extract_surface_colored(vol: TsdfVolume, cfg: TsdfConfig = TsdfConfig(), capacity: int = 65536):
    """(Cloud, colors (capacity, 3) in [0, 1]): crossing colors lerp the two
    voxels' fused RGB with the point's fraction. Needs a colored volume."""
    pts, mask, cols, _ = _surface_candidates(vol, cfg)
    if cols is None:
        raise ValueError("extract_surface_colored needs a colored volume (init_volume(with_color=True))")
    joint = _compact_to_capacity(torch.cat([pts, cols], dim=-1), mask, capacity)
    return cloud_mod.Cloud(points=joint.points[:, :3], mask=joint.mask), joint.points[:, 3:]


def extract_surface_oriented(vol: TsdfVolume, cfg: TsdfConfig = TsdfConfig(), capacity: int = 65536):
    """(Cloud, normals (capacity, 3)): the normalized masked TSDF gradient
    lerped to each crossing, pointing into free space."""
    pts, mask, _, nrms = _surface_candidates(vol, cfg, with_normals=True)
    joint = _compact_to_capacity(torch.cat([pts, nrms], dim=-1), mask, capacity)
    return cloud_mod.Cloud(points=joint.points[:, :3], mask=joint.mask), joint.points[:, 3:]
