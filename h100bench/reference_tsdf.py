"""Plain reference of one dense KinectFusion stream's step.

Written from the algorithm the port documents (``mapping/tsdf.py``,
``parallel/streams.py``, ``tracking/tsdf_tracker.py``) in plain torch,
importing nothing of the port; the registration is reference_pairs'.

A step renders the volume from the previous pose (a coarse full-budget
march at 1/coarse resolution seeds a short full-resolution march, then one
trilinear secant refinement of each hit), registers the new frame onto the
render, composes and re-orthonormalizes the pose where the registration
holds (finite, inlier fraction at least the minimum), and fuses the frame
at the new pose into the volume by the KinectFusion running average
(projective distance, truncated, weights capped) where it holds.

``dtype`` sets the precision of the data path, as in reference_pairs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from h100bench import reference_pairs

UNOBSERVED = 2.0


class Grid(NamedTuple):
    v: int
    voxel: float
    origin: tuple
    trunc: float
    max_weight: float
    min_depth: float
    max_depth: float
    max_range: float
    step_frac: float
    coarse: int
    refine_steps: int

    @property
    def step(self) -> float:
        return self.step_frac * self.trunc

    @property
    def num_steps(self) -> int:
        return int(math.ceil((self.max_range - self.min_depth) / self.step))


def grid_of(tsdf: dict) -> Grid:
    v, vs = int(tsdf["resolution"]), float(tsdf["voxel_size"])
    ext = v * vs
    return Grid(v, vs, (-ext / 2, -ext / 2, float(tsdf["origin_z_frac"]) * ext), float(tsdf["trunc"]),
                float(tsdf["max_weight"]), float(tsdf["min_depth"]), float(tsdf["max_depth"]),
                float(tsdf["max_range"]), float(tsdf["step_frac"]), int(tsdf["raycast_coarse"]),
                int(tsdf["refine_steps"]))


def _cam_from_world(pose_wc: torch.Tensor) -> torch.Tensor:
    R, t = pose_wc[:3, :3].double(), pose_wc[:3, 3].double()
    out = torch.eye(4, dtype=torch.float64, device=pose_wc.device)
    out[:3, :3], out[:3, 3] = R.T, -R.T @ t
    return out


def update_mask_slab(depth, pose_cw, cam, g: Grid, x0: int, nx: int, dtype=torch.float32):
    """(update (nx, V, V) bool, obs (nx, V, V)): the voxels of planes
    x0..x0+nx that the frame updates and their truncated observation."""
    fx, fy, cx, cy, w, h = cam
    dev = depth.device
    idx = torch.arange(g.v, dtype=dtype, device=dev) + 0.5
    wx = (idx[x0 : x0 + nx] * g.voxel + g.origin[0])[:, None, None]
    wy = (idx * g.voxel + g.origin[1])[None, :, None]
    wz = (idx * g.voxel + g.origin[2])[None, None, :]
    P = pose_cw.to(dtype)
    x, y, z = ((P[a, 0] * wx + P[a, 1] * wy) + P[a, 2] * wz + P[a, 3] for a in range(3))
    zs = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    u = fx * x / zs + cx
    v = fy * y / zs + cy
    inb = (z > g.min_depth) & (u >= -0.5) & (u < w - 0.5) & (v >= -0.5) & (v < h - 0.5)
    ui = torch.round(u.float()).long().clamp(0, w - 1)
    vi = torch.round(v.float()).long().clamp(0, h - 1)
    d = depth.to(dtype).reshape(-1)[vi * w + ui]
    d_ok = torch.isfinite(d) & (d > g.min_depth) & (d < g.max_depth)
    sdf = torch.where(d_ok, d, 0.0) - z
    upd = inb & d_ok & (sdf >= -g.trunc)
    return upd, torch.clamp(sdf / g.trunc, max=1.0)


def updated_voxels(depth, pose_wc, cam, g: Grid, slab: int = 32) -> int:
    """How many voxels the frame's update predicate takes."""
    pose_cw = _cam_from_world(pose_wc)
    return sum(int(update_mask_slab(depth, pose_cw, cam, g, x0, min(slab, g.v - x0))[0].sum())
               for x0 in range(0, g.v, slab))


def integrate(tsdf, weight, depth, pose_wc, cam, g: Grid, slab: int = 32, dtype=torch.float32) -> None:
    """Fuse a depth frame (meters) taken at pose_wc into (V, V, V) tsdf and
    weight in place: tsdf <- (tsdf w + obs) / (w + 1), w <- min(w + 1, max)."""
    pose_cw = _cam_from_world(pose_wc)
    for x0 in range(0, g.v, slab):
        nx = min(slab, g.v - x0)
        upd, obs = update_mask_slab(depth, pose_cw, cam, g, x0, nx, dtype)
        t, w = tsdf[x0 : x0 + nx], weight[x0 : x0 + nx]
        w_new = w.to(dtype) + 1.0
        t_new = (t.to(dtype) * w.to(dtype) + obs) / torch.clamp(w_new, min=1.0)
        t.copy_(torch.where(upd, t_new.to(t.dtype), t))
        w.copy_(torch.where(upd, torch.clamp(w_new, max=g.max_weight).to(w.dtype), w))


def march_field(tsdf, weight) -> torch.Tensor:
    return torch.where(weight > 0, tsdf.clamp(-1.0, 1.0), UNOBSERVED).reshape(-1)


def _rays(pose_wc, cam, dtype):
    fx, fy, cx, cy, w, h = cam
    dev = pose_wc.device
    R = pose_wc[:3, :3].to(dtype)
    uu = (torch.arange(w, dtype=dtype, device=dev) - cx) / fx
    vv = (torch.arange(h, dtype=dtype, device=dev) - cy) / fy
    dirs = [R[a, 0] * uu[None, :] + R[a, 1] * vv[:, None] + R[a, 2] for a in range(3)]
    return pose_wc[:3, 3].to(dtype), dirs


def _coords(p, a, g: Grid):
    return (p - g.origin[a]) / g.voxel - 0.5


def march(field, pose_wc, cam, g: Grid, n_steps: int, z_start, gate=None, refine: int = 0, dtype=torch.float32):
    """(H, W) depth of the first observed + -> - crossing along each ray from
    z_start within n_steps steps of step_frac x trunc (nearest-voxel
    samples, the crossing interpolated linearly), refined ``refine`` times
    trilinearly; 0 where none, or where ``gate`` is False."""
    t, dirs = _rays(pose_wc, cam, dtype)
    shape = dirs[0].shape
    z0 = torch.broadcast_to(torch.as_tensor(z_start, dtype=dtype, device=field.device), shape)
    step = g.step

    def sample(z):
        cs = [_coords(t[a] + z * dirs[a], a, g) for a in range(3)]
        inside = (cs[0] > -0.5) & (cs[0] < g.v - 0.5) & (cs[1] > -0.5) & (cs[1] < g.v - 0.5) \
            & (cs[2] > -0.5) & (cs[2] < g.v - 0.5)
        ix, iy, iz = (torch.round(c.float()).long().clamp(0, g.v - 1) for c in cs)
        raw = field[(ix * g.v + iy) * g.v + iz].to(dtype)
        return torch.where(inside, raw, 1.0), inside & (raw < 1.5)

    prev, prev_seen = sample(z0)
    hit = torch.zeros(shape, dtype=dtype, device=field.device)
    found = torch.zeros(shape, dtype=torch.bool, device=field.device)
    for k in range(n_steps):
        z = z0 + (k + 1) * step
        val, seen = sample(z)
        cross = ~found & prev_seen & seen & (prev > 0) & (val <= 0)
        den = prev - val
        frac = (prev / torch.where(den.abs() > 1e-12, den, 1e-12)).clamp(0.0, 1.0)
        hit = torch.where(cross, (z - step) + step * frac, hit)
        found = found | cross
        prev, prev_seen = val, seen
    if gate is not None:
        found = found & gate
    for _ in range(refine):
        delta = 0.6 * g.voxel
        zm, zp = hit - delta, hit + delta
        pm, okm = trilinear(field, [t[a] + zm * dirs[a] for a in range(3)], g, dtype)
        pp, okp = trilinear(field, [t[a] + zp * dirs[a] for a in range(3)], g, dtype)
        den = pm - pp
        ok = okm & okp & (den > 1e-6)
        frac = (pm / torch.where(ok, den, 1.0)).clamp(0.0, 1.0)
        hit = torch.where(ok & found, zm + 2.0 * delta * frac, hit)
    return torch.where(found, hit, 0.0).float()


def trilinear(field, pts, g: Grid, dtype):
    """Observed-corner-weighted trilinear sample at world points:
    (value, any observed mass)."""
    cs = [_coords(p, a, g) for a, p in enumerate(pts)]
    i0 = [torch.floor(c.float()).long().clamp(0, g.v - 2) for c in cs]
    fr = [(c - i.to(dtype)).clamp(0.0, 1.0) for c, i in zip(cs, i0)]
    acc = wsum = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wgt = (fr[0] if dx else 1 - fr[0]) * (fr[1] if dy else 1 - fr[1]) * (fr[2] if dz else 1 - fr[2])
                val = field[((i0[0] + dx) * g.v + i0[1] + dy) * g.v + i0[2] + dz].to(dtype)
                wgt = wgt * (val < 1.5).to(dtype)
                acc = acc + wgt * val
                wsum = wsum + wgt
    return acc / torch.clamp(wsum, min=1e-12), wsum > 1e-6


def render(tsdf, weight, pose_wc, cam, g: Grid, dtype=torch.float32) -> torch.Tensor:
    """The model's depth from pose_wc: coarse march, seeds, refine march."""
    fx, fy, cx, cy, w, h = cam
    c = g.coarse
    field = march_field(tsdf, weight)
    ccam = (fx / c, fy / c, (cx + 0.5) / c - 0.5, (cy + 0.5) / c - 0.5, w // c, h // c)
    dc = march(field, pose_wc, ccam, g, g.num_steps, g.min_depth, dtype=dtype)
    z_inf = torch.where(dc > 0, dc, math.inf)
    pooled = -torch.nn.functional.max_pool2d(-z_inf[None, None], 3, stride=1, padding=1)[0, 0]
    up = pooled.repeat_interleave(c, 0).repeat_interleave(c, 1)
    seeded = torch.isfinite(up)
    z0 = torch.clamp(torch.where(seeded, up, g.min_depth) - 2.0 * g.step, min=g.min_depth)
    return march(field, pose_wc, cam, g, g.refine_steps, z0, gate=seeded, refine=1, dtype=dtype)


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """The nearest rotation (polar factor U V^T), the translation kept."""
    U, _, Vh = torch.linalg.svd(T[:3, :3].double())
    R = U @ Vh
    if torch.linalg.det(R) < 0:
        R = torch.cat([R[:, :2], -R[:, 2:]], dim=1)
    out = T.double().clone()
    out[:3, :3] = R
    return out.float()


class StepOut(NamedTuple):
    render: torch.Tensor
    pose: torch.Tensor
    rmse: float
    inlier: float


def step(tsdf, weight, pose_wc, depth_m, cam, g: Grid, icp: dict, min_inlier: float, dtype=torch.float32):
    """One tracked and fused frame of one stream; tsdf, weight update in place."""
    model = render(tsdf, weight, pose_wc, cam, g, dtype)
    T, rmse, frac = reference_pairs.register(depth_m[None], model[None], cam, icp, dtype)
    ok = bool(torch.isfinite(T).all()) and float(frac[0]) >= min_inlier
    pose = orthonormalize(pose_wc.double() @ T[0].double()) if ok else pose_wc
    if ok:
        integrate(tsdf, weight, depth_m, pose, cam, g, dtype=dtype)
    return StepOut(model, pose, float(rmse[0]), float(frac[0]))
