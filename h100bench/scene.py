"""Frozen traffic generators: the sphere scene, its ray caster, camera motion.

A copy of the scene and depth ray caster of the port's
``data/synthetic.py`` (``default_scene``, ``_trace``, ``render_depth``),
batched over poses, with the motion models of the cells and RealSense's
z16 conversion. Nothing here imports the port: later changes to the
program cannot move the traffic.

Every random draw takes a ``torch.Generator`` that the caller seeds from
``--seed``; draws are made in a few large calls on the generator's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_INF = 1e30


class Camera(NamedTuple):
    """Pinhole intrinsics as plain numbers."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def camera_of(config: dict) -> Camera:
    c = config["camera"]
    return Camera(float(c["fx"]), float(c["fy"]), float(c["cx"]), float(c["cy"]), int(c["width"]), int(c["height"]))


class Scene(NamedTuple):
    centers: torch.Tensor  # (S, 3) world
    radii: torch.Tensor  # (S,)
    floor_y: float = 1.2
    wall_z: float = 4.0


def sphere_scene(seed: int, num_spheres: int = 12, device="cpu") -> Scene:
    """Random spheres in front of a floor and a back wall, drawn on the CPU
    from ``seed`` as the port's ``data.synthetic.default_scene`` draws them
    (centres, radii, then albedo, which depth does not use)."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))

    def uniform(shape, lo, hi):
        lo = torch.as_tensor(lo, dtype=torch.float32)
        hi = torch.as_tensor(hi, dtype=torch.float32)
        return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float32)

    centers = uniform((num_spheres, 3), [-1.5, -0.8, 1.0], [1.5, 1.0, 3.5])
    radii = uniform((num_spheres,), 0.15, 0.45)
    return Scene(centers.to(device), radii.to(device))


def render_depths(cam: Camera, poses_wc: torch.Tensor, scene: Scene, chunk: int = 16) -> torch.Tensor:
    """Z-depth images (N, H, W) f32 of the scene from camera-to-world poses
    (N, 4, 4); 0 where a ray hits nothing. The analytic ray cast of
    ``data.synthetic._trace``: spheres, the floor plane y = floor_y and the
    wall z = wall_z, nearest hit beyond 1 mm."""
    dev = scene.centers.device
    u = torch.arange(cam.width, dtype=torch.float32, device=dev)
    v = torch.arange(cam.height, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d_cam = torch.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy, torch.ones_like(uu)], dim=-1)
    out = []
    for i in range(0, poses_wc.shape[0], chunk):
        T = poses_wc[i : i + chunk].to(device=dev, dtype=torch.float32)
        o = T[:, :3, 3]  # (n, 3)
        w = torch.einsum("hwj,nij->nhwi", d_cam, T[:, :3, :3])  # (n, H, W, 3)
        oc = o[:, None, :] - scene.centers[None]  # (n, S, 3)
        a = (w * w).sum(-1)[..., None]
        b = 2.0 * torch.einsum("nhwi,nsi->nhws", w, oc)
        c = (oc * oc).sum(-1) - scene.radii**2  # (n, S)
        disc = b * b - 4.0 * a * c[:, None, None, :]
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_s = (-b - sq) / (2.0 * a)
        t_s = torch.where((disc > 0) & (t_s > 1e-3), t_s, _INF)
        wy, wz = w[..., 1], w[..., 2]
        t_f = (scene.floor_y - o[:, 1, None, None]) / torch.where(wy.abs() > 1e-9, wy, 1e-9)
        t_f = torch.where(t_f > 1e-3, t_f, _INF)
        t_w = (scene.wall_z - o[:, 2, None, None]) / torch.where(wz.abs() > 1e-9, wz, 1e-9)
        t_w = torch.where(t_w > 1e-3, t_w, _INF)
        t_best = torch.minimum(t_s.amin(-1), torch.minimum(t_f, t_w))
        out.append(torch.where(t_best < _INF, t_best, 0.0))
    return torch.cat(out)


def rotation(axes: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) about unit ``axes`` (..., 3) by
    ``angles`` (...) radians (Rodrigues)."""
    x, y, z = axes.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(*x.shape, 3, 3)
    s, c = torch.sin(angles)[..., None, None], torch.cos(angles)[..., None, None]
    eye = torch.eye(3, dtype=axes.dtype, device=axes.device).expand_as(K)
    return eye + s * K + (1.0 - c) * (K @ K)


def rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros((*R.shape[:-2], 4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def unit_vectors(g: torch.Generator, n: int, device) -> torch.Tensor:
    """n directions uniform on the sphere."""
    v = torch.randn((n, 3), generator=g, device=device, dtype=torch.float64)
    return (v / v.norm(dim=-1, keepdim=True)).float()


def step_lengths(motion: dict) -> tuple[float, float]:
    """(meters, radians) moved per frame at the stated mean speeds."""
    rate = float(motion["rate_hz"])
    return float(motion["speed_mps"]) / rate, math.radians(float(motion["rot_dps"])) / rate


def pair_poses(g: torch.Generator, n: int, start: dict, motion: dict, device):
    """(P0 (n,4,4), M (n,4,4)): each pair's start pose, drawn uniformly in
    the box ``start["box_m"]`` (half-widths in x, y, z) with yaw, pitch and
    roll uniform within ``start["ypr_deg"]``, and its motion: a translation
    of exactly one frame's length at the stated speed in a uniform random
    direction and a rotation of one frame's angle about a uniform random
    axis. The second frame's pose is P0 @ M."""
    box = torch.tensor(start["box_m"], dtype=torch.float32, device=device)
    ypr = torch.tensor([math.radians(a) for a in start["ypr_deg"]], dtype=torch.float32, device=device)
    u = torch.rand((n, 6), generator=g, device=device) * 2.0 - 1.0
    pos, ang = u[:, :3] * box, u[:, 3:] * ypr
    ex = torch.eye(3, dtype=torch.float32, device=device)
    R0 = rotation(ex[1].expand(n, 3), ang[:, 0]) @ rotation(ex[0].expand(n, 3), ang[:, 1]) @ rotation(
        ex[2].expand(n, 3), ang[:, 2])
    dt, dr = step_lengths(motion)
    dirs, axes = unit_vectors(g, n, device), unit_vectors(g, n, device)
    M = rigid(rotation(axes, torch.full((n,), dr, device=device)), dirs * dt)
    return rigid(R0, pos), M


def out_and_back(period: int, frames: int, direction: torch.Tensor, axis: torch.Tensor, motion: dict) -> torch.Tensor:
    """Camera-to-world poses (frames, 4, 4) of one camera that moves out and
    back along ``direction`` while turning about ``axis``, one frame's
    length and angle per frame, with period ``period``: s(f) runs 0, 1, ...,
    period/4, back to -period/4 and up to 0 again, so frame ``period``
    equals frame 0 and the frames cycle without a jump."""
    f = torch.arange(frames, dtype=torch.float64, device=direction.device)
    q = period / 4.0
    s = ((f + 3.0 * q) % period - 2.0 * q).abs() - q
    dt, dr = step_lengths(motion)
    R = rotation(axis.double().expand(frames, 3), s * dr)
    return rigid(R, s[:, None] * dt * direction.double()).float()


def add_noise(g: torch.Generator, depth: torch.Tensor, sigma_m: float) -> torch.Tensor:
    """Gaussian depth noise of ``sigma_m`` meters on the pixels that hit."""
    noise = torch.randn(depth.shape, generator=g, device=depth.device, dtype=torch.float32) * sigma_m
    return torch.where(depth > 0, depth + noise, depth)


def to_z16(depth_m: torch.Tensor, scale_m: float) -> torch.Tensor:
    """RealSense z16: depth in units of ``scale_m`` rounded to uint16, 0 = no
    data (misses and depths past the range)."""
    units = torch.round(depth_m / scale_m)
    units = torch.where((units > 0) & (units <= 65535), units, 0.0)
    return units.to(torch.int32).to(torch.uint16)
