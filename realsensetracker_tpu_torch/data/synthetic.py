"""Synthetic depth rendering: an analytic raycast of a sphere/plane scene.

Port of the depth half of realsensetracker_tpu/data/synthetic.py: frames
rendered from two poses admit an exact known relative transform. Random
draws come from a ``torch.Generator``, so ``default_scene(seed)`` places
its spheres elsewhere than JAX's; to compare the two renderers, hand the
same scene arrays to both. The RGB-D renderers wait (ROADMAP queue 1
item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realsensetracker_tpu_torch.geometry import camera, se3

_INF = 1e30


class Scene(NamedTuple):
    sphere_centers: torch.Tensor  # (S, 3) world
    sphere_radii: torch.Tensor  # (S,)
    floor_y: float = 1.2
    wall_z: float = 4.0


def _uniform(g: torch.Generator, shape, lo, hi) -> torch.Tensor:
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32)
    return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float32)


def default_scene(num_spheres: int = 12, seed: int = 0, device="cpu") -> Scene:
    """Random spheres in front of a floor and a back wall, drawn on the CPU
    from ``seed`` (so every device gets the same scene) and moved to
    ``device``."""
    g = torch.Generator().manual_seed(seed)
    centers = _uniform(g, (num_spheres, 3), [-1.5, -0.8, 1.0], [1.5, 1.0, 3.5])
    radii = _uniform(g, (num_spheres,), 0.15, 0.45)
    return Scene(sphere_centers=centers.to(device), sphere_radii=radii.to(device))


def render_depth(intr: camera.Intrinsics, T_wc: torch.Tensor, scene: Scene) -> torch.Tensor:
    """Z-depth image (H, W) of the scene from camera pose T_wc (camera->world);
    0 where a ray hits nothing."""
    dev = scene.sphere_centers.device
    T_wc = T_wc.to(device=dev, dtype=torch.float32)
    u = torch.arange(intr.width, dtype=torch.float32, device=dev)
    v = torch.arange(intr.height, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d_cam = torch.stack(
        [(uu - intr.cx) / intr.fx, (vv - intr.cy) / intr.fy, torch.ones_like(uu)], dim=-1
    )  # (H, W, 3), z = 1 so the ray parameter is the z-depth
    o = se3.translation(T_wc)
    w = torch.matmul(d_cam, se3.rotation(T_wc).T)

    # Spheres.
    oc = o - scene.sphere_centers  # (S, 3)
    a = (w * w).sum(-1)[..., None]  # (H, W, 1)
    b = 2.0 * torch.einsum("hwi,si->hws", w, oc)
    c = (oc * oc).sum(-1) - scene.sphere_radii**2  # (S,)
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_s = (-b - sq) / (2.0 * a)
    t_s = torch.where((disc > 0) & (t_s > 1e-3), t_s, _INF)  # (H, W, S)

    # Floor plane y = floor_y and back wall z = wall_z.
    t_f = (scene.floor_y - o[1]) / torch.where(w[..., 1].abs() > 1e-9, w[..., 1], 1e-9)
    t_f = torch.where(t_f > 1e-3, t_f, _INF)
    t_w = (scene.wall_z - o[2]) / torch.where(w[..., 2].abs() > 1e-9, w[..., 2], 1e-9)
    t_w = torch.where(t_w > 1e-3, t_w, _INF)

    t_best = torch.cat([t_s, t_f[..., None], t_w[..., None]], dim=-1).amin(-1)
    return torch.where(t_best < _INF, t_best, 0.0)


def render_pair(intr: camera.Intrinsics, motion_twist: torch.Tensor, scene: Scene | None = None):
    """Render (depth0, depth1, T_rel): frame1's camera displaced by the twist.

    T_rel maps camera-1 coordinates into camera-0 coordinates: the transform
    a src=frame1 -> dst=frame0 registration should estimate.
    """
    if scene is None:
        scene = default_scene()
    dev = scene.sphere_centers.device
    T_c0_c1 = se3.exp(torch.as_tensor(motion_twist, dtype=torch.float32, device=dev))
    depth0 = render_depth(intr, se3.identity(device=dev), scene)
    depth1 = render_depth(intr, T_c0_c1, scene)
    return depth0, depth1, T_c0_c1


def poses_from_twists(twists: torch.Tensor) -> torch.Tensor:
    """Integrate per-step twists (F-1, 6) into world poses (F, 4, 4) from
    identity."""
    poses = [se3.identity(device=twists.device)]
    for i in range(twists.shape[0]):
        poses.append(se3.compose(poses[-1], se3.exp(twists[i])))
    return torch.stack(poses)


def _random_walk_poses(num_frames: int, seed: int, step_scale: float, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    twists = step_scale * torch.randn((num_frames - 1, 6), generator=g, dtype=torch.float32)
    twists[:, 3:] *= 0.5  # damp rotations vs translations
    return poses_from_twists(twists.to(device))


def render_trajectory(
    intr: camera.Intrinsics,
    num_frames: int,
    scene: Scene | None = None,
    seed: int = 0,
    step_scale: float = 0.02,
    poses: torch.Tensor | None = None,
    device="cpu",
):
    """Render a smooth random-walk trajectory (or a scripted `poses` one)
    on ``device`` (the scene's device when a scene is given).

    Returns (depths (F, H, W), poses_wc (F, 4, 4)).
    """
    if scene is None:
        scene = default_scene(device=device)
    dev = scene.sphere_centers.device
    if poses is None:
        poses = _random_walk_poses(num_frames, seed, step_scale, dev)
    poses = poses.to(dev)
    depths = torch.stack([render_depth(intr, T, scene) for T in poses])
    return depths, poses
