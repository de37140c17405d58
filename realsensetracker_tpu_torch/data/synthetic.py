"""Synthetic depth rendering: an analytic raycast of a sphere/plane scene.

Port of realsensetracker_tpu/data/synthetic.py: frames rendered from two
poses admit an exact known relative transform, and the RGB-D renderer
shades every surface point the same from every view (world-anchored
albedo, texture and light), which direct RGB-D alignment relies on. Random
draws come from a ``torch.Generator``, so ``default_scene(seed)`` places
its spheres elsewhere than JAX's; to compare the two renderers, hand the
same scene arrays to both. ``lap_graph`` makes pose-graph problems
(drifted laps with exact loop edges) from a numpy seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from realsensetracker_tpu_torch.geometry import camera, se3

_INF = 1e30


class Scene(NamedTuple):
    sphere_centers: torch.Tensor  # (S, 3) world
    sphere_radii: torch.Tensor  # (S,)
    sphere_albedo: torch.Tensor | None = None  # (S, 3) base colors in [0, 1]
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
    albedo = _uniform(g, (num_spheres, 3), 0.25, 0.95)
    return Scene(sphere_centers=centers.to(device), sphere_radii=radii.to(device), sphere_albedo=albedo.to(device))


def _trace(intr: camera.Intrinsics, T_wc: torch.Tensor, scene: Scene):
    """Raycast the scene: (t_best (H,W), _INF where a ray misses; sid (H,W)
    surface id, 0..S-1 spheres, S floor, S+1 wall, S+2 miss; o (3,) the ray
    origin; w (H,W,3) world ray directions, z-depth parameterised)."""
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

    t_all = torch.cat([t_s, t_f[..., None], t_w[..., None]], dim=-1)
    t_best, sid = t_all.min(-1)  # the first minimum, as jnp.argmin
    sid = torch.where(t_best < _INF, sid, t_all.shape[-1])
    return t_best, sid, o, w


def render_depth(intr: camera.Intrinsics, T_wc: torch.Tensor, scene: Scene) -> torch.Tensor:
    """Z-depth image (H, W) of the scene from camera pose T_wc (camera->world);
    0 where a ray hits nothing."""
    t_best = _trace(intr, T_wc, scene)[0]
    return torch.where(t_best < _INF, t_best, 0.0)


_LIGHT_DIR = (0.40824829, -0.81649658, -0.40824829)
_FLOOR_ALBEDO = (0.55, 0.50, 0.40)
_WALL_ALBEDO = (0.45, 0.50, 0.60)


def _default_albedo(num_spheres: int, device=None) -> torch.Tensor:
    """Deterministic distinct sphere colors (golden-angle hue walk)."""
    i = torch.arange(num_spheres, dtype=torch.float32, device=device)
    h = (i * 0.61803398875) % 1.0
    r = 0.5 + 0.45 * torch.cos(2 * torch.pi * h)
    g = 0.5 + 0.45 * torch.cos(2 * torch.pi * (h + 1.0 / 3.0))
    b = 0.5 + 0.45 * torch.cos(2 * torch.pi * (h + 2.0 / 3.0))
    return torch.stack([r, g, b], dim=-1)


def render_rgbd(intr: camera.Intrinsics, T_wc: torch.Tensor, scene: Scene):
    """(depth (H,W), color (H,W,3) in [0,1]) from camera pose T_wc.

    Shading is world-anchored -- albedo x a smooth world-space texture x
    Lambert against a fixed world light -- so a surface point renders the
    same color from every viewpoint, and the texture gives a non-zero image
    gradient everywhere. Misses are black at depth 0.
    """
    t_best, sid, o, w = _trace(intr, T_wc, scene)
    dev = t_best.device
    f32 = dict(dtype=torch.float32, device=dev)
    hit = t_best < _INF
    t = torch.where(hit, t_best, 1.0)
    x = o + t[..., None] * w  # (H, W, 3) world hit points

    s_count = scene.sphere_centers.shape[0]
    albedo_s = scene.sphere_albedo
    if albedo_s is None:
        albedo_s = _default_albedo(s_count, dev)
    # Albedo table indexed by surface id (misses -> black).
    table = torch.cat([albedo_s, torch.tensor([_FLOOR_ALBEDO, _WALL_ALBEDO], **f32), torch.zeros((1, 3), **f32)])
    sid_c = torch.clamp(sid, 0, s_count + 2)
    base = table[sid_c]  # (H, W, 3)

    # Surface normals: spheres from the center offset, planes constant.
    centers = torch.cat([scene.sphere_centers, torch.zeros((3, 3), **f32)])
    n_sph = x - centers[sid_c]
    n_sph = n_sph / torch.clamp(torch.linalg.vector_norm(n_sph, dim=-1, keepdim=True), min=1e-9)
    n = torch.where(
        (sid < s_count)[..., None],
        n_sph,
        torch.where((sid == s_count)[..., None], torch.tensor([0.0, -1.0, 0.0], **f32),
                    torch.tensor([0.0, 0.0, -1.0], **f32)),
    )
    light = torch.tensor(_LIGHT_DIR, **f32)
    shade = 0.35 + 0.65 * torch.clamp(-(n * light).sum(-1), 0.0, 1.0)
    tex = (
        0.70
        + 0.18 * torch.sin(9.0 * x[..., 0]) * torch.cos(7.0 * x[..., 1])
        + 0.12 * torch.sin(5.0 * x[..., 2] + 2.0 * x[..., 0])
    )
    rgb = torch.clamp(base * (shade * tex)[..., None], 0.0, 1.0)
    rgb = torch.where(hit[..., None], rgb, 0.0)
    return torch.where(hit, t_best, 0.0), rgb


def intensity_from_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """Luma graylevel in [0,1] from an (..., 3) color image (BT.601)."""
    return (rgb * torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype, device=rgb.device)).sum(-1)


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


def render_trajectory_rgbd(
    intr: camera.Intrinsics,
    num_frames: int,
    scene: Scene | None = None,
    seed: int = 0,
    step_scale: float = 0.02,
    poses: torch.Tensor | None = None,
    device="cpu",
):
    """The RGB-D counterpart of render_trajectory, on the same poses for
    the same seed: (depths (F,H,W), colors (F,H,W,3), poses (F,4,4))."""
    if scene is None:
        scene = default_scene(device=device)
    dev = scene.sphere_centers.device
    if poses is None:
        poses = _random_walk_poses(num_frames, seed, step_scale, dev)
    poses = poses.to(dev)
    frames = [render_rgbd(intr, T, scene) for T in poses]
    return torch.stack([d for d, _ in frames]), torch.stack([c for _, c in frames]), poses


def lap_graph(laps: int, per_lap: int, seed: int = 3, noise: float = 0.01, loop_every: int = 20,
              step_length: float = 0.3):
    """A pose-graph problem of ``laps`` laps round a circle of ``per_lap``
    steps, as tests/test_posegraph_loops.py:96-120 builds its 1000-node
    graph (numpy seed, f32 poses): ground truth, odometry drifted by a
    twist of ``noise`` * N(0, 1) per step, and loop edges every
    ``loop_every`` nodes from each node of a later lap to the node one lap
    before, exact in the truth. Returns (gt (N,4,4), est (N,4,4), loops
    [(i, j, T_ij, 1.0)]) as numpy."""
    n = laps * per_lap
    rng = np.random.RandomState(seed)
    step = se3.exp(torch.tensor([step_length, 0, 0, 0, 0, 2 * np.pi / per_lap], dtype=torch.float32)).numpy()
    gt, est = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        gt.append((gt[-1] @ step).astype(np.float32))
        drift = se3.exp(torch.tensor(noise * rng.randn(6), dtype=torch.float32)).numpy()
        est.append((est[-1] @ step @ drift).astype(np.float32))
    gt, est = np.stack(gt), np.stack(est)
    loops = [(i - per_lap, i, (np.linalg.inv(gt[i - per_lap]) @ gt[i]).astype(np.float32), 1.0)
             for i in range(per_lap, n, loop_every)]
    return gt, est, loops
