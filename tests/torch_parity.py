"""Shared inputs for the JAX-vs-port parity tests (tests/test_torch_*.py).

Scenes are drawn with numpy from a seed and rendered once by the port's
raycaster; the resulting f32 numpy frames feed both packages, so the two
sides always see identical inputs. (conftest.py turns on jax_enable_x64;
every array handed to JAX here is f32.)
"""

import jax.numpy as jnp
import numpy as np
import torch

from realsensetracker_tpu.geometry import camera as jcam
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.geometry import camera, se3

# pytest-xdist runs 6 workers on 8 cores: keep each one to a few threads.
torch.set_num_threads(2)


def intrinsics(h, w, fx, fy=None):
    """The same pinhole model as a JAX and as a port Intrinsics."""
    args = dict(fx=fx, fy=fy or fx, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
    return jcam.Intrinsics(**args), camera.Intrinsics(**args)


def scene(seed=0, num_spheres=12):
    """The port's Scene, drawn with numpy (same ranges as default_scene)."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array([-1.5, -0.8, 1.0]), np.array([1.5, 1.0, 3.5])
    centers = lo + (hi - lo) * rng.rand(num_spheres, 3)
    radii = 0.15 + 0.30 * rng.rand(num_spheres)
    return synthetic.Scene(
        sphere_centers=torch.tensor(centers, dtype=torch.float32),
        sphere_radii=torch.tensor(radii, dtype=torch.float32),
    )


def render(intr, poses, seed=0) -> np.ndarray:
    """f32 depth frames (F, H, W) of scene(seed) from poses (F, 4, 4)."""
    sc = scene(seed)
    poses = torch.as_tensor(np.asarray(poses, np.float32))
    return np.stack([synthetic.render_depth(intr, T, sc).numpy() for T in poses])


def pair(intr, twist, seed=0):
    """(src depth, dst depth, T_true): src is the camera displaced by twist."""
    T = se3.exp(torch.tensor(twist, dtype=torch.float32)).numpy()
    d = render(intr, np.stack([np.eye(4, dtype=np.float32), T]), seed)
    return d[1], d[0], T


def j32(a):
    return jnp.asarray(np.asarray(a, np.float32))


def twist_gap(Ta, Tb) -> float:
    """Max |twist| of Ta^-1 Tb for two 4x4 poses (numpy, JAX or torch)."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    return se3.log(torch.from_numpy((np.linalg.inv(Ta) @ Tb).astype(np.float32))).abs().max().item()


def pose(twist) -> np.ndarray:
    """The f32 (4, 4) pose exp(twist) of a 6-vector [v, w]."""
    return se3.exp(torch.tensor(twist, dtype=torch.float32)).numpy()


def apply_pose(T, pts) -> np.ndarray:
    """f32 points (N, 3) moved by a (4, 4) pose, the product in f64."""
    return (pts.astype(np.float64) @ T[:3, :3].T.astype(np.float64) + T[:3, 3]).astype(np.float32)


# --- dense mapping -------------------------------------------------------------

# The submap tests' volume (tests/test_submaps.py:30-32): a 2.4 m cube of 5 cm
# voxels, 48^3, with the 80x60 camera of tests/test_tsdf.py:17-20.
DENSE_VOL = dict(resolution=48, voxel_size=0.05, origin=(-1.2, -1.2, -0.2625), trunc=0.15, max_range=3.0,
                 max_depth=4.0)
DENSE_ICP = dict(iters=(3, 3), inner_iters=2, samples=768, min_samples=192)


def dense_configs(**overrides):
    """(JAX TsdfConfig, port TsdfConfig) of DENSE_VOL with ``overrides``."""
    from realsensetracker_tpu.mapping import tsdf as jtsdf
    from realsensetracker_tpu_torch.mapping import tsdf as ptsdf

    kw = {**DENSE_VOL, **overrides}
    return jtsdf.TsdfConfig(**kw), ptsdf.TsdfConfig(**kw)


def walk(n, step=(0.01, -0.005, 0.015, 0.004, 0.006, -0.003)):
    """(n, 4, 4) f32 poses exp(i * step): a smooth short walk."""
    return np.stack([pose([i * s for s in step]) for i in range(n)])


def render_rgbd(intr, poses, seed=0):
    """(depths (F, H, W), colors (F, H, W, 3)) f32 of scene(seed) with its
    default albedo."""
    sc = scene(seed)
    frames = [synthetic.render_rgbd(intr, torch.as_tensor(np.asarray(T, np.float32)), sc) for T in poses]
    return np.stack([d.numpy() for d, _ in frames]), np.stack([c.numpy() for _, c in frames])


def look_at(forward, pos) -> np.ndarray:
    """world_from_cam (4, 4) f32 at ``pos`` with the camera's +z along
    ``forward`` (an exact axis gives a rotation of 0s and 1s)."""
    f = np.asarray(forward, np.float64)
    f = f / np.linalg.norm(f)
    helper = np.array([0.0, 1.0, 0.0]) if abs(f[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    x = np.cross(helper, f)
    x = x / np.linalg.norm(x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, np.cross(f, x), f], 1)
    T[:3, 3] = pos
    return T.astype(np.float32)


def adversarial_poses(cfg, n: int, seed: int = 0) -> np.ndarray:
    """(n, 4, 4) f32 world_from_cam poses that stress the integrate's brick
    cull in the volume of ``cfg``, in turn: on a brick corner inside the
    volume looking exactly along an axis (frustum planes on voxel planes),
    on a face of the volume looking along it (grazing), outside looking in,
    and anywhere in or around it at a random tilt (chip_smoke.py draws the
    same poses for the card)."""
    rng = np.random.RandomState(seed)
    v, vs = cfg.resolution, cfg.voxel_size
    lo, ext = np.array(cfg.origin, np.float64), cfg.resolution * cfg.voxel_size
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    poses = []
    for k in range(n):
        if k % 4 == 0:
            corner = np.array([8 * rng.randint(-(-v // 8) + 1), 8 * rng.randint(-(-v // 8) + 1),
                               32 * rng.randint(-(-v // 32) + 1)])
            pos, fwd = lo + np.minimum(corner, v) * vs, axes[rng.randint(6)]
        elif k % 4 == 1:
            a = rng.randint(3)
            pos = lo + ext * rng.rand(3)
            pos[a] = lo[a] + ext * rng.randint(2)
            fwd = axes[(a + 1 + rng.randint(2)) % 3] * rng.choice([-1.0, 1.0])
        elif k % 4 == 2:
            d = rng.randn(3)
            pos = lo + ext / 2 + d / np.linalg.norm(d) * ext * rng.uniform(0.6, 1.5)
            fwd = lo + ext / 2 - pos + 0.1 * ext * rng.randn(3)
        else:
            pos, fwd = lo + ext * rng.uniform(-0.2, 1.2, 3), rng.randn(3)
        poses.append(look_at(fwd, pos))
    return np.stack(poses)


def volumes_close(jvol, pvol, atol=1e-6):
    """Assert a JAX and a port TsdfVolume agree: the observed masks equal,
    weights equal, tsdf (and color planes) within atol."""
    np.testing.assert_array_equal(np.asarray(jvol.weight) > 0, pvol.weight.numpy() > 0)
    np.testing.assert_array_equal(np.asarray(jvol.weight), pvol.weight.numpy())
    np.testing.assert_allclose(pvol.tsdf.numpy(), np.asarray(jvol.tsdf), rtol=0, atol=atol)
    if jvol.color is not None:
        np.testing.assert_array_equal(np.asarray(jvol.color_weight), pvol.color_weight.numpy())
        np.testing.assert_allclose(pvol.color.numpy(), np.asarray(jvol.color), rtol=0, atol=atol)


def tracked_volumes_close(jvol, pvol, atol=1e-4, max_parted=1e-4):
    """Assert the volumes of two tracker runs agree: poses that part by
    ~1e-7 (the ICP's sums) move a voxel across the update predicate or onto
    the next pixel now and then, so at most ``max_parted`` of the voxels may
    differ in weight or by more than ``atol`` in tsdf."""
    jw, pw = np.asarray(jvol.weight), pvol.weight.numpy()
    parted = (jw != pw) | (np.abs(pvol.tsdf.numpy() - np.asarray(jvol.tsdf)) > atol)
    assert parted.mean() <= max_parted, f"{int(parted.sum())} voxels parted"


# --- host I/O --------------------------------------------------------------------


def block_jax_native(mp) -> None:
    """Keep the JAX package from building or loading its native library
    (native/build/, built by cmake with no lock): its loaders raise OSError,
    so JAX reads clips through read_clip_py and PNGs through PIL. ``mp`` is
    a pytest MonkeyPatch; undo() restores the loaders."""
    import realsensetracker_tpu.native as jnative
    from realsensetracker_tpu.data import recorded as jrecorded
    from realsensetracker_tpu.native import clip_io, png_io, voxel_map

    def refuse(*args, **kwargs):
        raise OSError("the JAX package's native library stays unbuilt in the port's tests")

    for mod in (jnative, clip_io, png_io, voxel_map):
        mp.setattr(mod, "load", refuse)
    mp.setattr(jrecorded, "_NATIVE_CLIP_IO", None)
