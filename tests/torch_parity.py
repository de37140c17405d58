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
