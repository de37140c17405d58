"""Parity of the port's geometry, synthetic renderer, depth units and
trajectory tools with the JAX package, on the same f32 numpy inputs.

camera and se3 agree to ~1e-6 (both sides f32), including the
small-angle Taylor branches of exp/log.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from realsensetracker_tpu.data import depth_units as jdu
from realsensetracker_tpu.data import synthetic as jsyn
from realsensetracker_tpu.geometry import camera as jcam
from realsensetracker_tpu.geometry import se3 as jse3
from realsensetracker_tpu.tracking import trajectory as jtraj
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.data import depth_units, synthetic
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.tracking import trajectory
from tests.torch_parity import intrinsics, j32, scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


def _twists(seed, n, rot_scale, trans_scale=0.5):
    rng = np.random.RandomState(seed)
    tw = rng.randn(n, 6).astype(np.float32)
    tw[:, :3] *= trans_scale
    tw[:, 3:] *= rot_scale
    return tw


# Rotation magnitudes on both sides of the Taylor switches (theta^2 < 1e-4
# in exp, theta < 1e-2 in log), plus exact zero.
SCALES = [0.0, 1e-4, 3e-3, 0.3, 1.5]


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=atol)


@pytest.mark.parametrize("scale", SCALES)
def test_exp_log_match_jax(scale):
    tw = _twists(int(scale * 1e4), 16, scale)
    T = se3.exp(torch.from_numpy(tw))
    _close(T, jse3.exp(j32(tw)))
    _close(se3.exp_so3(torch.from_numpy(tw[:, 3:])), jse3.exp_so3(j32(tw[:, 3:])))
    Tn = T.numpy()
    # log near pi is ill-conditioned in f32; compare on the JAX side's input.
    _close(se3.log(torch.from_numpy(Tn)), jse3.log(j32(Tn)), atol=5e-6)
    _close(se3.log_so3(torch.from_numpy(Tn[:, :3, :3])), jse3.log_so3(j32(Tn[:, :3, :3])), atol=5e-6)


def test_group_ops_match_jax():
    Ta = se3.exp(torch.from_numpy(_twists(1, 8, 0.7))).numpy()
    Tb = se3.exp(torch.from_numpy(_twists(2, 8, 0.7))).numpy()
    pts = np.random.RandomState(3).randn(8, 50, 3).astype(np.float32)
    ta, tb, tp = (torch.from_numpy(x) for x in (Ta, Tb, pts))
    _close(se3.compose(ta, tb), jse3.compose(j32(Ta), j32(Tb)))
    _close(se3.inverse(ta), jse3.inverse(j32(Ta)))
    _close(se3.transform_points(ta, tp), jse3.transform_points(j32(Ta), j32(pts)), atol=5e-6)
    _close(
        se3.transform_points_t(ta[0], tp[0].T),
        jse3.transform_points_t(j32(Ta[0]), j32(pts[0].T)),
        atol=5e-6,
    )
    _close(se3.hat(tp[0]), jse3.hat(j32(pts[0])))
    _close(se3.from_rt(ta[:, :3, :3], ta[:, :3, 3]), jse3.from_rt(j32(Ta[:, :3, :3]), j32(Ta[:, :3, 3])))
    _close(se3.identity(), jse3.identity())


def test_orthonormalize_and_accumulate_match_jax():
    Ta = se3.exp(torch.from_numpy(_twists(4, 8, 0.7))).numpy()
    Tb = se3.exp(torch.from_numpy(_twists(5, 8, 0.1))).numpy()
    noisy = Ta.copy()
    noisy[:, :3, :3] += 1e-3 * np.random.RandomState(6).randn(8, 3, 3).astype(np.float32)
    got = se3.orthonormalize(torch.from_numpy(noisy))
    _close(got, jse3.orthonormalize(j32(noisy)), atol=2e-6)
    R = got[:, :3, :3]
    torch.testing.assert_close(R @ R.transpose(1, 2), torch.eye(3).expand(8, 3, 3), rtol=0, atol=2e-6)
    assert (torch.linalg.det(R) > 0).all()
    _close(se3.accumulate(torch.from_numpy(Ta), torch.from_numpy(Tb)), jse3.accumulate(j32(Ta), j32(Tb)), atol=2e-6)


def test_orthonormalize_flips_reflection_like_jax():
    refl = np.diag([1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    _close(se3.orthonormalize(torch.from_numpy(refl)), jse3.orthonormalize(j32(refl)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quaternions_match_jax(seed):
    R = se3.exp(torch.from_numpy(_twists(seed, 16, 2.0)))[:, :3, :3].numpy()
    q = se3.quaternion_from_matrix(torch.from_numpy(R))
    _close(q, jse3.quaternion_from_matrix(j32(R)), atol=2e-6)
    _close(se3.matrix_from_quaternion(q), jse3.matrix_from_quaternion(j32(q.numpy())), atol=2e-6)


@pytest.mark.parametrize("factor", [0.5, 0.25])
def test_intrinsics_match_jax(factor):
    jintr, intr = intrinsics(487, 641, 300.0, 310.0)
    assert tuple(intr.scaled(factor)) == tuple(jintr.scaled(factor))
    assert tuple(intr.halved()) == tuple(jintr.halved())
    assert tuple(camera.TUM_FR1) == tuple(jcam.TUM_FR1)
    assert tuple(camera.TUM_DEFAULT) == tuple(jcam.TUM_DEFAULT)
    assert interop.intrinsics_from_jax(jintr) == intr


def test_camera_ops_match_jax():
    jintr, intr = intrinsics(48, 64, 100.0, 110.0)
    rng = np.random.RandomState(0)
    depth = (0.5 + 3 * rng.rand(48, 64)).astype(np.float32)
    depth[rng.rand(48, 64) < 0.1] = 0.0
    depth[0, :3] = [np.nan, -1.0, np.inf]
    got_v = camera.unproject_depth(torch.from_numpy(depth), intr)
    ref_v = jcam.unproject_depth(j32(depth), jintr)
    _close(got_v, ref_v, atol=2e-6)
    np.testing.assert_array_equal(
        camera.valid_mask(torch.from_numpy(depth), 0.05, 3.0).numpy(),
        np.asarray(jcam.valid_mask(j32(depth), 0.05, 3.0)),
    )
    pts = rng.randn(200, 3).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.1
    pts[0, 2] = 0.0  # the z_safe guard
    for g, r in zip(camera.project(torch.from_numpy(pts), intr), jcam.project(j32(pts), jintr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-6)
    u, v, _ = camera.project(torch.from_numpy(pts), intr)
    ju, jv, _ = jcam.project(j32(pts), jintr)
    np.testing.assert_array_equal(
        camera.in_bounds(u, v, intr, 1.0).numpy(), np.asarray(jcam.in_bounds(ju, jv, jintr, 1.0))
    )


def test_render_depth_matches_jax_on_same_scene():
    jintr, intr = intrinsics(45, 60, 60.0)
    sc = scene(seed=2)
    jscene = jsyn.Scene(sphere_centers=j32(sc.sphere_centers), sphere_radii=j32(sc.sphere_radii))
    T = se3.exp(torch.tensor([0.05, -0.02, 0.1, 0.02, -0.03, 0.01])).numpy()
    got = synthetic.render_depth(intr, torch.from_numpy(T), sc)
    ref = jsyn.render_depth(jintr, j32(T), jscene)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_poses_from_twists_matches_jax():
    tw = _twists(7, 5, 0.05, 0.05)
    _close(synthetic.poses_from_twists(torch.from_numpy(tw)), jsyn.poses_from_twists(j32(tw)), atol=2e-6)


def test_default_scene_and_trajectory_are_seeded():
    a = synthetic.default_scene(seed=5)
    b = synthetic.default_scene(seed=5)
    torch.testing.assert_close(a.sphere_centers, b.sphere_centers, rtol=0, atol=0)
    assert ((a.sphere_radii >= 0.15) & (a.sphere_radii <= 0.45)).all()
    _, intr = intrinsics(12, 16, 16.0)
    d1, p1 = synthetic.render_trajectory(intr, 3, seed=1)
    d2, p2 = synthetic.render_trajectory(intr, 3, seed=1)
    assert d1.shape == (3, 12, 16) and p1.shape == (3, 4, 4)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.float32])
def test_to_meters_np_matches_jax(dtype):
    raw = (np.arange(12).reshape(3, 4) * 900).astype(dtype)
    got = depth_units.to_meters_np(raw, 2e-4)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jdu.to_meters_np(raw, 2e-4))


def _trajectories():
    poses = se3.exp(torch.from_numpy(_twists(8, 10, 0.3))).numpy()
    noisy = poses.copy()
    noisy[:, :3, 3] += 0.01 * np.random.RandomState(9).randn(10, 3)
    return poses, noisy


def test_trajectory_tum_roundtrip_and_errors_match_jax(tmp_path):
    poses, noisy = _trajectories()
    est, gt = trajectory.Trajectory(), trajectory.Trajectory()
    jest, jgt = jtraj.Trajectory(), jtraj.Trajectory()
    for i in range(10):
        est.append(0.5 * i, noisy[i]), gt.append(0.5 * i, poses[i])
        jest.append(0.5 * i, noisy[i]), jgt.append(0.5 * i, poses[i])
    assert est.to_tum() == jest.to_tum()
    est.save_tum(str(tmp_path / "est.txt"))
    back = trajectory.Trajectory.load_tum(str(tmp_path / "est.txt"))
    jback = jtraj.Trajectory.load_tum(str(tmp_path / "est.txt"))
    np.testing.assert_allclose(np.stack(back.poses), np.stack(jback.poses), atol=1e-6)
    np.testing.assert_allclose(np.stack(back.poses), noisy, atol=2e-6)
    assert trajectory.absolute_trajectory_error(est, gt) == pytest.approx(
        jtraj.absolute_trajectory_error(jest, jgt)
    )
    assert trajectory.relative_pose_error(est, gt) == pytest.approx(jtraj.relative_pose_error(jest, jgt))


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and the JAX package
    out of sys.modules (the card's machine has no JAX)."""
    code = (
        "import pkgutil, importlib, sys, realsensetracker_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'realsensetracker_tpu')]\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("kind", ["near_rotation", "reflection"])
def test_orthogonalize_matches_jax(kind):
    """The nearest rotation by SVD, U's third column flipped where
    det(U V^T) < 0 (not R's, as orthonormalize does): a reflection lands on
    the same rotation as JAX's. The reflections are stretched so that their
    singular values stand apart (the flipped singular vector is
    ill-conditioned when they nearly coincide)."""
    tw = _twists(11, 8, 0.8)
    R = se3.exp(torch.from_numpy(tw))[:, :3, :3].numpy()
    R = R + 1e-3 * np.random.RandomState(12).randn(*R.shape).astype(np.float32)
    if kind == "reflection":
        R = R * np.array([1.3, 1.0, -0.6], np.float32)
    got = se3.orthogonalize(torch.from_numpy(R))
    _close(got, jse3.orthogonalize(j32(R)), atol=2e-6)
    np.testing.assert_allclose(torch.linalg.det(got).numpy(), 1.0, atol=1e-5)


def test_intrinsics_matrix_matches_jax():
    for jintr, intr in (intrinsics(48, 64, 50.0, 55.0), (jcam.TUM_FR1, camera.TUM_FR1)):
        K = intr.matrix()
        assert K.dtype == torch.float32 and K.device.type == "cpu"
        np.testing.assert_array_equal(K.numpy(), np.asarray(jintr.matrix()))
