"""Parity of the port's frame-to-frame tracker and Tracker facade with JAX.

Poses agree frame by frame to 1e-4 (twist of the pose difference) over
8 frames at 120x90, and a tracker carried across from JAX state with
interop.frame_to_frame_state_from_jax continues the JAX stream to 1e-4.
"""

import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.api import Tracker as JTracker
from realsensetracker_tpu.api import TrackerConfig as JTrackerConfig
from realsensetracker_tpu.tracking.frame_to_frame import FrameToFrameTracker as JF2F
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.tracking import trajectory
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameToFrameTracker
from tests.torch_parity import intrinsics, render

JINTR, INTR = intrinsics(90, 120, 120.0)
CFG = projective.ProjectiveIcpConfig(iters=(6, 6, 8), samples=2048)  # tests/test_tracking.py:17
JCFG = jproj.ProjectiveIcpConfig(iters=(6, 6, 8), samples=2048)
FRAMES = 8


@pytest.fixture(scope="module")
def stream():
    """(depths (F,H,W) f32, poses_wc (F,4,4)) of a seeded random walk."""
    rng = np.random.RandomState(0)
    tw = (0.02 * rng.randn(FRAMES - 1, 6)).astype(np.float32)
    tw[:, 3:] *= 0.5
    poses = [np.eye(4, dtype=np.float32)]
    for t in tw:
        poses.append(poses[-1] @ se3.exp(torch.from_numpy(t)).numpy())
    poses = np.stack(poses)
    return render(INTR, poses, seed=0), poses


@pytest.fixture(scope="module")
def jax_poses(stream):
    tracker = JF2F(JINTR, JCFG)
    return np.stack([np.asarray(tracker.process(d).pose) for d in stream[0]])


def _assert_poses_match(got, ref):
    for g, r in zip(got, ref):
        err = se3.log(torch.from_numpy(np.linalg.inv(r).astype(np.float32) @ np.asarray(g, np.float32)))
        assert err.abs().max().item() < 1e-4


def test_frame_to_frame_matches_jax(stream, jax_poses):
    tracker = FrameToFrameTracker(INTR, CFG)
    results = [tracker.process(d, timestamp=float(i)) for i, d in enumerate(stream[0])]
    assert all(r.success for r in results)
    _assert_poses_match([r.pose for r in results], jax_poses)
    gt = trajectory.Trajectory()
    for i, T in enumerate(stream[1]):
        gt.append(float(i), T)
    ate = trajectory.absolute_trajectory_error(tracker.trajectory, gt)
    assert ate["pairs"] == FRAMES and ate["rmse"] < 0.02


def test_tracker_facade_matches_jax_on_raw_depth(stream, tmp_path):
    raw = np.round(stream[0] * 1000).astype(np.uint16)  # millimetres
    jt = JTracker(JTrackerConfig(intrinsics=JINTR, method="projective", projective=JCFG))
    pt = Tracker(TrackerConfig(intrinsics=INTR, method="projective", projective=CFG))
    for i, d in enumerate(raw):
        jt.process(d, float(i))
        pt.process(d, float(i))
    _assert_poses_match(pt.trajectory.poses, jt.trajectory.poses)
    np.testing.assert_array_equal(pt.pose, pt.trajectory.poses[-1].astype(np.float32))
    path = tmp_path / "traj.txt"
    pt.save_trajectory(str(path))
    back = trajectory.Trajectory.load_tum(str(path))
    assert len(back) == FRAMES
    np.testing.assert_allclose(np.stack(back.poses), np.stack(pt.trajectory.poses), atol=1e-5)


@pytest.mark.parametrize("k", [1, 4])
def test_state_carried_from_jax_continues_the_stream(stream, jax_poses, k):
    depths = stream[0]
    jt = JF2F(JINTR, JCFG)
    for d in depths[:k]:
        jt.process(d)
    pt = interop.frame_to_frame_state_from_jax(jt)
    assert pt._index == k and len(pt.trajectory) == k
    assert pt.cfg == projective.fit_levels(CFG, 90, 120) == interop.icp_config_from_jax(jt.cfg)
    results = [pt.process(d) for d in depths[k:]]
    assert [r.frame_index for r in results] == list(range(k, FRAMES))
    _assert_poses_match([r.pose for r in results], jax_poses[k:])


def test_failure_holds_pose_and_reference(stream):
    depths = stream[0]
    tracker = FrameToFrameTracker(INTR, CFG, min_inlier_fraction=0.2)
    tracker.process(depths[0])
    tracker.process(depths[1])
    pose_before = tracker.pose.copy()
    res = tracker.process(np.zeros_like(depths[0]))
    assert not res.success
    np.testing.assert_array_equal(tracker.pose, pose_before)
    # Recovery: the next good frame registers against the HELD reference.
    assert tracker.process(depths[2]).success
    tracker.reset()
    assert len(tracker.trajectory) == 0 and tracker.process(depths[0]).frame_index == 0


def test_world_model_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        FrameToFrameTracker(INTR, CFG, map_capacity=1024)


@pytest.mark.parametrize("method", ["keyframe", "model", "icp", "gicp", "rgbd", "tsdf"])
def test_unported_methods_name_their_roadmap_item(method):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        Tracker(TrackerConfig(intrinsics=INTR, method=method))


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown"):
        Tracker(TrackerConfig(intrinsics=INTR, method="nope"))
