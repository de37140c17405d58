"""The port's tracker and SLAM checkpoints, and their exchange with the JAX
package's (one npz layout: the port's B = 1 pyramid levels are squeezed
on save and restored on load).

The halves of tests/test_streams_checkpoint.py on tracker and SLAM state,
on the port: a snapshot restores into a fresh tracker that continues as
the original does (1e-6 within one package); a snapshot written by JAX's
save_tracker / save_slam loads into the port, which then continues as JAX
continues (poses 1e-4, the same loop closures); one written by the port
loads into JAX alike. TSDF and submap checkpoints raise until the dense
modules are ported.
"""

import os

import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import projective as jprojective
from realsensetracker_tpu.data import synthetic as jsynthetic
from realsensetracker_tpu.tracking import checkpoint as jcheckpoint
from realsensetracker_tpu.tracking.frame_to_frame import FrameToFrameTracker as JFrameToFrameTracker
from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu_torch.tracking import checkpoint
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameToFrameTracker
from realsensetracker_tpu_torch.tracking.slam import SlamConfig, SlamTracker
from tests.test_slam import INTR as JINTR
from tests.test_slam import _loop_sequence
from tests.test_slam import _make_tracker as _make_jax_slam
from tests.test_slam_rgbd import _textured_sequence
from tests.test_torch_slam import INTR, make_tracker

# pytest-xdist runs 6 workers on 8 cores: keep each one to a few threads.
torch.set_num_threads(2)

CFG = ProjectiveIcpConfig(iters=(5, 5, 6), samples=1024)
JCFG = jprojective.ProjectiveIcpConfig(iters=(5, 5, 6), samples=1024)


@pytest.fixture(scope="module")
def frames():
    """Three frames of tests/test_streams_checkpoint.py's stream 0."""
    scene = jsynthetic.default_scene(seed=10)
    d, _ = jsynthetic.render_trajectory(JINTR, 3, scene=scene, seed=0, step_scale=0.015)
    return np.asarray(d)


@pytest.fixture(scope="module")
def sequence():
    depths, _ = _loop_sequence(10)
    return np.asarray(depths)


def _f2f(map_capacity=4096):
    return FrameToFrameTracker(INTR, CFG, map_capacity=map_capacity, device="cpu")


def test_tracker_roundtrip_resumes(frames, tmp_path):
    t1 = _f2f()
    t1.process(frames[0], 0.0)
    t1.process(frames[1], 1.0)
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save_tracker(path, t1)
    t2 = _f2f()
    checkpoint.load_tracker(path, t2)
    assert t2._index == t1._index and len(t2.trajectory) == 2
    np.testing.assert_array_equal(t2.pose, t1.pose)
    assert int(t2.world_map.count()) == int(t1.world_map.count())
    np.testing.assert_allclose(t1.process(frames[2], 2.0).pose, t2.process(frames[2], 2.0).pose, atol=1e-6)


def test_jax_tracker_checkpoint_resumes_in_the_port(frames, tmp_path):
    jt = JFrameToFrameTracker(JINTR, JCFG, map_capacity=4096)
    jt.process(frames[0], 0.0)
    jt.process(frames[1], 1.0)
    path = os.path.join(tmp_path, "jax.npz")
    jcheckpoint.save_tracker(path, jt)
    pt = _f2f()
    checkpoint.load_tracker(path, pt)
    assert pt._prev_levels[0].vertex_map.shape[0] == 1  # the batch dim restored
    np.testing.assert_allclose(pt.process(frames[2], 2.0).pose, np.asarray(jt.process(frames[2], 2.0).pose),
                               atol=1e-4)
    assert int(pt.world_map.count()) == int(jt.world_map.count())


def test_port_tracker_checkpoint_resumes_in_jax(frames, tmp_path):
    pt = _f2f()
    pt.process(frames[0], 0.0)
    pt.process(frames[1], 1.0)
    path = os.path.join(tmp_path, "port.npz")
    checkpoint.save_tracker(path, pt)
    data = np.load(path)
    assert data["level0_vertex"].shape == (75, 100, 3) and data["level0_packed"].shape == (4, 75, 100)
    jt = JFrameToFrameTracker(JINTR, JCFG, map_capacity=4096)
    jcheckpoint.load_tracker(path, jt)
    np.testing.assert_allclose(np.asarray(jt.process(frames[2], 2.0).pose), pt.process(frames[2], 2.0).pose,
                               atol=1e-4)


def test_map_config_mismatch_raises(frames, tmp_path):
    t1 = _f2f(map_capacity=0)
    t1.process(frames[0], 0.0)
    t1.process(frames[1], 1.0)
    path = os.path.join(tmp_path, "nomap.npz")
    checkpoint.save_tracker(path, t1)
    with pytest.raises(ValueError, match="world model"):
        checkpoint.load_tracker(path, _f2f())


def test_version_check(tmp_path):
    path = os.path.join(tmp_path, "bad.npz")
    np.savez(path, format_version=np.int64(999), frame_index=np.int64(0), traj_timestamps=np.zeros(0),
             traj_poses=np.zeros((0, 4, 4)))
    with pytest.raises(ValueError, match="version"):
        checkpoint.load_tracker(path, _f2f())


def test_v3_compatible_snapshot_loads(frames, tmp_path):
    t1 = _f2f()
    t1.process(frames[0], 0.0)
    t1.process(frames[1], 1.0)
    path = os.path.join(tmp_path, "v3.npz")
    checkpoint.save_tracker(path, t1)
    data = dict(np.load(path, allow_pickle=False))
    data["format_version"] = np.int64(3)
    np.savez(path, **data)
    t2 = _f2f()
    checkpoint.load_tracker(path, t2)
    np.testing.assert_allclose(t1.process(frames[2], 2.0).pose, t2.process(frames[2], 2.0).pose, atol=1e-6)
    data["num_levels"] = np.int64(int(data["num_levels"]) + 1)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="re-record"):
        checkpoint.load_tracker(path, _f2f())


def _continue(tracker, depths, start):
    return [tracker.process(depths[i], float(i)).pose for i in range(start, len(depths))]


def test_jax_slam_checkpoint_resumes_in_the_port(sequence, tmp_path):
    """JAX's SlamTracker over 6 frames, save_slam; the port loads it and
    both go on over frames 6-9: poses within 1e-4, the revisit closed in
    both, the same loop edges."""
    jt = _make_jax_slam()
    for i in range(6):
        jt.process(sequence[i], float(i))
    path = os.path.join(tmp_path, "slam_jax.npz")
    jcheckpoint.save_slam(path, jt)
    pt = make_tracker()
    checkpoint.load_slam(path, pt)
    assert pt.keyframe_count == jt.keyframe_count and len(pt._db) == len(jt._db)
    assert len(pt.trajectory) == len(jt.trajectory)
    np.testing.assert_allclose(_continue(pt, sequence, 6), np.stack(_continue(jt, sequence, 6)), atol=1e-4)
    assert pt.num_loop_closures == jt.num_loop_closures >= 1
    assert [e[:2] for e in pt._loop_edges] == [e[:2] for e in jt._loop_edges]


def test_port_slam_checkpoint_resumes_in_jax(sequence, tmp_path):
    pt = make_tracker()
    for i in range(6):
        pt.process(sequence[i], float(i))
    path = os.path.join(tmp_path, "slam_port.npz")
    checkpoint.save_slam(path, pt)
    jt = _make_jax_slam()
    jcheckpoint.load_slam(path, jt)
    assert jt.keyframe_count == pt.keyframe_count == 6
    np.testing.assert_allclose(np.stack(_continue(jt, sequence, 6)), _continue(pt, sequence, 6), atol=1e-4)
    assert jt.num_loop_closures == pt.num_loop_closures >= 1


def test_slam_version_check(tmp_path):
    path = os.path.join(tmp_path, "bad.npz")
    np.savez(path, slam_version=np.int64(999), format_version=np.int64(1))
    with pytest.raises(ValueError, match="slam checkpoint version"):
        checkpoint.load_slam(path, SlamTracker(SlamConfig(intrinsics=INTR, icp=CFG, device="cpu")))


def test_rgb_slam_checkpoint_roundtrip(tmp_path):
    from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig

    depths, grays, _ = (np.asarray(a) for a in _textured_sequence(5))
    cfg = SlamConfig(intrinsics=INTR, use_rgb=True, rgbd=RgbdIcpConfig(iters=(5, 5, 6), samples=1024),
                     keyframe_cloud_capacity=1024, device="cpu")
    cfg.align.fpfh_max_neighbors = 32

    def make():
        t = SlamTracker(cfg)
        t._vo.max_translation = 1e-6
        t._vo.max_rotation = 1e-6
        return t

    a = make()
    for i in range(3):
        a.process(depths[i], float(i), gray=grays[i])
    path = str(tmp_path / "slam_rgb.npz")
    checkpoint.save_slam(path, a)
    assert np.load(path)["level0_gray"].shape == (75, 100)
    b = make()
    checkpoint.load_slam(path, b)
    for i in range(3, 5):
        ra = a.process(depths[i], float(i), gray=grays[i])
        rb = b.process(depths[i], float(i), gray=grays[i])
        np.testing.assert_allclose(ra.pose, rb.pose, atol=1e-6)
    assert b.keyframe_count == a.keyframe_count
    with pytest.raises(ValueError, match="RGB-D"):
        checkpoint.load_slam(path, SlamTracker(SlamConfig(intrinsics=INTR, device="cpu")))


@pytest.mark.parametrize("fn", ["save_tsdf", "load_tsdf", "save_submaps", "load_submaps"])
def test_dense_checkpoints_wait_for_the_dense_modules(fn, tmp_path):
    """The dense checkpoints exist since the dense modules were ported
    (tests/test_torch_tsdf_checkpoint.py holds them to JAX); handed a
    tracker that is not a dense one, each refuses it by name."""
    with pytest.raises(ValueError, match="TSDF tracker"):
        getattr(checkpoint, fn)(str(tmp_path / "x.npz"), object())
