"""The SLAM layer's other cases on the port, as the JAX package tests them.

tests/test_slam.py's relocalization (192-246), u16 input, prep_scale and
host SE(3) log cases and tests/test_slam_rgbd.py::TestRgbdSlam, with the
JAX tests' scenes rendered by the JAX package and handed over as numpy;
plus process_window against per-frame processing, the power-of-two check
of keyframe_prep_scale, and a SlamTracker carried across from JAX
mid-stream (interop.slam_state_from_jax) continuing as JAX does: loop
edges equal, T within 1e-3, trajectory within 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.data import synthetic as jsynthetic
from realsensetracker_tpu.geometry import se3 as jse3
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.tracking import slam
from realsensetracker_tpu_torch.tracking.slam import SlamConfig, SlamTracker, _se3_log_np
from tests.test_slam import INTR as JINTR
from tests.test_slam import _loop_sequence
from tests.test_slam import _make_tracker as _make_jax_tracker
from tests.test_slam_rgbd import _ate_rmse, _textured_sequence
from tests.test_torch_slam import INTR, make_tracker

# pytest-xdist runs 6 workers on 8 cores: keep each one to a few threads.
torch.set_num_threads(2)

STEP = jnp.asarray([0.03, 0.0, 0.02, 0.0, 0.025, 0.0], jnp.float32)


@pytest.fixture(scope="module")
def sequence():
    depths, poses = _loop_sequence(10)
    return np.asarray(depths), np.asarray(poses)


def _twist_norm(T_a, T_b) -> float:
    return float(np.linalg.norm(se3.log(torch.from_numpy((np.linalg.inv(T_a) @ T_b).astype(np.float32))).numpy()))


def test_relocalization_recovers_from_lost_tracking():
    """Blind frames, then the camera reappears at frame 1's pose: the port
    relocalizes by robust global registration, floors the jump chain edge
    and records the verified registration as a loop edge."""
    scene = jsynthetic.default_scene(seed=21)
    poses = [jse3.identity()]
    for _ in range(3):
        poses.append(jse3.compose(poses[-1], jse3.exp(STEP)))
    reappear = [poses[1]]
    for _ in range(3):
        reappear.append(jse3.compose(reappear[-1], jse3.exp(STEP)))
    good = [np.asarray(jsynthetic.render_depth(JINTR, T, scene)) for T in poses]
    back = [np.asarray(jsynthetic.render_depth(JINTR, T, scene)) for T in reappear]
    frames = good + [np.zeros_like(good[0])] * 2 + back
    tracker = make_tracker()
    tracker._vo.max_consecutive_failures = 2
    for i, d in enumerate(frames):
        res = tracker.process(d, float(i))
    assert tracker.num_relocalizations >= 1
    assert res.success
    floor = tracker.config.reloc_odom_weight
    reloc_nodes = [k.index for k in tracker._keyframes[1:] if abs(k.odom_weight - floor) < 1e-9]
    assert reloc_nodes
    assert any(j in reloc_nodes for (_i, j, _T, _w) in tracker._loop_edges)
    assert _twist_norm(np.asarray(reappear[-1]), tracker.trajectory.poses[-1]) < 0.04


def test_u16_matches_f32_through_loop_closure(sequence):
    depths, _ = sequence
    scale = 1.0 / 5000.0
    raw = [np.asarray(d * 5000.0 + 0.5, np.uint16) for d in depths[:8]]
    quant = [r.astype(np.float32) * np.float32(scale) for r in raw]
    a, b = make_tracker(), make_tracker(depth_scale=scale)
    b._vo.depth_scale = scale
    ra = [a.process(d, float(i)) for i, d in enumerate(quant)]
    rb = [b.process(d, float(i)) for i, d in enumerate(raw)]
    assert a.keyframe_count == b.keyframe_count and a.num_loop_closures == b.num_loop_closures
    for x, y in zip(ra, rb):
        assert x.success == y.success
        np.testing.assert_allclose(x.pose, y.pose, atol=1e-5)
    np.testing.assert_allclose(a.optimize(), b.optimize(), atol=1e-4)


def test_prep_scale_2_closes_loops(sequence):
    depths, _ = sequence
    tracker = make_tracker(keyframe_prep_scale=2)
    for i, d in enumerate(depths):
        tracker.process(d, float(i))
    assert tracker.keyframe_count >= 3 and tracker.num_loop_closures >= 1


@pytest.mark.parametrize("scale", [0, 3, 6])
def test_prep_scale_must_be_a_power_of_two(sequence, scale):
    with pytest.raises(ValueError, match="power of two"):
        make_tracker(keyframe_prep_scale=scale)
    tracker = make_tracker()
    tracker.config.keyframe_prep_scale = scale  # set after construction, as the JAX tests do
    with pytest.raises(ValueError, match="power of two"):
        tracker.process(sequence[0][0], 0.0)  # the first frame is a keyframe: its prep checks


def test_host_se3_log_matches_device_log():
    rng = np.random.RandomState(0)
    for _ in range(10):
        tw = (rng.randn(6) * 0.6).astype(np.float32)
        T = se3.exp(torch.from_numpy(tw)).numpy()
        np.testing.assert_allclose(_se3_log_np(T), se3.log(torch.from_numpy(T)).numpy(), atol=1e-5)


def test_host_se3_log_small_and_near_pi_angles():
    tiny = se3.exp(torch.tensor([0.1, -0.2, 0.3, 1e-9, 0, 0])).numpy()
    np.testing.assert_allclose(_se3_log_np(tiny)[:3], [0.1, -0.2, 0.3], atol=1e-5)
    near_pi = se3.exp(torch.tensor([0, 0, 0, np.pi - 1e-8, 0, 0])).numpy()
    assert not np.isnan(_se3_log_np(near_pi)).any()


def test_process_window_matches_per_frame(sequence):
    """Promotions consumed in-scan and booked after it: the same keyframes,
    loop edges and trajectory as per-frame processing."""
    depths, _ = sequence
    per_frame, windowed = make_tracker(), make_tracker()
    per_frame.config.defer_keyframe_booking = False
    for i, d in enumerate(depths):
        per_frame.process(d, float(i))
    res = windowed.process_window(list(depths), [float(i) for i in range(10)], window=4)
    assert len(res) == 10
    assert [k.frame_index for k in windowed._keyframes] == [k.frame_index for k in per_frame._keyframes]
    assert [e[:2] for e in windowed._loop_edges] == [e[:2] for e in per_frame._loop_edges]
    np.testing.assert_allclose(np.stack(windowed.trajectory.poses), np.stack(per_frame.trajectory.poses), atol=1e-5)


def _rgb_config(**kw):
    cfg = SlamConfig(intrinsics=INTR, use_rgb=True, rgbd=RgbdIcpConfig(iters=(5, 5, 6), samples=1024),
                     loop_min_separation=3, keyframe_cloud_capacity=1024, device="cpu", **kw)
    cfg.align.fpfh_max_neighbors = 32
    return cfg


def test_use_rgb_tracks_and_keyframes():
    depths, grays, gt = (np.asarray(a) for a in _textured_sequence(6))
    tracker = SlamTracker(_rgb_config())
    tracker._vo.max_translation = 1e-6
    tracker._vo.max_rotation = 1e-6
    for i in range(6):
        assert tracker.process(depths[i], float(i), gray=grays[i]).success
    assert tracker.keyframe_count >= 5
    assert _ate_rmse(tracker.trajectory.poses, gt) < 5e-3
    opt = tracker.optimize()
    assert opt is not None and np.isfinite(opt).all()


def test_use_rgb_requires_gray():
    tracker = SlamTracker(_rgb_config())
    with pytest.raises(ValueError, match="gray"):
        tracker.process(np.ones((75, 100), np.float32), 0.0)
    with pytest.raises(ValueError, match="grays"):
        tracker.process_window([np.ones((75, 100), np.float32)])


def test_slam_config_from_jax_carries_every_field():
    jcfg = _make_jax_tracker().config
    cfg = interop.slam_config_from_jax(jcfg, device="cpu")
    for f in dataclasses.fields(SlamConfig):
        if f.name in ("intrinsics", "icp", "align", "rgbd", "device"):
            continue
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert tuple(cfg.intrinsics) == tuple(jcfg.intrinsics)
    assert cfg.icp.iters == tuple(jcfg.icp.iters) and cfg.align.fpfh_max_neighbors == 32
    assert cfg.device == "cpu"


def test_slam_state_carried_from_jax_continues_the_stream(sequence):
    """Six frames in JAX, then the same four frames in JAX and in the port
    (slam_state_from_jax): the revisit's loop edges, the trajectory and the
    optimized poses agree."""
    depths, _ = sequence
    jt = _make_jax_tracker()
    for i in range(6):
        jt.process(depths[i], float(i))
    pt = interop.slam_state_from_jax(jt, device="cpu")
    assert pt.keyframe_count == jt.keyframe_count == 6 and len(pt._db) == 6
    for i in range(6, 10):
        jt.process(depths[i], float(i))
        pt.process(depths[i], float(i))
    assert pt.num_loop_closures == jt.num_loop_closures >= 1
    assert [e[:2] for e in pt._loop_edges] == [e[:2] for e in jt._loop_edges]
    for a, b in zip(pt._loop_edges, jt._loop_edges):
        np.testing.assert_allclose(a[2], np.asarray(b[2]), atol=1e-3)
    np.testing.assert_allclose(np.stack(pt.trajectory.poses), np.stack(jt.trajectory.poses), atol=1e-4)
    np.testing.assert_allclose(pt.optimize(), jt.optimize(), atol=1e-4)


def test_prep_functions_take_raw_frames_on_the_device(sequence):
    """u16 frames convert to meters inside the prep (depth_scale), as the
    JAX prep does: the same cloud as from the quantized meters."""
    depths, _ = sequence
    raw = np.asarray(depths[2] * 5000.0 + 0.5, np.uint16)
    quant = raw.astype(np.float32) * np.float32(1.0 / 5000.0)
    kw = dict(intr=INTR, voxel_size=0.05, capacity=1024)
    a = slam._keyframe_prep_cloud(slam._device_frame(raw, "cpu"), depth_scale=1.0 / 5000.0, **kw)
    b = slam._keyframe_prep_cloud(slam._device_frame(quant, "cpu"), **kw)
    assert torch.equal(a.points, b.points) and torch.equal(a.mask, b.mask)


def test_slam_entry_points_default_to_the_card(monkeypatch):
    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.optimize import pose_graph

    jt = _make_jax_tracker()
    _, est, loops = synthetic.lap_graph(1, 8, loop_every=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = [
        lambda: SlamTracker(),
        lambda: SlamTracker(SlamConfig(intrinsics=INTR)),
        lambda: pose_graph.from_trajectory(est, loop_edges=loops),
        lambda: interop.slam_state_from_jax(jt),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_verifier_rejects_wrong_loops_without_odometry_gate():
    """tests/test_slam.py's seed-9 scene: self-similar spheres give
    confidently wrong global registrations; with the odometry gate off, the
    symmetric-overlap check alone must reject them and keep true revisits."""
    scene = jsynthetic.default_scene(seed=9)
    poses = [jse3.identity()]
    for tw in [STEP] * 5 + [-STEP] * 4:
        poses.append(jse3.compose(poses[-1], jse3.exp(tw)))
    depths = [np.asarray(jsynthetic.render_depth(JINTR, T, scene)) for T in poses]
    tracker = make_tracker(loop_odometry_gate=1e9)
    for i, d in enumerate(depths):
        tracker.process(d, float(i))
    assert tracker.num_loop_closures >= 1
    P = np.stack([np.asarray(T) for T in poses])
    for i, j, T, _w in tracker._loop_edges:
        err = _twist_norm(np.asarray(T), np.linalg.inv(P[i]) @ P[j])
        assert err < 0.05, f"wrong loop edge {i}<-{j} accepted (err {err:.3f})"


@pytest.mark.parametrize("capacity", [256, 8192], ids=["overflow", "underflow"])
def test_keyframe_prep_capacity_is_uniform_or_exact(capacity):
    """Over capacity the cloud keeps evenly spaced survivors (spanning the
    scene's x extent, where a head slice would keep only the low-x voxels);
    under it, every survivor once."""
    depth = np.asarray(jsynthetic.render_depth(JINTR, jse3.identity(), jsynthetic.default_scene(seed=3)))
    kw = dict(intr=INTR, voxel_size=0.02, normal_k=8, feature_radius=0.5, max_neighbors=16)
    full, _, _ = slam._fused_keyframe_prep(torch.from_numpy(depth), capacity=8192, **kw)
    full_pts = full.points.numpy()[full.mask.numpy()]
    cloud, feats, _ = slam._fused_keyframe_prep(torch.from_numpy(depth), capacity=capacity, **kw)
    m = cloud.mask.numpy()
    pts = cloud.points.numpy()[m]
    if capacity < len(full_pts):
        assert m.sum() == capacity
        lo, hi = full_pts[:, 0].min(), full_pts[:, 0].max()
        span = hi - lo
        assert pts[:, 0].min() < lo + 0.15 * span and pts[:, 0].max() > hi - 0.15 * span
        assert full_pts[:capacity, 0].max() < hi - 0.15 * span  # a head slice would miss the far end
    else:
        assert 0 < m.sum() < capacity and np.unique(pts, axis=0).shape[0] == m.sum()
    assert np.isfinite(feats.numpy()[m]).all()
