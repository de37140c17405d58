"""Parity of the port's trackers and Tracker facade with JAX.

Over 8 frames at 120x90, poses agree frame by frame to 1e-4 (twist of the
pose difference) for the frame-to-frame tracker with and without its world
map and for the cloud-ICP tracker, and the world maps agree in count, keys
and mask (points to 1e-5: the pose products sum in another order). A
tracker carried across from JAX state with the interop functions continues
the JAX stream to the same bars.

The frame-to-model tracker agrees exactly over its first two frames, and
over eight within MODEL_BAR. Its ICP searches a dense map with
|p|^2 + |q|^2 - 2 p.q in f32, which cannot order two model points whose
squared distances differ by less than an ulp of |p|^2 (~4e-6 m^2 at 6 m).
An ICP iteration of the port and one of JAX round the transform a few
f32 ulps apart (f64 sums in another order, another SVD), and at such a
near tie one correspondence of
~1000 then goes the other way: test_frame_to_model_parts_only_at_a_near_tie
follows one frame's ICP iteration by iteration from the same state and
shows the first flip and its gap. The flip moves the pose ~3e-5 within the
solve and up to ~5e-4 at its end; a moved pose moves a later key across a
voxel face, the maps part, and over eight frames the poses part by at most
1.6e-3 (3.0e-3 from state carried at frame 3). The cloud-ICP tracker
registers frame to frame and does not compound.

The map and cloud streams start from a generic pose: the synthetic floor
and wall, seen from the identity, put whole rows of points ON voxel faces,
where an ulp of pose decides the key.

Every port tracker here runs with device="cpu"; the default is the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.api import Tracker as JTracker
from realsensetracker_tpu.api import TrackerConfig as JTrackerConfig
from realsensetracker_tpu.api.config import AlignConfig as JAlignConfig
from realsensetracker_tpu.api.config import GicpConfig as JGicpConfig
from realsensetracker_tpu.tracking.frame_to_frame import FrameToFrameTracker as JF2F
from realsensetracker_tpu.tracking.frame_to_model import FrameToModelTracker as JF2M
from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.api import AlignConfig, GicpConfig, Tracker, TrackerConfig
from realsensetracker_tpu_torch.api import tracker as tracker_mod
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops import correspond
from realsensetracker_tpu_torch.ops.cloud import pad_to_capacity
from realsensetracker_tpu_torch.tracking.accumulator import init_map
from realsensetracker_tpu_torch.tracking import trajectory
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameToFrameTracker
from realsensetracker_tpu_torch.tracking.frame_to_model import FrameToModelTracker
from realsensetracker_tpu_torch.tracking.keyframe import KeyframeTracker
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
    tracker = FrameToFrameTracker(INTR, CFG, device="cpu")
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
    pt = Tracker(TrackerConfig(intrinsics=INTR, method="projective", projective=CFG, device="cpu"))
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
    pt = interop.frame_to_frame_state_from_jax(jt, device="cpu")
    assert pt._index == k and len(pt.trajectory) == k
    assert pt.cfg == projective.fit_levels(CFG, 90, 120) == interop.icp_config_from_jax(jt.cfg)
    results = [pt.process(d) for d in depths[k:]]
    assert [r.frame_index for r in results] == list(range(k, FRAMES))
    _assert_poses_match([r.pose for r in results], jax_poses[k:])


def test_failure_holds_pose_and_reference(stream):
    depths = stream[0]
    tracker = FrameToFrameTracker(INTR, CFG, min_inlier_fraction=0.2, device="cpu")
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


@pytest.mark.parametrize("method", ["rgbd", "tsdf"])
def test_unported_methods_name_their_roadmap_item(method):
    """Every method of the JAX facade is ported ("rgbd" in queue 1 item 8,
    "tsdf" in item 10): none is listed as missing, and each builds."""
    assert not hasattr(tracker_mod, "_NOT_PORTED")
    assert Tracker(TrackerConfig(intrinsics=INTR, method=method, device="cpu")).config.method == method


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown"):
        Tracker(TrackerConfig(intrinsics=INTR, method="nope", device="cpu"))


# --- the default device -------------------------------------------------------


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    assert device_mod.DEFAULT == "cuda" and TrackerConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = [
        lambda: Tracker(),
        lambda: Tracker(TrackerConfig(method="keyframe")),
        lambda: Tracker(TrackerConfig(method="model")),
        lambda: Tracker(TrackerConfig(method="icp")),
        lambda: Tracker(TrackerConfig(method="gicp")),
        lambda: FrameToFrameTracker(INTR),
        lambda: KeyframeTracker(INTR),
        lambda: FrameToModelTracker(INTR),
        lambda: interop.frame_to_frame_state_from_jax(JF2F(JINTR, JCFG)),
        lambda: interop.pyramid_levels_from_numpy([]),
        lambda: init_map(16),
        lambda: pad_to_capacity(np.zeros((3, 3), np.float32), 4),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert FrameToModelTracker(INTR, device="cpu").device == torch.device("cpu")


# --- the world map, frame-to-model and cloud ICP -------------------------------

MAP_CAPACITY = 8192
MODEL = dict(icp_max_iter=24, frame_capacity=1024, model_capacity=4096)
ALIGN = dict(cloud_capacity=2048, icp_max_iter=24)
MODEL_BAR = 4e-3  # frame-to-model vs JAX after the first two frames (docstring)
GICP = dict(max_outer=8, inner_iters=4, cov_k=16)
GICP_FRAMES = 4


@pytest.fixture(scope="module")
def offset_stream():
    """The stream's random walk from a generic start pose: (depths, poses)."""
    rng = np.random.RandomState(0)
    tw = (0.02 * rng.randn(FRAMES - 1, 6)).astype(np.float32)
    tw[:, 3:] *= 0.5
    start = np.array([0.013, 0.021, -0.017, 0.011, -0.007, 0.005], np.float32)
    poses = [se3.exp(torch.from_numpy(start)).numpy()]
    for t in tw:
        poses.append(poses[-1] @ se3.exp(torch.from_numpy(t)).numpy())
    poses = np.stack(poses)
    return render(INTR, poses, seed=0), poses


def _pose_errors(got, ref):
    return [
        se3.log(torch.from_numpy(np.linalg.inv(r).astype(np.float32) @ np.asarray(g, np.float32))).abs().max().item()
        for g, r in zip(got, ref)
    ]


def _assert_maps_match(got, ref):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(ref.keys))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), atol=1e-5)


def _world_map_run(depths, tracker):
    counts = []
    for d in depths:
        tracker.process(d)
        counts.append(int(tracker.world_map.count()))
    return counts


@pytest.fixture(scope="module")
def jax_world_map(offset_stream):
    jt = JF2F(JINTR, JCFG, map_capacity=MAP_CAPACITY)
    counts = _world_map_run(offset_stream[0], jt)
    return jt, counts


def test_world_map_tracker_matches_jax(offset_stream, jax_world_map):
    jt, jcounts = jax_world_map
    pt = FrameToFrameTracker(INTR, CFG, map_capacity=MAP_CAPACITY, device="cpu")
    counts = _world_map_run(offset_stream[0], pt)
    assert counts == jcounts and counts[-1] > counts[0] > 100
    _assert_poses_match(pt.trajectory.poses, jt.trajectory.poses)
    _assert_maps_match(pt.world_map, jt.world_map)


def test_world_map_through_the_facade(offset_stream, jax_world_map):
    cfg = TrackerConfig(intrinsics=INTR, projective=CFG, map_capacity=MAP_CAPACITY, device="cpu")
    pt = Tracker(cfg)
    for d in offset_stream[0]:
        pt.process(d)
    _assert_maps_match(pt.world_map, jax_world_map[0].world_map)
    assert Tracker(TrackerConfig(intrinsics=INTR, projective=CFG, device="cpu")).world_map is None


@pytest.fixture(scope="module")
def jax_model_run(offset_stream):
    jt = JF2M(JINTR, **MODEL)
    results = [jt.process(d) for d in offset_stream[0]]
    return jt, results


def test_frame_to_model_matches_jax(offset_stream, jax_model_run):
    jt, jres = jax_model_run
    pt = FrameToModelTracker(INTR, device="cpu", **MODEL)
    res, maps = [], []
    for d in offset_stream[0][:2]:
        res.append(pt.process(d))
        maps.append(pt.world_map)
    _assert_poses_match([r.pose for r in res], [r.pose for r in jres[:2]])  # exact so far
    jt2 = JF2M(JINTR, **MODEL)
    for d, m in zip(offset_stream[0][:2], maps):
        jt2.process(d)
        _assert_maps_match(m, jt2.world_map)
    res += [pt.process(d) for d in offset_stream[0][2:]]
    assert all(r.success for r in res) and all(r.success for r in jres)
    assert max(_pose_errors([r.pose for r in res], [r.pose for r in jres])) < MODEL_BAR
    assert abs(int(pt.world_map.count()) - int(jt.world_map.count())) <= 0.01 * pt.world_map.capacity
    # JAX's own bar against the truth (tests/test_tracking.py:249-251), in
    # the first camera's frame.
    truth = np.linalg.inv(offset_stream[1][0]) @ offset_stream[1][-1]
    assert np.abs(pt.pose - truth).max() < 0.05


def test_frame_to_model_parts_only_at_a_near_tie(offset_stream):
    """Frame 1 from the same JAX state, one GNC-ICP iteration at a time (mu
    is 1 over the first eight, so single iterations chain exactly): the
    transforms agree to a few ulps until one correspondence flips, and the
    two candidates of that flip lie closer than the f32 search resolves."""
    from realsensetracker_tpu.align import icp as jicp
    from realsensetracker_tpu.geometry import se3 as jse3
    from realsensetracker_tpu.ops import correspond as jcorr
    from realsensetracker_tpu.tracking import frame_to_model as jf2m
    from realsensetracker_tpu_torch.align import icp
    from realsensetracker_tpu_torch.ops import correspond
    from realsensetracker_tpu_torch.tracking import frame_to_model

    depth = offset_stream[0][1]
    jt = JF2M(JINTR, **MODEL)
    jt.process(offset_stream[0][0])
    pt = interop.frame_to_model_state_from_jax(jt, device="cpu")
    jsrc = jax.jit(jf2m._frame_cloud, static_argnums=(1, 2, 3))(depth, JINTR, 0.05, MODEL["frame_capacity"])
    src = frame_to_model.frame_cloud(torch.from_numpy(depth), INTR, 0.05, MODEL["frame_capacity"])
    np.testing.assert_array_equal(src.points.numpy(), np.asarray(jsrc.points))
    jdst, dst = jt.world_map.extract_cloud(), pt.world_map.extract_cloud()
    jx, x = jt._pose, pt._pose
    for _ in range(8):
        assert _pose_errors([x.numpy()], [np.asarray(jx)])[0] < 1e-6
        p = se3.transform_points(x, src.points)
        idx = correspond.nearest_neighbors(p, dst)[0].numpy()
        jidx = np.asarray(jcorr.nearest_neighbors(jse3.transform_points(jx, jsrc.points), jdst)[0])
        flips = np.nonzero((idx != jidx) & src.mask.numpy())[0]
        if len(flips):
            break
        x = icp.align_icp(src, dst, 1, init_transform=x).transform
        jx = jicp.align_icp(jsrc, jdst, 1, init_transform=jx).transform
    assert len(flips) == 1
    q, m = p.numpy().astype(np.float64)[flips], dst.points.numpy().astype(np.float64)
    gap = np.abs(((q - m[idx[flips]]) ** 2).sum(-1) - ((q - m[jidx[flips]]) ** 2).sum(-1))
    resolution = np.finfo(np.float32).eps * ((q**2).sum(-1) + (m[idx[flips]] ** 2).sum(-1))
    assert (gap < resolution).all()


def test_frame_to_model_through_the_facade(offset_stream, jax_model_run):
    align = AlignConfig(icp_max_iter=MODEL["icp_max_iter"])
    pt = Tracker(TrackerConfig(intrinsics=INTR, method="model", align=align, map_capacity=4096, device="cpu"))
    pt._impl.frame_capacity = MODEL["frame_capacity"]
    raw = np.round(offset_stream[0] * 1000).astype(np.uint16)  # u16 -> meters on the host
    for d in raw[:3]:
        assert pt.process(d).success
    assert pt._impl.model_capacity == 4096 and int(pt.world_map.count()) > 100


@pytest.fixture(scope="module")
def jax_icp_run(offset_stream):
    jt = JTracker(JTrackerConfig(intrinsics=JINTR, method="icp", align=JAlignConfig(**ALIGN)))
    results = [jt.process(d) for d in offset_stream[0]]
    return jt, results


def test_cloud_icp_tracker_matches_jax(offset_stream, jax_icp_run):
    jt, jres = jax_icp_run
    pt = Tracker(TrackerConfig(intrinsics=INTR, method="icp", align=AlignConfig(**ALIGN), device="cpu"))
    res = [pt.process(d) for d in offset_stream[0]]
    assert all(r.success for r in res)
    assert [r.success for r in res] == [r.success for r in jres]
    _assert_poses_match(pt.trajectory.poses, jt.trajectory.poses)
    for r, j in zip(res[1:], jres[1:]):
        assert abs(r.rmse - j.rmse) < 1e-4
    assert pt.world_map is None


@pytest.mark.parametrize("k", [1, 4])
def test_world_map_state_carried_from_jax(offset_stream, jax_world_map, k):
    depths = offset_stream[0]
    jt = JF2F(JINTR, JCFG, map_capacity=MAP_CAPACITY)
    for d in depths[:k]:
        jt.process(d)
    pt = interop.frame_to_frame_state_from_jax(jt, device="cpu")
    _assert_maps_match(pt.world_map, jt.world_map)
    for d in depths[k:]:
        pt.process(d)
    _assert_poses_match(pt.trajectory.poses, jax_world_map[0].trajectory.poses)
    _assert_maps_match(pt.world_map, jax_world_map[0].world_map)


def test_frame_to_model_state_carried_from_jax(offset_stream, jax_model_run):
    depths, k = offset_stream[0], 3
    jt = JF2M(JINTR, **MODEL)
    for d in depths[:k]:
        jt.process(d)
    pt = interop.frame_to_model_state_from_jax(jt, device="cpu")
    assert (pt.frame_capacity, pt.model_capacity, pt.icp_max_iter) == (1024, 4096, 24)
    _assert_maps_match(pt.world_map, jt.world_map)
    res = [pt.process(d) for d in depths[k:]]
    assert [r.frame_index for r in res] == list(range(k, FRAMES))
    errors = _pose_errors(pt.trajectory.poses, jax_model_run[0].trajectory.poses)
    assert max(errors[: k + 1]) < 1e-4 and max(errors) < MODEL_BAR


def test_cloud_tracker_state_carried_from_jax(offset_stream, jax_icp_run):
    depths, k = offset_stream[0], 3
    jt = JTracker(JTrackerConfig(intrinsics=JINTR, method="icp", align=JAlignConfig(**ALIGN)))
    for d in depths[:k]:
        jt.process(d)
    pt = interop.cloud_tracker_state_from_jax(jt._impl, device="cpu")
    assert pt.config.align == AlignConfig(**ALIGN) == interop.align_config_from_jax(jt.config.align)
    res = [pt.process(d) for d in depths[k:]]
    assert [r.frame_index for r in res] == list(range(k, FRAMES))
    _assert_poses_match(pt.trajectory.poses, jax_icp_run[0].trajectory.poses)


def test_align_config_defaults_match_jax():
    assert interop.align_config_from_jax(JAlignConfig()) == AlignConfig()


# --- GICP -------------------------------------------------------------------------
#
# On exact planes (the synthetic floor and wall) the plain scatter
# covariances are singular: the whitening's rsqrt of their smallest
# eigenvalue, ~f32 noise, turns ulps of M into a 9% change of the cost, and
# JAX and the port part by more than 1e-4 after one round from identical
# clouds and correspondences (test_gicp_on_exact_planes_is_ill_conditioned).
# 1 mm of depth noise, as a sensor has, makes the problem well posed.


@pytest.fixture(scope="module")
def noisy_stream(offset_stream):
    depths, poses = offset_stream
    noise = 1e-3 * np.random.RandomState(1).randn(*depths.shape)
    return np.where(depths > 0, depths + noise, 0.0).astype(np.float32)[:GICP_FRAMES], poses


def _gicp_configs(device="cpu"):
    port = TrackerConfig(intrinsics=INTR, method="gicp", align=AlignConfig(**ALIGN), gicp=GicpConfig(**GICP),
                         device=device)
    jax_ = JTrackerConfig(intrinsics=JINTR, method="gicp", align=JAlignConfig(**ALIGN), gicp=JGicpConfig(**GICP))
    return port, jax_


@pytest.fixture(scope="module")
def jax_gicp_run(noisy_stream):
    jt = JTracker(_gicp_configs()[1])
    results = [jt.process(d) for d in noisy_stream[0]]
    return jt, results


def test_gicp_tracker_matches_jax(noisy_stream, jax_gicp_run):
    jt, jres = jax_gicp_run
    pt = Tracker(_gicp_configs()[0])
    res = [pt.process(d) for d in noisy_stream[0]]
    assert all(r.success for r in res) and [r.success for r in res] == [r.success for r in jres]
    _assert_poses_match(pt.trajectory.poses, jt.trajectory.poses)
    for r, j in zip(res[1:], jres[1:]):
        # The GICP cost: 2048 whitened Huber terms at poses ~1e-6 apart.
        assert abs(r.rmse - j.rmse) <= 1e-3 * abs(j.rmse)
    truth = np.linalg.inv(noisy_stream[1][0]) @ noisy_stream[1][GICP_FRAMES - 1]
    assert np.abs(pt.pose - truth).max() < 0.05


def test_gicp_tracker_keeps_pose_on_an_empty_frame(noisy_stream):
    """An empty frame has no valid points: not ok, so the pose and the
    reference cloud are kept."""
    pt = Tracker(_gicp_configs()[0])
    pt.process(noisy_stream[0][0])
    prev = pt._impl._prev
    res = pt.process(np.zeros_like(noisy_stream[0][1]))
    assert not res.success and pt._impl._prev is prev
    np.testing.assert_array_equal(pt.pose, np.eye(4, dtype=np.float32))


def test_gicp_state_carried_from_jax(noisy_stream, jax_gicp_run):
    depths, k = noisy_stream[0], 2
    jt = JTracker(_gicp_configs()[1])
    for d in depths[:k]:
        jt.process(d)
    pt = interop.cloud_tracker_state_from_jax(jt._impl, device="cpu")
    assert pt.config.gicp == GicpConfig(**GICP) == interop.gicp_config_from_jax(jt.config.gicp)
    assert pt.config.method == "gicp"
    res = [pt.process(d) for d in depths[k:]]
    assert [r.frame_index for r in res] == list(range(k, GICP_FRAMES))
    _assert_poses_match(pt.trajectory.poses, jax_gicp_run[0].trajectory.poses)


def test_gicp_on_exact_planes_is_ill_conditioned(offset_stream, noisy_stream):
    """Frame 1 onto frame 0 from identical clouds and correspondences (one
    GICP round): on the exact renders one GN step moves the two costs 5%+
    apart (the whitening's rsqrt of a noise-level eigenvalue) and the poses
    by more than 1e-4; with 1 mm of depth noise within 5e-5."""
    from realsensetracker_tpu.align import gicp as jgicp
    from realsensetracker_tpu.api.tracker import _fused_depth_to_cloud
    from realsensetracker_tpu_torch.align import gicp
    from realsensetracker_tpu_torch.tracking.frame_to_model import frame_cloud

    gaps = []
    for depths in (offset_stream[0], noisy_stream[0]):
        jc = [_fused_depth_to_cloud(d, intr=JINTR, voxel_size=0.05, capacity=2048) for d in depths[1::-1]]
        pc = [frame_cloud(torch.from_numpy(d), INTR, 0.05, 2048) for d in depths[1::-1]]
        np.testing.assert_array_equal(pc[0].points.numpy(), np.asarray(jc[0].points))
        res = gicp.align_gicp(*pc, max_outer=1, inner_iters=4, cov_k=16)
        jres = jgicp.align_gicp(*jc, max_outer=1, inner_iters=4, cov_k=16)
        gaps.append(_pose_errors([res.transform.numpy()], [np.asarray(jres.transform)])[0])
        if depths is offset_stream[0]:
            src, dst = pc
            idx = correspond.nearest_neighbors(src.points, dst)[0]
            covs = (gicp.compute_covariances(src, 16), gicp.compute_covariances(dst, 16)[idx])
            args = (src.points, dst.points[idx], *covs, src.mask, se3.identity())
            cost = float(gicp.solve_alignment(*args, inner_iters=1)[1])
            jcost = float(jgicp.solve_alignment(*(jnp.asarray(a.numpy()) for a in args), inner_iters=1)[1])
            assert abs(cost - jcost) > 0.05 * jcost
    assert gaps[0] > 1e-4 and gaps[1] < 5e-5
