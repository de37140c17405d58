"""Parity of the port's SlamTracker with the JAX package's.

The scenario of tests/test_slam.py: _loop_sequence(10), an out-and-back
trajectory at 100x75 rendered once by the JAX package and handed to both
as numpy, every frame promoted to keyframe; each JAX run happens once per
module. Synchronous and deferred booking alike: keyframe frame indices
equal, loop-edge (i, j, weight) lists equal with T within 1e-3,
trajectories and optimize() poses within 1e-4. Inside the port: deferred
booking equals synchronous booking (edges 1e-6, poses 1e-6, optimized 1e-5,
as tests/test_slam.py:105-172), reads flush the pipeline, padded optimize
equals unpadded, online optimization feeds back. The first stage that
parts from JAX is FPFH's origin switch on exact planes (see the last
test): the keyframe clouds are exact at prep_scale 1 and 2.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from realsensetracker_tpu.tracking import slam as jslam
from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.tracking import slam
from realsensetracker_tpu_torch.tracking.slam import SlamConfig, SlamTracker
from tests.test_slam import INTR as JINTR
from tests.test_slam import _loop_sequence
from tests.test_slam import _make_tracker as _make_jax_tracker

# pytest-xdist runs 6 workers on 8 cores: keep each one to a few threads.
torch.set_num_threads(2)

INTR = camera.Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=37.0, width=100, height=75)
MODES = ["sync", "deferred"]


def make_tracker(force_keyframes=True, **kw):
    """The port's twin of tests/test_slam.py's _make_tracker, on the CPU."""
    cfg = SlamConfig(intrinsics=INTR, icp=ProjectiveIcpConfig(iters=(5, 5, 6), samples=1024),
                     loop_min_separation=3, loop_similarity=0.8, keyframe_cloud_capacity=1024,
                     device="cpu", **kw)
    cfg.align.fpfh_max_neighbors = 32
    tracker = SlamTracker(cfg)
    if force_keyframes:
        tracker._vo.max_translation = 1e-6
        tracker._vo.max_rotation = 1e-6
    return tracker


@pytest.fixture(scope="module")
def sequence():
    depths, poses = _loop_sequence(10)
    return np.asarray(depths), np.asarray(poses)


def _summary(tracker):
    """Everything compared, read before optimize() adopts new poses (the
    booking pipeline flushed first)."""
    tracker.flush_pending()
    return {
        "kf_frames": [k.frame_index for k in tracker._keyframes],
        "edges": [(int(i), int(j), float(w)) for i, j, _, w in tracker._loop_edges],
        "edge_T": [np.asarray(T, np.float64) for _, _, T, _ in tracker._loop_edges],
        "loops": tracker.num_loop_closures,
        "traj": np.stack(tracker.trajectory.poses),
        "tracker": copy.deepcopy(tracker) if isinstance(tracker, SlamTracker) else None,
        "opt": np.asarray(tracker.optimize()),
    }


def _run(tracker, depths, defer):
    tracker.config.defer_keyframe_booking = defer
    for i, d in enumerate(depths):
        tracker.process(d, float(i))
    return _summary(tracker)


@pytest.fixture(scope="module")
def jax_runs(sequence):
    depths, _ = sequence
    return {mode: _run(_make_jax_tracker(), depths, mode == "deferred") for mode in MODES}


@pytest.fixture(scope="module")
def port_runs(sequence):
    depths, _ = sequence
    return {mode: _run(make_tracker(), depths, mode == "deferred") for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_keyframes_and_loop_edges_match_jax(jax_runs, port_runs, mode):
    got, ref = port_runs[mode], jax_runs[mode]
    assert got["kf_frames"] == ref["kf_frames"] == list(range(10))
    assert got["edges"] == ref["edges"]
    assert got["loops"] == ref["loops"] >= 1
    for T, T_ref in zip(got["edge_T"], ref["edge_T"]):
        np.testing.assert_allclose(T, T_ref, atol=1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_trajectory_and_optimized_poses_match_jax(jax_runs, port_runs, mode):
    got, ref = port_runs[mode], jax_runs[mode]
    np.testing.assert_allclose(got["traj"], ref["traj"], atol=1e-4)
    np.testing.assert_allclose(got["opt"], ref["opt"], atol=1e-4)


def test_deferred_booking_matches_synchronous(port_runs):
    sync, deferred = port_runs["sync"], port_runs["deferred"]
    assert sync["kf_frames"] == deferred["kf_frames"]
    assert sync["edges"] == deferred["edges"] and sync["loops"] == deferred["loops"]
    for a, b in zip(sync["edge_T"], deferred["edge_T"]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(sync["traj"], deferred["traj"], atol=1e-6)
    np.testing.assert_allclose(sync["opt"], deferred["opt"], atol=1e-5)


def test_optimize_improves_the_endpoint(port_runs, sequence):
    _, gt = sequence
    tracker = port_runs["sync"]["tracker"]
    before = np.stack([k.pose for k in tracker._keyframes])
    err_before = np.linalg.norm(before[-1][:3, 3] - gt[-1][:3, 3])
    opt = port_runs["sync"]["opt"]
    assert np.isfinite(opt).all()
    assert np.linalg.norm(opt[-1][:3, 3] - gt[-1][:3, 3]) <= err_before + 1e-4


def test_padded_optimize_matches_unpadded(port_runs):
    tracker = port_runs["sync"]["tracker"]
    a, b = copy.deepcopy(tracker), copy.deepcopy(tracker)
    plain = a.optimize(gn_iters=6, cg_iters=40, pad=False)
    padded = b.optimize(gn_iters=6, cg_iters=40, pad=True)
    assert padded.shape == plain.shape == (10, 4, 4)
    np.testing.assert_allclose(padded, plain, atol=1e-5)


def test_deferred_booking_flushes_on_reads(sequence):
    depths, _ = sequence
    tracker = make_tracker()
    counts = []
    for i in range(6):
        tracker.process(depths[i], float(i))
        counts.append(tracker.keyframe_count)
    assert counts == list(range(1, 7))


def test_online_optimization_feeds_back(sequence):
    depths, gt = sequence
    tracker = make_tracker(optimize_every=2)
    for i, d in enumerate(depths):
        tracker.process(d, float(i))
    assert tracker.num_loop_closures >= 1 and tracker.num_online_optimizations >= 1
    traj = np.stack(tracker.trajectory.poses)
    assert np.isfinite(traj).all()
    assert np.linalg.norm(traj[-1][:3, 3] - gt[-1][:3, 3]) < 0.05


@pytest.mark.parametrize("prep_scale", [1, 2])
def test_keyframe_prep_parts_from_jax_first_at_the_fpfh_origin_switch(sequence, prep_scale):
    """The first stage where the SLAM path parts from JAX. The stage-A
    cloud is exact (JAX's compiled unprojection, x = d (u - cx) * (1/fx),
    voxel keys, uniform subsampling); the k-NN normals agree within 1e-6;
    FPFH computed from JAX's own normals agrees with JAX's (op by op) on
    every row within 1e-4. From the port's normals some rows part: on the
    scene's exact planes two neighbours' normals agree to an ulp, and
    FPFH's origin switch (|n1.d| < |n2.d|, fpfh.cpp:41) goes by that ulp
    (ROADMAP section 3). The pooled descriptor stays within 1e-2 and the
    loop edges downstream within 1e-3 (above)."""
    from realsensetracker_tpu.ops import fpfh as jfpfh
    from realsensetracker_tpu.ops import normals as jnormals
    from realsensetracker_tpu_torch.ops import fpfh, normals

    depths, _ = sequence
    cfg = make_tracker().config
    kw = dict(voxel_size=float(cfg.align.voxel_size), capacity=1024, prep_scale=prep_scale)
    fk = dict(normal_k=int(cfg.align.normal_k), feature_radius=float(cfg.align.feature_radius), max_neighbors=32)
    cloud, feats, desc = slam._fused_keyframe_prep(torch.from_numpy(depths[3]), intr=INTR, **kw, **fk)
    jcloud, jfeats, jdesc = jslam._fused_keyframe_prep(depths[3], intr=JINTR, **kw, **fk)
    np.testing.assert_array_equal(cloud.mask.numpy(), np.asarray(jcloud.mask))
    np.testing.assert_array_equal(cloud.points.numpy(), np.asarray(jcloud.points))
    m = cloud.mask.numpy()
    zero = np.zeros(3, np.float32)
    with jax.disable_jit():  # JAX op by op: compiled FPFH rounds its own switch ties
        jn = np.asarray(jnormals.orient_normals(jcloud.points, jnormals.knn_pca_normals(jcloud, 16), zero))
        j_same = np.asarray(jfpfh.compute_fpfh_from_normals(jcloud, jn, 0.5, 32))
    n = normals.orient_normals(cloud.points, normals.knn_pca_normals(cloud, 16), torch.zeros(3)).numpy()
    assert np.abs(n - jn)[m].max() < 1e-6
    same_normals = fpfh.compute_fpfh_from_normals(cloud, torch.from_numpy(jn), 0.5, 32).numpy()
    np.testing.assert_allclose(same_normals[m], j_same[m], atol=1e-4)
    parted = np.abs(feats.numpy() - np.asarray(jfeats)).max(-1)[m] > 1e-4
    assert 0 < parted.sum() < 0.3 * m.sum()
    assert np.abs(desc.numpy() - np.asarray(jdesc)).max() < 1e-2
    staged = slam._keyframe_prep_features(slam._keyframe_prep_cloud(torch.from_numpy(depths[3]), intr=INTR, **kw), **fk)
    assert torch.equal(staged[0], feats) and torch.equal(staged[1], desc)


def test_build_map_and_world_map(port_runs):
    tracker = port_runs["sync"]["tracker"]
    m = tracker.build_map(voxel_size=0.1, capacity=1 << 14)
    assert int(m.count()) > 100
    assert int(tracker.world_map.mask.sum()) >= int(m.count())
    # Dense re-fusion is ported (tests/test_torch_tsdf_checkpoint.py); it
    # needs the keyframe depths, which this tracker does not keep.
    with pytest.raises(ValueError, match="keep_depths"):
        tracker.build_dense()
    with pytest.raises(ValueError, match="keep_depths"):
        tracker.world_mesh()
