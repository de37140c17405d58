"""Parity of the port's submap atlas (realsensetracker_tpu_torch/mapping/submaps.py)
with the JAX package, on the CPU.

The corridor of tests/test_submaps.py:36-58 (numpy seed 3), 2 m out along
+x and back, 95 frames rendered by the port at 80x60 and fed to both sides,
in the 48^3 x 5 cm volume with the same ICP settings. Held to JAX: the
spawn and re-entry decisions (the span logs equal), the world poses within
1e-4, optimize_atlas's accepted loop edges (count equal) and the optimized
trajectory within 1e-3; held to the truth with the JAX tests' own bars
(tests/test_submaps.py:134-230).
"""

import numpy as np
import pytest
import torch

from realsensetracker_tpu.align.projective import ProjectiveIcpConfig as JIcp
from realsensetracker_tpu.mapping import submaps as JS
from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.mapping import submaps as PS
from tests.torch_parity import DENSE_ICP, dense_configs, intrinsics, j32, pose

JINTR, INTR = intrinsics(60, 80, 64.0)
JCFG, CFG = dense_configs()
F, SPAN = 48, 2.0


def _corridor_scene():
    rng = np.random.RandomState(3)
    n = 12
    cx = np.linspace(-0.5, SPAN + 1.0, n)
    centers = np.stack([cx, rng.uniform(-0.3, 0.55, n), rng.uniform(0.9, 1.6, n)], 1).astype(np.float32)
    radii = rng.uniform(0.16, 0.32, n).astype(np.float32)
    return synthetic.Scene(torch.from_numpy(centers), torch.from_numpy(radii), floor_y=0.9, wall_z=2.2)


@pytest.fixture(scope="module")
def out_and_back():
    """(depths (2F-1, 60, 80), truth poses): out along +x, then back."""
    poses = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, SPAN, F)
    poses = np.concatenate([poses, poses[::-1][1:]])
    sc = _corridor_scene()
    depths = np.stack([synthetic.render_depth(INTR, torch.from_numpy(T), sc).numpy() for T in poses])
    return depths, poses


def _atlases(**cfg):
    j = JS.SubmapTsdfTracker(JINTR, JS.SubmapConfig(volume=JCFG, **cfg), icp=JIcp(**DENSE_ICP))
    p = PS.SubmapTsdfTracker(INTR, PS.SubmapConfig(volume=CFG, **cfg), icp=ProjectiveIcpConfig(**DENSE_ICP),
                             device="cpu")
    return j, p


def _run_both(depths, **cfg):
    j, p = _atlases(**cfg)
    jr = [j.process(j32(d), float(i)) for i, d in enumerate(depths)]
    pr = [p.process(d, float(i)) for i, d in enumerate(depths)]
    return j, p, jr, pr


def _err(tr, truth):
    est = np.stack(list(tr.trajectory.poses))
    return np.linalg.norm(est[:, :3, 3] - truth[: len(est), :3, 3], axis=1)


@pytest.fixture(scope="module")
def loop_runs(out_and_back):
    """reactivate=False: the return leg spawns new submaps that overlap the
    outbound ones (the pose-graph path of tests/test_submaps.py:134)."""
    return _run_both(out_and_back[0], reactivate=False)


@pytest.fixture(scope="module")
def reentry_runs(out_and_back):
    return _run_both(out_and_back[0])


@pytest.mark.parametrize("runs", ["loop_runs", "reentry_runs"])
def test_atlas_decisions_and_poses_match_jax(request, out_and_back, runs):
    j, p, jr, pr = request.getfixturevalue(runs)
    assert all(r.success for r in pr) and all(r.success for r in jr)
    assert p._span_log == j._span_log
    assert p.num_submaps == j.num_submaps >= 4
    assert p.active_id == j.active_id
    for a, b in zip(jr, pr):
        np.testing.assert_allclose(b.pose, a.pose, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.pose, p.anchor @ np.asarray(p._t.pose), atol=1e-5)
    assert [s.frames for s in p.submaps] == [s.frames for s in j.submaps]
    # Frozen volumes live in host memory, fused for at least min_frames.
    assert all(s.volume.tsdf.device.type == "cpu" for s in p.finished)
    assert all(s.frames >= p.config.min_frames for s in p.finished)
    assert p.config.volume.integrate_slab == 36  # auto_slab: 3V/4


def test_reentry_reuses_submaps_and_snaps_drift(out_and_back, loop_runs, reentry_runs):
    """The JAX test's bars (tests/test_submaps.py:177-207) on the port."""
    _, truth = out_and_back
    a, b = loop_runs[1], reentry_runs[1]
    assert b.num_submaps < a.num_submaps
    assert b.active_id < b.num_submaps - 1
    assert _err(b, truth)[-1] <= _err(a, truth)[-1]
    sids = [sid for _, sid in b._span_log]
    assert len(sids) > len(set(sids))


def test_optimize_atlas_matches_jax(out_and_back, loop_runs):
    _, truth = out_and_back
    j, p, _, _ = loop_runs
    err_pre = _err(p, truth)
    anchors_pre = [s.world_from_submap.copy() for s in p.finished]
    jl = JS.optimize_atlas(j, surface_capacity=1024)
    pl = PS.optimize_atlas(p, surface_capacity=1024)
    assert pl == jl >= 1
    err_post = _err(p, truth)
    assert err_post[-1] < err_pre[-1]
    assert err_post.mean() < err_pre.mean() * 1.05
    assert any(not np.allclose(a, s.world_from_submap) for a, s in zip(anchors_pre, p.finished))
    for a, b in zip(j.trajectory.poses, p.trajectory.poses):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3)
    np.testing.assert_allclose(p.pose, np.asarray(p.trajectory.poses[-1], np.float32), atol=1e-5)
    np.testing.assert_allclose(p.pose, p.anchor @ np.asarray(p._t.pose), atol=1e-5)


def test_occupancy_gate_matches_jax(loop_runs):
    j, p, _, _ = loop_runs
    sig_j = [JS._occupancy_signature(s.volume, JCFG) for s in j.submaps[:3]]
    sig_p = [PS._occupancy_signature(s.volume, CFG) for s in p.submaps[:3]]
    for a, b in zip(sig_j, sig_p):
        assert np.abs(a - b).max() < 1e-2
    anchors = [s.world_from_submap for s in p.submaps]
    for i, k in ((0, 2), (0, 1), (1, 2)):
        T_ki = np.linalg.inv(anchors[k].astype(np.float64)) @ anchors[i].astype(np.float64)
        want = JS._pair_overlap_score(sig_p[i], sig_p[k], T_ki, JCFG)
        assert PS._pair_overlap_score(sig_p[i], sig_p[k], T_ki, CFG) == want


def test_world_exports_match_jax(reentry_runs):
    j, p, _, _ = reentry_runs
    wm, jwm = p.world_map, j.world_map
    assert abs(int(wm.mask.sum()) - int(np.asarray(jwm.mask).sum())) <= 0.01 * int(wm.mask.sum())
    pts = wm.points[wm.mask].numpy()
    assert pts[:, 0].min() < -0.8 and pts[:, 0].max() > SPAN - 0.4
    cloud, nrm = p.world_map_oriented
    assert nrm.shape == cloud.points.shape
    np.testing.assert_allclose(torch.linalg.vector_norm(nrm[cloud.mask], dim=-1).numpy(), 1.0, atol=1e-5)
    assert p.world_map_colored is None
    mesh = p.world_mesh(16384)
    assert mesh.vertices.shape[0] == p.num_submaps * 4096
    assert int(mesh.mask.sum()) > 1000


def test_windowed_atlas_matches_jax(out_and_back):
    depths = out_and_back[0][:32]
    j, p = _atlases()
    jr = j.process_window([j32(d) for d in depths], [float(i) for i in range(len(depths))], window=8)
    pr = p.process_window(list(depths), [float(i) for i in range(len(depths))], window=8)
    assert len(pr) == len(jr) == len(depths)
    assert p._span_log == j._span_log and p.num_submaps >= 2
    for a, b in zip(jr, pr):
        np.testing.assert_allclose(b.pose, a.pose, rtol=0, atol=1e-4)


@pytest.mark.parametrize("twist", [[0.1, 0, 0, 0, 0, 0], [0.0, 0.05, 0.02, 0.0, 0.3, 0.0],
                                   [0.7, 0, 0, 0, 0, 0], [0, 0, 0, 0.2, 0.1, 0]])
def test_pose_drifted_matches_jax(twist):
    T = pose(twist)
    for radius, probe in ((0.6, 0.6), (0.3, 1.0)):
        assert PS.pose_drifted(T, radius, probe) == JS.pose_drifted(T, radius, probe)


def test_config_matches_jax():
    for kw in ({}, {"spawn_radius": 0.5, "probe_depth": 0.25}):
        a, b = PS.SubmapConfig(volume=CFG, **kw), JS.SubmapConfig(volume=JCFG, **kw)
        assert (a.radius(), a.probe()) == (b.radius(), b.probe())
    p = PS.SubmapTsdfTracker(INTR, PS.SubmapConfig(volume=CFG._replace(integrate_slab=20), auto_slab=True),
                             device="cpu")
    assert p.config.volume.integrate_slab == 20


def test_optimize_atlas_mesh_names_the_multi_device_item(loop_runs):
    """optimize_atlas(mesh=...), the multi-device item, on a one-rank gloo
    mesh of this process: the sharded pair verification (padded to 4 rows,
    one all-gather) gives the unsharded run's edges and trajectory exactly."""
    import copy

    import torch.distributed as dist

    from realsensetracker_tpu_torch.parallel.mesh import make_mesh

    plain, sharded = copy.deepcopy(loop_runs[1]), copy.deepcopy(loop_runs[1])
    mesh = make_mesh(device="cpu")
    try:
        n_sharded = PS.optimize_atlas(sharded, surface_capacity=1024, mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert PS.optimize_atlas(plain, surface_capacity=1024) == n_sharded >= 1
    for a, b in zip(plain.trajectory.poses, sharded.trajectory.poses):
        np.testing.assert_array_equal(a, b)


def test_too_few_submaps_is_a_noop(out_and_back):
    _, p = _atlases()
    for i, d in enumerate(out_and_back[0][:8]):
        p.process(d, float(i))
    before = [np.asarray(T).copy() for T in p.trajectory.poses]
    assert PS.optimize_atlas(p) == 0
    for a, b in zip(before, p.trajectory.poses):
        np.testing.assert_array_equal(a, b)
