"""The port's dense checkpoints (tracking/checkpoint.py save_tsdf/load_tsdf,
save_submaps/load_submaps), interop.submap_state_from_jax and SlamTracker's
dense re-fusion (build_dense, world_mesh) against the JAX package, on the
CPU.

Checkpoints go both ways in the JAX npz layout: a port snapshot loads into
a JAX tracker and a JAX snapshot into the port's, and the two continue the
stream with poses within 1e-4 of each other; a snapshot restored into the
package that wrote it continues bit-identically. The JAX version and
geometry checks are kept. build_dense over the same keyframes equals JAX's
volume (tsdf within 1e-6, weights equal) and configuration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align.projective import ProjectiveIcpConfig as JIcp
from realsensetracker_tpu.mapping import submaps as JS
from realsensetracker_tpu.ops.cloud import Cloud as JCloud
from realsensetracker_tpu.tracking import checkpoint as jckpt
from realsensetracker_tpu.tracking import slam as jslam
from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker as JTsdf
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.mapping import submaps as PS
from realsensetracker_tpu_torch.ops.cloud import Cloud
from realsensetracker_tpu_torch.tracking import checkpoint, slam
from realsensetracker_tpu_torch.tracking.tsdf_tracker import TsdfTracker
from tests.torch_parity import DENSE_ICP, dense_configs, intrinsics, j32, render_rgbd, volumes_close, walk

JINTR, INTR = intrinsics(60, 80, 64.0)
JCFG, CFG = dense_configs()
JICP, ICP = JIcp(**DENSE_ICP), ProjectiveIcpConfig(**DENSE_ICP)
F = 8
POSES = walk(F, step=(0.03, -0.01, 0.02, 0.01, 0.02, -0.01))


@pytest.fixture(scope="module")
def frames():
    return render_rgbd(INTR, POSES, seed=3)


def _trackers(color=False):
    j = JTsdf(JINTR, volume=JCFG, icp=JICP, use_color=color)
    p = TsdfTracker(INTR, volume=CFG, icp=ICP, use_color=color, device="cpu")
    return j, p


def _feed(tr, depths, colors, lo, hi, jax):
    out = []
    for i in range(lo, hi):
        c = None if colors is None else colors[i]
        if jax:
            out.append(tr.process(j32(depths[i]), float(i), color=None if c is None else j32(c)))
        else:
            out.append(tr.process(depths[i], float(i), color=c))
    return out


@pytest.mark.parametrize("color", [False, True], ids=["depth", "colored"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_tsdf_checkpoint_crosses_packages(frames, tmp_path, color, direction):
    depths, colors = frames
    colors = colors if color else None
    j, p = _trackers(color)
    path = str(tmp_path / "tsdf.npz")
    if direction == "port_to_jax":
        _feed(p, depths, colors, 0, 4, jax=False)
        checkpoint.save_tsdf(path, p)
        jckpt.load_tsdf(path, j)
    else:
        _feed(j, depths, colors, 0, 4, jax=True)
        jckpt.save_tsdf(path, j)
        checkpoint.load_tsdf(path, p)
    volumes_close(j.tsdf_volume, p.tsdf_volume, atol=0)
    assert p._index == j._index == 4 and len(p.trajectory) == len(j.trajectory) == 4
    np.testing.assert_array_equal(p.pose, j.pose)
    jr, pr = _feed(j, depths, colors, 4, 6, jax=True), _feed(p, depths, colors, 4, 6, jax=False)
    for a, b in zip(jr, pr):
        assert a.success and b.success
        np.testing.assert_allclose(b.pose, a.pose, rtol=0, atol=1e-4)


def test_tsdf_roundtrip_continues_identically(frames, tmp_path):
    depths, _ = frames
    a = Tracker(TrackerConfig(intrinsics=INTR, method="tsdf", tsdf=CFG, projective=ICP, device="cpu"))
    for i in range(4):
        a.process(depths[i], float(i))
    path = str(tmp_path / "tsdf.npz")
    checkpoint.save_tsdf(path, a)  # the facade unwraps to its TsdfTracker
    b = Tracker(TrackerConfig(intrinsics=INTR, method="tsdf", tsdf=CFG, projective=ICP, device="cpu"))
    checkpoint.load_tsdf(path, b)
    for i in range(4, 6):
        np.testing.assert_array_equal(a.process(depths[i], float(i)).pose, b.process(depths[i], float(i)).pose)


def test_tsdf_checkpoint_checks_are_kept(frames, tmp_path):
    depths, colors = frames
    _, p = _trackers()
    p.process(depths[0])
    path = str(tmp_path / "tsdf.npz")
    checkpoint.save_tsdf(path, p)
    with pytest.raises(ValueError, match="geometry"):
        checkpoint.load_tsdf(path, TsdfTracker(INTR, volume=CFG._replace(voxel_size=0.06), device="cpu"))
    with pytest.raises(ValueError, match="color mismatch"):
        checkpoint.load_tsdf(path, TsdfTracker(INTR, volume=CFG, use_color=True, device="cpu"))
    data = dict(np.load(path))
    data["tsdf_version"] = np.int64(9)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="version"):
        checkpoint.load_tsdf(path, TsdfTracker(INTR, volume=CFG, device="cpu"))


def _atlases():
    j = JS.SubmapTsdfTracker(JINTR, JS.SubmapConfig(volume=JCFG, spawn_radius=0.08, min_frames=2), icp=JICP)
    p = PS.SubmapTsdfTracker(INTR, PS.SubmapConfig(volume=CFG, spawn_radius=0.08, min_frames=2), icp=ICP,
                             device="cpu")
    return j, p


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "interop"])
def test_submap_state_crosses_packages(frames, tmp_path, direction):
    depths, _ = frames
    j, p = _atlases()
    path = str(tmp_path / "atlas.npz")
    if direction == "port_to_jax":
        _feed(p, depths, None, 0, 6, jax=False)
        checkpoint.save_submaps(path, p)
        jckpt.load_submaps(path, j)
    else:
        _feed(j, depths, None, 0, 6, jax=True)
        if direction == "interop":
            p = interop.submap_state_from_jax(j, device="cpu")
        else:
            jckpt.save_submaps(path, j)
            checkpoint.load_submaps(path, p)
    assert p.num_submaps == j.num_submaps >= 2
    assert p._span_log == j._span_log and p.active_id == j.active_id
    for a, b in zip(j.submaps, p.submaps):
        np.testing.assert_array_equal(b.world_from_submap, a.world_from_submap)
        volumes_close(a.volume, b.volume, atol=0)
    jr, pr = _feed(j, depths, None, 6, F, jax=True), _feed(p, depths, None, 6, F, jax=False)
    for a, b in zip(jr, pr):
        np.testing.assert_allclose(b.pose, a.pose, rtol=0, atol=1e-4)
    assert p._span_log == j._span_log


def test_submap_checkpoint_checks_are_kept(frames, tmp_path):
    depths, _ = frames
    _, p = _atlases()
    _feed(p, depths, None, 0, 3, jax=False)
    path = str(tmp_path / "atlas.npz")
    checkpoint.save_submaps(path, p)
    wrong = PS.SubmapTsdfTracker(INTR, PS.SubmapConfig(volume=CFG._replace(origin=(0.0, 0.0, 0.0))), device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        checkpoint.load_submaps(path, wrong)
    with pytest.raises(ValueError, match="color mismatch"):
        checkpoint.load_submaps(path, PS.SubmapTsdfTracker(INTR, PS.SubmapConfig(volume=CFG), use_color=True,
                                                           device="cpu"))
    with pytest.raises(ValueError, match="submap TSDF tracker"):
        checkpoint.save_submaps(path, TsdfTracker(INTR, device="cpu"))


def _keyframes(depths):
    """(JAX keyframes, port keyframes) of frames 0, 3, 6 at their true poses,
    each with the frame's valid points as its cloud."""
    jk, pk = [], []
    for k, f in enumerate((0, 3, 6)):
        d = depths[f]
        v, u = np.nonzero(d > 0)
        pts = np.stack([(u - INTR.cx) / INTR.fx * d[v, u], (v - INTR.cy) / INTR.fy * d[v, u], d[v, u]], -1)
        pts = pts.astype(np.float32)[:512]
        mask = np.ones(len(pts), bool)
        jk.append(jslam._Keyframe(index=k, frame_index=f, pose=POSES[f], cloud=JCloud(jnp.asarray(pts),
                                  jnp.asarray(mask)), feats=None, depth=d))
        pk.append(slam._Keyframe(index=k, frame_index=f, pose=POSES[f], cloud=Cloud(torch.from_numpy(pts),
                                 torch.from_numpy(mask)), feats=None, depth=d))
    return jk, pk


def test_slam_build_dense_and_world_mesh_match_jax(frames):
    depths, _ = frames
    cam = dict(fx=INTR.fx, fy=INTR.fy, cx=INTR.cx, cy=INTR.cy, width=INTR.width, height=INTR.height)
    jt = jslam.SlamTracker(jslam.SlamConfig(intrinsics=JINTR, keep_depths=True))
    pt = slam.SlamTracker(slam.SlamConfig(intrinsics=camera.Intrinsics(**cam), keep_depths=True, device="cpu"))
    jt._keyframes, pt._keyframes = _keyframes(depths)
    jvol, jcfg = jt.build_dense(resolution=48)
    pvol, pcfg = pt.build_dense(resolution=48)
    assert tuple(pcfg) == tuple(jcfg)
    volumes_close(jvol, pvol)
    assert int((pvol.weight > 0).sum()) > 1000
    jm, pm = jt.world_mesh(capacity=8192, resolution=48), pt.world_mesh(capacity=8192, resolution=48)
    np.testing.assert_array_equal(pm.mask.numpy(), np.asarray(jm.mask))
    np.testing.assert_allclose(pm.vertices.numpy(), np.asarray(jm.vertices), rtol=0, atol=1e-6)
    assert slam.SlamTracker(slam.SlamConfig(intrinsics=INTR, device="cpu")).build_dense() is None
