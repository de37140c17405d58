"""Parity of the port's TSDF frame-to-model tracker
(realsensetracker_tpu_torch/tracking/tsdf_tracker.py), Tracker(method="tsdf")
and interop.tsdf_state_from_jax with the JAX package, on the CPU.

Inputs: 8 frames of a short walk through torch_parity.scene(1), rendered by
the port at 80x60 and fed to both sides as f32 numpy frames (or u16
millimetres), into the 48^3 x 5 cm volume of tests/test_submaps.py:30-32,
with its ICP settings. Bars: poses within 1e-4 of JAX per entry; success
flags equal; the port's window against its per-frame run within 1e-6; u16
against f32 within 1e-4; a failed frame holds the pose and leaves the
volume bit-identical, as in JAX. The tracked volumes agree to 1e-4 with at
most 0.01% of the voxels parted in weight: the two sides' poses part by
~1e-7 (the ICP sums in another order), which moves a voxel across the
update predicate now and then (integrate alone is exact against JAX,
tests/test_torch_tsdf.py).
"""

import numpy as np
import pytest
import torch

from realsensetracker_tpu.align.projective import ProjectiveIcpConfig as JIcp
from realsensetracker_tpu.align.rgbd import RgbdIcpConfig as JRgbd
from realsensetracker_tpu.api import Tracker as JTracker
from realsensetracker_tpu.api import TrackerConfig as JTrackerConfig
from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker as JTsdf
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig
from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
from realsensetracker_tpu_torch.tracking.tsdf_tracker import TSDF_STATS_WIDTH, TsdfTracker
from tests.torch_parity import (
    DENSE_ICP, dense_configs, intrinsics, j32, render_rgbd, tracked_volumes_close, volumes_close, walk,
)

JINTR, INTR = intrinsics(60, 80, 64.0)
JICP, ICP = JIcp(**DENSE_ICP), ProjectiveIcpConfig(**DENSE_ICP)
PHOTO = dict(iters=(4, 4), samples=768, min_samples=192)
F = 8
POSES = walk(F)
POSE_ATOL = 1e-4


@pytest.fixture(scope="module")
def frames():
    return render_rgbd(INTR, POSES, seed=1)


def _pair(**kw):
    """(JAX TsdfTracker, port TsdfTracker) with the same settings; ``vol``
    overrides the volume config."""
    vol = kw.pop("vol", {})
    photo = kw.pop("photo", None)
    jcfg, cfg = dense_configs(**vol)
    j = JTsdf(JINTR, volume=jcfg, icp=JICP, photometric=None if photo is None else JRgbd(**photo), **kw)
    p = TsdfTracker(INTR, volume=cfg, icp=ICP, photometric=None if photo is None else RgbdIcpConfig(**photo),
                    device="cpu", **kw)
    return j, p


def _run(tracker, depths, colors=None, jax=False):
    out = []
    for i, d in enumerate(depths):
        c = None if colors is None else colors[i]
        if jax:
            out.append(tracker.process(j32(d) if d.dtype == np.float32 else d, float(i),
                                       color=None if c is None else j32(c)))
        else:
            out.append(tracker.process(d, float(i), color=c))
    return out


def _assert_runs_match(jres, pres, atol=POSE_ATOL):
    assert [r.success for r in jres] == [r.success for r in pres]
    for a, b in zip(jres, pres):
        np.testing.assert_allclose(b.pose, a.pose, rtol=0, atol=atol)
        assert abs(a.inlier_fraction - b.inlier_fraction) < 1e-2
        assert a.frame_index == b.frame_index


@pytest.mark.parametrize("vol", [{}, {"raycast_coarse": 4}, {"subvoxel_iters": 0}, {"integrate_every": 2}],
                         ids=["default", "coarse4", "no_refine", "every2"])
def test_tracker_matches_jax(frames, vol):
    depths, _ = frames
    j, p = _pair(vol=vol)
    jres, pres = _run(j, depths, jax=True), _run(p, depths)
    assert all(r.success for r in pres)
    _assert_runs_match(jres, pres)
    tracked_volumes_close(j.tsdf_volume, p.tsdf_volume)
    assert p._fuse_counter == j._fuse_counter


@pytest.mark.parametrize("window", [3, 8])
def test_window_matches_per_frame(frames, window):
    depths, _ = frames
    _, a = _pair()
    _, b = _pair()
    per = _run(a, depths)
    win = b.process_window(list(depths), [float(i) for i in range(F)], window=window)
    assert len(win) == F
    for r, s in zip(per, win):
        assert r.success == s.success and r.frame_index == s.frame_index
        np.testing.assert_allclose(s.pose, r.pose, rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(s.relative), np.asarray(r.relative).reshape(4, 4), atol=1e-6)
    assert torch.equal(a.tsdf_volume.tsdf, b.tsdf_volume.tsdf)
    assert b.trajectory.timestamps == a.trajectory.timestamps


def test_window_matches_jax_window(frames):
    depths, _ = frames
    j, p = _pair(vol={"integrate_every": 3})
    jres = j.process_window([j32(d) for d in depths], window=4)
    pres = p.process_window(list(depths), window=4)
    _assert_runs_match(jres, pres)
    assert TSDF_STATS_WIDTH == 21


def test_u16_matches_f32_and_jax(frames):
    depths, _ = frames
    u16 = np.round(depths * 1000.0).astype(np.uint16)
    meters = (u16.astype(np.float32) * np.float32(1e-3)).astype(np.float32)
    j, p = _pair()
    _, q = _pair()
    jres = [j.process(d, float(i)) for i, d in enumerate(u16)]
    pres = [p.process(d, float(i)) for i, d in enumerate(u16)]
    qres = [q.process(torch.from_numpy(d), float(i)) for i, d in enumerate(meters)]
    _assert_runs_match(jres, pres)
    for a, b in zip(pres, qres):
        np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=1e-4)


def test_track_scale_with_its_fallback_matches_jax(frames):
    """track_scale=2 registers at 40x30; a coverage floor above 1 trips the
    fallback after fallback_patience frames on both sides."""
    depths, _ = frames
    j, p = _pair(vol={"track_scale": 2}, track_scale_fallback=2.0)
    jres, pres = _run(j, depths, jax=True), _run(p, depths)
    _assert_runs_match(jres, pres)
    assert p.num_track_scale_fallbacks == j.num_track_scale_fallbacks == 1
    assert p.track_scale_active == j.track_scale_active == 1


def test_track_scale_without_fallback_matches_jax(frames):
    depths, _ = frames
    j, p = _pair(vol={"track_scale": 2})
    _assert_runs_match(_run(j, depths, jax=True), _run(p, depths))
    assert p.track_scale_active == 2 and p.num_track_scale_fallbacks == 0


@pytest.mark.parametrize("ref", ["frame", "model"])
def test_photometric_matches_jax(frames, ref):
    depths, colors = frames
    j, p = _pair(use_color=True, photo=PHOTO, photometric_ref=ref)
    jres, pres = _run(j, depths[:5], colors[:5], jax=True), _run(p, depths[:5], colors[:5])
    _assert_runs_match(jres, pres)
    tracked_volumes_close(j.tsdf_volume, p.tsdf_volume)
    np.testing.assert_allclose(p._prev_gray.numpy(), np.asarray(j._prev_gray), atol=1e-6)


def test_failed_frame_holds_pose_and_volume(frames):
    """An empty frame fails registration: pose, volume and photometric
    reference all hold, in JAX and in the port; the next frame tracks."""
    depths, colors = frames
    j, p = _pair(use_color=True, photo=PHOTO)
    seq = [depths[0], depths[1], np.zeros_like(depths[0]), depths[2]]
    cols = [colors[0], colors[1], colors[1], colors[2]]
    for i in range(2):
        j.process(j32(seq[i]), color=j32(cols[i]))
        p.process(seq[i], color=cols[i])
    before = [t.clone() for t in p.tsdf_volume]
    gray_before = p._prev_gray.clone()
    jr, pr = j.process(j32(seq[2]), color=j32(cols[2])), p.process(seq[2], color=cols[2])
    assert not jr.success and not pr.success
    np.testing.assert_array_equal(pr.pose, p.trajectory.poses[-2].astype(np.float32))
    for a, b in zip(p.tsdf_volume, before):
        assert torch.equal(a, b)
    assert torch.equal(p._prev_gray, gray_before)
    assert np.array_equal(np.asarray(pr.relative), np.eye(4))
    jr, pr = j.process(j32(seq[3]), color=j32(cols[3])), p.process(seq[3], color=cols[3])
    assert jr.success and pr.success
    np.testing.assert_allclose(pr.pose, jr.pose, atol=POSE_ATOL)


def test_reseed_with_model_depth_matches_jax(frames):
    depths, _ = frames
    j, p = _pair()
    for i in range(3):
        j.process(j32(depths[i]))
        p.process(depths[i])
    render = depths[3] * 0.5
    j.reseed(j32(depths[3]), model_depth=j32(render))
    p.reseed(depths[3], model_depth=render)
    volumes_close(j.tsdf_volume, p.tsdf_volume)
    assert p._fuse_counter == 1 and len(p.trajectory) == 3
    np.testing.assert_array_equal(p.pose, np.eye(4, dtype=np.float32))


def test_validation_matches_jax():
    with pytest.raises(ValueError, match="use_color"):
        TsdfTracker(INTR, photometric=RgbdIcpConfig(), device="cpu")
    with pytest.raises(ValueError, match="photometric_ref"):
        TsdfTracker(INTR, photometric_ref="nope", device="cpu")
    _, p = _pair(use_color=True)
    with pytest.raises(ValueError, match="color frame"):
        p.process(np.ones((60, 80), np.float32))
    odd = _pair(vol={"track_scale": 3})[1]
    odd.process(np.ones((60, 80), np.float32))  # the seed frame registers nothing
    with pytest.raises(ValueError, match="power of 2"):
        odd.process(np.ones((60, 80), np.float32))


@pytest.mark.parametrize("color", [False, True], ids=["depth", "u8_color"])
def test_facade_matches_jax(frames, color):
    depths, colors = frames
    jcfg, cfg = dense_configs()
    u8 = np.clip(colors * 255, 0, 255).astype(np.uint8)
    jt = JTracker(JTrackerConfig(intrinsics=JINTR, method="tsdf", tsdf=jcfg, projective=JICP, tsdf_color=color))
    pt = Tracker(TrackerConfig(intrinsics=INTR, method="tsdf", tsdf=cfg, projective=ICP, tsdf_color=color,
                               device="cpu"))
    jres = [jt.process(j32(d), float(i), color=u8[i] if color else None) for i, d in enumerate(depths[:4])]
    pres = [pt.process(d, float(i), color=u8[i] if color else None) for i, d in enumerate(depths[:4])]
    _assert_runs_match(jres, pres)
    wm = pt.world_map
    assert int(wm.mask.sum()) == int(np.asarray(jt.world_map.mask).sum())
    oriented = pt.world_map_oriented
    assert oriented[1].shape == (65536, 3)
    if color:
        cloud, cols = pt.world_map_colored
        assert int(cloud.mask.sum()) > 0 and float(cols[cloud.mask].max()) <= 1.0
        assert pt.world_mesh(8192).colors is not None
    else:
        assert pt.world_map_colored is None
    mesh, jmesh = pt.world_mesh(8192), jt.world_mesh(8192)
    assert int(mesh.mask.sum()) == int(np.asarray(jmesh.mask).sum()) > 0
    more = pt.process_window(list(depths[4:6]), window=8, grays=list(u8[4:6]) if color else None)
    jmore = jt.process_window([j32(d) for d in depths[4:6]], window=8, grays=list(u8[4:6]) if color else None)
    _assert_runs_match(jmore, more)


def test_interop_continues_a_jax_stream(frames):
    depths, colors = frames
    j, _ = _pair(use_color=True, photo=PHOTO, vol={"integrate_every": 2})
    for i in range(4):
        j.process(j32(depths[i]), float(i), color=j32(colors[i]))
    p = interop.tsdf_state_from_jax(j, device="cpu")
    volumes_close(j.tsdf_volume, p.tsdf_volume, atol=0)
    assert p._fuse_counter == j._fuse_counter and p._index == j._index == 4
    assert len(p.trajectory) == 4
    jres = [j.process(j32(depths[i]), float(i), color=j32(colors[i])) for i in range(4, 6)]
    pres = [p.process(depths[i], float(i), color=colors[i]) for i in range(4, 6)]
    _assert_runs_match(jres, pres)
    cfg = interop.tracker_config_from_jax(JTrackerConfig(method="tsdf", tsdf_submap_radius=0.5, tsdf_color=True),
                                          device="cpu")
    assert cfg.tsdf_submap_radius == 0.5 and cfg.tsdf_color and tuple(cfg.tsdf) == tuple(dense_configs()[0].__class__())
