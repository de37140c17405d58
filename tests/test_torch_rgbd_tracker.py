"""Parity of the port's RGB-D frame and keyframe trackers,
Tracker(method="rgbd") and the RGB-D interop helpers with the JAX package.

The inputs, solver settings and tolerances of tests/test_torch_rgbd.py:
poses 1e-5 absolute per entry, success and keyframe events exactly, rmse
1e-3 relative and inlier fractions 0.01 against JAX; inside the port,
windows equal per-frame results at the atol of
tests/test_windowed.py:51-59, in every truncate mode and with padded rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import rgbd as jrgbd
from realsensetracker_tpu.api import Tracker as JTracker
from realsensetracker_tpu.api import TrackerConfig as JTrackerConfig
from realsensetracker_tpu.tracking.keyframe_rgbd import RgbdKeyframeTracker as JRgbdKeyframeTracker
from realsensetracker_tpu.tracking.rgbd import RgbdTracker as JRgbdTracker
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.align import rgbd
from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.tracking.keyframe_rgbd import RgbdKeyframeTracker
from realsensetracker_tpu_torch.tracking.rgbd import RgbdTracker
from tests.test_torch_rgbd import (
    CFG, INTR, JCFG, JINTR, _assert_results_match, _assert_same_stream, _sequence, failures, stream,  # noqa: F401
)
from tests.torch_parity import pose, scene

PROMOTE = dict(max_translation=0.03, max_rotation=0.03)
RESEED = dict(max_consecutive_failures=2, max_translation=10.0, max_rotation=10.0)


def _per_frame(tracker, depths, grays, t0=0):
    return [tracker.process(d, g, float(t0 + i)) for i, (d, g) in enumerate(zip(depths, grays))]


def _windowed(tracker, depths, grays, window, mode, pad_to=None):
    out, i = [], 0
    while i < len(depths):
        ts = [float(j) for j in range(i, min(i + window, len(depths)))]
        res = tracker.process_window(depths[i : i + window], grays[i : i + window], ts,
                                     pad_to=pad_to or window, truncate_at_events=mode)
        out.extend(res)
        i += len(res)
    return out


# --- trackers -----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_frame_run(stream):
    depths, grays = stream
    return _per_frame(JRgbdTracker(JINTR, JCFG), depths, grays)


def test_rgbd_tracker_matches_jax(stream, jax_frame_run):
    depths, grays = stream
    got = _per_frame(RgbdTracker(INTR, CFG, device="cpu"), depths, grays)
    _assert_results_match(got, jax_frame_run)
    assert all(r.success for r in got)


@pytest.fixture(scope="module")
def jax_keyframe_run(stream, failures):
    out = {}
    for name, (depths, grays), kw in (("promotions", stream, PROMOTE), ("failures", failures, RESEED)):
        out[name] = (depths, grays, kw, _per_frame(JRgbdKeyframeTracker(JINTR, JCFG, **kw), depths, grays))
    return out


@pytest.mark.parametrize("name", ["promotions", "failures"])
def test_rgbd_keyframe_tracker_matches_jax(jax_keyframe_run, name):
    depths, grays, kw, ref = jax_keyframe_run[name]
    got = _per_frame(RgbdKeyframeTracker(INTR, CFG, device="cpu", **kw), depths, grays)
    _assert_results_match(got, ref)
    events = sum(r.is_new_keyframe for r in ref[1:])
    assert events >= 1 if name == "promotions" else any(not r.success for r in ref)


@pytest.mark.parametrize("mode", [True, "failures", False])
def test_rgbd_keyframe_window_matches_per_frame(jax_keyframe_run, mode):
    """Windows of 3 in each truncate mode, padded to 3, through promotions
    and a failure streak with its re-seed, equal the port's per-frame run."""
    for name in ("promotions", "failures"):
        depths, grays, kw, _ = jax_keyframe_run[name]
        ref = _per_frame(RgbdKeyframeTracker(INTR, CFG, device="cpu", **kw), depths, grays)
        win = RgbdKeyframeTracker(INTR, CFG, device="cpu", **kw)
        _assert_same_stream(_windowed(win, depths, grays, 3, mode), ref)


def test_rgbd_keyframe_padded_rows_are_inert(stream):
    """tests/test_windowed.py:607-637: a short event-free window padded to 8
    equals per-frame, and the failure bookkeeping agrees."""
    depths, grays = stream
    ref = RgbdKeyframeTracker(INTR, CFG, device="cpu")
    win = RgbdKeyframeTracker(INTR, CFG, device="cpu")
    ra = _per_frame(ref, depths[:4], grays[:4])
    win.process(depths[0], grays[0], 0.0)
    res = win.process_window(depths[1:4], grays[1:4], [1.0, 2.0, 3.0], pad_to=8, truncate_at_events=False)
    assert len(res) == 3 and not any(r.is_new_keyframe for r in ra[1:])
    _assert_same_stream(ra[1:], res)
    assert (win._index, win._fail_streak, win._fails_since_kf) == (ref._index, ref._fail_streak, ref._fails_since_kf)
    np.testing.assert_array_equal(win._pose.numpy(), ref._pose.numpy())


def test_rgbd_keyframe_relocalize_and_world_correction_match_jax(stream):
    depths, grays = stream
    jt, pt = JRgbdKeyframeTracker(JINTR, JCFG), RgbdKeyframeTracker(INTR, CFG, device="cpu")
    for t in (jt, pt):
        _per_frame(t, depths[:2], grays[:2])
    _windowed(pt, depths[2:4], grays[2:4], 2, False)
    for i in (2, 3):
        jt.process(depths[i], grays[i], float(i))
    target = pose([0.05, 0.0, 0.02, 0.0, 0.03, 0.0])
    delta = pose([0.01, 0.02, -0.01, 0.005, 0.0, 0.01])
    for t in (jt, pt):
        t.relocalize_to(target)
        t.apply_world_correction(delta)
    np.testing.assert_allclose(pt.pose, np.asarray(jt.pose), atol=1e-6)
    a, b = pt.process(depths[4], grays[4], 4.0), jt.process(depths[4], grays[4], 4.0)
    _assert_results_match([a], [b])


# --- the facade and interop ---------------------------------------------------


@pytest.mark.parametrize("color", ["u8_rgb", "u8_gray", "float_gray"])
def test_tracker_facade_rgbd_matches_jax(color):
    sc = scene(6)
    T = pose([0.01, 0.0, 0.01, 0.0, 0.01, 0.0])
    frames = [synthetic.render_rgbd(INTR, torch.from_numpy(P), sc) for P in (np.eye(4, dtype=np.float32), T, T @ T)]
    cfg = TrackerConfig(intrinsics=INTR, method="rgbd", rgbd=CFG, device="cpu")
    jcfg = JTrackerConfig(intrinsics=JINTR, method="rgbd", rgbd=JCFG)
    port, ref = Tracker(cfg), JTracker(jcfg)
    for i, (d, c) in enumerate(frames):
        c8 = np.clip(c.numpy() * 255, 0, 255).astype(np.uint8)
        col = {"u8_rgb": c8, "u8_gray": c8[..., 1], "float_gray": synthetic.intensity_from_rgb(c).numpy()}[color]
        a, b = port.process(d.numpy(), float(i), color=col), ref.process(d.numpy(), float(i), color=col)
        _assert_results_match([a], [b])
        assert a.success


def test_rgbd_requires_color():
    tracker = Tracker(TrackerConfig(intrinsics=INTR, method="rgbd", device="cpu"))
    with pytest.raises(ValueError, match="color"):
        tracker.process(np.ones((INTR.height, INTR.width), np.float32), 0.0)


def test_rgbd_state_carried_from_jax_continues_the_stream(stream):
    depths, grays = stream
    jt = JRgbdTracker(JINTR, JCFG)
    _per_frame(jt, depths[:3], grays[:3])
    pt = interop.rgbd_state_from_jax(jt, device="cpu")
    assert pt.cfg == interop.rgbd_config_from_jax(jt.cfg) and pt._index == 3
    _assert_results_match(_per_frame(pt, depths[3:], grays[3:], 3), _per_frame(jt, depths[3:], grays[3:], 3))
    assert len(pt.trajectory) == len(jt.trajectory) == len(depths)


@pytest.mark.parametrize("after", ["process", "process_window"])
def test_rgbd_keyframe_state_carried_from_jax_continues_the_stream(stream, after):
    depths, grays = stream
    jt = JRgbdKeyframeTracker(JINTR, JCFG, **PROMOTE)
    _per_frame(jt, depths[:3], grays[:3])
    pt = interop.rgbd_keyframe_state_from_jax(jt, device="cpu")
    ref = _per_frame(jt, depths[3:], grays[3:], 3)
    if after == "process":
        got = _per_frame(pt, depths[3:], grays[3:], 3)
    else:
        got = pt.process_window(depths[3:], grays[3:], [3.0, 4.0, 5.0], truncate_at_events=False)
    _assert_results_match(got, ref)


def test_rgbd_configs_match_jax():
    assert rgbd.RgbdIcpConfig()._asdict() == jrgbd.RgbdIcpConfig()._asdict()
    jcfg = JTrackerConfig(method="rgbd", rgbd=JCFG)
    cfg = interop.tracker_config_from_jax(jcfg, device="cpu")
    assert cfg.rgbd == CFG and cfg.method == "rgbd"
    assert dataclasses.replace(cfg, device="cuda").rgbd == CFG


def test_rgbd_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = [
        lambda: Tracker(TrackerConfig(method="rgbd")),
        lambda: RgbdTracker(INTR),
        lambda: RgbdKeyframeTracker(INTR),
        lambda: interop.rgbd_state_from_jax(JRgbdTracker(JINTR, JCFG)),
        lambda: interop.rgbd_keyframe_state_from_jax(JRgbdKeyframeTracker(JINTR, JCFG)),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_as_gray_matches_jax_on_host_and_tensor_input():
    from realsensetracker_tpu.api.tracker import _as_gray as j_as_gray
    from realsensetracker_tpu_torch.api.tracker import _as_gray

    rng = np.random.RandomState(9)
    for a in (rng.randint(0, 256, (5, 7, 3)).astype(np.uint8), rng.randint(0, 256, (5, 7)).astype(np.uint8),
              rng.rand(5, 7, 3).astype(np.float32), rng.rand(5, 7).astype(np.float32)):
        ref = np.asarray(j_as_gray(a))
        np.testing.assert_array_equal(_as_gray(a), ref)
        np.testing.assert_allclose(_as_gray(torch.from_numpy(a)).numpy(), ref, rtol=1e-6, atol=1e-7)
