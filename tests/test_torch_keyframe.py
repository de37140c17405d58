"""Parity of the port's KeyframeTracker and Tracker(method="keyframe") with JAX.

The setup of tests/test_windowed.py (100x75, iters (4,4,5), 1024 samples),
rendered once with numpy-drawn scenes and fed to both packages. Against
JAX's per-frame run: poses to atol 1e-5, success, is_new_keyframe and
span_failures exactly, rmse to 1e-4 relative and inlier_fraction to 0.01
(f32 sums run in another order). Inside the port, windows equal per-frame
results at the atol of tests/test_windowed.py:51-59.
"""

import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.api import Tracker as JTracker
from realsensetracker_tpu.api import TrackerConfig as JTrackerConfig
from realsensetracker_tpu.tracking.keyframe import KeyframeTracker as JKeyframeTracker
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.tracking.keyframe import KeyframeTracker
from tests.torch_parity import intrinsics, render

JINTR, INTR = intrinsics(75, 100, 100.0)  # tests/test_windowed.py:17
CFG = projective.ProjectiveIcpConfig(iters=(4, 4, 5), samples=1024)
JCFG = jproj.ProjectiveIcpConfig(iters=(4, 4, 5), samples=1024)
PROMOTE = dict(max_translation=0.06, max_rotation=0.05)
RESEED = dict(max_consecutive_failures=2, max_translation=10.0, max_rotation=10.0)
U16_SCALE = np.float32(1.0 / 5000.0)


def _sequence(n, step=(0.03, 0.0, 0.02, 0.0, 0.025, 0.0), seed=21):
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        poses.append(poses[-1] @ se3.exp(torch.tensor(step)).numpy())
    return list(render(INTR, np.stack(poses), seed))


def _failures_sequence():
    good = _sequence(4, step=(0.01, 0.0, 0.01, 0.0, 0.01, 0.0))
    return good + [np.zeros_like(good[0])] * 3 + [good[-1]] * 2


SCENARIOS = {
    "promotions": (lambda: _sequence(9), PROMOTE),
    "failures": (_failures_sequence, RESEED),
}


def _per_frame(tracker, depths, t0=0):
    return [tracker.process(d, float(t0 + i)) for i, d in enumerate(depths)]


def _windowed(tracker, depths, window, mode):
    out, i = [], 0
    while i < len(depths):
        chunk = depths[i : i + window]
        ts = [float(j) for j in range(i, i + len(chunk))]
        res = tracker.process_window(chunk, ts, pad_to=window, truncate_at_events=mode)
        out.extend(res)
        i += len(res)
    return out


def _assert_results_match(a, b, rmse_rtol=1e-4, inlier_atol=0.01):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.frame_index == rb.frame_index
        assert ra.success == rb.success, ra.frame_index
        assert ra.is_new_keyframe == rb.is_new_keyframe, ra.frame_index
        assert ra.span_failures == rb.span_failures, ra.frame_index
        np.testing.assert_allclose(np.asarray(ra.pose), np.asarray(rb.pose), atol=1e-5)
        np.testing.assert_allclose(ra.rmse, rb.rmse, rtol=rmse_rtol, atol=1e-7)
        assert abs(ra.inlier_fraction - rb.inlier_fraction) <= inlier_atol


def _assert_same_stream(a, b):
    """Port against port: the atol of tests/test_windowed.py:51-59."""
    _assert_results_match(a, b, rmse_rtol=0, inlier_atol=1e-5)


@pytest.fixture(scope="module")
def scenario():
    """name -> (depths, tracker kwargs, JAX per-frame results)."""
    out = {}
    for name, (make, kw) in SCENARIOS.items():
        depths = make()
        out[name] = (depths, kw, _per_frame(JKeyframeTracker(JINTR, JCFG, **kw), depths))
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_per_frame_matches_jax(scenario, name):
    depths, kw, ref = scenario[name]
    got = _per_frame(KeyframeTracker(INTR, CFG, device="cpu", **kw), depths)
    _assert_results_match(got, ref)
    if name == "promotions":
        assert sum(r.is_new_keyframe for r in ref[1:]) >= 2
    else:
        assert any(r.is_new_keyframe and not r.success for r in ref)  # recovery re-seed


@pytest.mark.parametrize("mode", [True, False, "failures"], ids=["truncate", "through", "failures"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_window_matches_jax_and_per_frame(scenario, name, mode):
    depths, kw, ref = scenario[name]
    per_frame = KeyframeTracker(INTR, CFG, device="cpu", **kw)
    windowed = KeyframeTracker(INTR, CFG, device="cpu", **kw)
    a = _per_frame(per_frame, depths)
    b = _windowed(windowed, depths, 4, mode)
    _assert_results_match(b, ref)
    _assert_same_stream(a, b)
    assert windowed._fail_streak == per_frame._fail_streak
    assert windowed._fails_since_kf == per_frame._fails_since_kf
    assert windowed.last_span_failures == per_frame.last_span_failures
    np.testing.assert_allclose(windowed._kf_pose.numpy(), per_frame._kf_pose.numpy(), atol=1e-5)
    # The adopted carry continues like the per-frame state.
    tail = _sequence(3, step=(0.01, 0.0, 0.01, 0.0, 0.0, 0.0))
    _assert_same_stream(_per_frame(per_frame, tail, 100), _per_frame(windowed, tail, 100))


def test_window_truncates_at_events(scenario):
    depths, kw, _ = scenario["promotions"]
    tracker = KeyframeTracker(INTR, CFG, device="cpu", **kw)
    lens, i = [], 0
    while i < len(depths):
        res = tracker.process_window(depths[i : i + 4], pad_to=4, truncate_at_events=True)
        lens.append(len(res))
        if 1 < len(res) < min(4, len(depths) - i):  # a short window ends at its event
            assert res[-1].is_new_keyframe
        i += len(res)
    assert lens[0] == 1 and any(n < 4 for n in lens[1:-1])


def test_padding_inert_without_events():
    depths = _sequence(4, step=(0.005, 0.0, 0.005, 0.0, 0.0, 0.0))
    ref = KeyframeTracker(INTR, CFG, device="cpu")
    win = KeyframeTracker(INTR, CFG, device="cpu")
    a = _per_frame(ref, depths)
    win.process(depths[0], 0.0)
    res = win.process_window(depths[1:], [1.0, 2.0, 3.0], pad_to=8, truncate_at_events=False)
    assert len(res) == 3
    _assert_same_stream(a[1:], res)
    assert win._index == ref._index
    np.testing.assert_array_equal(win.pose, ref.pose)


def test_uint16_matches_quantized_float_and_jax():
    depths = _sequence(9, step=(0.05, 0.0, 0.04, 0.0, 0.04, 0.0))
    raw = [np.asarray(d * 5000.0 + 0.5, np.uint16) for d in depths]
    quant = [r.astype(np.float32) * U16_SCALE for r in raw]
    ref = _per_frame(JKeyframeTracker(JINTR, JCFG, depth_scale=float(U16_SCALE), **PROMOTE), raw)
    a = _per_frame(KeyframeTracker(INTR, CFG, device="cpu", **PROMOTE), quant)
    b = _per_frame(KeyframeTracker(INTR, CFG, device="cpu", depth_scale=float(U16_SCALE), **PROMOTE), raw)
    c = _windowed(KeyframeTracker(INTR, CFG, device="cpu", depth_scale=float(U16_SCALE), **PROMOTE), raw, 4, False)
    assert sum(r.is_new_keyframe for r in a[1:]) >= 2
    _assert_same_stream(a, b)
    _assert_same_stream(a, c)
    _assert_results_match(b, ref)


def test_mixed_window_converts_raw_frames():
    depths = _sequence(5, step=(0.01, 0.0, 0.01, 0.0, 0.0, 0.0))
    raw = [np.asarray(d * 5000.0 + 0.5, np.uint16) for d in depths]
    quant = [r.astype(np.float32) * U16_SCALE for r in raw]
    mixed = [raw[i] if i % 2 else quant[i] for i in range(5)]
    a = _per_frame(KeyframeTracker(INTR, CFG, device="cpu"), quant)
    b = _windowed(KeyframeTracker(INTR, CFG, device="cpu", depth_scale=float(U16_SCALE)), mixed, 4, True)
    _assert_same_stream(a, b)


def _drive_corrections(tracker, depths):
    """Frames, a relocalization, frames, a world correction, frames."""
    out = _per_frame(tracker, depths[:3])
    T = np.asarray(tracker.pose, np.float32).copy()
    T[:3, 3] += np.float32([0.01, -0.02, 0.005])
    tracker.relocalize_to(T)
    out += _per_frame(tracker, depths[3:5], 3)
    delta = se3.exp(torch.tensor([0.002, 0.001, -0.003, 0.001, -0.002, 0.0015])).numpy()
    tracker.apply_world_correction(delta)
    out += _per_frame(tracker, depths[5:], 5)
    return out


def test_relocalize_and_world_correction_match_jax(scenario):
    depths, kw, _ = scenario["promotions"]
    ref = _drive_corrections(JKeyframeTracker(JINTR, JCFG, **kw), depths)
    tracker = KeyframeTracker(INTR, CFG, device="cpu", **kw)
    got = _drive_corrections(tracker, depths)
    _assert_results_match(got, ref)
    assert len(tracker.trajectory) == len(depths)


def test_relocalize_after_window_rebuilds_the_keyframe(scenario):
    depths, kw, _ = scenario["promotions"]
    a, b = KeyframeTracker(INTR, CFG, device="cpu", **kw), KeyframeTracker(INTR, CFG, device="cpu", **kw)
    _per_frame(a, depths[:5])
    _windowed(b, depths[:5], 4, False)
    assert b._last_levels is None
    for t in (a, b):
        t.relocalize_to(np.eye(4, dtype=np.float32))
    for x, y in zip(a._kf_levels, b._kf_levels):
        torch.testing.assert_close(x.packed, y.packed, rtol=0, atol=0)
    _assert_same_stream(_per_frame(a, depths[5:], 5), _per_frame(b, depths[5:], 5))


@pytest.fixture(scope="module")
def facade_reference(scenario):
    depths = scenario["promotions"][0]
    jt = JTracker(JTrackerConfig(intrinsics=JINTR, method="keyframe", projective=JCFG))
    return _per_frame(jt, depths)


def test_tracker_process_window_matches_jax(scenario, facade_reference):
    depths = scenario["promotions"][0]
    cfg = TrackerConfig(intrinsics=INTR, device="cpu", method="keyframe", projective=CFG)
    per_frame, windowed = Tracker(cfg), Tracker(cfg)
    a = _per_frame(per_frame, depths)
    b = windowed.process_window(depths, [float(i) for i in range(len(depths))], window=4)
    _assert_results_match(b, facade_reference)
    _assert_same_stream(a, b)
    assert len(windowed.trajectory) == len(depths)
    np.testing.assert_array_equal(windowed.pose, b[-1].pose)


def test_tracker_process_window_needs_keyframe_method(scenario):
    with pytest.raises(ValueError, match="keyframe"):
        Tracker(TrackerConfig(intrinsics=INTR, device="cpu", method="projective")).process_window(scenario["promotions"][0])


def test_tracker_passes_raw_depth_to_the_keyframe_tracker(scenario, facade_reference):
    depths = scenario["promotions"][0]
    raw = [np.asarray(d * 1000.0 + 0.5, np.uint16) for d in depths]
    tracker = Tracker(TrackerConfig(intrinsics=INTR, device="cpu", method="keyframe", projective=CFG, depth_scale=1e-3))
    got = _per_frame(tracker, raw)
    quant = _per_frame(KeyframeTracker(INTR, CFG, device="cpu"), [r.astype(np.float32) * np.float32(1e-3) for r in raw])
    _assert_same_stream(got, quant)


@pytest.mark.parametrize("k", [1, 4])
def test_state_carried_from_jax_continues_the_stream(scenario, k):
    depths, kw, ref = scenario["promotions"]
    jt = JKeyframeTracker(JINTR, JCFG, **kw)
    _per_frame(jt, depths[:k])
    pt = interop.keyframe_state_from_jax(jt, device="cpu")
    assert pt._index == k and len(pt.trajectory) == k
    assert pt.cfg == projective.fit_levels(CFG, 75, 100)
    assert (pt.max_translation, pt.max_rotation) == (0.06, 0.05)
    _assert_results_match(_per_frame(pt, depths[k:], k), ref[k:])


def test_normal_space_keyframe_tracking():
    """BASELINE config 3 through the facade, the bar of
    tests/test_baseline_configs.py:57-69."""
    depths = _sequence(5, step=(0.01, -0.005, 0.01, 0.0, 0.01, 0.0))
    cfg = projective.ProjectiveIcpConfig(iters=(6, 6, 8), samples=1536, sample_mode="normal_space")
    tracker = Tracker(TrackerConfig(intrinsics=INTR, device="cpu", method="keyframe", projective=cfg))
    results = _per_frame(tracker, depths)
    assert all(r.success for r in results)
    truth = np.linalg.matrix_power(se3.exp(torch.tensor([0.01, -0.005, 0.01, 0.0, 0.01, 0.0])).numpy(), 4)
    err = se3.log(torch.from_numpy(np.linalg.inv(truth).astype(np.float32) @ tracker.pose))
    assert err.abs().max().item() < 0.05
