"""The port's HTTP tracking service (realsensetracker_tpu_torch/api/
service.py) and rs_serve (cli/rs_serve.py) on the CPU.

Mirrors tests/test_service.py case by case at its 80x60 camera: every
endpoint (/track, /track_window, /pose, /status, /metrics, /trajectory,
/reset), sessions, the Prometheus text, the TUM trajectory, the raw-u16
passthrough and its scale-mismatch guard, window parity with /track, the
body codecs, and ``rs_serve --device cpu --max-frames``. The trackers
behind it are the port's on ``device="cpu"``; a service run is held to the
same tracker called directly (1e-6) and to the JAX tracker on the same
frames (1e-4). Every server is closed in a fixture or a ``finally`` and
every client call has a 30 s timeout.
"""

import io
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from realsensetracker_tpu.api import Tracker as JTracker
from realsensetracker_tpu.api import TrackerConfig as JTrackerConfig
from realsensetracker_tpu.data import synthetic as jsyn
from realsensetracker_tpu.geometry import camera as jcam
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
from realsensetracker_tpu_torch.api import service as svc_mod
from realsensetracker_tpu_torch.api.service import TrackingService, get_json, post_frame, post_window
from tests.torch_parity import scene as port_scene  # noqa: F401  (caps torch threads)

W, H = 80, 60
JINTR = jcam.Intrinsics(fx=64.0, fy=64.0, cx=(W - 1) / 2, cy=(H - 1) / 2, width=W, height=H)
INTR = interop.intrinsics_from_jax(JINTR)
TIMEOUT = 30.0


def _post(url, depth, **kw):
    return post_frame(url, depth, timeout=TIMEOUT, **kw)


def _post_window(url, depths, **kw):
    return post_window(url, depths, timeout=TIMEOUT, **kw)


def _get(url, path):
    return get_json(url, path, timeout=TIMEOUT)


def _reset(url, session=None):
    path = "/reset" + (f"?session={session}" if session else "")
    with urllib.request.urlopen(urllib.request.Request(url + path, data=b""), timeout=TIMEOUT) as r:
        return r.status


def _tracker(method="keyframe", **kw):
    return lambda: Tracker(TrackerConfig(intrinsics=INTR, method=method, device="cpu", **kw))


@pytest.fixture(scope="module")
def frames():
    depths, poses = jsyn.render_trajectory(JINTR, 4, seed=0, step_scale=0.01)
    return [np.asarray(depths[i], np.float32) for i in range(4)], np.asarray(poses)


@pytest.fixture()
def service():
    svc = TrackingService(_tracker())
    yield svc
    svc.close()


def _url(svc):
    return f"http://127.0.0.1:{svc.port}"


class TestTrackingService:
    def test_track_sequence_and_trajectory(self, service, frames):
        depths, _ = frames
        url = _url(service)
        recs = [_post(url, depths[i], ts=i / 30.0) for i in range(4)]
        assert [r["frame"] for r in recs] == [1, 2, 3, 4]
        assert all(r["success"] for r in recs)
        pose = np.asarray(recs[-1]["pose"])
        np.testing.assert_allclose(pose[:3, :3].T @ pose[:3, :3], np.eye(3), atol=1e-5)
        st = _get(url, "/status")
        assert st["frames"] == 4 and st["tracker"] == "Tracker"
        np.testing.assert_allclose(np.asarray(_get(url, "/pose")["pose"]), pose, atol=1e-6)
        tum = _get(url, "/trajectory").strip().splitlines()
        assert len(tum) == 4 and len(tum[0].split()) == 8

    def test_service_pose_matches_local_and_jax_tracker(self, service, frames):
        depths, _ = frames
        url = _url(service)
        recs = [_post(url, depths[i], ts=i / 30.0) for i in range(4)]
        local = Tracker(TrackerConfig(intrinsics=INTR, method="keyframe", device="cpu"))
        jax_t = JTracker(JTrackerConfig(intrinsics=JINTR, method="keyframe"))
        for i in range(4):
            res = local.process(depths[i], i / 30.0)
            jres = jax_t.process(depths[i], i / 30.0)
            np.testing.assert_allclose(np.asarray(recs[i]["pose"]), res.pose, rtol=0, atol=1e-6)
            np.testing.assert_allclose(np.asarray(recs[i]["pose"]), np.asarray(jres.pose), rtol=0, atol=1e-4)
            assert recs[i]["success"] == bool(jres.success)

    def test_reset(self, service, frames):
        depths, _ = frames
        url = _url(service)
        _post(url, depths[0])
        assert _reset(url) == 200
        assert "default" not in _get(url, "/status")["sessions"]
        assert _post(url, depths[1])["frame"] == 1

    def test_independent_sessions(self, service, frames):
        depths, _ = frames
        url = _url(service)
        a1 = _post(url, depths[0], ts=0.0, session="a")
        b1 = _post(url, depths[2], ts=0.0, session="b")
        a2 = _post(url, depths[1], ts=1 / 30.0, session="a")
        assert (a1["frame"], b1["frame"], a2["frame"]) == (1, 1, 2)
        st = _get(url, "/status")
        assert st["sessions"]["a"]["frames"] == 2 and st["sessions"]["b"]["frames"] == 1
        assert len(_get(url, "/trajectory?session=a").strip().splitlines()) == 2
        assert len(_get(url, "/trajectory?session=b").strip().splitlines()) == 1

    def test_bad_body_is_400_not_crash(self, service):
        req = urllib.request.Request(_url(service) + "/track", data=b"not an npy")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert ei.value.code == 400

    def test_unknown_path_is_404(self, service):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(_url(service), "/nope")
        assert ei.value.code == 404

    def test_concurrent_producers_serialize(self, frames):
        depths, _ = frames
        svc = TrackingService(_tracker("projective"))
        try:
            url, out, errors = _url(svc), [], []

            def worker(i):
                try:
                    out.append(_post(url, depths[i % 4], ts=float(i)))
                except BaseException as e:
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not errors and sorted(r["frame"] for r in out) == [1, 2, 3, 4, 5, 6]
            assert svc.status()["frames"] == 6
        finally:
            svc.close()


class TestServiceMethods:
    def test_slam_tracker_via_service(self, frames):
        from realsensetracker_tpu_torch.tracking.slam import SlamConfig, SlamTracker

        depths, _ = frames
        svc = TrackingService(lambda: SlamTracker(SlamConfig(intrinsics=INTR, device="cpu")))
        try:
            url = _url(svc)
            for i in range(4):
                rec = _post(url, depths[i], ts=i / 30.0)
            assert rec["frame"] == 4 and rec["success"]
            st = _get(url, "/status")
            assert st["tracker"] == "SlamTracker" and st["keyframes"] >= 1
        finally:
            svc.close()

    def test_rgbd_npz_color_path(self):
        depths, colors, _ = jsyn.render_trajectory_rgbd(JINTR, 3, seed=0)
        svc = TrackingService(_tracker("rgbd"))
        try:
            url = _url(svc)
            for i in range(3):
                rec = _post(url, np.asarray(depths[i]), ts=i / 30.0, color=np.asarray(colors[i]))
            assert rec["frame"] == 3 and rec["success"]
        finally:
            svc.close()

    def test_rgbd_without_color_is_500(self, frames):
        depths, _ = frames
        svc = TrackingService(_tracker("rgbd"))
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(_url(svc), depths[0])
            assert ei.value.code == 500
        finally:
            svc.close()


def _traj_poses(tum_text: str) -> np.ndarray:
    return np.asarray([list(map(float, ln.split())) for ln in tum_text.strip().splitlines()])


class TestTrackWindow:
    def test_window_matches_per_frame(self):
        depths, _ = jsyn.render_trajectory(JINTR, 10, seed=1, step_scale=0.01)
        depths = [np.asarray(d, np.float32) for d in depths]
        svc_a, svc_b = TrackingService(_tracker()), TrackingService(_tracker())
        try:
            ua, ub = _url(svc_a), _url(svc_b)
            recs_a = [_post(ua, d, ts=i / 30.0) for i, d in enumerate(depths)]
            out = _post_window(ub, np.stack(depths), ts=np.arange(10) / 30.0, window=4)
            assert out["windowed"] is True
            recs_b = out["frames"]
            assert [r["frame"] for r in recs_b] == list(range(1, 11)) and all(r["success"] for r in recs_b)
            for a, b in zip(recs_a, recs_b):
                np.testing.assert_allclose(np.asarray(a["pose"]), np.asarray(b["pose"]), atol=1e-5)
            np.testing.assert_allclose(_traj_poses(_get(ua, "/trajectory")), _traj_poses(_get(ub, "/trajectory")),
                                       atol=1e-5)
        finally:
            svc_a.close()
            svc_b.close()

    def test_window_batches_continue_session(self, service, frames):
        depths, _ = frames
        url = _url(service)
        out1 = _post_window(url, np.stack(depths[:2]), window=2)
        out2 = _post_window(url, np.stack(depths[2:]), window=2)
        assert [r["frame"] for r in out1["frames"] + out2["frames"]] == [1, 2, 3, 4]
        assert _get(url, "/status")["frames"] == 4

    def test_non_keyframe_method_falls_back_per_frame(self, frames):
        depths, _ = frames
        svc = TrackingService(_tracker("projective"))
        try:
            out = _post_window(_url(svc), np.stack(depths))
            assert out["windowed"] is False
            assert [r["frame"] for r in out["frames"]] == [1, 2, 3, 4] and all(r["success"] for r in out["frames"])
        finally:
            svc.close()

    def test_slam_tracker_window_via_service(self, frames):
        from realsensetracker_tpu_torch.tracking.slam import SlamConfig, SlamTracker

        depths, _ = frames
        svc = TrackingService(lambda: SlamTracker(SlamConfig(intrinsics=INTR, device="cpu")))
        try:
            url = _url(svc)
            out = _post_window(url, np.stack(depths), ts=np.arange(4) / 30.0, window=4)
            assert out["windowed"] is True and [r["frame"] for r in out["frames"]] == [1, 2, 3, 4]
            assert _get(url, "/status")["keyframes"] >= 1
        finally:
            svc.close()

    def test_window_decode_preserves_gray_dtype(self):
        g8 = (np.random.RandomState(0).rand(3, H, W) * 255).astype(np.uint8)
        buf = io.BytesIO()
        np.savez(buf, depths=np.ones((3, H, W), np.float32), grays=g8)
        depths, grays, ts = svc_mod._decode_window(buf.getvalue())
        assert grays.dtype == np.uint8
        np.testing.assert_array_equal(grays, g8)
        assert depths.dtype == np.float32 and ts is None

    def test_window_zero_is_400(self, service, frames):
        depths, _ = frames
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_window(_url(service), np.stack(depths[:2]), window=0)
        assert ei.value.code == 400

    def test_midbatch_failure_resyncs_frame_counter(self):
        class _Traj(list):
            def to_tum(self):
                return "\n".join("0 0 0 0 0 0 0 1" for _ in self)

        class _Result:
            pose = torch.eye(4)  # a tensor result: the service reads it back explicitly
            success = torch.tensor(True)

        class _FlakyTracker:
            def __init__(self):
                self.trajectory = _Traj()
                self.pose = np.eye(4)
                self._blew_up = False

            def process(self, depth, ts=None):
                if len(self.trajectory) == 2 and not self._blew_up:
                    self._blew_up = True
                    raise RuntimeError("mid-batch failure")
                self.trajectory.append(1)
                return _Result()

        svc = TrackingService(_FlakyTracker)
        try:
            url = _url(svc)
            d = np.zeros((4, 8, 8), np.float32)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post_window(url, d)
            assert ei.value.code == 500
            assert _get(url, "/status")["sessions"]["default"]["frames"] == 2
            assert len(_get(url, "/trajectory").strip().splitlines()) == 2
            nxt = _post(url, d[0])
            assert nxt["frame"] == 3 and nxt["success"] is True
        finally:
            svc.close()

    def test_bad_window_body_is_400(self, service):
        b = io.BytesIO()
        np.save(b, np.asarray([1.0], np.float32))  # .npy, not .npz -> 400
        req = urllib.request.Request(_url(service) + "/track_window", data=b.getvalue())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert ei.value.code == 400


class TestMetrics:
    def test_metrics_and_latency(self, service, frames):
        depths, _ = frames
        url = _url(service)
        for i in range(3):
            _post(url, depths[i], ts=i / 30.0)
        lat = _get(url, "/status")["sessions"]["default"]["latency"]
        assert lat["count"] == 3 and lat["p50_ms"] > 0 and lat["p95_ms"] >= lat["p50_ms"]
        text = _get(url, "/metrics")
        assert "rst_frames_total 3" in text
        assert 'rst_session_frames{session="default"} 3' in text
        assert 'rst_track_ms{session="default",stat="p50"}' in text

    def test_prometheus_label_escaping(self):
        assert svc_mod._plabel('a"b\\c') == 'a\\"b\\\\c'
        assert svc_mod._plabel("plain") == "plain"

    def test_wide_integer_body_is_400(self, service):
        with pytest.raises(ValueError, match="uint16"):
            svc_mod._as_depth(np.full((H, W), 70000, np.int32))
        b = io.BytesIO()
        np.save(b, np.full((H, W), -1, np.int32))
        req = urllib.request.Request(_url(service) + "/track", data=b.getvalue())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert ei.value.code == 400


def _serve(argv, capsys, posts):
    """rs_serve.main(argv) on a thread; post_frame each of ``posts`` once it
    prints its address. Returns (rc, stdout)."""
    from realsensetracker_tpu_torch.cli import rs_serve

    rc = {}
    th = threading.Thread(target=lambda: rc.setdefault("rc", rs_serve.main(argv)))
    th.start()
    port, out = None, ""
    for _ in range(100):
        out += capsys.readouterr().out
        m = re.search(r"http://127\.0\.0\.1:(\d+)/", out)
        if m:
            port = int(m.group(1))
            break
        time.sleep(0.1)
    assert port, "service did not start"
    for i, d in enumerate(posts):
        assert _post(f"http://127.0.0.1:{port}", d, ts=i / 30.0)["success"]
    th.join(timeout=60)
    assert not th.is_alive()
    return rc["rc"], out + capsys.readouterr().out


class TestServeCli:
    def test_serves_until_max_frames(self, frames, capsys):
        depths, _ = frames
        rc, out = _serve(["--method", "keyframe", "--width", str(W), "--height", str(H), "--fx", "64",
                          "--max-frames", "2", "--device", "cpu"], capsys, depths[:2])
        assert rc == 0 and "served 2 frames" in out and "(keyframe, 80x60)" in out

    def test_slam_method_and_flag_errors(self, frames, capsys):
        from realsensetracker_tpu_torch.cli import rs_serve

        depths, _ = frames
        rc, out = _serve(["--method", "slam", "--width", str(W), "--height", str(H), "--fx", "64",
                          "--max-frames", "1", "--device", "cpu"], capsys, depths[:1])
        assert rc == 0 and "served 1 frames" in out
        assert rs_serve.main(["--tsdf-submap-radius", "0.5", "--device", "cpu"]) == 1
        assert rs_serve.main(["--method", "keyframe", "--tsdf-resolution", "32", "--device", "cpu"]) == 1
        assert "--batch-mesh" in rs_serve.build_parser().format_help()


class TestTsdfService:
    def _mk(self):
        from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
        from realsensetracker_tpu_torch.mapping.tsdf import TsdfConfig

        return _tracker("tsdf", tsdf=TsdfConfig(resolution=64, voxel_size=0.1, origin=(-3.2, -2.4, -0.3), trunc=0.3,
                                                max_range=5.0),
                        projective=ProjectiveIcpConfig(iters=(3, 3), inner_iters=2, samples=768, min_samples=192))

    def test_tsdf_window_matches_per_frame(self):
        depths, _ = jsyn.render_trajectory(JINTR, 7, scene=jsyn.default_scene(seed=3), seed=1, step_scale=0.01)
        depths = [np.asarray(d, np.float32) for d in depths]
        svc_a, svc_b = TrackingService(self._mk()), TrackingService(self._mk())
        try:
            recs_a = [_post(_url(svc_a), d, ts=i / 30.0) for i, d in enumerate(depths)]
            out = _post_window(_url(svc_b), np.stack(depths), ts=np.arange(7) / 30.0, window=3)
            assert out["windowed"] is True and all(r["success"] for r in out["frames"])
            np.testing.assert_allclose(np.asarray(recs_a[-1]["pose"]), np.asarray(out["frames"][-1]["pose"]),
                                       atol=1e-6)
        finally:
            svc_a.close()
            svc_b.close()


class TestRawU16:
    def test_u16_matches_f32_keyframe(self, frames):
        depths, _ = frames
        scale = 1.0 / 5000.0
        raw = [np.asarray(d * 5000.0 + 0.5, np.uint16) for d in depths]
        quant = [r.astype(np.float32) * np.float32(scale) for r in raw]
        mk = _tracker(depth_scale=scale)
        a, b = TrackingService(mk, depth_scale=scale), TrackingService(mk, depth_scale=scale)
        try:
            ra = [_post(_url(a), d, ts=i / 30.0) for i, d in enumerate(quant)]
            rb = [_post(_url(b), d, ts=i / 30.0) for i, d in enumerate(raw)]
            for x, y in zip(ra, rb):
                assert x["success"] == y["success"]
                np.testing.assert_allclose(x["pose"], y["pose"], atol=1e-6)
        finally:
            a.close()
            b.close()

    def test_u16_window_and_slam_host_conversion(self, frames):
        from realsensetracker_tpu_torch.tracking.slam import SlamConfig, SlamTracker

        depths, _ = frames
        scale = 1.0 / 5000.0
        raw = np.stack([np.asarray(d * 5000.0 + 0.5, np.uint16) for d in depths])
        svc = TrackingService(_tracker(depth_scale=scale), depth_scale=scale)
        try:
            rec = _post_window(_url(svc), raw, ts=[i / 30.0 for i in range(4)], window=4)
            assert rec["windowed"] and [f["success"] for f in rec["frames"]] == [True] * 4
        finally:
            svc.close()
        # SLAM accepts raw depth but keeps its 1e-3 default scale while the
        # service runs 1/5000: the guard host-converts to meters instead.
        seen = []

        class _Spy(SlamTracker):
            def process(self, depth, timestamp=None, gray=None):
                seen.append(np.asarray(depth).dtype)
                return super().process(depth, timestamp, gray)

        svc2 = TrackingService(lambda: _Spy(SlamConfig(intrinsics=INTR, device="cpu")), depth_scale=scale)
        try:
            recs = [_post(_url(svc2), raw[i], ts=i / 30.0) for i in range(4)]
            assert all(r["success"] for r in recs) and seen == [np.float32] * 4
        finally:
            svc2.close()
