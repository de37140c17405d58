"""The port's cross-session batching executor (realsensetracker_tpu_torch/
api/batching.py) against the JAX package, on the CPU.

Mirrors tests/test_batching.py case by case at its shapes (the 100x75 INTR
of :32, S = 3 sessions of 4 frames; 64x48 RGB-D with S = 2; 80x60 dense
slots into a 48^3 volume): coalescing with linger_ms and its early out,
the slot lifecycle (capacity errors, release, generations, reseeds),
SessionDesyncError and request timeouts, windows and mixed rounds, u16
staging and host conversion of mixed rounds, submap-radius reseeds, and
dispatch errors delivered to the waiting requests. The mesh-sharded cases
of the JAX file have no counterpart: the port serves one device.

Every session's poses are held to JAX's streams run on the same frames
within 1e-4 (the executor changes how many sessions share a step, never
what a session computes). No server outlives its test, every client call
has a 30 s timeout and every executor a 30 s request timeout.
"""

import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.align import rgbd as jrgbd
from realsensetracker_tpu.api import batching as jbatching
from realsensetracker_tpu.data import synthetic as jsyn
from realsensetracker_tpu.geometry import camera as jcam
from realsensetracker_tpu.mapping.tsdf import TsdfConfig as JTsdfConfig
from realsensetracker_tpu.parallel import streams as jst
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.api.batching import BatchedExecutor, BatchingConfig, SessionDesyncError
from realsensetracker_tpu_torch.api.service import TrackingService, get_json, post_frame, post_window
from realsensetracker_tpu_torch.parallel import streams as pst
from realsensetracker_tpu_torch.tracking.tsdf_tracker import TsdfTracker
from tests.torch_parity import scene as port_scene  # noqa: F401  (caps torch threads)

JINTR = jcam.Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=37.0, width=100, height=75)
JCFG = jproj.ProjectiveIcpConfig(iters=(5, 5, 6), samples=1024)
INTR, CFG = interop.intrinsics_from_jax(JINTR), interop.icp_config_from_jax(JCFG)
S, F = 3, 4
ATOL = 1e-4
TIMEOUT = 30.0  # every client call and every executor request


def _cfg(**kw):
    kw.setdefault("intrinsics", INTR)
    kw.setdefault("icp", CFG)
    kw.setdefault("request_timeout_s", TIMEOUT)
    return BatchingConfig(device="cpu", **kw)


def _post(url, depth, **kw):
    return post_frame(url, depth, timeout=TIMEOUT, **kw)


def _post_window(url, depths, **kw):
    return post_window(url, depths, timeout=TIMEOUT, **kw)


def _get(url, path):
    return get_json(url, path, timeout=TIMEOUT)


def _run_threads(target, n):
    errors = []

    def wrap(i):
        try:
            target(i)
        except BaseException as e:  # handed to the test
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads), "a worker hung"
    assert not errors, errors


@pytest.fixture(scope="module")
def stream_data():
    """(F, S, H, W): S independent trajectories through different scenes."""
    out = []
    for i in range(S):
        d, _ = jsyn.render_trajectory(JINTR, F, scene=jsyn.default_scene(seed=20 + i), seed=i, step_scale=0.015)
        out.append(np.asarray(d, np.float32))
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def jax_poses(stream_data):
    """JAX's aligned all-active run: (F, S, 4, 4) poses after each frame."""
    ref = jst.init_streams(jnp.asarray(stream_data[0]), JINTR, JCFG)
    out = [np.asarray(ref.poses)]
    for f in range(1, F):
        ref, _ = jst.step_streams(ref, jnp.asarray(stream_data[f]), JINTR, JCFG)
        out.append(np.asarray(ref.poses))
    return np.stack(out)


def _close(pose, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(pose, np.float32), ref, rtol=0, atol=atol)


class TestBatchedExecutor:
    def test_concurrent_sessions_coalesce_and_match(self, stream_data, jax_poses):
        ex = BatchedExecutor(_cfg(capacity=S, linger_ms=150.0))
        try:
            trackers = [ex.make_session_tracker() for _ in range(S)]
            barrier = threading.Barrier(S)
            results = [[] for _ in range(S)]

            def worker(i):
                for f in range(F):
                    barrier.wait(timeout=TIMEOUT)
                    results[i].append(trackers[i].process(stream_data[f, i], float(f)))

            _run_threads(worker, S)
            for i in range(S):
                assert [r.frame_index for r in results[i]] == list(range(F))
                assert all(r.success for r in results[i])
                for f in range(F):
                    _close(results[i][f].pose, jax_poses[f, i])
                assert len(trackers[i].trajectory) == F
            st = ex.stats()
            assert st["frames"] == S * F and st["active_sessions"] == S
            assert st["dispatches"] < S * F and st["max_batch"] >= 2
            assert st["mean_batch"] == round(st["frames"] / st["dispatches"], 3)
            assert st["errors"] == 0
        finally:
            ex.close()

    def test_slot_lifecycle_capacity_release_reseed(self, stream_data):
        ex = BatchedExecutor(_cfg(capacity=1))
        try:
            t1 = ex.make_session_tracker()
            with pytest.raises(RuntimeError, match="capacity"):
                ex.make_session_tracker()
            with pytest.raises(ValueError, match="shape"):
                t1.process(np.zeros((8, 8), np.float32))
            r0 = t1.process(stream_data[0, 0], 0.0)
            r1 = t1.process(stream_data[1, 0], 1.0)
            assert r0.success and r1.success
            np.testing.assert_array_equal(r0.pose, np.eye(4))
            assert not np.allclose(r1.pose, np.eye(4), atol=1e-6)
            t1.release()
            t1.release()  # idempotent
            t2 = ex.make_session_tracker()  # reuses the freed slot...
            r = t2.process(stream_data[0, 1], 0.0)
            np.testing.assert_array_equal(r.pose, np.eye(4))  # ...reseeded
            # The STALE facade must not write into the reacquired slot, nor
            # release its successor's slot.
            with pytest.raises(RuntimeError, match="reset|released"):
                t1.process(stream_data[2, 0], 2.0)
            t1.release()
            assert t2.process(stream_data[1, 1], 1.0).success
        finally:
            ex.close()
        with pytest.raises(RuntimeError, match="closed"):
            t2.process(stream_data[1, 1], 1.0)
        with pytest.raises(RuntimeError, match="closed"):
            ex.make_session_tracker()

    @pytest.mark.parametrize("kw, match", [
        ({"capacity": 0}, "capacity"),
        ({"window": 0}, "window"),
        ({"tsdf_submap_radius": 0.5}, "tsdf"),
        ({"rgbd": True, "tsdf": True}, "exclusive"),
    ])
    def test_config_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            BatchedExecutor(_cfg(**kw))

    def test_windowed_requests_coalesce_and_match(self, stream_data, jax_poses):
        ex = BatchedExecutor(_cfg(capacity=S, window=F, linger_ms=150.0))
        try:
            trackers = [ex.make_session_tracker() for _ in range(S)]
            barrier = threading.Barrier(S)
            results = [None] * S

            def worker(i):
                barrier.wait(timeout=TIMEOUT)
                results[i] = trackers[i].process_window(stream_data[:, i], list(range(F)), window=F)

            _run_threads(worker, S)
            for i in range(S):
                assert [r.frame_index for r in results[i]] == list(range(F))
                for f in range(F):
                    _close(results[i][f].pose, jax_poses[f, i])
            st = ex.stats()
            assert st["frames"] == S * F and st["dispatches"] <= 2
        finally:
            ex.close()

    def test_window_request_validation(self, stream_data):
        ex = BatchedExecutor(_cfg(capacity=1, window=2))
        try:
            t1 = ex.make_session_tracker()
            with pytest.raises(ValueError, match="window"):
                ex.track_window(0, stream_data[:3, 0], seed=True)
            rs = t1.process_window(stream_data[:3, 0], window=8)  # chunks to the executor window
            assert len(rs) == 3 and rs[0].success
        finally:
            ex.close()

    def test_mixed_single_and_window_rounds_alternate(self, stream_data, jax_poses):
        """One session posts single frames while another posts windows: the
        two kinds never share a round, both progress, both match JAX."""
        ex = BatchedExecutor(_cfg(capacity=2, window=2, linger_ms=50.0))
        try:
            a, b = ex.make_session_tracker(), ex.make_session_tracker()
            out = {}

            def worker(i):
                if i == 0:
                    out[0] = [a.process(stream_data[f, 0], float(f)) for f in range(F)]
                else:
                    out[1] = b.process_window(stream_data[:, 1], window=2)

            _run_threads(worker, 2)
            for i in range(2):
                assert [r.frame_index for r in out[i]] == list(range(F))
                _close(out[i][-1].pose, jax_poses[F - 1, i])
            assert ex.stats()["frames"] == 2 * F
        finally:
            ex.close()

    def test_linger_early_out_when_batch_is_full(self, stream_data):
        ex = BatchedExecutor(_cfg(capacity=2, linger_ms=30_000.0))
        try:
            trackers = [ex.make_session_tracker() for _ in range(2)]
            t0 = time.monotonic()
            _run_threads(lambda i: trackers[i].process(stream_data[0, i], 0.0), 2)
            assert time.monotonic() - t0 < 25.0  # far below the 30 s linger
            assert ex.stats()["frames"] == 2
        finally:
            ex.close()

    def test_timeout_queued_is_clean_inflight_desyncs(self, stream_data, monkeypatch):
        """A request that times out QUEUED is cancelled (retry-safe); one
        that times out IN-FLIGHT poisons its session facade."""
        real = pst.step_streams_masked
        release = threading.Event()

        def slow(*a, **k):
            release.wait(20.0)
            return real(*a, **k)

        monkeypatch.setattr(pst, "step_streams_masked", slow)
        ex = BatchedExecutor(_cfg(capacity=2, request_timeout_s=1.0))
        try:
            t1, t2 = ex.make_session_tracker(), ex.make_session_tracker()
            errs = {}

            def first():
                try:
                    t1.process(stream_data[0, 0], 0.0)
                except BaseException as e:
                    errs["t1"] = e

            th = threading.Thread(target=first)
            th.start()
            time.sleep(0.3)  # the dispatcher is now blocked inside `slow`
            with pytest.raises(TimeoutError, match="never dispatched"):
                t2.process(stream_data[0, 1], 0.0)
            th.join(timeout=10.0)
            assert isinstance(errs.get("t1"), SessionDesyncError)
            with pytest.raises(SessionDesyncError, match="reset"):
                t1.process(stream_data[1, 0], 1.0)
            release.set()
            r = t2.process(stream_data[0, 1], 0.0)
            assert r.success and r.frame_index == 0
        finally:
            release.set()
            ex.close()

    def test_dispatch_errors_reach_the_waiting_requests(self, stream_data, monkeypatch):
        """A failing dispatch is delivered to every request of its round and
        counted in stats()["errors"]; the dispatcher serves the next round."""
        real = pst.step_streams_masked
        calls = {"n": 0}

        def flaky(*a, **k):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected dispatch failure")
            return real(*a, **k)

        monkeypatch.setattr(pst, "step_streams_masked", flaky)
        ex = BatchedExecutor(_cfg(capacity=2, linger_ms=150.0))
        try:
            trackers = [ex.make_session_tracker() for _ in range(2)]
            errs = []

            def worker(i):
                try:
                    trackers[i].process(stream_data[0, i], 0.0)
                except RuntimeError as e:
                    errs.append(str(e))

            _run_threads(worker, 2)
            assert errs == ["injected dispatch failure"] * 2
            assert ex.stats()["errors"] == 1 and ex.stats()["dispatches"] == 0
            assert trackers[0].process(stream_data[0, 0], 0.0).success
            assert ex.stats()["dispatches"] == 1
        finally:
            ex.close()

    def test_stress_many_sessions_no_lost_update(self, stream_data):
        """More producer threads than cores, a tiny switch interval: every
        request is delivered once, in order, and the executor's counters
        add up (a lost update in the queues or stats would break them)."""
        import sys

        n, frames = 12, 2
        ex = BatchedExecutor(_cfg(capacity=n))
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            trackers = [ex.make_session_tracker() for _ in range(n)]
            results = [[] for _ in range(n)]

            def worker(i):
                for f in range(frames):
                    results[i].append(trackers[i].process(stream_data[f, i % S], float(f)))

            _run_threads(worker, n)
            for i in range(n):
                assert [r.frame_index for r in results[i]] == list(range(frames))
                assert all(r.success for r in results[i])
                _close(results[i][1].pose, results[i % S][1].pose, atol=1e-6)  # same frames, same poses
            st = ex.stats()
            assert st["frames"] == n * frames and st["errors"] == 0
            assert round(st["mean_batch"] * st["dispatches"]) == n * frames
        finally:
            sys.setswitchinterval(old)
            ex.close()

    def test_device_defaults_to_cuda(self):
        cfg = BatchingConfig(intrinsics=INTR)
        assert cfg.device == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                BatchedExecutor(cfg)


class TestBatchedService:
    def test_sessions_through_http_coalesce_and_match(self, stream_data, jax_poses):
        ex = BatchedExecutor(_cfg(capacity=S, linger_ms=50.0))
        svc = TrackingService(ex.make_session_tracker, extra_status=ex.stats)
        try:
            url = f"http://127.0.0.1:{svc.port}"

            def worker(i):
                for f in range(F):
                    assert _post(url, stream_data[f, i], ts=float(f), session=f"s{i}")["frame"] == f + 1

            _run_threads(worker, S)
            st = _get(url, "/status")
            assert st["frames"] == S * F
            assert st["batching"]["frames"] == S * F and st["batching"]["capacity"] == S
            assert st["batching"]["active_sessions"] == S and st["batching"]["errors"] == 0
            for i in range(S):
                assert st["sessions"][f"s{i}"]["frames"] == F
                _close(_get(url, f"/pose?session=s{i}")["pose"], jax_poses[F - 1, i])
                assert len(_get(url, f"/trajectory?session=s{i}").strip().splitlines()) == F
            text = _get(url, "/metrics")
            assert f"rst_batch_frames_total {S * F}" in text
            assert "rst_batch_dispatches_total" in text and "rst_batch_mean_size" in text
        finally:
            svc.close()
            ex.close()

    def test_track_window_through_http_batched(self, stream_data, jax_poses):
        ex = BatchedExecutor(_cfg(capacity=S, window=F))
        svc = TrackingService(ex.make_session_tracker, extra_status=ex.stats)
        try:
            url = f"http://127.0.0.1:{svc.port}"
            out = _post_window(url, stream_data[:, 0], ts=np.arange(F, dtype=np.float64), session="w0", window=F)
            assert out["windowed"] is True
            assert [r["frame"] for r in out["frames"]] == list(range(1, F + 1))
            for f in range(F):
                _close(out["frames"][f]["pose"], jax_poses[f, 0])
            st = _get(url, "/status")
            assert st["batching"]["frames"] == F and st["batching"]["dispatches"] == 1
            assert st["batching"]["mean_batch"] == 1.0  # sessions per round, not frames
        finally:
            svc.close()
            ex.close()

    def test_track_window_honest_windowed_flag(self, stream_data):
        ex = BatchedExecutor(_cfg(capacity=1))
        svc = TrackingService(ex.make_session_tracker, extra_status=ex.stats)
        try:
            out = _post_window(f"http://127.0.0.1:{svc.port}", stream_data[:2, 0], window=4)
            assert out["windowed"] is False
            assert len(out["frames"]) == 2 and all(r["success"] for r in out["frames"])
        finally:
            svc.close()
            ex.close()

    def test_capacity_exhaustion_is_500(self, stream_data):
        ex = BatchedExecutor(_cfg(capacity=1))
        svc = TrackingService(ex.make_session_tracker, extra_status=ex.stats)
        try:
            url = f"http://127.0.0.1:{svc.port}"
            _post(url, stream_data[0, 0], session="a")
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, stream_data[0, 1], session="b")
            assert ei.value.code == 500 and "capacity" in ei.value.read().decode()
            with urllib.request.urlopen(urllib.request.Request(url + "/reset?session=a", data=b""),
                                        timeout=TIMEOUT) as r:
                assert r.status == 200
            assert _post(url, stream_data[0, 1], session="b")["frame"] == 1
        finally:
            svc.close()
            ex.close()


# --- RGB-D slots -------------------------------------------------------------

JRGBD_INTR = jcam.Intrinsics(fx=64.0, fy=64.0, cx=31.5, cy=23.5, width=64, height=48)
JRGBD_CFG = jrgbd.RgbdIcpConfig(iters=(4, 4), samples=512, min_samples=128)
S2 = 2


@pytest.fixture(scope="module")
def rgbd_data():
    depths, grays = [], []
    for i in range(S2):
        d, c, _ = jsyn.render_trajectory_rgbd(JRGBD_INTR, F, scene=jsyn.default_scene(seed=70 + i), seed=i,
                                              step_scale=0.01)
        depths.append(np.asarray(d, np.float32))
        grays.append(np.asarray(jsyn.intensity_from_rgb(c), np.float32))
    return np.stack(depths, 1), np.stack(grays, 1)


class TestRgbdBatched:
    def test_rgbd_executor_through_http(self, rgbd_data):
        depths, grays = rgbd_data
        js = jst.blank_streams_rgbd(JRGBD_INTR, JRGBD_CFG, num_streams=S2)
        on = jnp.ones(S2, bool)
        for f in range(F):
            js, _ = jst.step_streams_masked_rgbd(js, jnp.asarray(depths[f]), jnp.asarray(grays[f]), on,
                                                 jnp.full(S2, f == 0), JRGBD_INTR, JRGBD_CFG)
        ex = BatchedExecutor(_cfg(intrinsics=interop.intrinsics_from_jax(JRGBD_INTR), rgbd=True,
                                  rgbd_icp=interop.rgbd_config_from_jax(JRGBD_CFG), capacity=S2, window=2))
        svc = TrackingService(ex.make_session_tracker, extra_status=ex.stats)
        try:
            url = f"http://127.0.0.1:{svc.port}"
            with pytest.raises(urllib.error.HTTPError) as ei:  # color missing: a clean 500
                _post(url, depths[0, 0], session="s0")
            assert "intensity" in ei.value.read().decode()
            for f in range(F):
                assert _post(url, depths[f, 0], ts=float(f), color=grays[f, 0], session="s0")["success"]
            # u8 grays through /track_window scale by 1/255 like /track's color
            g8 = np.round(grays[:, 1] * 255).astype(np.uint8)
            out = _post_window(url, depths[:, 1], grays=g8, ts=np.arange(F, dtype=np.float64), session="s1",
                               window=2)
            assert len(out["frames"]) == F and all(r["success"] for r in out["frames"])
            _close(_get(url, "/pose?session=s0")["pose"], np.asarray(js.poses)[0])
            assert ex.stats()["errors"] == 0
        finally:
            svc.close()
            ex.close()


class TestServeCliBatched:
    def test_batched_flag_end_to_end(self, capsys):
        import re

        from realsensetracker_tpu_torch.cli import rs_serve

        w, h = 64, 48
        intr = jcam.Intrinsics(fx=64.0, fy=64.0, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
        depths, _ = jsyn.render_trajectory(intr, 2, seed=0, step_scale=0.01)
        rc = {}

        def run():
            rc["rc"] = rs_serve.main(["--batched", "--batch-capacity", "2", "--width", str(w), "--height", str(h),
                                      "--fx", "64", "--max-frames", "2", "--device", "cpu"])

        th = threading.Thread(target=run)
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
        assert "batched" in out
        url = f"http://127.0.0.1:{port}"
        assert _post(url, np.asarray(depths[0]), ts=0.0)["success"]
        assert _post(url, np.asarray(depths[1]), ts=1 / 30.0)["success"]
        th.join(timeout=60)
        assert not th.is_alive() and rc["rc"] == 0
        assert "served 2 frames" in capsys.readouterr().out


# --- dense (TSDF) slots --------------------------------------------------------

JTSDF_INTR = jcam.Intrinsics(fx=64.0, fy=64.0, cx=39.5, cy=29.5, width=80, height=60)
JTSDF_ICP = jproj.ProjectiveIcpConfig(iters=(3, 3), inner_iters=2, samples=768, min_samples=192)
JVOL = JTsdfConfig(resolution=48, voxel_size=0.12, origin=(-2.88, -2.16, -0.4), trunc=0.36, max_range=5.0)
TSDF_INTR, TSDF_ICP = interop.intrinsics_from_jax(JTSDF_INTR), interop.icp_config_from_jax(JTSDF_ICP)
VOL = interop.tsdf_config_from_jax(JVOL)
S3 = 2


@pytest.fixture(scope="module")
def tsdf_data():
    out = []
    for i in range(S3):
        d, _ = jsyn.render_trajectory(JTSDF_INTR, F, scene=jsyn.default_scene(seed=30 + i), seed=i, step_scale=0.01)
        out.append(np.asarray(d, np.float32))
    return np.stack(out, 1)


class TestTsdfSlots:
    def test_tsdf_executor_through_http(self, tsdf_data):
        js = jst.blank_tsdf_streams(JTSDF_INTR, JVOL, num_streams=S3)
        on = jnp.ones(S3, bool)
        for f in range(F):
            js, _ = jst.step_tsdf_streams_masked(js, jnp.asarray(tsdf_data[f]), on, jnp.full(S3, f == 0),
                                                 JTSDF_INTR, JVOL, JTSDF_ICP)
        ex = BatchedExecutor(_cfg(intrinsics=TSDF_INTR, icp=TSDF_ICP, capacity=S3, tsdf=True, tsdf_cfg=VOL,
                                  window=2))
        svc = TrackingService(ex.make_session_tracker)
        try:
            url = f"http://127.0.0.1:{svc.port}"
            recs = {"s0": [_post(url, tsdf_data[f, 0], ts=f / 30.0, session="s0") for f in range(F)]}
            recs["s1"] = _post_window(url, tsdf_data[:, 1], ts=np.arange(F) / 30.0, window=2, session="s1")["frames"]
            for i, sid in enumerate(("s0", "s1")):
                _close(np.asarray(recs[sid][-1]["pose"]), np.asarray(js.poses)[i])
                tr = TsdfTracker(TSDF_INTR, volume=VOL, icp=TSDF_ICP, device="cpu")
                for f in range(F):
                    tr.process(tsdf_data[f, i], float(f))
                _close(np.asarray(recs[sid][-1]["pose"]), tr.pose)
            assert ex.stats()["frames"] == 2 * F
        finally:
            svc.close()
            ex.close()

    def test_submap_radius_gives_unbounded_extent(self):
        """A session walking out of its volume stays tracked under
        tsdf_submap_radius (anchor-composed reseeds), per frame and through
        windowed chunks (the anchor updates at the reseed, not at
        detection), where the fixed single volume degrades."""
        from realsensetracker_tpu_torch.data import synthetic as psyn
        from realsensetracker_tpu_torch.mapping.tsdf import TsdfConfig

        vol = TsdfConfig(resolution=48, voxel_size=0.05, origin=(-1.2, -1.2, -0.2625), trunc=0.15, max_range=3.0,
                         max_depth=4.0)
        rng = np.random.RandomState(3)
        ns = 12
        centers = np.stack([np.linspace(-0.5, 3.0, ns), rng.uniform(-0.3, 0.55, ns), rng.uniform(0.9, 1.6, ns)], 1)
        scene = psyn.Scene(sphere_centers=torch.tensor(centers, dtype=torch.float32),
                           sphere_radii=torch.tensor(rng.uniform(0.16, 0.32, ns), dtype=torch.float32),
                           floor_y=0.9, wall_z=2.2)
        nf = 40
        gt = np.tile(np.eye(4, dtype=np.float32), (nf, 1, 1))
        gt[:, 0, 3] = np.linspace(0.0, 2.0, nf)
        depths = np.stack([psyn.render_depth(TSDF_INTR, torch.from_numpy(T), scene).numpy() for T in gt])

        def run(radius, window):
            ex = BatchedExecutor(_cfg(intrinsics=TSDF_INTR, icp=TSDF_ICP, capacity=1, tsdf=True, tsdf_cfg=vol,
                                      tsdf_submap_radius=radius, window=window))
            try:
                tr = ex.make_session_tracker()
                if window > 1:
                    rs = tr.process_window(depths, window=window)
                else:
                    rs = [tr.process(depths[f], float(f)) for f in range(nf)]
                est = np.stack(list(tr.trajectory.poses))
                return rs, np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1), tr
            finally:
                ex.close()

        rs_fix, err_fix, _ = run(0.0, 1)
        rs_sub, err_sub, tr_sub = run(0.6, 1)
        assert all(r.success for r in rs_sub)
        assert tr_sub.num_reseeds >= 2 and err_sub.max() < 0.25
        assert sum(r.success for r in rs_fix) < nf or err_fix.max() > 3 * err_sub.max()
        rs_win, err_win, tr_win = run(0.6, 4)
        assert all(r.success for r in rs_win)
        assert tr_win.num_reseeds >= 2 and err_win.max() < 0.3


# --- raw u16 -------------------------------------------------------------------


class TestU16Batched:
    def test_u16_sessions_match_f32(self, stream_data):
        scale = 1.0 / 5000.0
        raw = np.asarray(stream_data * 5000.0 + 0.5, np.uint16)
        quant = raw.astype(np.float32) * np.float32(scale)
        outs = []
        for data, kw in ((quant, {}), (raw, {"depth_scale": scale})):
            ex = BatchedExecutor(_cfg(capacity=S, **kw))
            try:
                trackers = [ex.make_session_tracker() for _ in range(S)]
                outs.append([[trackers[i].process(data[f, i], float(f)) for f in range(F)] for i in range(S)])
            finally:
                ex.close()
        for i in range(S):
            for a, b in zip(outs[0][i], outs[1][i]):
                assert a.success == b.success
                np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=1e-6)

    def test_mixed_window_list_converts_to_meters(self, stream_data):
        scale = 1.0 / 5000.0
        raw = np.asarray(stream_data * 5000.0 + 0.5, np.uint16)
        quant = raw.astype(np.float32) * np.float32(scale)
        outs = []
        for mixed in (False, True):
            ex = BatchedExecutor(_cfg(capacity=1, window=4, depth_scale=scale))
            try:
                frames = [quant[f, 0] for f in range(4)]
                if mixed:
                    frames[1], frames[2] = raw[1, 0], raw[2, 0]
                outs.append(ex.make_session_tracker().process_window(frames, window=4))
            finally:
                ex.close()
        for a, b in zip(*outs):
            assert a.success == b.success
            np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=1e-6)

    def test_mixed_round_host_converts(self, stream_data, jax_poses):
        """One session posts raw u16, another f32 meters, in the SAME
        linger-coalesced round: the round stages f32 and converts the
        integer request on the host."""
        scale = 1.0 / 5000.0
        raw = np.asarray(stream_data * 5000.0 + 0.5, np.uint16)
        quant = raw.astype(np.float32) * np.float32(scale)
        ex = BatchedExecutor(_cfg(capacity=2, linger_ms=150.0, depth_scale=scale))
        try:
            trackers = [ex.make_session_tracker() for _ in range(2)]
            barrier = threading.Barrier(2)
            results = [[] for _ in range(2)]

            def worker(i):
                for f in range(F):
                    barrier.wait(timeout=TIMEOUT)
                    results[i].append(trackers[i].process(raw[f, i] if i == 0 else quant[f, i], float(f)))

            _run_threads(worker, 2)
            assert ex.stats()["max_batch"] == 2
            for i in range(2):
                assert all(r.success for r in results[i])
                _close(results[i][-1].pose, jax_poses[F - 1, i], atol=2e-4)  # u16 quantization
        finally:
            ex.close()


# --- interop -------------------------------------------------------------------


class TestBatchingInterop:
    def test_batching_config_from_jax(self):
        jcfg = jbatching.BatchingConfig(intrinsics=JTSDF_INTR, icp=JTSDF_ICP, capacity=4, linger_ms=5.0, window=3,
                                        tsdf=True, tsdf_cfg=JVOL, tsdf_submap_radius=0.7, depth_scale=2e-4)
        cfg = interop.batching_config_from_jax(jcfg, device="cpu")
        assert cfg == BatchingConfig(intrinsics=TSDF_INTR, icp=TSDF_ICP, capacity=4, linger_ms=5.0, window=3,
                                     tsdf=True, tsdf_cfg=VOL, tsdf_submap_radius=0.7, depth_scale=2e-4,
                                     rgbd_icp=interop.rgbd_config_from_jax(jcfg.rgbd_icp), device="cpu")
        with pytest.raises(ValueError, match="mesh"):
            interop.batching_config_from_jax(jcfg.__class__(intrinsics=JINTR, mesh=object()), device="cpu")
