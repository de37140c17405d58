"""Tracking-as-a-service: POST depth frames over HTTP, get SE(3) poses back.

Port of realsensetracker_tpu/api/service.py (pure host code: the stdlib
HTTP server, the session table, the body codecs and the clients). A
production deployment is a long-lived service fed by remote producers.
`TrackingService` wraps any tracker with a `.process(depth, ts, ...)`
method (api.Tracker, tracking.slam.SlamTracker, the batched session
facades of api/batching.py) in a stdlib ThreadingHTTPServer:

  POST /track        body = .npy (H, W) float32 depth, or .npz with keys
                     depth [+ color] for RGB-D methods; optional ?ts=SECONDS
                     -> JSON {frame, success, pose, rmse, inlier_fraction, ms}
  POST /track_window body = .npz with depths (B, H, W) [+ grays (B, H, W)]
                     [+ ts (B,)]; optional ?window=W. Runs up to W frames
                     per host copy (tracking/keyframe.py process_window)
                     when the session tracker supports it, and a per-frame
                     loop otherwise. Results are per-frame IDENTICAL to
                     /track.
                     -> JSON {frames: [record...], ms, windowed}
  GET  /pose         latest pose + frame counter
  GET  /status       service + per-session tracker stats (incl. latency)
  GET  /metrics      Prometheus text format (frames, latency quantiles)
  GET  /trajectory   full trajectory, TUM text format
  POST /reset        fresh tracker state (new trajectory)

Every endpoint takes ?session=NAME (default "default"): each session is an
independent tracker created on first use, so N producers track N
independent streams against one device.

For ordinary trackers a lock serializes device work (/track requests and
the reads of a tracker's state), so N producers can POST concurrently and
get queued, ordered results. Trackers that declare
`supports_concurrent_process` (api/batching.py facades) instead run their
device work in their OWN dispatcher thread; the service calls their
`process` outside the lock, because overlapping calls are what coalesce
into one batched dispatch. The client side is `post_frame` / `post_window`
/ `get_json` (stdlib urllib).
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
import urllib.request
from collections import deque

import numpy as np
import torch


class _Session:
    """Per-session tracker + counters + latency window (last 512 frames)."""

    __slots__ = ("tracker", "frames", "lat_ms")

    def __init__(self, tracker):
        self.tracker = tracker
        self.frames = 0
        self.lat_ms: deque = deque(maxlen=512)

    def record(self, n_frames: int, total_ms: float) -> None:
        self.frames += n_frames
        per = total_ms / max(n_frames, 1)
        self.lat_ms.extend([per] * n_frames)

    def latency(self) -> dict:
        if not self.lat_ms:
            return {"count": 0}
        xs = np.sort(np.asarray(self.lat_ms))
        q = lambda p: float(xs[min(len(xs) - 1, int(p * len(xs)))])
        return {
            "count": len(xs),
            "mean_ms": round(float(xs.mean()), 3),
            "p50_ms": round(q(0.50), 3),
            "p95_ms": round(q(0.95), 3),
            "last_ms": round(float(self.lat_ms[-1]), 3),
        }


def _plabel(name: str) -> str:
    """Escape a Prometheus label value (exposition format: \\ then \")."""
    return name.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _color_kwarg(tracker) -> str:
    """api.Tracker.process takes color=, SlamTracker.process takes gray=.

    Inspect only the actual parameters (co_varnames also lists locals, so
    a local named `gray` in a color-taking process would mislabel it)."""
    code = tracker.process.__code__
    params = code.co_varnames[: code.co_argcount + code.co_kwonlyargcount]
    return "gray" if "gray" in params else "color"


def host_array(val) -> np.ndarray:
    """A tracker's frame or result value as a host array: a tensor on any
    device is copied back explicitly, anything else goes through numpy."""
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def _current_pose(tracker) -> np.ndarray:
    pose = getattr(tracker, "pose", None)
    if pose is None:
        traj = tracker.trajectory
        pose = traj.poses[-1] if len(traj) else np.eye(4)
    return host_array(pose).astype(np.float64)


def _result_record(res, frame: int, ms: float) -> dict:
    rec = {"frame": frame, "ms": round(ms, 3)}
    for key in ("success", "rmse", "inlier_fraction"):
        if hasattr(res, key):
            val = host_array(getattr(res, key))
            rec[key] = bool(val) if key == "success" else float(val)
    pose = host_array(res.pose).astype(np.float64)
    rec["pose"] = [[round(float(v), 9) for v in row] for row in pose]
    return rec


class TrackingService:
    """HTTP frame-in/pose-out tracking service around a tracker factory."""

    def __init__(self, make_tracker, host: str = "127.0.0.1", port: int = 0,
                 max_frames: int | None = None, extra_status=None,
                 depth_scale: float = 1e-3):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._make_tracker = make_tracker
        # Meters per raw unit for INTEGER depth bodies. Clients may POST
        # raw uint16 (half the f32 bytes); trackers that advertise
        # accepts_raw_depth get them verbatim (and convert on device --
        # api.Tracker, BatchedSessionTracker), others get host-converted
        # meters.
        self._depth_scale = depth_scale
        self._extra_status = extra_status  # callable -> dict, merged into
        # /status under "batching" (see api/batching.py BatchedExecutor.stats)
        self._lock = threading.Lock()  # serializes device dispatches
        self._sessions: dict[str, _Session] = {}
        self._frames = 0  # total across sessions
        self._started = time.time()
        self._max_frames = max_frames
        self.done = threading.Event()  # set once max_frames frames tracked
        svc = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, obj, code: int = 200) -> None:
                self._send(code, json.dumps(obj).encode())

            def _session(self) -> str:
                if "session=" in self.path:
                    return self.path.split("session=")[1].split("&")[0] or "default"
                return "default"

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/pose":
                    with svc._lock:
                        sess = svc._get_session(self._session())
                        pose = _current_pose(sess.tracker)
                        frames = sess.frames
                    self._send_json({
                        "frame": frames,
                        "pose": [[float(v) for v in row] for row in pose],
                    })
                elif path == "/status":
                    self._send_json(svc.status())
                elif path == "/metrics":
                    self._send(200, svc.metrics().encode(),
                               "text/plain; version=0.0.4")
                elif path == "/trajectory":
                    with svc._lock:
                        sess = svc._get_session(self._session())
                        text = sess.tracker.trajectory.to_tum()
                    self._send(200, text.encode(), "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                path = self.path.split("?")[0]
                if path == "/reset":
                    name = self._session()
                    with svc._lock:
                        old = svc._sessions.pop(name, None)
                    # Release shared resources (a batched tracker's slot)
                    # deterministically -- GC alone defers the release while
                    # any in-flight handler still references the tracker,
                    # which would make a follow-up session hit a spurious
                    # capacity-exhausted 500.
                    release = getattr(
                        old.tracker if old else None, "release", None
                    )
                    if release is not None:
                        release()
                    self._send_json({"reset": True, "session": name})
                    return
                if path == "/track_window":
                    self._track_window()
                    return
                if path != "/track":
                    self._send(404, b"not found", "text/plain")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    depth, color = _decode_frame(self.rfile.read(n))
                    ts = None
                    if "ts=" in self.path:
                        ts = float(self.path.split("ts=")[1].split("&")[0])
                except Exception as e:  # malformed request, not a crash
                    self._send_json({"error": str(e)}, code=400)
                    return
                try:
                    with svc._lock:
                        sess = svc._get_session(self._session())

                    def call(tracker):
                        kwargs = {}
                        if color is not None:
                            kwargs[_color_kwarg(tracker)] = color
                        d = svc._ingest_depth(depth, tracker)
                        return tracker.process(d, ts, **kwargs), 1

                    res, ms, frames, total = svc._run_tracked(sess, call)
                    self._send_json(_result_record(res, frames, ms))
                except Exception as e:
                    self._send_json({"error": str(e)}, code=500)
                    return
                # max_frames bounds the TOTAL across sessions.
                if svc._max_frames is not None and total >= svc._max_frames:
                    svc.done.set()

            def _track_window(self):
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    depths, grays, ts = _decode_window(self.rfile.read(n))
                    window = 8
                    if "window=" in self.path:
                        window = int(
                            self.path.split("window=")[1].split("&")[0]
                        )
                    if window < 1:
                        raise ValueError(f"window must be >= 1, got {window}")
                except Exception as e:  # malformed request, not a crash
                    self._send_json({"error": str(e)}, code=400)
                    return
                sess = None
                base = 0
                try:
                    with svc._lock:
                        sess = svc._get_session(self._session())
                        base = sess.frames

                    def call(tracker):
                        d = svc._ingest_depth(depths, tracker)
                        rw = _process_window(tracker, d, ts, grays, window)
                        return rw, len(rw[0])

                    (results, windowed), ms, _, total = svc._run_tracked(
                        sess, call
                    )
                    per = ms / max(len(results), 1)
                    recs = [
                        _result_record(r, base + 1 + i, per)
                        for i, r in enumerate(results)
                    ]
                    self._send_json({
                        "frames": recs,
                        "ms": round(ms, 3),
                        "windowed": windowed,
                    })
                except Exception as e:
                    # The tracker may have consumed a prefix of the batch
                    # before failing (its trajectory already advanced);
                    # resync the session counter so subsequent frame numbers
                    # stay aligned with /trajectory rows.
                    if sess is not None:
                        with svc._lock:
                            done = len(sess.tracker.trajectory) - base
                            if done > 0:
                                sess.frames = base + done
                                svc._frames += done
                    self._send_json({"error": str(e)}, code=500)
                    return
                if svc._max_frames is not None and total >= svc._max_frames:
                    svc.done.set()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def _get_session(self, name: str) -> _Session:
        """Caller must hold self._lock. Creates the session on first use."""
        if name not in self._sessions:
            self._sessions[name] = _Session(self._make_tracker())
        return self._sessions[name]

    def _ingest_depth(self, depth, tracker):
        """Raw integer depth bodies pass through to trackers that accept
        them (accepts_raw_depth: api.Tracker via config.depth_scale,
        SlamTracker via SlamConfig.depth_scale, BatchedSessionTracker via
        BatchingConfig.depth_scale -- all convert ON DEVICE at half the
        f32 upload bytes); anything else gets host-converted meters at
        this service's depth_scale.

        Raw passthrough happens ONLY when the tracker's own depth_scale
        agrees with the service's: a raw-accepting tracker converts at
        ITS scale, so a mismatch (e.g. a SlamTracker left at the 1e-3
        default behind a 1/5000 service) would silently misread every
        frame by the ratio. Meters are unambiguous, so on mismatch (or
        when the tracker's scale is undiscoverable) the service converts
        on host instead."""
        if not np.issubdtype(np.asarray(depth).dtype, np.integer):
            return depth
        if getattr(tracker, "accepts_raw_depth", False):
            ts = getattr(tracker, "depth_scale", None)
            if ts is None:
                ts = getattr(getattr(tracker, "config", None),
                             "depth_scale", None)
            if ts is not None and float(ts) == float(self._depth_scale):
                return depth
        return np.asarray(depth).astype(np.float32) * self._depth_scale

    def _run_tracked(self, sess: _Session, call):
        """Run `call(tracker) -> (out, n_frames)` with the dispatch-lock
        discipline, update counters, and return
        (out, ms, session_frames, total_frames).

        Ordinary trackers dispatch while holding the service lock (one
        tracker's device work at a time, in request order).
        Trackers with `supports_concurrent_process` (api/batching.py
        facades) serialize device work in their own dispatcher thread and
        MUST run outside the lock -- overlapping calls are what coalesce
        into one batched dispatch.
        """
        concurrent = getattr(
            sess.tracker, "supports_concurrent_process", False
        )
        dispatch_lock = (
            contextlib.nullcontext() if concurrent else self._lock
        )
        with dispatch_lock:
            t0 = time.perf_counter()
            out, n = call(sess.tracker)
            ms = 1000 * (time.perf_counter() - t0)
        with self._lock:
            sess.record(n, ms)
            self._frames += n
            return out, ms, sess.frames, self._frames

    def status(self) -> dict:
        with self._lock:
            sessions = {}
            for name, sess in self._sessions.items():
                rec = {
                    "frames": sess.frames,
                    "tracker": type(sess.tracker).__name__,
                    "latency": sess.latency(),
                }
                kf = getattr(sess.tracker, "keyframe_count", None)
                if kf is not None:
                    rec["keyframes"] = int(kf)
                sessions[name] = rec
            out = {
                "frames": self._frames,
                "uptime_s": round(time.time() - self._started, 1),
                "sessions": sessions,
            }
            if "default" in sessions:
                out["tracker"] = sessions["default"]["tracker"]
                if "keyframes" in sessions["default"]:
                    out["keyframes"] = sessions["default"]["keyframes"]
        if self._extra_status is not None:
            out["batching"] = self._extra_status()
        return out

    def metrics(self) -> str:
        """Prometheus text exposition of the service counters."""
        lines = [
            "# TYPE rst_frames_total counter",
            f"rst_frames_total {self._frames}",
            "# TYPE rst_uptime_seconds gauge",
            f"rst_uptime_seconds {round(time.time() - self._started, 1)}",
        ]
        with self._lock:
            items = [(n, s.frames, s.latency()) for n, s in
                     self._sessions.items()]
        lines.append("# TYPE rst_session_frames counter")
        for name, frames, _ in items:
            lines.append(
                f'rst_session_frames{{session="{_plabel(name)}"}} {frames}'
            )
        lines.append("# TYPE rst_track_ms gauge")
        for name, _, lat in items:
            for key in ("p50_ms", "p95_ms", "mean_ms", "last_ms"):
                if key in lat:
                    lines.append(
                        f'rst_track_ms{{session="{_plabel(name)}",'
                        f'stat="{key[:-3]}"}} {lat[key]}'
                    )
        if self._extra_status is not None:
            b = self._extra_status()
            lines += [
                "# TYPE rst_batch_dispatches_total counter",
                f"rst_batch_dispatches_total {b.get('dispatches', 0)}",
                "# TYPE rst_batch_errors_total counter",
                f"rst_batch_errors_total {b.get('errors', 0)}",
                "# TYPE rst_batch_frames_total counter",
                f"rst_batch_frames_total {b.get('frames', 0)}",
                "# TYPE rst_batch_mean_size gauge",
                f"rst_batch_mean_size {b.get('mean_batch', 0.0)}",
                "# TYPE rst_batch_active_sessions gauge",
                f"rst_batch_active_sessions {b.get('active_sessions', 0)}",
            ]
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _decode_frame(body: bytes):
    """Request body -> (depth (H, W), color | None).

    .npy = a single depth array; .npz (zip magic) = 'depth' [+ 'color'].
    Depth keeps an INTEGER dtype (raw uint16 counts -- half the f32
    bytes; scaled by the service/tracker depth_scale); floats coerce to
    f32 meters.
    """
    buf = io.BytesIO(body)
    if body[:2] == b"PK":
        with np.load(buf) as z:
            if "depth" not in z:
                raise ValueError(".npz body needs a 'depth' array")
            depth = _as_depth(z["depth"])
            color = np.asarray(z["color"]) if "color" in z else None
        return depth, color
    arr = np.load(buf, allow_pickle=False)
    return _as_depth(arr), None


def _as_depth(arr) -> np.ndarray:
    """Integer bodies stage as uint16 RAW units, floats as f32 meters.

    Wider integer dtypes are accepted only when their VALUES fit uint16
    (a bare astype would silently wrap 100000 -> 34464 / -1 -> 65535 and
    the tracker would register against garbage); out-of-range integers
    are a 400 to the client, who should send uint16 raw units or f32
    meters."""
    a = np.asarray(arr)
    if np.issubdtype(a.dtype, np.integer):
        if a.dtype != np.uint16 and a.size and (
            int(a.min()) < 0 or int(a.max()) > 65535
        ):
            raise ValueError(
                "integer depth exceeds the uint16 raw-unit range; send "
                "uint16 raw units or float32 meters"
            )
        return a.astype(np.uint16)
    return a.astype(np.float32)


def _decode_window(body: bytes):
    """/track_window body -> (depths (B, H, W), grays | None, ts | None).

    grays keep their dtype: uint8 frames must reach the trackers' _as_gray
    unscaled so its /255 branch fires (api/tracker.py), identically to
    /track's color path."""
    if body[:2] != b"PK":
        raise ValueError("/track_window needs an .npz body with 'depths'")
    with np.load(io.BytesIO(body)) as z:
        if "depths" not in z:
            raise ValueError(".npz body needs a 'depths' (B, H, W) array")
        depths = _as_depth(z["depths"])
        grays = np.asarray(z["grays"]) if "grays" in z else None
        ts = np.asarray(z["ts"], np.float64) if "ts" in z else None
    if depths.ndim != 3 or len(depths) == 0:
        raise ValueError(f"depths must be non-empty (B, H, W), got {depths.shape}")
    if grays is not None and len(grays) != len(depths):
        raise ValueError("grays/depths length mismatch")
    if ts is not None and len(ts) != len(depths):
        raise ValueError("ts/depths length mismatch")
    return depths, grays, ts


def _process_window(tracker, depths, ts, grays, window: int):
    """Run a frame batch through the tracker's window path when one exists
    (api.Tracker methods 'keyframe' and 'tsdf', tracking.slam.SlamTracker,
    the batched facades), else a per-frame loop. Both are per-frame
    identical; the window path costs one host copy per `window` frames
    instead of one per frame. Returns (results, used_window_path)."""
    ts_list = list(ts) if ts is not None else [None] * len(depths)
    pw = getattr(tracker, "process_window", None)
    cfg = getattr(tracker, "config", None)
    # api.Tracker scans methods 'keyframe' and 'tsdf'; SlamConfig has no
    # .method (SlamTracker.process_window handles its own truncation).
    method = getattr(cfg, "method", "keyframe")
    if pw is not None and method in ("keyframe", "tsdf"):
        pw_code = pw.__code__
        takes_grays = "grays" in pw_code.co_varnames[
            : pw_code.co_argcount + pw_code.co_kwonlyargcount
        ]
        # "windowed" is honest only if frames actually run together: a
        # batched facade with BatchingConfig.window=1 (or ?window=1)
        # dispatches per frame even through its process_window.
        scans = min(window, getattr(tracker, "window_capacity", window)) > 1
        if grays is None and not getattr(cfg, "use_rgb", False):
            return pw(list(depths), ts_list, window=window), scans
        if grays is not None and takes_grays:
            return (
                pw(list(depths), ts_list, window=window, grays=list(grays)),
                scans,
            )
    out = []
    for i, d in enumerate(depths):
        kwargs = {}
        if grays is not None:
            kwargs[_color_kwarg(tracker)] = grays[i]
        out.append(tracker.process(d, ts_list[i], **kwargs))
    return out, False


# -- stdlib client helpers ---------------------------------------------------

def post_frame(base_url: str, depth, ts: float | None = None,
               color=None, session: str | None = None,
               timeout: float = 120.0) -> dict:
    """Client: POST one frame to a TrackingService; returns the JSON record."""
    buf = io.BytesIO()
    if color is not None:
        np.savez(buf, depth=_as_depth(depth), color=np.asarray(color))
    else:
        np.save(buf, _as_depth(depth))  # raw u16 stays raw (half bytes)
    url = base_url.rstrip("/") + "/track"
    params = []
    if ts is not None:
        params.append(f"ts={ts}")
    if session is not None:
        params.append(f"session={session}")
    if params:
        url += "?" + "&".join(params)
    req = urllib.request.Request(
        url, data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def post_window(base_url: str, depths, ts=None, grays=None,
                session: str | None = None, window: int | None = None,
                timeout: float = 600.0) -> dict:
    """Client: POST a frame batch to /track_window; returns the JSON record
    ({frames: [...], ms, windowed}). One HTTP round trip -- and one host
    copy per `window` frames -- instead of one of each per frame."""
    arrays = {"depths": _as_depth(depths)}
    if grays is not None:
        arrays["grays"] = np.asarray(grays)  # dtype-preserving (uint8 stays)
    if ts is not None:
        arrays["ts"] = np.asarray(ts, np.float64)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    url = base_url.rstrip("/") + "/track_window"
    params = []
    if session is not None:
        params.append(f"session={session}")
    if window is not None:
        params.append(f"window={window}")
    if params:
        url += "?" + "&".join(params)
    req = urllib.request.Request(
        url, data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get_json(base_url: str, path: str, timeout: float = 30.0):
    """Client: GET a service path; JSON bodies parsed, text returned."""
    with urllib.request.urlopen(
        base_url.rstrip("/") + path, timeout=timeout
    ) as r:
        body = r.read()
    if r.headers.get("Content-Type", "").startswith("application/json"):
        return json.loads(body)
    return body.decode()
