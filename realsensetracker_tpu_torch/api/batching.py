"""Cross-session dynamic batching for the tracking service.

Port of realsensetracker_tpu/api/batching.py. Many producers POST frames
to one card; serializing sessions (the plain TrackingService) pays the
per-frame host cost -- Python, launches, the stats copy -- once per
session per frame. ``BatchedExecutor`` instead coalesces concurrently
pending ``/track`` requests across sessions into ONE batched step: each
session owns a slot of a device-resident ``parallel.streams`` state, and
a dispatcher thread drains whatever requests are queued into a single
``step_streams_masked`` call (inactive slots untouched, first frames seed
their slot at identity). On the card that is one downsample launch, one
level-kernel launch per level and one gn_round launch per association
round for all the sessions in the round, and ONE device-to-host copy (the
stats rows). While one dispatch runs, new requests pile up and form the
next batch.

Semantics per slot are frame-to-frame visual odometry with
failure-holds-pose (rs_replay_app.cpp:266-273), the batched serving
analog of ``Tracker(method="projective")`` without the world model; with
``BatchingConfig(rgbd=True)`` the joint point-to-plane + photometric
objective (align/rgbd.py) replaces depth-only ICP and sessions POST
depth+color bodies; with ``tsdf=True`` every session owns a dense volume
(KinectFusion's loop per slot).

With ``BatchingConfig(mesh=...)`` the slot axis shards over the mesh's
data ranks (JAX shards it over the mesh's devices): the executor runs on
data rank 0, whose dispatcher stages and uploads a round as before, then
broadcasts a header and scatters the staged inputs by slot block over the
data group; every rank steps its own block of slots with the same masked
step, and the stats rows all-gather back to rank 0, which keeps its one
device-to-host copy. The other ranks run ``run_worker(config)``, a loop
that steps what it receives until the executor closes.

Usage (see cli/rs_serve.py ``--batched``):

    ex = BatchedExecutor(BatchingConfig(intrinsics=intr, capacity=8))
    svc = TrackingService(ex.make_session_tracker, extra_status=ex.stats)
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.align import rgbd as rgbd_mod
from realsensetracker_tpu_torch.api.service import host_array
from realsensetracker_tpu_torch.data.depth_units import stage_depth_np, to_meters_np
from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.parallel import mesh as mesh_mod
from realsensetracker_tpu_torch.parallel import streams
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameResult
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


@dataclass(frozen=True)
class BatchingConfig:
    """Executor configuration: the slot count and frame shape are fixed at
    construction."""

    intrinsics: camera.Intrinsics
    icp: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig()
    capacity: int = 8  # max concurrent sessions (slots)
    min_inlier_fraction: float = 0.2
    mesh: object = None  # parallel.mesh DeviceMesh | None: shard the slot
    # axis over `data_axis` so serving capacity scales with devices (each
    # data rank steps capacity/n_data slots; registrations are independent,
    # so the step needs no collective beyond the inputs' scatter and the
    # stats' gather). Capacity must be a multiple of the data size; the
    # mesh's other dims must be 1.
    data_axis: str = "data"
    linger_ms: float = 0.0  # wait this long after the first pending
    # request before dispatching, letting co-arriving requests coalesce
    # (0: the running dispatch itself is the batching window).
    request_timeout_s: float = 600.0  # bound on one request's wait
    window: int = 1  # max frames per request. > 1 lets /track_window
    # batches run up to this many frames per slot in one dispatch
    # (streams.step_streams_masked_window); rounds of single frames keep
    # the per-frame step.
    rgbd: bool = False  # joint depth+photometric odometry per slot
    # (align/rgbd.py): every frame must then carry an intensity/color plane.
    rgbd_icp: rgbd_mod.RgbdIcpConfig = rgbd_mod.RgbdIcpConfig()
    tsdf: bool = False  # dense frame-to-model slots: each session owns a
    # device-resident TSDF volume (streams.step_tsdf_streams_masked).
    # Device memory = capacity * 2 * V^3 * 4 bytes. Exclusive with rgbd.
    tsdf_cfg: object = None  # mapping.tsdf.TsdfConfig | None (defaults)
    tsdf_submap_radius: float = 0.0  # tsdf slots: > 0 gives every session
    # unbounded extent by anchor-composed reseeds: when the camera (or its
    # view centre) drifts past this radius from the slot's last seed, the
    # next frame reseeds the volume at the current pose and the session
    # facade composes poses through the accumulated anchor. 0 = one volume.
    depth_scale: float = 1e-3  # meters per raw unit for INTEGER depth
    # frames. When every request in a round is integer, the round stages
    # uint16 (half the f32 upload bytes) and converts on the device
    # (ops/pyramid.depth_to_meters); mixed rounds convert the integer
    # frames on the host. Float frames are always meters.
    device: str = device_mod.DEFAULT  # "cpu" runs the kernels' plain versions


class SessionDesyncError(RuntimeError):
    """A request timed out AFTER its frame was handed to the dispatcher:
    the frame will still be applied to the slot's device state, so the
    session facade's view (frame index, trajectory) no longer matches the
    device. The session must be reset (its slot reseeds on reuse)."""


class _Request:
    __slots__ = ("depths", "grays", "seed", "event", "rows", "error")

    def __init__(self, depths: np.ndarray, grays: np.ndarray | None, seed: bool):
        self.depths = depths  # (n, H, W), 1 <= n <= config.window
        self.grays = grays  # (n, H, W) [0, 1] | None (rgbd executors only)
        self.seed = seed  # first frame (row 0) (re)seeds the slot
        self.event = threading.Event()
        self.rows: np.ndarray | None = None  # (n, stats_width)
        self.error: BaseException | None = None


class SlotResult:
    """Unpacked masked-step stats row for one slot (35-wide depth-only or
    36-wide RGB-D; see streams.MASKED_STATS_WIDTH/MASKED_RGBD_STATS_WIDTH)."""

    __slots__ = ("pose", "relative", "success", "rmse", "photo_rmse", "inlier_fraction")

    def __init__(self, row: np.ndarray):
        self.pose = row[0:16].reshape(4, 4).astype(np.float32)
        self.relative = row[16:32].reshape(4, 4).astype(np.float32)
        self.success = bool(row[32] > 0.5)
        self.rmse = float(row[33])
        if len(row) == streams.MASKED_RGBD_STATS_WIDTH:
            self.photo_rmse = float(row[34])
            self.inlier_fraction = float(row[35])
        else:
            self.photo_rmse = None
            self.inlier_fraction = float(row[34])


class BatchedExecutor:
    """Owns the device slot state + the dispatcher thread.

    Thread model: handler threads enqueue into per-slot FIFO queues and
    block on an event; the single dispatcher thread drains at most one
    request per slot per round (preserving per-session frame order), runs
    one masked step, and delivers the packed rows. All device work runs on
    the dispatcher thread, on ``config.device``'s current stream there --
    the stream the stats copy waits on. The service must NOT hold its own
    lock around ``process`` (see ``supports_concurrent_process`` on the
    session facade).
    """

    def __init__(self, config: BatchingConfig):
        if config.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {config.capacity}")
        if config.window < 1:
            raise ValueError(f"window must be >= 1, got {config.window}")
        if config.rgbd and config.tsdf:
            raise ValueError("rgbd and tsdf slot modes are mutually exclusive")
        if config.tsdf_submap_radius and not config.tsdf:
            raise ValueError("tsdf_submap_radius requires tsdf slot mode")
        self.config = config
        self.device = device_mod.resolve(config.device)
        self._link = None
        if config.mesh is not None:
            self._link = _SlotLink(config, self.device)
            self.device = self._link.device  # this rank's card
            if self._link.index != 0:
                raise ValueError(
                    f"the executor runs on data rank 0 of the mesh; this is data rank {self._link.index} "
                    "(call run_worker(config) there)"
                )
        self._broken: BaseException | None = None  # a sharded round that failed part-way
        self._cond = threading.Condition()
        self._pending: dict[int, deque[_Request]] = {}
        self._free = list(range(config.capacity - 1, -1, -1))
        self._prefer_singles = True  # mixed-round alternation (see _run)
        # Per-slot generation: bumped on every acquisition so a STALE
        # facade (its session was /reset while a request loop was still
        # running) cannot enqueue into a reacquired slot.
        self._gen = [0] * config.capacity
        self._stop = False
        self._state = None  # device slot state, built on the first dispatch
        # stats (guarded by _cond)
        self._dispatches = 0
        self._frames = 0  # individual frames (window requests count n)
        self._sessions_served = 0  # per-round session count, summed
        self._max_batch = 0  # max sessions in one round
        self._errors = 0  # failed dispatch rounds (delivered as 500s)
        self._thread = threading.Thread(target=self._run, name="rst-batch-dispatch", daemon=True)
        self._thread.start()

    # -- session lifecycle ----------------------------------------------

    def make_session_tracker(self) -> "BatchedSessionTracker":
        """TrackingService-compatible factory: one tracker facade = one
        slot. Raises RuntimeError when all slots are taken."""
        return BatchedSessionTracker(self, *self._acquire_slot())

    def _acquire_slot(self) -> tuple[int, int]:
        with self._cond:
            if self._stop:
                raise RuntimeError("executor is closed")
            if self._broken is not None:
                raise RuntimeError(f"sharded executor stopped after a failed round: {self._broken!r}")
            if not self._free:
                raise RuntimeError(
                    f"batch capacity exhausted ({self.config.capacity} concurrent sessions); reset an idle "
                    "session or raise BatchingConfig.capacity"
                )
            slot = self._free.pop()
            self._gen[slot] += 1
            self._pending[slot] = deque()
            return slot, self._gen[slot]

    def _release_slot(self, slot: int, gen: int | None = None) -> None:
        with self._cond:
            if gen is not None and self._gen[slot] != gen:
                return  # a stale facade must not free its successor's slot
            q = self._pending.pop(slot, None)
            if q is None:
                return  # already released
            for req in q:  # unblock anyone still waiting on this session
                req.error = RuntimeError("session was reset/released")
                req.event.set()
            self._free.append(slot)

    # -- request path -----------------------------------------------------

    def track(self, slot: int, depth: np.ndarray, seed: bool, gray: np.ndarray | None = None,
              gen: int | None = None) -> SlotResult:
        """Blocking: enqueue one frame for ``slot``, wait for its batch."""
        return self.track_window(
            slot, np.asarray(depth)[None], seed,
            grays=None if gray is None else np.asarray(gray, np.float32)[None], gen=gen,
        )[0]

    def track_window(self, slot: int, depths: np.ndarray, seed: bool, grays: np.ndarray | None = None,
                     gen: int | None = None) -> list[SlotResult]:
        """Blocking: enqueue up to ``config.window`` frames for ``slot`` as
        ONE request, wait for the round that carries them. Returns one
        SlotResult per frame, in order. ``gen`` (from _acquire_slot) guards
        against a stale facade writing into a reacquired slot."""
        intr = self.config.intrinsics
        shape = (int(intr.height), int(intr.width))
        # Integer frames stay RAW (uint16; meters = raw * depth_scale on the
        # device); floats are meters. Integers that do NOT fit uint16
        # convert to meters here instead of wrapping.
        depths, _ = stage_depth_np(depths, self.config.depth_scale)
        if depths.ndim != 3 or depths.shape[1:] != shape:
            raise ValueError(
                f"frame batch shape {depths.shape} != (n,) + service shape {shape} (one slot state serves "
                "all sessions)"
            )
        if not 1 <= len(depths) <= self.config.window:
            raise ValueError(
                f"request carries {len(depths)} frames; the executor window is {self.config.window} "
                "(BatchingConfig.window)"
            )
        if self.config.rgbd:
            if grays is None:
                raise ValueError("rgbd executor: every frame needs an intensity/color plane (post .npz "
                                 "depth+color bodies)")
            grays = np.asarray(grays, np.float32)
            if grays.shape != depths.shape:
                raise ValueError(f"grays shape {grays.shape} != depths {depths.shape}")
        else:
            grays = None  # interface parity: ignored, like Tracker color
        req = _Request(depths, grays, seed)
        with self._cond:
            if self._stop:
                raise RuntimeError("executor is closed")
            if gen is not None and self._gen[slot] != gen:
                raise RuntimeError("session was reset/released (its slot belongs to a newer session now)")
            q = self._pending.get(slot)
            if q is None:
                raise RuntimeError(f"slot {slot} is not active")
            q.append(req)
            self._cond.notify_all()
        if not req.event.wait(self.config.request_timeout_s):
            # Cancel if still queued: the frame never reached the device, so
            # the caller may safely retry it. If the dispatcher already took
            # it, the frame WILL mutate the slot's device state -- that
            # session is desynchronized and must be reset.
            with self._cond:
                q = self._pending.get(slot)
                cancelled = False
                if q is not None:
                    try:
                        q.remove(req)
                        cancelled = True
                    except ValueError:
                        pass
            if cancelled:
                raise TimeoutError(
                    f"batched track timed out after {self.config.request_timeout_s}s (frame was never "
                    "dispatched; safe to retry)"
                )
            if not req.event.is_set():  # in flight right now
                raise SessionDesyncError(
                    f"batched track timed out after {self.config.request_timeout_s}s with the frame in-flight "
                    "on the device; the slot state will advance without this session seeing the result -- "
                    "reset the session"
                )
            # completed between the wait timing out and the lock: deliver.
        if req.error is not None:
            raise req.error
        return [SlotResult(row) for row in req.rows]

    # -- dispatcher -------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                batch = self._next_round()
            if batch is None:
                if self._link is not None and self._broken is None:
                    with self._on_device():
                        self._link.stop()  # the workers' loops end
                return
            if batch:
                self._dispatch(batch)

    def _next_round(self) -> dict[int, _Request] | None:
        """Wait (holding _cond) for pending requests and take the next
        round's batch: one request per slot. None once the executor closes
        (every waiting request gets the shutdown error)."""
        while not self._stop and not any(self._pending.values()):
            self._cond.wait()
        if self._stop:
            for q in self._pending.values():
                for req in q:
                    req.error = RuntimeError("executor is closed")
                    req.event.set()
            self._pending.clear()
            return None
        if self.config.linger_ms > 0:
            deadline = time.monotonic() + self.config.linger_ms / 1000.0
            while not self._stop:
                # Early out once EVERY active session has a frame
                # queued: the batch cannot get any fuller.
                if self._pending and all(self._pending.values()):
                    break
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                self._cond.wait(timeout=rem)
            if self._stop:
                return {}  # the next call delivers shutdown errors
        # One request per slot per round keeps per-session order.
        # Single-frame and multi-frame (window) requests never share
        # a round: a mixed round would run every slot through the
        # window loop, coupling single-frame sessions' latency to the
        # window length. When both kinds are pending, alternate.
        heads = {slot: q[0] for slot, q in self._pending.items() if q}
        singles = {s for s, r in heads.items() if len(r.depths) == 1}
        multis = {s for s, r in heads.items() if len(r.depths) > 1}
        if singles and multis:
            pick = singles if self._prefer_singles else multis
            self._prefer_singles = not self._prefer_singles
        else:
            pick = singles or multis
        return {slot: self._pending[slot].popleft() for slot in pick}

    def _on_device(self):
        """The dispatcher's device context: the card current on its thread."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()

    def _staging(self, shape, dtype) -> torch.Tensor:
        """A zeroed host buffer; pinned for a card, so that its upload is an
        asynchronous DMA (no host sync) and the caching host allocator holds
        it until that copy has run."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True)

    def _dispatch(self, batch: dict[int, _Request]) -> None:
        cfg = self.config
        s = cfg.capacity
        h, w = int(cfg.intrinsics.height), int(cfg.intrinsics.width)
        n_frames = sum(len(req.depths) for req in batch.values())
        try:
            with self._on_device():
                windowed = any(len(req.depths) > 1 for req in batch.values())
                # A round where EVERY request posted raw integer frames
                # stages uint16 (half the upload; the step converts on the
                # device). Mixed rounds stage f32, converting the integer
                # requests on the host.
                all_int = all(np.issubdtype(req.depths.dtype, np.integer) for req in batch.values())
                ddtype = torch.uint16 if all_int else torch.float32

                def as_staged(d):
                    if all_int or not np.issubdtype(d.dtype, np.integer):
                        return d
                    return to_meters_np(d, cfg.depth_scale)

                lead = (s, cfg.window) if windowed else (s,)
                depths = self._staging(lead + (h, w), ddtype)
                grays = self._staging(lead + (h, w), torch.float32) if cfg.rgbd else None
                flags = self._staging((2,) + lead, torch.bool)  # [active, seed]
                d_np, f_np = depths.numpy(), flags.numpy()
                g_np = grays.numpy() if grays is not None else None
                for slot, req in batch.items():
                    # (slot, first n window rows) or (slot,): where the
                    # request's frames land; row 0 carries its seed flag.
                    rows = (slot, slice(0, len(req.depths))) if windowed else slot
                    first = (slot, 0) if windowed else slot
                    d_np[rows] = as_staged(req.depths if windowed else req.depths[0])
                    f_np[0][rows] = True
                    f_np[1][first] = req.seed
                    if g_np is not None and req.grays is not None:
                        g_np[rows] = req.grays if windowed else req.grays[0]
                flags_d = self._upload(flags)
                inputs = (self._upload(depths), None if grays is None else self._upload(grays), flags_d[0], flags_d[1])
                if self._link is not None:  # this rank's slot block of each
                    inputs = self._link.send(windowed, all_int, *inputs)
                self._state, stats = _step_slots(cfg, self._state, windowed, all_int, *inputs)
                if self._link is not None:
                    stats = self._link.gather(stats)
                rows = stats.cpu().numpy()  # the dispatch's ONE device-to-host copy
        except Exception as e:  # deliver to the round's requests; the dispatcher keeps serving
            with self._cond:
                self._errors += 1
                if self._link is not None:
                    # The ranks may stand at different collectives now:
                    # no further round can be trusted.
                    self._broken = e
                    self._stop = True
            for req in batch.values():
                req.error = e
                req.event.set()
            return
        with self._cond:
            self._dispatches += 1
            self._frames += n_frames
            self._sessions_served += len(batch)
            self._max_batch = max(self._max_batch, len(batch))
        for slot, req in batch.items():
            req.rows = rows[slot, : len(req.depths)] if windowed else rows[slot][None]
            req.event.set()

    # -- observability / shutdown ----------------------------------------

    def stats(self) -> dict:
        with self._cond:
            d, f = self._dispatches, self._frames
            return {
                "capacity": self.config.capacity,
                "active_sessions": len(self._pending),
                "dispatches": d,
                "frames": f,  # individual frames (window requests count n)
                # sessions coalesced per round -- NOT frames/dispatches,
                # which would conflate the window and cross-session levers
                "mean_batch": round(self._sessions_served / d, 3) if d else 0.0,
                "max_batch": self._max_batch,
                "errors": self._errors,
            }

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)


def _blank_slots(cfg: BatchingConfig, num_streams: int, device):
    """A blank slot state of ``num_streams`` slots in the config's mode."""
    if cfg.rgbd:
        return streams.blank_streams_rgbd(cfg.intrinsics, cfg.rgbd_icp, num_streams=num_streams, device=device)
    if cfg.tsdf:
        return streams.blank_tsdf_streams(cfg.intrinsics, cfg.tsdf_cfg, num_streams=num_streams, device=device)
    return streams.blank_streams(cfg.intrinsics, cfg.icp, num_streams=num_streams, device=device)


def _step_slots(cfg: BatchingConfig, state, windowed: bool, all_int: bool, depths, grays, active, seed):
    """One masked step of the slots whose inputs these are (every slot, or
    one rank's block of a sharded executor); the state starts blank.
    Returns (state, stats rows)."""
    if state is None:
        state = _blank_slots(cfg, depths.shape[0], depths.device)
    kw = dict(min_inlier_fraction=cfg.min_inlier_fraction, depth_scale=cfg.depth_scale if all_int else 1.0)
    if cfg.rgbd:
        step = streams.step_streams_masked_rgbd_window if windowed else streams.step_streams_masked_rgbd
        return step(state, depths, grays, active, seed, cfg.intrinsics, cfg.rgbd_icp, **kw)
    if cfg.tsdf:
        step = streams.step_tsdf_streams_masked_window if windowed else streams.step_tsdf_streams_masked
        return step(state, depths, active, seed, cfg.intrinsics, cfg.tsdf_cfg, cfg.icp, **kw)
    step = streams.step_streams_masked_window if windowed else streams.step_streams_masked
    return step(state, depths, active, seed, cfg.intrinsics, cfg.icp, **kw)


class _SlotLink:
    """A sharded executor's traffic over the mesh's data group, one round
    at a time: data rank 0 broadcasts a header [go, windowed, all-int] and
    scatters each staged input by slot block; every rank steps its block;
    the stats rows all-gather back. A header with go = 0 ends the workers'
    loops. The inputs travel as their bytes (uint8): NCCL and gloo carry no
    16-bit integers."""

    def __init__(self, cfg: BatchingConfig, device: torch.device):
        mesh, axis = cfg.mesh, cfg.data_axis
        others = [n for n in mesh.mesh_dim_names if n != axis and mesh_mod.axis_size(mesh, n) > 1]
        if others:
            raise ValueError(f"the serving mesh shards slots over {axis!r} alone; its dims {others} must be 1")
        if mesh_mod.mesh_device(mesh).type != device.type:
            raise ValueError(f"BatchingConfig.device is {device}, the mesh's ranks are on {mesh.device_type}")
        self.n = mesh_mod.axis_size(mesh, axis)
        if cfg.capacity % self.n:
            raise ValueError(
                f"capacity ({cfg.capacity}) must be a multiple of the mesh '{axis}' axis size ({self.n}) "
                "so slots shard evenly over devices"
            )
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        self.index = mesh_mod.axis_index(mesh, axis)
        self.group = mesh.get_group(axis)
        self.root = dist.get_global_rank(self.group, 0)
        self.device = mesh_mod.mesh_device(mesh)
        self.slots = cfg.capacity // self.n

    def _header(self, values=None) -> list[int]:
        head = torch.tensor(values or [0, 0, 0], dtype=torch.int64, device=self.device)
        dist.broadcast(head, src=self.root, group=self.group)
        return values or head.tolist()

    def _scatter(self, x: torch.Tensor | None, shape, dtype) -> torch.Tensor:
        size = torch.empty((), dtype=dtype).element_size()
        out = torch.empty(tuple(shape[:-1]) + (shape[-1] * size,), dtype=torch.uint8, device=self.device)
        parts = None if x is None else [p.contiguous() for p in x.view(torch.uint8).chunk(self.n)]
        dist.scatter(out, parts, src=self.root, group=self.group)
        return out.view(dtype)

    def _exchange(self, windowed: bool, all_int: bool, depths=None, grays=None, active=None, seed=None):
        cfg = self.cfg
        lead = (self.slots, cfg.window) if windowed else (self.slots,)
        hw = (int(cfg.intrinsics.height), int(cfg.intrinsics.width))
        d = self._scatter(depths, lead + hw, torch.uint16 if all_int else torch.float32)
        g = self._scatter(grays, lead + hw, torch.float32) if cfg.rgbd else None
        return d, g, self._scatter(active, lead, torch.bool), self._scatter(seed, lead, torch.bool)

    def send(self, windowed: bool, all_int: bool, depths, grays, active, seed):
        """Data rank 0: this round's header and inputs out; returns its own
        block of each."""
        self._header([1, int(windowed), int(all_int)])
        return self._exchange(windowed, all_int, depths, grays, active, seed)

    def receive(self):
        """A worker: the next round's (windowed, all_int, depths, grays,
        active, seed) for its block, or None when the executor closed."""
        go, windowed, all_int = self._header()
        if not go:
            return None
        return (bool(windowed), bool(all_int)) + self._exchange(bool(windowed), bool(all_int))

    def gather(self, stats: torch.Tensor) -> torch.Tensor:
        return mesh_mod.all_gather(stats, self.mesh, self.axis)

    def stop(self) -> None:
        self._header([0, 0, 0])


def run_worker(config: BatchingConfig) -> None:
    """The loop of a data rank other than 0 of a sharded executor: step
    this rank's block of slots with every round rank 0 sends, until the
    executor closes. Every rank passes the same config, its own mesh."""
    if config.mesh is None:
        raise ValueError("run_worker serves a sharded executor: BatchingConfig.mesh is None")
    dev = device_mod.resolve(config.device)
    link = _SlotLink(config, dev)
    if link.index == 0:
        raise ValueError("data rank 0 runs the BatchedExecutor itself, not run_worker")
    state = None
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        while (msg := link.receive()) is not None:
            state, stats = _step_slots(config, state, *msg)
            link.gather(stats)


class BatchedSessionTracker:
    """One session's tracker facade over a shared BatchedExecutor slot.

    API-compatible with the trackers TrackingService wraps (``process`` ->
    FrameResult, ``.pose``, ``.trajectory``); ``supports_concurrent_process``
    tells the service NOT to hold its lock across ``process``: concurrent
    sessions' calls coalesce into one dispatch inside the executor.
    """

    supports_concurrent_process = True
    # Raw integer (u16) frames pass through to the executor, which stages
    # them at half the f32 bytes and converts on the device.
    accepts_raw_depth = True

    @property
    def depth_scale(self) -> float:
        """The executor's meters-per-raw-unit: the service checks that its
        own depth_scale agrees before passing raw frames through."""
        return self._ex.config.depth_scale

    def __init__(self, executor: BatchedExecutor, slot: int, gen: int):
        self._ex = executor
        self._slot = slot
        self._gen = gen  # slot generation (stale-facade guard)
        self._lock = threading.Lock()  # per-session frame order
        self._index = 0
        self._desynced = False  # a timed-out frame mutated the slot anyway
        self._pose_np = np.eye(4, dtype=np.float32)
        self.trajectory = Trajectory()
        # Submap-style unbounded extent (tsdf_submap_radius > 0): slot poses
        # are LOCAL to the last reseed; the facade composes them through the
        # accumulated anchor and schedules a reseed on drift.
        self._anchor = np.eye(4, dtype=np.float32)
        self._pending_seed = False
        self._frames_since_seed = 0
        self.num_reseeds = 0

    @property
    def window_capacity(self) -> int:
        """Frames one executor request can carry (BatchingConfig.window)."""
        return self._ex.config.window

    @property
    def pose(self) -> np.ndarray:
        return self._pose_np

    def process(self, depth, timestamp: float | None = None, color=None) -> FrameResult:
        """One frame in -> FrameResult out. Depth-only executors accept and
        ignore ``color`` (interface parity with method='projective'); rgbd
        executors require it (gray or RGB, converted like api.Tracker)."""
        gray = self._gray(color)
        with self._lock:
            self._check_sync()
            ts = float(self._index) if timestamp is None else timestamp
            try:
                r = self._ex.track(self._slot, host_array(depth), seed=(self._index == 0 or self._take_pending_seed()),
                                   gray=gray, gen=self._gen)
            except SessionDesyncError:
                self._desynced = True
                raise
            return self._append(r, ts)

    def process_window(self, depths, timestamps=None, window: int = 8, grays=None) -> list[FrameResult]:
        """Run a frame batch, ``min(window, executor window)`` frames per
        executor request (TrackingService /track_window plugs in here).
        Per-frame identical to ``process``: each chunk is one request whose
        frames batch across sessions AND loop along time on the device."""
        if grays is not None:
            grays = [self._gray(g) for g in grays]
        if self._ex.config.rgbd and (grays is None or any(g is None for g in grays)):
            raise ValueError("rgbd executor: /track_window bodies need a 'grays' array with one intensity plane "
                             "per frame")
        with self._lock:
            self._check_sync()
            chunk = max(1, min(window, self._ex.config.window))
            out: list[FrameResult] = []
            for i in range(0, len(depths), chunk):
                arrs = [host_array(d) for d in depths[i : i + chunk]]
                kinds = {bool(np.issubdtype(a.dtype, np.integer)) for a in arrs}
                if len(kinds) > 1:
                    # Mixed raw-integer / float-meters chunks: stacking would
                    # promote the raw frames to float COUNTS read as meters.
                    arrs = [to_meters_np(a, self._ex.config.depth_scale) for a in arrs]
                part = np.asarray(arrs)
                if not np.issubdtype(part.dtype, np.integer):
                    part = part.astype(np.float32)  # raw u16 stays raw
                gpart = np.stack(grays[i : i + chunk]) if grays is not None and self._ex.config.rgbd else None
                try:
                    rs = self._ex.track_window(self._slot, part,
                                               seed=(self._index == 0 or self._take_pending_seed()),
                                               grays=gpart, gen=self._gen)
                except SessionDesyncError:
                    self._desynced = True
                    raise
                for j, r in enumerate(rs):
                    ts = (float(self._index) if timestamps is None or timestamps[i + j] is None
                          else float(timestamps[i + j]))
                    out.append(self._append(r, ts))
            return out

    def _gray(self, color):
        """Color/gray plane -> [0, 1] f32 intensity on the host (api.Tracker
        rules); None unless the executor is rgbd."""
        if not self._ex.config.rgbd or color is None:
            return None  # an rgbd executor raises its "needs intensity" error
        from realsensetracker_tpu_torch.api.tracker import _as_gray

        return _as_gray(host_array(color))

    def _check_sync(self) -> None:
        if self._desynced:
            raise SessionDesyncError("session is desynchronized from its device slot (an earlier frame timed out "
                                     "in-flight); reset the session")

    def _take_pending_seed(self) -> bool:
        """Consume a drift-scheduled reseed (caller holds self._lock). The
        slot restarts from the incoming raw frame at identity; the anchor
        becomes the LAST composed world pose -- set here, not at drift
        detection, because frames between detection and reseed (the tail of
        a windowed chunk) still track in the OLD frame."""
        if not self._pending_seed:
            return False
        self._pending_seed = False
        self._anchor = self._pose_np.astype(np.float32)
        self._frames_since_seed = 0
        self.num_reseeds += 1
        return True

    def _probe(self) -> float:
        from realsensetracker_tpu_torch.mapping.tsdf import TsdfConfig

        vc = self._ex.config.tsdf_cfg or TsdfConfig()
        return vc.resolution * vc.voxel_size / 4.0

    def _append(self, r: SlotResult, ts: float) -> FrameResult:
        """Caller holds self._lock."""
        pose = r.pose
        radius = self._ex.config.tsdf_submap_radius
        if radius > 0:
            pose = (self._anchor @ r.pose).astype(np.float32)
            self._frames_since_seed += 1
            # min-frames guard mirrors SubmapConfig.min_frames: a reseed
            # right after a reseed would thrash on a fast pan.
            if r.success and not self._pending_seed and self._frames_since_seed >= 4:
                from realsensetracker_tpu_torch.mapping.submaps import pose_drifted

                if pose_drifted(r.pose, radius, self._probe()):
                    self._pending_seed = True  # anchor set at the reseed
        self._pose_np = pose
        self.trajectory.append(ts, pose)
        res = FrameResult(pose, r.relative, r.success, r.rmse, r.inlier_fraction, self._index)
        self._index += 1
        return res

    def release(self) -> None:
        """Free the slot (called on /reset, or by GC as a fallback)."""
        self._ex._release_slot(self._slot, self._gen)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass

