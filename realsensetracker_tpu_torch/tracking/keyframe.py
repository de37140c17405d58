"""Frame-to-keyframe tracking (BASELINE config 3).

Port of realsensetracker_tpu/tracking/keyframe.py. Every frame registers
against a held keyframe, and the current frame becomes the keyframe when
motion or overlap crosses a threshold; a failed registration keeps both the
pose and the keyframe, and a streak of failures re-seeds the keyframe at
the current frame (pose held).

The keyframe pyramid and the poses stay on the device. A tracked frame
(``process``) costs one device-to-host transfer, its (25,) stats vector;
a window (``process_window``) runs the same step over W frames in a Python
loop whose carry stays on the device -- ``torch.where`` selects replay the
host's promotion and failure logic -- and costs one (W, 30) transfer. The
W source pyramids of a window are built in one batched call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.ops.pyramid import PyramidLevel, build_pyramid, depth_to_meters
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


class KeyframeResult(NamedTuple):
    pose: np.ndarray  # world_from_camera (host array; the device copy stays on the card)
    success: bool
    is_new_keyframe: bool
    rmse: float
    inlier_fraction: float
    frame_index: int
    # Tracking failures in the keyframe span ENDING at this event (0 on
    # non-event frames), so each promotion of a window reports its own span.
    span_failures: int = 0


def _pyramid(depth, intr, cfg, depth_scale):
    """Depth batch (B, H, W), raw integer or float meters, on its device ->
    (levels, intrs) with the plane table of every level."""
    return build_pyramid(
        depth_to_meters(depth, depth_scale), intr, len(cfg.iters), cfg.min_depth, cfg.max_depth
    )


def _track(levels, intrs, kf_levels, kf_pose, pose, cfg):
    """Register one frame's levels (B = 1) onto the keyframe, warm-started
    from the last pose: (transform (4,4), rmse, inlier_fraction,
    new_pose (4,4), twist (6,), finite_ok) as device tensors."""
    init = se3.compose(se3.inverse(kf_pose), pose)
    icp = projective.projective_icp(levels, kf_levels, tuple(intrs), init_transform=init, cfg=cfg)
    T = icp.transform[0]
    new_pose = se3.accumulate(kf_pose, T)
    return T, icp.rmse[0], icp.inlier_fraction[0], new_pose, se3.log(T), torch.isfinite(T).all()


def _fused_track_step(depth, kf_levels, kf_pose, pose, *, intr, cfg, depth_scale=1.0):
    """One tracked frame: (levels, new_pose (4,4), stats (25,)) with stats =
    [rmse, inlier_fraction, finite_ok, twist(6), new_pose(16)], all on the
    device."""
    levels, intrs = _pyramid(depth[None], intr, cfg, depth_scale)
    _, rmse, inlier, new_pose, tw, ok = _track(levels, intrs, kf_levels, kf_pose, pose, cfg)
    stats = torch.cat([torch.stack([rmse, inlier, ok.to(torch.float32)]), tw, new_pose.reshape(-1)])
    return tuple(levels), new_pose, stats


def _frame_levels(levels, i):
    """Row i of batched levels, as B = 1 levels (views)."""
    return [PyramidLevel(*(t[i : i + 1] for t in lvl)) for lvl in levels]


def _fused_track_window(depths, kf_levels, kf_pose, pose, streak0, fails0, thresholds,
                        max_fails, row_valid, *, intr, cfg, truncate=True, depth_scale=1.0):
    """A window of W tracked frames, carry on the device.

    thresholds: (min_inlier_fraction, max_translation, max_rotation,
    min_overlap), compared in f32 as Python scalars; max_fails: the
    failure streak that re-seeds. Nothing in the loop copies between host
    and device. Returns (kf_levels, kf_pose, pose, stats (W, 30)), the
    stats still on the device for the caller's one read. Per-frame row:
    [0] rmse  [1] inlier_fraction  [2] finite_ok  [3:9] twist
    [9:25] pose after the frame (held on failure)  [25] success
    [26] is_new_keyframe  [27] span failures at the event (value BEFORE
    the keyframe reset)  [28] fail streak after  [29] fails since
    keyframe after.

    truncate=True latches the carry at the first keyframe event (``done``
    freezes every later update), so the returned state is the state at
    that frame; truncate=False promotes in-loop through any number of
    events; truncate="failures" latches only at recovery re-seeds.
    ``row_valid`` ((W,) bool) marks real rows: invalid rows freeze the
    carry like the latch, which makes padded rows inert.
    """
    levels, intrs = _pyramid(depths, intr, cfg, depth_scale)
    kf_lv, kf_p, p = tuple(kf_levels), kf_pose, pose
    carry = _window_carry(streak0, fails0, depths.device)
    rows = []
    for i in range(depths.shape[0]):
        frame = _frame_levels(levels, i)
        _, rmse, inlier, new_pose, tw, ok = _track(frame, intrs, kf_lv, kf_p, p, cfg)
        event_now, p, kf_p, carry, row = _window_row(
            rmse, inlier, ok, tw, new_pose, p, kf_p, carry, row_valid[i], thresholds, max_fails, truncate
        )
        kf_lv = tuple(
            PyramidLevel(*(torch.where(event_now, a, b) for a, b in zip(new, old)))
            for new, old in zip(frame, kf_lv)
        )
        rows.append(row)
    return kf_lv, kf_p, p, torch.stack(rows)


def _window_carry(streak0: int, fails0: int, device):
    """A window's counters on the device: (fail streak, fails since the
    keyframe, done)."""
    return (
        torch.full((), streak0, dtype=torch.int32, device=device),
        torch.full((), fails0, dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.bool, device=device),
    )


def _window_row(rmse, inlier, ok, tw, new_pose, p, kf_p, carry, valid, thresholds, max_fails, truncate):
    """One frame of a window: the host's promotion and failure logic as
    device selects. thresholds is (min_inlier_fraction, max_translation,
    max_rotation, min_overlap); an invalid row, or any row after the carry
    latched, changes nothing. Returns (event_now, pose, keyframe pose,
    carry, stats row (30,)) in the layout of _fused_track_window."""
    min_inlier, max_translation, max_rotation, min_overlap = thresholds
    streak, fails, done = carry
    dead = done | ~valid
    success = ok & (inlier >= min_inlier)
    promote = success & (
        (torch.linalg.vector_norm(tw[:3]) > max_translation)
        | (torch.linalg.vector_norm(tw[3:]) > max_rotation)
        | (inlier < min_overlap)
    )
    streak1 = torch.where(success, 0, streak + 1)
    fails1 = torch.where(success, fails, fails + 1)
    reseed = ~success & (streak1 >= max_fails)
    is_new_kf = promote | reseed
    event_now = is_new_kf & ~dead
    p1 = torch.where(success & ~dead, new_pose, p)
    kf_p1 = torch.where(event_now, p1, kf_p)
    streak2 = torch.where(dead, streak, torch.where(reseed, 0, streak1))
    fails2 = torch.where(dead, fails, torch.where(is_new_kf, 0, fails1))
    flags = torch.stack([t.to(torch.float32) for t in (success, is_new_kf, fails1, streak2, fails2)])
    row = torch.cat([torch.stack([rmse, inlier, ok.to(torch.float32)]), tw, p1.reshape(-1), flags])
    if truncate == "failures":
        done = done | (is_new_kf & ~success)
    elif truncate:
        done = done | is_new_kf
    return event_now, p1, kf_p1, (streak2, fails2, done), row


def _read_frame(tracker, s, new_pose_dev, timestamp: float):
    """The result of a tracked frame from its host stats s (25,): the
    success gate, promotion on motion or overlap, and the failure streak
    that re-seeds (pose held). Updates the tracker's pose, keyframe pose,
    counters, trajectory and index; returns (result, is_new_keyframe), and
    the caller takes the frame's target as the keyframe's when set."""
    rmse, inlier, finite_ok = float(s[0]), float(s[1]), bool(s[2] > 0.5)
    tw = s[3:9]
    success = finite_ok and inlier >= tracker.min_inlier_fraction
    is_new_kf = False
    if success:
        tracker._fail_streak = 0
        tracker._pose = new_pose_dev
        tracker._pose_np = s[9:25].reshape(4, 4)
        is_new_kf = bool(
            np.linalg.norm(tw[:3]) > tracker.max_translation
            or np.linalg.norm(tw[3:]) > tracker.max_rotation
            or inlier < tracker.min_overlap
        )
    else:
        tracker._fail_streak += 1
        tracker._fails_since_kf += 1
        if tracker._fail_streak >= tracker.max_consecutive_failures:
            # Recovery re-seed: pose held, the current frame becomes the
            # reference so tracking can resume.
            tracker._fail_streak = 0
            is_new_kf = True
    if is_new_kf:
        tracker._kf_pose = tracker._pose
        tracker.last_span_failures = tracker._fails_since_kf
        tracker._fails_since_kf = 0
    tracker.trajectory.append(timestamp, tracker._pose_np)
    res = KeyframeResult(
        pose=tracker._pose_np,
        success=success,
        is_new_keyframe=is_new_kf,
        rmse=rmse,
        inlier_fraction=inlier,
        frame_index=tracker._index,
        span_failures=tracker.last_span_failures if is_new_kf else 0,
    )
    tracker._index += 1
    return res, is_new_kf


def _read_window(tracker, s, n_real: int, timestamps, truncate):
    """The results of a window's host stats rows s (W, 30), up to the
    consumed tail (the first keyframe event in the latched modes); appends
    the tracker's trajectory, advances its index and sets its failure
    counters. Returns (results, last consumed row, the last event's row or
    -1, whether the carry latched at the tail)."""
    results: list[KeyframeResult] = []
    consumed, last_event, hard_stop = 0, -1, False
    for i in range(n_real):
        ts = timestamps[i] if timestamps[i] is not None else float(tracker._index)
        pose_np = s[i, 9:25].reshape(4, 4).astype(np.float32)
        success = s[i, 25] > 0.5
        is_new_kf = s[i, 26] > 0.5
        tracker._pose_np = pose_np
        tracker.trajectory.append(ts, pose_np)
        results.append(KeyframeResult(
            pose=pose_np,
            success=bool(success),
            is_new_keyframe=bool(is_new_kf),
            rmse=float(s[i, 0]),
            inlier_fraction=float(s[i, 1]),
            frame_index=tracker._index,
            span_failures=int(s[i, 27]) if is_new_kf else 0,
        ))
        tracker._index += 1
        consumed = i + 1
        if is_new_kf:
            last_event = i
            if truncate is True or (truncate == "failures" and not success):
                hard_stop = True
                break
    last = consumed - 1
    if last_event >= 0:
        tracker.last_span_failures = int(s[last_event, 27])
    if hard_stop:
        tracker._fail_streak, tracker._fails_since_kf = 0, 0
    else:
        tracker._fail_streak, tracker._fails_since_kf = int(s[last, 28]), int(s[last, 29])
    return results, last, last_event, hard_stop


@dataclass
class KeyframeTracker:
    # Raw integer (u16) frames go to the device as they are and convert to
    # meters there at depth_scale; the Tracker facade probes this flag.
    accepts_raw_depth = True

    intr: camera.Intrinsics
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig()
    min_inlier_fraction: float = 0.2
    # Promote the keyframe when relative motion exceeds these bounds:
    max_translation: float = 0.15  # meters
    max_rotation: float = 0.15  # radians
    min_overlap: float = 0.6  # inlier fraction below this forces a keyframe
    # Lost-tracking recovery: after this many consecutive failures the
    # current frame becomes the keyframe (pose held).
    max_consecutive_failures: int = 5
    # Meters per raw unit for INTEGER depth frames; float frames are meters.
    depth_scale: float = 1e-3
    device: str | torch.device = device_mod.DEFAULT

    _fail_streak: int = 0
    # Failed frames since the previous keyframe, snapshotted into
    # last_span_failures at every keyframe event.
    _fails_since_kf: int = 0
    last_span_failures: int = 0
    _last_levels: object = field(default=None, repr=False)
    # Windows keep the last frame's depth, not its pyramid; relocalize_to
    # rebuilds the pyramid from it when it needs the frame as a keyframe.
    _last_depth: object = field(default=None, repr=False)
    _kf_levels: object = field(default=None, repr=False)
    _kf_pose: object = field(default=None, repr=False)  # world_from_keyframe
    _pose: object = field(default=None, repr=False)  # device copy
    _pose_np: object = field(default=None, repr=False)  # host mirror
    _index: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        self.device = device_mod.resolve(self.device)
        # Resolution-aware schedule: drop coarse levels below ~24 px.
        self.cfg = projective.fit_levels(self.cfg, int(self.intr.height), int(self.intr.width))

    @property
    def pose(self):
        return self._pose_np

    def _host_frame(self, depth) -> torch.Tensor:
        """A frame as a tensor where it lies: raw integers stay integer,
        floats become f32 (before any upload)."""
        t = depth if isinstance(depth, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(depth))
        return t.to(torch.float32) if t.is_floating_point() else t

    def process(self, depth, timestamp: float | None = None) -> KeyframeResult:
        depth = self._host_frame(depth).to(self.device)
        if timestamp is None:
            timestamp = float(self._index)

        if self._kf_levels is None:
            levels, _ = _pyramid(depth[None], self.intr, self.cfg, self.depth_scale)
            self._pose = se3.identity(device=self.device)
            self._pose_np = np.eye(4, dtype=np.float32)
            self._kf_pose = self._pose
            self._kf_levels = tuple(levels)
            self._last_levels = self._kf_levels
            self.trajectory.append(timestamp, self._pose_np)
            res = KeyframeResult(self._pose_np, True, True, 0.0, 1.0, self._index)
            self._index += 1
            return res

        levels, new_pose_dev, stats = _fused_track_step(
            depth, self._kf_levels, self._kf_pose, self._pose,
            intr=self.intr, cfg=self.cfg, depth_scale=self.depth_scale,
        )
        self._last_levels = levels  # kept for a possible external re-seed
        res, is_new_kf = _read_frame(self, stats.cpu().numpy(), new_pose_dev, timestamp)  # one host transfer
        if is_new_kf:
            self._kf_levels = levels
        return res

    def _window_stack(self, depths, pad_to):
        """(W', H, W) frames on the device, padded by repeating the last
        frame, and the number of real rows. Mixed raw/float windows convert
        the raw frames to meters first (stacking would read counts as
        meters)."""
        frames = [self._host_frame(d) for d in depths]
        if len({f.is_floating_point() for f in frames}) > 1:
            frames = [depth_to_meters(f, self.depth_scale) for f in frames]
        n_real = len(frames)
        if pad_to is not None and pad_to > n_real:
            frames += [frames[-1]] * (pad_to - n_real)
        return torch.stack(frames).to(self.device), n_real

    def process_window(self, depths, timestamps=None, pad_to: int | None = None,
                       truncate_at_events: bool | str = True) -> list[KeyframeResult]:
        """Process up to len(depths) frames with one host transfer.

        truncate_at_events=True (default): consumes frames up to and
        INCLUDING the first keyframe event (promotion or recovery re-seed),
        or the whole window if none occurs; fewer results than depths means
        the caller re-submits the tail. False: always consumes the whole
        window, promoting in-loop. "failures": promotions are consumed
        in-loop, the window stops at the first recovery re-seed.

        pad_to: pad the window to this many rows (the last frame repeated);
        padded rows are inert in every mode. Results match process() frame
        for frame.
        """
        if timestamps is None:
            timestamps = [None] * len(depths)
        if self._kf_levels is None:  # bootstrap: the first frame seeds the keyframe
            return [self.process(depths[0], timestamps[0])]
        stack, n_real = self._window_stack(depths, pad_to)
        valid = torch.arange(stack.shape[0], device=self.device) < n_real
        kf_lv_dev, kf_pose_dev, pose_dev, stats = _fused_track_window(
            stack, self._kf_levels, self._kf_pose, self._pose,
            self._fail_streak, self._fails_since_kf,
            (self.min_inlier_fraction, self.max_translation, self.max_rotation, self.min_overlap),
            self.max_consecutive_failures, valid,
            intr=self.intr, cfg=self.cfg, truncate=truncate_at_events,
            depth_scale=self.depth_scale,
        )
        s = stats.cpu().numpy()  # the window's one host transfer
        results, last, last_event, hard_stop = _read_window(self, s, n_real, timestamps, truncate_at_events)
        self._last_depth = depths[last]
        self._last_levels = kf_lv_dev if hard_stop else None  # else rebuilt from _last_depth if needed
        self._pose = pose_dev  # the pose after the last consumed row
        if last_event >= 0:
            # The carry holds the keyframe state at the truncation point
            # (latched modes) or after the LAST event (multi-event mode).
            self._kf_levels = kf_lv_dev
            self._kf_pose = kf_pose_dev
        return results

    def relocalize_to(self, pose) -> None:
        """Override the pose with an externally computed estimate and
        re-seed the keyframe at the LAST processed frame (the SLAM layer's
        relocalization hands its recovered pose back here)."""
        self._pose = torch.as_tensor(np.asarray(pose, np.float32), device=self.device)
        self._pose_np = np.asarray(pose, np.float32)
        self._kf_pose = self._pose
        if self._last_levels is None and self._last_depth is not None:
            depth = self._host_frame(self._last_depth).to(self.device)
            self._last_levels = tuple(_pyramid(depth[None], self.intr, self.cfg, self.depth_scale)[0])
        self._kf_levels = self._last_levels
        self._fail_streak = 0
        self._fails_since_kf = 0
        if self.trajectory.poses:
            self.trajectory.poses[-1] = np.asarray(pose, np.float64)

    def apply_world_correction(self, delta) -> None:
        """Left-multiply a world-frame correction delta = P' P^-1 into the
        pose state (online pose-graph optimization). Keyframe pyramids are
        in camera coordinates, so only the poses change."""
        d = torch.as_tensor(np.asarray(delta, np.float32), device=self.device)
        self._pose = se3.orthonormalize(se3.compose(d, self._pose))
        self._kf_pose = se3.orthonormalize(se3.compose(d, self._kf_pose))
        self._pose_np = self._pose.cpu().numpy()
        if self.trajectory.poses:
            self.trajectory.poses[-1] = np.asarray(self._pose_np, np.float64)
