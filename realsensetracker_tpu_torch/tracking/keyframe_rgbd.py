"""Frame-to-keyframe RGB-D tracking (joint geometry + photometry VO).

Port of realsensetracker_tpu/tracking/keyframe_rgbd.py, the colored
counterpart of tracking/keyframe.py: every frame registers against a held
keyframe with the combined point-to-plane + photometric objective
(align/rgbd.py), promoting the current frame to keyframe on motion or
overlap thresholds, and a streak of failures re-seeds the keyframe at the
current frame (pose held).

The keyframe target (plane-table levels and intensity pyramid) and the
poses stay on the device. ``process`` costs one device-to-host transfer,
its (25,) stats vector; ``process_window`` runs the same step over W frames
in a Python loop whose carry stays on the device, ``torch.where`` selects
replaying the host's promotion and failure logic, and costs one (W, 30)
transfer. The W targets and source samples of a window are built in one
batched call each.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.align import rgbd as rgbd_mod
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.ops.pyramid import PyramidLevel
from realsensetracker_tpu_torch.tracking.keyframe import (
    KeyframeResult,
    _frame_levels,
    _read_frame,
    _read_window,
    _window_carry,
    _window_row,
)
from realsensetracker_tpu_torch.tracking.rgbd import _as_frame
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


def _track(src_samples, intrs, kf_levels, kf_grays, kf_pose, pose, cfg):
    """Register one frame's samples (B = 1) onto the keyframe target,
    warm-started from the last pose: (rmse, inlier_fraction, new_pose
    (4,4), twist (6,), finite_ok) as device tensors."""
    init = se3.compose(se3.inverse(kf_pose), pose)
    out = rgbd_mod.rgbd_icp_sampled(src_samples, kf_levels, kf_grays, intrs, init_transform=init, cfg=cfg)
    T = out.transform[0]
    return out.rmse[0], out.inlier_fraction[0], se3.accumulate(kf_pose, T), se3.log(T), torch.isfinite(T).all()


def _fused_rgbd_track_step(depth, gray, kf_levels, kf_grays, kf_pose, pose, *, intr, cfg):
    """One tracked frame: (levels, grays, new_pose (4,4), stats (25,)) with
    stats = [rmse, inlier_fraction, finite_ok, twist(6), new_pose(16)], all
    on the device."""
    levels, grays, intrs = rgbd_mod.build_rgbd_target(depth[None], gray[None], intr, cfg)
    src = rgbd_mod.sample_rgbd_source(depth[None], gray[None], intrs, cfg)
    rmse, inlier, new_pose, tw, ok = _track(src, intrs, kf_levels, kf_grays, kf_pose, pose, cfg)
    stats = torch.cat([torch.stack([rmse, inlier, ok.to(torch.float32)]), tw, new_pose.reshape(-1)])
    return levels, grays, new_pose, stats


def _fused_rgbd_track_window(depths, grays_in, kf_levels, kf_grays, kf_pose, pose, streak0, fails0,
                             thresholds, max_fails, row_valid, *, intr, cfg, truncate=True):
    """A window of W tracked RGB-D frames (depths, grays_in (W,H,W) on the
    device), carry on the device: the colored counterpart of
    keyframe._fused_track_window, with its stats row layout, ``truncate``
    modes and ``row_valid`` padding. Returns (kf_levels, kf_grays, kf_pose,
    pose, stats (W, 30))."""
    levels, grays, intrs = rgbd_mod.build_rgbd_target(depths, grays_in, intr, cfg)
    samples = rgbd_mod.sample_rgbd_source(depths, grays_in, intrs, cfg)
    kf_lv, kf_gr, kf_p, p = tuple(kf_levels), tuple(kf_grays), kf_pose, pose
    carry = _window_carry(streak0, fails0, depths.device)
    rows = []
    for i in range(depths.shape[0]):
        frame_lv = _frame_levels(levels, i)
        frame_gr = [g[i : i + 1] for g in grays]
        src = [tuple(t[i : i + 1] for t in level) for level in samples]
        rmse, inlier, new_pose, tw, ok = _track(src, intrs, kf_lv, kf_gr, kf_p, p, cfg)
        event_now, p, kf_p, carry, row = _window_row(
            rmse, inlier, ok, tw, new_pose, p, kf_p, carry, row_valid[i], thresholds, max_fails, truncate
        )
        kf_lv = tuple(
            PyramidLevel(*(torch.where(event_now, a, b) for a, b in zip(new, old)))
            for new, old in zip(frame_lv, kf_lv)
        )
        kf_gr = tuple(torch.where(event_now, a, b) for a, b in zip(frame_gr, kf_gr))
        rows.append(row)
    return kf_lv, kf_gr, kf_p, p, torch.stack(rows)


@dataclass
class RgbdKeyframeTracker:
    """The VO of the SLAM layer when color exists: the interface of
    KeyframeTracker (process -> KeyframeResult, process_window,
    relocalize_to, apply_world_correction, last_span_failures) with
    (depth, gray) input, depth in float meters."""

    intr: camera.Intrinsics
    cfg: rgbd_mod.RgbdIcpConfig = rgbd_mod.RgbdIcpConfig()
    min_inlier_fraction: float = 0.2
    max_translation: float = 0.15  # meters
    max_rotation: float = 0.15  # radians
    min_overlap: float = 0.6
    max_consecutive_failures: int = 5
    device: str | torch.device = device_mod.DEFAULT

    _fail_streak: int = 0
    _fails_since_kf: int = 0
    last_span_failures: int = 0
    _last_target: object = field(default=None, repr=False)  # (levels, grays)
    # Windows keep the last frame's (depth, gray), not its target;
    # relocalize_to rebuilds the target from it when it needs it.
    _last_frame: object = field(default=None, repr=False)
    _kf_target: object = field(default=None, repr=False)  # (levels, grays)
    _kf_pose: object = field(default=None, repr=False)
    _pose: object = field(default=None, repr=False)
    _pose_np: object = field(default=None, repr=False)
    _index: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        self.device = device_mod.resolve(self.device)
        self.cfg = projective.fit_levels(self.cfg, int(self.intr.height), int(self.intr.width))

    @property
    def pose(self):
        return self._pose_np

    def _target(self, depth, gray):
        levels, grays, _ = rgbd_mod.build_rgbd_target(depth[None], gray[None], self.intr, self.cfg)
        return levels, grays

    def process(self, depth, gray, timestamp: float | None = None) -> KeyframeResult:
        depth = _as_frame(depth, self.device)
        gray = _as_frame(gray, self.device)
        if timestamp is None:
            timestamp = float(self._index)

        if self._kf_target is None:
            self._pose = se3.identity(device=self.device)
            self._pose_np = np.eye(4, dtype=np.float32)
            self._kf_pose = self._pose
            self._kf_target = self._target(depth, gray)
            self._last_target = self._kf_target
            self.trajectory.append(timestamp, self._pose_np)
            res = KeyframeResult(self._pose_np, True, True, 0.0, 1.0, self._index)
            self._index += 1
            return res

        kf_levels, kf_grays = self._kf_target
        levels, grays, new_pose_dev, stats = _fused_rgbd_track_step(
            depth, gray, kf_levels, kf_grays, self._kf_pose, self._pose, intr=self.intr, cfg=self.cfg
        )
        self._last_target = (levels, grays)
        res, is_new_kf = _read_frame(self, stats.cpu().numpy(), new_pose_dev, timestamp)  # one host transfer
        if is_new_kf:
            self._kf_target = (levels, grays)
        return res

    def _window_stack(self, frames, pad_to):
        """(W', H, W) f32 frames on the device, padded by repeating the last."""
        frames = [_as_frame(f, self.device) for f in frames]
        if pad_to is not None and pad_to > len(frames):
            frames += [frames[-1]] * (pad_to - len(frames))
        return torch.stack(frames)

    def process_window(self, depths, grays, timestamps=None, pad_to: int | None = None,
                       truncate_at_events: bool | str = True) -> list[KeyframeResult]:
        """Process up to len(depths) RGB-D frames with one host transfer.

        The contract of KeyframeTracker.process_window, truncate modes
        included: True consumes frames up to and INCLUDING the first
        keyframe event (fewer results than frames: re-submit the tail);
        "failures" consumes promotions in-loop and stops at the first
        recovery re-seed; False always consumes the whole window. pad_to
        pads the window with inert rows. Results match process() frame for
        frame.
        """
        if timestamps is None:
            timestamps = [None] * len(depths)
        if self._kf_target is None:  # bootstrap: the first frame seeds the keyframe
            return [self.process(depths[0], grays[0], timestamps[0])]
        kf_levels, kf_grays = self._kf_target
        n_real = len(depths)
        depth_stack = self._window_stack(depths, pad_to)
        gray_stack = self._window_stack(grays, pad_to)
        valid = torch.arange(depth_stack.shape[0], device=self.device) < n_real
        kf_lv_dev, kf_gr_dev, kf_pose_dev, pose_dev, stats = _fused_rgbd_track_window(
            depth_stack, gray_stack, kf_levels, kf_grays, self._kf_pose, self._pose,
            self._fail_streak, self._fails_since_kf,
            (self.min_inlier_fraction, self.max_translation, self.max_rotation, self.min_overlap),
            self.max_consecutive_failures, valid,
            intr=self.intr, cfg=self.cfg, truncate=truncate_at_events,
        )
        s = stats.cpu().numpy()  # the window's one host transfer
        results, last, last_event, hard_stop = _read_window(self, s, n_real, timestamps, truncate_at_events)
        self._last_frame = (depths[last], grays[last])
        self._last_target = (kf_lv_dev, kf_gr_dev) if hard_stop else None  # else rebuilt from _last_frame
        self._pose = pose_dev  # the pose after the last consumed row
        if last_event >= 0:
            # The carry holds the keyframe state at the truncation point
            # (latched modes) or after the LAST event (multi-event mode).
            self._kf_target = (kf_lv_dev, kf_gr_dev)
            self._kf_pose = kf_pose_dev
        return results

    def relocalize_to(self, pose) -> None:
        """Override the pose with an externally computed estimate and
        re-seed the keyframe at the LAST processed frame."""
        self._pose = torch.as_tensor(np.asarray(pose, np.float32), device=self.device)
        self._pose_np = np.asarray(pose, np.float32)
        self._kf_pose = self._pose
        if self._last_target is None and self._last_frame is not None:
            d, g = self._last_frame
            self._last_target = self._target(_as_frame(d, self.device), _as_frame(g, self.device))
        self._kf_target = self._last_target
        self._fail_streak = 0
        self._fails_since_kf = 0
        if self.trajectory.poses:
            self.trajectory.poses[-1] = np.asarray(pose, np.float64)

    def apply_world_correction(self, delta) -> None:
        """Left-multiply a world-frame correction delta = P' P^-1 into the
        pose state; the keyframe target is in camera coordinates."""
        d = torch.as_tensor(np.asarray(delta, np.float32), device=self.device)
        self._pose = se3.orthonormalize(se3.compose(d, self._pose))
        self._kf_pose = se3.orthonormalize(se3.compose(d, self._kf_pose))
        self._pose_np = self._pose.cpu().numpy()
        if self.trajectory.poses:
            self.trajectory.poses[-1] = np.asarray(self._pose_np, np.float64)
