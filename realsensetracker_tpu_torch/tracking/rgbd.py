"""Frame-to-frame RGB-D visual odometry (joint geometry + photometry).

Port of realsensetracker_tpu/tracking/rgbd.py: per frame, register the
current depth + intensity pair against the previous one with the combined
point-to-plane + photometric objective (align/rgbd.py), compose into the
global pose, and hold the reference frame on failure. The previous frame's
target (plane-table levels and intensity pyramid) and the pose stay on the
device; a frame costs one device-to-host transfer, its (19,) stats vector.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.align import rgbd as rgbd_mod
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameResult
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


def _as_frame(a, device) -> torch.Tensor:
    """A host or device (H, W) frame as f32 on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=torch.float32)


def _fused_rgbd_step(depth, gray, prev_levels, prev_grays, pose, *, intr, cfg):
    """One RGB-D tracked frame (B = 1): (levels, grays, new_pose (4,4),
    relative (4,4), stats (19,)) with stats = [rmse, inlier_fraction,
    finite_ok, new_pose(16)], all on the device."""
    levels, grays, intrs = rgbd_mod.build_rgbd_target(depth[None], gray[None], intr, cfg)
    src_samples = rgbd_mod.sample_rgbd_source(depth[None], gray[None], intrs, cfg)
    out = rgbd_mod.rgbd_icp_sampled(src_samples, prev_levels, prev_grays, intrs, cfg=cfg)
    relative = out.transform[0]
    new_pose = se3.accumulate(pose, relative)
    ok = torch.isfinite(relative).all()
    stats = torch.cat([out.rmse, out.inlier_fraction, ok.to(torch.float32)[None], new_pose.reshape(-1)])
    return levels, grays, new_pose, relative, stats


@dataclass
class RgbdTracker:
    """Stateful streaming tracker: (depth, gray) frames in -> poses out."""

    intr: camera.Intrinsics
    cfg: rgbd_mod.RgbdIcpConfig = rgbd_mod.RgbdIcpConfig()
    min_inlier_fraction: float = 0.2
    device: str | torch.device = device_mod.DEFAULT

    _prev_target: object = field(default=None, repr=False)  # (levels, grays)
    _pose: object = field(default=None, repr=False)  # device copy
    _pose_np: object = field(default=None, repr=False)  # host mirror
    _index: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        self.device = device_mod.resolve(self.device)
        # build_rgbd_target fits the schedule itself; without this the
        # stored cfg would disagree with the built level count at sub-VGA
        # resolutions.
        self.cfg = projective.fit_levels(self.cfg, int(self.intr.height), int(self.intr.width))

    def reset(self) -> None:
        self._prev_target = None
        self._pose = None
        self._pose_np = None
        self._index = 0
        self.trajectory = Trajectory()

    @property
    def pose(self):
        return self._pose_np

    def process(self, depth, gray, timestamp: float | None = None) -> FrameResult:
        depth = _as_frame(depth, self.device)
        gray = _as_frame(gray, self.device)
        if timestamp is None:
            timestamp = float(self._index)

        if self._prev_target is None:
            # The frame's target is kept for the NEXT frame: each frame is
            # preprocessed once as the destination; its source role is
            # sampled on the fly.
            levels, grays, _ = rgbd_mod.build_rgbd_target(depth[None], gray[None], self.intr, self.cfg)
            self._pose = se3.identity(device=self.device)
            self._pose_np = np.eye(4, dtype=np.float32)
            self._prev_target = (levels, grays)
            self.trajectory.append(timestamp, self._pose_np)
            res = FrameResult(self._pose_np, se3.identity(device=self.device), True, 0.0, 1.0, self._index)
            self._index += 1
            return res

        dst_levels, dst_grays = self._prev_target
        levels, grays, new_pose, relative, stats = _fused_rgbd_step(
            depth, gray, dst_levels, dst_grays, self._pose, intr=self.intr, cfg=self.cfg
        )
        s = stats.cpu().numpy()  # the frame's one host transfer
        rmse, inlier, finite_ok = float(s[0]), float(s[1]), bool(s[2] > 0.5)
        success = finite_ok and inlier >= self.min_inlier_fraction
        if success:
            self._pose = new_pose
            self._pose_np = s[3:19].reshape(4, 4)
            self._prev_target = (levels, grays)
        self.trajectory.append(timestamp, self._pose_np)
        res = FrameResult(self._pose_np, relative, success, rmse, inlier, self._index)
        self._index += 1
        return res
