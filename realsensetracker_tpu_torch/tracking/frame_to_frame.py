"""Frame-to-frame visual odometry driver (BASELINE config 2).

Port of realsensetracker_tpu/tracking/frame_to_frame.py without the world
model: per frame, register the current depth frame against the previous
one, compose the result into the global pose, and keep the old reference
frame on failure. Each frame costs one device-to-host transfer (the
packed stats), as in the JAX version.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.ops.pyramid import build_pyramid
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


class FrameResult(NamedTuple):
    pose: np.ndarray  # (4, 4) world_from_camera (host array)
    relative: torch.Tensor  # (4, 4) prev_from_curr
    success: bool
    rmse: float
    inlier_fraction: float
    frame_index: int


def _f2f_step(depth, prev_levels, pose, intr, cfg):
    """One tracked frame: (levels, new_pose (4,4), relative (4,4), stats
    (19,)) with stats = [rmse, inlier_fraction, finite_ok, new_pose(16)]."""
    levels, intrs = build_pyramid(depth[None], intr, len(cfg.iters), cfg.min_depth, cfg.max_depth)
    icp = projective.projective_icp(levels, prev_levels, tuple(intrs), cfg=cfg)
    relative = icp.transform[0]
    new_pose = se3.accumulate(pose, relative)
    ok = torch.isfinite(relative).all()
    stats = torch.cat([icp.rmse, icp.inlier_fraction, ok.to(torch.float32)[None], new_pose.reshape(-1)])
    return tuple(levels), new_pose, relative, stats


@dataclass
class FrameToFrameTracker:
    """Stateful streaming tracker: depth frames in -> world poses out."""

    intr: camera.Intrinsics
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig()
    min_inlier_fraction: float = 0.2  # tracking-failure gate
    map_capacity: int = 0  # 0 disables the world model (the only mode ported)
    device: str | torch.device = "cpu"

    _prev_levels: object = field(default=None, repr=False)
    _pose: object = field(default=None, repr=False)  # device copy
    _pose_np: object = field(default=None, repr=False)  # host mirror
    _index: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        if self.map_capacity:
            raise NotImplementedError(
                "map_capacity > 0 needs the world-model accumulator, not ported yet "
                "(ROADMAP queue 1 item 6: ops/cloud, ops/voxel, tracking/accumulator)"
            )
        self.device = torch.device(self.device)
        # Resolution-aware schedule: drop unusable coarse levels.
        self.cfg = projective.fit_levels(self.cfg, int(self.intr.height), int(self.intr.width))

    def reset(self) -> None:
        self._prev_levels = None
        self._pose = None
        self._pose_np = None
        self._index = 0
        self.trajectory = Trajectory()

    @property
    def pose(self):
        return self._pose_np

    def process(self, depth, timestamp: float | None = None) -> FrameResult:
        depth = torch.as_tensor(depth, device=self.device)
        if timestamp is None:
            timestamp = float(self._index)

        if self._prev_levels is None:
            levels, _ = build_pyramid(
                depth[None], self.intr, len(self.cfg.iters), self.cfg.min_depth, self.cfg.max_depth
            )
            self._pose = se3.identity(device=self.device)
            self._pose_np = np.eye(4, dtype=np.float32)
            self._prev_levels = tuple(levels)
            self.trajectory.append(timestamp, self._pose_np)
            res = FrameResult(self._pose_np, se3.identity(device=self.device), True, 0.0, 1.0, self._index)
            self._index += 1
            return res

        # Register curr (src) onto prev (dst): T maps curr -> prev coords.
        levels, new_pose, relative, stats = _f2f_step(
            depth, self._prev_levels, self._pose, self.intr, self.cfg
        )
        s = stats.cpu().numpy()  # the frame's one host transfer
        rmse, inlier, finite_ok = float(s[0]), float(s[1]), bool(s[2] > 0.5)
        success = finite_ok and inlier >= self.min_inlier_fraction
        if success:
            self._pose = new_pose
            self._pose_np = s[3:19].reshape(4, 4)
            self._prev_levels = levels
        # On failure: hold the pose AND keep the previous reference frame.
        self.trajectory.append(timestamp, self._pose_np)
        res = FrameResult(self._pose_np, relative, success, rmse, inlier, self._index)
        self._index += 1
        return res
