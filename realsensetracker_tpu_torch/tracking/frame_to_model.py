"""Frame-to-model tracking: register each frame against the world model.

Port of realsensetracker_tpu/tracking/frame_to_model.py, the reference's
compiled-out branch (rs_replay_app.cpp:274-287): downsample the current
cloud, GNC-ICP it against the accumulated map, then insert it. The map is
a fixed-capacity masked cloud on the device, so ICP runs against it
directly, and a frame -- unproject, voxel downsample, ICP, SE(3)-projected
pose, conditional insert -- is one function whose results stay on the
device until the frame's one host transfer, its (18,) stats vector.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import icp as icp_mod
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.ops import cloud as cloud_mod
from realsensetracker_tpu_torch.ops import voxel as voxel_mod
from realsensetracker_tpu_torch.tracking import accumulator as acc_mod
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameResult
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


def frame_cloud(depth: torch.Tensor, intr: camera.Intrinsics, voxel_size: float, capacity: int) -> cloud_mod.Cloud:
    """Depth (H, W) -> the voxel-downsampled cloud of its valid pixels
    (depth in (0.05, 10) m), reduced uniformly to ``capacity`` rows, the
    pixels unprojected as the JAX trackers' compiled step does
    (camera.unproject_depth_compiled)."""
    depth = depth.to(torch.float32)
    valid = camera.valid_mask(depth, 0.05, 10.0)
    verts = camera.unproject_depth_compiled(torch.where(valid, depth, 0.0), intr)
    h, w = depth.shape
    c = cloud_mod.Cloud(verts.reshape(h * w, 3), valid.reshape(h * w))
    return cloud_mod.subsample_to_capacity(voxel_mod.downsample_voxel(c, voxel_size), capacity)


def _model_step(depth, model, pose, *, intr, voxel_size, frame_capacity, icp_max_iter, max_mean_cost):
    """One frame-to-model step: (new_model, new_pose (4,4), relative (4,4),
    stats (18,)) with stats = [mean_cost, ok, new_pose(16)], all on the
    device. On success the model absorbs the frame at the new pose;
    otherwise model and pose are kept."""
    curr = frame_cloud(depth, intr, voxel_size, frame_capacity)
    out = icp_mod.align_icp(curr, model.extract_cloud(), icp_max_iter, init_transform=pose)
    # Absolute world_from_camera, projected onto SE(3): it seeds the next
    # frame's registration.
    new_pose = se3.orthonormalize(out.transform)
    ok = torch.isfinite(out.transform).all() & (out.mean_cost < max_mean_cost)
    inserted = acc_mod.add_cloud(model, new_pose, curr, voxel_size)
    new_model = acc_mod.MapAccumulator(*(torch.where(ok, a, b) for a, b in zip(inserted, model)))
    new_pose = torch.where(ok, new_pose, pose)
    stats = torch.cat([torch.stack([out.mean_cost, ok.to(torch.float32)]), new_pose.reshape(-1)])
    # FrameResult.relative is prev_from_curr; align_icp gave world_from_camera.
    relative = se3.compose(se3.inverse(pose), new_pose)
    return new_model, new_pose, relative, stats


@dataclass
class FrameToModelTracker:
    """Streaming tracker registering every frame against the fused map."""

    intr: camera.Intrinsics
    voxel_size: float = 0.05  # rs_replay_app.cpp:279
    icp_max_iter: int = 64
    frame_capacity: int = 4096
    model_capacity: int = 32768
    max_mean_cost: float = 0.25  # tracking-failure gate (meters RMS)
    device: str | torch.device = device_mod.DEFAULT

    _pose: object = field(default=None, repr=False)  # device copy
    _pose_np: object = field(default=None, repr=False)  # host mirror
    _model: object = field(default=None, repr=False)
    _index: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        self.device = device_mod.resolve(self.device)

    @property
    def pose(self):
        return self._pose_np

    @property
    def world_map(self):
        return self._model

    def process(self, depth, timestamp: float | None = None) -> FrameResult:
        depth = torch.as_tensor(depth, device=self.device)
        if timestamp is None:
            timestamp = float(self._index)

        if self._model is None:
            curr = frame_cloud(depth, self.intr, self.voxel_size, self.frame_capacity)
            self._pose = se3.identity(device=self.device)
            self._pose_np = np.eye(4, dtype=np.float32)
            self._model = acc_mod.add_cloud(
                acc_mod.init_map(self.model_capacity, self.device), self._pose, curr, self.voxel_size
            )
            self.trajectory.append(timestamp, self._pose_np)
            res = FrameResult(self._pose_np, se3.identity(device=self.device), True, 0.0, 1.0, self._index)
            self._index += 1
            return res

        self._model, self._pose, relative, stats = _model_step(
            depth, self._model, self._pose, intr=self.intr, voxel_size=self.voxel_size,
            frame_capacity=self.frame_capacity, icp_max_iter=self.icp_max_iter,
            max_mean_cost=self.max_mean_cost,
        )
        s = stats.cpu().numpy()  # the frame's one host transfer
        cost, ok = float(s[0]), bool(s[1] > 0.5)
        if ok:
            self._pose_np = s[2:18].reshape(4, 4)
        self.trajectory.append(timestamp, self._pose_np)
        res = FrameResult(self._pose_np, relative, ok, cost, 1.0 if ok else 0.0, self._index)
        self._index += 1
        return res
