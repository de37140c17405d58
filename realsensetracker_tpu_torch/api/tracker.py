"""Public tracking facade: frames in -> poses out.

Port of realsensetracker_tpu/api/tracker.py for every method:
"projective" (with the world map when ``map_capacity > 0``), "keyframe",
"model" (frame-to-model), "icp" and "gicp" (the cloud tracker, GNC-ICP or
GICP), "rgbd" (joint geometric + photometric frame-to-frame odometry, which
takes a color or gray frame beside each depth frame) and "tsdf" (dense
KinectFusion frame-to-model tracking against a TSDF volume, or the submap
atlas with ``tsdf_submap_radius > 0``; with ``tsdf_color`` it takes an RGB
frame beside each depth frame).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import gicp as gicp_mod
from realsensetracker_tpu_torch.align import icp as icp_mod
from realsensetracker_tpu_torch.api.config import TrackerConfig
from realsensetracker_tpu_torch.data.depth_units import to_meters_np
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops.pyramid import depth_to_meters
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameResult, FrameToFrameTracker
from realsensetracker_tpu_torch.tracking.frame_to_model import FrameToModelTracker, frame_cloud
from realsensetracker_tpu_torch.tracking.keyframe import KeyframeTracker
from realsensetracker_tpu_torch.tracking.rgbd import RgbdTracker
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory

class Tracker:
    """Streaming depth tracker with selectable registration backend."""

    # Integer (raw u16) depth frames are accepted by every method: scaled by
    # config.depth_scale on the device (keyframe) or on the host (_ingest).
    accepts_raw_depth = True

    def __init__(self, config: TrackerConfig | None = None):
        self.config = config or TrackerConfig()
        method = self.config.method
        if method == "projective":
            self._impl = FrameToFrameTracker(
                self.config.intrinsics,
                self.config.projective,
                min_inlier_fraction=self.config.min_inlier_fraction,
                map_capacity=self.config.map_capacity,
                map_voxel_size=self.config.map_voxel_size,
                device=self.config.device,
            )
        elif method == "keyframe":
            self._impl = KeyframeTracker(
                self.config.intrinsics,
                self.config.projective,
                min_inlier_fraction=self.config.min_inlier_fraction,
                depth_scale=self.config.depth_scale,
                device=self.config.device,
            )
        elif method == "model":
            kw = {"model_capacity": self.config.map_capacity} if self.config.map_capacity else {}
            self._impl = FrameToModelTracker(
                self.config.intrinsics,
                voxel_size=self.config.map_voxel_size,
                icp_max_iter=self.config.align.icp_max_iter,
                device=self.config.device,
                **kw,
            )
        elif method == "tsdf":
            self._impl = _tsdf_impl(self.config)
        elif method == "rgbd":
            self._impl = RgbdTracker(
                self.config.intrinsics,
                self.config.rgbd,
                min_inlier_fraction=self.config.min_inlier_fraction,
                device=self.config.device,
            )
        elif method in ("icp", "gicp"):
            self._impl = _CloudTracker(self.config)
        else:
            raise ValueError(f"unknown tracking method: {method}")

    def _ingest(self, depth):
        """Integer (raw unit) frames -> f32 meters by config.depth_scale,
        on the host for host frames, unless the impl declares
        ``accepts_raw_depth`` (KeyframeTracker, the single-volume
        TsdfTracker): then the raw frame passes through and converts on the
        device. The submap atlas reads depth on the host at handovers and
        takes meters."""
        if getattr(self._impl, "accepts_raw_depth", False):
            return depth
        if isinstance(depth, torch.Tensor):
            return depth_to_meters(depth, self.config.depth_scale)
        return to_meters_np(depth, self.config.depth_scale)

    def process(self, depth, timestamp: float | None = None, color=None):
        """One (H, W) depth frame (float meters or integer raw units) in ->
        KeyframeResult (keyframe) or FrameResult (the other methods) out.

        ``color`` feeds the photometric term of method="rgbd", which
        requires it: an (H, W) gray image in [0, 1], or an (H, W, 3) image
        ([0, 1] float or uint8) reduced to BT.601 luma (_as_gray). The other
        methods ignore it.
        """
        depth = self._ingest(depth)
        if self.config.method == "rgbd":
            if color is None:
                raise ValueError("method='rgbd' requires a color/gray frame")
            return self._impl.process(depth, _as_gray(color), timestamp)
        if self.config.method == "tsdf" and self.config.tsdf_color:
            # Raw RGB (not luma): the volume fuses per-voxel color.
            return self._impl.process(depth, timestamp, color=color)
        return self._impl.process(depth, timestamp)

    def process_window(self, depths, timestamps=None, window: int = 8, grays=None):
        """Process a sequence of frames, up to ``window`` frames per host
        transfer (methods 'keyframe' and 'tsdf'). Identical results to
        per-frame process(); one result per frame. For method='tsdf' with
        tsdf_color, ``grays`` carries the per-frame RGB images."""
        if self.config.method == "tsdf":
            return self._impl.process_window(
                [self._ingest(d) for d in depths], timestamps, window=window,
                colors=grays if self.config.tsdf_color else None,
            )
        if self.config.method != "keyframe":
            raise ValueError(
                f"process_window() requires method='keyframe' or 'tsdf' (got {self.config.method!r})"
            )
        if timestamps is None:
            timestamps = [None] * len(depths)
        results = []
        i = 0
        while i < len(depths):
            # Non-truncating: keyframe events promote in-loop, so a window
            # never re-submits its tail (the bootstrap call consumes only
            # the first frame).
            consumed = self._impl.process_window(
                depths[i : i + window], timestamps[i : i + window],
                pad_to=window, truncate_at_events=False,
            )
            results.extend(consumed)
            i += len(consumed)
        return results

    @property
    def pose(self):
        return self._impl.pose

    @property
    def trajectory(self) -> Trajectory:
        return self._impl.trajectory

    @property
    def world_map(self):
        """The MapAccumulator of 'projective' with map_capacity > 0 and of
        'model', the surface Cloud of 'tsdf'; None for the other methods."""
        return getattr(self._impl, "world_map", None)

    def world_mesh(self, capacity: int = 131072):
        """TriangleMesh of the dense model (method='tsdf'), else None."""
        fn = getattr(self._impl, "world_mesh", None)
        return fn(capacity) if fn is not None else None

    @property
    def world_map_colored(self):
        """(Cloud, colors) of a color-fusing backend (tsdf_color), else None."""
        return getattr(self._impl, "world_map_colored", None)

    @property
    def world_map_oriented(self):
        """(Cloud, normals) of the dense backend (method='tsdf'), else None."""
        return getattr(self._impl, "world_map_oriented", None)

    def save_trajectory(self, path: str) -> None:
        self.trajectory.save_tum(path)


def _tsdf_impl(config: TrackerConfig):
    """The dense backend of method='tsdf': a TsdfTracker, or the submap
    atlas when config.tsdf_submap_radius > 0."""
    photo_kw = {"photometric": config.rgbd} if config.tsdf_photometric else {}
    if config.tsdf_submap_radius > 0:
        from realsensetracker_tpu_torch.mapping.submaps import SubmapConfig, SubmapTsdfTracker

        return SubmapTsdfTracker(
            config.intrinsics,
            SubmapConfig(volume=config.tsdf, spawn_radius=config.tsdf_submap_radius),
            icp=config.projective, min_inlier_fraction=config.min_inlier_fraction, use_color=config.tsdf_color,
            track_scale_fallback=config.tsdf_track_scale_fallback, device=config.device, **photo_kw,
        )
    from realsensetracker_tpu_torch.tracking.tsdf_tracker import TsdfTracker

    return TsdfTracker(
        config.intrinsics, volume=config.tsdf, icp=config.projective,
        min_inlier_fraction=config.min_inlier_fraction, use_color=config.tsdf_color,
        depth_scale=config.depth_scale, track_scale_fallback=config.tsdf_track_scale_fallback,
        device=config.device, **photo_kw,
    )


_LUMA = (0.299, 0.587, 0.114)  # BT.601


def _as_gray(color):
    """(H, W) gray | (H, W, 3) RGB -> [0, 1] f32 luma (BT.601), a numpy
    array for host input, a tensor on its device for a tensor.

    uint8 scales by 1/255 in BOTH arities: photo_huber and photo_weight
    are calibrated for [0, 1] intensities, so an unscaled 0-255 gray image
    would upset the geometric/photometric balance.
    """
    if isinstance(color, torch.Tensor):
        t = color.to(torch.float32)
        if color.dtype == torch.uint8:
            t = t / 255.0
        if t.dim() == 2:
            return t
        # Python weights: a weight tensor on the card would be a host copy.
        return (t[..., 0] * _LUMA[0] + t[..., 1] * _LUMA[1]) + t[..., 2] * _LUMA[2]
    arr = np.asarray(color)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        return arr.astype(np.float32)
    return arr.astype(np.float32) @ np.asarray(_LUMA, np.float32)


def _cloud_step(depth, prev, pose, config: TrackerConfig):
    """One cloud-tracker frame (unproject + voxel downsample + GNC-ICP or
    GICP onto the previous cloud + pose composition): (curr_cloud, new_pose
    (4,4), relative (4,4), stats (18,)) with stats = [cost, ok,
    new_pose(16)], all on the device."""
    align = config.align
    curr = frame_cloud(depth, config.intrinsics, align.voxel_size, align.cloud_capacity)
    if config.method == "icp":
        out = icp_mod.align_icp(curr, prev, align.icp_max_iter)
        rel, cost = out.transform, out.mean_cost
        ok = torch.isfinite(rel).all() & out.success
    else:
        out = gicp_mod.align_gicp(curr, prev, **dataclasses.asdict(config.gicp))
        rel, cost = out.transform, out.cost
        # A degenerate solve leaves a finite identity with cost inf: gate on
        # the cost and the valid count too, or an empty frame would become
        # the reference.
        ok = torch.isfinite(rel).all() & torch.isfinite(cost) & (out.num_valid >= 3)
    # accumulate = compose + SE(3) projection: a raw compose would let f32
    # rotation drift grow without bound over a long stream.
    new_pose = torch.where(ok, se3.accumulate(pose, rel), pose)
    stats = torch.cat([torch.stack([cost, ok.to(torch.float32)]), new_pose.reshape(-1)])
    return curr, new_pose, rel, stats


class _CloudTracker:
    """The reference replay loop (rs_replay_app.cpp:244-273) on
    voxel-downsampled clouds: each frame registers onto the previous
    frame's cloud by GNC-ICP ("icp") or GICP ("gicp"); a failure keeps the
    pose and the previous cloud. One host transfer per frame. The cloud is
    the JAX facade's ``_fused_depth_to_cloud``: the valid pixels of a
    one-level source pyramid are exactly frame_cloud's."""

    def __init__(self, config: TrackerConfig):
        if config.method not in ("icp", "gicp"):
            raise ValueError(f"the cloud tracker runs method='icp' or 'gicp', not {config.method!r}")
        self.config = config
        self.device = device_mod.resolve(config.device)
        self._prev = None
        self._pose = None
        self._pose_np = None
        self._index = 0
        self.trajectory = Trajectory()

    @property
    def pose(self):
        return self._pose_np

    def process(self, depth, timestamp: float | None = None) -> FrameResult:
        cfg = self.config
        depth = torch.as_tensor(depth, device=self.device)
        if timestamp is None:
            timestamp = float(self._index)
        if self._prev is None:
            self._pose = se3.identity(device=self.device)
            self._pose_np = np.eye(4, dtype=np.float32)
            self._prev = frame_cloud(depth, cfg.intrinsics, cfg.align.voxel_size, cfg.align.cloud_capacity)
            self.trajectory.append(timestamp, self._pose_np)
            res = FrameResult(self._pose_np, se3.identity(device=self.device), True, 0.0, 1.0, self._index)
            self._index += 1
            return res

        curr, new_pose, rel, stats = _cloud_step(depth, self._prev, self._pose, cfg)
        s = stats.cpu().numpy()  # the frame's one host transfer
        cost, ok = float(s[0]), bool(s[1] > 0.5)
        if ok:
            self._pose = new_pose
            self._pose_np = s[2:18].reshape(4, 4)
            self._prev = curr
        self.trajectory.append(timestamp, self._pose_np)
        res = FrameResult(self._pose_np, rel, ok, cost, 1.0 if ok else 0.0, self._index)
        self._index += 1
        return res
