"""TSDF frame-to-model tracking: register every frame against a raycast
render of the fused dense volume (KinectFusion tracking loop).

Port of realsensetracker_tpu/tracking/tsdf_tracker.py. Per frame: render
the model at the previous pose (kernels/tsdf.march), register the frame
onto the render by projective point-to-plane ICP (the pyramid kernels and
one gn_round launch per association round; or the joint RGB-D solver with
``photometric``), then integrate the frame at the new pose
(kernels/tsdf.fuse_block). The volume, the pose and the photometric
reference stay on the device; whether a frame fuses (registration success,
integrate_every cadence) and where (the slab window) are device tensors the
integrate kernel reads. A frame costs one device-to-host copy, its stats
row; ``process_window`` runs the same step over W frames in a Python loop
and costs one copy per window.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.kernels import downsample
from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod
from realsensetracker_tpu_torch.ops.pyramid import depth_to_meters
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameResult
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


def _luma(color: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> (...) BT.601 luma, Python weights (no host copy)."""
    w = tsdf_mod.LUMA
    return (color[..., 0] * w[0] + color[..., 1] * w[1]) + color[..., 2] * w[2]


def _track_views(depth: torch.Tensor, intr: camera.Intrinsics, track_scale: int):
    """(tracking-resolution depth, intrinsics) of live (..., H, W) frames:
    ``track_scale`` (a power of two) halves them that many times with the
    ICP pyramid's validity-aware 2x2 pooling (kernels/downsample on the
    card, one launch for all frames; invalid pixels 0) and the intrinsics
    with Intrinsics.halved."""
    if track_scale <= 1:
        return depth, intr
    if track_scale & (track_scale - 1):
        raise ValueError(f"track_scale={track_scale} must be a power of 2")
    valid = torch.isfinite(depth) & (depth > 0)
    d = torch.where(valid, depth, 0.0).reshape(-1, *depth.shape[-2:]).contiguous()
    halvings = track_scale.bit_length() - 1
    out = downsample.downsample_levels(d, halvings + 1, 0.0)[-1][0]
    for _ in range(halvings):
        intr = intr.halved()
    return out.reshape(*depth.shape[:-2], *out.shape[-2:]), intr


def _pool_gray(gray: torch.Tensor, track_scale: int) -> torch.Tensor:
    """Plain 2x2 mean pooling of an intensity image to the tracking
    resolution (intensity has no invalid sentinel)."""
    s = track_scale
    while s > 1:
        h = gray.shape[-2] // 2 * 2
        w = gray.shape[-1] // 2 * 2
        gray = gray[..., :h, :w].reshape(*gray.shape[:-2], h // 2, 2, w // 2, 2).mean(dim=(-3, -1))
        s //= 2
    return gray


TSDF_STATS_WIDTH = 21  # [rmse, inlier_fraction, ok, pose(16), track_cov, fused]


class TsdfStepOut(NamedTuple):
    """Result of one frame-to-model step (unpacked by attribute)."""

    vol: object  # the volume (updated in place)
    pose: torch.Tensor  # (4, 4) new world_from_cam
    relative: torch.Tensor  # (4, 4) accepted relative transform (I on failure)
    gray: object  # next photometric reference (None without photometric)
    stats: torch.Tensor  # (TSDF_STATS_WIDTH,) [rmse, inlier_fraction, ok, pose(16), track_cov, fused];
    # track_cov = valid render pixels / valid frame pixels at the tracking
    # resolution; fused = 1 when this frame integrated


def _tsdf_step_math(vol, depth, pose, color, valid, prev_gray=None, *, intr, vol_cfg, icp_cfg,
                    min_inlier_fraction, photo_cfg=None, photo_ref="frame", fuse=None) -> TsdfStepOut:
    """One frame-to-model step on the device (JAX _tsdf_step_math).

    Renders the model at ``pose``, registers the frame (the render is the
    destination, so the transform composes right onto the previous pose),
    and integrates the frame at the new pose. A failed registration
    (non-finite transform or inlier fraction below the gate) or ``valid``
    False holds the pose and the volume: the integrate kernel reads the gate
    on the device. With ``photo_cfg`` (an RgbdIcpConfig; colored volume and
    color frames) registration is joint geometric + photometric; the
    photometric reference is the previous frame's gray (``photo_ref``
    "frame", held on failure like the pose) or the fused-color render
    ("model"). ``fuse`` (a bool, or a () bool tensor) gates integration on
    the integrate_every cadence when vol_cfg.integrate_every > 1."""
    from realsensetracker_tpu_torch.align import rgbd as rgbd_mod

    new_gray = None
    track_scale = int(vol_cfg.track_scale)
    t_depth, t_intr = _track_views(depth, intr, track_scale)
    if photo_cfg is not None:
        gray = _luma(color)
        if photo_ref == "frame":
            model_depth = tsdf_mod.render_model_depth(vol, pose, t_intr, vol_cfg)
            ref_gray = _pool_gray(prev_gray, track_scale)
        else:
            model_depth, ref_gray = tsdf_mod.render_model_rgbd(vol, pose, t_intr, vol_cfg)
        res = rgbd_mod.register_rgbd_pair(t_depth[None], _pool_gray(gray, track_scale)[None], model_depth[None],
                                          ref_gray[None], t_intr, photo_cfg)
    else:
        model_depth = tsdf_mod.render_model_depth(vol, pose, t_intr, vol_cfg)
        res = projective.register_depth_pair(t_depth[None], model_depth[None], t_intr, icp_cfg)
    T, rmse, inlier = res.transform[0], res.rmse[0], res.inlier_fraction[0]
    ok = torch.isfinite(T).all() & (inlier >= min_inlier_fraction) & valid
    f32 = torch.float32
    track_cov = (model_depth > 0).sum().to(f32) / torch.clamp((t_depth > 0).sum().to(f32), min=1.0)
    do_int = (ok & fuse) if int(vol_cfg.integrate_every) > 1 else ok
    new_pose = torch.where(ok, se3.orthonormalize(se3.compose(pose, T)), pose)
    tsdf_mod.integrate(vol, depth, new_pose, intr, vol_cfg, color=color, gate=do_int)
    stats = torch.cat([
        torch.stack([rmse.to(f32), inlier.to(f32), ok.to(f32)]),
        new_pose.reshape(-1).to(f32),
        torch.stack([track_cov, do_int.to(f32)]),
    ])
    relative = torch.where(ok, T, torch.eye(4, dtype=f32, device=T.device))
    if photo_cfg is not None:
        new_gray = torch.where(ok, gray, prev_gray) if photo_ref == "frame" else gray
    return TsdfStepOut(vol, new_pose, relative, new_gray, stats)


def _seed_volume(depth, intr, vol_cfg, color=None, with_color=False, depth_scale=1.0):
    """A fresh volume with ``depth`` fused at identity."""
    depth = depth_to_meters(depth, depth_scale)
    vol = tsdf_mod.init_volume(vol_cfg, with_color=with_color, device=depth.device)
    return tsdf_mod.integrate(vol, depth, se3.identity(device=depth.device), intr, vol_cfg, color=color)


@dataclass
class TsdfTracker:
    """Streaming dense frame-to-model tracker (KinectFusion loop)."""

    # Raw integer (u16) frames convert to meters on the device at depth_scale.
    accepts_raw_depth = True

    intr: camera.Intrinsics
    volume: tsdf_mod.TsdfConfig = tsdf_mod.TsdfConfig()
    icp: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig()
    min_inlier_fraction: float = 0.2
    surface_capacity: int = 65536  # extract_surface output size
    use_color: bool = False  # fuse per-voxel RGB; process() then needs a color frame per call
    photometric: object = None  # RgbdIcpConfig | None: joint geometric + photometric registration (use_color)
    photometric_ref: str = "frame"  # "frame": previous raw gray; "model": the fused-color render
    depth_scale: float = 1e-3  # meters per raw unit for integer depth frames
    track_scale_fallback: float = 0.0  # coverage floor below which track_scale > 1 falls back to 1
    fallback_patience: int = 3  # consecutive low-coverage frames before the fallback
    device: str | torch.device = device_mod.DEFAULT

    _vol: object = field(default=None, repr=False)
    _prev_gray: object = field(default=None, repr=False)  # photometric reference (device)
    _pose: object = field(default=None, repr=False)  # device copy
    _pose_np: object = field(default=None, repr=False)  # host mirror
    _index: int = 0
    _fuse_counter: int = 0  # frames since the (re)seed; the seed is fuse slot 0
    _track_cfg: object = field(default=None, repr=False)  # active tracking config (track_scale may drop to 1)
    _low_cov_streak: int = 0
    num_track_scale_fallbacks: int = 0
    trajectory: Trajectory = field(default_factory=Trajectory)

    def __post_init__(self):
        self.device = device_mod.resolve(self.device)
        if self.photometric is not None and not self.use_color:
            raise ValueError(
                "photometric frame-to-model needs use_color=True (color drives the photometric term and the "
                "colored model)"
            )
        if self.photometric_ref not in ("frame", "model"):
            raise ValueError("photometric_ref must be 'frame' or 'model'")
        self._track_cfg = self.volume

    @property
    def track_scale_active(self) -> int:
        """The tracking-resolution divisor in effect (1 after a fallback)."""
        return int(self._track_cfg.track_scale)

    def _fuse_due(self, offset: int = 0) -> bool | None:
        """integrate_every due flag of the frame ``offset`` after the next
        (None when decimation is off)."""
        n = int(self.volume.integrate_every)
        if n <= 1:
            return None
        return (self._fuse_counter + offset) % n == 0

    def _monitor_track_cov(self, cov: float) -> None:
        thresh = float(self.track_scale_fallback)
        if thresh <= 0 or self.track_scale_active <= 1:
            return
        if cov < thresh:
            self._low_cov_streak += 1
            if self._low_cov_streak >= int(self.fallback_patience):
                self._track_cfg = self.volume._replace(track_scale=1)
                self.num_track_scale_fallbacks += 1
                self._low_cov_streak = 0
        else:
            self._low_cov_streak = 0

    @property
    def pose(self):
        return self._pose_np

    @property
    def tsdf_volume(self):
        """The device-resident TsdfVolume (None before the seed)."""
        return self._vol

    @property
    def world_map(self):
        """Zero-level surface as a masked Cloud (extracted on access)."""
        if self._vol is None:
            return None
        return tsdf_mod.extract_surface(self._vol, self.volume, self.surface_capacity)

    @property
    def world_map_oriented(self):
        """(Cloud, normals (C, 3)) with TSDF-gradient normals; None before the seed."""
        if self._vol is None:
            return None
        return tsdf_mod.extract_surface_oriented(self._vol, self.volume, self.surface_capacity)

    def world_mesh(self, capacity: int = 131072):
        """Zero-level surface as a TriangleMesh (marching tetrahedra; colored
        vertices iff use_color); None before the seed."""
        if self._vol is None:
            return None
        from realsensetracker_tpu_torch.mapping.mesh import extract_mesh

        return extract_mesh(self._vol, self.volume, capacity, with_color=self.use_color)

    @property
    def world_map_colored(self):
        """(Cloud, colors (C, 3) in [0, 1]); None unless use_color."""
        if self._vol is None or not self.use_color:
            return None
        return tsdf_mod.extract_surface_colored(self._vol, self.volume, self.surface_capacity)

    def _color_frame(self, color):
        """The frame's color as (H, W, 3) f32 in [0, 1] on the device (u8
        scales by 1/255, gray repeats to 3 channels); None without use_color."""
        if not self.use_color:
            return None
        if color is None:
            raise ValueError("use_color tracker: process() needs an (H, W, 3) color frame per call")
        t = color if isinstance(color, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(color))
        t = t.to(self.device)
        t = t.to(torch.float32) / 255.0 if t.dtype == torch.uint8 else t.to(torch.float32)
        if t.dim() == 2:
            t = t[..., None].expand(*t.shape, 3)
        return t.contiguous()

    def _as_depth(self, depth) -> torch.Tensor:
        """A frame on the device: raw integers stay integer (converted on the
        device at depth_scale), floats become f32 meters."""
        t = depth if isinstance(depth, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(depth))
        t = t.to(self.device)
        return t.to(torch.float32) if t.is_floating_point() else t

    def _meters(self, depth) -> torch.Tensor:
        return depth_to_meters(self._as_depth(depth), self.depth_scale).contiguous()

    def _start_episode(self, depth, color) -> None:
        """Fresh volume fused at identity, pose reset, fuse cadence and
        reduced-resolution tracking re-armed."""
        self._vol = _seed_volume(self._meters(depth), self.intr, self.volume, color=color,
                                 with_color=self.use_color)
        if self.photometric is not None:
            self._prev_gray = _luma(color)
        self._pose = se3.identity(device=self.device)
        self._pose_np = np.eye(4, dtype=np.float32)
        self._fuse_counter = 1
        self._track_cfg = self.volume
        self._low_cov_streak = 0

    def reseed(self, depth, color=None, model_depth=None) -> None:
        """Restart the model from this frame: a fresh volume fused at
        identity, pose reset; trajectory and frame index are kept (the
        submap-atlas handover primitive). ``model_depth`` (the old model
        rendered at the handover pose, a depth frame in the new submap's
        camera frame) also fuses at identity, borrowing the frame's color."""
        color = self._color_frame(color)
        self._start_episode(depth, color)
        if model_depth is not None:
            md = torch.as_tensor(model_depth, dtype=torch.float32, device=self.device).contiguous()
            tsdf_mod.integrate(self._vol, md, self._pose, self.intr, self.volume, color=color)

    def process(self, depth, timestamp: float | None = None, color=None) -> FrameResult:
        if timestamp is None:
            timestamp = float(self._index)
        color = self._color_frame(color)

        if self._vol is None:
            self._start_episode(depth, color)
            self.trajectory.append(timestamp, self._pose_np)
            res = FrameResult(self._pose_np, se3.identity(device=self.device), True, 0.0, 1.0, self._index)
            self._index += 1
            return res

        due = self._fuse_due()
        out = _tsdf_step_math(
            self._vol, self._meters(depth), self._pose, color, True, self._prev_gray,
            intr=self.intr, vol_cfg=self._track_cfg, icp_cfg=self.icp,
            min_inlier_fraction=float(self.min_inlier_fraction), photo_cfg=self.photometric,
            photo_ref=self.photometric_ref, fuse=due,
        )
        self._fuse_counter += 1
        self._prev_gray = out.gray
        s = out.stats.cpu().numpy()  # the frame's one host transfer
        self._pose = out.pose
        return self._read_row(s, out.relative, timestamp)

    def _read_row(self, s: np.ndarray, relative, timestamp) -> FrameResult:
        rmse, inlier, ok = float(s[0]), float(s[1]), bool(s[2] > 0.5)
        self._monitor_track_cov(float(s[19]))
        if ok:
            self._pose_np = s[3:19].reshape(4, 4)
        if timestamp is None:
            timestamp = float(self._index)
        self.trajectory.append(timestamp, self._pose_np)
        res = FrameResult(pose=self._pose_np, relative=relative, success=ok, rmse=rmse, inlier_fraction=inlier,
                          frame_index=self._index)
        self._index += 1
        return res

    def process_window(self, depths, timestamps=None, window: int = 8, colors=None) -> list[FrameResult]:
        """Process a batch of frames, up to ``window`` frames per host copy.
        Identical per-frame results to process() (the same step, the carry
        on the device); each chunk's stats and relative transforms come back
        in one (k, 37) copy. Eager PyTorch has no compiled program to reuse,
        so a short tail is not padded. Seeding (the first frame ever) happens
        per frame, before the loop."""
        n = len(depths)
        if timestamps is None:
            timestamps = [None] * n
        if self.use_color and (colors is None or len(colors) != n):
            raise ValueError("use_color tracker: process_window() needs one color frame per depth frame")
        results: list[FrameResult] = []
        i = 0
        if self._vol is None and n:
            results.append(self.process(depths[0], timestamps[0], color=colors[0] if colors is not None else None))
            i = 1
        while i < n:
            k = min(window, n - i)
            rows = []
            for j in range(k):
                color = self._color_frame(colors[i + j]) if self.use_color else None
                out = _tsdf_step_math(
                    self._vol, self._meters(depths[i + j]), self._pose, color, True, self._prev_gray,
                    intr=self.intr, vol_cfg=self._track_cfg, icp_cfg=self.icp,
                    min_inlier_fraction=float(self.min_inlier_fraction), photo_cfg=self.photometric,
                    photo_ref=self.photometric_ref, fuse=self._fuse_due(j),
                )
                self._pose, self._prev_gray = out.pose, out.gray
                rows.append(torch.cat([out.stats, out.relative.reshape(-1)]))
            self._fuse_counter += k
            s = torch.stack(rows).cpu().numpy()  # the window's one host transfer
            for j in range(k):
                results.append(self._read_row(s[j, :TSDF_STATS_WIDTH], s[j, TSDF_STATS_WIDTH:].reshape(4, 4),
                                              timestamps[i + j]))
            i += k
        return results
