"""Tracker configuration.

Port of the fields of realsensetracker_tpu/api/config.py that the ported
methods read ("projective", "keyframe", "model", "icp"), plus the torch
device the tracker runs on. ``AlignConfig`` holds the three fields of the
JAX one (the reference's RsAlignAppSettings) that the cloud tracker reads,
with their defaults; the others come with the GICP, FPFH and
robust-global ports that read them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu_torch.geometry import camera


@dataclass
class AlignConfig:
    """Pairwise registration settings (ref RsAlignAppSettings)."""

    voxel_size: float = 0.05
    icp_max_iter: int = 128
    cloud_capacity: int = 8192  # fixed capacity after voxel downsample


@dataclass
class TrackerConfig:
    """Streaming tracker settings."""

    intrinsics: camera.Intrinsics = camera.TUM_DEFAULT
    method: str = "projective"  # "projective" | "keyframe" | "model" | "icp" (ported so far)
    projective: ProjectiveIcpConfig = ProjectiveIcpConfig()
    align: AlignConfig = field(default_factory=AlignConfig)
    min_inlier_fraction: float = 0.2
    map_capacity: int = 0  # projective: world-map capacity (0 = off); model: model capacity
    map_voxel_size: float = 0.05  # rs_replay_app.cpp:178
    depth_scale: float = 1e-3  # meters per raw unit for INTEGER depth frames
    device: str = device_mod.DEFAULT  # "cpu" runs every kernel's plain torch version
