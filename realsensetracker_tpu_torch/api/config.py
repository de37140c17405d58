"""Tracker configuration.

Port of the fields of realsensetracker_tpu/api/config.py:TrackerConfig
that method="projective" reads, plus the torch device the tracker runs on.
"""

from __future__ import annotations

from dataclasses import dataclass

from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu_torch.geometry import camera


@dataclass
class TrackerConfig:
    """Streaming tracker settings."""

    intrinsics: camera.Intrinsics = camera.TUM_DEFAULT
    method: str = "projective"  # the only method ported so far
    projective: ProjectiveIcpConfig = ProjectiveIcpConfig()
    min_inlier_fraction: float = 0.2
    map_capacity: int = 0  # > 0 (the world model) is not ported yet
    depth_scale: float = 1e-3  # meters per raw unit for INTEGER depth frames
    device: str = "cpu"  # "cuda" runs the pyramid through the CUDA level kernel
