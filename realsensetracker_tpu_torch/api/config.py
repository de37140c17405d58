"""Configuration dataclasses.

Port of realsensetracker_tpu/api/config.py: every tracking method
("projective", "keyframe", "model", "icp", "gicp", "rgbd", "tsdf") and the
pairwise pipelines of ``models``, plus the torch device the tracker runs on,
and the replay app's settings (ReplayConfig).
Defaults reproduce the reference's settings:

* AlignConfig mirrors RsAlignAppSettings (rs_align_app.cpp:21-31):
  voxel_size 0.05, normal_k 16, feature_radius 0.5, lowe_ratio 0.9 and the
  init_with_fpfh / refine_with_icp / use_robust switches;
* icp_max_iter 128 (rs_replay_app.cpp:251, rs_align_app.cpp:303);
* GICP: 16 outer rounds (align_gicp.cpp:107), Huber delta 0.5 (:67),
  covariance k 32 (point_cloud_utils.cpp:104);
* robust noise_bound 0.25 (rs_replay_app.cpp:263, rs_align_app.cpp:312).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig
from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.mapping.tsdf import TsdfConfig


@dataclass
class AlignConfig:
    """Pairwise registration settings (ref RsAlignAppSettings)."""

    voxel_size: float = 0.05
    normal_k: int = 16
    feature_radius: float = 0.5
    lowe_ratio: float = 0.9
    init_with_fpfh: bool = True
    refine_with_icp: bool = True
    use_robust: bool = False  # 'use_teaser' in the reference
    icp_max_iter: int = 128
    fpfh_max_neighbors: int = 64  # kNN cap on the radius ball; 0 = auto-size
    # to the densest true ball (exact radiusSearch parity, fpfh.cpp:133-147)
    noise_bound: float = 0.25
    cloud_capacity: int = 8192  # fixed capacity after voxel downsample


@dataclass
class GicpConfig:
    """align_gicp's keyword arguments, with the reference's defaults."""

    max_outer: int = 16  # align_gicp.cpp:107
    inner_iters: int = 8
    cov_k: int = 32  # point_cloud_utils.cpp:104
    use_gicp_cov: bool = False  # align_gicp.cpp:121-123 passes false
    huber_delta: float = 0.5  # align_gicp.cpp:67


@dataclass
class TrackerConfig:
    """Streaming tracker settings."""

    intrinsics: camera.Intrinsics = camera.TUM_DEFAULT
    method: str = "projective"  # "projective" | "keyframe" | "model" | "icp" | "gicp" | "rgbd" | "tsdf"
    projective: ProjectiveIcpConfig = ProjectiveIcpConfig()
    rgbd: RgbdIcpConfig = RgbdIcpConfig()  # method="rgbd": the joint geometric + photometric solver
    tsdf: TsdfConfig = TsdfConfig()  # method="tsdf": volume and raycast settings
    tsdf_color: bool = False  # method="tsdf": fuse per-voxel RGB too
    tsdf_photometric: bool = False  # method="tsdf": joint geometric + photometric frame-to-model
    # registration with the `rgbd` solver config; requires tsdf_color
    tsdf_submap_radius: float = 0.0  # method="tsdf": > 0 switches to the submap atlas (mapping/submaps.py),
    # spawning a new volume every this-many meters of camera/view-centre drift; 0 = one volume
    tsdf_track_scale_fallback: float = 0.0  # method="tsdf" with tsdf.track_scale > 1: coverage floor below
    # which reduced-resolution tracking falls back to full resolution; 0 = off
    align: AlignConfig = field(default_factory=AlignConfig)
    gicp: GicpConfig = field(default_factory=GicpConfig)
    min_inlier_fraction: float = 0.2
    map_capacity: int = 0  # projective: world-map capacity (0 = off); model: model capacity
    map_voxel_size: float = 0.05  # rs_replay_app.cpp:178
    depth_scale: float = 1e-3  # meters per raw unit for INTEGER depth frames
    device: str = device_mod.DEFAULT  # "cpu" runs every kernel's plain torch version


@dataclass
class ReplayConfig:
    """Replay app settings (ref RsReplayAppSettings, rs_replay_app.cpp:36-39)."""

    record_file: str = ""
    frame_interval_ms: float = 0.0
    max_frames: int = 0  # 0 = all
    trajectory_out: str = ""
