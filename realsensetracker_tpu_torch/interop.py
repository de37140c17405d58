"""Carry configuration and tracker state across from the JAX package.

The system has no weights: what a user carries is configuration and
tracker state. These functions read the JAX objects' NamedTuple fields and
arrays through numpy, so this module imports neither JAX nor
realsensetracker_tpu. Trackers land on ``device``, the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig
from realsensetracker_tpu_torch.api.batching import BatchingConfig
from realsensetracker_tpu_torch.api.config import AlignConfig, GicpConfig, TrackerConfig
from realsensetracker_tpu_torch.api.tracker import _CloudTracker
from realsensetracker_tpu_torch.data.recorded import Clip
from realsensetracker_tpu_torch.geometry.camera import Intrinsics
from realsensetracker_tpu_torch.mapping.submaps import Submap, SubmapConfig, SubmapTsdfTracker, _to_host
from realsensetracker_tpu_torch.mapping.tsdf import TsdfConfig, TsdfVolume
from realsensetracker_tpu_torch.ops.cloud import Cloud
from realsensetracker_tpu_torch.ops.pyramid import PyramidLevel
from realsensetracker_tpu_torch.parallel.streams import RgbdStreamState, StreamState, TsdfStreamState
from realsensetracker_tpu_torch.tracking.accumulator import MapAccumulator
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameToFrameTracker
from realsensetracker_tpu_torch.tracking.frame_to_model import FrameToModelTracker
from realsensetracker_tpu_torch.tracking.keyframe import KeyframeTracker
from realsensetracker_tpu_torch.tracking.keyframe_rgbd import RgbdKeyframeTracker
from realsensetracker_tpu_torch.tracking.rgbd import RgbdTracker
from realsensetracker_tpu_torch.tracking.slam import SlamConfig, SlamTracker, _Keyframe
from realsensetracker_tpu_torch.tracking.tsdf_tracker import TsdfTracker
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


def intrinsics_from_jax(obj) -> Intrinsics:
    return Intrinsics(
        fx=float(obj.fx), fy=float(obj.fy), cx=float(obj.cx), cy=float(obj.cy),
        width=int(obj.width), height=int(obj.height),
    )


def clip_from_jax(clip) -> Clip:
    """A JAX recorded.Clip as the port's: the same host arrays, the
    intrinsics rebuilt as the port's camera.Intrinsics."""
    colors = None if clip.colors is None else np.asarray(clip.colors, np.uint8)
    return Clip(depths=np.asarray(clip.depths, np.float32), timestamps=np.asarray(clip.timestamps, np.float64),
                intrinsics=intrinsics_from_jax(clip.intrinsics), colors=colors)


def icp_config_from_jax(cfg) -> ProjectiveIcpConfig:
    fields = {name: getattr(cfg, name) for name in ProjectiveIcpConfig._fields}
    fields["iters"] = tuple(int(i) for i in cfg.iters)
    return ProjectiveIcpConfig(**fields)


def rgbd_config_from_jax(cfg) -> RgbdIcpConfig:
    fields = {name: getattr(cfg, name) for name in RgbdIcpConfig._fields}
    fields["iters"] = tuple(int(i) for i in cfg.iters)
    return RgbdIcpConfig(**fields)


def align_config_from_jax(cfg) -> AlignConfig:
    return AlignConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(AlignConfig)})


def gicp_config_from_jax(cfg) -> GicpConfig:
    return GicpConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(GicpConfig)})


def tsdf_config_from_jax(cfg) -> TsdfConfig:
    """A JAX TsdfConfig as the port's, every field carried over."""
    fields = {name: getattr(cfg, name) for name in TsdfConfig._fields}
    fields["origin"] = tuple(float(o) for o in cfg.origin)
    return TsdfConfig(**fields)


def tracker_config_from_jax(cfg, device=device_mod.DEFAULT) -> TrackerConfig:
    """The fields of a JAX TrackerConfig that the port reads."""
    return TrackerConfig(
        intrinsics=intrinsics_from_jax(cfg.intrinsics),
        method=cfg.method,
        projective=icp_config_from_jax(cfg.projective),
        rgbd=rgbd_config_from_jax(cfg.rgbd),
        tsdf=tsdf_config_from_jax(cfg.tsdf),
        tsdf_color=bool(cfg.tsdf_color),
        tsdf_photometric=bool(cfg.tsdf_photometric),
        tsdf_submap_radius=float(cfg.tsdf_submap_radius),
        tsdf_track_scale_fallback=float(cfg.tsdf_track_scale_fallback),
        align=align_config_from_jax(cfg.align),
        gicp=gicp_config_from_jax(cfg.gicp),
        min_inlier_fraction=float(cfg.min_inlier_fraction),
        map_capacity=int(cfg.map_capacity),
        map_voxel_size=float(cfg.map_voxel_size),
        depth_scale=float(cfg.depth_scale),
        device=str(device),
    )


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.tensor(a, device=device_mod.resolve(device))


def cloud_from_jax(cloud, device=device_mod.DEFAULT) -> Cloud:
    return Cloud(_tensor(cloud.points, device), _tensor(cloud.mask, device))


def map_from_jax(acc, device=device_mod.DEFAULT) -> MapAccumulator:
    """A JAX MapAccumulator (points f32, keys int32, mask) -> the port's."""
    return MapAccumulator(_tensor(acc.points, device), _tensor(acc.keys, device), _tensor(acc.mask, device))


def pyramid_levels_from_numpy(levels, device=device_mod.DEFAULT) -> list[PyramidLevel]:
    """JAX PyramidLevels of one frame -> port PyramidLevels with B = 1."""
    device = device_mod.resolve(device)
    return [PyramidLevel(*(_tensor(a, device)[None] for a in lvl)) for lvl in levels]


def frame_to_frame_state_from_jax(jax_tracker, device=device_mod.DEFAULT) -> FrameToFrameTracker:
    """A port FrameToFrameTracker that continues the JAX tracker's stream:
    same pose, reference pyramid, world map, frame index, trajectory and
    fitted cfg."""
    tracker = FrameToFrameTracker(
        intrinsics_from_jax(jax_tracker.intr),
        icp_config_from_jax(jax_tracker.cfg),
        min_inlier_fraction=float(jax_tracker.min_inlier_fraction),
        map_capacity=int(jax_tracker.map_capacity),
        map_voxel_size=float(jax_tracker.map_voxel_size),
        map_points_per_frame=int(jax_tracker.map_points_per_frame),
        device=device,
    )
    if jax_tracker._map is not None:
        tracker._map = map_from_jax(jax_tracker._map, device)
    if jax_tracker._prev_levels is not None:
        tracker._prev_levels = tuple(pyramid_levels_from_numpy(jax_tracker._prev_levels, device))
        tracker._pose = _tensor(jax_tracker._pose, device)
        tracker._pose_np = np.asarray(jax_tracker._pose_np, dtype=np.float32)
    tracker._index = int(jax_tracker._index)
    tracker.trajectory = _trajectory(jax_tracker.trajectory)
    return tracker


def _trajectory(traj) -> Trajectory:
    return Trajectory(list(traj.timestamps), [np.array(p, dtype=np.float64) for p in traj.poses])


def frame_to_model_state_from_jax(jax_tracker, device=device_mod.DEFAULT) -> FrameToModelTracker:
    """A port FrameToModelTracker that continues the JAX tracker's stream:
    same settings, model, pose, frame index and trajectory."""
    tracker = FrameToModelTracker(
        intrinsics_from_jax(jax_tracker.intr),
        voxel_size=float(jax_tracker.voxel_size),
        icp_max_iter=int(jax_tracker.icp_max_iter),
        frame_capacity=int(jax_tracker.frame_capacity),
        model_capacity=int(jax_tracker.model_capacity),
        max_mean_cost=float(jax_tracker.max_mean_cost),
        device=device,
    )
    if jax_tracker._model is not None:
        tracker._model = map_from_jax(jax_tracker._model, device)
        tracker._pose = _tensor(jax_tracker._pose, device)
        tracker._pose_np = np.asarray(jax_tracker._pose_np, dtype=np.float32)
    tracker._index = int(jax_tracker._index)
    tracker.trajectory = _trajectory(jax_tracker.trajectory)
    return tracker


def cloud_tracker_state_from_jax(jax_tracker, device=device_mod.DEFAULT) -> _CloudTracker:
    """A port cloud tracker (the ``Tracker(method="icp" | "gicp")`` backend) that
    continues the JAX facade's ``_CloudTracker``: same config, previous
    cloud, pose, frame index and trajectory."""
    tracker = _CloudTracker(tracker_config_from_jax(jax_tracker.config, device))
    if jax_tracker._prev is not None:
        tracker._prev = cloud_from_jax(jax_tracker._prev, device)
        tracker._pose = _tensor(jax_tracker._pose, device)
        tracker._pose_np = np.asarray(jax_tracker._pose_np, dtype=np.float32)
    tracker._index = int(jax_tracker._index)
    tracker.trajectory = _trajectory(jax_tracker.trajectory)
    return tracker


def keyframe_state_from_jax(jax_tracker, device=device_mod.DEFAULT) -> KeyframeTracker:
    """A port KeyframeTracker that continues the JAX KeyframeTracker's
    stream: same thresholds, depth_scale, fitted cfg, keyframe pyramid and
    pose, pose, failure bookkeeping, frame index and trajectory."""
    tracker = KeyframeTracker(
        intrinsics_from_jax(jax_tracker.intr),
        icp_config_from_jax(jax_tracker.cfg),
        min_inlier_fraction=float(jax_tracker.min_inlier_fraction),
        max_translation=float(jax_tracker.max_translation),
        max_rotation=float(jax_tracker.max_rotation),
        min_overlap=float(jax_tracker.min_overlap),
        max_consecutive_failures=int(jax_tracker.max_consecutive_failures),
        depth_scale=float(jax_tracker.depth_scale),
        device=device,
    )
    if jax_tracker._kf_levels is not None:
        tracker._kf_levels = tuple(pyramid_levels_from_numpy(jax_tracker._kf_levels, device))
        tracker._kf_pose = _tensor(jax_tracker._kf_pose, device)
        tracker._pose = _tensor(jax_tracker._pose, device)
        tracker._pose_np = np.asarray(jax_tracker._pose_np, dtype=np.float32)
    if jax_tracker._last_levels is not None:
        tracker._last_levels = tuple(pyramid_levels_from_numpy(jax_tracker._last_levels, device))
    if jax_tracker._last_depth is not None:
        tracker._last_depth = np.asarray(jax_tracker._last_depth)
    tracker._fail_streak = int(jax_tracker._fail_streak)
    tracker._fails_since_kf = int(jax_tracker._fails_since_kf)
    tracker.last_span_failures = int(jax_tracker.last_span_failures)
    tracker._index = int(jax_tracker._index)
    tracker.trajectory = _trajectory(jax_tracker.trajectory)
    return tracker


def _rgbd_target(target, device):
    """A JAX RGB-D target (plane-table levels, gray levels) of one frame ->
    the port's, with B = 1."""
    levels, grays = target
    return tuple(pyramid_levels_from_numpy(levels, device)), tuple(_tensor(g, device)[None] for g in grays)


def rgbd_state_from_jax(jax_tracker, device=device_mod.DEFAULT) -> RgbdTracker:
    """A port RgbdTracker that continues the JAX RgbdTracker's stream: same
    fitted cfg, previous target (plane-table levels and gray pyramid),
    pose, frame index and trajectory."""
    tracker = RgbdTracker(
        intrinsics_from_jax(jax_tracker.intr),
        rgbd_config_from_jax(jax_tracker.cfg),
        min_inlier_fraction=float(jax_tracker.min_inlier_fraction),
        device=device,
    )
    if jax_tracker._prev_target is not None:
        tracker._prev_target = _rgbd_target(jax_tracker._prev_target, device)
        tracker._pose = _tensor(jax_tracker._pose, device)
        tracker._pose_np = np.asarray(jax_tracker._pose_np, dtype=np.float32)
    tracker._index = int(jax_tracker._index)
    tracker.trajectory = _trajectory(jax_tracker.trajectory)
    return tracker


def rgbd_keyframe_state_from_jax(jax_tracker, device=device_mod.DEFAULT) -> RgbdKeyframeTracker:
    """A port RgbdKeyframeTracker that continues the JAX one's stream: same
    thresholds, fitted cfg, keyframe target and pose, pose, last frame's
    target or frame, failure bookkeeping, frame index and trajectory."""
    tracker = RgbdKeyframeTracker(
        intrinsics_from_jax(jax_tracker.intr),
        rgbd_config_from_jax(jax_tracker.cfg),
        min_inlier_fraction=float(jax_tracker.min_inlier_fraction),
        max_translation=float(jax_tracker.max_translation),
        max_rotation=float(jax_tracker.max_rotation),
        min_overlap=float(jax_tracker.min_overlap),
        max_consecutive_failures=int(jax_tracker.max_consecutive_failures),
        device=device,
    )
    if jax_tracker._kf_target is not None:
        tracker._kf_target = _rgbd_target(jax_tracker._kf_target, device)
        tracker._kf_pose = _tensor(jax_tracker._kf_pose, device)
        tracker._pose = _tensor(jax_tracker._pose, device)
        tracker._pose_np = np.asarray(jax_tracker._pose_np, dtype=np.float32)
    if jax_tracker._last_target is not None:
        tracker._last_target = _rgbd_target(jax_tracker._last_target, device)
    if jax_tracker._last_frame is not None:
        tracker._last_frame = tuple(np.asarray(a, np.float32) for a in jax_tracker._last_frame)
    tracker._fail_streak = int(jax_tracker._fail_streak)
    tracker._fails_since_kf = int(jax_tracker._fails_since_kf)
    tracker.last_span_failures = int(jax_tracker.last_span_failures)
    tracker._index = int(jax_tracker._index)
    tracker.trajectory = _trajectory(jax_tracker.trajectory)
    return tracker


def slam_config_from_jax(cfg, device=device_mod.DEFAULT) -> SlamConfig:
    """A JAX SlamConfig as the port's, every field carried over."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(SlamConfig) if f.name != "device"}
    fields["intrinsics"] = intrinsics_from_jax(cfg.intrinsics)
    fields["icp"] = icp_config_from_jax(cfg.icp)
    fields["align"] = align_config_from_jax(cfg.align)
    fields["rgbd"] = rgbd_config_from_jax(cfg.rgbd) if cfg.rgbd is not None else None
    return SlamConfig(**fields, device=str(device))


def slam_state_from_jax(jax_slam, device=device_mod.DEFAULT) -> SlamTracker:
    """A port SlamTracker that continues the JAX SlamTracker's stream: its
    VO (keyframe_state_from_jax or rgbd_keyframe_state_from_jax), keyframes,
    database (re-added, as load_slam rebuilds it), loop edges, counters and
    lost flag. A keyframe in the JAX tracker's booking pipeline is booked
    first."""
    jax_slam.flush_pending()
    tracker = SlamTracker(slam_config_from_jax(jax_slam.config, device))
    if tracker.config.use_rgb:
        tracker._vo = rgbd_keyframe_state_from_jax(jax_slam._vo, device)
    else:
        tracker._vo = keyframe_state_from_jax(jax_slam._vo, device)
    for kf in jax_slam._keyframes:
        cloud = cloud_from_jax(kf.cloud, device)
        feats = _tensor(kf.feats, device)
        tracker._keyframes.append(_Keyframe(
            index=int(kf.index),
            frame_index=int(kf.frame_index),
            pose=np.asarray(kf.pose, np.float32),
            cloud=cloud,
            feats=feats,
            odom_from_prev=None if kf.odom_from_prev is None else np.asarray(kf.odom_from_prev, np.float32),
            odom_weight=float(kf.odom_weight),
            depth=None if kf.depth is None else np.asarray(kf.depth, np.float32),
        ))
        tracker._db.add(int(kf.index), cloud, feats)
    tracker._loop_edges = [(int(i), int(j), np.asarray(T, np.float32), float(w))
                           for i, j, T, w in jax_slam._loop_edges]
    tracker.num_loop_closures = jax_slam.num_loop_closures
    tracker.num_relocalizations = int(jax_slam.num_relocalizations)
    tracker.num_online_optimizations = jax_slam.num_online_optimizations
    tracker.lost = bool(jax_slam.lost)
    tracker._frame_count = int(jax_slam._frame_count)
    tracker._optimize_due = bool(jax_slam._optimize_due)
    return tracker


def tsdf_volume_from_jax(vol, device=device_mod.DEFAULT) -> TsdfVolume:
    """A JAX TsdfVolume (tsdf, weight and, when colored, color and
    color_weight) -> the port's, on ``device``."""
    return TsdfVolume(*(None if a is None else _tensor(a, device) for a in vol))


def tsdf_state_from_jax(jax_tracker, device=device_mod.DEFAULT) -> TsdfTracker:
    """A port TsdfTracker that continues the JAX TsdfTracker's stream: same
    settings, volume, pose, photometric reference, fuse counter, active
    tracking config (after a track_scale fallback), frame index and
    trajectory."""
    photo = jax_tracker.photometric
    tracker = TsdfTracker(
        intrinsics_from_jax(jax_tracker.intr),
        volume=tsdf_config_from_jax(jax_tracker.volume),
        icp=icp_config_from_jax(jax_tracker.icp),
        min_inlier_fraction=float(jax_tracker.min_inlier_fraction),
        surface_capacity=int(jax_tracker.surface_capacity),
        use_color=bool(jax_tracker.use_color),
        photometric=None if photo is None else rgbd_config_from_jax(photo),
        photometric_ref=jax_tracker.photometric_ref,
        depth_scale=float(jax_tracker.depth_scale),
        track_scale_fallback=float(jax_tracker.track_scale_fallback),
        fallback_patience=int(jax_tracker.fallback_patience),
        device=device,
    )
    _carry_tsdf_state(jax_tracker, tracker, device)
    return tracker


def _carry_tsdf_state(jax_tracker, tracker: TsdfTracker, device) -> None:
    if jax_tracker._vol is not None:
        tracker._vol = tsdf_volume_from_jax(jax_tracker._vol, device)
    if jax_tracker._prev_gray is not None:
        tracker._prev_gray = _tensor(jax_tracker._prev_gray, device)
    if jax_tracker._pose is not None:
        tracker._pose = _tensor(jax_tracker._pose, device)
        tracker._pose_np = np.asarray(jax_tracker._pose_np, dtype=np.float32)
    tracker._fuse_counter = int(jax_tracker._fuse_counter)
    tracker._track_cfg = tsdf_config_from_jax(jax_tracker._track_cfg)
    tracker._low_cov_streak = int(jax_tracker._low_cov_streak)
    tracker.num_track_scale_fallbacks = int(jax_tracker.num_track_scale_fallbacks)
    tracker._index = int(jax_tracker._index)
    tracker.trajectory = _trajectory(jax_tracker.trajectory)


def submap_state_from_jax(jax_atlas, device=device_mod.DEFAULT) -> SubmapTsdfTracker:
    """A port SubmapTsdfTracker that continues the JAX atlas's stream: same
    policy, every submap (anchor, volume, frames; frozen volumes in host
    memory when offloaded), the inner tracker's state, the span log and
    the world trajectory."""
    inner = jax_atlas._t
    cfg = jax_atlas.config
    photo = inner.photometric
    atlas = SubmapTsdfTracker(
        intrinsics_from_jax(jax_atlas.intr),
        SubmapConfig(
            volume=tsdf_config_from_jax(cfg.volume), spawn_radius=float(cfg.spawn_radius),
            probe_depth=float(cfg.probe_depth), min_frames=int(cfg.min_frames),
            offload_finished=bool(cfg.offload_finished), reactivate=bool(cfg.reactivate),
            reactivate_min_inliers=float(cfg.reactivate_min_inliers), auto_slab=bool(cfg.auto_slab),
        ),
        icp=icp_config_from_jax(inner.icp),
        min_inlier_fraction=float(inner.min_inlier_fraction),
        surface_capacity=int(jax_atlas.surface_capacity),
        use_color=bool(jax_atlas.use_color),
        photometric=None if photo is None else rgbd_config_from_jax(photo),
        photometric_ref=inner.photometric_ref,
        track_scale_fallback=float(inner.track_scale_fallback),
        device=device,
    )
    _carry_tsdf_state(inner, atlas._t, device)
    dev = atlas.device
    for k, s in enumerate(jax_atlas._subs):
        vol = None
        if s.volume is not None and k != jax_atlas._active_id:
            vol = tsdf_volume_from_jax(s.volume, dev)
            if atlas.config.offload_finished and dev.type == "cuda":
                vol = _to_host(vol)
            elif atlas.config.offload_finished:
                vol = TsdfVolume(*(None if a is None else a.cpu() for a in vol))
        atlas._subs.append(Submap(world_from_submap=np.asarray(s.world_from_submap, np.float32), volume=vol,
                                  frames=int(s.frames)))
    atlas._anchor = np.asarray(jax_atlas._anchor, np.float32)
    atlas._frames_in_active = int(jax_atlas._frames_in_active)
    atlas._active_id = int(jax_atlas._active_id)
    atlas._span_log = [(int(a), int(b)) for a, b in jax_atlas._span_log]
    atlas.trajectory = _trajectory(jax_atlas.trajectory)
    atlas._pose_np = None if jax_atlas._pose_np is None else np.asarray(jax_atlas._pose_np, np.float32)
    return atlas


# --- multi-stream state and the batching executor ------------------------------


def _batched_levels(levels, device) -> tuple:
    """JAX PyramidLevels batched over the slot axis -> port PyramidLevels."""
    return tuple(PyramidLevel(*(_tensor(a, device) for a in lvl)) for lvl in levels)


def _slot_fields(state, device) -> dict:
    return {
        "poses": _tensor(state.poses, device),
        "initialized": _tensor(state.initialized, device),
        "frame_count": _tensor(np.asarray(state.frame_count, np.int32), device),
    }


def stream_state_from_jax(state, device=device_mod.DEFAULT) -> StreamState:
    """A JAX parallel.streams.StreamState (poses, batched reference
    pyramids, initialized, frame_count) as the port's."""
    return StreamState(ref_levels=_batched_levels(state.ref_levels, device), **_slot_fields(state, device))


def rgbd_stream_state_from_jax(state, device=device_mod.DEFAULT) -> RgbdStreamState:
    """A JAX RgbdStreamState (plane-table and intensity pyramids) as the port's."""
    return RgbdStreamState(
        ref_levels=_batched_levels(state.ref_levels, device),
        ref_grays=tuple(_tensor(g, device) for g in state.ref_grays),
        **_slot_fields(state, device),
    )


def tsdf_stream_state_from_jax(state, device=device_mod.DEFAULT) -> TsdfStreamState:
    """A JAX TsdfStreamState ((S, V, V, V) tsdf and weight planes) as the port's."""
    volume = TsdfVolume(_tensor(state.volume.tsdf, device), _tensor(state.volume.weight, device))
    return TsdfStreamState(volume=volume, **_slot_fields(state, device))


def batching_config_from_jax(cfg, device=device_mod.DEFAULT, mesh=None) -> BatchingConfig:
    """A JAX BatchingConfig as the port's. A sharded one (JAX mesh set)
    needs the port's own mesh (parallel.mesh.make_mesh) in ``mesh``: a JAX
    Mesh of devices cannot be carried into torch ranks, so without one it
    raises. The data axis carries over."""
    if getattr(cfg, "mesh", None) is not None and mesh is None:
        raise ValueError(
            "a BatchingConfig with a JAX mesh shards the slot axis over devices: pass the port's mesh "
            "(parallel.mesh.make_mesh) as mesh="
        )
    return BatchingConfig(
        intrinsics=intrinsics_from_jax(cfg.intrinsics),
        icp=icp_config_from_jax(cfg.icp),
        capacity=int(cfg.capacity),
        min_inlier_fraction=float(cfg.min_inlier_fraction),
        linger_ms=float(cfg.linger_ms),
        request_timeout_s=float(cfg.request_timeout_s),
        window=int(cfg.window),
        rgbd=bool(cfg.rgbd),
        rgbd_icp=rgbd_config_from_jax(cfg.rgbd_icp),
        tsdf=bool(cfg.tsdf),
        tsdf_cfg=None if cfg.tsdf_cfg is None else tsdf_config_from_jax(cfg.tsdf_cfg),
        tsdf_submap_radius=float(cfg.tsdf_submap_radius),
        depth_scale=float(cfg.depth_scale),
        device=str(device),
        mesh=mesh,
        data_axis=str(cfg.data_axis),
    )
