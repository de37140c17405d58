"""Tracker state checkpoint/resume.

Port of realsensetracker_tpu/tracking/checkpoint.py, in the JAX package's
npz layout, so that a checkpoint written by either package loads in the
other: the port's pyramid levels carry a leading batch of 1
(ops/pyramid.py), which is squeezed on save and restored on load. A
FrameToFrameTracker snapshot holds pose, frame index, trajectory, world
model and reference pyramid; a SlamTracker snapshot adds the VO's keyframe
state, the keyframe store, the loop edges and the counters; a TsdfTracker
snapshot holds the dense volume (tsdf, weight and the color planes) with
its geometry, and a SubmapTsdfTracker snapshot every submap's anchor and
volume with the handover span log.
"""

from __future__ import annotations

import numpy as np
import torch

from realsensetracker_tpu_torch.tracking.trajectory import Trajectory

FORMAT_VERSION = 4  # v4: the resolution-fitted level count (projective.fit_levels)
SLAM_FORMAT_VERSION = 1


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _flatten_levels(levels) -> dict:
    """B = 1 pyramid levels as the JAX package's per-frame arrays."""
    out = {}
    if levels is None:
        return out
    for i, lv in enumerate(levels):
        out[f"level{i}_vertex"] = _host(lv.vertex_map[0])
        out[f"level{i}_normal"] = _host(lv.normal_map[0])
        out[f"level{i}_valid"] = _host(lv.valid[0])
        out[f"level{i}_vertex_valid"] = _host(lv.vertex_valid[0])
        out[f"level{i}_packed"] = _host(lv.packed[0])
    out["num_levels"] = np.int64(len(levels))
    return out


def _restore_levels(data, device) -> list | None:
    from realsensetracker_tpu_torch.ops.pyramid import PyramidLevel

    if "num_levels" not in data:
        return None
    t = lambda key: torch.as_tensor(data[key], device=device)[None]  # noqa: E731
    return [
        PyramidLevel(
            vertex_map=t(f"level{i}_vertex"),
            normal_map=t(f"level{i}_normal"),
            valid=t(f"level{i}_valid"),
            vertex_valid=t(f"level{i}_vertex_valid"),
            packed=t(f"level{i}_packed"),
        )
        for i in range(int(data["num_levels"]))
    ]


def _check_format_version(data, tracker) -> None:
    """Accept the current version, and v3 snapshots whose stored pyramid
    matches this tracker's fitted schedule (v3 -> v4 changed only the
    resolution-fitted level count); snapshots with no pyramid are
    version-independent."""
    version = int(data["format_version"])
    if version == FORMAT_VERSION:
        return
    if version == 3 and "num_levels" in data:
        from realsensetracker_tpu_torch.align.projective import fit_levels

        cfg = getattr(tracker, "cfg", None)
        intr = getattr(tracker, "intr", None)
        if cfg is not None and intr is not None:
            want = len(fit_levels(cfg, intr.height, intr.width).iters)
            if int(data["num_levels"]) == want:
                return
            raise ValueError(
                f"v3 checkpoint stores {int(data['num_levels'])} pyramid levels but this tracker's "
                f"resolution-fitted schedule builds {want} (v4, projective.fit_levels); re-record the snapshot"
            )
    elif version == 3:
        return
    raise ValueError(f"checkpoint version {version} != {FORMAT_VERSION}")


def _trajectory(data) -> Trajectory:
    traj = Trajectory()
    for ts, T in zip(data["traj_timestamps"], data["traj_poses"]):
        traj.append(float(ts), T)
    return traj


def _trajectory_payload(traj) -> dict:
    return {
        "traj_timestamps": np.asarray(traj.timestamps, np.float64),
        "traj_poses": np.stack(traj.poses) if traj.poses else np.zeros((0, 4, 4)),
    }


def save_tracker(path: str, tracker) -> None:
    """Snapshot a FrameToFrameTracker to ``path`` (.npz)."""
    payload = {
        "format_version": np.int64(FORMAT_VERSION),
        "frame_index": np.int64(tracker._index),
        **_trajectory_payload(tracker.trajectory),
    }
    if tracker._pose is not None:
        payload["pose"] = _host(tracker._pose)
    payload.update(_flatten_levels(tracker._prev_levels))
    if getattr(tracker, "_map", None) is not None:
        payload["map_points"] = _host(tracker._map.points)
        payload["map_keys"] = _host(tracker._map.keys)
        payload["map_mask"] = _host(tracker._map.mask)
    np.savez_compressed(path, **payload)


def load_tracker(path: str, tracker) -> None:
    """Restore a save_tracker snapshot (either package's) into ``tracker``
    in place, on the tracker's device."""
    from realsensetracker_tpu_torch.tracking.accumulator import MapAccumulator

    dev = tracker.device
    data = np.load(path, allow_pickle=False)
    _check_format_version(data, tracker)
    tracker._index = int(data["frame_index"])
    tracker.trajectory = _trajectory(data)
    tracker._pose = torch.as_tensor(data["pose"], device=dev) if "pose" in data else None
    tracker._pose_np = np.asarray(data["pose"], np.float32) if "pose" in data else None
    levels = _restore_levels(data, dev)
    tracker._prev_levels = tuple(levels) if levels is not None else None
    if "map_points" in data:
        tracker._map = MapAccumulator(
            points=torch.as_tensor(data["map_points"], device=dev),
            keys=torch.as_tensor(data["map_keys"], device=dev),
            mask=torch.as_tensor(data["map_mask"], device=dev),
        )
    elif getattr(tracker, "map_capacity", 0) and tracker._prev_levels is not None:
        # process() skips its map-init branch once _prev_levels is set: the
        # first successful frame would meet no map. Fail loudly instead.
        raise ValueError(
            "checkpoint has no world model but the tracker was built with "
            f"map_capacity={tracker.map_capacity}; restore into a tracker "
            "with map_capacity=0 or re-record the snapshot with its map"
        )


def save_slam(path: str, tracker) -> None:
    """Snapshot a SlamTracker: VO state, keyframe store (poses, clouds,
    FPFH features, odometry measurements + confidences), loop edges and
    counters. A keyframe still in the booking pipeline is booked first."""
    tracker.flush_pending()
    vo = tracker._vo
    payload = {
        "slam_version": np.int64(SLAM_FORMAT_VERSION),
        "format_version": np.int64(FORMAT_VERSION),
        "frame_index": np.int64(vo._index),
        "fail_streak": np.int64(vo._fail_streak),
        "fails_since_kf": np.int64(vo._fails_since_kf),
        "last_span_failures": np.int64(vo.last_span_failures),
        "frame_count": np.int64(tracker._frame_count),
        "lost": np.bool_(tracker.lost),
        "num_loop_closures": np.int64(tracker.num_loop_closures),
        "num_relocalizations": np.int64(tracker.num_relocalizations),
        "num_online_optimizations": np.int64(tracker.num_online_optimizations),
        **_trajectory_payload(vo.trajectory),
    }
    if vo._pose is not None:
        payload["pose"] = _host(vo._pose)
        payload["kf_pose"] = _host(vo._kf_pose)
    if hasattr(vo, "_kf_target"):  # RGB-D VO (tracking/keyframe_rgbd.py)
        payload["slam_rgb"] = np.bool_(True)
        if vo._kf_target is not None:
            levels, grays = vo._kf_target
            payload.update(_flatten_levels(levels))
            for i, g in enumerate(grays):
                payload[f"level{i}_gray"] = _host(g[0])
    else:
        payload.update(_flatten_levels(vo._kf_levels))
    kfs = tracker._keyframes
    if kfs:
        eye = np.eye(4, dtype=np.float32)
        payload["kf_frame_indices"] = np.asarray([k.frame_index for k in kfs], np.int64)
        payload["kf_poses"] = np.stack([np.asarray(k.pose, np.float32) for k in kfs])
        payload["kf_cloud_points"] = np.stack([_host(k.cloud.points).astype(np.float32) for k in kfs])
        payload["kf_cloud_mask"] = np.stack([_host(k.cloud.mask) for k in kfs])
        payload["kf_feats"] = np.stack([_host(k.feats).astype(np.float32) for k in kfs])
        payload["kf_odom"] = np.stack(
            [np.asarray(k.odom_from_prev, np.float32) if k.odom_from_prev is not None else eye for k in kfs]
        )
        payload["kf_odom_w"] = np.asarray([k.odom_weight for k in kfs], np.float32)
    edges = tracker._loop_edges
    payload["loop_i"] = np.asarray([e[0] for e in edges], np.int64)
    payload["loop_j"] = np.asarray([e[1] for e in edges], np.int64)
    payload["loop_T"] = (
        np.stack([np.asarray(e[2], np.float32) for e in edges]) if edges else np.zeros((0, 4, 4), np.float32)
    )
    payload["loop_w"] = np.asarray([e[3] for e in edges], np.float32)
    np.savez_compressed(path, **payload)


def load_slam(path: str, tracker) -> None:
    """Restore a save_slam snapshot (either package's) into a freshly
    constructed SlamTracker with the same SlamConfig, in place. The
    keyframe database is rebuilt by re-adding every keyframe (descriptors
    are functions of the stored features)."""
    from realsensetracker_tpu_torch.ops.cloud import Cloud
    from realsensetracker_tpu_torch.tracking.slam import _Keyframe

    data = np.load(path, allow_pickle=False)
    sv = int(data["slam_version"])
    if sv != SLAM_FORMAT_VERSION:
        raise ValueError(f"slam checkpoint version {sv} != {SLAM_FORMAT_VERSION}")
    vo = tracker._vo
    dev = vo.device
    _check_format_version(data, vo)
    vo._index = int(data["frame_index"])
    vo._fail_streak = int(data["fail_streak"])
    vo._fails_since_kf = int(data["fails_since_kf"])
    vo.last_span_failures = int(data["last_span_failures"])
    vo.trajectory = _trajectory(data)
    vo._pose = torch.as_tensor(data["pose"], device=dev) if "pose" in data else None
    vo._pose_np = np.asarray(data["pose"], np.float32) if "pose" in data else None
    vo._kf_pose = torch.as_tensor(data["kf_pose"], device=dev) if "kf_pose" in data else None
    levels = _restore_levels(data, dev)
    saved_rgb = "slam_rgb" in data and bool(data["slam_rgb"])
    if hasattr(vo, "_kf_target") != saved_rgb:
        raise ValueError(
            "SLAM checkpoint VO mismatch: snapshot "
            f"{'uses' if saved_rgb else 'does not use'} RGB-D odometry but "
            "the tracker's SlamConfig.use_rgb disagrees"
        )
    if saved_rgb:
        if levels is not None:
            grays = tuple(torch.as_tensor(data[f"level{i}_gray"], device=dev)[None] for i in range(len(levels)))
            vo._kf_target = (tuple(levels), grays)
        else:
            vo._kf_target = None
        vo._last_target = vo._kf_target
    else:
        vo._kf_levels = tuple(levels) if levels is not None else None
        vo._last_levels = vo._kf_levels

    tracker._frame_count = int(data["frame_count"])
    tracker.lost = bool(data["lost"])
    tracker.num_loop_closures = int(data["num_loop_closures"])
    tracker.num_relocalizations = int(data["num_relocalizations"])
    tracker.num_online_optimizations = int(data["num_online_optimizations"])

    tracker._keyframes = []
    if "kf_poses" in data:
        for k in range(data["kf_poses"].shape[0]):
            cloud = Cloud(
                points=torch.as_tensor(data["kf_cloud_points"][k], device=dev),
                mask=torch.as_tensor(data["kf_cloud_mask"][k], device=dev),
            )
            feats = torch.as_tensor(data["kf_feats"][k], device=dev)
            tracker._keyframes.append(_Keyframe(
                index=k,
                frame_index=int(data["kf_frame_indices"][k]),
                pose=np.asarray(data["kf_poses"][k], np.float32),
                cloud=cloud,
                feats=feats,
                odom_from_prev=np.asarray(data["kf_odom"][k], np.float32) if k else None,
                odom_weight=float(data["kf_odom_w"][k]),
            ))
            tracker._db.add(k, cloud, feats)
    tracker._loop_edges = [
        (int(i), int(j), np.asarray(T, np.float32), float(w))
        for i, j, T, w in zip(data["loop_i"], data["loop_j"], data["loop_T"], data["loop_w"])
    ]


TSDF_FORMAT_VERSION = 1
SUBMAP_FORMAT_VERSION = 1


def _unwrap_tsdf(tracker):
    """A TsdfTracker, or the api.Tracker facade around one."""
    impl = getattr(tracker, "_impl", tracker)
    if not hasattr(impl, "_vol"):
        raise ValueError("not a TSDF tracker (method='tsdf')")
    return impl


def _check_geometry(data, cfg) -> None:
    vs = float(data["vol_voxel_size"])
    org = data["vol_origin"]
    if abs(vs - cfg.voxel_size) > 1e-9 or np.abs(org - np.asarray(cfg.origin)).max() > 1e-9:
        raise ValueError(
            f"snapshot volume geometry (voxel {vs} m, origin {org.tolist()}) != configured "
            f"(voxel {cfg.voxel_size} m, origin {list(cfg.origin)})"
        )


def save_tsdf(path: str, tracker) -> None:
    """Snapshot a TsdfTracker: pose, frame index, trajectory and the dense
    volume (tsdf, weight [+ color planes]) with its geometry."""
    tracker = _unwrap_tsdf(tracker)
    payload = {
        "tsdf_version": np.int64(TSDF_FORMAT_VERSION),
        "frame_index": np.int64(tracker._index),
        **_trajectory_payload(tracker.trajectory),
        "vol_voxel_size": np.float64(tracker.volume.voxel_size),
        "vol_origin": np.asarray(tracker.volume.origin, np.float64),
    }
    if tracker._pose is not None:
        payload["pose"] = _host(tracker._pose)
    vol = tracker._vol
    if vol is not None:
        payload["vol_tsdf"] = _host(vol.tsdf)
        payload["vol_weight"] = _host(vol.weight)
        if vol.color is not None:
            payload["vol_color"] = _host(vol.color)
            payload["vol_color_weight"] = _host(vol.color_weight)
    np.savez_compressed(path, **payload)


def load_tsdf(path: str, tracker) -> None:
    """Restore a save_tsdf snapshot (either package's) into a freshly
    constructed TsdfTracker with the same TsdfConfig, in place, on the
    tracker's device."""
    from realsensetracker_tpu_torch.mapping.tsdf import TsdfVolume

    tracker = _unwrap_tsdf(tracker)
    dev = tracker.device
    data = np.load(path, allow_pickle=False)
    version = int(data["tsdf_version"])
    if version != TSDF_FORMAT_VERSION:
        raise ValueError(f"tsdf checkpoint version {version} != {TSDF_FORMAT_VERSION}")
    saved_color = "vol_color" in data
    if "vol_voxel_size" in data:
        _check_geometry(data, tracker.volume)
    if "vol_tsdf" in data:
        v = data["vol_tsdf"].shape[-1]
        if v != tracker.volume.resolution:
            raise ValueError(f"snapshot volume {v}^3 != configured {tracker.volume.resolution}^3")
        if saved_color != bool(tracker.use_color):
            raise ValueError(
                f"TSDF checkpoint color mismatch: snapshot {'has' if saved_color else 'lacks'} color planes but "
                "the tracker's use_color disagrees"
            )
        t = lambda key: torch.as_tensor(data[key], dtype=torch.float32, device=dev)  # noqa: E731
        tracker._vol = TsdfVolume(
            tsdf=t("vol_tsdf"), weight=t("vol_weight"),
            color=t("vol_color") if saved_color else None,
            color_weight=t("vol_color_weight") if saved_color else None,
        )
    else:
        tracker._vol = None
    tracker._index = int(data["frame_index"])
    tracker.trajectory = _trajectory(data)
    tracker._pose = torch.as_tensor(data["pose"], dtype=torch.float32, device=dev) if "pose" in data else None
    tracker._pose_np = np.asarray(data["pose"], np.float32) if "pose" in data else None


def _unwrap_submaps(tracker):
    """A SubmapTsdfTracker, or the api.Tracker facade around one."""
    impl = getattr(tracker, "_impl", tracker)
    if not (hasattr(impl, "_subs") and hasattr(impl, "_t")):
        raise ValueError("not a submap TSDF tracker (method='tsdf' with a spawn radius)")
    return impl


def save_submaps(path: str, tracker) -> None:
    """Snapshot a SubmapTsdfTracker: every submap's anchor and dense planes
    (stacked (K, V, V, V), the active one's live volume included), the
    handover span log, the inner tracker's pose and the world trajectory."""
    tr = _unwrap_submaps(tracker)
    inner = tr._t
    cfg = tr.config
    subs = tr.submaps  # the live anchor and volume stand in for the active id
    payload = {
        "submap_version": np.int64(SUBMAP_FORMAT_VERSION),
        "vol_voxel_size": np.float64(cfg.volume.voxel_size),
        "vol_origin": np.asarray(cfg.volume.origin, np.float64),
        "spawn_radius": np.float64(cfg.spawn_radius),
        "frame_index": np.int64(inner._index),
        "frames_in_active": np.int64(tr._frames_in_active),
        "active_id": np.int64(tr._active_id),
        "span_log": np.asarray(tr._span_log, np.int64).reshape(-1, 2),
        **_trajectory_payload(tr.trajectory),
    }
    if subs:
        payload["anchors"] = np.stack([s.world_from_submap for s in subs]).astype(np.float32)
        # Stored frames exclude the active streak (frames_in_active is its own field).
        payload["sub_frames"] = np.asarray([e.frames for e in tr._subs], np.int64)
        payload["subs_tsdf"] = np.stack([_host(s.volume.tsdf) for s in subs])
        payload["subs_weight"] = np.stack([_host(s.volume.weight) for s in subs])
        if tr.use_color:
            payload["subs_color"] = np.stack([_host(s.volume.color) for s in subs])
            payload["subs_color_weight"] = np.stack([_host(s.volume.color_weight) for s in subs])
    if inner._pose is not None:
        payload["pose"] = _host(inner._pose)
    np.savez_compressed(path, **payload)


def load_submaps(path: str, tracker) -> None:
    """Restore a save_submaps snapshot (either package's) into a freshly
    constructed SubmapTsdfTracker with the same volume geometry, in place:
    the active volume on the tracker's device, the frozen ones in host
    memory (or on the device without offload_finished)."""
    from realsensetracker_tpu_torch.mapping.submaps import Submap, _to_device, _to_host
    from realsensetracker_tpu_torch.mapping.tsdf import TsdfVolume

    tr = _unwrap_submaps(tracker)
    inner = tr._t
    dev = tr.device
    data = np.load(path, allow_pickle=False)
    version = int(data["submap_version"])
    if version != SUBMAP_FORMAT_VERSION:
        raise ValueError(f"submap checkpoint version {version} != {SUBMAP_FORMAT_VERSION}")
    cfgv = tr.config.volume
    _check_geometry(data, cfgv)
    saved_color = "subs_color" in data
    if "anchors" in data and saved_color != bool(tr.use_color):
        raise ValueError(
            f"submap checkpoint color mismatch: snapshot {'has' if saved_color else 'lacks'} color planes but the "
            "tracker's use_color disagrees"
        )
    active_id = int(data["active_id"])
    tr._subs = []
    if "anchors" in data:
        if data["subs_tsdf"].shape[-1] != cfgv.resolution:
            raise ValueError(f"snapshot volume {data['subs_tsdf'].shape[-1]}^3 != configured {cfgv.resolution}^3")
        for i in range(data["anchors"].shape[0]):
            t = lambda key: torch.as_tensor(np.ascontiguousarray(data[key][i]), dtype=torch.float32)  # noqa: E731
            vol = TsdfVolume(
                tsdf=t("subs_tsdf"), weight=t("subs_weight"),
                color=t("subs_color") if saved_color else None,
                color_weight=t("subs_color_weight") if saved_color else None,
            )
            if i == active_id or not tr.config.offload_finished:
                vol = _to_device(vol, dev)
            elif dev.type == "cuda":
                vol = _to_host(vol)  # pinned, as a frozen submap is kept
            tr._subs.append(Submap(world_from_submap=np.asarray(data["anchors"][i], np.float32), volume=vol,
                                   frames=int(data["sub_frames"][i])))
    tr._active_id = active_id
    if active_id >= 0:
        tr._anchor = tr._subs[active_id].world_from_submap
        inner._vol = tr._subs[active_id].volume
    else:
        inner._vol = None
    inner._pose = torch.as_tensor(data["pose"], dtype=torch.float32, device=dev) if "pose" in data else None
    inner._pose_np = np.asarray(data["pose"], np.float32) if "pose" in data else None
    inner._index = int(data["frame_index"])
    tr._frames_in_active = int(data["frames_in_active"])
    tr._span_log = [(int(a), int(b)) for a, b in data["span_log"]]
    tr.trajectory = _trajectory(data)
    tr._pose_np = np.asarray(tr.trajectory.poses[-1], np.float32) if tr.trajectory.poses else None
