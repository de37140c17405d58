"""Mapping tracker: keyframe VO + loop closure + pose-graph optimization.

Port of realsensetracker_tpu/tracking/slam.py. Keyframe odometry
(tracking/keyframe.py, or tracking/keyframe_rgbd.py with color) feeds a
keyframe database (loop_closure/detector.py); verified loop closures
become edges of a pose graph optimized on the device
(optimize/pose_graph.py); the voxel world model rebuilds from the
optimized keyframe poses.

Keyframe booking runs synchronously or, by default, through the deferred
pipeline of the JAX package (SlamConfig.defer_keyframe_booking): a clean
promotion's work spreads over the next four frames -- stage-A prep (cloud)
on the event frame, stage-B prep (FPFH + descriptor) one frame later, place
recognition, insertion and verification the next, one wait frame, then the
verdicts are booked. Eager PyTorch runs each stage's work when the stage
fires (verification reads its stop flags on the host), so the pipeline
spreads the host work of an event over five frames; every quantity is
taken at event time, so keyframes, loop edges and the optimized trajectory
equal synchronous booking's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.api.config import AlignConfig
from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.kernels import downsample
from realsensetracker_tpu_torch.loop_closure.detector import KeyframeDatabase, global_descriptor
from realsensetracker_tpu_torch.ops import cloud as cloud_mod
from realsensetracker_tpu_torch.ops import fpfh as fpfh_mod
from realsensetracker_tpu_torch.ops import voxel as voxel_mod
from realsensetracker_tpu_torch.ops.pyramid import depth_to_meters, level_intrinsics
from realsensetracker_tpu_torch.optimize import pose_graph as pg
from realsensetracker_tpu_torch.tracking.keyframe import KeyframeTracker
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


def _check_prep_scale(prep_scale) -> int:
    s = int(prep_scale)
    if s < 1 or s & (s - 1):
        raise ValueError(f"keyframe_prep_scale must be a power of two >= 1, got {prep_scale!r}")
    return s


def _device_frame(depth, device) -> torch.Tensor:
    """A frame as a tensor on ``device``: raw integers stay integer (they
    convert to meters there), floats become f32."""
    t = depth if isinstance(depth, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(depth))
    t = t.to(device)
    return t.to(torch.float32) if t.is_floating_point() else t


def _prep_cloud_math(depth, *, intr, voxel_size, capacity, depth_scale=1.0, prep_scale=1):
    """Depth frame (H, W) on the device -> capacity-bounded keyframe cloud.

    Raw integer frames convert to meters on the device. ``prep_scale`` (a
    power of two) builds the cloud from the 1/prep_scale pyramid level (the
    ICP pyramid's validity-aware 2x2 pooling: the downsample kernel on the
    card). Pixels unproject as JAX's compiled prep does,
    x = d (u - cx) * (1 / fx) (camera.unproject_depth_compiled), so voxel
    keys agree with it. The capacity reduction is spatially uniform
    (ops.cloud.subsample_to_capacity)."""
    n_levels = max(_check_prep_scale(prep_scale).bit_length(), 1)  # 1->1, 2->2, 4->3
    d = depth_to_meters(depth, depth_scale)
    valid = camera.valid_mask(d, 0.05, 10.0)
    d = torch.where(valid, d, 0.0)
    if n_levels > 1:
        d, valid = downsample.downsample_levels(d[None].contiguous(), n_levels)[-1]
        d, valid = d[0], valid[0]
    lv_intr = level_intrinsics(intr, n_levels)[-1]
    h, w = d.shape
    pts = camera.unproject_depth_compiled(d, lv_intr).reshape(h * w, 3)
    c = voxel_mod.downsample_voxel(cloud_mod.Cloud(points=pts, mask=valid.reshape(h * w)), voxel_size)
    return cloud_mod.subsample_to_capacity(c, capacity)


def _prep_features_math(kf_cloud, *, normal_k, feature_radius, max_neighbors):
    """Keyframe cloud -> (FPFH features, place descriptor)."""
    viewpoint = torch.zeros(3, dtype=torch.float32, device=kf_cloud.points.device)
    feats = fpfh_mod.compute_fpfh(kf_cloud, viewpoint, normal_k, feature_radius, max_neighbors)
    return feats, global_descriptor(feats, kf_cloud.mask)


# The deferred pipeline's two stages: stage A (unproject + voxel downsample
# + capacity) on the event frame, stage B (FPFH + descriptor) one frame
# later. JAX compiles each as its own program; here they are the functions.
_keyframe_prep_cloud = _prep_cloud_math
_keyframe_prep_features = _prep_features_math


def _fused_keyframe_prep(depth, *, intr, voxel_size, normal_k, feature_radius, max_neighbors, capacity,
                         depth_scale=1.0, prep_scale=1):
    """Depth frame -> (keyframe cloud, FPFH features, place descriptor): the
    synchronous paths' prep (relocalization, synchronous booking)."""
    kf_cloud = _prep_cloud_math(depth, intr=intr, voxel_size=voxel_size, capacity=capacity,
                                depth_scale=depth_scale, prep_scale=prep_scale)
    feats, desc = _prep_features_math(kf_cloud, normal_k=normal_k, feature_radius=feature_radius,
                                      max_neighbors=max_neighbors)
    return kf_cloud, feats, desc


@dataclass
class SlamConfig:
    """The JAX SlamConfig's fields and defaults (their reasons are given
    there, realsensetracker_tpu/tracking/slam.py:130-267), plus the device."""

    intrinsics: camera.Intrinsics = camera.TUM_DEFAULT
    icp: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig()
    align: AlignConfig = field(default_factory=AlignConfig)
    loop_similarity: float = 0.95
    loop_min_separation: int = 5  # in keyframes
    loop_noise_bound: float = 0.25
    loop_weight: float = 0.25  # loop edges are less precise than odometry
    loop_overlap_tau: float = 0.05  # verifier: symmetric-overlap distance
    loop_min_overlap: float = 0.6
    # Odometry gate on loop transforms: gate + drift_per_keyframe * |i - j|
    # in twist norm (drift grows with separation).
    loop_odometry_gate: float = 0.3
    loop_drift_per_keyframe: float = 0.05
    optimize_every: int = 0  # online optimization every N keyframes (0: on demand)
    keyframe_cloud_capacity: int = 4096
    relocalize: bool = True  # robust global registration after a failure streak
    reloc_candidates: int = 3  # recent keyframes + the best place-recognition hits
    reloc_retry_every: int = 5  # lost mode: retry cadence in frames
    reloc_odom_weight: float = 0.02  # floor of the chain edge into a relocalized keyframe
    use_rgb: bool = False  # RGB-D odometry (process takes gray frames)
    rgbd: "object" = None  # align.rgbd.RgbdIcpConfig; None -> defaults
    keep_depths: bool = False  # keep keyframe depths for dense re-fusion
    depth_scale: float = 1e-3  # meters per raw unit of INTEGER depth frames
    window_defer_events: bool = True  # process_window: book promotions after the scan
    defer_keyframe_booking: bool = True  # the five-frame booking pipeline
    keyframe_prep_scale: int = 1  # keyframe clouds from the 1/s pyramid level (a power of two)
    device: str = device_mod.DEFAULT


def _se3_log_np(T: np.ndarray) -> np.ndarray:
    """Host-side SE(3) log in NumPy, [tx ty tz rx ry rz] as geometry.se3.log;
    an inf twist near theta = pi (the loop gate rejects it anyway)."""
    R = np.asarray(T[:3, :3], np.float64)
    t = np.asarray(T[:3, 3], np.float64)
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(c))
    if theta < 1e-7:
        w_hat = 0.5 * (R - R.T)
        w = np.array([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]])
        return np.concatenate([t, w])
    s = np.sin(theta)
    if abs(s) < 1e-6:
        return np.full(6, np.inf)
    w_hat = (R - R.T) * (theta / (2.0 * s))
    w = np.array([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]])
    V_inv = (
        np.eye(3)
        - 0.5 * w_hat
        + (1.0 / theta**2) * (1.0 - theta * s / (2.0 * (1.0 - np.cos(theta)))) * (w_hat @ w_hat)
    )
    return np.concatenate([V_inv @ t, w])


@dataclass
class _Keyframe:
    index: int  # keyframe index (graph node id)
    frame_index: int
    pose: np.ndarray  # world_from_keyframe (updated by optimization)
    cloud: object
    feats: object
    # prev_kf^-1 @ this, captured AT INSERTION: the graph is rebuilt from
    # these, never re-extracted from optimized poses.
    odom_from_prev: np.ndarray | None = None
    odom_weight: float = 1.0  # reduced when the span had tracking failures
    depth: np.ndarray | None = None  # raw (H, W) f32 meters under keep_depths


class SlamTracker:
    """Streaming SLAM: depth frames in -> loop-consistent trajectory out."""

    accepts_raw_depth = True

    def __init__(self, config: SlamConfig | None = None):
        self.config = config or SlamConfig()
        self.device = device_mod.resolve(self.config.device)
        _check_prep_scale(self.config.keyframe_prep_scale)
        if self.config.use_rgb:
            from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig
            from realsensetracker_tpu_torch.tracking.keyframe_rgbd import RgbdKeyframeTracker

            self._vo = RgbdKeyframeTracker(self.config.intrinsics, self.config.rgbd or RgbdIcpConfig(),
                                           device=self.device)
        else:
            self._vo = KeyframeTracker(self.config.intrinsics, self.config.icp,
                                       depth_scale=self.config.depth_scale, device=self.device)
        self._db = KeyframeDatabase(min_separation=self.config.loop_min_separation,
                                    similarity_threshold=self.config.loop_similarity)
        self._keyframes: list[_Keyframe] = []
        self._loop_edges: list[tuple] = []  # (kf_i, kf_j, T_ij, weight)
        self._num_loop_closures = 0
        self.num_relocalizations = 0
        self._num_online_optimizations = 0
        self.lost = False  # un-relocalized tracking loss: pose is stale
        self._frame_count = 0
        self._optimize_due = False  # the cadence fired inside a deferred window
        self._pending_kf: dict | None = None  # at most one keyframe in the booking pipeline

    @property
    def trajectory(self) -> Trajectory:
        return self._vo.trajectory

    @property
    def keyframe_count(self) -> int:
        self.flush_pending()
        return len(self._keyframes)

    # Counters read after a stream flush, so a still-pipelined keyframe's
    # loop edges are counted; the setters serve checkpoint restore.
    @property
    def num_loop_closures(self) -> int:
        self.flush_pending()
        return self._num_loop_closures

    @num_loop_closures.setter
    def num_loop_closures(self, v) -> None:
        self._num_loop_closures = int(v)

    @property
    def num_online_optimizations(self) -> int:
        self.flush_pending()
        return self._num_online_optimizations

    @num_online_optimizations.setter
    def num_online_optimizations(self, v) -> None:
        self._num_online_optimizations = int(v)

    def _meters(self, depth):
        """f32 meters of a frame where it lies: numpy for host frames, a
        tensor on its device for a tensor."""
        if isinstance(depth, torch.Tensor):
            return depth_to_meters(depth, self.config.depth_scale)
        from realsensetracker_tpu_torch.data.depth_units import to_meters_np

        return to_meters_np(depth, self.config.depth_scale)

    def _host_meters(self, depth) -> np.ndarray:
        m = self._meters(depth)
        return (m.cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)).astype(np.float32)

    def process(self, depth, timestamp: float | None = None, gray=None):
        if self.config.use_rgb:
            if gray is None:
                raise ValueError("SlamConfig.use_rgb=True: process() needs gray frames")
            from realsensetracker_tpu_torch.api.tracker import _as_gray

            res = self._vo.process(self._meters(depth), _as_gray(gray), timestamp)
        else:
            res = self._vo.process(depth, timestamp)
        self._frame_count += 1
        return self._post_frame(depth, res, defer_booking=self.config.defer_keyframe_booking)

    def process_window(self, depths, timestamps=None, window: int = 8, grays=None):
        """Process frames scanning up to ``window`` per VO window (the VO's
        process_window; use_rgb needs ``grays``).

        window_defer_events=True (default): the scan truncates only at
        recovery re-seeds; promotions are consumed in-scan and booked after
        it from the per-row results, the online optimization cadence at the
        window boundary. False: the scan truncates at every keyframe event,
        so the SLAM logic runs at exactly the frames process() would. While
        lost, frames go one by one (the retry cadence). One result per frame.
        """
        if self.config.use_rgb and grays is None:
            raise ValueError("SlamConfig.use_rgb=True: process_window() needs grays")
        self.flush_pending()
        if timestamps is None:
            timestamps = [None] * len(depths)
        defer = self.config.window_defer_events
        results = []
        i = 0
        while i < len(depths):
            if self.lost:
                if self.config.use_rgb:
                    results.append(self.process(depths[i], timestamps[i], gray=grays[i]))
                else:
                    results.append(self.process(depths[i], timestamps[i]))
                i += 1
                continue
            mode = "failures" if defer else True
            if self.config.use_rgb:
                from realsensetracker_tpu_torch.api.tracker import _as_gray

                consumed = self._vo.process_window(
                    [self._meters(d) for d in depths[i : i + window]],
                    [_as_gray(g) for g in grays[i : i + window]],
                    timestamps[i : i + window], pad_to=window, truncate_at_events=mode,
                )
            else:
                consumed = self._vo.process_window(depths[i : i + window], timestamps[i : i + window],
                                                   pad_to=window, truncate_at_events=mode)
            self._frame_count += len(consumed)
            if defer:
                # Book each in-scan promotion in frame order; only the last
                # row can be a failure re-seed (the scan latches there). The
                # online optimization waits until all of the window's
                # keyframes are booked: their odometry edges must be
                # measured in one drift frame.
                opt_due = False
                for j, res in enumerate(consumed):
                    if res.is_new_keyframe:
                        consumed[j] = self._post_frame(depths[i + j], res, defer_optimize=True)
                        opt_due = opt_due or self._optimize_due
                        self._optimize_due = False
                if opt_due:
                    self._optimize_online()
            else:
                res = consumed[-1]
                if res.is_new_keyframe:
                    consumed[-1] = self._post_frame(depths[i + len(consumed) - 1], res)
            results.extend(consumed)
            i += len(consumed)
        return results

    def flush_pending(self) -> None:
        """Run the booking pipeline to completion (a no-op when empty):
        before anything that must see current keyframe / loop-edge state."""
        while self._pending_kf is not None:
            self._advance_pending()

    def _advance_pending(self) -> None:
        """Advance the deferred keyframe one pipeline stage."""
        p = self._pending_kf
        if p is None:
            return
        if p["stage"] == 1:
            self._pending_fire_features()
        elif p["stage"] == 2:
            self._pending_stage2()
        elif p["stage"] == 3:
            p["stage"] = 4  # the wait frame
        else:
            self._pending_stage3()

    def _prep_kwargs(self) -> dict:
        cfg = self.config
        return dict(intr=cfg.intrinsics, voxel_size=float(cfg.align.voxel_size),
                    capacity=int(cfg.keyframe_cloud_capacity), depth_scale=float(cfg.depth_scale),
                    prep_scale=int(cfg.keyframe_prep_scale))

    def _feature_kwargs(self) -> dict:
        cfg = self.config
        return dict(normal_k=int(cfg.align.normal_k), feature_radius=float(cfg.align.feature_radius),
                    max_neighbors=int(cfg.align.fpfh_max_neighbors))

    def _defer_keyframe(self, depth, res) -> None:
        """Stage 1 (the event frame): the stage-A prep and a snapshot of
        every event-time quantity the later stages need."""
        span = getattr(res, "span_failures", None)
        if span is None:
            span = self._vo.last_span_failures
        self._pending_kf = {
            "stage": 1,
            "cloud": _keyframe_prep_cloud(_device_frame(depth, self.device), **self._prep_kwargs()),
            "pose": np.asarray(res.pose, np.float64),
            "frame_index": int(res.frame_index),
            "span": int(span),
            "depth": depth if self.config.keep_depths else None,
        }

    def _pending_fire_features(self) -> None:
        """Stage 1.5 (one frame later): the stage-B prep on the stage-A cloud."""
        p = self._pending_kf
        p["feat"] = _keyframe_prep_features(p["cloud"], **self._feature_kwargs())
        p["stage"] = 2

    def _pending_stage2(self) -> None:
        """Stage 2 (two frames after the event): place recognition, keyframe
        and odometry-edge insertion, loop verification (its verdicts stay
        on the device until stage 3)."""
        cfg = self.config
        p = self._pending_kf
        cloud = p["cloud"]
        feats, desc = p["feat"]
        kf_idx = len(self._keyframes)
        pose = p["pose"]
        kf = _Keyframe(
            index=kf_idx,
            frame_index=p["frame_index"],
            pose=pose.astype(np.float32),
            cloud=cloud,
            feats=feats,
            odom_from_prev=(
                (np.linalg.inv(self._keyframes[-1].pose.astype(np.float64)) @ pose).astype(np.float32)
                if self._keyframes else None
            ),
            odom_weight=max(0.02, 1.0 / (1.0 + p["span"])),
            depth=self._host_meters(p["depth"]) if cfg.keep_depths else None,
        )
        hits = self._db.query(kf_idx, cloud, feats, desc=desc)
        p["verify"] = self._db.verify_batch_async(
            kf_idx, cloud, feats, [c for c, _ in hits], noise_bound=cfg.loop_noise_bound,
            overlap_tau=cfg.loop_overlap_tau, min_overlap=cfg.loop_min_overlap, pad_to=3,
        )
        self._db.add(kf_idx, cloud, feats)
        self._keyframes.append(kf)
        p["kf_idx"] = kf_idx
        p["stage"] = 3

    def _pending_stage3(self) -> None:
        """Final stage (four frames after the event): collect the verdicts,
        book accepted edges, run the optimize cadence."""
        p = self._pending_kf
        self._pending_kf = None
        kf_idx = p["kf_idx"]
        if p["verify"] is not None:
            T_dev, ok_dev, kept = p["verify"]
            verdicts = KeyframeDatabase.finish_verify(T_dev, ok_dev, kept)
            self._book_loop_edges(kf_idx, p["pose"].astype(np.float32), list(zip(kept, verdicts)),
                                  reloc_edge=None)
        if self._cadence_due():
            self._optimize_online()

    def _cadence_due(self) -> bool:
        ev = self.config.optimize_every
        return bool(ev and len(self._keyframes) >= 2 and len(self._keyframes) % ev == 0 and self._loop_edges)

    def _post_frame(self, depth, res, defer_optimize=False, defer_booking=False):
        """Everything process() does after the VO step: relocalization,
        keyframe events (loop closure + graph edges), online optimization.

        defer_optimize: record that the optimize cadence fired
        (self._optimize_due) instead of running it (windowed booking).
        defer_booking: clean promotions enter the booking pipeline; every
        path that needs current state flushes it first."""
        precomputed = None
        odom_weight = None  # None -> from the span's failure count
        # A failure-streak re-seed means the held pose is stale: try to
        # relocalize now and, failing that, enter lost mode and retry.
        reseed_fail = res.is_new_keyframe and not res.success
        retry = self.lost and (
            res.is_new_keyframe or self._frame_count % max(self.config.reloc_retry_every, 1) == 0
        )
        if res.is_new_keyframe or reseed_fail or retry or self.lost:
            self.flush_pending()  # events see fully booked state
        else:
            self._advance_pending()
        reloc_edge = None
        if self.config.relocalize and self._keyframes and (reseed_fail or retry):
            pose, precomputed, reloc_edge = self._try_relocalize(depth)
            if pose is not None:
                self._vo.relocalize_to(pose)
                self.num_relocalizations += 1
                self.lost = False
                # A keyframe at the recovery point: its chain edge measures
                # held-stale drift (floored weight); the verified
                # registration becomes a loop edge to the matched keyframe.
                res = res._replace(pose=np.asarray(pose, np.float32), is_new_keyframe=True)
                odom_weight = self.config.reloc_odom_weight
            else:
                reloc_edge = None
                if reseed_fail:
                    self.lost = True
        if res.is_new_keyframe:
            if (defer_booking and res.success and precomputed is None and odom_weight is None
                    and reloc_edge is None):
                self._defer_keyframe(depth, res)
                return res
            self._on_keyframe(depth, res, precomputed=precomputed, odom_weight=odom_weight,
                              reloc_edge=reloc_edge)
            if self._cadence_due():
                if defer_optimize:
                    self._optimize_due = True
                else:
                    self._optimize_online()
        return res

    def _optimize_online(self) -> None:
        """Optimize the keyframe graph in-stream and left-multiply the latest
        keyframe's correction into the VO."""
        old_last = self._keyframes[-1].pose.astype(np.float64).copy()
        opt = self.optimize(pad=True)
        if opt is None or not np.isfinite(opt).all():
            return
        delta = opt[-1].astype(np.float64) @ np.linalg.inv(old_last)
        self._vo.apply_world_correction(delta.astype(np.float32))
        self._num_online_optimizations += 1

    def _try_relocalize(self, depth):
        """Robust global registration of the current frame against the most
        recent keyframes and the best place-recognition hits; returns
        (world_pose | None, (cloud, feats, desc), (kf_index, T_cur_to_kf) | None)."""
        cfg = self.config
        cloud, feats, desc = self._prepare(depth)
        n_recent = max(cfg.reloc_candidates - 1, 1)
        cands = [kf.index for kf in self._keyframes[-n_recent:]]
        cands.reverse()  # newest first: most likely overlap
        for cand_id, _sim in self._db.query(1 << 30, cloud, feats, top_k=cfg.reloc_candidates, desc=desc):
            if cand_id not in cands and len(cands) < cfg.reloc_candidates:
                cands.append(cand_id)
        verdicts = self._db.verify_batch(
            -1, cloud, feats, cands, noise_bound=cfg.loop_noise_bound, overlap_tau=cfg.loop_overlap_tau,
            min_overlap=cfg.loop_min_overlap, pad_to=max(3, cfg.reloc_candidates),
        )
        for kf_i, (T_cur_to_kf, ok) in zip(cands, verdicts):
            if ok:
                T = np.asarray(T_cur_to_kf)
                return self._keyframes[kf_i].pose @ T, (cloud, feats, desc), (kf_i, T)
        return None, (cloud, feats, desc), None

    def _prepare(self, depth):
        """(cloud, feats, descriptor) of the current frame."""
        return _fused_keyframe_prep(_device_frame(depth, self.device), **self._prep_kwargs(),
                                    **self._feature_kwargs())

    def _on_keyframe(self, depth, res, precomputed=None, odom_weight=None, reloc_edge=None) -> None:
        """Synchronous keyframe booking."""
        cfg = self.config
        kf_idx = len(self._keyframes)
        if odom_weight is None:
            # Each failed frame of the span held the pose while the camera
            # moved: discount the incoming odometry edge.
            span = getattr(res, "span_failures", None)
            if span is None:
                span = self._vo.last_span_failures
            odom_weight = max(0.02, 1.0 / (1.0 + span))
        if precomputed is not None:  # the relocalization attempt's prep
            cloud, feats, desc = precomputed
        else:
            cloud, feats, desc = self._prepare(depth)
        pose = np.asarray(res.pose, np.float64)
        kf = _Keyframe(
            index=kf_idx,
            frame_index=res.frame_index,
            pose=pose.astype(np.float32),
            cloud=cloud,
            feats=feats,
            odom_from_prev=(
                (np.linalg.inv(self._keyframes[-1].pose.astype(np.float64)) @ pose).astype(np.float32)
                if self._keyframes else None
            ),
            odom_weight=float(odom_weight),
            depth=self._host_meters(depth) if cfg.keep_depths else None,
        )
        # Query BEFORE adding (never match self).
        hits = self._db.query(kf_idx, cloud, feats, desc=desc)
        verdicts = self._db.verify_batch(
            kf_idx, cloud, feats, [c for c, _ in hits], noise_bound=cfg.loop_noise_bound,
            overlap_tau=cfg.loop_overlap_tau, min_overlap=cfg.loop_min_overlap, pad_to=3,
        )
        self._book_loop_edges(kf_idx, np.asarray(res.pose), list(zip([c for c, _ in hits], verdicts)), reloc_edge)
        self._db.add(kf_idx, cloud, feats)
        self._keyframes.append(kf)

    def _book_loop_edges(self, kf_idx, kf_pose, cand_verdicts, reloc_edge=None) -> None:
        """Gate + record accepted loop edges for keyframe kf_idx.
        cand_verdicts: [(cand_idx, (T_ab, ok)), ...]; kf_pose is the
        keyframe's EVENT-TIME world pose (the gate compares in the drift
        frame the measurement was made in)."""
        cfg = self.config
        added_pairs = set()
        for cand_idx, (T_ab, ok) in cand_verdicts:
            if ok:
                # T maps this keyframe's coordinates into the candidate's:
                # the edge (i=cand, j=this) measures T_i^-1 T_j = T.
                T_meas = np.asarray(T_ab)
                pred = np.linalg.inv(self._keyframes[cand_idx].pose) @ np.asarray(kf_pose)
                delta = _se3_log_np(np.linalg.inv(T_meas) @ pred)
                allowed = cfg.loop_odometry_gate + cfg.loop_drift_per_keyframe * abs(kf_idx - cand_idx)
                if np.linalg.norm(delta) > allowed:
                    continue
                self._loop_edges.append((cand_idx, kf_idx, T_meas, cfg.loop_weight))
                added_pairs.add((int(cand_idx), kf_idx))
                self._num_loop_closures += 1
        if reloc_edge is not None and (int(reloc_edge[0]), kf_idx) not in added_pairs:
            # The verified relocalization measurement, unless place
            # recognition already added the same (cand, this) edge.
            cand_idx, T_reloc = reloc_edge
            self._loop_edges.append((int(cand_idx), kf_idx, np.asarray(T_reloc, np.float32), cfg.loop_weight))
            self._num_loop_closures += 1

    def optimize(self, gn_iters: int = 10, cg_iters: int = 60, pad: bool = False):
        """Pose-graph optimization over the keyframes; returns the optimized
        keyframe poses (K, 4, 4) and adopts them when finite. The graph uses
        the odometry measured at insertion. pad: node and edge counts
        rounded up to powers of two with inert padding (weight-0 chain
        edges, (0, 0) self-edges), as the JAX package pads for its compiled
        programs: the same result."""
        self.flush_pending()
        if len(self._keyframes) < 2:
            return np.stack([k.pose for k in self._keyframes]) if self._keyframes else None
        K = len(self._keyframes)
        poses = np.stack([k.pose for k in self._keyframes]).astype(np.float32)
        odom = [k.odom_from_prev for k in self._keyframes[1:]]
        odom_w = [k.odom_weight for k in self._keyframes[1:]]
        loops = [(i, j, np.asarray(T, np.float32), w) for (i, j, T, w) in self._loop_edges]
        if pad:
            eye = np.eye(4, dtype=np.float32)
            n_pad = max(8, 1 << (K - 1).bit_length())
            if n_pad > K:
                poses = np.concatenate([poses, np.repeat(poses[-1][None], n_pad - K, axis=0)])
                odom = odom + [eye] * (n_pad - K)
                odom_w = odom_w + [0.0] * (n_pad - K)
            ne = max(len(loops), 1)
            e_pad = max(4, 1 << (ne - 1).bit_length())
            loops = loops + [(0, 0, eye, 0.0)] * (e_pad - len(loops))
        graph = pg.from_trajectory(poses, loop_edges=loops, odometry=odom, odometry_weights=odom_w,
                                   device=self.device)
        opt_poses, _cost = pg.optimize_pose_graph(graph, gn_iters=gn_iters, cg_iters=cg_iters)
        opt = opt_poses.cpu().numpy()[:K]  # the optimization's one read
        if not np.isfinite(opt).all():
            return opt  # caller decides; keyframe poses stay untouched
        for k, kf in enumerate(self._keyframes):
            kf.pose = opt[k]
        return opt

    def build_map(self, voxel_size: float = 0.05, capacity: int = 1 << 18):
        """World model from (optimized) keyframe poses + clouds."""
        from realsensetracker_tpu_torch.tracking import accumulator as acc_mod

        self.flush_pending()
        acc = acc_mod.init_map(capacity, self.device)
        for kf in self._keyframes:
            pose = torch.as_tensor(np.asarray(kf.pose, np.float32), device=self.device)
            acc = acc_mod.add_cloud(acc, pose, kf.cloud, voxel_size)
        return acc

    @property
    def world_map(self):
        """Sparse voxel world map (masked Cloud) at the CURRENT keyframe
        poses; call after optimize() for the loop-consistent model."""
        if not self._keyframes:
            return None
        return self.build_map().extract_cloud()

    def build_dense(self, voxel_size: float = 0.04, resolution: int = 128, margin: float = 0.3):
        """Re-fuse the kept keyframe depths into a TSDF volume at the current
        (post-optimization) keyframe poses: (TsdfVolume, TsdfConfig), or None
        without keyframes. The volume is auto-sized: its origin centres the
        world bounding box of the keyframe clouds (+ margin), and the voxel
        edge grows above ``voxel_size`` until the resolution^3 grid covers
        the box. Requires SlamConfig.keep_depths."""
        from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod

        self.flush_pending()
        if not self._keyframes:
            return None
        if any(kf.depth is None for kf in self._keyframes):
            raise ValueError(
                "dense re-fusion needs the keyframe depth frames: construct the tracker with "
                "SlamConfig(keep_depths=True)"
            )
        mins, maxs = [], []
        for kf in self._keyframes:
            pts = kf.cloud.points.cpu().numpy()[kf.cloud.mask.cpu().numpy()]
            if not len(pts):
                continue
            pose = np.asarray(kf.pose, np.float64)
            w = pts.astype(np.float64) @ pose[:3, :3].T + pose[:3, 3]
            mins.append(w.min(axis=0))
            maxs.append(w.max(axis=0))
        if not mins:
            return None
        lo = np.min(mins, axis=0) - margin
        hi = np.max(maxs, axis=0) + margin
        vs = max(float(voxel_size), float((hi - lo).max()) / resolution)
        center = (lo + hi) / 2
        half = resolution * vs / 2
        cfg = tsdf_mod.TsdfConfig(resolution=resolution, voxel_size=vs,
                                  origin=tuple(float(c - half) for c in center), trunc=max(3.0 * vs, 0.1))
        vol = tsdf_mod.init_volume(cfg, device=self.device)
        for kf in self._keyframes:
            depth = torch.as_tensor(np.asarray(kf.depth, np.float32), device=self.device)
            pose = torch.as_tensor(np.asarray(kf.pose, np.float32), device=self.device)
            tsdf_mod.integrate(vol, depth, pose, self.config.intrinsics, cfg)
        return vol, cfg

    def world_mesh(self, capacity: int = 131072, voxel_size: float = 0.04, resolution: int = 128,
                   margin: float = 0.3):
        """Loop-consistent dense surface as a TriangleMesh (build_dense +
        marching tetrahedra); None without keyframes, raises without
        keep_depths."""
        from realsensetracker_tpu_torch.mapping.mesh import extract_mesh

        out = self.build_dense(voxel_size=voxel_size, resolution=resolution, margin=margin)
        if out is None:
            return None
        vol, cfg = out
        return extract_mesh(vol, cfg, capacity)
