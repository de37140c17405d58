"""Submap atlas: unbounded dense mapping from fixed-shape TSDF volumes.

Port of realsensetracker_tpu/mapping/submaps.py. The atlas keeps
KinectFusion frame-to-model tracking (tracking/tsdf_tracker.py) inside the
newest submap and, when the camera or its view centre drifts past a spawn
radius, freezes the active volume (offloaded to pinned host memory) and
seeds a fresh one anchored at the current world pose, first trying to
re-enter an existing submap that covers the pose (registration-gated).
The world model is the union of rigidly placed fixed-shape volumes;
``optimize_atlas`` loop-closes them by registering their surfaces and
optimizing a pose graph over the anchors. Every submap shares one
TsdfConfig, so the whole atlas runs the per-frame kernels of one
TsdfTracker; the host does the spawn policy on the stats row it already
reads per frame.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod
from realsensetracker_tpu_torch.ops import cloud as cloud_mod
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


@dataclass(frozen=True)
class SubmapConfig:
    """Atlas policy knobs (the volume geometry lives in ``volume``)."""

    volume: tsdf_mod.TsdfConfig = tsdf_mod.TsdfConfig()
    spawn_radius: float = 0.0  # meters of camera/view-centre drift before a handover; 0 = auto (extent / 4)
    probe_depth: float = 0.0  # view-centre probe distance along the optical axis; 0 = auto (extent / 4)
    min_frames: int = 4  # frames a submap absorbs before the next spawn
    offload_finished: bool = True  # frozen volumes move to (pinned) host memory
    reactivate: bool = True  # on drift, first try to re-enter an existing submap covering the pose
    reactivate_min_inliers: float = 0.4  # inlier-fraction gate of the re-entry, relative to render coverage
    auto_slab: bool = True  # integrate_slab unset (0) -> 3V/4 for submap volumes (bounded local scenes)

    def radius(self) -> float:
        extent = self.volume.resolution * self.volume.voxel_size
        return self.spawn_radius or extent / 4.0

    def probe(self) -> float:
        extent = self.volume.resolution * self.volume.voxel_size
        return self.probe_depth or extent / 4.0


class Submap(NamedTuple):
    """An atlas entry. The active submap's entry is a stale placeholder (its
    live volume and anchor sit in the inner tracker), refreshed whenever
    the tracker hands over to another submap."""

    world_from_submap: np.ndarray  # (4, 4) f32, host
    volume: object  # TsdfVolume (host tensors when offloaded)
    frames: int  # frames fused into it (accumulates across activations)


def pose_drifted(local_pose: np.ndarray, radius: float, probe: float) -> bool:
    """Drift predicate of the atlas (and, later, the serving slots): the
    camera position or the mid-range view centre moved more than
    ``radius`` from where the submap was seeded (identity / (0, 0, probe))."""
    t = local_pose[:3, 3]
    if float(np.linalg.norm(t)) > radius:
        return True
    view = local_pose[:3, :3] @ np.array([0.0, 0.0, probe], np.float32) + t
    return float(np.linalg.norm(view - np.array([0.0, 0.0, probe]))) > radius


def _to_host(vol: tsdf_mod.TsdfVolume) -> tsdf_mod.TsdfVolume:
    """A host copy of a volume: pinned memory for a card's volume (the
    upload back is then a plain DMA), an independent copy for a CPU one."""
    def host(t):
        if t is None:
            return None
        if t.is_cuda:
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t)
            return out
        return t.clone()

    return tsdf_mod.TsdfVolume(*(host(a) for a in vol))


def _to_device(vol: tsdf_mod.TsdfVolume, device) -> tsdf_mod.TsdfVolume:
    return tsdf_mod.TsdfVolume(*(None if a is None else a.to(device) for a in vol))


class SubmapTsdfTracker:
    """TsdfTracker facade over a growing atlas of fixed-shape submaps.

    Same streaming surface as tracking.tsdf_tracker.TsdfTracker (process,
    process_window, pose, trajectory, world_map, world_mesh, ...), but poses
    are world poses (anchor-composed) and the world model is the union of
    all submaps."""

    def __init__(
        self,
        intr: camera.Intrinsics,
        config: SubmapConfig = SubmapConfig(),
        icp: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
        min_inlier_fraction: float = 0.2,
        surface_capacity: int = 65536,
        use_color: bool = False,
        photometric: object = None,  # RgbdIcpConfig | None
        photometric_ref: str = "frame",
        track_scale_fallback: float = 0.0,
        device: str | torch.device = device_mod.DEFAULT,
    ):
        from realsensetracker_tpu_torch.tracking.tsdf_tracker import TsdfTracker

        self.intr = intr
        self.device = device_mod.resolve(device)
        if config.auto_slab and int(config.volume.integrate_slab) == 0:
            config = replace(config, volume=config.volume._replace(integrate_slab=3 * config.volume.resolution // 4))
        self.config = config
        self.surface_capacity = surface_capacity
        self.use_color = use_color
        # The inner tracker runs in the ACTIVE submap's frame; its own
        # trajectory is ignored (ours is the world one).
        self._t = TsdfTracker(
            intr, volume=config.volume, icp=icp, min_inlier_fraction=min_inlier_fraction,
            surface_capacity=surface_capacity, use_color=use_color, photometric=photometric,
            photometric_ref=photometric_ref, track_scale_fallback=track_scale_fallback, device=self.device,
        )
        self._anchor = np.eye(4, dtype=np.float32)  # world_from_submap
        self._frames_in_active = 0
        self._active_id = -1  # -1 before the seed frame
        self._subs: list[Submap] = []
        # (traj_start, submap_id) handover log: trajectory index `start`
        # onward was tracked in `submap_id` (until the next entry).
        self._span_log: list[tuple[int, int]] = []
        self.trajectory = Trajectory()
        self._pose_np = None

    # -- policy ---------------------------------------------------------------

    def _drifted(self, local_pose: np.ndarray) -> bool:
        return pose_drifted(local_pose, self.config.radius(), self.config.probe())

    def _freeze_active(self) -> None:
        vol = self._t.tsdf_volume
        old = self._subs[self._active_id]
        self._subs[self._active_id] = Submap(
            world_from_submap=self._anchor,
            volume=_to_host(vol) if self.config.offload_finished else vol,
            frames=old.frames + self._frames_in_active,
        )

    def _device_depth(self, depth) -> torch.Tensor:
        t = depth if isinstance(depth, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(depth))
        return t.to(device=self.device, dtype=torch.float32).contiguous()

    def _try_reactivate(self, depth, color, world_pose: np.ndarray):
        """Re-enter the nearest existing submap covering the current pose,
        verified by registering the live frame onto its render at the
        predicted local pose; on success the correction snaps the world pose
        onto the old map. Returns the corrected world pose, or None."""
        best = None
        for k, s in enumerate(self._subs):
            if k == self._active_id:
                continue
            local = np.linalg.inv(s.world_from_submap.astype(np.float64)) @ world_pose
            if self._drifted(local.astype(np.float32)):
                continue
            d = float(np.linalg.norm(local[:3, 3]))
            if best is None or d < best[0]:
                best = (d, k, local.astype(np.float32))
        if best is None:
            return None
        _, k, local = best
        vol_k = _to_device(self._subs[k].volume, self.device)
        local_t = torch.as_tensor(local, device=self.device)
        render = tsdf_mod.render_model_depth(vol_k, local_t, self.intr, self.config.volume)
        depth_t = self._device_depth(depth)
        res = projective.register_depth_pair(depth_t[None], render[None], self.intr, self._t.icp)
        # A re-entered submap covers only part of the frustum, so the inlier
        # fraction is gated against the render's coverage (its ceiling) plus
        # a floor on coverage itself.
        cov = float((render > 0).to(torch.float32).mean())
        inl = float(res.inlier_fraction[0])
        T = res.transform[0]
        ok = bool(torch.isfinite(T).all()) and cov >= 0.2 and inl >= self.config.reactivate_min_inliers * cov
        if not ok:
            return None
        local2_t = se3.orthonormalize(se3.compose(local_t, T))
        local2 = local2_t.cpu().numpy().astype(np.float32)
        self._freeze_active()
        self._active_id = k
        self._anchor = self._subs[k].world_from_submap
        # Fuse the live frame into the re-entered volume at the snapped pose.
        color_t = self._t._color_frame(color)
        self._t._vol = tsdf_mod.integrate(vol_k, depth_t, local2_t, self.intr, self.config.volume, color=color_t)
        self._t._pose = local2_t
        self._t._pose_np = local2
        # Re-entry is a fresh episode for the inner tracker's cadence.
        self._t._fuse_counter = 1
        self._t._track_cfg = self._t.volume
        self._t._low_cov_streak = 0
        if self._t.photometric is not None:
            from realsensetracker_tpu_torch.tracking.tsdf_tracker import _luma

            self._t._prev_gray = _luma(color_t)
        self._frames_in_active = 1
        # This frame was re-measured against submap k: its span starts here.
        self._span_log.append((len(self.trajectory) - 1, k))
        return (self._anchor @ local2).astype(np.float32)

    def _spawn_new(self, depth, color, world_pose: np.ndarray) -> None:
        vol = self._t.tsdf_volume
        # The frozen model rendered at the handover pose is a depth frame in
        # the new submap's camera frame: fusing it hands over the old
        # submap's denoised surface.
        handover = tsdf_mod.render_model_depth(vol, self._t._pose, self.intr, self.config.volume)
        self._freeze_active()
        self._subs.append(Submap(world_from_submap=np.asarray(world_pose, np.float32).copy(), volume=None, frames=0))
        self._active_id = len(self._subs) - 1
        # The handover frame was tracked in (and appended under) the old
        # submap; the new span starts at the next trajectory entry.
        self._span_log.append((len(self.trajectory), self._active_id))
        self._anchor = np.asarray(world_pose, np.float32).copy()
        self._t.reseed(self._device_depth(depth), color=color, model_depth=handover)
        self._frames_in_active = 1

    def _maybe_handover(self, depth, color, world_pose: np.ndarray):
        """After a successful frame: the snapped world pose if a re-entry
        happened, else None (whether or not a new submap spawned)."""
        if self._frames_in_active < self.config.min_frames:
            return None
        if not self._drifted(np.asarray(self._t.pose)):
            return None
        if self.config.reactivate:
            corrected = self._try_reactivate(depth, color, world_pose)
            if corrected is not None:
                return corrected
        self._spawn_new(depth, color, world_pose)
        return None

    # -- streaming ---------------------------------------------------------------

    def _seed_bookkeeping(self) -> None:
        if self._active_id < 0:
            self._subs.append(Submap(world_from_submap=self._anchor, volume=None, frames=0))
            self._active_id = 0
            self._span_log.append((len(self.trajectory), 0))

    def process(self, depth, timestamp: float | None = None, color=None):
        first = self._t.tsdf_volume is None
        r = self._t.process(depth, timestamp, color=color)
        if first:
            self._seed_bookkeeping()
        world_pose = (self._anchor @ r.pose).astype(np.float32)
        self._pose_np = world_pose
        self._frames_in_active += 1
        ts = timestamp if timestamp is not None else float(r.frame_index)
        self.trajectory.append(ts, world_pose)
        if r.success:
            corrected = self._maybe_handover(depth, color, world_pose)
            if corrected is not None:  # a re-entry snapped this frame
                world_pose = corrected
                self._pose_np = corrected
                self.trajectory.poses[-1] = np.asarray(corrected, np.float64)
        return r._replace(pose=world_pose)

    def process_window(self, depths, timestamps=None, window: int = 8, colors=None):
        """Windowed variant: frames go through TsdfTracker.process_window in
        chunks of ``window``; the spawn check runs between chunks, so a
        handover can land up to window - 1 frames late."""
        n = len(depths)
        if timestamps is None:
            timestamps = [None] * n
        results = []
        i = 0
        while i < n:
            first = self._t.tsdf_volume is None
            chunk = depths[i:i + window]
            cts = timestamps[i:i + window]
            cols = colors[i:i + window] if colors is not None else None
            rs = self._t.process_window(chunk, cts, window=window, colors=cols)
            if first:
                self._seed_bookkeeping()
            for j, r in enumerate(rs):
                world_pose = (self._anchor @ r.pose).astype(np.float32)
                self._pose_np = world_pose
                self._frames_in_active += 1
                ts = cts[j] if cts[j] is not None else float(r.frame_index)
                self.trajectory.append(ts, world_pose)
                results.append(r._replace(pose=world_pose))
            if results and results[-1].success:
                corrected = self._maybe_handover(chunk[-1], cols[-1] if cols is not None else None, results[-1].pose)
                if corrected is not None:
                    self._pose_np = corrected
                    self.trajectory.poses[-1] = np.asarray(corrected, np.float64)
                    results[-1] = results[-1]._replace(pose=corrected)
            i += len(rs)
        return results

    # -- state -------------------------------------------------------------------

    @property
    def pose(self):
        return self._pose_np

    @property
    def tsdf_volume(self):
        """The active submap's device volume (None before the seed)."""
        return self._t.tsdf_volume

    @property
    def anchor(self) -> np.ndarray:
        """world_from_submap of the active submap."""
        return self._anchor

    @property
    def num_submaps(self) -> int:
        return len(self._subs)

    @property
    def active_id(self) -> int:
        """Index of the submap currently tracked in (-1 before the seed)."""
        return self._active_id

    @property
    def submaps(self) -> list:
        """All atlas entries in id order, the active one's live anchor and
        volume in place of its placeholder."""
        out = []
        for i, s in enumerate(self._subs):
            if i == self._active_id:
                out.append(s._replace(world_from_submap=self._anchor, volume=self._t.tsdf_volume,
                                      frames=s.frames + self._frames_in_active))
            else:
                out.append(s)
        return out

    @property
    def finished(self) -> list:
        """Frozen (non-active) atlas entries, id order."""
        return [s for i, s in enumerate(self._subs) if i != self._active_id]

    def _all_volumes(self):
        """(world_from_submap, device TsdfVolume) of every submap in id order."""
        out = []
        for i, s in enumerate(self._subs):
            if i == self._active_id:
                out.append((self._anchor, self._t.tsdf_volume))
            else:
                out.append((s.world_from_submap, _to_device(s.volume, self.device)))
        return out

    def _anchor_t(self, anchor: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(anchor, np.float32), device=self.device)

    # -- world-model extraction ----------------------------------------------------

    def _union(self, extract):
        """Per-submap extraction, moved into the world frame and concatenated:
        extract(vol) -> (Cloud, extra (C, 3) | None, rotate_extra)."""
        vols = self._all_volumes()
        if not vols:
            return None
        pts, masks, extras = [], [], []
        for anchor, vol in vols:
            c, extra, rotate = extract(vol)
            a = self._anchor_t(anchor)
            pts.append(torch.matmul(c.points, a[:3, :3].T) + a[:3, 3])
            masks.append(c.mask)
            if extra is not None:
                extras.append(torch.matmul(extra, a[:3, :3].T) if rotate else extra)
        cloud = cloud_mod.Cloud(points=torch.cat(pts), mask=torch.cat(masks))
        return cloud, (torch.cat(extras) if extras else None)

    @property
    def world_map(self):
        """Union of all submap zero-level surfaces as one masked Cloud
        (surface_capacity points per submap, world frame)."""
        out = self._union(lambda vol: (tsdf_mod.extract_surface(vol, self.config.volume, self.surface_capacity),
                                       None, False))
        return None if out is None else out[0]

    @property
    def world_map_oriented(self):
        """(Cloud, normals): the union surface with TSDF-gradient normals
        rotated into the world frame."""
        return self._union(lambda vol: (*tsdf_mod.extract_surface_oriented(vol, self.config.volume,
                                                                          self.surface_capacity), True))

    @property
    def world_map_colored(self):
        """(Cloud, colors) union; None unless use_color."""
        if not self.use_color:
            return None
        return self._union(lambda vol: (*tsdf_mod.extract_surface_colored(vol, self.config.volume,
                                                                         self.surface_capacity), False))

    def world_mesh(self, capacity: int = 131072):
        """Union triangle mesh: each submap contributes up to
        capacity / num_submaps triangles (floor 4096), in the world frame."""
        from realsensetracker_tpu_torch.mapping.mesh import TriangleMesh, extract_mesh

        vols = self._all_volumes()
        if not vols:
            return None
        per = max(4096, capacity // len(vols))
        verts, masks, cols = [], [], []
        for anchor, vol in vols:
            m = extract_mesh(vol, self.config.volume, per, with_color=self.use_color)
            a = self._anchor_t(anchor)
            verts.append(torch.matmul(m.vertices, a[:3, :3].T) + a[:3, 3])
            masks.append(m.mask)
            if m.colors is not None:
                cols.append(m.colors)
        return TriangleMesh(vertices=torch.cat(verts), mask=torch.cat(masks),
                            colors=torch.cat(cols) if cols else None)


# -- atlas-level loop closure + pose-graph optimization -----------------------------


def _verify_submap_pairs(surfs, feats, pairs, *, noise_bound, overlap_tau, min_overlap, refine_iters,
                         mesh=None, mesh_axis: str = "data"):
    """Geometric verification of candidate submap pairs (the keyframe
    loop-closure recipe): robust global registration of surface j onto
    surface i, symmetric-overlap acceptance, and an ICP refinement kept only
    when it does not lose overlap. Returns (T (P, 4, 4) i_from_j, ok (P,),
    overlap (P,)) on the device; JAX vmaps the same per-pair function over
    a padded pair axis.

    With ``mesh`` the pair axis pads as JAX's does (a power of two, at
    least 4, then a multiple of the mesh's device count) and splits over
    ``mesh_axis``: each rank verifies its block (the surfaces are
    replicated: every rank passes the same), the padding rows stay inert
    (identity, not ok, overlap 0) without being verified, and one
    all-gather returns every row to every rank."""
    if mesh is None:
        return _verify_pairs(surfs, feats, pairs, noise_bound, overlap_tau, min_overlap, refine_iters)
    from realsensetracker_tpu_torch.parallel import mesh as mesh_mod

    n_pairs = len(pairs)
    cap = max(4, 1 << (n_pairs - 1).bit_length())
    n_dev = mesh.size()
    cap = max(cap, n_dev)
    if cap % n_dev:
        cap = ((cap + n_dev - 1) // n_dev) * n_dev
    mine = mesh_mod.block(cap, mesh, mesh_axis, "pair axis")
    real = [pairs[k] for k in range(mine.start, min(mine.stop, n_pairs))]
    dev = mesh_mod.mesh_device(mesh)
    rows = torch.zeros((mine.stop - mine.start, 18), dtype=torch.float32, device=dev)
    rows[:, :16] = torch.eye(4, dtype=torch.float32, device=dev).reshape(16)
    if real:
        T, ok, ov = _verify_pairs(surfs, feats, real, noise_bound, overlap_tau, min_overlap, refine_iters)
        rows[: len(real)] = torch.cat([T.reshape(-1, 16), ok[:, None].to(torch.float32), ov[:, None]], dim=1).to(dev)
    rows = mesh_mod.all_gather(rows, mesh, mesh_axis)[:n_pairs]
    return rows[:, :16].reshape(-1, 4, 4), rows[:, 16] > 0.5, rows[:, 17]


def _verify_pairs(surfs, feats, pairs, noise_bound, overlap_tau, min_overlap, refine_iters):
    """The verification of each of ``pairs`` in turn, on one device."""
    from realsensetracker_tpu_torch.align import icp as icp_mod
    from realsensetracker_tpu_torch.align import robust_global

    Ts, oks, ovs = [], [], []
    for i, j in pairs:
        src, dst = surfs[j], surfs[i]
        res = robust_global.register_robust(src, dst, feats[j], feats[i], noise_bound)
        fwd, bwd = robust_global.symmetric_overlap(res.transform, src, dst, overlap_tau)
        ov = torch.minimum(fwd, bwd)
        ok = res.valid & (ov >= min_overlap)
        ref = icp_mod.align_icp(src, dst, max_iter=refine_iters, init_transform=res.transform)
        f2, b2 = robust_global.symmetric_overlap(ref.transform, src, dst, overlap_tau)
        use_ref = torch.isfinite(ref.transform).all() & (torch.minimum(f2, b2) >= ov)
        Ts.append(torch.where(use_ref, ref.transform, res.transform))
        oks.append(ok)
        ovs.append(ov)
    return torch.stack(Ts), torch.stack(oks), torch.stack(ovs)


def _occupancy_signature(vol, cfg: tsdf_mod.TsdfConfig, pool: int = 8) -> np.ndarray:
    """Coarse (G, G, G) near-surface occupancy mass of a volume, host numpy:
    the fraction of each pool^3 block whose voxels are observed and within
    half the truncation band of the surface. Reads the host copy of an
    offloaded volume: no upload, no surface extraction."""
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # noqa: E731
    w = host(vol.weight) > 0
    t = np.abs(host(vol.tsdf)) < 0.5
    v = w.shape[0]
    g = max(v // pool, 1)
    trim = g * pool
    m = (w & t)[:trim, :trim, :trim]
    return m.reshape(g, pool, g, pool, g, pool).mean(axis=(1, 3, 5))


def _pair_overlap_score(ci: np.ndarray, cj: np.ndarray, T_ji: np.ndarray, cfg: tsdf_mod.TsdfConfig,
                        pool: int = 8) -> float:
    """Anchor-warped occupancy overlap of two submaps in [0, 1]:
    sum(min(Ci, Cj o T_ji)) / min(mass_i, mass_j), submap i's coarse cell
    centres warped into j's frame by the relative anchor transform."""
    g = ci.shape[0]
    cell = cfg.voxel_size * pool
    o = np.asarray(cfg.origin, np.float64)
    idx = np.stack(np.meshgrid(*([np.arange(g)] * 3), indexing="ij"), -1).reshape(-1, 3)
    centers = o + (idx + 0.5) * cell
    T = np.asarray(T_ji, np.float64)
    p = centers @ T[:3, :3].T + T[:3, 3]
    jidx = np.floor((p - o) / cell).astype(int)
    inside = np.all((jidx >= 0) & (jidx < g), axis=1)
    cj_at = np.zeros(len(idx))
    cj_at[inside] = cj[tuple(jidx[inside].T)]
    ci_f = ci.ravel()
    inter = float(np.minimum(ci_f, cj_at).sum())
    return inter / (min(float(ci_f.sum()), float(cj.sum())) + 1e-9)


def optimize_atlas(
    tracker: SubmapTsdfTracker,
    *,
    surface_capacity: int = 2048,
    min_separation: int = 2,
    gate: float = 0.0,  # anchor-distance candidate gate; 0 = auto (extent)
    occupancy_gate: float = 0.25,  # warped-occupancy overlap mid-gate; 0 disables
    occupancy_pool: int = 8,  # coarse-cell edge in voxels
    noise_bound: float = 0.0,  # 0 = auto (4 voxels)
    overlap_tau: float = 0.0,  # 0 = auto (2 voxels)
    min_overlap: float = 0.7,
    loop_weight: float = 0.25,
    refine_iters: int = 16,
    feature_radius: float = 0.0,  # 0 = auto (6 voxels)
    max_neighbors: int = 64,
    gn_iters: int = 10,
    cg_iters: int = 50,
    mesh=None,
    mesh_axis: str = "data",
) -> int:
    """Loop-close and optimize the submap atlas in place; returns the number
    of accepted loop edges (0: nothing changed).

    Non-adjacent submaps whose anchors lie within ``gate`` and whose warped
    occupancy overlaps are verified against each other (FPFH from the
    TSDF-gradient normals, then the keyframe loop-closure recipe); accepted
    transforms become loop edges of a pose graph over the anchors
    (optimize/pose_graph.py). Every submap is rigid, so the optimized
    anchors make the whole dense model consistent at once, and each
    submap's trajectory span is rewritten by its anchor correction.

    ``mesh`` (a parallel.mesh DeviceMesh) shards the pair verification over
    its ``mesh_axis`` ranks (_verify_submap_pairs); every rank calls
    optimize_atlas on its own copy of the same atlas and ends with the same
    anchors."""
    from realsensetracker_tpu_torch.ops import fpfh as fpfh_mod
    from realsensetracker_tpu_torch.optimize import pose_graph as pg

    cfgv = tracker.config.volume
    voxel = cfgv.voxel_size
    extent = cfgv.resolution * voxel
    gate = gate or extent
    noise_bound = noise_bound or 4 * voxel
    overlap_tau = overlap_tau or 2 * voxel
    feature_radius = feature_radius or 6 * voxel

    subs = tracker.submaps
    k = len(subs)
    if k < min_separation + 1:
        return 0
    anchors = np.stack([s.world_from_submap for s in subs]).astype(np.float32)
    pairs = [(i, j) for i in range(k) for j in range(i + min_separation, k)
             if np.linalg.norm(anchors[i][:3, 3] - anchors[j][:3, 3]) < gate]
    if not pairs:
        return 0

    if occupancy_gate > 0:
        sigs = {idx: _occupancy_signature(subs[idx].volume, cfgv, occupancy_pool)
                for idx in sorted({i for p in pairs for i in p})}
        kept = []
        for i, j in pairs:
            T_ji = np.linalg.inv(anchors[j].astype(np.float64)) @ anchors[i].astype(np.float64)
            if _pair_overlap_score(sigs[i], sigs[j], T_ji, cfgv, occupancy_pool) >= occupancy_gate:
                kept.append((i, j))
        pairs = kept
        if not pairs:
            return 0

    # Upload, extract and describe only the submaps of surviving pairs.
    active = sorted({idx for p in pairs for idx in p})
    slot = {idx: s for s, idx in enumerate(active)}
    surfs, feats = [], []
    for idx in active:
        c, n = tsdf_mod.extract_surface_oriented(_to_device(subs[idx].volume, tracker.device), cfgv,
                                                 surface_capacity)
        surfs.append(c)
        feats.append(fpfh_mod.compute_fpfh_from_normals(c, n, feature_radius, max_neighbors))

    T, ok, ov = _verify_submap_pairs(
        surfs, feats, [(slot[i], slot[j]) for i, j in pairs], noise_bound=noise_bound,
        overlap_tau=overlap_tau, min_overlap=min_overlap, refine_iters=refine_iters, mesh=mesh, mesh_axis=mesh_axis,
    )
    T, ok, ov = T.cpu().numpy(), ok.cpu().numpy(), ov.cpu().numpy()
    # Confidence-weighted edges: the edge error falls sharply with overlap.
    loop_edges = [(i, j, T[c], loop_weight * float(ov[c])) for c, (i, j) in enumerate(pairs) if ok[c]]
    if not loop_edges:
        return 0

    graph = pg.from_trajectory(torch.as_tensor(anchors, device=tracker.device), loop_edges=loop_edges)
    new_anchors, _cost = pg.optimize_pose_graph(graph, gn_iters=gn_iters, cg_iters=cg_iters)
    new_anchors = new_anchors.cpu().numpy().astype(np.float32)

    # Rigid per-submap corrections: anchors, then every trajectory span
    # tracked in that submap (handovers and re-entries alike).
    corrs = [new_anchors[idx] @ np.linalg.inv(anchors[idx].astype(np.float64)) for idx in range(k)]
    log = tracker._span_log
    for e, (start, sid) in enumerate(log):
        end = log[e + 1][0] if e + 1 < len(log) else len(tracker.trajectory)
        for t in range(start, end):
            tracker.trajectory.poses[t] = corrs[sid] @ tracker.trajectory.poses[t]
    for idx in range(k):
        if idx == tracker._active_id:
            tracker._anchor = new_anchors[idx]
        else:
            tracker._subs[idx] = tracker._subs[idx]._replace(world_from_submap=new_anchors[idx])
    if tracker.trajectory.poses:
        tracker._pose_np = np.asarray(tracker.trajectory.poses[-1], np.float32)
    return len(loop_edges)
