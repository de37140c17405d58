"""Multi-stream tracking: S concurrent frame streams advanced together.

Port of realsensetracker_tpu/parallel/streams.py (BASELINE config 5, "8
concurrent streams at 30 FPS with live pose output"). Per-stream state
(pose + reference pyramid) lives on the device with the stream axis S as
the batch axis of the port's batched functions, so one step registers
every stream's new frame against its own reference in ONE batched
registration: on the card one downsample launch and one level-kernel
launch per level build the S new pyramids, and one gn_round launch per
association round registers all S pairs. Pose and reference update only
where tracking succeeded.

Where JAX scanned a window with ``lax.scan``, a Python loop runs over the
window with the state on the device and no host sync inside it. Integer
(raw u16) frames convert to meters on the device
(ops/pyramid.depth_to_meters).

The masked steps (``step_streams_masked`` and its RGB-D and dense
variants) serve the batching executor (api/batching.py): only ``active``
slots advance, ``seed`` slots restart at identity, and each returns one
packed stats row per slot -- one device-to-host copy per dispatch.

The dense slots hold S volumes as (S, V, V, V) planes; each slot renders
through kernels/tsdf.march (S launches per step), and all S integrate in
one mapping/tsdf.integrate_slots call (the integrate kernel's slot axis:
three launches per step, the tile map, the cull and the update). The
volumes update IN PLACE, gated on the device: clone the planes to keep an
old state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.align import rgbd as rgbd_mod
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod
from realsensetracker_tpu_torch.ops.pyramid import PyramidLevel, build_pyramid, depth_to_meters
from realsensetracker_tpu_torch.tracking.tsdf_tracker import _track_views
from realsensetracker_tpu_torch.utils.tracing import span


class StreamState(NamedTuple):
    poses: torch.Tensor  # (S, 4, 4) world_from_camera
    ref_levels: tuple  # PyramidLevels with B = S (reference frames), fine -> coarse
    initialized: torch.Tensor  # (S,) bool
    frame_count: torch.Tensor  # (S,) int32


class StreamStepResult(NamedTuple):
    poses: torch.Tensor  # (S, 4, 4)
    success: torch.Tensor  # (S,)
    rmse: torch.Tensor  # (S,)
    inlier_fraction: torch.Tensor  # (S,)


def _eye(s: int, device) -> torch.Tensor:
    return se3.identity(device=device).expand(s, 4, 4).contiguous()


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-slot (S,) mask shaped to broadcast against ``like`` (S, ...)."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _select_levels(mask, new, old) -> tuple:
    """Per slot, the new PyramidLevels where ``mask`` holds, else the old."""
    return tuple(
        PyramidLevel(*(torch.where(_bcast(mask, a), a, b) for a, b in zip(n, o)))
        for n, o in zip(new, old)
    )


def _build_levels(depths, intr, cfg):
    """Plane-table pyramids of a (S, H, W) meters batch for ``cfg`` fitted to
    the frame size: (levels, intrs), fine -> coarse."""
    cfg = projective.fit_levels(cfg, *depths.shape[-2:])
    levels, intrs = build_pyramid(depths, intr, len(cfg.iters), cfg.min_depth, cfg.max_depth)
    return tuple(levels), tuple(intrs)


def _flag(x, s: int, device) -> torch.Tensor:
    """A per-slot bool mask as an (S,) tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.bool, device=device).reshape(s)


def init_streams(
    first_depths: torch.Tensor,  # (S, H, W)
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    num_streams: int | None = None,
    depth_scale: float = 1.0,  # meters per unit for INTEGER frames
) -> StreamState:
    """Seed S streams with their first frames (identity poses)."""
    first_depths = depth_to_meters(first_depths, depth_scale)
    s = first_depths.shape[0] if num_streams is None else num_streams
    dev = first_depths.device
    levels, _ = _build_levels(first_depths, intr, cfg)
    return StreamState(
        poses=_eye(s, dev),
        ref_levels=levels,
        initialized=torch.ones(s, dtype=torch.bool, device=dev),
        frame_count=torch.ones(s, dtype=torch.int32, device=dev),
    )


def _register_all(ref_levels, depths, intr, cfg, min_inlier_fraction):
    """Build the new pyramids and register every slot against its reference
    in one batched registration. Shared by the always-on and the masked
    steps. Returns (new_levels, icp_result, ok) with ok = finite transform
    & inlier gate."""
    cfg = projective.fit_levels(cfg, *depths.shape[-2:])
    new_levels, intrs = _build_levels(depths, intr, cfg)
    res = projective.projective_icp(new_levels, ref_levels, intrs, cfg=cfg)
    finite = torch.isfinite(res.transform).all(-1).all(-1)
    ok = finite & (res.inlier_fraction >= min_inlier_fraction)
    return new_levels, res, ok


def _step_impl(state, depths, intr, cfg, min_inlier_fraction):
    new_levels, res, success = _register_all(state.ref_levels, depths, intr, cfg, min_inlier_fraction)
    new_pose = se3.orthonormalize(se3.compose(state.poses, res.transform))
    poses = torch.where(success[:, None, None], new_pose, state.poses)
    # Failure semantics (ref rs_replay_app.cpp:266-273): keep the old
    # reference frame and pose where registration failed.
    ref_levels = _select_levels(success, new_levels, state.ref_levels)
    new_state = StreamState(poses, ref_levels, state.initialized, state.frame_count + 1)
    return new_state, StreamStepResult(poses, success, res.rmse, res.inlier_fraction)


def step_streams(
    state: StreamState,
    depths: torch.Tensor,  # (S, H, W) one new frame per stream
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[StreamState, StreamStepResult]:
    """Advance every stream by one frame in one batched step."""
    return _step_impl(state, depth_to_meters(depths, depth_scale), intr, cfg, min_inlier_fraction)


def _stack_results(seq) -> StreamStepResult:
    return StreamStepResult(*(torch.stack(x, dim=1) for x in zip(*seq)))


def step_streams_window(
    state: StreamState,
    depths: torch.Tensor,  # (S, W, H, Wd): W new frames per stream
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[StreamState, StreamStepResult]:
    """Advance every stream by W frames: W step_streams in a loop, the
    state on the device. Per-frame results come back as (S, W, ...)."""
    seq = []
    for j in range(depths.shape[1]):
        state, res = _step_impl(state, depth_to_meters(depths[:, j], depth_scale), intr, cfg, min_inlier_fraction)
        seq.append(res)
    return state, _stack_results(seq)


def blank_streams(
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    num_streams: int = 8,
    device=device_mod.DEFAULT,
) -> StreamState:
    """Uninitialized S-slot state (all slots inactive, identity poses).

    Slots come alive one at a time through ``step_streams_masked``'s
    ``seed`` mask: the serving executor (api/batching.py) allocates one
    slot per session as sessions connect."""
    dev = device_mod.resolve(device)
    depths = torch.zeros((num_streams, int(intr.height), int(intr.width)), dtype=torch.float32, device=dev)
    levels, _ = _build_levels(depths, intr, cfg)
    return StreamState(
        poses=_eye(num_streams, dev),
        ref_levels=levels,
        initialized=torch.zeros(num_streams, dtype=torch.bool, device=dev),
        frame_count=torch.zeros(num_streams, dtype=torch.int32, device=dev),
    )


# Packed per-slot stats row of step_streams_masked: pose (16) | relative
# (16) | success | rmse | inlier_fraction. One (S, 35) tensor = ONE
# device-to-host copy per dispatch.
MASKED_STATS_WIDTH = 35


def _masked_finish(state, transform, ok, active, seed, rmse, inlier, extra_cols):
    """Shared masking/pose/stats core of every masked step (depth-only,
    RGB-D and dense, single and windowed). ``extra_cols`` are (S,) columns
    packed between rmse and inlier (RGB-D photo_rmse).

    Returns (poses, initialized, frame_count, take_new, stats): take_new is
    the per-slot mask of slots whose reference takes the new frame (seeded
    or tracked successfully)."""
    seeding = active & seed
    tracking = active & ~seed
    success = tracking & ok

    s = state.poses.shape[0]
    eye = _eye(s, state.poses.device)
    new_pose = se3.orthonormalize(se3.compose(state.poses, transform))
    poses = torch.where(success[:, None, None], new_pose, state.poses)
    poses = torch.where(seeding[:, None, None], eye, poses)
    take_new = success | seeding

    f32 = torch.float32
    relative = torch.where(seeding[:, None, None], eye, transform)
    cols = [torch.where(seeding, 0.0, rmse.to(f32))]
    cols += [torch.where(seeding, 0.0, e.to(f32)) for e in extra_cols]
    cols.append(torch.where(seeding, 1.0, inlier.to(f32)))
    stats = torch.cat(
        [poses.reshape(s, 16).to(f32), relative.reshape(s, 16).to(f32), take_new[:, None].to(f32)]
        + [c[:, None] for c in cols],
        dim=1,
    )
    return poses, state.initialized | seeding, state.frame_count + active.to(torch.int32), take_new, stats


def _masked_impl(state, depths, active, seed, intr, cfg, min_inlier_fraction):
    s, dev = state.poses.shape[0], state.poses.device
    active, seed = _flag(active, s, dev), _flag(seed, s, dev)
    new_levels, res, ok = _register_all(state.ref_levels, depths, intr, cfg, min_inlier_fraction)
    poses, initialized, count, take_new, stats = _masked_finish(
        state, res.transform, ok, active, seed, res.rmse, res.inlier_fraction, []
    )
    ref_levels = _select_levels(take_new, new_levels, state.ref_levels)
    return StreamState(poses, ref_levels, initialized, count), stats


def step_streams_masked(
    state: StreamState,
    depths: torch.Tensor,  # (S, H, W) one new frame per slot
    active,  # (S,) bool: slots with a request this round
    seed,  # (S,) bool: active slot's FIRST frame (re)seeds it
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[StreamState, torch.Tensor]:
    """Advance only the ``active`` slots; ``seed`` slots take the new frame
    as their reference at identity pose (the per-stream init branch,
    rs_replay_app.cpp:236-240). Inactive slots' pose, reference and
    frame_count are untouched, so one step serves ANY subset of sessions.

    Returns (new_state, stats (S, 35)); see MASKED_STATS_WIDTH for the row
    layout. Rows of inactive slots report their held pose with
    success=False."""
    return _masked_impl(state, depth_to_meters(depths, depth_scale), active, seed, intr, cfg, min_inlier_fraction)


def _window_flags(active, seed, s, w, device):
    return (torch.as_tensor(active, dtype=torch.bool, device=device).reshape(s, w),
            torch.as_tensor(seed, dtype=torch.bool, device=device).reshape(s, w))


def step_streams_masked_window(
    state: StreamState,
    depths: torch.Tensor,  # (S, W, H, Wd): up to W new frames per slot
    active,  # (S, W) bool: which window rows carry a frame
    seed,  # (S, W) bool: row is that slot's FIRST frame
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[StreamState, torch.Tensor]:
    """Masked multi-stream step over a W-frame window: W masked steps in a
    loop, the state on the device. Sessions with fewer than W frames pad
    with active=False rows, which leave their slot untouched.

    Returns (new_state, stats (S, W, 35)): per-frame rows in window order,
    identical to W sequential step_streams_masked calls."""
    s, w = depths.shape[:2]
    active, seed = _window_flags(active, seed, s, w, state.poses.device)
    rows = []
    for j in range(w):
        state, st = _masked_impl(state, depth_to_meters(depths[:, j], depth_scale), active[:, j], seed[:, j],
                                 intr, cfg, min_inlier_fraction)
        rows.append(st)
    return state, torch.stack(rows, dim=1)


# --- RGB-D streams ------------------------------------------------------------


class RgbdStreamState(NamedTuple):
    """Per-slot RGB-D state: reference plane tables + intensity pyramids."""

    poses: torch.Tensor  # (S, 4, 4) world_from_camera
    ref_levels: tuple  # PyramidLevels with B = S (reference frames)
    ref_grays: tuple  # (S, H_l, W_l) intensity pyramid (reference frames)
    initialized: torch.Tensor  # (S,) bool
    frame_count: torch.Tensor  # (S,) int32


def blank_streams_rgbd(
    intr: camera.Intrinsics,
    cfg: rgbd_mod.RgbdIcpConfig = rgbd_mod.RgbdIcpConfig(),
    num_streams: int = 8,
    device=device_mod.DEFAULT,
) -> RgbdStreamState:
    """Uninitialized S-slot RGB-D state (see blank_streams)."""
    dev = device_mod.resolve(device)
    z = torch.zeros((num_streams, int(intr.height), int(intr.width)), dtype=torch.float32, device=dev)
    levels, grays, _ = rgbd_mod.build_rgbd_target(z, z, intr, cfg)
    return RgbdStreamState(
        poses=_eye(num_streams, dev),
        ref_levels=tuple(levels),
        ref_grays=tuple(grays),
        initialized=torch.zeros(num_streams, dtype=torch.bool, device=dev),
        frame_count=torch.zeros(num_streams, dtype=torch.int32, device=dev),
    )


# RGB-D stats row: pose (16) | relative (16) | success | rmse | photo_rmse
# | inlier_fraction.
MASKED_RGBD_STATS_WIDTH = 36


def _masked_rgbd_impl(state, depths, grays, active, seed, intr, cfg, min_inlier_fraction):
    s, dev = state.poses.shape[0], state.poses.device
    active, seed = _flag(active, s, dev), _flag(seed, s, dev)
    cfg = projective.fit_levels(cfg, *depths.shape[-2:])
    grays = grays.to(torch.float32)
    new_levels, new_grays, intrs = rgbd_mod.build_rgbd_target(depths, grays, intr, cfg)
    samples = rgbd_mod.sample_rgbd_source(depths, grays, intrs, cfg)
    res = rgbd_mod.rgbd_icp_sampled(samples, state.ref_levels, state.ref_grays, intrs, None, cfg)
    finite = torch.isfinite(res.transform).all(-1).all(-1)
    ok = finite & (res.inlier_fraction >= min_inlier_fraction)
    poses, initialized, count, take_new, stats = _masked_finish(
        state, res.transform, ok, active, seed, res.rmse, res.inlier_fraction, [res.photo_rmse]
    )
    ref_levels = _select_levels(take_new, new_levels, state.ref_levels)
    ref_grays = tuple(torch.where(_bcast(take_new, n), n, o) for n, o in zip(new_grays, state.ref_grays))
    return RgbdStreamState(poses, ref_levels, ref_grays, initialized, count), stats


def step_streams_masked_rgbd(
    state: RgbdStreamState,
    depths: torch.Tensor,  # (S, H, W)
    grays: torch.Tensor,  # (S, H, W) [0, 1] intensities
    active,  # (S,) bool
    seed,  # (S,) bool
    intr: camera.Intrinsics,
    cfg: rgbd_mod.RgbdIcpConfig = rgbd_mod.RgbdIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[RgbdStreamState, torch.Tensor]:
    """RGB-D variant of ``step_streams_masked``: each active slot registers
    its new frame against its reference with the JOINT point-to-plane +
    photometric objective (align/rgbd.py), batched over the S slots (on the
    card one gn_system launch per joint step for all of them).

    Returns (new_state, stats (S, 36)); see MASKED_RGBD_STATS_WIDTH."""
    return _masked_rgbd_impl(state, depth_to_meters(depths, depth_scale), grays, active, seed, intr, cfg,
                             min_inlier_fraction)


def step_streams_masked_rgbd_window(
    state: RgbdStreamState,
    depths: torch.Tensor,  # (S, W, H, Wd)
    grays: torch.Tensor,  # (S, W, H, Wd)
    active,  # (S, W) bool
    seed,  # (S, W) bool
    intr: camera.Intrinsics,
    cfg: rgbd_mod.RgbdIcpConfig = rgbd_mod.RgbdIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[RgbdStreamState, torch.Tensor]:
    """RGB-D variant of ``step_streams_masked_window``. Returns (new_state,
    stats (S, W, 36))."""
    s, w = depths.shape[:2]
    active, seed = _window_flags(active, seed, s, w, state.poses.device)
    rows = []
    for j in range(w):
        state, st = _masked_rgbd_impl(state, depth_to_meters(depths[:, j], depth_scale), grays[:, j], active[:, j],
                                      seed[:, j], intr, cfg, min_inlier_fraction)
        rows.append(st)
    return state, torch.stack(rows, dim=1)


def shard_streams(state, mesh, data_axis: str = "data"):
    """This rank's contiguous block of the slot axis of a StreamState,
    RgbdStreamState or TsdfStreamState (volumes included), copied onto the
    rank's device: the rank at data coordinate r keeps slots r S/n ..
    (r+1) S/n - 1 and steps them with the same step functions. S must be a
    multiple of the data size."""
    from realsensetracker_tpu_torch.parallel import mesh as mesh_mod

    dev = mesh_mod.mesh_device(mesh)

    def take(x):
        if isinstance(x, torch.Tensor):
            return x[mesh_mod.block(x.shape[0], mesh, data_axis, "slot axis")].to(dev, copy=True)
        if isinstance(x, tuple):
            parts = [take(a) for a in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        return x

    return take(state)


# --- dense (TSDF frame-to-model) streams ---------------------------------------


class TsdfStreamState(NamedTuple):
    """S concurrent KinectFusion trackers: each slot carries its own dense
    volume ((S, V, V, V) tsdf/weight planes) and pose. Device memory is
    S * 2 * V^3 * 4 bytes (128 MB at S=8, V=128). The planes update in
    place, so unlike JAX's functional state, a step that raises part-way
    may leave some slots' planes advanced."""

    poses: torch.Tensor  # (S, 4, 4) world_from_camera
    volume: tsdf_mod.TsdfVolume  # (S, V, V, V) tsdf and weight planes, no color
    initialized: torch.Tensor  # (S,) bool (seeded at least once)
    frame_count: torch.Tensor  # (S,) int32


def _slot_volume(volume: tsdf_mod.TsdfVolume, i: int) -> tsdf_mod.TsdfVolume:
    """Slot i's volume as views of the (S, V, V, V) planes."""
    return tsdf_mod.TsdfVolume(volume.tsdf[i], volume.weight[i])


def _stream_vol_cfg(vol_cfg):
    """The slot config: the frustum-slab window is forced OFF (JAX forces it
    off under vmap, where its cond computes both branches; the fused result
    is bit-identical to the full pass by construction)."""
    vol_cfg = vol_cfg or tsdf_mod.TsdfConfig()
    if vol_cfg.integrate_slab:
        vol_cfg = vol_cfg._replace(integrate_slab=0)
    return vol_cfg


def _fuse_flags(frame_count: torch.Tensor, vol_cfg) -> torch.Tensor:
    """integrate_every cadence keyed on each slot's frame counter (the same
    phase as TsdfTracker's counter from a fresh seed)."""
    n_every = int(vol_cfg.integrate_every)
    if n_every > 1:
        return frame_count % n_every == 0
    return torch.ones(frame_count.shape, dtype=torch.bool, device=frame_count.device)


def init_tsdf_streams(
    first_depths: torch.Tensor,  # (S, H, W)
    intr: camera.Intrinsics,
    vol_cfg=None,
    depth_scale: float = 1.0,
) -> TsdfStreamState:
    """Seed S dense streams: each slot's volume integrates its first frame
    at identity."""
    vol_cfg = _stream_vol_cfg(vol_cfg)
    first_depths = depth_to_meters(first_depths, depth_scale)
    s, dev = first_depths.shape[0], first_depths.device
    state = blank_tsdf_streams(intr, vol_cfg, num_streams=s, device=dev)
    tsdf_mod.integrate_slots(state.volume, first_depths, _eye(s, dev), intr, vol_cfg)
    return state._replace(
        initialized=torch.ones(s, dtype=torch.bool, device=dev),
        frame_count=torch.ones(s, dtype=torch.int32, device=dev),
    )


def _tsdf_register(state, depths, base_poses, seeding_render, intr, vol_cfg, icp_cfg, min_inlier_fraction):
    """Render every slot's model at its base pose (S raycasts), then register
    all S frames (at the tracking resolution, tracking/tsdf_tracker.
    _track_views) onto their renders in ONE batched registration. Slots in
    ``seeding_render`` restart from an empty volume, whose render is empty.
    Returns (transform (S,4,4), ok (S,), rmse (S,), inlier (S,))."""
    t_d, t_intr = _track_views(depths, intr, int(vol_cfg.track_scale))
    renders = torch.stack([
        tsdf_mod.render_model_depth(_slot_volume(state.volume, i), base_poses[i], t_intr, vol_cfg)
        for i in range(depths.shape[0])
    ])
    renders = torch.where(seeding_render[:, None, None], 0.0, renders)
    res = projective.register_depth_pair(t_d, renders, t_intr, icp_cfg)
    ok = torch.isfinite(res.transform).all(-1).all(-1) & (res.inlier_fraction >= min_inlier_fraction)
    return res.transform, ok, res.rmse, res.inlier_fraction


def _tsdf_streams_impl(state, depths, intr, vol_cfg, icp_cfg, min_inlier_fraction):
    s, dev = depths.shape[0], depths.device
    fuses = _fuse_flags(state.frame_count, vol_cfg)
    no_seed = torch.zeros(s, dtype=torch.bool, device=dev)
    T, ok, rmse, inlier = _tsdf_register(state, depths, state.poses, no_seed, intr, vol_cfg, icp_cfg,
                                         min_inlier_fraction)
    poses = torch.where(ok[:, None, None], se3.orthonormalize(se3.compose(state.poses, T)), state.poses)
    tsdf_mod.integrate_slots(state.volume, depths, poses, intr, vol_cfg, gates=ok & fuses)
    new_state = TsdfStreamState(poses, state.volume, state.initialized, state.frame_count + 1)
    return new_state, StreamStepResult(poses, ok, rmse, inlier)


def step_tsdf_streams(
    state: TsdfStreamState,
    depths: torch.Tensor,  # (S, H, W) one new frame per stream
    intr: camera.Intrinsics,
    vol_cfg=None,
    icp_cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[TsdfStreamState, StreamStepResult]:
    """Advance S dense frame-to-model trackers one frame: S renders, one
    batched registration, one integrate of all S gated on the device
    (failure hold, integrate_every cadence) -- the same results as
    per-slot tracking."""
    with span("rst.streams.step"):
        vol_cfg = _stream_vol_cfg(vol_cfg)
        return _tsdf_streams_impl(state, depth_to_meters(depths, depth_scale), intr, vol_cfg, icp_cfg,
                                  min_inlier_fraction)


def step_tsdf_streams_window(
    state: TsdfStreamState,
    depths: torch.Tensor,  # (S, W, H, Wd): W new frames per stream
    intr: camera.Intrinsics,
    vol_cfg=None,
    icp_cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[TsdfStreamState, StreamStepResult]:
    """Advance S dense streams by W frames (a loop of step_tsdf_streams)."""
    with span("rst.streams.step"):
        vol_cfg = _stream_vol_cfg(vol_cfg)
        seq = []
        for j in range(depths.shape[1]):
            state, res = _tsdf_streams_impl(state, depth_to_meters(depths[:, j], depth_scale), intr, vol_cfg,
                                            icp_cfg, min_inlier_fraction)
            seq.append(res)
        return state, _stack_results(seq)


def blank_tsdf_streams(
    intr: camera.Intrinsics,
    vol_cfg=None,
    num_streams: int = 8,
    device=device_mod.DEFAULT,
) -> TsdfStreamState:
    """Uninitialized S-slot dense state (empty volumes, identity poses);
    slots come alive through step_tsdf_streams_masked's seed mask."""
    vol_cfg = _stream_vol_cfg(vol_cfg)
    dev = device_mod.resolve(device)
    s, v = num_streams, vol_cfg.resolution
    return TsdfStreamState(
        poses=_eye(s, dev),
        volume=tsdf_mod.TsdfVolume(
            tsdf=torch.ones((s, v, v, v), dtype=torch.float32, device=dev),
            weight=torch.zeros((s, v, v, v), dtype=torch.float32, device=dev),
        ),
        initialized=torch.zeros(s, dtype=torch.bool, device=dev),
        frame_count=torch.zeros(s, dtype=torch.int32, device=dev),
    )


def _tsdf_masked_impl(state, depths, active, seed, intr, vol_cfg, icp_cfg, min_inlier_fraction):
    s, dev = state.poses.shape[0], state.poses.device
    active, seed = _flag(active, s, dev), _flag(seed, s, dev)
    eye = _eye(s, dev)
    fuses = _fuse_flags(state.frame_count, vol_cfg)
    # A seeding slot restarts from an EMPTY volume at identity: its
    # registration (against the empty render) fails by construction and
    # is discarded by _masked_finish's seeding branch.
    base_poses = torch.where(seed[:, None, None], eye, state.poses)
    T, ok, rmse, inlier = _tsdf_register(state, depths, base_poses, seed, intr, vol_cfg, icp_cfg,
                                         min_inlier_fraction)
    pose_cand = torch.where(seed[:, None, None], eye, se3.orthonormalize(se3.compose(state.poses, T)))
    safe_t = torch.where(torch.isfinite(T), T, eye)
    poses, initialized, count, _, stats = _masked_finish(state, safe_t, ok, active, seed, rmse, inlier, [])
    # The volume changes only where the slot seeds, or tracks successfully
    # with its integrate_every cadence due; inactive slots are untouched.
    # A seeding slot's planes are cleared on the device first.
    seeding = active & seed
    state.volume.tsdf.masked_fill_(_bcast(seeding, state.volume.tsdf), 1.0)
    state.volume.weight.masked_fill_(_bcast(seeding, state.volume.weight), 0.0)
    tsdf_mod.integrate_slots(state.volume, depths, pose_cand, intr, vol_cfg, gates=active & (seed | (ok & fuses)))
    return TsdfStreamState(poses, state.volume, initialized, count), stats


def step_tsdf_streams_masked(
    state: TsdfStreamState,
    depths: torch.Tensor,  # (S, H, W) one new frame per slot
    active,  # (S,) bool: slots with a request this round
    seed,  # (S,) bool: active slot's FIRST frame (re)seeds it
    intr: camera.Intrinsics,
    vol_cfg=None,
    icp_cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[TsdfStreamState, torch.Tensor]:
    """Masked dense (KinectFusion) multi-stream step: active slots raycast
    their own volume, register (one batched registration for all slots),
    and integrate at the new pose; seed slots restart from an empty volume
    at identity; inactive slots stay bit-identical. Returns (state, stats
    (S, 35)) with the step_streams_masked row layout."""
    vol_cfg = _stream_vol_cfg(vol_cfg)
    return _tsdf_masked_impl(state, depth_to_meters(depths, depth_scale), active, seed, intr, vol_cfg, icp_cfg,
                             min_inlier_fraction)


def step_tsdf_streams_masked_window(
    state: TsdfStreamState,
    depths: torch.Tensor,  # (S, W, H, Wd)
    active,  # (S, W) bool
    seed,  # (S, W) bool
    intr: camera.Intrinsics,
    vol_cfg=None,
    icp_cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    min_inlier_fraction: float = 0.2,
    depth_scale: float = 1.0,
) -> tuple[TsdfStreamState, torch.Tensor]:
    """Masked dense multi-stream step over a W-frame window (a loop; the S
    volumes stay on the device). Returns (state, stats (S, W, 35))
    identical to W sequential masked steps."""
    vol_cfg = _stream_vol_cfg(vol_cfg)
    s, w = depths.shape[:2]
    active, seed = _window_flags(active, seed, s, w, state.poses.device)
    rows = []
    for j in range(w):
        state, st = _tsdf_masked_impl(state, depth_to_meters(depths[:, j], depth_scale), active[:, j], seed[:, j],
                                      intr, vol_cfg, icp_cfg, min_inlier_fraction)
        rows.append(st)
    return state, torch.stack(rows, dim=1)
