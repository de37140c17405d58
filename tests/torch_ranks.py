"""Gloo ranks on the CPU for the port's multi-device tests.

``run_ranks(world, scenario, *args)`` runs ``scenario(*args)`` on ``world``
spawned processes joined in one gloo process group through a FileStore in
a temporary directory (TCP ports would collide across xdist workers), with
parallel.dryrun.spawn_ranks, and returns the ranks' results in rank order.
The ranks import this module, torch and the port only -- never JAX -- and
run one torch thread each. A collective that hangs fails after 60 s (the
group's timeout), and a rank that has not reported after 120 s fails the
run.

The scenarios below are module-level so that the ranks can find them; each
runs everything one test file needs from one group and returns numpy
results.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch

from realsensetracker_tpu_torch.parallel.dryrun import spawn_ranks

GROUP_TIMEOUT = timedelta(seconds=60)
JOIN_TIMEOUT = 120.0


def run_ranks(world: int, scenario, *args) -> list:
    """``scenario(*args)`` on ``world`` gloo ranks; returns their results."""
    return spawn_ranks(world, scenario, args, device="cpu", threads=1, group_timeout=GROUP_TIMEOUT,
                       timeout=JOIN_TIMEOUT)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _raises(fn, *args, **kw) -> str:
    """The message of the exception ``fn`` raises ('' if none)."""
    try:
        fn(*args, **kw)
    except Exception as e:  # returned to the test, which checks type and text
        return f"{type(e).__name__}: {e}"
    return ""


# --- tests/test_torch_parallel.py ----------------------------------------------------


def parallel_scenario(src, dst, intr_kw, cfgs) -> dict:
    """Mesh shapes, point-sharded and data-parallel registration, the
    multihost helpers and the dry run's checks, on 4 ranks."""
    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.geometry import camera
    from realsensetracker_tpu_torch.parallel import batched, dryrun, multihost, sharded
    from realsensetracker_tpu_torch.parallel import mesh as mesh_mod

    intr = camera.Intrinsics(**intr_kw)
    src, dst = torch.from_numpy(src), torch.from_numpy(dst)
    out = {"errors": {
        "too_many": _raises(mesh_mod.make_mesh, 8, device="cpu"),
        "pp": _raises(mesh_mod.make_mesh, 4, point_parallelism=3, device="cpu"),
    }}
    meshes = {pp: mesh_mod.make_mesh(4, point_parallelism=pp, device="cpu") for pp in (1, 2, 4)}
    out["shapes"] = {pp: (mesh_mod.axis_size(m, "data"), mesh_mod.axis_size(m, "point")) for pp, m in meshes.items()}
    out["balanced"] = tuple(mesh_mod.balanced_mesh(device="cpu").mesh.shape)
    for name, kw in cfgs.items():
        cfg = projective.ProjectiveIcpConfig(**kw)
        pair2 = (src[:2], dst[:2])
        for pp in (2, 4):  # 2x2 and 1x4 meshes: the points of a pair over 2 and 4 ranks
            T, rmse = sharded.register_batch_point_sharded(meshes[pp], *pair2, intr, cfg)
            out[f"point_{name}_pp{pp}"] = (_np(T), _np(rmse))
        ref = batched.register_batch(*pair2, intr, cfg)
        out[f"plain_{name}"] = (_np(ref.transform), _np(ref.rmse))
    cfg = projective.ProjectiveIcpConfig(**cfgs["default"])
    T, rmse = sharded.register_batch_point_sharded(meshes[1], src, dst, intr, cfg)  # 4 data ranks, 2 pairs each
    out["point_data4"] = (_np(T), _np(rmse))
    res = batched.register_batch_sharded(meshes[1], src, dst, intr, cfg)
    out["data_parallel"] = tuple(_np(x) for x in res)
    ref = batched.register_batch(src, dst, intr, cfg)
    out["plain_all"] = tuple(_np(x) for x in ref)
    frames = multihost.global_frame_batch(np.zeros((2, 12, 16), np.float32), meshes[1])
    mine = multihost.process_stream_slice(8)  # this rank's pairs, loaded alone
    gsrc, gdst = (multihost.global_frame_batch(x[mine], meshes[1]) for x in (src, dst))
    out["data_parallel_from_local"] = _np(batched.register_batch_sharded(meshes[1], gsrc, gdst, intr, cfg).transform)
    out["multihost"] = {
        "slice": multihost.process_stream_slice(8),
        "uneven": _raises(multihost.process_stream_slice, 6),
        "global_shape": tuple(frames.shape),
        "local_shape": tuple(frames.to_local().shape),
    }
    multihost.all_processes_ready()
    multihost.all_processes_ready()
    out["dryrun"] = dryrun.dryrun_rank(4, "cpu")
    return out


# --- tests/test_torch_sharded_tsdf.py ------------------------------------------------


def tsdf_scenario(depths, poses, intr_kw, cfg_kw, icp_kw) -> dict:
    """The x-slab volume over 4 ranks: layout, integrate, raycast, color,
    mesh extraction and a tracker resharded mid-stream, each beside the
    unsharded volume of the same rank."""
    from torch.distributed.tensor import Replicate, Shard

    from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
    from realsensetracker_tpu_torch.geometry import camera
    from realsensetracker_tpu_torch.mapping import mesh as mesh_extract
    from realsensetracker_tpu_torch.mapping import sharded as sh
    from realsensetracker_tpu_torch.mapping import tsdf
    from realsensetracker_tpu_torch.parallel.mesh import make_mesh
    from realsensetracker_tpu_torch.tracking.tsdf_tracker import TsdfTracker

    intr, cfg = camera.Intrinsics(**intr_kw), tsdf.TsdfConfig(**cfg_kw)
    depths, poses = torch.from_numpy(depths), torch.from_numpy(poses)
    mesh = make_mesh(4, device="cpu")
    vol = sh.init_volume_sharded(cfg, mesh)
    out = {
        "placements": (tuple(vol.tsdf.placements) == (Shard(0), Replicate())
                       and list(sh.volume_sharding(mesh)) == [Shard(0), Replicate()]),
        "global_shape": tuple(vol.tsdf.shape),
        "local_shape": tuple(vol.tsdf.to_local().shape),
        "indivisible": _raises(sh.shard_volume, tsdf.init_volume(cfg._replace(resolution=62), device="cpu"), mesh),
        "slab_forced_off": True,
    }
    ref = tsdf.init_volume(cfg, device="cpu")
    layout = []
    for i in range(len(depths)):
        tsdf.integrate(ref, depths[i], poses[i], intr, cfg)
        sh.integrate(vol, depths[i], poses[i], intr, cfg)
        layout.append(tuple(vol.tsdf.placements) == (Shard(0), Replicate()))
        if i == 2:
            out["raycast"] = _np(sh.raycast(vol, poses[0], intr, cfg))
            out["raycast_plain"] = _np(tsdf.raycast(ref, poses[0], intr, cfg))
    out["layout_kept"] = all(layout)
    whole = sh.gather_volume(vol)
    out["tsdf"], out["weight"] = _np(whole.tsdf), _np(whole.weight)
    out["exact"] = bool(torch.equal(whole.tsdf, ref.tsdf) and torch.equal(whole.weight, ref.weight))
    # A window configuration integrates the whole slab (the window is forced off).
    win = sh.init_volume_sharded(cfg._replace(integrate_slab=32), mesh)
    sh.integrate(win, depths[0], poses[0], intr, cfg._replace(integrate_slab=32))
    one = tsdf.integrate(tsdf.init_volume(cfg, device="cpu"), depths[0], poses[0], intr, cfg)
    out["window_exact"] = bool(torch.equal(sh.gather_volume(win).tsdf, one.tsdf))

    color = torch.full(depths.shape[1:] + (3,), 0.4)
    cvol = sh.init_volume_sharded(cfg, mesh, with_color=True)
    sh.integrate(cvol, depths[0], poses[0], intr, cfg, color=color)
    cref = tsdf.integrate(tsdf.init_volume(cfg, with_color=True, device="cpu"), depths[0], poses[0], intr, cfg,
                          color=color)
    out["color"] = _np(sh.gather_volume(cvol).color)
    out["color_exact"] = bool(torch.equal(sh.gather_volume(cvol).color, cref.color))

    m_sh = mesh_extract.extract_mesh(sh.shard_volume(one, mesh), cfg, capacity=16384)
    m_ref = mesh_extract.extract_mesh(one, cfg, capacity=16384)
    out["mesh"] = (_np(m_sh.vertices), _np(m_sh.mask))
    out["mesh_exact"] = bool(torch.equal(m_sh.vertices, m_ref.vertices) and torch.equal(m_sh.mask, m_ref.mask))

    icp = ProjectiveIcpConfig(**icp_kw)
    a = TsdfTracker(intr, volume=cfg, icp=icp, device="cpu")
    b = TsdfTracker(intr, volume=cfg, icp=icp, device="cpu")
    for i in range(2):
        a.process(depths[i].numpy(), float(i))
        b.process(depths[i].numpy(), float(i))
    b._vol = sh.shard_volume(b._vol, mesh)  # reshard mid-stream
    steps = []
    for i in range(2, len(depths)):
        ra, rb = a.process(depths[i].numpy(), float(i)), b.process(depths[i].numpy(), float(i))
        steps.append((ra.success, rb.success, ra.pose, rb.pose))
    out["tracker"] = steps
    out["tracker_still_sharded"] = sh.is_sharded(b.tsdf_volume)
    return out


# --- tests/test_torch_sharded_serving.py ---------------------------------------------


def _serve_sharded(cfg, drive):
    """Rank 0 runs a BatchedExecutor over ``cfg`` and ``drive(executor)``;
    the other ranks serve it (run_worker) until it closes."""
    import torch.distributed as dist

    from realsensetracker_tpu_torch.api.batching import BatchedExecutor, run_worker

    if dist.get_rank() != 0:
        run_worker(cfg)
        return None
    ex = BatchedExecutor(cfg)
    try:
        return drive(ex)
    finally:
        ex.close()


def drive_depth_sessions(ex, stream_data) -> dict:
    """S sessions of F frames in turn, then a fresh session's 2-frame window
    of raw u16 frames (1/5000 m: the executor's depth_scale)."""
    f_n, s_n = stream_data.shape[:2]
    trackers = [ex.make_session_tracker() for _ in range(s_n)]
    for f in range(f_n):
        for i in range(s_n):
            trackers[i].process(stream_data[f, i], float(f))
    raw = np.asarray(stream_data[:2, 0] * 5000.0 + 0.5, np.uint16)
    rs = ex.make_session_tracker().process_window(raw, window=2)
    return {"poses": [t.pose for t in trackers], "window": [(r.success, r.pose) for r in rs], "stats": ex.stats()}


def drive_dense_sessions(ex, tsdf_data) -> dict:
    f_n, s_n = tsdf_data.shape[:2]
    trackers = [ex.make_session_tracker() for _ in range(s_n)]
    for f in range(f_n):
        for i in range(s_n):
            trackers[i].process(tsdf_data[f, i], float(f))
    return {"poses": [t.pose for t in trackers], "stats": ex.stats()}


def serving_scenario(stream_data, tsdf_data, depth_kw, dense_kw, atlas) -> dict:
    """The slot axis over 2 ranks: shard_streams of the three slot states,
    the capacity check, the sharded executor with depth and with dense
    slots, and the atlas's pair verification with the pair axis sharded."""
    import functools

    import torch.distributed as dist

    from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
    from realsensetracker_tpu_torch.api.batching import BatchedExecutor, BatchingConfig, run_worker
    from realsensetracker_tpu_torch.geometry import camera
    from realsensetracker_tpu_torch.mapping import submaps
    from realsensetracker_tpu_torch.mapping.tsdf import TsdfConfig
    from realsensetracker_tpu_torch.ops.cloud import Cloud
    from realsensetracker_tpu_torch.parallel import streams
    from realsensetracker_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, device="cpu")
    rank = dist.get_rank()

    def config(kw, **extra):
        kw = dict(kw)
        intr, icp = camera.Intrinsics(**kw.pop("intrinsics")), ProjectiveIcpConfig(**kw.pop("icp"))
        if "tsdf_cfg" in kw:
            kw["tsdf_cfg"] = TsdfConfig(**kw["tsdf_cfg"])
        return BatchingConfig(intrinsics=intr, icp=icp, mesh=mesh, device="cpu", request_timeout_s=60.0,
                              **kw, **extra)

    out = {"capacity": _raises(BatchedExecutor if rank == 0 else run_worker, config(depth_kw, capacity=3)),
           "not_rank0": _raises(run_worker if rank == 0 else BatchedExecutor, config(depth_kw, capacity=4))}

    cfg = config(depth_kw, capacity=4)
    blanks = {
        "depth": streams.blank_streams(cfg.intrinsics, cfg.icp, num_streams=4, device="cpu"),
        "rgbd": streams.blank_streams_rgbd(cfg.intrinsics, num_streams=4, device="cpu"),
        "tsdf": streams.blank_tsdf_streams(cfg.intrinsics, TsdfConfig(**dense_kw["tsdf_cfg"]), num_streams=4,
                                           device="cpu"),
    }
    lo = 2 * mesh.get_local_rank("data")
    shards = {}
    for name, state in blanks.items():
        local = streams.shard_streams(state, mesh)
        want = [x[lo : lo + 2] for x in _leaves(state)]
        shards[name] = (type(local) is type(state),
                        all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(_leaves(local), want)))
    out["shard_streams"] = shards

    out["depth"] = _serve_sharded(cfg, functools.partial(drive_depth_sessions, stream_data=stream_data))
    out["dense"] = _serve_sharded(config(dense_kw, capacity=2),
                                  functools.partial(drive_dense_sessions, tsdf_data=tsdf_data))

    points, masks, feats, pairs, kw = atlas
    surfs = [Cloud(torch.from_numpy(p), torch.from_numpy(m)) for p, m in zip(points, masks)]
    feats = [torch.from_numpy(f) for f in feats]
    plain = submaps._verify_submap_pairs(surfs, feats, pairs, **kw)
    sharded = submaps._verify_submap_pairs(surfs, feats, pairs, mesh=mesh, **kw)
    out["verify"] = (tuple(_np(x) for x in sharded), tuple(_np(x) for x in plain))
    return out


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [leaf for a in x for leaf in _leaves(a)]
    return []
