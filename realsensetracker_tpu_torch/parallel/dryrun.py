"""Multi-device dry run: every sharded path at the flagship shapes, checked.

The torch twin of ``dryrun_multichip`` in the repository's
``__graft_entry__.py`` (its ``_dryrun_impl``). ``dryrun_multichip(n)``
starts n ranks, one process per card (NCCL), joins them in a
(data, point) mesh with point size 2 where n is even, and on every rank:

* registers 2 pairs per data rank of 640x480 frames with the default
  ProjectiveIcpConfig point-sharded (parallel/sharded.py: gn_system with
  the round's association pose, an all-reduce per inner step) and holds
  the transforms within 1e-5 of register_batch on the whole batch;
* integrates a 64^3 volume in x-slabs (mapping/sharded.py) and holds it
  within 1e-6 of the unsharded volume, then raycasts it through the slab
  gather (more than 30% of the rays hit);
* runs the masked serving steps (depth seed, tracked and 2-frame window
  rounds; dense slots seed and tracked) on this rank's block of 8 slots
  (streams.shard_streams) and holds stats, poses and volumes exactly
  equal to the unsharded steps' rows of the same slots;
* verifies 3 atlas surface pairs with the pair axis sharded
  (submaps._verify_submap_pairs) within 1e-5 of the unsharded run.

A rank that fails raises, and dryrun_multichip raises with its
traceback. It needs n cards on "cuda"; it never moves itself to the CPU
when cards are missing (that would hide the device): it raises, and
``device="cpu"`` runs gloo ranks on the CPU instead.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod

COLLECTIVE_TIMEOUT = timedelta(seconds=300)  # a hung collective fails, not the caller's patience


def spawn_ranks(world: int, fn, args=(), device=device_mod.DEFAULT, threads: int | None = None,
                group_timeout: timedelta = COLLECTIVE_TIMEOUT, timeout: float = 1800.0) -> list:
    """``fn(*args)`` on ``world`` spawned processes joined in one process
    group (NCCL on "cuda", gloo on "cpu") through a FileStore in a
    temporary directory; returns the ranks' results in rank order. ``fn``
    must be importable by the ranks (a module-level function), its results
    picklable; ``threads`` caps each rank's torch threads. Raises with the
    failed ranks' tracebacks, or when a rank has not reported within
    ``timeout`` seconds (a collective that hangs fails after
    ``group_timeout``)."""
    import torch.multiprocessing as mp

    dev = device_mod.resolve(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="rst-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, world, store, dev.type, threads, group_timeout, fn, args,
                                                      results)) for r in range(world)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        try:
            while len(got) < world:
                try:
                    rank, ok, payload = results.get(timeout=max(1.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                got[rank] = (ok, payload)
                if not ok:
                    break
        finally:
            for p in procs:
                p.join(timeout=30 if len(got) == world else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = {r: msg for r, (ok, msg) in got.items() if not ok}
    if failed or len(got) < world:
        detail = "\n".join(f"rank {r}:\n{msg}" for r, msg in sorted(failed.items()))
        raise RuntimeError(f"{len(got)} of {world} ranks reported, {len(failed)} failed\n{detail}")
    return [got[r][1] for r in range(world)]


def _rank_main(rank, world, store, device_type, threads, group_timeout, fn, args, results) -> None:
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank, world_size=world,
                                timeout=group_timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # the parent raises with it
        raise


def dryrun_multichip(n_devices: int, device=device_mod.DEFAULT) -> dict:
    """Run the dry run on ``n_devices`` ranks (spawned processes); returns
    rank 0's summary (errors against the unsharded paths, hit share,
    seconds). Raises if any rank fails."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} cards, this host has {torch.cuda.device_count()}; "
            "pass device='cpu' to run gloo ranks on the CPU"
        )
    threads = max(1, (os.cpu_count() or 1) // (2 * n_devices)) if dev.type == "cpu" else None
    return spawn_ranks(n_devices, dryrun_rank, (n_devices, dev.type), device=dev, threads=threads)[0]


def _check(tag: str, got, want, atol: float = 0.0) -> float:
    got, want = (torch.as_tensor(x).cpu().numpy() for x in (got, want))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=tag)
    return float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()) if got.size else 0.0


def dryrun_rank(world: int, device_type: str) -> dict:
    """One rank's share of the dry run, inside an initialized process group
    of ``world`` ranks (every rank calls it alike). Returns its summary."""
    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.geometry import camera, se3
    from realsensetracker_tpu_torch.mapping import sharded as tsdf_sharded
    from realsensetracker_tpu_torch.mapping import submaps as submaps_mod
    from realsensetracker_tpu_torch.mapping import tsdf
    from realsensetracker_tpu_torch.ops import fpfh as fpfh_mod
    from realsensetracker_tpu_torch.parallel import batched, sharded, streams
    from realsensetracker_tpu_torch.parallel import mesh as mesh_mod

    t0 = time.perf_counter()
    point = 2 if world % 2 == 0 and world >= 2 else 1
    mesh = mesh_mod.make_mesh(world, point_parallelism=point, device=device_type)
    dev = mesh_mod.mesh_device(mesh)
    data = mesh_mod.axis_size(mesh, "data")
    out = {"world": world, "mesh": [data, point], "device": str(dev)}

    # -- flagship registration: 640x480, default config, 2 pairs per data rank
    intr = camera.TUM_FR1
    cfg = projective.ProjectiveIcpConfig()
    batch = 2 * data
    scene = synthetic.default_scene(device=dev)
    srcs, dsts = [], []
    for i in range(batch):
        tw = torch.tensor([0.01 * (i + 1), -0.005 * i, 0.004, 0.008, -0.006, 0.01 * i], dtype=torch.float32)
        d0, d1, _ = synthetic.render_pair(intr, tw, scene)
        srcs.append(d1)
        dsts.append(d0)
    src, dst = torch.stack(srcs), torch.stack(dsts)
    T, rmse = sharded.register_batch_point_sharded(mesh, src, dst, intr, cfg)
    assert T.shape == (batch, 4, 4) and bool(torch.isfinite(T).all())
    ref = batched.register_batch(src, dst, intr, cfg)
    out["register_max_abs_err"] = _check("point-sharded vs register_batch", T, ref.transform, 1e-5)
    out["rmse_max_abs_err"] = _check("point-sharded rmse", rmse, ref.rmse, 1e-5)

    # -- dense mapping: a 64^3 volume in x-slabs over the data ranks
    small = camera.Intrinsics(fx=64.0, fy=64.0, cx=39.5, cy=29.5, width=80, height=60)
    vcfg = tsdf.TsdfConfig(resolution=64, voxel_size=0.1, origin=(-3.2, -2.4, -0.3), trunc=0.3, max_range=5.0)
    eye = se3.identity(device=dev)
    depth = synthetic.render_depth(small, eye, synthetic.default_scene(seed=3, device=dev))
    vol = tsdf_sharded.init_volume_sharded(vcfg, mesh, axis="data")
    tsdf_sharded.integrate(vol, depth, eye, small, vcfg)
    whole = tsdf.integrate(tsdf.init_volume(vcfg, device=dev), depth, eye, small, vcfg)
    local, x0 = tsdf_sharded.local_slab(vol)
    nx = local.tsdf.shape[0]
    out["integrate_max_abs_err"] = _check("sharded integrate", local.tsdf, whole.tsdf[x0 : x0 + nx], 1e-6)
    render = tsdf_sharded.raycast(vol, eye, small, vcfg)
    out["raycast_hit_share"] = float((render > 0).float().mean())
    assert out["raycast_hit_share"] > 0.3, out["raycast_hit_share"]
    out["raycast_max_abs_err"] = _check("sharded raycast", render, tsdf.raycast(whole, eye, small, vcfg), 1e-5)

    # -- serving: the masked steps on this rank's block of 8 slots
    S = 8
    mine = mesh_mod.block(S, mesh, "data", "slot axis")
    scene7 = synthetic.default_scene(seed=7, device=dev)
    frames = torch.stack([
        synthetic.render_depth(small, se3.exp(torch.tensor(
            [0.01 * s, -0.004 * s, 0.02, 0.003 * s, 0.0, -0.002 * s], dtype=torch.float32, device=dev)), scene7)
        for s in range(2 * S)
    ])
    on = torch.ones(S, dtype=torch.bool, device=dev)
    off = torch.zeros(S, dtype=torch.bool, device=dev)
    seed_frames, track_frames = frames[:S], frames[S:]
    st_ref = streams.blank_streams(small, num_streams=S, device=dev)
    st_dev = streams.shard_streams(st_ref, mesh)
    st_ref, stats_ref = streams.step_streams_masked(st_ref, seed_frames, on, on, small)
    st_dev, stats_dev = streams.step_streams_masked(st_dev, seed_frames[mine], on[mine], on[mine], small)
    _check("masked seed stats", stats_dev, stats_ref[mine])
    st_ref2, stats_ref = streams.step_streams_masked(st_ref, track_frames, on, off, small)
    st_dev2, stats_dev = streams.step_streams_masked(st_dev, track_frames[mine], on[mine], off[mine], small)
    _check("masked track stats", stats_dev, stats_ref[mine])
    _check("masked track poses", st_dev2.poses, st_ref2.poses[mine])
    win = torch.stack([seed_frames, track_frames], dim=1)
    act2 = torch.ones((S, 2), dtype=torch.bool, device=dev)
    seed2 = torch.stack([on, off], dim=1)
    blank_ref = streams.blank_streams(small, num_streams=S, device=dev)
    stw_ref, wstats_ref = streams.step_streams_masked_window(blank_ref, win, act2, seed2, small)
    stw_dev, wstats_dev = streams.step_streams_masked_window(
        streams.shard_streams(blank_ref, mesh), win[mine], act2[mine], seed2[mine], small)
    _check("masked window stats", wstats_dev, wstats_ref[mine])
    _check("masked window poses", stw_dev.poses, stw_ref.poses[mine])
    _check("window vs sequential", stw_ref.poses, st_ref2.poses, 1e-6)

    tcfg = tsdf.TsdfConfig(resolution=32, voxel_size=0.2, origin=(-3.2, -2.4, -0.3), trunc=0.6, max_range=5.0)
    ts_ref = streams.blank_tsdf_streams(small, tcfg, num_streams=S, device=dev)
    ts_dev = streams.shard_streams(ts_ref, mesh)
    for tag, fr, sd in (("seed", seed_frames, on), ("track", track_frames, off)):
        ts_ref, tstats_ref = streams.step_tsdf_streams_masked(ts_ref, fr, on, sd, small, tcfg)
        ts_dev, tstats_dev = streams.step_tsdf_streams_masked(ts_dev, fr[mine], on[mine], sd[mine], small, tcfg)
        _check(f"tsdf masked {tag} stats", tstats_dev, tstats_ref[mine])
    _check("tsdf masked volumes", ts_dev.volume.tsdf, ts_ref.volume.tsdf[mine])

    # -- atlas: candidate pairs verified with the pair axis sharded
    surfs, feats = [], []
    for k in range(3):
        vol_k = tsdf.integrate(tsdf.init_volume(tcfg, device=dev), frames[k], eye, small, tcfg)
        c, nrm = tsdf.extract_surface_oriented(vol_k, tcfg, 512)
        surfs.append(c)
        feats.append(fpfh_mod.compute_fpfh_from_normals(c, nrm, 6 * tcfg.voxel_size, 64))
    vkw = dict(noise_bound=4 * tcfg.voxel_size, overlap_tau=2 * tcfg.voxel_size, min_overlap=0.5, refine_iters=4)
    pairs = [(0, 1), (0, 2), (1, 2)]
    vT_ref, vok_ref, _ = submaps_mod._verify_submap_pairs(surfs, feats, pairs, **vkw)
    vT, vok, _ = submaps_mod._verify_submap_pairs(surfs, feats, pairs, mesh=mesh, mesh_axis="data", **vkw)
    out["atlas_verify_max_abs_err"] = _check("sharded atlas verify T", vT, vT_ref, 1e-5)
    _check("sharded atlas verify ok", vok, vok_ref)
    out["seconds"] = time.perf_counter() - t0
    return out
