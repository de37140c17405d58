"""Batched frame-pair registration: the ``pairs.*`` cells.

Set-up renders the pool of distinct pairs on the device from the seed
(scene.py): each pair's start pose and its one-frame motion, two renders,
Gaussian depth noise. Each call of the window registers ``batch`` pairs
through the cell's entry of ``parallel.batched`` and reads the transforms
on the host; calls cycle through the pool. Once the window has closed, the
plain reference (reference_pairs.py) registers every pair of the pool
again and each transform the window read, and the last rmse and inlier
fraction of each pair, are compared with it.
"""

from __future__ import annotations

import time

import torch

from h100bench import hooks, readers, reference_pairs, scene, stats
from h100bench import trace as tracing


def make_pool(config: dict, seed: int, dev: torch.device):
    """(src, dst (N, H, W) f32 meters, motion (N, 4, 4)): N distinct pairs."""
    cam = scene.camera_of(config)
    g = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    sc = scene.sphere_scene(config["scene"]["seed"], config["scene"]["spheres"], dev)
    n = int(config["pairs"])
    P0, M = scene.pair_poses(g, n, config["start"], config["motion"], dev)
    dst = scene.add_noise(g, scene.render_depths(cam, P0, sc), config["noise_m"])
    src = scene.add_noise(g, scene.render_depths(cam, P0 @ M, sc), config["noise_m"])
    return src, dst, M


def icp_dict(config: dict) -> dict:
    icp = dict(config["icp"])
    icp["iters"] = tuple(icp["iters"])
    return icp


def compare(transforms, rmse, frac, ref):
    """The numbers compared: the largest twist gap of any transform read in
    the window, and the largest rmse and inlier-fraction gaps, to the
    reference's (T, rmse, frac)."""
    T_ref, rmse_ref, frac_ref = ref
    twist = 0.0
    for start, T in transforms:
        n = T.shape[0]
        gap = reference_pairs.twist_gap(T_ref[start : start + n], T.to(T_ref.device))
        twist = max(twist, float(torch.nan_to_num(gap, nan=float("inf")).max()))
    return [
        ("twist_gap", twist),
        ("rmse_gap", float(torch.nan_to_num((rmse - rmse_ref).abs(), nan=float("inf")).max())),
        ("inlier_gap", float(torch.nan_to_num((frac - frac_ref).abs(), nan=float("inf")).max())),
    ]


def run(cell, config, seed, seconds, trace, device, t_start, records=None):
    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.geometry import camera
    from realsensetracker_tpu_torch.parallel import batched

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cam = scene.camera_of(config)
    icp = icp_dict(config)
    src, dst, motion = make_pool(config, seed, dev)
    n, batch = src.shape[0], int(cell["batch"])
    if n % batch:
        raise ValueError(f"pool of {n} pairs is no multiple of the batch {batch}")
    intr = camera.Intrinsics(*cam)
    cfg = projective.ProjectiveIcpConfig(**icp)
    if cell["entry"] == "register_batch_chunked":
        def entry(s):
            return batched.register_batch_chunked(src[s : s + batch], dst[s : s + batch], intr, cfg,
                                                  chunk=int(cell["chunk"]))
    elif cell["entry"] == "register_batch":
        def entry(s):
            return batched.register_batch(src[s : s + batch], dst[s : s + batch], intr, cfg)
    else:
        raise ValueError(f"unknown entry {cell['entry']!r}")

    last = {}  # pool start -> the last (rmse, frac) of its pairs, on the device
    read = []  # (pool start, transforms read on the host)

    def call(k):
        s = (k * batch) % n
        res = entry(s)
        read.append((s, res.transform.cpu()))
        last[s] = (res.rmse, res.inlier_fraction)

    call(0)  # warm: builds the kernels on a checkout's first run, fills the allocator
    sync()
    read.clear()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    k, ends = 0, []
    while True:
        call(k)
        k += 1
        elapsed = time.perf_counter() - t0
        ends.append(elapsed)
        if elapsed >= seconds:
            break
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {cell["rate_metric"]: stats.rate(k * batch, elapsed), "setup_s": t0 - t_start}

    traced = None
    if trace:
        calls = int(cell["trace_calls"])

        def stretch():
            nonlocal k
            for _ in range(calls):
                call(k)
                k += 1

        win, logs = tracing.traced_recorded(stretch, records or {})
        traced = readers.Traced(win, calls * batch, config, logs,
                                {"call_s": [b - a for a, b in zip([0.0] + ends, ends)]})

    t_check = time.perf_counter()
    failed = sum(int((~torch.isfinite(T).all(-1).all(-1)).sum()) for _, T in read)
    attempted = sum(T.shape[0] for _, T in read)
    ref = reference_pairs.register_blocks(src, dst, cam, icp, dtype=getattr(torch, config["precision"]))
    rmse = torch.cat([last[s][0] for s in sorted(last)])
    frac = torch.cat([last[s][1] for s in sorted(last)])
    covered = torch.cat([torch.arange(s, s + batch, device=dev) for s in sorted(last)])
    ref_sub = (ref[0], ref[1][covered], ref[2][covered])
    numbers = compare(read, rmse, frac, ref_sub)
    limits = cell["limits"]
    return {
        "e2e": e2e, "attempted": attempted, "failed": failed, "memory_peak_bytes": memory_peak,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "traced": traced,
        "checks": [(name, value, limits[name]) for name, value in numbers],
        "info": {"calls": k, "window_s": elapsed, "check_s": time.perf_counter() - t_check,
                 "pairs_checked": int(covered.numel()),
                 "program_truth_gap": max(reference_pairs.truth_gap(T.to(dev), motion[s : s + batch])
                                          for s, T in read[-(n // batch):]),
                 "reference_truth_gap": reference_pairs.truth_gap(ref[0], motion)},
    }


def control(cell, config):
    """The reference in bfloat16 put in the program's place (the 6x6 solve
    and the pose products stay float32)."""
    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.parallel import batched

    cam, icp = scene.camera_of(config), icp_dict(config)

    def entry(src, dst, intr, cfg, *args, **kwargs):
        T, rmse, frac = reference_pairs.register_blocks(src, dst, cam, icp, dtype=torch.bfloat16)
        return projective.ProjectiveIcpResult(T, rmse, frac, torch.zeros_like(rmse, dtype=torch.int32))

    return hooks.patched(batched, register_batch=entry, register_batch_chunked=entry)


def _state_unchanged(cell, config):
    """Each association round returns the poses it was given."""
    from realsensetracker_tpu_torch.kernels import gn_step

    real, real_ref = gn_step.gn_round, gn_step.gn_round_reference

    def keep(real_fn):
        return lambda T, *a, **k: (T, real_fn(T, *a, **k)[1])

    return hooks.patched(gn_step, gn_round=keep(real), gn_round_reference=keep(real_ref))


def _half_batch(cell, config):
    """Each call registers the first half of its pairs and repeats those
    results for the rest."""
    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.parallel import batched

    real = batched.register_batch

    def entry(src, dst, intr, cfg=projective.ProjectiveIcpConfig()):
        h = src.shape[0] // 2
        res = real(src[:h], dst[:h], intr, cfg)
        return projective.ProjectiveIcpResult(*(torch.cat([x, x]) for x in res))

    return hooks.patched(batched, register_batch=entry)


def _answer_altered(cell, config):
    """The first pair of each call moves 5 mm along x."""
    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.parallel import batched

    real = batched.register_batch

    def entry(src, dst, intr, cfg=projective.ProjectiveIcpConfig()):
        res = real(src, dst, intr, cfg)
        T = res.transform.clone()
        T[0, 0, 3] += 0.005
        return res._replace(transform=T)

    return hooks.patched(batched, register_batch=entry)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch, "answer_altered": _answer_altered}
