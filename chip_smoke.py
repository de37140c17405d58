#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (realsensetracker_tpu_torch) once on one
NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and no
need for JAX. Phases, one JSON line each:

  1. device     -- the card (name and power limit from nvidia-smi); TF32 off.
  2. kernel     -- builds csrc/level_kernel.cu and holds the CUDA level
                   kernel against its plain torch version (atol 2e-5, the
                   validity pattern identical) at the four level shapes of a
                   640x480 frame (B=4) and at 482x64 and 36x128.
  3. register   -- register_batch on 64 pairs and register_batch_chunked on
                   1024 pairs (chunk 512) at 640x480 with the default
                   ProjectiveIcpConfig, against known twists.
  4. tracker    -- Tracker(method="projective") over a 30-frame 640x480
                   trajectory: every frame succeeds, ATE rmse < 0.02 m.
  5. timing     -- kernel vs plain version at B=512 per level shape, and
                   register_batch_chunked pairs/s on 2048 pairs, chunk 512.

Then the kernels line, and last {"ok": true, "device": {...}}. Any failed
check raises: the exit code is non-zero and the last line is not printed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

ATOL = 2e-5  # kernel vs plain version (tests/test_kernels.py:29)
TWIST_BAR_IDENTITY = 1e-4  # tests/test_projective_icp.py:65
TWIST_BAR_MOTION = 3e-3  # tests/test_projective_icp.py:81
ATE_BAR = 0.02  # meters, tests/test_tracking.py:40
REPLACES = "realsensetracker_tpu/kernels/level_kernel.py:42"
SOURCE = "realsensetracker_tpu_torch/csrc/level_kernel.cu"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")

    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.geometry import camera, se3
    from realsensetracker_tpu_torch.kernels import build, level_kernel
    from realsensetracker_tpu_torch.ops import pyramid
    from realsensetracker_tpu_torch.parallel import batched
    from realsensetracker_tpu_torch.tracking import trajectory

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit(
        "device", card=card, count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, capability=list(torch.cuda.get_device_capability(0)),
    )

    intr = camera.TUM_FR1
    cfg = projective.ProjectiveIcpConfig()
    num_levels = len(cfg.iters)
    level_intrs = pyramid.level_intrinsics(intr, num_levels)
    scene = synthetic.default_scene(seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def levels_of(depth):
        """Masked depth of each pyramid level, as build_pyramid feeds it to the kernel."""
        valid = camera.valid_mask(depth, cfg.min_depth, cfg.max_depth)
        d = torch.where(valid, depth, 0.0)
        out = []
        for _ in range(num_levels):
            out.append(d.contiguous())
            d, valid = pyramid.downsample_depth(d, valid)
        return out

    def holes(d, frac=0.05):
        mask = torch.rand(d.shape, generator=gen, device=dev) < frac
        return torch.where(mask, 0.0, d).contiguous()

    # ---- 2. kernel vs plain version -------------------------------------
    t0 = time.perf_counter()
    build.build(level_kernel.SOURCE)
    build_s = time.perf_counter() - t0
    log = (build.library_path(level_kernel.SOURCE).parent / "build.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, ptxas=ptxas)

    max_err = 0.0

    def compare(d, li):
        nonlocal max_err
        got = level_kernel.build_level_packed(d, li)
        ref = level_kernel.build_level_packed_reference(d, li)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        same_valid = torch.equal(got[:, :3].abs().sum(1) > 0, ref[:, :3].abs().sum(1) > 0)
        max_err = max(max_err, err)
        check(err <= ATOL, f"kernel vs plain at {tuple(d.shape)}: max abs err {err} > {ATOL}")
        check(same_valid, f"kernel vs plain at {tuple(d.shape)}: validity pattern differs")
        return {"shape": list(d.shape), "max_abs_err": err, "valid_frac": (ref[:, 2] != 0).float().mean().item()}

    poses4 = se3.exp(0.02 * torch.randn((4, 6), generator=gen, device=dev))
    frames4 = torch.stack([synthetic.render_depth(intr, T, scene) for T in poses4])
    cases = [compare(holes(d), li) for d, li in zip(levels_of(frames4), level_intrs)]
    for h, w, f in ((482, 64, 60.0), (36, 128, 50.0)):
        odd = camera.Intrinsics(fx=f, fy=f, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
        d = torch.stack([synthetic.render_depth(odd, T, scene) for T in poses4])
        cases.append(compare(holes(levels_of(d)[0]), odd))
    emit("kernel", atol=ATOL, cases=cases)

    # ---- 3. batched registration (main path) -----------------------------
    level_kernel.LAUNCHES = 0  # count only the main path's launches from here
    scale = torch.tensor([0.02, 0.02, 0.02, 0.015, 0.015, 0.015], device=dev)
    twists = (2 * torch.rand((64, 6), generator=gen, device=dev) - 1) * scale
    twists[0] = 0.0  # one identity pair
    truth = se3.exp(twists)
    dst = synthetic.render_depth(intr, se3.identity(device=dev), scene)[None].expand(64, -1, -1).contiguous()
    src = torch.stack([synthetic.render_depth(intr, T, scene) for T in truth])

    def twist_errors(T_est, T_true):
        err = se3.log(se3.compose(se3.inverse(T_true), T_est)).abs()
        return err[:, :3].amax(-1), err[:, 3:].amax(-1)

    def check_twists(res, T_true, identity_rows, what):
        t_err, r_err = twist_errors(res.transform, T_true)
        worst = torch.maximum(t_err, r_err)
        check(bool(torch.isfinite(res.transform).all()), f"{what}: non-finite transforms")
        check(worst[identity_rows].max().item() < TWIST_BAR_IDENTITY, f"{what}: identity pairs off")
        check(worst.max().item() < TWIST_BAR_MOTION, f"{what}: twist error {worst.max().item()}")
        return {"t_err_max": t_err.max().item(), "r_err_max": r_err.max().item(),
                "identity_err_max": worst[identity_rows].max().item(),
                "inlier_fraction_min": res.inlier_fraction.min().item(),
                "rmse_max": res.rmse.max().item()}

    before = level_kernel.LAUNCHES
    res64 = batched.register_batch(src, dst, intr, cfg)
    torch.cuda.synchronize()
    check(level_kernel.LAUNCHES - before == num_levels, "register_batch: one launch per level")
    acc64 = check_twists(res64, truth, torch.tensor([0]), "register_batch B=64")

    reps = 16
    src_big, dst_big, truth_big = src.repeat(reps, 1, 1), dst.repeat(reps, 1, 1), truth.repeat(reps, 1, 1)
    chunk = 512
    before = level_kernel.LAUNCHES
    res_big = batched.register_batch_chunked(src_big, dst_big, intr, cfg, chunk=chunk)
    torch.cuda.synchronize()
    chunks = src_big.shape[0] // chunk
    chunk_launches = level_kernel.LAUNCHES - before
    check(chunk_launches == num_levels * chunks, f"chunked: {chunk_launches} launches")
    for i in range(0, src_big.shape[0], chunk):
        part = batched.register_batch(src_big[i : i + chunk], dst_big[i : i + chunk], intr, cfg)
        for a, b in zip(res_big, part):
            check(torch.equal(a[i : i + chunk], b), f"chunk at {i} differs from register_batch")
    acc_big = check_twists(res_big, truth_big, torch.arange(0, 1024, 64), "register_batch_chunked B=1024")
    emit("register", pairs=64, accuracy_64=acc64, chunked_pairs=1024, chunk=chunk,
         chunked_launches=chunk_launches, accuracy_1024=acc_big,
         bars={"identity": TWIST_BAR_IDENTITY, "motion": TWIST_BAR_MOTION})

    # ---- 4. tracker facade (main path) -----------------------------------
    depths, poses_gt = synthetic.render_trajectory(intr, 30, seed=0, device=dev)
    tracker = Tracker(TrackerConfig(intrinsics=intr, method="projective", device="cuda"))
    before = level_kernel.LAUNCHES
    results, frame_ms = [], []
    for i in range(depths.shape[0]):
        t0 = time.perf_counter()
        results.append(tracker.process(depths[i], float(i)))  # ends in a host transfer
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    tracker_launches = level_kernel.LAUNCHES - before
    gt = trajectory.Trajectory()
    for i, T in enumerate(poses_gt.cpu().numpy()):
        gt.append(float(i), T)
    ate = trajectory.absolute_trajectory_error(tracker.trajectory, gt)
    check(all(r.success for r in results), "tracker: a frame failed")
    check(ate["rmse"] < ATE_BAR, f"tracker: ATE rmse {ate['rmse']} >= {ATE_BAR}")
    check(tracker_launches == num_levels * len(results), f"tracker: {tracker_launches} launches")
    main_path_launches = level_kernel.LAUNCHES
    check(main_path_launches > 0, "the main path never launched the level kernel")
    emit("tracker", frames=len(results), ate_rmse=ate["rmse"], ate_max=ate["max"],
         launches=tracker_launches, host_ms_per_frame_median=statistics.median(frame_ms[1:]),
         host_ms_per_frame_max=max(frame_ms[1:]), card=card)

    # ---- 5. timing (CUDA events, after warm-up) --------------------------
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    kernel_ms, plain_ms, per_level = 0.0, 0.0, []
    for d, li in zip(levels_of(dst_big[:chunk]), level_intrs):
        compare(d, li)
        run_k = lambda d=d, li=li: level_kernel.build_level_packed(d, li)  # noqa: E731
        run_p = lambda d=d, li=li: level_kernel.build_level_packed_reference(d, li)  # noqa: E731
        p1, k1, k2, p2 = time_ms(run_p, 3), time_ms(run_k, 20), time_ms(run_k, 20), time_ms(run_p, 3)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        kernel_ms, plain_ms = kernel_ms + k, plain_ms + p
        bytes_moved = d.numel() * 4 * 5  # 4 B of depth in, 16 B of plane table out
        per_level.append({"shape": list(d.shape), "kernel_ms": k, "plain_ms": p,
                          "kernel_GBps": bytes_moved / k / 1e6})
    emit("timing_kernel", batch=chunk, levels=per_level, kernel_ms_total=kernel_ms,
         plain_ms_total=plain_ms, card=card)

    base0, base1, _ = synthetic.render_pair(
        intr, torch.tensor([0.01, -0.005, 0.01, 0.005, -0.01, 0.005]), scene
    )
    del src_big, dst_big, res_big
    batch = 2048
    noise = lambda b: b + 0.001 * torch.randn((batch,) + b.shape, generator=gen, device=dev)  # noqa: E731
    bench_src, bench_dst = noise(base1), noise(base0)
    batched.register_batch_chunked(bench_src[:chunk], bench_dst[:chunk], intr, cfg, chunk=chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_iters = 3
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = batched.register_batch_chunked(bench_src, bench_dst, intr, cfg, chunk=chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(out.transform).all()), "bench workload: non-finite transforms")
    emit("timing_register", pairs=batch, chunk=chunk, iters=n_iters,
         pairs_per_s=batch * n_iters / dt, seconds=dt,
         peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9, card=card)

    print(json.dumps({"kernels": [{
        "name": "build_level_packed", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": main_path_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
