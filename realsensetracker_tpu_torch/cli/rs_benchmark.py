"""rs-benchmark: throughput/latency benchmark CLI.

Port of realsensetracker_tpu/cli/rs_benchmark.py: registered pairs/sec for
any pipeline at any batch size and resolution, or frames/sec for the
streaming SLAM and dense pipelines, printed as one JSON line with the JAX
CLI's keys. ``--device`` (default cuda) picks the card or the CPU.

Timing: a warm-up call, then ``--iters`` calls on the same inputs, each
ended by a device synchronize (the JAX CLI's per-call host read). CUDA
memoizes nothing, so the JAX CLI's per-call input salt is not ported.

Batching: ``projective-icp`` registers the batch in one call
(parallel.batched.register_batch, or register_batch_chunked with
``--chunk``), and ``rgbd`` in one batched register_rgbd_pair, the
per-pair results of B separate calls. JAX vmaps ``gnc-icp`` and ``gicp``
over the batch; the port's align_icp and align_gicp take one pair, so
those two loop over the B pairs.

Usage:
  python -m realsensetracker_tpu_torch.cli.rs_benchmark --batch 64 --iters 10
  python -m realsensetracker_tpu_torch.cli.rs_benchmark --pipeline gnc-icp --points 4096
  python -m realsensetracker_tpu_torch.cli.rs_benchmark --device cpu --width 80 --height 60 --batch 2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np

# The relative camera motion of the projective pipeline's frame pair.
PAIR_TWIST = (0.01, -0.005, 0.01, 0.005, -0.01, 0.005)
NOISE_BLOCK = 256  # frames of host noise drawn and uploaded at a time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-benchmark", description=__doc__)
    p.add_argument("--pipeline", default="projective-icp")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--points", type=int, default=4096, help="cloud pipelines")
    # Flagship schedule (BENCHMARKS.md): coarse -> fine association rounds.
    p.add_argument("--level-iters", default="3,3,3,2")
    p.add_argument("--inner-iters", type=int, default=2,
                   help="GN updates per association (gathers once per round)")
    p.add_argument("--chunk", type=int, default=0,
                   help="register the batch as a loop of chunks of this size "
                        "(0 = one batch); bounds the device working set")
    p.add_argument("--window", type=int, default=8,
                   help="slam-window pipeline: frames scanned per dispatch")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="capture a torch.profiler trace of the timed region "
                        "into DIR/trace.json (chrome://tracing, Perfetto)")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda or cpu)")
    return p


def intrinsics(width: int, height: int):
    from realsensetracker_tpu_torch.geometry import camera

    return camera.Intrinsics(
        fx=width * 0.8, fy=width * 0.8,
        cx=(width - 1) / 2, cy=(height - 1) / 2,
        width=width, height=height,
    )


def _noisy(base, batch: int, rng: np.random.RandomState):
    """(B, H, W) copies of the (H, W) device frame ``base``, each plus its
    own 1 mm Gaussian noise drawn on the host from ``rng`` (the JAX CLI's
    numbers, drawn NOISE_BLOCK frames at a time to bound the host peak)."""
    import torch

    out = torch.empty((batch,) + tuple(base.shape), dtype=torch.float32, device=base.device)
    for i in range(0, batch, NOISE_BLOCK):
        n = min(NOISE_BLOCK, batch - i)
        block = 0.001 * rng.randn(n, *base.shape).astype(np.float32)
        out[i:i + n] = base[None] + torch.from_numpy(block).to(base.device)
    return out


def projective_inputs(batch: int, width: int, height: int, device):
    """The projective-icp pipeline's inputs on ``device``: (intr, src
    (B, H, W), dst (B, H, W), T_true (4, 4)). A frame pair of the port's
    default scene rendered at PAIR_TWIST, each side repeated B times with
    per-pair noise from RandomState(0), src first; T_true is the
    src-to-dst transform a registration should find."""
    import torch

    from realsensetracker_tpu_torch.data import synthetic

    intr = intrinsics(width, height)
    rng = np.random.RandomState(0)
    scene = synthetic.default_scene(device=device)
    d0, d1, T_true = synthetic.render_pair(intr, torch.tensor(PAIR_TWIST, dtype=torch.float32), scene)
    return intr, _noisy(d1, batch, rng), _noisy(d0, batch, rng), T_true


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_calls(step, iters: int, dev, traced) -> float:
    """Seconds for ``iters`` calls of ``step`` after one warm-up call, a
    device synchronize after each."""
    step()
    _sync(dev)
    with traced():
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
            _sync(dev)
        return time.perf_counter() - t0


def _time_stream(tracker, frames, win: int, dev, traced) -> tuple[int, float]:
    """(timed frames, seconds) of a streaming tracker over ``frames``: per
    frame process() (win 0) or process_window() ``win`` frames at a time.
    The warm-up covers the seed frame AND the first tracked step (at least
    2 frames), so neither lands in the timed region, which ends with a
    synchronize."""

    def run(fr, base):
        ts = [float(base + i) / 30.0 for i in range(len(fr))]
        if win:
            tracker.process_window(fr, ts, window=win)
        else:
            for f, t in zip(fr, ts):
                tracker.process(f, t)

    skip = min(2 * max(win, 1), max(len(frames) // 4, 2))
    run(frames[:skip], 0)
    _sync(dev)
    with traced():
        t0 = time.perf_counter()
        run(frames[skip:], skip)
        _sync(dev)
        return len(frames) - skip, time.perf_counter() - t0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    pipelines = ("projective-icp", "rgbd", "gnc-icp", "gicp", "slam", "slam-window", "tsdf", "tsdf-window")
    if args.pipeline not in pipelines:
        raise SystemExit(f"unsupported pipeline for benchmarking: {args.pipeline}")
    import torch

    from realsensetracker_tpu_torch import device as device_mod
    from realsensetracker_tpu_torch.data import synthetic

    dev = device_mod.resolve(args.device)
    intr = intrinsics(args.width, args.height)
    rng = np.random.RandomState(0)

    def traced():
        # Wraps ONLY the timed region (after the warm-up) so the trace
        # shows steady-state device work, not kernel builds.
        if args.profile:
            from realsensetracker_tpu_torch.utils.profiling import device_trace

            return device_trace(args.profile)
        return contextlib.nullcontext()

    if args.pipeline == "projective-icp":
        from realsensetracker_tpu_torch.align import projective
        from realsensetracker_tpu_torch.parallel import batched

        iters = tuple(int(x) for x in args.level_iters.split(","))
        cfg = projective.ProjectiveIcpConfig(iters=iters, inner_iters=args.inner_iters, samples=args.samples)
        _, src, dst, _ = projective_inputs(args.batch, args.width, args.height, dev)
        if args.chunk > 0:
            def step():
                return batched.register_batch_chunked(src, dst, intr, cfg, args.chunk).transform
        else:
            def step():
                return batched.register_batch(src, dst, intr, cfg).transform
        dt = _time_calls(step, args.iters, dev, traced)
    elif args.pipeline == "rgbd":
        from realsensetracker_tpu_torch.align import rgbd as rgbd_mod

        cfg = rgbd_mod.RgbdIcpConfig(samples=args.samples)
        ds, cs, _ = synthetic.render_trajectory_rgbd(intr, 2, device=dev)
        g0 = synthetic.intensity_from_rgb(cs[0])
        g1 = synthetic.intensity_from_rgb(cs[1])
        src = _noisy(ds[1], args.batch, rng)
        dst = _noisy(ds[0], args.batch, rng)
        gs = g1.expand((args.batch,) + tuple(g1.shape))
        gd = g0.expand((args.batch,) + tuple(g0.shape))

        def step():
            return rgbd_mod.register_rgbd_pair(src, gs, dst, gd, intr, cfg).transform

        dt = _time_calls(step, args.iters, dev, traced)
    elif args.pipeline in ("gnc-icp", "gicp"):
        from realsensetracker_tpu_torch.align import gicp as gicp_mod
        from realsensetracker_tpu_torch.align import icp as icp_mod
        from realsensetracker_tpu_torch.ops import cloud as cloud_mod

        if args.pipeline == "gnc-icp":
            def one(s, d):
                return icp_mod.align_icp(cloud_mod.from_points(s), cloud_mod.from_points(d), 128).transform
        else:
            def one(s, d):
                return gicp_mod.align_gicp(cloud_mod.from_points(s), cloud_mod.from_points(d)).transform
        src = torch.from_numpy(rng.randn(args.batch, args.points, 3).astype(np.float32)).to(dev)
        dst = src + 0.01

        def step():
            return torch.stack([one(src[b], dst[b]) for b in range(args.batch)])

        dt = _time_calls(step, args.iters, dev, traced)
    elif args.pipeline in ("slam", "slam-window"):
        # Streaming SLAM frames/sec over a synthetic trajectory: --batch
        # frames, per-frame process() ("slam") or --window frames per
        # process_window call ("slam-window"). Every call reads its stats
        # on the host; the timed region ends with a synchronize.
        from realsensetracker_tpu_torch.tracking.slam import SlamConfig, SlamTracker

        win = args.window if args.pipeline == "slam-window" else 0
        depths, _ = synthetic.render_trajectory(intr, args.batch, seed=0, device=dev)
        tracker = SlamTracker(SlamConfig(intrinsics=intr, device=str(dev)))
        n_timed, dt = _time_stream(tracker, [depths[i] for i in range(args.batch)], win, dev, traced)
        # Single-device program: the per-chip rate IS the measured rate.
        print(json.dumps({
            "pipeline": args.pipeline,
            "frames": args.batch,
            "window": win,
            "resolution": f"{args.width}x{args.height}",
            "frames_per_sec_per_chip": round(n_timed / dt, 2),
            "ms_per_frame": round(1000 * dt / max(n_timed, 1), 2),
            "keyframes": tracker.keyframe_count,
        }))
        return 0
    else:  # tsdf, tsdf-window
        # Dense frame-to-model frames/sec: the KinectFusion loop over a
        # synthetic trajectory of host frames, per-frame process() ("tsdf")
        # or --window frames per process_window call ("tsdf-window").
        from realsensetracker_tpu_torch.mapping.tsdf import TsdfConfig
        from realsensetracker_tpu_torch.tracking.tsdf_tracker import TsdfTracker

        win = args.window if args.pipeline == "tsdf-window" else 0
        depths, _ = synthetic.render_trajectory(
            intr, args.batch, scene=synthetic.default_scene(seed=3, device=dev), seed=0, step_scale=0.008,
        )
        frames = [d.cpu().numpy() for d in depths]
        # c2f render (the production path) when the resolution allows it.
        coarse = 4 if (args.height % 4 == 0 and args.width % 4 == 0) else 1
        tracker = TsdfTracker(intr, volume=TsdfConfig(raycast_coarse=coarse), device=dev)
        n_timed, dt = _time_stream(tracker, frames, win, dev, traced)
        print(json.dumps({
            "pipeline": args.pipeline,
            "frames": args.batch,
            "window": win,
            "resolution": f"{args.width}x{args.height}",
            "volume": f"{tracker.volume.resolution}^3",
            "raycast_coarse": coarse,
            "frames_per_sec_per_chip": round(n_timed / dt, 2),
            "ms_per_frame": round(1000 * dt / max(n_timed, 1), 2),
        }))
        return 0

    per_pair = args.batch * args.iters / dt
    # Single-device program: the per-chip rate IS the measured rate.
    print(json.dumps({
        "pipeline": args.pipeline,
        "batch": args.batch,
        "resolution": f"{args.width}x{args.height}",
        "pairs_per_sec_per_chip": round(per_pair, 2),
        "ms_per_batch": round(1000 * dt / args.iters, 2),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
