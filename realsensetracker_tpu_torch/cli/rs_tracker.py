"""rs-tracker: continuous tracker demo on a hardware-free source.

Port of realsensetracker_tpu/cli/rs_tracker.py, the rs_tracker prototype
app (rs_tracker.cpp:33-116): a loop pulling frames from a fake source (the
raycast scene, rendered on the device), registering consecutive frames
(GICP in the reference; selectable here), and printing the pose as
quaternion|translation like the reference's operator<< (rs_tracker.cpp:28-31).
The scene is the port's (synthetic.default_scene), so the printed poses
are not the JAX app's.

Usage:
  python -m realsensetracker_tpu_torch.cli.rs_tracker --frames 20 --method gicp
  python -m realsensetracker_tpu_torch.cli.rs_tracker --device cpu --frames 5
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-tracker", description=__doc__)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--method", default="gicp",
                   choices=["projective", "keyframe", "icp", "gicp"])
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--voxel-size", type=float, default=0.1)  # rs_tracker.cpp:79
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device to track on (cuda or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from realsensetracker_tpu_torch import device as device_mod
    from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.geometry import camera, se3

    dev = device_mod.resolve(args.device)
    intr = camera.Intrinsics(
        fx=args.width * 0.8, fy=args.width * 0.8,
        cx=(args.width - 1) / 2, cy=(args.height - 1) / 2,
        width=args.width, height=args.height,
    )
    depths, _ = synthetic.render_trajectory(intr, args.frames, seed=args.seed, device=dev)
    cfg = TrackerConfig(intrinsics=intr, method=args.method, device=str(dev))
    cfg.align.voxel_size = args.voxel_size
    cfg.align.cloud_capacity = 4096
    cfg.gicp.max_outer = 8
    tracker = Tracker(cfg)

    for i in range(args.frames):
        res = tracker.process(depths[i], float(i))
        T = torch.as_tensor(res.pose).cpu().to(torch.float32)
        q = se3.quaternion_from_matrix(T[:3, :3]).tolist()
        t = T[:3, 3].tolist()
        # Reference pose print format: quaternion | translation
        # (rs_tracker.cpp:28-31).
        print(f"frame {i:3d} [{'ok' if res.success else 'FAIL'}] "
              f"q=({q[0]:+.4f},{q[1]:+.4f},{q[2]:+.4f},{q[3]:+.4f}) | "
              f"t=({t[0]:+.4f},{t[1]:+.4f},{t[2]:+.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
