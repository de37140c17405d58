"""rs-capture: grab frames from a source and export point clouds as PLY.

Port of realsensetracker_tpu/cli/capture.py, itself a port of
basic_capture (basic_capture.cpp:8-53): N frames -> /tmp/%04d.ply. The
camera is replaced by the synthetic scene or an existing clip; the
vertices are unprojected on ``--device`` (default cuda). The port's scene
is not JAX's (synthetic.default_scene), so synthetic captures differ from
the JAX CLI's; a clip's captures agree.

Usage:
  python -m realsensetracker_tpu_torch.cli.capture --frames 10 --out "/tmp/{:04d}.ply"
  python -m realsensetracker_tpu_torch.cli.capture --device cpu --clip clip.rsc --out "/tmp/{:04d}.ply"
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-capture", description=__doc__)
    p.add_argument("--frames", type=int, default=100)  # basic_capture.cpp:32
    p.add_argument("--out", default="/tmp/{:04d}.ply")  # :45
    p.add_argument("--clip", default="", help="Use clip frames instead of synthetic")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device to unproject on (cuda or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from realsensetracker_tpu_torch import device as device_mod
    from realsensetracker_tpu_torch.geometry import camera
    from realsensetracker_tpu_torch.ops.pyramid import build_pyramid
    from realsensetracker_tpu_torch.vis import export_ply

    dev = device_mod.resolve(args.device)
    if args.clip:
        from realsensetracker_tpu_torch.data import recorded

        clip = recorded.read_clip(args.clip)
        intr = clip.intrinsics
        depths = clip.depths[: args.frames]
    else:
        from realsensetracker_tpu_torch.data import synthetic

        intr = camera.TUM_DEFAULT
        depths, _ = synthetic.render_trajectory(intr, args.frames, seed=args.seed, device=dev)

    for i in range(len(depths)):
        d = torch.as_tensor(depths[i], dtype=torch.float32).to(dev)[None]
        # No normals: only vertex_map/vertex_valid are read below.
        levels, _ = build_pyramid(d, intr, 1, with_normals=False)
        pts = levels[0].vertex_map.reshape(-1, 3).cpu().numpy()
        ok = levels[0].vertex_valid.reshape(-1).cpu().numpy()
        path = args.out.format(i)
        export_ply(path, pts[ok])
        print(f"frame {i}: {int(ok.sum())} points -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
