"""rs-view-clouds: render saved xyzrgb/ply clouds to PNG.

Port of realsensetracker_tpu/cli/view_clouds.py, itself a port of the
viewer app (view_xyzrgb.cpp:14-63): loops over numbered /tmp/%04d.xyzrgb
files and renders them -- here to PNG images. Also reads the reference's
recorded .pb clouds (pattern ending in .pb; see data.pb_interop for the
schema-free best-effort parser). Host code only: no device, no tensors.
The renders need matplotlib, imported when the first cloud is drawn.

Usage:
  python -m realsensetracker_tpu_torch.cli.view_clouds --pattern "/tmp/{:04d}.xyzrgb" \\
      --frames 100 --out-dir /tmp/views
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-view-clouds", description=__doc__)
    p.add_argument("--pattern", default="/tmp/{:04d}.xyzrgb")  # view_xyzrgb.cpp:44
    p.add_argument("--frames", type=int, default=100)  # :43
    p.add_argument("--out-dir", default="/tmp/cloud_views")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from realsensetracker_tpu_torch.vis import load_xyzrgb, render_cloud_png

    os.makedirs(args.out_dir, exist_ok=True)
    count = 0
    for i in range(args.frames):
        path = args.pattern.format(i)
        if not os.path.exists(path):
            continue
        if path.endswith(".pb"):
            from realsensetracker_tpu_torch.data import pb_interop

            pts, cols = pb_interop.read_pb_cloud(path)
            if cols is None:
                cols = np.full((len(pts), 3), 0.5, np.float32)
        else:
            pts, cols = load_xyzrgb(path)
        if len(pts) == 0:
            # Empty/xyz-only file: skip it instead of crashing the loop
            # (cols.max() on a zero-length array raises).
            print(f"skipping empty cloud: {path}")
            continue
        out = os.path.join(args.out_dir, f"view_{i:04d}.png")
        render_cloud_png(out, [(pts, cols / 255.0 if cols.max() > 1 else cols)])
        count += 1
    print(f"rendered {count} clouds -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
