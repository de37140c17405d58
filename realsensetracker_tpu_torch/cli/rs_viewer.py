"""rs-viewer: capture/record/view frames (headless).

Port of realsensetracker_tpu/cli/rs_viewer.py: rs_viewer_app
(rs_viewer_app.cpp:26-58) + the viewer loop's record path
(rs_viewer.cpp:105-112). With no camera hardware, the capture source is
the synthetic raycast scene or an existing clip; frames can be recorded to
.rsc and/or rendered to PNGs, and --ply-dir unprojects each frame on
``--device`` (default cuda). The live loop (--loop, --serve, --live-latest)
renders on the host from a paced FrameStream. The port's scene is not
JAX's (synthetic.default_scene), so synthetic recordings differ from the
JAX CLI's; the files are the same format both ways.

Usage:
  python -m realsensetracker_tpu_torch.cli.rs_viewer --record /tmp/clip.rsc --frames 60
  python -m realsensetracker_tpu_torch.cli.rs_viewer --view clip.rsc --render-dir /tmp/out
  python -m realsensetracker_tpu_torch.cli.rs_viewer --device cpu --view clip.rsc --ply-dir /tmp/ply
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-viewer", description=__doc__)
    p.add_argument("--record", "-r", default="",
                   help="Record synthetic capture to this .rsc file")
    p.add_argument("--frame-interval", "-f", type=float, default=0.0,
                   help="Frame interval in ms (ref default 1000)")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--color", action="store_true",
                   help="Record RGB-D (v2 clip with a color plane)")
    p.add_argument("--view", default="", help="View an existing .rsc clip")
    p.add_argument("--render-dir", default="", help="Write depth PNGs here")
    p.add_argument("--ply-dir", default="",
                   help="Export per-frame (colored) PLY clouds here")
    p.add_argument("--loop", action="store_true",
                   help="Run the live viewer Loop (rs_viewer.cpp:67-117): "
                        "poll source -> render fresh frames -> sleep "
                        "interval/8 when stale -> optionally record")
    p.add_argument("--serve", type=int, default=-1, metavar="PORT",
                   help="Serve the live view over HTTP (0 = auto port); "
                        "GET / is a self-refreshing page, /stream a "
                        "multipart live stream. Implies --loop.")
    p.add_argument("--live-latest", default="", metavar="PNG",
                   help="Atomically refresh this PNG with the latest frame "
                        "(file-watcher live view). Implies --loop.")
    p.add_argument("--device", default="cuda", help="torch device for the stream and --ply-dir (cuda or cpu)")
    return p


def _live_loop(args, dev) -> int:
    """The reference viewer's Loop + record semantics (rs_viewer.cpp:67-117)
    over a paced FrameStream: the producer thread rate-limits frames like
    RsDriver (rs_driver.cpp:196), the loop polls, renders fresh
    frames to the HTTP/live-file view, sleeps interval/8 when stale, and
    records every shown frame (:105-112)."""
    from realsensetracker_tpu_torch.data import recorded
    from realsensetracker_tpu_torch.data import stream as stream_mod
    from realsensetracker_tpu_torch.geometry import camera as camera_mod
    from realsensetracker_tpu_torch.vis import live

    if args.view:
        clip = recorded.read_clip(args.view)
        depths = np.asarray(clip.depths)
        stamps = np.asarray(clip.timestamps)
        intr = clip.intrinsics
    else:
        from realsensetracker_tpu_torch.data import synthetic

        w, h = args.width, args.height
        intr = camera_mod.Intrinsics(fx=w * 0.8, fy=w * 0.8, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
        d, _ = synthetic.render_trajectory(intr, args.frames, seed=args.seed, device=dev)
        depths = d.cpu().numpy()
        stamps = np.arange(len(depths), dtype=np.float64) / 30.0

    interval_s = args.frame_interval / 1000.0
    stream = stream_mod.FrameStream(
        ((stamps[i], depths[i]) for i in range(len(depths))),
        transfer=lambda x: x,  # host-side rendering; no device staging
        min_interval_s=interval_s,
        device=dev,
    )
    for flag in ("render_dir", "ply_dir"):
        if getattr(args, flag, ""):
            print(f"note: --{flag.replace('_', '-')} applies to the "
                  "non-loop path and is ignored in live/loop mode", file=sys.stderr)
    if args.color:
        print("note: live/loop mode renders and records depth only; "
              "--color is ignored here", file=sys.stderr)
    server = live.LiveServer(port=args.serve) if args.serve >= 0 else None
    if server is not None:
        print(f"live view: http://127.0.0.1:{server.port}/")
    # Frames are retained ONLY when recording (a live view of a long clip
    # would otherwise hold every shown frame in memory for a counter).
    shown_frames: list = []
    counter = [0]
    t0 = time.monotonic()

    def on_frame(ts, depth):
        png = live.encode_png(live.depth_to_rgb(depth))
        elapsed = max(time.monotonic() - t0, 1e-6)
        status = {"frame": counter[0], "timestamp": float(ts), "fps": round((counter[0] + 1) / elapsed, 2)}
        if server is not None:
            server.update(png, status)
        if args.live_latest:
            live.write_latest_png(args.live_latest, png)
        if args.record:
            shown_frames.append((ts, depth))
        counter[0] += 1

    # --frames sizes SYNTHETIC capture; viewing a clip plays it to the end
    # (the reference Loop runs until the source ends, rs_viewer.cpp:67-117).
    cap = len(depths) if args.view else args.frames
    try:
        shown = live.viewer_loop(stream, on_frame, frame_interval_s=interval_s, max_frames=cap)
    finally:
        stream.close()
    if args.record and shown_frames:
        recorded.write_clip(
            args.record,
            np.stack([d for _, d in shown_frames]),
            np.asarray([t for t, _ in shown_frames], np.float64),
            intr,
        )
        print(f"recorded {len(shown_frames)} frames -> {args.record}")
    print(f"live loop: {shown} frames shown")
    if server is not None:
        server.close()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from realsensetracker_tpu_torch import device as device_mod
    from realsensetracker_tpu_torch.data import recorded

    dev = device_mod.resolve(args.device)
    if args.loop or args.serve >= 0 or args.live_latest:
        return _live_loop(args, dev)
    if args.record:
        clip = recorded.record_synthetic_clip(
            args.record, num_frames=args.frames, seed=args.seed,
            width=args.width, height=args.height, with_color=args.color,
        )
        tag = "RGB-D" if clip.has_color else "depth"
        print(f"recorded {len(clip)} {tag} frames -> {args.record}")
    if args.view:
        clip = recorded.read_clip(args.view)
        tag = "RGB-D" if clip.has_color else "depth"
        print(f"{args.view}: {len(clip)} {tag} frames {clip.depths.shape[1:]} "
              f"intr=({clip.intrinsics.fx:.1f},{clip.intrinsics.fy:.1f},"
              f"{clip.intrinsics.cx:.1f},{clip.intrinsics.cy:.1f})")
        if args.render_dir:
            from realsensetracker_tpu_torch.vis import render_depth_png

            os.makedirs(args.render_dir, exist_ok=True)
            for i in range(len(clip)):
                render_depth_png(os.path.join(args.render_dir, f"depth_{i:04d}.png"), clip.depths[i])
            print(f"rendered {len(clip)} PNGs -> {args.render_dir}")
        if args.ply_dir:
            # Colored-cloud export: the reference viewer's colored rendering
            # (rs_viewer.cpp:90-100) as per-frame PLY files.
            import torch

            from realsensetracker_tpu_torch.geometry import camera as camera_mod
            from realsensetracker_tpu_torch.vis import export_ply

            os.makedirs(args.ply_dir, exist_ok=True)
            for i in range(len(clip)):
                d = torch.as_tensor(clip.depths[i], dtype=torch.float32).to(dev)
                verts = camera_mod.unproject_depth(d, clip.intrinsics).cpu().numpy()
                ok = np.asarray(clip.depths[i] > 0).reshape(-1)
                pts = verts.reshape(-1, 3)[ok]
                cols = None
                if clip.has_color:
                    cols = clip.colors[i].reshape(-1, 3)[ok].astype(np.float32) / 255.0
                export_ply(os.path.join(args.ply_dir, f"cloud_{i:04d}.ply"), pts, cols)
            print(f"exported {len(clip)} PLY clouds -> {args.ply_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
