"""rs-streams: concurrent multi-stream tracking demo (BASELINE config 5).

Port of realsensetracker_tpu/cli/rs_streams.py: tracks S independent depth
streams, one batched step per frame-tick (parallel/streams.py), and
reports aggregate and per-stream FPS -- the "8 concurrent streams at 30
FPS each with live pose output" configuration. ``--rgb`` switches every
stream to the joint point-to-plane + photometric objective
(step_streams_masked_rgbd[_window]); ``--tsdf`` makes each stream a dense
KinectFusion tracker with its own volume (step_tsdf_streams[_window]).
Flags and printed lines are the JAX CLI's; ``--device`` (default cuda)
picks the card or the CPU.

The timed loop keeps every result on the device and ends with one host
read of the streams' poses; the per-frame lines are printed after it.

Usage:
  python -m realsensetracker_tpu_torch.cli.rs_streams --streams 8 --frames 30
  python -m realsensetracker_tpu_torch.cli.rs_streams --device cpu --streams 2 --frames 4 --width 64 --height 48
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rs-streams", description=__doc__)
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--window", type=int, default=0,
                   help="advance W frames per step call (S x W frames per "
                        "call, the state on the device; 0 = one call per frame)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--rgb", action="store_true",
                   help="RGB-D streams: joint point-to-plane + photometric "
                        "odometry per stream (parallel/streams "
                        "step_streams_masked_rgbd[_window])")
    p.add_argument("--tsdf", action="store_true",
                   help="dense streams: each slot is a KinectFusion "
                        "frame-to-model tracker with its own TSDF volume "
                        "(parallel/streams step_tsdf_streams[_window])")
    p.add_argument("--tsdf-resolution", type=int, default=128,
                   help="--tsdf: voxels per axis per stream volume "
                        "(device memory = streams * 2 * V^3 * 4 bytes)")
    p.add_argument("--tsdf-voxel", type=float, default=0.04,
                   help="--tsdf: voxel edge length in meters")
    p.add_argument("--print-poses", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device to track on (cuda or cpu)")
    return p


def _slice_windows(frames, win: int) -> list:
    """(F, S, H, W) device frames -> pre-sliced full windows (S, W, H, W)."""
    usable = ((frames.shape[0] - 1) // win) * win
    return [frames[1 + k : 1 + k + win].movedim(0, 1).contiguous() for k in range(0, usable, win)]


def _render_streams(args, intr, dev, rgb: bool):
    """Each stream's own scene and walk: (F, S, H, W) depths on ``dev``,
    and with ``rgb`` the (F, S, H, W) intensities too."""
    import torch

    from realsensetracker_tpu_torch.data import synthetic

    depths, grays = [], []
    for i in range(args.streams):
        scene = synthetic.default_scene(seed=40 + i, device=dev)
        if rgb:
            d, c, _ = synthetic.render_trajectory_rgbd(intr, args.frames, scene=scene, seed=i, step_scale=0.01)
            grays.append(synthetic.intensity_from_rgb(torch.as_tensor(c).to(dev)))
        else:
            d, _ = synthetic.render_trajectory(intr, args.frames, scene=scene, seed=i, step_scale=0.01)
        depths.append(torch.as_tensor(d).to(dev))
    depths = torch.stack(depths, dim=1)
    return (depths, torch.stack(grays, dim=1)) if rgb else depths


class _DepthMode:
    """step_streams / step_streams_window over synthetic depth streams."""

    label = "streams"

    def __init__(self, args, intr, dev):
        from realsensetracker_tpu_torch.parallel import streams

        self._streams, self._intr = streams, intr
        print(f"rendering {args.streams} x {args.frames} synthetic frames ...")
        self.depths = _render_streams(args, intr, dev, rgb=False)  # (F, S, H, W)
        self.state = streams.init_streams(self.depths[0], intr)

    def warm(self, win: int) -> None:
        # One step (or window) of frame 0 against itself, discarded. Window
        # inputs are pre-sliced here so the timed loop measures stepping,
        # not (F, S, ...) -> (S, W, ...) copies.
        st = self._streams
        if win:
            self._windows = _slice_windows(self.depths, win)
            warm = self.depths[0][:, None].repeat(1, win, 1, 1)
            state_w, _ = st.step_streams_window(self.state, warm, self._intr)
        else:
            state_w, _ = st.step_streams(self.state, self.depths[0], self._intr)
        state_w.poses.cpu()

    def step(self, f: int):
        self.state, res = self._streams.step_streams(self.state, self.depths[f], self._intr)
        return res

    def step_window(self, k: int, win: int) -> list:
        self.state, res = self._streams.step_streams_window(self.state, self._windows[k // win], self._intr)
        # Unstack (S, W, ...) window results into per-frame records.
        return [self._streams.StreamStepResult(*(x[:, j] for x in res)) for j in range(win)]

    @staticmethod
    def success_of(rec):
        return rec.success.cpu().numpy()

    @staticmethod
    def poses_of(rec):
        return rec.poses.cpu().numpy()


class _RgbdMode:
    """Masked RGB-D steps over synthetic depth+intensity streams; records
    are (S, MASKED_RGBD_STATS_WIDTH) stats rows."""

    label = "RGB-D streams"

    def __init__(self, args, intr, dev):
        import torch

        from realsensetracker_tpu_torch.parallel import streams

        self._streams, self._intr = streams, intr
        s = args.streams
        print(f"rendering {s} x {args.frames} synthetic RGB-D frames ...")
        self.depths, self.grays = _render_streams(args, intr, dev, rgb=True)  # (F, S, H, W) each
        self._ones = torch.ones((s,), dtype=torch.bool, device=dev)
        self._zeros = torch.zeros((s,), dtype=torch.bool, device=dev)
        self.state = streams.blank_streams_rgbd(intr, num_streams=s, device=dev)

    def warm(self, win: int) -> None:
        # Seeding every slot on frame 0 doubles as the single-step warm-up.
        import torch

        st = self._streams
        self.state, _ = st.step_streams_masked_rgbd(
            self.state, self.depths[0], self.grays[0], self._ones, self._ones, self._intr,
        )
        self.state.poses.cpu()
        if win:
            s, dev = self.depths.shape[1], self.depths.device
            self._aw = torch.ones((s, win), dtype=torch.bool, device=dev)
            self._sw = torch.zeros((s, win), dtype=torch.bool, device=dev)
            self._dwin = _slice_windows(self.depths, win)
            self._gwin = _slice_windows(self.grays, win)
            warm_d = self.depths[0][:, None].repeat(1, win, 1, 1)
            warm_g = self.grays[0][:, None].repeat(1, win, 1, 1)
            st_w, _ = st.step_streams_masked_rgbd_window(self.state, warm_d, warm_g, self._aw, self._sw, self._intr)
            st_w.poses.cpu()  # window warm-up (discarded)

    def step(self, f: int):
        self.state, stats = self._streams.step_streams_masked_rgbd(
            self.state, self.depths[f], self.grays[f], self._ones, self._zeros, self._intr,
        )
        return stats

    def step_window(self, k: int, win: int) -> list:
        self.state, stats = self._streams.step_streams_masked_rgbd_window(
            self.state, self._dwin[k // win], self._gwin[k // win], self._aw, self._sw, self._intr,
        )
        return [stats[:, j] for j in range(win)]

    @staticmethod
    def success_of(rec):
        return rec[:, 32].cpu().numpy() > 0.5

    @staticmethod
    def poses_of(rec):
        return rec[:, :16].reshape(-1, 4, 4).cpu().numpy()


class _TsdfMode:
    """Dense streams: S per-slot TSDF volumes advanced by
    step_tsdf_streams[_window]; records are StreamStepResult."""

    label = "dense (TSDF) streams"

    def __init__(self, args, intr, dev):
        from realsensetracker_tpu_torch.mapping.tsdf import TsdfConfig
        from realsensetracker_tpu_torch.parallel import streams

        self._streams, self._intr = streams, intr
        res, vox = args.tsdf_resolution, args.tsdf_voxel
        extent = res * vox
        self._cfg = TsdfConfig(
            resolution=res, voxel_size=vox,
            origin=(-extent / 2, -extent / 2, -0.109375 * extent),
            trunc=max(3.0 * vox, 0.1),
            raycast_coarse=4 if (intr.height % 4 == 0 and intr.width % 4 == 0) else 1,
        )
        print(f"rendering {args.streams} x {args.frames} synthetic frames ({res}^3 volume per stream) ...")
        self.depths = _render_streams(args, intr, dev, rgb=False)  # (F, S, H, W)
        self.state = streams.init_tsdf_streams(self.depths[0], intr, self._cfg)

    def warm(self, win: int) -> None:
        # The volumes update in place: warm up on a copy, discarded.
        from realsensetracker_tpu_torch.mapping.tsdf import clone_volume

        st = self._streams
        copy = self.state._replace(volume=clone_volume(self.state.volume))
        if win:
            self._windows = _slice_windows(self.depths, win)
            warm = self.depths[0][:, None].repeat(1, win, 1, 1)
            state_w, _ = st.step_tsdf_streams_window(copy, warm, self._intr, self._cfg)
        else:
            state_w, _ = st.step_tsdf_streams(copy, self.depths[0], self._intr, self._cfg)
        state_w.poses.cpu()

    def step(self, f: int):
        self.state, res = self._streams.step_tsdf_streams(self.state, self.depths[f], self._intr, self._cfg)
        return res

    def step_window(self, k: int, win: int) -> list:
        self.state, res = self._streams.step_tsdf_streams_window(
            self.state, self._windows[k // win], self._intr, self._cfg
        )
        return [self._streams.StreamStepResult(*(x[:, j] for x in res)) for j in range(win)]

    success_of = staticmethod(_DepthMode.success_of)
    poses_of = staticmethod(_DepthMode.poses_of)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from realsensetracker_tpu_torch import device as device_mod
    from realsensetracker_tpu_torch.geometry import camera

    if args.rgb and args.tsdf:
        print("--rgb and --tsdf are mutually exclusive", file=sys.stderr)
        return 1
    dev = device_mod.resolve(args.device)
    intr = camera.Intrinsics(
        fx=args.width * 0.8, fy=args.width * 0.8,
        cx=(args.width - 1) / 2, cy=(args.height - 1) / 2,
        width=args.width, height=args.height,
    )
    s = args.streams
    mode_cls = _RgbdMode if args.rgb else _TsdfMode if args.tsdf else _DepthMode
    mode = mode_cls(args, intr, dev)
    win = max(0, args.window)
    # The trailing (frames-1) % W steps run per frame: dropping them would
    # misreport the run.
    usable = ((args.frames - 1) // win) * win if win else 0
    mode.warm(win)

    # Results stay on the device in the timed loop ("live pose output" =
    # device-resident poses each tick); the log is read afterwards.
    t0 = time.perf_counter()
    n_steps = 0
    results = []
    if win:
        for k in range(0, usable, win):
            results.extend(mode.step_window(k, win))
            n_steps += win
    for f in range(1 + usable, args.frames):
        results.append(mode.step(f))
        n_steps += 1
    mode.state.poses.cpu()  # the timing fence: one host read after the loop
    dt = time.perf_counter() - t0
    for f, rec in enumerate(results, start=1):
        ok = int(mode.success_of(rec).sum())
        if args.print_poses:
            poses = mode.poses_of(rec)
            for i in range(s):
                t = poses[i][:3, 3]
                print(f"  frame {f} stream {i}: t=({t[0]:+.3f},{t[1]:+.3f},{t[2]:+.3f})")
        else:
            print(f"frame {f}: {ok}/{s} streams tracking")
    per_stream_fps = n_steps / dt
    print(
        f"{s} {mode.label} x {n_steps} steps in {dt:.2f}s: "
        f"{per_stream_fps:.1f} FPS/stream "
        f"({s * per_stream_fps:.0f} frames/s aggregate)"
    )
    target = 30.0
    print(f"config-5 target 30 FPS/stream: {'MET' if per_stream_fps >= target else 'NOT MET'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
