"""Dense multi-camera KinectFusion streams: the ``kinfu*`` cells.

Set-up renders every camera's out-and-back trajectory over its own sphere
scene on the device, the cameras in an order drawn from the seed, and
converts the frames to z16, then
seeds the streams (``parallel.streams.init_tsdf_streams``: each camera's
volume fuses its first frame). A call of the window advances all cameras
``window`` frames (``step_tsdf_streams``, or ``step_tsdf_streams_window``
for windows of several) and reads the poses on the host.

Correctness follows the program step by step from its own state: once
the window has closed, the volumes and poses of a seeded sample of cameras
are copied, one more call runs on the next frames with each render of the
sampled cameras recorded, and the plain reference (reference_tsdf.py)
repeats those cameras' steps from the copied state: the renders, the poses
and the registration's rmse and inlier fraction of every step, and the
volumes after the call, are compared. The start is checked by itself: the
sampled cameras' volumes as seeding left them against the reference's
fusion of their first frames into empty volumes.
"""

from __future__ import annotations

import time

import torch

from h100bench import hooks, readers, reference_pairs, reference_tsdf, scene, stats
from h100bench import trace as tracing


def make_frames(config: dict, order: list, frames: int, dev: torch.device):
    """(z16 frames (F, S, H, W) uint16, poses (S, F, 4, 4)): slot i holds
    camera order[i] of the configuration's fixed set, each walking out and
    back over its own scene, frame f at position f of the cycle (frames
    past the period repeat its start). Every seed runs the same cameras,
    in its own order, so that the seed changes the inputs and not the work."""
    cam = scene.camera_of(config)
    traj = config["trajectory"]
    s = int(config["cameras"])
    g = torch.Generator().manual_seed(int(traj["setup_seed"]))
    dirs = scene.unit_vectors(g, s, "cpu") * torch.tensor(traj["direction_scale"])
    axes = scene.unit_vectors(g, s, "cpu") * torch.tensor(traj["axis_scale"])
    dirs, axes = (x / x.norm(dim=-1, keepdim=True) for x in (dirs, axes))
    out = torch.empty((frames, s, cam.height, cam.width), dtype=torch.uint16, device=dev)
    poses = []
    for slot, c in enumerate(order):
        P = scene.out_and_back(int(traj["period"]), frames, dirs[c].to(dev), axes[c].to(dev), config["motion"])
        sc = scene.sphere_scene(int(config["scene"]["first_seed"]) + c, int(config["scene"]["spheres"]), dev)
        out[:, slot] = scene.to_z16(scene.render_depths(cam, P, sc), float(config["depth_scale"]))
        poses.append(P)
    return out, torch.stack(poses)


def draw(seed: int, cameras: int, checked: int) -> tuple[list, list]:
    """(the cameras' order over the slots, the slots checked), from the seed."""
    g = torch.Generator().manual_seed(seed % (1 << 63))
    order = torch.randperm(cameras, generator=g).tolist()
    return order, sorted(torch.randperm(cameras, generator=g)[:checked].tolist())


def tsdf_config(config: dict):
    from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod

    t = config["tsdf"]
    g = reference_tsdf.grid_of(t)
    return tsdf_mod.TsdfConfig(
        resolution=g.v, voxel_size=g.voxel, origin=g.origin, trunc=g.trunc, max_weight=g.max_weight,
        min_depth=g.min_depth, max_depth=g.max_depth, max_range=g.max_range, step_frac=g.step_frac,
        raycast_coarse=g.coarse, refine_steps=g.refine_steps, track_scale=int(t["track_scale"]),
        integrate_every=int(t["integrate_every"]), integrate_slab=0, subvoxel_iters=int(t["subvoxel_iters"]))


class Program:
    """The port's streams and the calls a cell makes on them."""

    def __init__(self, config: dict, cell: dict, frames: torch.Tensor, dev):
        from realsensetracker_tpu_torch.align import projective
        from realsensetracker_tpu_torch.geometry import camera
        from realsensetracker_tpu_torch.parallel import streams

        self.streams = streams
        self.intr = camera.Intrinsics(*scene.camera_of(config))
        self.vcfg = tsdf_config(config)
        icp = dict(config["icp"], iters=tuple(config["icp"]["iters"]))
        self.icp = projective.ProjectiveIcpConfig(**icp)
        self.min_inlier = float(config["min_inlier_fraction"])
        self.scale = float(config["depth_scale"])
        self.window = int(cell["window"])
        self.frames = frames
        self.state = streams.init_tsdf_streams(frames[0], self.intr, self.vcfg, depth_scale=self.scale)

    def call(self, f: int):
        """Advance every camera through frames f .. f + window - 1 and read
        the poses on the host; returns the result on the device."""
        st = self.streams
        if self.window == 1:
            self.state, res = st.step_tsdf_streams(self.state, self.frames[f], self.intr, self.vcfg, self.icp,
                                                   self.min_inlier, depth_scale=self.scale)
        else:
            depths = self.frames[f : f + self.window].transpose(0, 1)
            self.state, res = st.step_tsdf_streams_window(self.state, depths, self.intr, self.vcfg, self.icp,
                                                          self.min_inlier, depth_scale=self.scale)
        res.poses.cpu()
        return res


def _checked_call(prog: Program, f: int, sample: list):
    """One more call on the program's state with the sampled cameras'
    renders recorded: (renders [tick][k], poses (ticks, K, 4, 4), rmse,
    inlier (ticks, K), volumes after [(tsdf, weight)] of the sample)."""
    from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod

    log = []
    with hooks.recording(tsdf_mod, "render_model_depth", log, lambda a, k, out: out):
        res = prog.call(f)
    s = prog.state.poses.shape[0]
    renders = [[log[t * s + c] for c in sample] for t in range(len(log) // s)]

    def pick(x):  # (ticks, K, ...) of the sampled cameras; windows stack ticks on dim 1
        return (x.transpose(0, 1) if prog.window > 1 else x[None])[:, sample]

    vols = [(prog.state.volume.tsdf[c].clone(), prog.state.volume.weight[c].clone()) for c in sample]
    return renders, pick(res.poses), pick(res.rmse), pick(res.inlier_fraction), vols


def _reference_call(pre, frames_m, cam, g, icp, min_inlier, dtype, follow=None):
    """The reference over the same call for the sampled cameras from the
    copied state ``pre`` [(tsdf, weight, pose)] (updated in place), with
    frames_m (ticks, K, H, W): the same tuple as _checked_call. With
    ``follow`` (ticks, K, 4, 4), the program's poses, each tick after the
    first starts from the program's pose of the tick before, so that a
    window's ticks are each checked from the program's state and not
    through the reference's own chain of poses."""
    renders, poses, rmse, inl = [], [], [], []
    for t in range(frames_m.shape[0]):
        row = []
        for k, (tsdf, weight, pose) in enumerate(pre):
            if follow is not None and t > 0:
                pose = follow[t - 1, k].to(pose.device)
            out = reference_tsdf.step(tsdf, weight, pose, frames_m[t, k], cam, g, icp, min_inlier, dtype)
            pre[k] = (tsdf, weight, out.pose)
            row.append(out)
        renders.append([o.render for o in row])
        poses.append(torch.stack([o.pose for o in row]))
        rmse.append(torch.tensor([o.rmse for o in row]))
        inl.append(torch.tensor([o.inlier for o in row]))
    return renders, torch.stack(poses), torch.stack(rmse), torch.stack(inl), [(t, w) for t, w, _ in pre]


def voxel_gap(a, b, tol: float = 0.01) -> float:
    """Share of voxels whose weight differs or whose tsdf differs by more
    than ``tol`` (in units of trunc)."""
    ta, wa = a
    tb, wb = b
    bad = ((ta - tb).abs() > tol) | (wa != wb) | ~torch.isfinite(ta)
    return float(bad.sum()) / bad.numel()


def render_gap(a, b, tol_m: float = 1e-3) -> float:
    """Share of pixels whose depths differ by more than ``tol_m``."""
    bad = ((a - b).abs() > tol_m) | ~torch.isfinite(a)
    return float(bad.sum()) / bad.numel()


def compare(prog_out, ref_out, start_prog, start_ref):
    r_p, P_p, rmse_p, in_p, vol_p = prog_out
    r_r, P_r, rmse_r, in_r, vol_r = ref_out
    pose = max(float(torch.nan_to_num(reference_pairs.twist_gap(P_r[t], P_p[t].to(P_r.device)),
                                      nan=float("inf")).max()) for t in range(P_r.shape[0]))
    # A render the program never made counts as wholly wrong.
    rend = 1.0 if len(r_p) != len(r_r) else max(
        render_gap(a.to(b.device), b) for ra, rb in zip(r_p, r_r) for a, b in zip(ra, rb))
    vox = max(voxel_gap(a, b) for a, b in zip(vol_p, vol_r))
    start = max(voxel_gap((a[0].to(b[0].device), a[1].to(b[0].device)), b) for a, b in zip(start_prog, start_ref))
    nan = float("inf")
    return [
        ("pose_gap", pose),
        ("render_gap", rend),
        ("voxel_gap", vox),
        ("start_voxel_gap", start),
        ("rmse_gap", float(torch.nan_to_num((rmse_p.float().cpu() - rmse_r.float()).abs(), nan=nan).max())),
        ("inlier_gap", float(torch.nan_to_num((in_p.float().cpu() - in_r.float()).abs(), nan=nan).max())),
    ]


def run(cell, config, seed, seconds, trace, device, t_start, records=None):
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cam = scene.camera_of(config)
    g = reference_tsdf.grid_of(config["tsdf"])
    icp = dict(config["icp"], iters=tuple(config["icp"]["iters"]))
    period, window = int(config["trajectory"]["period"]), int(cell["window"])
    s = int(config["cameras"])
    order, sample = draw(seed, s, int(cell["check_cameras"]))
    frames, truth = make_frames(config, order, period + window - 1, dev)

    prog = Program(config, cell, frames, dev)
    start_prog = _program_start(prog, frames, sample, cam, g, float(config["depth_scale"]))
    f = 1
    prog.call(f)  # warm: builds the kernels on a checkout's first run, fills the allocator
    f = (f + window) % period
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ticks, results = [], []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        res = prog.call(f)
        ticks.append(time.perf_counter() - a)
        results.append(res.success)
        f = (f + window) % period
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    calls = len(ticks)
    e2e = {cell["rate_metric"]: stats.rate(calls * window * s, elapsed), "setup_s": t0 - t_start}

    traced = None
    if trace:
        n = int(cell["trace_calls"])

        def traced_calls():
            nonlocal f
            for _ in range(n):
                prog.call(f)
                f = (f + window) % period

        win, logs = tracing.traced_recorded(traced_calls, records or {})
        traced = readers.Traced(win, n * window * s, config, logs, {"call_s": ticks})

    t_check = time.perf_counter()
    failed = int(sum(int((~r).sum()) for r in results))
    pre = [(prog.state.volume.tsdf[c].clone(), prog.state.volume.weight[c].clone(), prog.state.poses[c].clone())
           for c in sample]
    frames_m = frames[f : f + window].float()[:, sample] * float(config["depth_scale"])
    prog_out = _program_checked(prog, f, sample, pre, frames_m, cam, g, icp, float(config["min_inlier_fraction"]))
    del prog
    if cuda:
        torch.cuda.empty_cache()
    dtype = getattr(torch, config["precision"])
    ref_out = _reference_call(pre, frames_m, cam, g, icp, float(config["min_inlier_fraction"]), dtype,
                              follow=prog_out[1])
    start_ref = [_fused_first(frames[0, c].float() * float(config["depth_scale"]), cam, g, dtype) for c in sample]
    numbers = compare(prog_out, ref_out, start_prog, start_ref)
    limits = cell["limits"]
    truth_gap = reference_pairs.twist_gap(truth[sample, f + window - 1], prog_out[1][-1].to(truth.device))
    return {
        "e2e": e2e, "attempted": calls * window * s, "failed": failed, "memory_peak_bytes": memory_peak,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "traced": traced,
        "checks": [(name, value, limits[name]) for name, value in numbers],
        "info": {"calls": calls, "window_s": elapsed, "check_s": time.perf_counter() - t_check,
                 "camera_order": order, "slots_checked": sample,
                 "tick_ms_median": stats.percentile(ticks, 50) * 1e3,
                 "tick_ms_p95": stats.percentile(ticks, 95) * 1e3, "truth_gap": float(truth_gap.max())},
    }


def _program_start(prog, frames, sample, cam, g, scale):
    """The sampled cameras' volumes as seeding left them, on the host."""
    return [(prog.state.volume.tsdf[c].to("cpu", copy=True), prog.state.volume.weight[c].to("cpu", copy=True))
            for c in sample]


def _reference_start(dtype):
    def start(prog, frames, sample, cam, g, scale):
        return [_fused_first(frames[0, c].float() * scale, cam, g, dtype) for c in sample]
    return start


def _fused_first(depth_m, cam, g, dtype=torch.float32):
    """The reference's volume after fusing a first frame at the identity."""
    t = torch.ones((g.v,) * 3, dtype=torch.float32, device=depth_m.device)
    w = torch.zeros_like(t)
    reference_tsdf.integrate(t, w, depth_m, torch.eye(4, device=depth_m.device), cam, g, dtype=dtype)
    return t, w


def _program_checked(prog, f, sample, pre, frames_m, cam, g, icp, min_inlier):
    return _checked_call(prog, f, sample)


def _reference_checked(dtype):
    def checked(prog, f, sample, pre, frames_m, cam, g, icp, min_inlier):
        copy = [(t.clone(), w.clone(), p.clone()) for t, w, p in pre]
        return _reference_call(copy, frames_m, cam, g, icp, min_inlier, dtype)
    return checked



def control(cell, config):
    """The reference in bfloat16 put in the program's place for the checked
    call and the start (the 6x6 solve and the pose products stay float32)."""
    import sys

    return hooks.patched(sys.modules[__name__], _program_checked=_reference_checked(torch.bfloat16),
                    _program_start=_reference_start(torch.bfloat16))


def _impl_patch(make):
    from realsensetracker_tpu_torch.parallel import streams

    return hooks.patched(streams, _tsdf_streams_impl=make(streams._tsdf_streams_impl, streams))


def _state_unchanged(cell, config):
    """Each step returns the state it was given: poses kept, volumes untouched."""
    def make(real, streams):
        def impl(state, depths, *args):
            s = depths.shape[0]
            ones = torch.ones(s, dtype=torch.bool, device=depths.device)
            zeros = torch.zeros(s, dtype=torch.float32, device=depths.device)
            return state, streams.StreamStepResult(state.poses, ones, zeros, zeros + 1.0)
        return impl
    return _impl_patch(make)


def _half_batch(cell, config):
    """Each step advances the first half of the cameras; the rest keep
    their state and repeat the first half's results."""
    def make(real, streams):
        from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod

        def impl(state, depths, *args):
            h = depths.shape[0] // 2
            part = streams.TsdfStreamState(state.poses[:h], tsdf_mod.TsdfVolume(state.volume.tsdf[:h],
                                           state.volume.weight[:h]), state.initialized[:h], state.frame_count[:h])
            new, res = real(part, depths[:h], *args)
            poses = torch.cat([new.poses, state.poses[h:]])
            out = state._replace(poses=poses, frame_count=state.frame_count + 1)
            return out, streams.StreamStepResult(poses, *(torch.cat([x, x]) for x in res[1:]))
        return impl
    return _impl_patch(make)


def _answer_altered(cell, config):
    """Each step's new poses move 5 mm along x where they are made."""
    def make(real, streams):
        def impl(state, depths, *args):
            new, res = real(state, depths, *args)
            poses = new.poses.clone()
            poses[:, 0, 3] += 0.005
            return new._replace(poses=poses), res._replace(poses=poses)
        return impl
    return _impl_patch(make)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch, "answer_altered": _answer_altered}
