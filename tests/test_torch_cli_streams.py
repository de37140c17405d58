"""The port's rs_streams (realsensetracker_tpu_torch/cli/rs_streams.py) on
the CPU: the JAX CLI's cases (tests/test_api_cli.py:278-338) run with
--device cpu, then both CLIs on identical injected frames.

Each package's CLI renders its own scenes, which differ between the two
(the port draws from a torch.Generator). The parity cases therefore
replace each package's synthetic.render_trajectory(_rgbd), within the
test, with frames of tests/torch_parity's numpy-drawn scenes (seed 40 + i,
as the CLIs seed stream i's scene) along a walk of their own per stream,
and record the state each step function returns. Held: the printed
per-frame lines equal, and the final poses of every stream within 1e-4 of
the JAX CLI's (tests/test_torch_streams.py's bar). One JAX run per
scenario (module scope).
"""

import numpy as np
import pytest
import torch

from realsensetracker_tpu.cli import rs_streams as jrs_streams
from realsensetracker_tpu.data import synthetic as jsynthetic
from realsensetracker_tpu.parallel import streams as jstreams
from realsensetracker_tpu_torch.cli import rs_streams
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.parallel import streams
from tests import torch_parity
from tests.replay_parity import Run

POSE_BAR = 1e-4
SMALL = ["--streams", "2", "--width", "64", "--height", "48"]
SCENARIOS = {
    "depth": SMALL + ["--frames", "5"],
    "window": SMALL + ["--frames", "5", "--window", "2"],
    "rgb": SMALL + ["--frames", "4", "--rgb", "--window", "2"],
    "tsdf": ["--streams", "2", "--frames", "4", "--width", "80", "--height", "60", "--tsdf",
             "--tsdf-resolution", "48", "--tsdf-voxel", "0.12", "--window", "2"],
}
STEPS = ("step_streams", "step_streams_window", "step_streams_masked_rgbd", "step_streams_masked_rgbd_window",
         "step_tsdf_streams", "step_tsdf_streams_window")


def _walk(n, seed):
    """Stream ``seed``'s own short walk."""
    base = np.array([0.01, -0.005, 0.015, 0.004, 0.006, -0.003])
    return torch_parity.walk(n, step=tuple(base * (1.0 + 0.25 * seed)))


def _fake_renders(jax_side: bool):
    """render_trajectory(_rgbd) stand-ins: stream ``seed``'s frames of the
    numpy-drawn scene 40 + seed, the same arrays for both packages."""

    def frames(intr, n, seed, rgb):
        intr = camera.Intrinsics(*intr)
        poses = _walk(n, seed)
        out = (*torch_parity.render_rgbd(intr, poses, seed=40 + seed), poses) if rgb else (
            torch_parity.render(intr, poses, seed=40 + seed), poses)
        return tuple(torch_parity.j32(a) for a in out) if jax_side else out

    def render_trajectory(intr, num_frames, scene=None, seed=0, step_scale=0.02, **_):
        return frames(intr, num_frames, seed, rgb=False)

    def render_trajectory_rgbd(intr, num_frames, scene=None, seed=0, step_scale=0.02, **_):
        return frames(intr, num_frames, seed, rgb=True)

    return render_trajectory, render_trajectory_rgbd


def _run(main, argv, synth_mod, streams_mod, jax_side):
    """One CLI run on the injected frames: (Run, final poses (S, 4, 4))."""
    box = {}
    mp = pytest.MonkeyPatch()
    fake, fake_rgbd = _fake_renders(jax_side)
    mp.setattr(synth_mod, "render_trajectory", fake)
    mp.setattr(synth_mod, "render_trajectory_rgbd", fake_rgbd)
    for name in STEPS:
        fn = getattr(streams_mod, name)

        def record(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            box["state"] = out[0]
            return out

        mp.setattr(streams_mod, name, record)
    try:
        run = Run(main, argv)
    finally:
        mp.undo()
    return run, np.asarray(box["state"].poses.cpu() if not jax_side else box["state"].poses, np.float64)


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _run(jrs_streams.main, argv, jsynthetic, jstreams, True) for name, argv in SCENARIOS.items()}


def _frame_lines(run):
    return [ln for ln in run.lines if ln.startswith("frame ")]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_streams_match_jax_on_identical_frames(jax_runs, name):
    jrun, jposes = jax_runs[name]
    run, poses = _run(rs_streams.main, SCENARIOS[name] + ["--device", "cpu"], synthetic, streams, False)
    assert run.rc == jrun.rc == 0
    assert _frame_lines(run) == _frame_lines(jrun)
    assert all(ln.endswith("2/2 streams tracking") for ln in _frame_lines(run))
    steps = [ln for ln in run.lines if "FPS/stream" in ln]
    jsteps = [ln for ln in jrun.lines if "FPS/stream" in ln]
    assert steps[0].split(" steps in ")[0] == jsteps[0].split(" steps in ")[0]  # "2 <label> x N"
    assert poses.shape == jposes.shape == (2, 4, 4)
    assert np.abs(poses - jposes).max() <= POSE_BAR
    assert np.abs(poses - np.eye(4)).max() > 10 * POSE_BAR  # the streams moved


def _port(argv, capsys):
    rc = rs_streams.main(argv + ["--device", "cpu"])
    assert rc == 0
    return capsys.readouterr().out


# --- the JAX CLI's cases (tests/test_api_cli.py:278-338) -------------------------


def test_streams_demo_runs(capsys):
    out = _port(["--streams", "2", "--frames", "3", "--width", "64", "--height", "48"], capsys)
    assert "FPS/stream" in out
    assert "config-5 target 30 FPS/stream: " in out


def test_streams_demo_windowed(capsys):
    out = _port(["--streams", "2", "--frames", "5", "--width", "64", "--height", "48", "--window", "2"], capsys)
    assert "frame 4: 2/2 streams tracking" in out
    assert "FPS/stream" in out


def test_streams_rgbd(capsys):
    out = _port(["--streams", "2", "--frames", "4", "--width", "64", "--height", "48", "--rgb", "--window", "2"],
                capsys)
    assert "RGB-D streams" in out
    assert "frame 3: 2/2 streams tracking" in out  # windowed + tail
    assert "FPS/stream" in out


def test_streams_tsdf(capsys):
    out = _port(["--streams", "2", "--frames", "4", "--width", "80", "--height", "60", "--tsdf",
                 "--tsdf-resolution", "48", "--tsdf-voxel", "0.12", "--window", "2"], capsys)
    assert "dense (TSDF) streams" in out
    assert "frame 3: 2/2 streams tracking" in out
    assert "FPS/stream" in out


def test_streams_windowed_tail_not_dropped(capsys):
    """(frames-1) % window != 0: the trailing steps run per frame."""
    out = _port(["--streams", "2", "--frames", "4", "--width", "64", "--height", "48", "--window", "2"], capsys)
    assert "frame 3: 2/2 streams tracking" in out  # the tail step
    assert "x 3 steps" in out


# --- the rest of the surface ---------------------------------------------------------


def test_print_poses_lines(capsys):
    out = _port(["--streams", "2", "--frames", "3", "--width", "64", "--height", "48", "--print-poses"], capsys)
    lines = [ln for ln in out.splitlines() if ln.startswith("  frame ")]
    assert len(lines) == 2 * 2 and lines[0].startswith("  frame 1 stream 0: t=(")
    assert "streams tracking" not in out


def test_rgb_and_tsdf_are_exclusive(capsys):
    assert rs_streams.main(["--rgb", "--tsdf", "--device", "cpu"]) == 1
    assert "mutually exclusive" in capsys.readouterr().err


def test_tsdf_warmup_leaves_the_volumes_alone():
    """The dense slots' volumes update in place: the warm-up step runs on
    a copy, so the timed steps start from the seeded volumes."""
    args = rs_streams.build_parser().parse_args(SCENARIOS["tsdf"] + ["--device", "cpu"])
    intr = camera.Intrinsics(fx=64.0, fy=64.0, cx=39.5, cy=29.5, width=80, height=60)
    mode = rs_streams._TsdfMode(args, intr, torch.device("cpu"))
    before = mode.state.volume.tsdf.clone(), mode.state.volume.weight.clone()
    mode.warm(2)
    assert torch.equal(mode.state.volume.tsdf, before[0])
    assert torch.equal(mode.state.volume.weight, before[1])


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        rs_streams.main(["--streams", "1", "--frames", "2", "--width", "32", "--height", "24"])
