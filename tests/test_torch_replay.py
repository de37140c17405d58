"""The port's rs_replay (realsensetracker_tpu_torch/cli/rs_replay.py) on a
64x48 TUM-layout sequence, against the JAX package's rs_replay on the same
files, both in-process on the CPU; and the port's rs_tracker.

The sequence (8 frames, 16-bit depth PNGs at 1/5000 m, RGB, ground truth)
is written once by the port. Depth-only replay streams raw uint16 frames
through stream_tum in both packages. Held: the trajectory files and the
--json poses within 1e-4 for --method projective, keyframe --window 4 and
tsdf (48^3 x 8 cm); the ATE and RPE lines within 1e-4 (m, and rad for
the rotation errors, which the lines print in degrees); the printed summary
lines; the --start-frame / --max-frames count semantics. JAX reads the
PNGs through PIL (torch_parity.block_jax_native).
"""

import re

import numpy as np
import pytest

from realsensetracker_tpu.api import config as jconfig
from realsensetracker_tpu_torch.api import ReplayConfig
from realsensetracker_tpu_torch.cli import rs_tracker
from realsensetracker_tpu_torch.data import tum
from tests.replay_parity import Runner, assert_same_rows, assert_same_trajectory, processed
from tests.torch_parity import block_jax_native

TSDF_SMALL = ["--tsdf-resolution", "48", "--tsdf-voxel", "0.08"]
METHODS = {
    "projective": ["--method", "projective"],
    "keyframe-w4": ["--method", "keyframe", "--window", "4"],
    "tsdf": ["--method", "tsdf", *TSDF_SMALL],
}


@pytest.fixture(scope="module", autouse=True)
def _jax_without_native():
    mp = pytest.MonkeyPatch()
    block_jax_native(mp)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("replay") / "seq")
    return tum.synthesize_tum_sequence(root, num_frames=8, width=64, height=48, with_color=True, seed=1)


@pytest.fixture(scope="module")
def runner():
    return Runner()


@pytest.fixture(scope="module")
def runs(seq, runner, tmp_path_factory):
    """{name: (port run, JAX run, port trajectory, JAX trajectory)} of each
    method over the sequence, with --json, --ate and --rpe 0.1."""
    out = tmp_path_factory.mktemp("traj")
    got = {}
    for name, args in METHODS.items():
        tp, tj = str(out / f"{name}-port.txt"), str(out / f"{name}-jax.txt")
        base = ["--tum", seq, *args, "--json", "--ate", "--rpe", "0.1"]
        got[name] = (runner.port(base + ["--trajectory-out", tp]), runner.jax(base + ["--trajectory-out", tj]), tp, tj)
    return got


@pytest.mark.parametrize("name", list(METHODS))
def test_trajectory_matches_jax(runs, name):
    port, jax, tp, tj = runs[name]
    assert port.rc == jax.rc == 0, port.err + jax.err
    assert processed(port) == processed(jax) == 8
    assert_same_trajectory(tp, tj)
    assert_same_rows(port.rows, jax.rows)
    assert all(r["success"] for r in port.rows)


@pytest.mark.parametrize("name", list(METHODS))
@pytest.mark.parametrize("metric", ["ATE:", "RPE:"])
def test_ate_and_rpe_lines_match_jax(runs, name, metric):
    import json

    port, jax, _, _ = runs[name]
    got, ref = (json.loads(r.line(metric)[len(metric):]) for r in (port, jax))
    assert got.keys() == ref.keys() and got["pairs"] == ref["pairs"] > 0
    for k in got:  # meters within 1e-4; angles within 1e-4 rad, in degrees
        bar = np.degrees(1e-4) if k.endswith("_deg") else 1e-4
        assert abs(got[k] - ref[k]) <= bar, (k, got[k], ref[k])
    if metric == "ATE:":
        assert got["rmse"] < 0.02


@pytest.mark.parametrize("name", list(METHODS))
def test_summary_lines_match_jax(runs, name):
    port, jax, tp, tj = runs[name]

    def shape(run, path):
        return [re.sub(r"[\d.]+s \([\d.]+ fps\)", "_", ln.replace(path, "PATH")).split(":")[0]
                for ln in run.lines]

    assert shape(port, tp) == shape(jax, tj)
    assert port.line("trajectory -> ") == f"trajectory -> {tp}"


@pytest.mark.parametrize("start,count", [(2, 3), (5, 0), (6, 10)])
def test_start_and_max_frames_count(seq, runner, start, count):
    """--max-frames is a COUNT from --start-frame (0 = to the end)."""
    argv = ["--tum", seq, "--json", "--start-frame", str(start), "--max-frames", str(count)]
    port, jax = runner.port(argv), runner.jax(argv)
    want = min(count or 8, 8 - start)
    assert processed(port) == processed(jax) == len(port.rows) == want
    stamps = [float(f"{t:.6f}") for t in np.arange(start, start + want) / 30.0]
    assert [r["timestamp"] for r in port.rows] == [r["timestamp"] for r in jax.rows] == pytest.approx(stamps)
    assert_same_rows(port.rows, jax.rows)


def test_rgbd_and_color_tsdf_run(seq, runner, tmp_path):
    """The color paths read rgb/ through the port's PNG decoder: RGB-D
    odometry and a colored TSDF with a colored map."""
    for argv in (["--method", "rgbd"], ["--method", "tsdf", *TSDF_SMALL, "--tsdf-color",
                                        "--save-map", str(tmp_path / "map.ply")]):
        run = runner.port(["--tum", seq, "--json", "--ate", *argv])
        assert run.rc == 0, run.err
        assert processed(run) == 8 and all(r["success"] for r in run.rows)
    assert run.line("map (").endswith(f"colored) -> {tmp_path / 'map.ply'}")


def test_live_latest_png(seq, runner, tmp_path):
    png = tmp_path / "latest.png"
    run = runner.port(["--tum", seq, "--max-frames", "3", "--live-latest", str(png), "--serve", "0"])
    assert run.rc == 0, run.err
    assert run.lines[0].startswith("live view: http://127.0.0.1:")
    img = tum.read_png(str(png))
    assert img.shape == (48, 64, 3) and img.max() > 0


def test_rs_tracker_prints_poses(capsys):
    assert rs_tracker.main(["--device", "cpu", "--frames", "3", "--method", "projective",
                            "--width", "64", "--height", "48"]) == 0
    lines = capsys.readouterr().out.splitlines()
    pat = re.compile(r"frame +\d+ \[(ok|FAIL)\] q=\(([+-]\d\.\d{4},){3}[+-]\d\.\d{4}\) \| t=\(([+-]\d\.\d{4},){2}"
                     r"[+-]\d\.\d{4}\)")
    assert len(lines) == 3 and all(pat.fullmatch(ln) for ln in lines)
    assert lines[0].startswith("frame   0 [ok] q=(+0.0000,+0.0000,+0.0000,+1.0000)")


def test_replay_config_matches_jax():
    assert vars(ReplayConfig()) == vars(jconfig.ReplayConfig())
