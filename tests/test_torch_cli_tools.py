"""The port's rs_align, rs_viewer, capture and view_clouds
(realsensetracker_tpu_torch/cli/) on the CPU, against the JAX CLIs on the
same files: the JAX tests' cases (tests/test_api_cli.py:119-141,171-177,
206-225 and tests/test_live_viewer.py:133-164) with --device cpu, then
both packages' CLIs side by side.

Held: rs_align (FPFH + Lowe + Kabsch + ICP, -i 1 -x 1) on one shared .rsc
clip, on .npy clouds and on the same clouds as .pb files: the transform
and the ICP cost within 1e-4 of JAX's, the match count within 2% (the
FPFH rows part at ties: ROADMAP's standing records of PRs 5-7 and 11,
and tests/test_torch_fpfh.py); --use-robust 1 runs (no
parity: robust-global parts from JAX at near ties, ROADMAP's standing
record). capture --clip and rs_viewer --view --ply-dir: the points handed
to export_ply within 1e-6 of JAX's, the colors equal. view_clouds: the
same printed lines and renders as JAX's over xyzrgb files, an empty file
and a .pb. JAX reads the clips through read_clip_py
(torch_parity.block_jax_native); one JAX run per scenario.
"""

import os
import re

import numpy as np
import pytest
import torch

import realsensetracker_tpu.vis as jvis
import realsensetracker_tpu_torch.vis as pvis
from realsensetracker_tpu.cli import capture as jcapture
from realsensetracker_tpu.cli import rs_align as jrs_align
from realsensetracker_tpu.cli import rs_viewer as jrs_viewer
from realsensetracker_tpu.cli import view_clouds as jview_clouds
from realsensetracker_tpu_torch.cli import capture, rs_align, rs_viewer, view_clouds
from realsensetracker_tpu_torch.data import pb_interop, recorded, synthetic
from realsensetracker_tpu_torch.geometry import camera, se3
from tests.replay_parity import Run
from tests.torch_parity import block_jax_native

ALIGN_BAR = 1e-4
PLY_BAR = 1e-6
MATCH_PART = 0.02  # match counts, of JAX's (385 against 391 on the clip)
ALIGN_ARGS = ["--capacity", "1024", "--feature-radius", "0.4", "-k", "8"]


@pytest.fixture(scope="module", autouse=True)
def _jax_without_native():
    mp = pytest.MonkeyPatch()
    block_jax_native(mp)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 3-frame 64x48 clip with color (the port's scene) and the vertex
    clouds of its frames 0 and 1 as .npy and .pb files."""
    d = tmp_path_factory.mktemp("tools")
    clip = str(d / "c.rsc")
    recorded.record_synthetic_clip(clip, num_frames=3, width=64, height=48, with_color=True, seed=1)
    c = recorded.read_clip(clip)
    out = {"dir": d, "clip": clip}
    for i, name in enumerate(("src", "dst")):
        cl = rs_align._cloud_from_depth(c.depths[i], c.intrinsics, 1024, "cpu")
        pts = cl.points[cl.mask].numpy()
        out[name + ".npy"] = str(d / f"{name}.npy")
        np.save(out[name + ".npy"], pts)
        out[name + ".pb"] = str(d / f"{name}.pb")
        pb_interop.write_pb_cloud(out[name + ".pb"], pts)
    return out


def _transform(run) -> np.ndarray:
    text = run.out.split("transform :", 1)[1]
    return np.array([float(x) for x in re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", text)[:16]]).reshape(4, 4)


def _matches(run) -> int:
    return int(run.line("matches :").split(":")[1])


ALIGN_INPUTS = {
    "clip": lambda f: ["--clip", f["clip"]],
    "npy": lambda f: ["-s", f["src.npy"], "-t", f["dst.npy"]],
    "pb": lambda f: ["-s", f["src.pb"], "-t", f["dst.pb"]],
}


@pytest.fixture(scope="module")
def jax_align(files):
    return {name: Run(jrs_align.main, make(files) + ALIGN_ARGS + ["-i", "1", "-x", "1"])
            for name, make in ALIGN_INPUTS.items()}


@pytest.mark.parametrize("name", list(ALIGN_INPUTS))
def test_align_matches_jax(files, jax_align, name):
    jrun = jax_align[name]
    run = Run(rs_align.main, ALIGN_INPUTS[name](files) + ALIGN_ARGS + ["-i", "1", "-x", "1", "--device", "cpu"])
    assert run.rc == jrun.rc == 0
    # FPFH features part from JAX's in a few rows (a normal from a
    # degenerate k-NN PCA, compiled JAX's origin switch at ulp ties), so
    # the Lowe test keeps a few other matches; the transform does not move.
    assert abs(_matches(run) - _matches(jrun)) <= MATCH_PART * _matches(jrun)
    assert _matches(run) > 0
    T, jT = _transform(run), _transform(jrun)
    assert np.abs(T - jT).max() <= ALIGN_BAR
    assert abs(float(run.line("icp mean cost :").split(":")[1])
               - float(jrun.line("icp mean cost :").split(":")[1])) <= ALIGN_BAR


def test_align_npy_and_pb_agree(files, jax_align):
    """The .pb parse hands align_pair the same f32 points as the .npy."""
    assert _matches(jax_align["npy"]) == _matches(jax_align["pb"])
    np.testing.assert_array_equal(_transform(jax_align["npy"]), _transform(jax_align["pb"]))


def test_align_robust_runs(files):
    run = Run(rs_align.main, ALIGN_INPUTS["clip"](files) + ALIGN_ARGS + ["--use-robust", "1", "--device", "cpu"])
    assert run.rc == 0
    T = _transform(run)
    assert np.isfinite(T).all() or np.isnan(T).all()
    assert "icp mean cost :" in run.out


@pytest.mark.parametrize("fpfh", ["1", "0"])
def test_align_render(files, tmp_path, fpfh):
    """--render colors the source by its FPFH (from align_pair, or computed
    for the colors alone when -i 0 skips it)."""
    pytest.importorskip("matplotlib")
    png = str(tmp_path / "a.png")
    run = Run(rs_align.main, ALIGN_INPUTS["clip"](files) + ALIGN_ARGS + ["-i", fpfh, "--render", png,
                                                                        "--device", "cpu"])
    assert run.rc == 0 and f"render -> {png}" in run.out
    assert os.path.getsize(png) > 1000


def test_align_needs_inputs():
    run, jrun = Run(rs_align.main, ["--device", "cpu"]), Run(jrs_align.main, [])
    assert run.rc == jrun.rc == 1
    assert run.err == jrun.err == "need --clip or --source-file/--target-file\n"


def test_align_clip(files, capsys):
    """tests/test_api_cli.py:206-215."""
    assert rs_align.main(["--clip", files["clip"], *ALIGN_ARGS, "--device", "cpu"]) == 0
    assert "transform" in capsys.readouterr().out


def test_align_clip_capacity_overflow_spans_image():
    """tests/test_api_cli.py:119-141: _cloud_from_depth far below the
    valid-pixel count subsamples uniformly, not a head slice."""
    intr = camera.Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=37.0, width=100, height=75)
    d = synthetic.render_depth(intr, se3.identity(), synthetic.default_scene(seed=2)).numpy()
    full = rs_align._cloud_from_depth(d, intr, 100000, "cpu")
    full_pts = full.points[full.mask].numpy()
    assert len(full_pts) > 1000
    c = rs_align._cloud_from_depth(d, intr, 256, "cpu")
    pts = c.points[c.mask].numpy()
    assert len(pts) == 256
    span_full = full_pts[:, 1].max() - full_pts[:, 1].min()
    assert pts[:, 1].max() - pts[:, 1].min() > 0.8 * span_full


# --- PLY exports against JAX ---------------------------------------------------------


def _recorded_exports(main, argv, vis_mod):
    """Run a CLI with its package's export_ply wrapped: (Run, [(path,
    points, colors)] as handed over)."""
    got = []
    real = vis_mod.export_ply

    def export_ply(path, points, colors=None, normals=None):
        got.append((path, np.asarray(points, np.float64), None if colors is None else np.asarray(colors)))
        real(path, points, colors, normals)

    mp = pytest.MonkeyPatch()
    mp.setattr(vis_mod, "export_ply", export_ply)
    try:
        run = Run(main, argv)
    finally:
        mp.undo()
    return run, got


def _same_exports(got, jgot):
    assert len(got) == len(jgot) > 0
    for (path, pts, cols), (jpath, jpts, jcols) in zip(got, jgot):
        assert os.path.basename(path) == os.path.basename(jpath)
        assert pts.shape == jpts.shape and len(pts) > 0
        assert np.abs(pts - jpts).max() <= PLY_BAR
        assert (cols is None) == (jcols is None)
        if cols is not None:
            np.testing.assert_array_equal(cols, jcols)
        with open(path) as f, open(jpath) as g:
            assert f.read(200).split("end_header")[0] == g.read(200).split("end_header")[0]


def test_capture_clip_ply_matches_jax(files, tmp_path):
    outs = {s: str(tmp_path / s / "{:02d}.ply") for s in ("port", "jax")}
    for o in outs.values():
        os.makedirs(os.path.dirname(o))
    run, got = _recorded_exports(capture.main, ["--clip", files["clip"], "--frames", "2", "--out", outs["port"],
                                                "--device", "cpu"], pvis)
    jrun, jgot = _recorded_exports(jcapture.main, ["--clip", files["clip"], "--frames", "2", "--out", outs["jax"]],
                                   jvis)
    assert run.rc == jrun.rc == 0
    _same_exports(got, jgot)
    assert [ln.split(" -> ")[0] for ln in run.lines] == [ln.split(" -> ")[0] for ln in jrun.lines]


def test_viewer_ply_dir_matches_jax(files, tmp_path):
    dirs = {s: str(tmp_path / s) for s in ("port", "jax")}
    run, got = _recorded_exports(rs_viewer.main, ["--view", files["clip"], "--ply-dir", dirs["port"],
                                                  "--device", "cpu"], pvis)
    jrun, jgot = _recorded_exports(jrs_viewer.main, ["--view", files["clip"], "--ply-dir", dirs["jax"]], jvis)
    assert run.rc == jrun.rc == 0
    _same_exports(got, jgot)
    assert got[0][2] is not None  # the clip's colors
    assert run.lines[0] == jrun.lines[0]  # the clip summary
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))


def test_capture_ply(tmp_path):
    """tests/test_api_cli.py:217-225 (the port's synthetic scene)."""
    out = os.path.join(tmp_path, "{:02d}.ply")
    assert capture.main(["--frames", "2", "--out", out, "--device", "cpu"]) == 0
    with open(os.path.join(tmp_path, "00.ply")) as f:
        assert f.readline() == "ply\n"
    assert os.path.exists(os.path.join(tmp_path, "01.ply"))


# --- rs_viewer ----------------------------------------------------------------------------


def test_viewer_record_and_view(tmp_path, capsys):
    """tests/test_api_cli.py:171-177."""
    clip_path = os.path.join(tmp_path, "c.rsc")
    assert rs_viewer.main(["--record", clip_path, "--frames", "3", "--width", "64", "--height", "48",
                           "--device", "cpu"]) == 0
    assert rs_viewer.main(["--view", clip_path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"recorded 3 depth frames -> {clip_path}" in out
    assert f"{clip_path}: 3 depth frames (48, 64) intr=(51.2,51.2,31.5,23.5)" in out


def test_viewer_record_color_read_by_jax(tmp_path):
    clip_path = os.path.join(tmp_path, "c.rsc")
    assert rs_viewer.main(["--record", clip_path, "--frames", "2", "--width", "32", "--height", "24", "--color",
                           "--device", "cpu"]) == 0
    jrun = Run(jrs_viewer.main, ["--view", clip_path])
    assert jrun.rc == 0 and jrun.lines[0].startswith(f"{clip_path}: 2 RGB-D frames (24, 32)")


def test_viewer_render_dir(files, tmp_path):
    pytest.importorskip("matplotlib")
    run = Run(rs_viewer.main, ["--view", files["clip"], "--render-dir", str(tmp_path), "--device", "cpu"])
    assert run.rc == 0 and f"rendered 3 PNGs -> {tmp_path}" in run.out
    assert sorted(os.listdir(tmp_path)) == [f"depth_{i:04d}.png" for i in range(3)]


def test_loop_records_and_writes_latest(tmp_path):
    """tests/test_live_viewer.py:133-145."""
    clip_path = str(tmp_path / "live.rsc")
    latest = str(tmp_path / "latest.png")
    rc = rs_viewer.main(["--loop", "--frames", "4", "--width", "32", "--height", "24", "--record", clip_path,
                         "--live-latest", latest, "--device", "cpu"])
    assert rc == 0
    with open(latest, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    clip = recorded.read_clip(clip_path)
    assert len(clip) == 4
    assert clip.depths.shape[1:] == (24, 32)


def test_loop_plays_a_clip_to_its_end(files, tmp_path):
    """Viewing a clip in the loop shows every frame, whatever --frames
    says, and records them back bit for bit (at the clip's u16 mm)."""
    out = str(tmp_path / "again.rsc")
    run = Run(rs_viewer.main, ["--loop", "--view", files["clip"], "--frames", "1", "--record", out,
                               "--ply-dir", str(tmp_path), "--device", "cpu"])
    assert run.rc == 0 and "live loop: 3 frames shown" in run.out
    assert "--ply-dir applies to the non-loop path" in run.err
    np.testing.assert_array_equal(recorded.read_clip(out).depths, recorded.read_clip(files["clip"]).depths)


def test_serve_loop_answers_and_closes():
    run = Run(rs_viewer.main, ["--serve", "0", "--frames", "2", "--width", "32", "--height", "24",
                               "--device", "cpu"])
    assert run.rc == 0
    assert re.match(r"live view: http://127\.0\.0\.1:\d+/$", run.lines[0])
    assert run.lines[-1] == "live loop: 2 frames shown"


@pytest.mark.parametrize("cli", [rs_align, rs_viewer, capture])
def test_default_device_needs_cuda(cli, files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    argv = {rs_align: ["--clip", files["clip"]], rs_viewer: ["--view", files["clip"]],
            capture: ["--clip", files["clip"], "--out", str(tmp_path / "{}.ply")]}[cli]
    with pytest.raises(RuntimeError, match="needs CUDA"):
        cli.main(argv)


# --- view_clouds ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cloud_files(tmp_path_factory):
    """xyzrgb clouds 0 and 2 (0-255 and 0-1 colors), an empty xyzrgb 1, and
    a .pb cloud without colors."""
    d = tmp_path_factory.mktemp("clouds")
    rng = np.random.default_rng(3)
    pvis.save_xyzrgb(str(d / "0000.xyzrgb"), rng.normal(size=(40, 3)), rng.integers(0, 256, (40, 3)))
    (d / "0001.xyzrgb").write_text("")
    pvis.save_xyzrgb(str(d / "0002.xyzrgb"), rng.normal(size=(30, 3)), rng.uniform(size=(30, 3)))
    pb_interop.write_pb_cloud(str(d / "0000.pb"), rng.normal(size=(25, 3)).astype(np.float32))
    return d


@pytest.mark.parametrize("ext", ["xyzrgb", "pb"])
def test_view_clouds_matches_jax(cloud_files, tmp_path, ext):
    pytest.importorskip("matplotlib")
    pattern = str(cloud_files / ("{:04d}." + ext))
    outs = {s: str(tmp_path / s) for s in ("port", "jax")}
    run = Run(view_clouds.main, ["--pattern", pattern, "--frames", "4", "--out-dir", outs["port"]])
    jrun = Run(jview_clouds.main, ["--pattern", pattern, "--frames", "4", "--out-dir", outs["jax"]])
    assert run.rc == jrun.rc == 0
    assert [ln.replace(outs["port"], "OUT") for ln in run.lines] == [ln.replace(outs["jax"], "OUT")
                                                                       for ln in jrun.lines]
    assert sorted(os.listdir(outs["port"])) == sorted(os.listdir(outs["jax"]))
    want = {"xyzrgb": ["view_0000.png", "view_0002.png"], "pb": ["view_0000.png"]}[ext]
    assert sorted(os.listdir(outs["port"])) == want
    if ext == "xyzrgb":
        assert run.lines[0] == f"skipping empty cloud: {cloud_files / '0001.xyzrgb'}"
