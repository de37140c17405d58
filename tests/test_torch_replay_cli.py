"""The port's rs_replay on a 64x48 .rsc clip with color, its argument
checks, and its writers (realsensetracker_tpu_torch/vis), against the JAX
package on the CPU.

Held: the trajectory files and --json poses within 1e-4 for --method
projective, keyframe --window 4 and tsdf (48^3 x 8 cm, with --save-mesh:
the same triangle count); rgbd on the clip's gray; the same exit codes and
messages for every argument error; export_ply, export_mesh_ply,
encode_png, depth_to_rgb and pack_cloud byte for byte against the JAX
package's on the same arrays; a LiveServer answering /, /status and
/frame.png. JAX reads the clip through read_clip_py
(torch_parity.block_jax_native).
"""

import json
import os
import urllib.request

import numpy as np
import pytest

from realsensetracker_tpu.vis import live as jlive
from realsensetracker_tpu.vis import render as jrender
from realsensetracker_tpu_torch.data import recorded, tum
from realsensetracker_tpu_torch.vis import live, render
from tests.replay_parity import Runner, assert_same_rows, assert_same_trajectory, processed
from tests.torch_parity import block_jax_native

TSDF_SMALL = ["--tsdf-resolution", "48", "--tsdf-voxel", "0.08"]
METHODS = {
    "projective": ["--method", "projective"],
    "keyframe-w4": ["--method", "keyframe", "--window", "4"],
    "tsdf": ["--method", "tsdf", *TSDF_SMALL, "--save-mesh", "MESH"],
}


@pytest.fixture(scope="module", autouse=True)
def _jax_without_native():
    mp = pytest.MonkeyPatch()
    block_jax_native(mp)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A clip with color, a depth-only clip, a depth-only TUM sequence, an
    empty TUM index; written by the port."""
    d = tmp_path_factory.mktemp("clips")
    clip = str(d / "rgbd.rsc")
    recorded.record_synthetic_clip(clip, num_frames=8, width=64, height=48, with_color=True, seed=2)
    depth_clip = str(d / "depth.rsc")
    recorded.record_synthetic_clip(depth_clip, num_frames=2, width=32, height=24)
    seq = tum.synthesize_tum_sequence(str(d / "seq"), num_frames=2, width=32, height=24)
    empty = d / "empty"
    empty.mkdir()
    (empty / "depth.txt").write_text("# no frames\n")
    return {"clip": clip, "depth_clip": depth_clip, "seq": seq, "empty": str(empty), "dir": d}


@pytest.fixture(scope="module")
def runner():
    return Runner()


@pytest.fixture(scope="module")
def runs(files, runner):
    got = {}
    for name, args in METHODS.items():
        paths = {side: str(files["dir"] / f"{name}-{side}") for side in ("port", "jax")}

        def argv(side):
            extra = [paths[side] + ".mesh.ply" if a == "MESH" else a for a in args]
            return ["--record", files["clip"], *extra, "--json", "--trajectory-out", paths[side] + ".txt"]

        got[name] = (runner.port(argv("port")), runner.jax(argv("jax")), paths["port"], paths["jax"])
    return got


@pytest.mark.parametrize("name", list(METHODS))
def test_clip_trajectory_matches_jax(runs, name):
    port, jax, pp, pj = runs[name]
    assert port.rc == jax.rc == 0, port.err + jax.err
    assert processed(port) == processed(jax) == 8
    assert_same_trajectory(pp + ".txt", pj + ".txt")
    assert_same_rows(port.rows, jax.rows)
    assert all(r["success"] for r in port.rows)


def test_clip_tsdf_mesh_matches_jax(runs):
    port, jax, pp, pj = runs["tsdf"]
    n_port = int(port.line("mesh (").split()[1][1:])
    assert n_port == int(jax.line("mesh (").split()[1][1:]) > 0
    for path in (pp, pj):
        with open(path + ".mesh.ply") as f:
            assert f.readline() == "ply\n"


def test_clip_rgbd_runs(files, runner):
    run = runner.port(["--record", files["clip"], "--method", "rgbd", "--json"])
    assert run.rc == 0, run.err
    assert processed(run) == 8 and all(r["success"] for r in run.rows)


ARG_ERRORS = {
    "no-source": [],
    "slam-rgb-without-slam": ["--tum", "SEQ", "--slam-rgb"],
    "window-on-projective": ["--tum", "SEQ", "--window", "4"],
    "photometric-without-color": ["--tum", "SEQ", "--method", "tsdf", "--tsdf-photometric"],
    "color-without-tsdf": ["--tum", "SEQ", "--tsdf-color"],
    "tsdf-flags-without-tsdf": ["--tum", "SEQ", "--tsdf-resolution", "48"],
    "fallback-without-scale": ["--tum", "SEQ", "--method", "tsdf", "--tsdf-track-scale-fallback", "0.5"],
    "empty-sequence": ["--tum", "EMPTY"],
    "rgbd-without-rgb": ["--tum", "SEQ", "--method", "rgbd"],
    "rgbd-on-depth-clip": ["--record", "DEPTH_CLIP", "--method", "rgbd"],
    "save-state-on-projective": ["--tum", "SEQ", "--save-state", "x.npz"],
    "submaps-without-tsdf": ["--tum", "SEQ", "--submap-radius", "0.5"],
    "optimize-atlas-without-submaps": ["--tum", "SEQ", "--method", "tsdf", "--optimize-atlas"],
    "unknown-method": ["--tum", "SEQ", "--method", "nope"],
}


@pytest.mark.parametrize("name", list(ARG_ERRORS))
def test_argument_errors_match_jax(files, runner, name):
    subst = {"SEQ": files["seq"], "EMPTY": files["empty"], "DEPTH_CLIP": files["depth_clip"]}
    argv = [subst.get(a, a) for a in ARG_ERRORS[name]]
    port, jax = runner.port(argv), runner.jax(argv)
    assert port.rc == jax.rc != 0
    assert port.rows == [] and not any(ln.startswith("processed") for ln in port.lines)
    if port.rc == 1:
        assert port.err == jax.err
    else:  # argparse: the same complaint, under each program's usage line
        assert port.err.splitlines()[-1] == jax.err.splitlines()[-1]


# --- writers -----------------------------------------------------------------------


def _cloud(seed, n=40):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


@pytest.mark.parametrize("extra", ["plain", "colors", "normals", "both"])
def test_export_ply_bytes_match_jax(tmp_path, extra):
    pts, cols, nrm = _cloud(1)
    kw = {"plain": {}, "colors": {"colors": cols}, "normals": {"normals": nrm},
          "both": {"colors": cols, "normals": nrm}}[extra]
    render.export_ply(str(tmp_path / "p.ply"), pts, **kw)
    jrender.export_ply(str(tmp_path / "j.ply"), pts, **kw)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("colored", [False, True])
@pytest.mark.parametrize("weld", [True, False])
def test_export_mesh_ply_bytes_match_jax(tmp_path, colored, weld):
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(12, 3)).astype(np.float32)
    tris = verts[rng.integers(0, 12, (20, 3))]  # shared vertices to weld
    cols = rng.uniform(size=(20, 3, 3)).astype(np.float32) if colored else None
    render.export_mesh_ply(str(tmp_path / "p.ply"), tris, cols, weld=weld)
    jrender.export_mesh_ply(str(tmp_path / "j.ply"), tris, cols, weld=weld)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_xyzrgb_and_fpfh_colors_match_jax(tmp_path):
    pts, cols, _ = _cloud(3)
    render.save_xyzrgb(str(tmp_path / "p.txt"), pts, cols)
    jrender.save_xyzrgb(str(tmp_path / "j.txt"), pts, cols)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    for a, b in zip(render.load_xyzrgb(str(tmp_path / "p.txt")), jrender.load_xyzrgb(str(tmp_path / "j.txt"))):
        np.testing.assert_array_equal(a, b)
    feats = np.random.default_rng(4).uniform(size=(30, 33))
    np.testing.assert_array_equal(render.fpfh_pca_colors(feats), jrender.fpfh_pca_colors(feats))


def test_live_encoders_match_jax():
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.0, 6.0, (24, 32)).astype(np.float32)
    depth[0, :3] = [np.nan, np.inf, -1.0]
    rgb = live.depth_to_rgb(depth)
    np.testing.assert_array_equal(rgb, jlive.depth_to_rgb(depth))
    assert live.encode_png(rgb) == jlive.encode_png(rgb)
    np.testing.assert_array_equal(tum.decode_png(live.encode_png(rgb)), rgb)
    pts, cols, _ = _cloud(6)
    assert live.pack_cloud(pts, cols, trajectory=pts[:5]) == jlive.pack_cloud(pts, cols, trajectory=pts[:5])


def test_live_server_answers():
    server = live.LiveServer(port=0)
    try:
        png = live.encode_png(np.full((4, 6, 3), 200, np.uint8))
        server.update(png, {"frame": 3})
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            assert r.status == 200 and b"<" in r.read()
        with urllib.request.urlopen(base + "/status", timeout=30) as r:
            assert json.loads(r.read())["frame"] == 3
        with urllib.request.urlopen(base + "/frame.png", timeout=30) as r:
            assert r.read() == png
    finally:
        server.close()


def test_write_latest_png_is_atomic(tmp_path):
    path = str(tmp_path / "latest.png")
    live.write_latest_png(path, b"abc")
    assert open(path, "rb").read() == b"abc" and not os.path.exists(path + ".tmp")
