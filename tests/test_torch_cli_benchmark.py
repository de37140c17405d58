"""The port's rs_benchmark (realsensetracker_tpu_torch/cli/rs_benchmark.py)
on the CPU: the JAX CLI's cases (tests/test_cli_smoke.py:37-93) with
--device cpu, the rgbd, gnc-icp, gicp, slam and tsdf pipelines, the JSON
keys against the JAX CLI's, the projective inputs against the JAX CLI's
recipe, and the batched RGB-D registration the rgbd pipeline times against
B separate registrations. The port's --profile writes one trace.json (a
torch.profiler Chrome trace), not JAX's xprof plugins/profile directory.
"""

import json

import numpy as np
import pytest
import torch

from realsensetracker_tpu.cli import rs_benchmark as jrs_benchmark
from realsensetracker_tpu_torch.align import rgbd as rgbd_mod
from realsensetracker_tpu_torch.cli import rs_benchmark
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.geometry import se3
from tests.replay_parity import Run

TINY = ["--width", "80", "--height", "60"]
PAIR_KEYS = ["pipeline", "batch", "resolution", "pairs_per_sec_per_chip", "ms_per_batch"]
# realsensetracker_tpu/cli/rs_benchmark.py:204-212 and :251-260.
SLAM_KEYS = ["pipeline", "frames", "window", "resolution", "frames_per_sec_per_chip", "ms_per_frame", "keyframes"]
TSDF_KEYS = ["pipeline", "frames", "window", "resolution", "volume", "raycast_coarse", "frames_per_sec_per_chip",
             "ms_per_frame"]


def _run(capsys, argv):
    rc = rs_benchmark.main(argv + ["--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return json.loads(out[-1])


# --- the JAX CLI's cases (tests/test_cli_smoke.py:37-93) ------------------------


def test_projective_pipeline_keys_match_jax(capsys):
    argv = ["--batch", "2", "--iters", "2", *TINY, "--samples", "256", "--level-iters", "2,2"]
    rec = _run(capsys, argv)
    jrun = Run(jrs_benchmark.main, argv)
    assert jrun.rc == 0
    jrec = json.loads(jrun.out.strip().splitlines()[-1])
    assert list(rec) == list(jrec) == PAIR_KEYS
    assert {k: rec[k] for k in ("pipeline", "batch", "resolution")} == {
        k: jrec[k] for k in ("pipeline", "batch", "resolution")}
    assert rec["pipeline"] == "projective-icp"
    assert rec["pairs_per_sec_per_chip"] > 0


def test_projective_chunked(capsys):
    rec = _run(capsys, ["--batch", "4", "--iters", "1", *TINY, "--samples", "256", "--level-iters", "2,2",
                        "--chunk", "2"])
    assert rec["pairs_per_sec_per_chip"] > 0 and rec["batch"] == 4


def test_slam_window_pipeline(capsys):
    rec = _run(capsys, ["--pipeline", "slam-window", "--batch", "8", "--window", "2", *TINY])
    assert list(rec) == SLAM_KEYS
    assert rec["pipeline"] == "slam-window" and rec["window"] == 2
    assert rec["frames_per_sec_per_chip"] > 0
    assert rec["keyframes"] >= 1


def test_tsdf_window_pipeline(capsys):
    rec = _run(capsys, ["--pipeline", "tsdf-window", "--batch", "6", "--window", "2", *TINY])
    assert list(rec) == TSDF_KEYS
    assert rec["pipeline"] == "tsdf-window" and rec["window"] == 2
    assert rec["frames_per_sec_per_chip"] > 0
    assert rec["volume"] == "128^3" and rec["raycast_coarse"] == 4


def test_profile_writes_trace(capsys, tmp_path):
    trace_dir = tmp_path / "trace"
    rec = _run(capsys, ["--batch", "2", "--iters", "1", *TINY, "--samples", "256", "--level-iters", "2",
                        "--profile", str(trace_dir)])
    assert rec["pairs_per_sec_per_chip"] > 0
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    assert any("register_depth_pair" in e.get("name", "") or e.get("cat") == "cpu_op" for e in events)


def test_unknown_pipeline_rejected():
    with pytest.raises(SystemExit):
        rs_benchmark.main(["--pipeline", "nope", "--device", "cpu"])


# --- the pipelines JAX's tests leave out -----------------------------------------


@pytest.mark.parametrize("pipeline,extra", [
    ("rgbd", ["--batch", "2", "--iters", "1", *TINY, "--samples", "256"]),
    ("gnc-icp", ["--batch", "2", "--iters", "1", "--points", "256"]),
    ("gicp", ["--batch", "2", "--iters", "1", "--points", "256"]),
])
def test_pair_pipeline(capsys, pipeline, extra):
    rec = _run(capsys, ["--pipeline", pipeline, *extra])
    assert list(rec) == PAIR_KEYS
    assert rec["pipeline"] == pipeline and rec["batch"] == 2
    assert rec["pairs_per_sec_per_chip"] > 0 and rec["ms_per_batch"] > 0


@pytest.mark.parametrize("pipeline,keys", [("slam", SLAM_KEYS), ("tsdf", TSDF_KEYS)])
def test_frame_pipeline(capsys, pipeline, keys):
    rec = _run(capsys, ["--pipeline", pipeline, "--batch", "4", *TINY])
    assert list(rec) == keys
    assert rec["window"] == 0 and rec["frames"] == 4
    assert rec["frames_per_sec_per_chip"] > 0


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        rs_benchmark.main(["--batch", "1", "--iters", "1", *TINY])


# --- the inputs and the batched RGB-D entry ------------------------------------------


def test_projective_inputs_follow_the_jax_recipe(monkeypatch):
    """The pair rendered at PAIR_TWIST, then per-pair noise drawn from
    RandomState(0) in the JAX CLI's order (src first, in one stream; here
    in blocks of NOISE_BLOCK frames), added in f32: bit-equal to the JAX
    CLI's numpy expression (rs_benchmark.py:79-85) on the same frames."""
    b, w, h = 3, 40, 30
    monkeypatch.setattr(rs_benchmark, "NOISE_BLOCK", 2)  # more than one block
    intr, src, dst, T = rs_benchmark.projective_inputs(b, w, h, torch.device("cpu"))
    d0, d1, T_ref = synthetic.render_pair(intr, torch.tensor(rs_benchmark.PAIR_TWIST), synthetic.default_scene())
    rng = np.random.RandomState(0)
    want_src = d1.numpy()[None] + 0.001 * rng.randn(b, h, w).astype(np.float32)
    want_dst = d0.numpy()[None] + 0.001 * rng.randn(b, h, w).astype(np.float32)
    np.testing.assert_array_equal(src.numpy(), want_src)
    np.testing.assert_array_equal(dst.numpy(), want_dst)
    np.testing.assert_array_equal(T.numpy(), T_ref.numpy())
    np.testing.assert_allclose(se3.log(T).numpy(), rs_benchmark.PAIR_TWIST, atol=1e-5)  # f32 exp then log


def test_batched_rgbd_equals_pairs_one_by_one():
    """The rgbd pipeline times one batched register_rgbd_pair over B pairs
    where JAX vmaps a one-pair function: each pair's transform equals its
    own B=1 registration."""
    intr = rs_benchmark.intrinsics(80, 60)
    cfg = rgbd_mod.RgbdIcpConfig(samples=256)
    ds, cs, _ = synthetic.render_trajectory_rgbd(intr, 2)
    g0, g1 = synthetic.intensity_from_rgb(cs[0]), synthetic.intensity_from_rgb(cs[1])
    rng = np.random.RandomState(0)
    src, dst = rs_benchmark._noisy(ds[1], 3, rng), rs_benchmark._noisy(ds[0], 3, rng)
    gs, gd = g1.expand(3, *g1.shape), g0.expand(3, *g0.shape)
    batched = rgbd_mod.register_rgbd_pair(src, gs, dst, gd, intr, cfg).transform
    for i in range(3):
        one = rgbd_mod.register_rgbd_pair(src[i:i + 1], gs[i:i + 1], dst[i:i + 1], gd[i:i + 1], intr, cfg).transform
        torch.testing.assert_close(batched[i], one[0], rtol=0, atol=1e-6)
    assert not torch.equal(batched[0], batched[1])  # distinct pairs
