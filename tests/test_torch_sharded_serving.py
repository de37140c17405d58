"""The port's sharded serving (streams.shard_streams, BatchingConfig(mesh=...),
rs_serve --batch-mesh) and sharded atlas verification
(submaps._verify_submap_pairs(mesh=...)) on 2 gloo ranks, against the JAX
package on the conftest's 8-device CPU mesh.

One module-scoped group of 2 spawned ranks (tests/torch_ranks.py) runs
every scenario: the executor on rank 0, run_worker on rank 1. The cases
twin tests/test_batching.py:444-480 (S = 3 depth sessions of 4 frames at
100x75 in 4 slots, window 2, then a fresh session's 2-frame window of u16
frames) and
:957-990 (2 dense sessions at 80x60 into 48^3 volumes), and
tests/test_submaps.py:521 (5 candidate pairs of 4 surfaces, padded to 8
rows over the ranks). Bars: sessions' poses within 1e-4 of JAX's streams
(the port's serving bar, tests/test_torch_batching.py) and exactly equal
to the port's unsharded executor on the same requests (each slot computes
what it computes alone; the dense case within 1e-6, its one slot per rank
registering at B = 1, where torch's CPU matmul sums in another order);
the pair verification exactly equal to the unsharded verification, and
within 1e-5 of JAX's sharded verification on the same surfaces and
features with the same accept flags.
"""

import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.api import batching as jbatching
from realsensetracker_tpu.data import synthetic as jsyn
from realsensetracker_tpu.mapping import submaps as jsubmaps
from realsensetracker_tpu.mapping.tsdf import TsdfConfig as JTsdfConfig
from realsensetracker_tpu.ops import cloud as jcloud
from realsensetracker_tpu.parallel import streams as jst
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.api.batching import BatchedExecutor, BatchingConfig
from realsensetracker_tpu_torch.api.service import post_frame
from realsensetracker_tpu_torch.mapping import tsdf as ptsdf
from realsensetracker_tpu_torch.ops import fpfh
from realsensetracker_tpu_torch.tracking.tsdf_tracker import TsdfTracker
from tests import torch_ranks
from tests.torch_parity import intrinsics, render, walk

JINTR = jproj.camera.Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=37.0, width=100, height=75)
JCFG = jproj.ProjectiveIcpConfig(iters=(5, 5, 6), samples=1024)
INTR, CFG = interop.intrinsics_from_jax(JINTR), interop.icp_config_from_jax(JCFG)
S, F = 3, 4
JTSDF_INTR = jproj.camera.Intrinsics(fx=64.0, fy=64.0, cx=39.5, cy=29.5, width=80, height=60)
JTSDF_ICP = jproj.ProjectiveIcpConfig(iters=(3, 3), inner_iters=2, samples=768, min_samples=192)
JVOL = JTsdfConfig(resolution=48, voxel_size=0.12, origin=(-2.88, -2.16, -0.4), trunc=0.36, max_range=5.0)
TSDF_INTR, TSDF_ICP = interop.intrinsics_from_jax(JTSDF_INTR), interop.icp_config_from_jax(JTSDF_ICP)
VOL = interop.tsdf_config_from_jax(JVOL)
S3 = 2
ATOL = 1e-4
DEPTH_KW = dict(intrinsics=INTR._asdict(), icp=CFG._asdict(), window=2, depth_scale=2e-4)
DENSE_KW = dict(intrinsics=TSDF_INTR._asdict(), icp=TSDF_ICP._asdict(), tsdf=True, tsdf_cfg=VOL._asdict())

# The atlas pair verification: 4 surfaces of a 48^3 x 5 cm volume, each
# fused from one frame of a short walk at identity (so pair (i, j)'s truth
# is the walk's relative pose).
VJINTR, VINTR = intrinsics(60, 80, 64.0)
VVOL = ptsdf.TsdfConfig(resolution=48, voxel_size=0.05, origin=(-1.2, -1.2, -0.2625), trunc=0.15, max_range=3.0,
                        max_depth=4.0)
PAIRS = [(0, 1), (0, 2), (1, 3), (2, 3), (0, 3)]
VERIFY_KW = dict(noise_bound=4 * 0.05, overlap_tau=2 * 0.05, min_overlap=0.7, refine_iters=8)


@pytest.fixture(scope="module")
def stream_data():
    """(F, S, H, W): S independent trajectories (tests/test_torch_batching.py)."""
    out = []
    for i in range(S):
        d, _ = jsyn.render_trajectory(JINTR, F, scene=jsyn.default_scene(seed=20 + i), seed=i, step_scale=0.015)
        out.append(np.asarray(d, np.float32))
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def tsdf_data():
    out = []
    for i in range(S3):
        d, _ = jsyn.render_trajectory(JTSDF_INTR, F, scene=jsyn.default_scene(seed=30 + i), seed=i, step_scale=0.01)
        out.append(np.asarray(d, np.float32))
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def atlas():
    """(points, masks, features, pairs, kwargs) of the 4 surfaces, numpy."""
    depths = render(VINTR, walk(4, step=(0.02, 0.0, 0.01, 0.0, 0.01, 0.0)), seed=3)
    points, masks, feats = [], [], []
    for d in depths:
        vol = ptsdf.integrate(ptsdf.init_volume(VVOL, device="cpu"), torch.from_numpy(d), torch.eye(4), VINTR, VVOL)
        c, n = ptsdf.extract_surface_oriented(vol, VVOL, 512)
        points.append(c.points.numpy())
        masks.append(c.mask.numpy())
        feats.append(fpfh.compute_fpfh_from_normals(c, n, 6 * VVOL.voxel_size, 64).numpy())
    return points, masks, feats, PAIRS, VERIFY_KW


@pytest.fixture(scope="module")
def ranks(stream_data, tsdf_data, atlas):
    return torch_ranks.run_ranks(2, torch_ranks.serving_scenario, stream_data, tsdf_data, DEPTH_KW, DENSE_KW, atlas)


def _unsharded(drive, data, **kw):
    """The same requests through the port's one-device executor."""
    ex = BatchedExecutor(BatchingConfig(device="cpu", request_timeout_s=60.0, **kw))
    try:
        return drive(ex, data)
    finally:
        ex.close()


def test_capacity_must_split_over_the_data_ranks(ranks):
    assert ranks[0]["capacity"].startswith("ValueError: capacity (3) must be a multiple of the mesh 'data'")
    assert ranks[1]["capacity"] == ranks[0]["capacity"]
    assert ranks[0]["not_rank0"].startswith("ValueError: data rank 0 runs the BatchedExecutor")
    assert ranks[1]["not_rank0"].startswith("ValueError: the executor runs on data rank 0")


@pytest.mark.parametrize("kind", ["depth", "rgbd", "tsdf"])
def test_shard_streams_keeps_this_ranks_slot_block(ranks, kind):
    for r in ranks:
        same_type, rows_equal = r["shard_streams"][kind]
        assert same_type and rows_equal


def test_mesh_sharded_executor_matches_unsharded(ranks, stream_data):
    from tests.torch_ranks import drive_depth_sessions

    got = ranks[0]["depth"]
    assert ranks[1]["depth"] is None  # the worker rank serves, it holds no sessions
    ref = jst.init_streams(jnp.asarray(stream_data[0]), JINTR, JCFG)
    for f in range(1, F):
        ref, _ = jst.step_streams(ref, jnp.asarray(stream_data[f]), JINTR, JCFG)
    for i in range(S):
        np.testing.assert_allclose(got["poses"][i], np.asarray(ref.poses[i]), rtol=0, atol=ATOL)
    # The windowed round also runs sharded, on u16 frames (their bytes
    # scattered): a fresh session's 2-frame window matches its per-frame
    # twin within the u16 quantization (tests/test_torch_batching.py).
    two = jst.step_streams(jst.init_streams(jnp.asarray(stream_data[0, :1]), JINTR, JCFG),
                           jnp.asarray(stream_data[1, :1]), JINTR, JCFG)[0]
    assert all(ok for ok, _ in got["window"])
    np.testing.assert_allclose(got["window"][1][1], np.asarray(two.poses[0]), rtol=0, atol=2e-4)
    assert got["stats"]["frames"] == S * F + 2 and got["stats"]["errors"] == 0
    plain = _unsharded(drive_depth_sessions, stream_data, intrinsics=INTR, icp=CFG, capacity=4, window=2,
                       depth_scale=2e-4)
    for a, b in zip(got["poses"], plain["poses"]):
        np.testing.assert_array_equal(a, b)
    for (_, a), (_, b) in zip(got["window"], plain["window"]):
        np.testing.assert_array_equal(a, b)


def test_mesh_sharded_tsdf_executor_matches_tracker(ranks, tsdf_data):
    from tests.torch_ranks import drive_dense_sessions

    got = ranks[0]["dense"]
    for i in range(S3):
        tr = TsdfTracker(TSDF_INTR, volume=VOL, icp=TSDF_ICP, device="cpu")
        for f in range(F):
            tr.process(tsdf_data[f, i], float(f))
        np.testing.assert_allclose(got["poses"][i], tr.pose, rtol=0, atol=ATOL)
    js = jst.blank_tsdf_streams(JTSDF_INTR, JVOL, num_streams=S3)
    on = jnp.ones(S3, bool)
    for f in range(F):
        js, _ = jst.step_tsdf_streams_masked(js, jnp.asarray(tsdf_data[f]), on, jnp.full(S3, f == 0),
                                             JTSDF_INTR, JVOL, JTSDF_ICP)
    np.testing.assert_allclose(np.stack(got["poses"]), np.asarray(js.poses), rtol=0, atol=ATOL)
    # One slot per rank registers at B = 1, where torch's CPU matmul sums
    # in another order than at B = 2 (1.9e-8 apart on these poses).
    plain = _unsharded(drive_dense_sessions, tsdf_data, intrinsics=TSDF_INTR, icp=TSDF_ICP, capacity=2, tsdf=True,
                       tsdf_cfg=VOL)
    for a, b in zip(got["poses"], plain["poses"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_sharded_pair_verify_matches_single_device(ranks, atlas):
    points, masks, feats, pairs, kw = atlas
    for r in ranks:
        (T, ok, ov), (T0, ok0, ov0) = r["verify"]
        assert T.shape == (len(pairs), 4, 4)
        np.testing.assert_array_equal(T, T0)
        np.testing.assert_array_equal(ok, ok0)
        np.testing.assert_array_equal(ov, ov0)
    surfs = [jcloud.Cloud(points=jnp.asarray(p), mask=jnp.asarray(m)) for p, m in zip(points, masks)]
    jfeats = [jnp.asarray(f) for f in feats]
    jT, jok, jov = jsubmaps._verify_submap_pairs(surfs, jfeats, pairs, mesh=Mesh(np.asarray(jax.devices()), ("data",)),
                                                 **kw)
    (T, ok, ov), _ = ranks[0]["verify"]
    assert ok.any()
    np.testing.assert_array_equal(ok, np.asarray(jok))
    np.testing.assert_allclose(T, np.asarray(jT), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ov, np.asarray(jov), rtol=0, atol=1e-5)


def test_batching_config_from_jax_carries_the_port_mesh():
    mesh = object()  # stands for a parallel.mesh DeviceMesh: the config only carries it
    jcfg = jbatching.BatchingConfig(intrinsics=JINTR, icp=JCFG, capacity=8, mesh=object(), data_axis="slots")
    cfg = interop.batching_config_from_jax(jcfg, device="cpu", mesh=mesh)
    assert cfg.mesh is mesh and cfg.data_axis == "slots" and cfg.capacity == 8
    with pytest.raises(ValueError, match="port's mesh"):
        interop.batching_config_from_jax(jcfg, device="cpu")


def test_rs_serve_batch_mesh_answers_requests(stream_data, capsys):
    """rs_serve --batched --batch-mesh 2 --device cpu: this process is rank 0
    and serves HTTP, the CLI spawns rank 1; two frames are tracked."""
    from realsensetracker_tpu_torch.cli import rs_serve

    argv = ["--batched", "--batch-mesh", "2", "--batch-capacity", "2", "--device", "cpu", "--width", "100",
            "--height", "75", "--fx", "100", "--max-frames", "2"]
    rc = {}
    th = threading.Thread(target=lambda: rc.setdefault("rc", rs_serve.main(argv)))
    th.start()
    port, out = None, ""
    for _ in range(600):
        out += capsys.readouterr().out
        m = re.search(r"http://127\.0\.0\.1:(\d+)/", out)
        if m:
            port = int(m.group(1))
            break
        time.sleep(0.1)
    assert port, "service did not start"
    for f in range(2):
        r = post_frame(f"http://127.0.0.1:{port}", stream_data[f, 0], f / 30.0, timeout=60)
        assert r["success"]
    th.join(timeout=120)
    assert not th.is_alive()
    out += capsys.readouterr().out
    assert rc["rc"] == 0 and "served 2 frames" in out and "(batched, 100x75)" in out
