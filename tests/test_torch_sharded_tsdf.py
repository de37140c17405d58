"""The port's x-slab TSDF volume (realsensetracker_tpu_torch/mapping/sharded.py)
on 4 gloo ranks, against the JAX package's sharded volume on the
conftest's 8-device CPU mesh.

One module-scoped group of 4 spawned ranks (tests/torch_ranks.py) runs
every scenario of tests/test_sharded_tsdf.py on the same frames (4 80x60
depth frames rendered by the port along a short walk, the JAX test's
10 cm voxels in a 48^3 volume). Bars, JAX's own: integrate
and color within 1e-6, raycast within 1e-5 with over 30% of rays hitting,
mesh extraction with equal counts and vertices within 1e-5, the tracker
resharded mid-stream within 1e-5 of the unsharded tracker. Against the
port's unsharded volume on the same rank every result is bit-identical:
each slab computes its voxels exactly as the whole volume does.
"""

import jax
import numpy as np
import pytest

from realsensetracker_tpu.align.projective import ProjectiveIcpConfig as JIcp
from realsensetracker_tpu.mapping import mesh as jmesh_extract
from realsensetracker_tpu.mapping import sharded as jsh
from realsensetracker_tpu.mapping import tsdf as jtsdf
from realsensetracker_tpu.parallel.mesh import make_mesh as jmake_mesh
from realsensetracker_tpu.tracking.tsdf_tracker import TsdfTracker as JTsdfTracker
from tests import torch_ranks
from tests.torch_parity import intrinsics, j32, render, walk

JINTR, INTR = intrinsics(60, 80, 64.0)
# The JAX test's 10 cm voxels at V = 48 (12-plane slabs here, 6 in JAX): the
# port's integrate takes compiled XLA's fused multiply-adds as XLA lays
# them out at V = 48; at V = 64 an ulp of some voxels' z moves ~0.4% of
# them by up to 3e-6 against JAX (ROADMAP §3's record of compiled XLA's FMAs).
CFG = dict(resolution=48, voxel_size=0.1, origin=(-2.4, -2.4, -0.3), trunc=0.3, max_range=5.0)
JCFG = jtsdf.TsdfConfig(**CFG)
ICP = dict(iters=(3, 3), inner_iters=2, samples=768, min_samples=192)


@pytest.fixture(scope="module")
def frames():
    poses = walk(4, step=(0.01, -0.005, 0.02, 0.004, 0.006, -0.003))
    return render(INTR, poses, seed=3), poses


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(8)


@pytest.fixture(scope="module")
def ranks(frames):
    depths, poses = frames
    return torch_ranks.run_ranks(4, torch_ranks.tsdf_scenario, depths, poses, INTR._asdict(), CFG, ICP)


@pytest.fixture(scope="module")
def jax_volume(frames, jmesh):
    depths, poses = frames
    vol = jsh.init_volume_sharded(JCFG, jmesh)
    for i in range(len(depths)):
        vol = jsh.integrate(vol, j32(depths[i]), j32(poses[i]), JINTR, JCFG)
    return vol


def test_layout(ranks):
    for r in ranks:
        assert r["placements"] and r["global_shape"] == (48, 48, 48)
        assert r["local_shape"] == (12, 48, 48)  # 48 planes over 4 ranks


def test_indivisible_resolution_rejected(ranks):
    assert ranks[0]["indivisible"].startswith("ValueError: volume resolution 62 not divisible")


def test_integrate_parity_and_layout_stability(ranks, jax_volume):
    for r in ranks:
        assert r["layout_kept"] and r["exact"] and r["window_exact"]
    np.testing.assert_allclose(ranks[0]["tsdf"], np.asarray(jax_volume.tsdf), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["weight"], np.asarray(jax_volume.weight), rtol=0, atol=1e-6)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["tsdf"], ranks[0]["tsdf"])


def test_raycast_parity(ranks, frames, jmesh):
    depths, poses = frames
    vol = jsh.init_volume_sharded(JCFG, jmesh)
    for i in range(3):
        vol = jsh.integrate(vol, j32(depths[i]), j32(poses[i]), JINTR, JCFG)
    d_jax = np.asarray(jsh.raycast(vol, j32(poses[0]), JINTR, JCFG))
    for r in ranks:
        np.testing.assert_array_equal(r["raycast"], r["raycast_plain"])
        np.testing.assert_allclose(r["raycast"], d_jax, rtol=0, atol=1e-5)
    assert (ranks[0]["raycast"] > 0).mean() > 0.3  # the render hit surface


def test_colored_volume_shards(ranks, frames, jmesh):
    depths, poses = frames
    color = np.full((60, 80, 3), 0.4, np.float32)
    vol = jsh.init_volume_sharded(JCFG, jmesh, with_color=True)
    vol = jsh.integrate(vol, j32(depths[0]), j32(poses[0]), JINTR, JCFG, color=j32(color))
    assert ranks[0]["color_exact"]
    np.testing.assert_allclose(ranks[0]["color"], np.asarray(vol.color), rtol=0, atol=1e-6)


def test_mesh_extraction_from_sharded(ranks, frames, jmesh):
    depths, poses = frames
    vol = jsh.integrate(jsh.init_volume_sharded(JCFG, jmesh), j32(depths[0]), j32(poses[0]), JINTR, JCFG)
    m_jax = jmesh_extract.extract_mesh(vol, JCFG, capacity=16384)
    verts, mask = ranks[0]["mesh"]
    assert all(r["mesh_exact"] for r in ranks)
    assert int(mask.sum()) == int(m_jax.count()) > 500
    np.testing.assert_allclose(verts[mask], np.asarray(m_jax.vertices)[np.asarray(m_jax.mask)], rtol=0, atol=1e-5)


def test_tracker_step_on_sharded_volume(ranks, frames, jmesh):
    """A TsdfTracker whose volume is resharded mid-stream routes integrate
    and raycast through mapping/sharded: its poses are the unsharded
    tracker's, and JAX's sharded tracker's within 1e-5."""
    depths, _ = frames
    jt = JTsdfTracker(JINTR, volume=JCFG, icp=JIcp(**ICP))
    for i in range(2):
        jt.process(np.asarray(depths[i]), float(i))
    jt._vol = jsh.shard_volume(jt._vol, jmesh)
    for r in ranks:
        assert r["tracker_still_sharded"]
        for i, (ok_a, ok_b, pa, pb) in enumerate(r["tracker"]):
            assert ok_a and ok_b
            np.testing.assert_array_equal(pa, pb)
            if r is ranks[0]:
                jr = jt.process(np.asarray(depths[2 + i]), float(2 + i))
                np.testing.assert_allclose(pb, jr.pose, rtol=0, atol=1e-5)


def test_eight_jax_devices_available():
    assert jax.device_count() >= 8
