"""Parity of the port's marching-tetrahedra mesh extraction
(realsensetracker_tpu_torch/mapping/mesh.py) with the JAX package's jitted
extract_mesh, on the CPU.

The port derives its own copy of the triangle tables; they equal JAX's.
On the same volume (a JAX-fused 48^3 volume carried across by interop),
the triangle masks and their order are equal and the vertices and vertex
colors agree within 1e-6.
"""

import numpy as np
import pytest
import torch

from realsensetracker_tpu.mapping import mesh as JM
from realsensetracker_tpu.mapping import tsdf as J
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.mapping import mesh as PM
from realsensetracker_tpu_torch.mapping import tsdf as P
from tests.torch_parity import dense_configs, intrinsics, j32, render_rgbd, walk

JINTR, INTR = intrinsics(60, 80, 64.0)
JCFG, CFG = dense_configs()


@pytest.fixture(scope="module")
def fused():
    poses = walk(4)
    depths, colors = render_rgbd(INTR, poses, seed=2)
    jv = J.init_volume(JCFG, with_color=True)
    for d, c, T in zip(depths, colors, poses):
        jv = J.integrate(jv, j32(d), j32(T), JINTR, JCFG, color=j32(c))
    return jv, interop.tsdf_volume_from_jax(jv, device="cpu")


def test_tables_match_jax():
    np.testing.assert_array_equal(PM._TRI_TABLES, JM._TRI_TABLES)
    assert PM._TETS == JM._TETS and PM._TET_EDGES == JM._TET_EDGES
    np.testing.assert_array_equal(PM._CORNER_BITS, JM._CORNER_BITS)


@pytest.mark.parametrize("with_color", [False, True], ids=["plain", "colored"])
@pytest.mark.parametrize("capacity", [2048, 65536])
def test_extract_mesh_matches_jax(fused, with_color, capacity):
    """At 2048 the capacity subsample keeps the same triangles in both."""
    jv, pv = fused
    want = JM.extract_mesh(jv, JCFG, capacity, with_color=with_color)
    got = PM.extract_mesh(pv, CFG, capacity, with_color=with_color)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert int(got.count()) > 1000
    np.testing.assert_allclose(got.vertices.numpy(), np.asarray(want.vertices), rtol=0, atol=1e-6)
    if with_color:
        np.testing.assert_allclose(got.colors.numpy(), np.asarray(want.colors), rtol=0, atol=1e-6)
    else:
        assert got.colors is None and want.colors is None
    assert got.capacity == capacity


def test_normals_face_the_camera():
    """A wall at 2 m seen head on: every triangle's winding normal points
    back toward the camera (-z), as the JAX package's does."""
    vol = P.init_volume(CFG, device="cpu")
    for _ in range(2):
        P.integrate(vol, torch.full((60, 80), 2.0), torch.eye(4), INTR, CFG)
    m = PM.extract_mesh(vol, CFG, 16384)
    v = m.vertices[m.mask]
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    assert len(v) > 100 and bool((n[:, 2] < 0).all())
    assert float((v[..., 2] - 2.0).abs().max()) < 0.5 * CFG.voxel_size


def test_colored_mesh_needs_a_colored_volume(fused):
    _, pv = fused
    with pytest.raises(ValueError, match="colored volume"):
        PM.extract_mesh(P.TsdfVolume(pv.tsdf, pv.weight), CFG, 1024, with_color=True)


def test_empty_volume_has_no_triangles():
    m = PM.extract_mesh(P.init_volume(CFG, device="cpu"), CFG, 1024)
    assert int(m.count()) == 0 and m.vertices.shape == (1024, 3, 3)
