"""Parity of the port's clouds, voxel downsample and world-map accumulator
with the JAX package (and the hash-map oracle of tests/reference_impl.py).

The cases mirror tests/test_voxel.py. Inputs are numpy arrays pinned to
f32 and fed to both sides. Keys, masks, indices and points are held EXACT
against JAX as it compiles these functions: XLA turns a division by a
constant into a multiply by its f32 reciprocal, which the port writes out
(camera.reciprocal), so voxel_coords and subsample_to_capacity are held to
their jitted JAX forms (JAX jits the others itself). Eager JAX divides,
which moves a point lying ON a voxel face, and only such a point, to the
neighbouring key. The poses here are identities and translations, whose
transform is exact in any summation order. Mask-weighted sums
(centroids) are held to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.geometry import se3 as jse3
from realsensetracker_tpu.ops import cloud as jcloud
from realsensetracker_tpu.ops import voxel as jvoxel
from realsensetracker_tpu.tracking import accumulator as jacc
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops import cloud, voxel
from realsensetracker_tpu_torch.tracking import accumulator as acc
from tests import reference_impl as ref


def _points(seed, n, scale=1.0, offset=(0.0, 0.0, 0.0)):
    rng = np.random.RandomState(seed)
    return (scale * rng.randn(n, 3) + np.asarray(offset)).astype(np.float32)


def _both(points, mask=None):
    """(JAX Cloud, port Cloud) of the same f32 points and mask."""
    mask = np.ones(len(points), bool) if mask is None else np.asarray(mask)
    return (jcloud.Cloud(jnp.asarray(points), jnp.asarray(mask)),
            cloud.Cloud(torch.from_numpy(points), torch.from_numpy(mask)))


def _assert_selection_equal(got, jref):
    idx, mask = got
    jidx, jmask = jref
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


# --- voxel keys and selection ----------------------------------------------


_jax_voxel_coords = jax.jit(jvoxel.voxel_coords, static_argnums=(1, 2))
_jax_subsample = jax.jit(jcloud.subsample_to_capacity, static_argnums=(1,))


@pytest.mark.parametrize("mode", ["floor", "trunc"])
def test_voxel_coords_and_keys_match_jax(mode):
    """Random points plus points on voxel faces, where a divide and a
    multiply by the reciprocal round to different sides: 4 (k + 0.5) / 120
    lies on a face of the 0.05 grid for every third k."""
    pts = _points(0, 400, scale=3.0)
    pts[:5] = [[0.05, -0.05, 0.1], [-0.0, 0.0, -0.1], [0.15, 0.25, -0.35], [30.0, -30.0, 0.0], [-0.049, 0.049, 0]]
    k = np.arange(-60, 60, dtype=np.float32)
    pts[100:220] = (np.float32(4.0) * (k + np.float32(0.5)) / np.float32(120.0))[:, None]
    mask = np.arange(400) % 7 != 0
    got = voxel.voxel_coords(torch.from_numpy(pts), 0.05, mode)
    jref = _jax_voxel_coords(jnp.asarray(pts), 0.05, mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref))
    keys = voxel.pack_keys(got, torch.from_numpy(mask))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jvoxel.pack_keys(jref, jnp.asarray(mask))))


@pytest.mark.parametrize("mode", ["floor", "trunc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_select_indices_matches_jax(seed, mode):
    pts = _points(seed, 500, scale=0.5)
    mask = np.random.RandomState(seed + 10).rand(500) > 0.2
    jc, pc = _both(pts, mask)
    _assert_selection_equal(voxel.voxel_select_indices(pc, 0.1, mode), jvoxel.voxel_select_indices(jc, 0.1, mode))


def test_selects_same_points_as_reference_hash_map():
    pts = _points(2, 500, scale=0.5)
    idx, mask = voxel.voxel_select_indices(cloud.from_points(torch.from_numpy(pts)), 0.1)
    assert set(idx[mask].tolist()) == set(ref.downsample_voxel_np(pts, 0.1))


def test_far_from_origin_cloud_not_collapsed():
    """Per-cloud recentring: 8 m out at 1 cm voxels still matches the
    unbounded hash-map oracle and JAX."""
    pts = _points(5, 400, scale=0.5, offset=(8.0, -8.0, 8.0))
    jc, pc = _both(pts)
    got = voxel.voxel_select_indices(pc, 0.01)
    expect = set(ref.downsample_voxel_np(pts, 0.01))
    assert len(expect) > 300
    assert set(got[0][got[1]].tolist()) == expect
    _assert_selection_equal(got, jvoxel.voxel_select_indices(jc, 0.01))


def test_first_point_wins():
    pts = np.array([[0.01, 0.01, 0.01], [0.02, 0.02, 0.02], [0.5, 0.5, 0.5]], np.float32)
    idx, mask = voxel.voxel_select_indices(cloud.from_points(torch.from_numpy(pts)), 0.1)
    assert set(idx[mask].tolist()) == {0, 2}  # index 1 shares index 0's voxel and loses


def test_masked_points_ignored():
    jc, pc = _both(np.array([[0.0, 0, 0], [1.0, 0, 0]], np.float32), [False, True])
    out = voxel.downsample_voxel(pc, 0.1)
    assert int(out.count()) == 1
    np.testing.assert_array_equal(out.points[0].numpy(), [1.0, 0, 0])
    jout = jvoxel.downsample_voxel(jc, 0.1)
    np.testing.assert_array_equal(out.points.numpy(), np.asarray(jout.points))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(jout.mask))


def test_all_unique_full_capacity():
    """count == n: the one case where JAX's parking slot n-1 is live."""
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    jc, pc = _both(pts)
    out = voxel.downsample_voxel(pc, 0.05)
    assert int(out.count()) == 10
    assert set(map(tuple, out.points.tolist())) == set(map(tuple, pts.tolist()))
    _assert_selection_equal(voxel.voxel_select_indices(pc, 0.05), jvoxel.voxel_select_indices(jc, 0.05))


def test_trunc_mode_differs_from_floor():
    c = cloud.from_points(torch.tensor([[-0.01, 0, 0], [0.01, 0, 0]]))
    assert int(voxel.downsample_voxel(c, 0.1, mode="floor").count()) == 2
    assert int(voxel.downsample_voxel(c, 0.1, mode="trunc").count()) == 1


def test_all_masked_cloud_is_empty():
    jc, pc = _both(_points(3, 16), np.zeros(16, bool))
    _assert_selection_equal(voxel.voxel_select_indices(pc, 0.1), jvoxel.voxel_select_indices(jc, 0.1))
    assert int(voxel.downsample_voxel(pc, 0.1).count()) == 0


@pytest.mark.parametrize("n", [5, 64, 200])
def test_front_order_is_a_stable_partition(n):
    flags = torch.from_numpy(np.random.RandomState(n).rand(n) > 0.6)
    perm = voxel.front_order(flags)
    np.testing.assert_array_equal(perm.numpy(), np.argsort(~flags.numpy(), kind="stable"))


def test_downsample_voxel_points_match_jax():
    pts = _points(7, 1000, scale=1.0, offset=(0.0, 0.0, 2.0))
    mask = np.random.RandomState(8).rand(1000) > 0.1
    jc, pc = _both(pts, mask)
    got, jref = voxel.downsample_voxel(pc, 0.05), jvoxel.downsample_voxel(jc, 0.05)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(jref.mask))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(jref.points))


# --- clouds ------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [100, 96, 300, 1000])
def test_subsample_to_capacity_matches_jax(capacity):
    """Fewer survivors than capacity pass through; more are strided
    uniformly (capacity 96 does not divide the count: the stride rounds)."""
    jc, pc = _both(_points(9, 600, scale=1.0))
    jd, pd = jvoxel.downsample_voxel(jc, 0.2), voxel.downsample_voxel(pc, 0.2)
    got, jref = cloud.subsample_to_capacity(pd, capacity), _jax_subsample(jd, capacity)
    assert got.points.shape == (capacity, 3)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(jref.mask))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(jref.points))


def test_cloud_reductions_match_jax():
    pts = _points(11, 300, scale=2.0)
    pts[3] = [np.nan, 0.0, 1.0]
    pts[8] = [np.inf, 1.0, 1.0]
    mask = np.random.RandomState(12).rand(300) > 0.3
    jc, pc = _both(pts, mask)
    jf, pf = jcloud.mask_nonfinite(jc), cloud.mask_nonfinite(pc)
    np.testing.assert_array_equal(pf.mask.numpy(), np.asarray(jf.mask))
    np.testing.assert_array_equal(pf.points.numpy(), np.asarray(jf.points))
    assert int(pf.count()) == int(jf.count())
    np.testing.assert_allclose(cloud.centroid(pf).numpy(), np.asarray(jcloud.centroid(jf)), atol=1e-6)
    w = np.random.RandomState(13).rand(300).astype(np.float32)
    np.testing.assert_allclose(
        cloud.weighted_centroid(pf.points, torch.from_numpy(w)).numpy(),
        np.asarray(jcloud.weighted_centroid(jf.points, jnp.asarray(w))), atol=1e-6,
    )
    for g, r in zip(cloud.extents(pf), jcloud.extents(jf)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_pad_to_capacity_matches_jax():
    pts = _points(14, 10)
    mask = np.arange(10) % 3 != 0
    for m in (None, mask):
        got = cloud.pad_to_capacity(pts, 16, m, device="cpu")
        jref = jcloud.pad_to_capacity(pts, 16, m)
        np.testing.assert_array_equal(got.points.numpy(), np.asarray(jref.points))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(jref.mask))
    assert cloud.pad_to_capacity(pts, 4, device="cpu").points.shape == (4, 3)


# --- the world-map accumulator ----------------------------------------------


def _translation(t):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    return T


def _assert_maps_equal(got, jref):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(jref.mask))
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(jref.keys))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(jref.points))


def _insert_both(capacity, clouds, voxel_size=0.05):
    """Insert the same (points, mask, pose) sequence into a JAX and a port
    map; returns both maps."""
    jm, pm = jacc.init_map(capacity), acc.init_map(capacity, device="cpu")
    for pts, mask, T in clouds:
        jc, pc = _both(pts, mask)
        jm = jacc.add_cloud(jm, jnp.asarray(T), jc, voxel_size)
        pm = acc.add_cloud(pm, torch.from_numpy(T), pc, voxel_size)
    return pm, jm


def test_init_map_matches_jax():
    _assert_maps_equal(acc.init_map(8, device="cpu"), jacc.init_map(8))


def test_insert_and_extract():
    pm, jm = _insert_both(64, [(_points(1, 20, scale=2.0), None, np.eye(4, dtype=np.float32))])
    assert int(pm.count()) == 20
    _assert_maps_equal(pm, jm)
    c = pm.extract_cloud()
    assert c.points is pm.points and c.mask is pm.mask


def test_existing_entries_win():
    p1 = np.array([[0.01, 0.01, 0.01]], np.float32)
    p2 = np.array([[0.03, 0.03, 0.03]], np.float32)  # the same voxel under trunc at 0.05
    I = np.eye(4, dtype=np.float32)
    pm, jm = _insert_both(16, [(p1, None, I), (p2, None, I)])
    assert int(pm.count()) == 1
    np.testing.assert_array_equal(pm.points[pm.mask].numpy(), p1)
    _assert_maps_equal(pm, jm)


def test_transform_applied():
    pm, jm = _insert_both(8, [(np.array([[0.2, 0.2, 0.2]], np.float32), None, _translation([1.0, 0, 0]))])
    np.testing.assert_allclose(pm.points[pm.mask].numpy(), [[1.2, 0.2, 0.2]], atol=1e-6)
    _assert_maps_equal(pm, jm)


def test_capacity_respected_nothing_evicted():
    I = np.eye(4, dtype=np.float32)
    pm, jm = _insert_both(8, [(_points(2, 32, scale=5.0), None, I), (_points(3, 32, scale=5.0), None, I)])
    assert int(pm.count()) == 8 and pm.points.shape == (8, 3)
    _assert_maps_equal(pm, jm)


def test_matches_reference_dedupe_across_clouds():
    rng = np.random.RandomState(3)
    a = rng.rand(40, 3).astype(np.float32)
    b = rng.rand(40, 3).astype(np.float32)
    I = np.eye(4, dtype=np.float32)
    pm, jm = _insert_both(128, [(a, None, I), (b, None, I)], voxel_size=0.1)
    _assert_maps_equal(pm, jm)
    ref_map = {}
    for p in np.concatenate([a, b]):
        ref_map.setdefault(tuple((p / np.float32(0.1)).astype(np.int32)), p)
    got = pm.points[pm.mask].numpy()
    assert sorted(map(tuple, got.tolist())) == sorted(map(tuple, np.stack(list(ref_map.values())).tolist()))


def test_masked_translated_stream_matches_jax():
    """Several masked clouds at translated poses, filling past capacity."""
    rng = np.random.RandomState(21)
    clouds = [
        (_points(30 + i, 300, scale=1.0, offset=(0, 0, 2)), rng.rand(300) > 0.25, _translation(0.05 * rng.randn(3)))
        for i in range(4)
    ]
    pm, jm = _insert_both(512, clouds)
    assert int(pm.count()) == 512
    _assert_maps_equal(pm, jm)


def test_rotated_insert_matches_jax():
    """A rotated pose: the transform's sums run in another order on each
    side (points within 1e-6); the keys still agree on these points."""
    tw = np.array([0.05, -0.02, 0.03, 0.1, -0.05, 0.08], np.float32)
    T = np.array(jse3.exp(jnp.asarray(tw)), np.float32)
    pts, mask = _points(40, 500, offset=(0, 0, 2)), np.ones(500, bool)
    pm, jm = _insert_both(1024, [(pts, mask, T)])
    np.testing.assert_array_equal(pm.mask.numpy(), np.asarray(jm.mask))
    np.testing.assert_array_equal(pm.keys.numpy(), np.asarray(jm.keys))
    np.testing.assert_allclose(pm.points.numpy(), np.asarray(jm.points), atol=1e-6)
    np.testing.assert_allclose(se3.transform_points(torch.from_numpy(T), torch.from_numpy(pts)).numpy(),
                               np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts))), atol=1e-6)


def test_map_from_jax_round_trip():
    pm, jm = _insert_both(64, [(_points(50, 40), None, np.eye(4, dtype=np.float32))])
    carried = interop.map_from_jax(jm, device="cpu")
    assert carried.keys.dtype == torch.int32 and carried.mask.dtype == torch.bool
    _assert_maps_equal(carried, jm)
    more = _points(51, 40)
    nxt = acc.add_cloud(carried, se3.identity(), cloud.from_points(torch.from_numpy(more)))
    jnxt = jacc.add_cloud(jm, jse3.identity(), jcloud.from_points(jnp.asarray(more)))
    _assert_maps_equal(nxt, jnxt)
