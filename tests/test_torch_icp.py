"""Parity of the port's nearest neighbours, k-NN PCA normals, Kabsch and
GNC-ICP with the JAX package and the NumPy oracles of
tests/reference_impl.py.

The cases mirror tests/test_align_parity.py; numpy makes the inputs,
pinned to f32, for every side. Bars: poses to 1e-4 (PARITY.md, the
BASELINE gate), 1-NN and k-NN indices exact, distances to 1e-5 relative,
normals to 1e-4. Kabsch and ICP accumulate their covariances in f64 on both
sides (the suite runs JAX with x64).

The k-NN tie cases use a 6x6x3 grid 1/16 m apart: every squared distance
is exact in f32 whatever the summation order, so equal distances are truly
equal and the order among them is the tie rule alone (the lower index
first, as jax.lax.top_k and the oracles' stable argsort).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import icp as jicp
from realsensetracker_tpu.align import kabsch as jkabsch
from realsensetracker_tpu.ops import cloud as jcloud
from realsensetracker_tpu.ops import correspond as jcorr
from realsensetracker_tpu.ops import normals as jnormals
from realsensetracker_tpu_torch.align import icp, kabsch
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops import cloud, correspond, normals
from tests import reference_impl as ref

BAR = 1e-4


def _cloud(seed, n, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(n, 3)).astype(np.float32)


def _pose(seed, rot_scale=0.2, trans_scale=0.3):
    tw = np.random.RandomState(seed).randn(6).astype(np.float32)
    tw[:3] *= trans_scale
    tw[3:] *= rot_scale
    return se3.exp(torch.from_numpy(tw)).numpy()


def _apply(T, pts):
    return (pts.astype(np.float64) @ T[:3, :3].T.astype(np.float64) + T[:3, 3]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def pose_error(Ta, Tb):
    """Max abs difference over the 3x4 pose block."""
    return float(np.max(np.abs(np.asarray(Ta)[:3] - np.asarray(Tb)[:3])))


# --- nearest neighbours -----------------------------------------------------


@pytest.mark.parametrize("chunk", [64, 2048])
def test_exact_1nn_matches_brute_force_and_jax(chunk):
    src, dst = _cloud(6, 257), _cloud(7, 123)
    idx, d2 = correspond.nearest_neighbors(_t(src), cloud.from_points(_t(dst)), chunk=chunk)
    full = ((src[:, None] - dst[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx.numpy(), full.argmin(1))
    np.testing.assert_allclose(d2.numpy(), full.min(1), rtol=1e-5, atol=1e-6)
    jidx, jd2 = jcorr.nearest_neighbors(jnp.asarray(src), jcloud.from_points(jnp.asarray(dst)), chunk=chunk)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-6)


def test_masked_dst_excluded():
    dst = cloud.Cloud(torch.tensor([[0.0, 0, 0], [10, 0, 0]]), torch.tensor([False, True]))
    idx, _ = correspond.nearest_neighbors(torch.tensor([[0.1, 0, 0]]), dst)
    assert int(idx[0]) == 1


def test_knn_sorted_and_exact():
    src, dst = _cloud(8, 65), _cloud(9, 90)
    mask = np.arange(90) % 5 != 0
    idx, d2 = correspond.knn(_t(src), cloud.Cloud(_t(dst), _t(mask)), k=5, chunk=32)
    full = np.where(mask[None], ((src[:, None] - dst[None]) ** 2).sum(-1), np.inf)
    expect = np.argsort(full, axis=1)[:, :5]
    np.testing.assert_array_equal(idx.numpy(), expect)
    np.testing.assert_allclose(d2.numpy(), np.take_along_axis(full, expect, 1), rtol=1e-5, atol=1e-6)
    jidx, jd2 = jcorr.knn(jnp.asarray(src), jcloud.Cloud(jnp.asarray(dst), jnp.asarray(mask)), k=5, chunk=32)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-6)


def _grid():
    """108 points on a 6x6x3 grid 1/16 m apart (exact squared distances)."""
    g = np.stack(np.meshgrid(np.arange(6), np.arange(6), np.arange(3), indexing="ij"), -1)
    return (g.reshape(-1, 3) / 16.0).astype(np.float32)


def test_knn_breaks_ties_by_index_as_jax():
    """On the grid, torch.topk (the search before the repair) orders equal
    distances its own way and even picks other neighbour sets; the repaired
    knn returns JAX's indices and the oracle's stable order."""
    g = _grid()
    pc = cloud.from_points(_t(g))
    idx, d2 = correspond.knn(_t(g), pc, k=16, chunk=40)
    jidx, jd2 = jcorr.knn(jnp.asarray(g), jcloud.from_points(jnp.asarray(g)), k=16, chunk=40)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    full = ((g[:, None].astype(np.float64) - g[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx.numpy(), np.argsort(full, axis=1, kind="stable")[:, :16])
    old = torch.topk(correspond._masked_sqdist(_t(g), pc), 16, dim=-1, largest=False, sorted=True).indices.numpy()
    jidx = np.asarray(jidx)
    assert (old != jidx).any(1).sum() > 50
    assert sum(set(a) != set(b) for a, b in zip(old, jidx)) > 20


@pytest.mark.parametrize("chunk", [32, 1024])
def test_knn_self_breaks_ties_by_index_as_jax(chunk):
    g = _grid()
    idx, d2 = correspond.knn_self(cloud.from_points(_t(g)), k=16, chunk=chunk)
    jidx, jd2 = jcorr.knn_self(jcloud.from_points(jnp.asarray(g)), k=16, chunk=chunk)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    assert (idx.numpy() != np.arange(len(g))[:, None]).all()


def test_knn_self_masked_matches_jax():
    """Invalid points and the query itself take _BIG; with fewer valid
    points than k the tail is _BIG padding, in index order."""
    pts = _cloud(25, 90)
    mask = np.random.RandomState(26).rand(90) > 0.3
    idx, d2 = correspond.knn_self(cloud.Cloud(_t(pts), _t(mask)), k=8, chunk=32)
    jidx, jd2 = jcorr.knn_self(jcloud.Cloud(jnp.asarray(pts), jnp.asarray(mask)), k=8, chunk=32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-6)
    sparse = np.zeros(40, bool)
    sparse[:5] = True
    idx, d2 = correspond.knn_self(cloud.Cloud(_t(pts[:40]), _t(sparse)), k=8)
    jidx, _ = jcorr.knn_self(jcloud.Cloud(jnp.asarray(pts[:40]), jnp.asarray(sparse)), k=8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (d2.numpy()[:5, 4:] >= 1e29).all()


# --- k-NN PCA normals ---------------------------------------------------------


@pytest.mark.parametrize("n,k", [(80, 8), (200, 16)])
def test_knn_pca_normals_match_reference_and_jax(n, k):
    """Unit normals along the smallest principal axis (sign free), faced to
    the viewpoint by orient_normals, as the oracle and JAX."""
    pts = _cloud(27 + n, n, scale=0.5)
    got = normals.knn_pca_normals(cloud.from_points(_t(pts)), k=k).numpy()
    jgot = np.asarray(jnormals.knn_pca_normals(jcloud.from_points(jnp.asarray(pts)), k=k))
    oracle = ref.compute_normals_np(pts, k=k)
    for other in (jgot, oracle):  # generic clouds: a simple smallest eigenvalue
        np.testing.assert_allclose(np.abs((got * other).sum(-1)), 1.0, atol=BAR)
    view = np.array([0.0, 0.0, -2.0], np.float32)
    oriented = normals.orient_normals(_t(pts), _t(got), _t(view)).numpy()
    np.testing.assert_allclose(oriented, ref.orient_normals_np(pts, jgot, view), atol=BAR)
    np.testing.assert_array_equal(
        oriented, np.asarray(jnormals.orient_normals(jnp.asarray(pts), jnp.asarray(got), jnp.asarray(view))))
    assert (((pts - view) * oriented).sum(-1) <= 0).all()


def test_knn_pca_normals_weight_out_padding():
    """Fewer valid points than k: the _BIG padding rows carry no weight."""
    pts = np.zeros((32, 3), np.float32)
    pts[:6] = np.array([[0, 0, 1], [0.1, 0, 1], [0, 0.1, 1], [0.1, 0.1, 1], [0.05, 0.02, 1], [0.02, 0.07, 1]])
    mask = np.arange(32) < 6
    got = normals.knn_pca_normals(cloud.Cloud(_t(pts), _t(mask)), k=8).numpy()[:6]
    jgot = np.asarray(jnormals.knn_pca_normals(jcloud.Cloud(jnp.asarray(pts), jnp.asarray(mask)), k=8))[:6]
    np.testing.assert_allclose(np.abs(got[:, 2]), 1.0, atol=1e-6)  # the plane z = 1
    np.testing.assert_allclose(np.abs((got * jgot).sum(-1)), 1.0, atol=1e-6)


def test_pairwise_sqdist_matches_jax():
    a, b = _cloud(10, 40, 3.0), _cloud(11, 70, 3.0)
    np.testing.assert_allclose(correspond.pairwise_sqdist(_t(a), _t(b)).numpy(),
                               np.asarray(jcorr.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-5)


# --- Kabsch -------------------------------------------------------------------


def test_kabsch_exact_rotation_recovered():
    src = _cloud(0, 50)
    T_true = _pose(1)
    T = kabsch.solve_kabsch(_t(src), _t(_apply(T_true, src)))
    assert pose_error(T, T_true) < BAR


def test_kabsch_matches_reference_and_jax_weighted():
    src = _cloud(2, 40)
    dst = _apply(_pose(3), src) + 0.01 * np.random.RandomState(0).randn(40, 3).astype(np.float32)
    w = np.random.RandomState(1).rand(40).astype(np.float32)
    T = kabsch.solve_kabsch(_t(src), _t(dst), weights=_t(w))
    assert pose_error(T, ref.solve_kabsch_np(src, dst, [(i, i) for i in range(40)], w)) < BAR
    jT = jkabsch.solve_kabsch(jnp.asarray(src), jnp.asarray(dst), weights=jnp.asarray(w))
    assert pose_error(T, jT) < BAR


def test_kabsch_masked_matches_subset():
    src = _cloud(4, 30)
    dst = _apply(_pose(5), src)
    keep = np.zeros(30, bool)
    keep[::2] = True
    T = kabsch.solve_kabsch(_t(src), _t(dst), mask=_t(keep))
    assert pose_error(T, ref.solve_kabsch_np(src, dst, [(i, i) for i in range(30) if keep[i]])) < BAR
    assert pose_error(T, jkabsch.solve_kabsch(jnp.asarray(src), jnp.asarray(dst), mask=jnp.asarray(keep))) < BAR


def test_kabsch_reflection_fix():
    """A planar, mirrored correspondence: U V^T is a reflection, and the fix
    flips R's third column as the reference does."""
    src = np.random.RandomState(2).randn(20, 3).astype(np.float32)
    src[:, 2] = 0.0
    dst = src.copy()
    dst[:, 0] *= -1
    R = se3.rotation(kabsch.solve_kabsch(_t(src), _t(dst))).numpy()
    assert np.linalg.det(R) > 0
    jR = np.asarray(jkabsch.solve_kabsch(jnp.asarray(src), jnp.asarray(dst)))[:3, :3]
    np.testing.assert_allclose(R, jR, atol=BAR)


def test_kabsch_batched_and_f64():
    """Leading batch dims broadcast; the covariance is f64 even from f32."""
    src = np.stack([_cloud(20 + i, 30) for i in range(3)])
    Ts = np.stack([_pose(30 + i) for i in range(3)])
    dst = np.stack([_apply(T, s) for T, s in zip(Ts, src)])
    got = kabsch.solve_kabsch(_t(src), _t(dst))
    assert got.shape == (3, 4, 4) and got.dtype == torch.float32
    for g, T in zip(got.numpy(), Ts):
        assert pose_error(g, T) < BAR


# --- GNC-ICP ------------------------------------------------------------------


def test_icp_matches_reference_and_jax():
    """Full GNC-ICP against the golden NumPy transcription: the 1e-4 gate."""
    src = _cloud(10, 120)
    dst = _apply(_pose(11, rot_scale=0.1, trans_scale=0.1), src)
    T_ref, cost_ref = ref.align_icp_np(src, dst, max_iter=32)
    res = icp.align_icp(cloud.from_points(_t(src)), cloud.from_points(_t(dst)), max_iter=32)
    assert pose_error(res.transform, T_ref) < BAR
    assert abs(float(res.mean_cost) - cost_ref) < BAR
    jres = jicp.align_icp(jcloud.from_points(jnp.asarray(src)), jcloud.from_points(jnp.asarray(dst)), max_iter=32)
    assert pose_error(res.transform, jres.transform) < BAR
    assert abs(float(res.mean_cost) - float(jres.mean_cost)) < BAR
    assert bool(res.success) and int(res.num_valid) == 120


def test_icp_recovers_known_transform():
    src = _cloud(12, 200, scale=2.0)
    T_true = _pose(13, rot_scale=0.05, trans_scale=0.05)
    res = icp.align_icp(cloud.from_points(_t(src)), cloud.from_points(_t(_apply(T_true, src))), max_iter=64)
    assert pose_error(res.transform, T_true) < 1e-3
    assert bool(res.success)


def test_icp_masked_points_ignored():
    src = _cloud(14, 100)
    dst = _apply(_pose(15, rot_scale=0.05, trans_scale=0.05), src)
    src_aug = np.concatenate([src, 100.0 + _cloud(16, 28)])
    mask = np.concatenate([np.ones(100, bool), np.zeros(28, bool)])
    res = icp.align_icp(cloud.Cloud(_t(src_aug), _t(mask)), cloud.from_points(_t(dst)), max_iter=32)
    T_ref, _ = ref.align_icp_np(src, dst, max_iter=32)
    assert pose_error(res.transform, T_ref) < BAR


@pytest.mark.parametrize("chunk", [64, 2048])
def test_icp_masked_clouds_with_init_match_jax(chunk):
    """Masked src and dst, a warm start and a chunked search, as the
    trackers call it."""
    src = _cloud(17, 300, scale=1.5)
    dst = _apply(_pose(18, rot_scale=0.08, trans_scale=0.08), _cloud(17, 300, scale=1.5))
    sm = np.random.RandomState(19).rand(300) > 0.2
    dm = np.random.RandomState(20).rand(300) > 0.1
    init = _pose(21, rot_scale=0.02, trans_scale=0.02)
    res = icp.align_icp(cloud.Cloud(_t(src), _t(sm)), cloud.Cloud(_t(dst), _t(dm)), 24, _t(init), chunk)
    jres = jicp.align_icp(jcloud.Cloud(jnp.asarray(src), jnp.asarray(sm)),
                          jcloud.Cloud(jnp.asarray(dst), jnp.asarray(dm)), 24, jnp.asarray(init), chunk)
    assert pose_error(res.transform, jres.transform) < BAR
    assert abs(float(res.mean_cost) - float(jres.mean_cost)) < BAR


def test_icp_too_few_points_keeps_init():
    init = _pose(22, rot_scale=0.02, trans_scale=0.02)
    src = cloud.Cloud(_t(_cloud(23, 10)), _t(np.arange(10) < 2))
    res = icp.align_icp(src, cloud.from_points(_t(_cloud(24, 10))), 8, _t(init))
    np.testing.assert_array_equal(res.transform.numpy(), init)
    assert not bool(res.success)


def test_gnc_schedule_matches_reference():
    mu, expect = np.float32(1.0), []
    for it in range(40):
        if it > 0 and it % 8 == 0:
            mu = np.float32(mu / np.float32(1.4))
        expect.append(float(mu))
    assert icp.gnc_schedule(40) == expect
