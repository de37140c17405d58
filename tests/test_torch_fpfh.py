"""Parity of the port's FPFH (ops/fpfh.py) with the JAX package and the
NumPy transcription of fpfh.cpp in tests/reference_impl.py.

numpy makes every input from a seed, pinned to f32. Bars: features and
histograms to 1e-4 (PARITY.md C2-C19), neighbourhoods, flags, counts and
match indices exact, normals to 1e-5. Normals for the feature cases come
from the port's k-NN PCA and are fed to both sides.

Where a case meets a near tie, the features are held to the JAX functions
run op by op (``jax.disable_jit``), which round as the port does.
Compiled, XLA contracts the pair features into FMAs, and the origin switch
|n1.d| < |n2.d| (fpfh.cpp:41) of a pair whose normals agree to a few ulps
(neighbours with the same k-NN set) then goes either way: one pair's f3
changes sign, and the SPFH weight moves between mirror bins.
test_compiled_jax_parts_from_the_oracle_at_a_switch_near_tie shows such a
pair, where the port and the oracle agree and compiled JAX does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.ops import cloud as jcloud
from realsensetracker_tpu.ops import fpfh as jfpfh
from realsensetracker_tpu.ops import normals as jnormals
from realsensetracker_tpu_torch.ops import cloud, fpfh, normals
from tests import reference_impl as ref

BAR = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(pts, mask=None):
    m = np.ones(len(pts), bool) if mask is None else mask
    return cloud.Cloud(_t(pts), _t(m)), jcloud.Cloud(jnp.asarray(pts), jnp.asarray(m))


def _cloud_and_normals(n, seed, scale=0.5):
    """(points, port cloud, JAX cloud, oriented normals (numpy)) of a
    Gaussian cloud, normals from 8-NN PCA faced to the origin."""
    pts = (scale * np.random.RandomState(seed).randn(n, 3)).astype(np.float32)
    pc, jc = _both(pts)
    nrm = normals.orient_normals(pc.points, normals.knn_pca_normals(pc, k=8), torch.zeros(3))
    return pts, pc, jc, nrm.numpy()


def _eager(fn, *args):
    """A JAX function evaluated op by op."""
    with jax.disable_jit():
        return fn(*args)


def _dense_cloud(n_dense=100, n_far=20, seed=7):
    """tests/test_fpfh.py:83-91: a packed ball inside the radius, far shell."""
    rng = np.random.RandomState(seed)
    dense = np.clip(0.1 * rng.randn(n_dense, 3).astype(np.float32), -0.2, 0.2)
    far = 5.0 + rng.rand(n_far, 3).astype(np.float32)
    return np.vstack([dense, far]).astype(np.float32)


# --- pair features and histograms ------------------------------------------------


def test_pair_features_match_reference_and_jax():
    rng = np.random.RandomState(0)
    p1, p2 = rng.randn(64, 3).astype(np.float32), rng.randn(64, 3).astype(np.float32)
    n1, n2 = rng.randn(64, 3), rng.randn(64, 3)
    n1 = (n1 / np.linalg.norm(n1, axis=1, keepdims=True)).astype(np.float32)
    n2 = (n2 / np.linalg.norm(n2, axis=1, keepdims=True)).astype(np.float32)
    p2[5], n2[5] = p1[5], n1[5]  # zero distance: invalid
    f, ok = fpfh.pair_features(*map(_t, (p1, n1, p2, n2)))
    jf, jok = jfpfh.pair_features(*map(jnp.asarray, (p1, n1, p2, n2)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)
    assert not ok[5] and (f[5] == 0).all()
    for i in range(64):
        f_ref, ok_ref = ref.compute_pfh_np(p1[i], n1[i], p2[i], n2[i])
        assert bool(ok[i]) == ok_ref
        if ok_ref:
            np.testing.assert_allclose(f[i].numpy(), f_ref, atol=1e-5)


def test_histogram_matches_jax():
    rng = np.random.RandomState(1)
    feats = np.stack([rng.uniform(-3.3, 3.3, (20, 16)), rng.uniform(-2.2, 2.2, (20, 16)),
                      rng.uniform(-1.1, 1.1, (20, 16))], -1).astype(np.float32)
    w = rng.rand(20, 16).astype(np.float32)
    got = fpfh._histogram(_t(feats), _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfpfh._histogram(jnp.asarray(feats), jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(got.reshape(20, 3, 11).sum(-1), np.repeat(w.sum(-1)[:, None], 3, 1), rtol=1e-5)


# --- SPFH and FPFH -----------------------------------------------------------------


@pytest.mark.parametrize("cap", [16, 64])
def test_spfh_and_neighbourhood_match_jax(cap):
    """Below the densest ball the cap truncates (flag set), above it not."""
    pts, pc, jc, nrm = _cloud_and_normals(60, seed=2)
    got = fpfh.compute_spfh(pc, _t(nrm), 0.6, cap)
    want = _eager(jfpfh.compute_spfh, jc, jnp.asarray(nrm), 0.6, cap)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-6)
    assert bool(got[4]) == bool(want[4]) == bool(jfpfh.compute_spfh(jc, jnp.asarray(nrm), 0.6, cap)[4]) == (cap == 16)


@pytest.mark.parametrize("n,seed,radius", [(50, 0, 0.8), (40, 1, 0.8), (120, 3, 0.5)])
def test_fpfh_from_normals_matches_reference_and_jax(n, seed, radius):
    pts, pc, jc, nrm = _cloud_and_normals(n, seed)
    f, truncated = fpfh.compute_fpfh_from_normals_checked(pc, _t(nrm), radius, max_neighbors=n)
    np.testing.assert_allclose(f.numpy(), ref.compute_fpfh_np(pts, nrm, radius), atol=BAR)
    np.testing.assert_allclose(f.numpy(), np.asarray(jfpfh.compute_fpfh_from_normals(jc, jnp.asarray(nrm), radius, n)),
                               atol=BAR)
    assert not bool(truncated)
    seg = f.numpy().reshape(-1, 3, 11).sum(-1)
    assert np.all((np.abs(seg - 1.0) < BAR) | (seg < 1e-6))  # unit segments, or empty


@pytest.mark.parametrize("n,k,radius,cap", [(200, 16, 0.5, 64), (160, 8, 0.3, 32)])
def test_fpfh_pipeline_matches_jax(n, k, radius, cap):
    """compute_fpfh_checked: k-NN PCA normals -> orientation -> FPFH. The
    normals agree with JAX's to 1e-5 (another eigh); the features are JAX's
    for the port's normals, and the truncation flag is compiled JAX's."""
    pts = (0.5 * np.random.RandomState(n).randn(n, 3)).astype(np.float32)
    pc, jc = _both(pts)
    view = np.array([0.1, -0.2, -3.0], np.float32)
    f, tr = fpfh.compute_fpfh_checked(pc, _t(view), k, radius, cap)
    nrm = normals.orient_normals(pc.points, normals.knn_pca_normals(pc, k), _t(view))
    jnrm = jnormals.orient_normals(jc.points, jnormals.knn_pca_normals(jc, k), jnp.asarray(view))
    np.testing.assert_allclose(nrm.numpy(), np.asarray(jnrm), atol=1e-5)
    np.testing.assert_array_equal(fpfh.compute_fpfh_from_normals(pc, nrm, radius, cap).numpy(), f.numpy())
    jf = _eager(jfpfh.compute_fpfh_from_normals, jc, jnp.asarray(nrm.numpy()), radius, cap)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=BAR)
    assert bool(tr) == bool(jfpfh.compute_fpfh_checked(jc, jnp.asarray(view), k, radius, cap)[1])
    np.testing.assert_array_equal(fpfh.compute_fpfh(pc, _t(view), k, radius, cap).numpy(), f.numpy())


def test_compiled_jax_parts_from_the_oracle_at_a_switch_near_tie():
    """60 points, radius 0.6: the port's FPFH is the oracle's, compiled
    JAX's is not. Their SPFH differ in one row, by one pair whose f3 takes
    the other sign: its |n1.d| and |n2.d| differ by less than an f32 ulp,
    and the port decides the switch as op-by-op JAX does."""
    pts, pc, jc, nrm = _cloud_and_normals(60, seed=2)
    oracle = ref.compute_fpfh_np(pts, nrm, 0.6)
    np.testing.assert_allclose(fpfh.compute_fpfh_from_normals(pc, _t(nrm), 0.6, 60).numpy(), oracle, atol=BAR)
    compiled = np.asarray(jfpfh.compute_fpfh_from_normals(jc, jnp.asarray(nrm), 0.6, 60))
    assert np.abs(compiled - oracle).max() > 1e-2
    spfh, idx, ok, _, _ = fpfh.compute_spfh(pc, _t(nrm), 0.6, 60)
    jspfh = np.asarray(jfpfh.compute_spfh(jc, jnp.asarray(nrm), 0.6, 60)[0])
    rows = np.nonzero(np.abs(spfh.numpy() - jspfh).max(1) > 1e-6)[0]
    assert len(rows) == 1
    r = rows[0]
    nb = idx[r].numpy()
    d = (pts[nb] - pts[r]).astype(np.float64)
    dist = np.linalg.norm(d, axis=1)
    d = d / np.where(dist > 0, dist, 1)[:, None]
    gap = np.where(ok[r].numpy() & (dist > 0), np.abs(np.abs(d @ nrm[r]) - np.abs((d * nrm[nb]).sum(-1))), np.inf)
    k = np.argmin(gap)
    assert gap[k] < np.finfo(np.float32).eps * np.abs(d[k] @ nrm[r])
    args = (pts[r], nrm[r], pts[nb[k]], nrm[nb[k]])
    mine = fpfh.pair_features(*map(_t, args))[0].numpy()
    np.testing.assert_allclose(mine, np.asarray(_eager(jfpfh.pair_features, *map(jnp.asarray, args))[0]), atol=1e-7)
    jitted = np.asarray(jax.jit(jfpfh.pair_features)(*map(jnp.asarray, args))[0])
    assert np.sign(mine[2]) == -np.sign(jitted[2])


# --- the ball cap -----------------------------------------------------------------------


def test_ball_counts_and_cap_match_bruteforce_and_jax():
    pts = _dense_cloud(n_dense=30, n_far=10, seed=8)
    mask = np.ones(len(pts), bool)
    mask[3] = False
    pc, jc = _both(pts, mask)
    got = fpfh.ball_counts(pc, 0.5, chunk=16).numpy()
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got, np.where(mask, ((d2 <= 0.25) & mask[None]).sum(-1), 0))
    np.testing.assert_array_equal(got, np.asarray(jfpfh.ball_counts(jc, 0.5, chunk=16)))
    big = _dense_cloud()
    bc, jbc = _both(big)
    assert fpfh.densest_ball_count(bc, 0.5) == jfpfh.densest_ball_count(jbc, 0.5) >= 100
    assert fpfh.ball_truncated(bc, 0.5, 64) and not fpfh.ball_truncated(bc, 0.5, 128)
    assert fpfh.auto_max_neighbors((bc, 0.5), (pc, 0.5)) == jfpfh.auto_max_neighbors((jbc, 0.5), (jc, 0.5))
    assert fpfh.auto_max_neighbors((pc, 0.1)) == jfpfh.auto_max_neighbors((jc, 0.1)) == 32


def test_auto_cap_restores_exact_parity():
    """tests/test_fpfh.py:108-125: the auto cap gives the oracle's features
    on the dense cloud; the default cap of 64 truncates and drifts."""
    pts = _dense_cloud()
    pc, jc = _both(pts)
    # JAX's normals, as in tests/test_fpfh.py: the clipped cloud's flat
    # faces give near-parallel normals, and with the port's own normals a
    # switch near tie moves the features 1e-3 from the oracle's.
    nrm = _t(np.asarray(jnormals.orient_normals(jc.points, jnormals.knn_pca_normals(jc, k=8), jnp.zeros(3))))
    k_auto = fpfh.auto_max_neighbors((pc, 0.5))
    f_auto, tr = fpfh.compute_fpfh_from_normals_checked(pc, nrm, 0.5, k_auto)
    f_ref = ref.compute_fpfh_np(pts, nrm.numpy(), 0.5)
    np.testing.assert_allclose(f_auto.numpy(), f_ref, atol=BAR)
    f_cap, tr_cap = fpfh.compute_fpfh_from_normals_checked(pc, nrm, 0.5, 64)
    assert not bool(tr) and bool(tr_cap)
    assert float(np.abs(f_cap.numpy() - f_ref).max()) > 1e-3
    # (Compiled JAX meets a switch near tie on this cloud: the oracle holds.)
    _, jtr = jfpfh.compute_fpfh_from_normals_checked(jc, jnp.asarray(nrm.numpy()), 0.5, k_auto)
    assert k_auto == jfpfh.auto_max_neighbors((jc, 0.5)) and not bool(jtr)


# --- matching --------------------------------------------------------------------------


def test_feature_matches_match_jax():
    rng = np.random.RandomState(3)
    src_f = (rng.rand(40, 33) * 4.0).astype(np.float32)
    dst_f = (src_f + 0.01 * rng.randn(40, 33)).astype(np.float32)
    dmask = np.arange(40) % 7 != 0
    idx, d2 = fpfh.compute_matches(_t(src_f), _t(dst_f), torch.ones(40, dtype=torch.bool), _t(dmask), 2)
    jidx, jd2 = jfpfh.compute_matches(jnp.asarray(src_f), jnp.asarray(dst_f), jnp.ones(40, bool), jnp.asarray(dmask), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # |a|^2 + |b|^2 - 2 a.b at |f|^2 ~ 50: ~1e-5 of cancellation noise
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=5e-4)
    assert (idx[dmask, 0].numpy() == np.arange(40)[dmask]).all() and dmask[idx.numpy()].all()


def test_lowe_pruning_matches_reference_and_jax():
    rng = np.random.RandomState(4)
    src_f = rng.rand(30, 33).astype(np.float32)
    dst_f = rng.rand(25, 33).astype(np.float32)
    idx, _ = fpfh.compute_matches(_t(src_f), _t(dst_f), torch.ones(30, dtype=torch.bool),
                                  torch.ones(25, dtype=torch.bool), 2)
    pairs_ref, w_ref = ref.prune_matches_lowe_np(idx.numpy(), src_f, dst_f, 0.9)
    j, w, keep = fpfh.prune_matches_lowe(idx, _t(src_f), _t(dst_f), 0.9)
    assert [(i, int(j[i])) for i in range(30) if keep[i]] == pairs_ref
    np.testing.assert_allclose([float(w[i]) for i in range(30) if keep[i]], w_ref, rtol=1e-5)
    smask = np.arange(30) % 3 != 0
    got = fpfh.prune_matches_lowe(idx, _t(src_f), _t(dst_f), 0.9, _t(smask))
    want = jfpfh.prune_matches_lowe(jnp.asarray(idx.numpy()), jnp.asarray(src_f), jnp.asarray(dst_f), 0.9,
                                    jnp.asarray(smask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
