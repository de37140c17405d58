"""Parity of the port's robust global registration (align/robust_global.py)
with the JAX package and the oracles of tests/test_robust_global.py.

numpy makes every input from a seed, pinned to f32. Bars: poses and
rotations to 1e-4 (PARITY.md C30), k-core membership, matches, inlier
masks and counts exact; max_kcore also equals the sequential-peeling
oracle. The scenes mirror tests/test_robust_global.py: 256 points,
descriptors shared up to noise by matched points, outliers random or in
rigidly moved decoy groups.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import robust_global as jrg
from realsensetracker_tpu.ops import cloud as jcloud
from realsensetracker_tpu_torch.align import robust_global as rg
from realsensetracker_tpu_torch.ops import cloud
from tests.test_robust_global import _numpy_max_clique, _numpy_max_kcore
from tests.torch_parity import apply_pose, pose, twist_gap

BAR = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _features(n, noise, seed):
    base = np.random.RandomState(seed).randn(n, 33).astype(np.float32)
    return base, (base + noise * np.random.RandomState(seed + 1).randn(n, 33)).astype(np.float32)


# --- matching -----------------------------------------------------------------------


def test_mutual_matches_match_jax():
    src_f, dst_f = _features(80, 0.3, 0)
    dst_f[:10] = dst_f[10:20] + 0.01  # decoys break the cross-check
    sm, dm = np.arange(80) % 9 != 0, np.arange(80) % 11 != 0
    idx, keep = rg.mutual_matches(_t(src_f), _t(dst_f), _t(sm), _t(dm))
    jidx, jkeep = jrg.mutual_matches(*map(jnp.asarray, (src_f, dst_f, sm, dm)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < keep.sum() < sm.sum()
    f = _t(src_f)
    idx, keep = rg.mutual_matches(f, f, torch.ones(80, dtype=torch.bool), torch.ones(80, dtype=torch.bool))
    assert (idx.numpy() == np.arange(80)).all() and keep.all()


# --- the k-core screen ---------------------------------------------------------------


def _random_graph(seed, n=48, p=0.2):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, n) < p
    return a | a.T, rng.rand(n) < 0.9


@pytest.mark.parametrize("seed", range(5))
def test_max_kcore_matches_oracle_and_jax(seed):
    adj, keep = _random_graph(seed)
    got = rg.max_kcore(_t(adj), _t(keep)).numpy()
    np.testing.assert_array_equal(got, _numpy_max_kcore(adj, keep))
    np.testing.assert_array_equal(got, np.asarray(jrg.max_kcore(jnp.asarray(adj), jnp.asarray(keep))))


def test_max_kcore_contains_max_clique_and_empty_keep():
    rng = np.random.RandomState(7)
    n = 40
    adj = rng.rand(n, n) < 0.1
    adj |= adj.T
    clique = rng.choice(n, 12, replace=False)
    adj[np.ix_(clique, clique)] = True
    keep = np.ones(n, bool)
    core = rg.max_kcore(_t(adj), _t(keep)).numpy()
    np.testing.assert_array_equal(core, np.asarray(jrg.max_kcore(jnp.asarray(adj), jnp.asarray(keep))))
    assert _numpy_max_clique(adj, keep) == set(clique.tolist()) <= set(np.nonzero(core)[0].tolist())
    assert not rg.max_kcore(torch.ones(8, 8, dtype=torch.bool), torch.zeros(8, dtype=torch.bool)).any()


def test_max_kcore_peels_in_blocks_to_the_same_core():
    """The host checks for a change once per PEEL_CHECK_EVERY rounds; any
    block size gives the same core, and the rounds run are counted."""
    adj, keep = _random_graph(11, n=96, p=0.1)
    want = _numpy_max_kcore(adj, keep)
    before = rg.ITERATIONS["peel"]
    for every in (1, 3, 64):
        rg.PEEL_CHECK_EVERY, saved = every, rg.PEEL_CHECK_EVERY
        try:
            np.testing.assert_array_equal(rg.max_kcore(_t(adj), _t(keep)).numpy(), want)
        finally:
            rg.PEEL_CHECK_EVERY = saved
    assert rg.ITERATIONS["peel"] > before


# --- GNC-TLS rotation and the translation vote ---------------------------------------


def _tims(seed=7, m=384, scene_scale=30.0, noise=0.003, outlier_frac=0.3, outlier_mag=80.0):
    """tests/test_robust_global.py:268-281."""
    rng = np.random.RandomState(seed)
    R_true = pose([0, 0, 0, 0.4, -0.3, 0.5])[:3, :3]
    a = rng.uniform(-scene_scale, scene_scale, (m, 3)).astype(np.float32)
    b = (a @ R_true.T + rng.normal(0, noise, (m, 3))).astype(np.float32)
    n_out = int(outlier_frac * m)
    b[:n_out] += rng.uniform(-outlier_mag, outlier_mag, (n_out, 3)).astype(np.float32)
    mask = np.ones(m, bool)
    mask[-7:] = False
    return a, b, mask, R_true


@pytest.mark.parametrize("case,kw", [
    ("tight", {}),  # 1 mm bound, 300 m outliers: more than 64 rounds
    ("tight", {"max_iters": 64, "cost_threshold": 0.0}),
    ("loose", {}),
])
def test_gnc_tls_rotation_matches_jax(case, kw):
    if case == "tight":
        a, b, mask, R_true = _tims(noise=3e-4, outlier_mag=300.0)
        bound = 1e-3
    else:
        a, b, mask, R_true = _tims(scene_scale=2.0, noise=0.02, outlier_mag=5.0)
        bound = 0.5
    R, inl = rg._gnc_tls_rotation(_t(a), _t(b), _t(mask), bound, **kw)
    jR, jinl = jrg._gnc_tls_rotation(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), bound, **kw)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=BAR)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    err = np.arccos(np.clip((np.trace(R.numpy().T @ R_true) - 1) / 2, -1, 1))
    assert err < (1e-4 if case == "tight" and not kw else 0.02)


def test_consensus_translation_and_overlap_match_jax():
    rng = np.random.RandomState(5)
    t = np.concatenate([0.3 + 0.02 * rng.randn(60, 3), 3 * rng.randn(40, 3)]).astype(np.float32)
    mask = rng.rand(100) < 0.9
    got = rg._consensus_translation(_t(t), _t(mask), 0.1).numpy()
    np.testing.assert_allclose(got, np.asarray(jrg._consensus_translation(jnp.asarray(t), jnp.asarray(mask), 0.1)),
                               atol=1e-6)
    pts = rng.randn(150, 3).astype(np.float32)
    T = pose([0.1, -0.05, 0.02, 0.05, 0.1, -0.08])
    dst = apply_pose(T, pts[30:])
    dmask = np.arange(120) % 5 != 0
    src_c = cloud.Cloud(_t(pts), _t(np.ones(150, bool)))
    fwd, bwd = rg.symmetric_overlap(_t(T), src_c, cloud.Cloud(_t(dst), _t(dmask)), 0.05)
    jfwd, jbwd = jrg.symmetric_overlap(jnp.asarray(T), jcloud.Cloud(jnp.asarray(pts), jnp.ones(150, bool)),
                                       jcloud.Cloud(jnp.asarray(dst), jnp.asarray(dmask)), 0.05)
    assert float(fwd) == pytest.approx(float(jfwd)) and float(bwd) == pytest.approx(float(jbwd))
    assert 0.5 < float(fwd) < 1.0 and float(bwd) == 1.0


# --- full registration ---------------------------------------------------------------


def _scene(case):
    """(src, dst, src_feats, dst_feats, noise_bound, T_true, src mask)."""
    n = 256
    rng = np.random.RandomState({"large": 1, "outliers": 3, "structured": 20, "few": 8}[case])
    src = rng.randn(n, 3).astype(np.float32)
    T_true = pose({"large": [0.5, -0.3, 0.2, 1.2, 0.8, -0.5], "outliers": [0.3, 0.2, -0.4, 0.9, -0.6, 0.4],
                    "structured": [0.4, -0.2, 0.3, 0.8, -0.5, 0.6], "few": [0.0] * 6}[case])
    dst = apply_pose(T_true, src)
    mask = np.ones(n, bool)
    if case == "outliers":  # 30% gross outliers
        bad = rng.choice(n, 77, replace=False)
        dst[bad] = (rng.randn(77, 3) * 3).astype(np.float32)
    elif case == "structured":  # 60%: three rigidly moved decoy groups
        decoys = ([-0.5, 0.3, 0.1, -1.0, 0.4, 0.2], [0.1, 0.6, -0.4, 0.3, 1.1, -0.7], [0.7, -0.1, 0.5, -0.6, -0.9, 1.0])
        for g, tw in zip(np.array_split(np.arange(102, n), 3), decoys):
            dst[g] = apply_pose(pose(tw), src[g])
    elif case == "few":
        mask[2:] = False
    sf, df = _features(n, 0.01, 40)
    return src, dst, sf, df, 0.1, T_true, mask


@pytest.mark.parametrize("case", ["large", "outliers", "structured", "few"])
def test_register_robust_matches_jax(case):
    src, dst, sf, df, bound, T_true, mask = _scene(case)
    res = rg.register_robust(cloud.Cloud(_t(src), _t(mask)), cloud.Cloud(_t(dst), _t(mask)), _t(sf), _t(df), bound)
    jres = jrg.register_robust(jcloud.Cloud(jnp.asarray(src), jnp.asarray(mask)),
                               jcloud.Cloud(jnp.asarray(dst), jnp.asarray(mask)),
                               jnp.asarray(sf), jnp.asarray(df), bound)
    assert bool(res.valid) == bool(jres.valid) == (case != "few")
    if case != "few":  # two matches leave the rotation to each SVD's choice of basis
        assert twist_gap(jres.transform, res.transform) < BAR
    for field in ("num_correspondences", "num_inliers"):
        assert int(getattr(res, field)) == int(getattr(jres, field))
    assert float(res.rotation_inlier_fraction) == pytest.approx(float(jres.rotation_inlier_fraction), abs=1e-6)
    if case != "few":
        assert twist_gap(T_true, res.transform) < (5e-2 if case == "outliers" else 1e-2)


# --- the frame pair of chip_smoke.py's align_pair phase (standing records) ----------

# The 19 TIMs of the k-core that the port's CPU run of robust-global reaches
# on chip_smoke.py's frame pair (the 8192-point voxel cloud of one 640x480
# TUM_FR1 frame and its copy moved by a known twist): source and
# destination differences, f32.
TIMS_A = np.array([
    [-0.000266314, -0.046507716, 0.00046587], [0.0075109, -0.054272056, 0.000425339],
    [0.001230955, -0.000437617, -0.0422287], [0.036948323, -0.000817776, -0.044775963],
    [0.000645995, -0.000457287, -0.044734955], [0.003737092, -0.000679016, -0.0637176],
    [0.00011611, -0.000441074, -0.043659687], [0.00011909, -0.000451803, -0.04470277],
    [0.000121832, -0.000462413, -0.045782804], [-0.000621796, -0.100770354, 0.001009464],
    [0.007244587, -0.10077977, 0.000891209], [-0.000516534, -0.001101971, -0.10987401],
    [0.03759432, -0.001275063, -0.08951092], [0.003853202, -0.00112009, -0.10737729],
    [0.0002352, -0.000892878, -0.088362455], [0.000240922, -0.000914216, -0.09048557],
    [-0.00032413, -0.100277305, 0.001000166], [-0.000312328, -0.10023272, 0.000999689],
    [-0.000798106, -0.24692678, 0.002463102],
], np.float32)
TIMS_B = np.array([
    [-0.19563246, -0.46770817, 0.46248865], [-0.051912785, -0.000000119, -0.10071564],
    [0.19982636, 0.3194958, -0.3632176], [0.14845002, -0.05319643, 0.0],
    [0.10168743, -0.045789838, -0.000000477], [0.047071457, -0.046139896, 0.0],
    [0.000253677, -0.054181397, 0.0], [-0.20261979, -0.047673106, 0.000000715],
    [-0.046477437, -0.05439037, -0.000000238], [0.000446796, -0.100649476, 0.000000477],
    [-0.24754524, -0.4677083, 0.361773], [-0.34561574, -0.31949568, 0.2134633],
    [0.25013745, -0.09898627, -0.000000477], [0.047325134, -0.10032129, 0.0],
    [-0.20236611, -0.1018545, 0.000000715], [-0.24909723, -0.10206348, 0.000000477],
    [0.00068295, -0.10026294, 0.0], [0.000682712, -0.10023582, 0.0],
    [-0.044896245, -0.24721062, 0.0],
], np.float32)


def test_gnc_tls_rotation_goes_nan_with_jax_when_mu_overflows():
    """Standing record, JAX side: on these 19 mostly inconsistent TIMs the
    weighted cost never settles to the relative threshold, mu grows x1.4 a
    round until it overflows f32 (~265 rounds), the weights turn NaN and
    the stopping round's rotation is NaN. JAX's GNC-TLS returns NaN; the
    port returns NaN with it, on the same inputs."""
    mask = np.ones(len(TIMS_A), bool)
    rg.ITERATIONS.update(gnc=0)
    R, inl = rg._gnc_tls_rotation(_t(TIMS_A), _t(TIMS_B), _t(mask), 0.5)
    jR, jinl = jrg._gnc_tls_rotation(jnp.asarray(TIMS_A), jnp.asarray(TIMS_B), jnp.asarray(mask), 0.5)
    assert torch.isnan(R).all() and np.isnan(np.asarray(jR)).all()
    assert not inl.any() and not np.asarray(jinl).any()
    assert rg.ITERATIONS["gnc"] > 200


def _fpfh_like(n, seed):
    """Non-negative 33-bin rows summing to 300, as FPFH's three 11-bin
    histograms of percentages: |f|^2 ~ 1e4."""
    rng = np.random.RandomState(seed)
    return (300.0 * rng.dirichlet(np.ones(33) * 0.5, size=n)).astype(np.float32)


def test_feature_matches_part_from_jax_only_at_near_ties():
    """Standing record, neither side: the 1-NN over FPFH rows is the f32
    |a|^2 + |b|^2 - 2 a.b form, which cannot separate two candidates whose
    squared distances differ by less than its rounding, ~4 eps (|a|^2 +
    |b|^2) ~ 5e-3 here. Each destination row is shadowed by a twin at
    almost the same distance from its source row; the port's and JAX's
    forward matches may part only at rows where the two best distances
    (in f64) lie within that bound."""
    src = _fpfh_like(96, 3)
    rng = np.random.RandomState(4)
    step = rng.randn(96, 33).astype(np.float32)
    dst = np.concatenate([src + 0.5 * step, src - 0.5 * step + 1e-4 * rng.randn(96, 33).astype(np.float32)])
    mask = np.ones(len(dst), bool)
    idx, _ = rg.mutual_matches(_t(src), _t(dst), _t(np.ones(96, bool)), _t(mask))
    jidx, _ = jrg.mutual_matches(*map(jnp.asarray, (src, dst, np.ones(96, bool), mask)))
    d2 = ((src[:, None, :].astype(np.float64) - dst[None].astype(np.float64)) ** 2).sum(-1)
    best2 = np.sort(d2, axis=1)[:, :2]
    norms = (src.astype(np.float64) ** 2).sum(-1)[:, None] + (dst.astype(np.float64) ** 2).sum(-1)[None]
    bound = 4 * np.finfo(np.float32).eps * norms.max(1)
    near_tie = best2[:, 1] - best2[:, 0] <= bound
    assert near_tie.sum() >= 10  # the twins make near ties
    parted = idx.numpy() != np.asarray(jidx)
    assert not (parted & ~near_tie).any()
    exact = np.argmin(d2, axis=1)
    assert ((idx.numpy() == exact) | near_tie).all()
