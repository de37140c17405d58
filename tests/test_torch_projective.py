"""Parity of the port's projective ICP and batched registration with JAX.

Tolerances: relative-pose twists agree to 1e-4, rmse to 1e-3 relative,
and num_matched to 1% of the samples (gate and round-half decisions can
flip when f32 sums run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.ops import pyramid as jpyr
from realsensetracker_tpu.parallel import batched as jbatched
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops import pyramid
from realsensetracker_tpu_torch.parallel import batched
from tests.torch_parity import intrinsics, j32, pair

JINTR, INTR = intrinsics(120, 160, 160.0)
CFG = projective.ProjectiveIcpConfig()  # flagship defaults, fitted to 3 levels here
JCFG = jproj.ProjectiveIcpConfig()
MOTIONS = [
    [0.0] * 6,
    [0.02, -0.01, 0.015, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.02, -0.015, 0.01],
    [0.03, 0.01, -0.02, 0.02, 0.01, -0.02],
]


def _degrade(d, seed):
    r = np.random.RandomState(seed)
    d = d + 0.005 * r.randn(*d.shape).astype(np.float32)
    d[r.rand(*d.shape) < 0.3] = 0.0
    return d


@pytest.fixture(scope="module")
def pairs():
    """(src (4,H,W), dst (4,H,W), T_true (4,4,4)); the last pair degraded
    by 30% dropout and 5 mm noise on both frames."""
    src, dst, truth = zip(*(pair(INTR, m, seed=1) for m in MOTIONS))
    src, dst = np.stack(src), np.stack(dst)
    src[-1], dst[-1] = _degrade(src[-1], 1), _degrade(dst[-1], 2)
    return src, dst, np.stack(truth)


@pytest.fixture(scope="module")
def jax_batch(pairs):
    src, dst, _ = pairs
    return jbatched.register_batch(j32(src), j32(dst), JINTR, JCFG)


def _twist(T):
    return se3.log(torch.tensor(np.asarray(T), dtype=torch.float32)).numpy()


def _assert_results_match(got, ref):
    np.testing.assert_allclose(_twist(got.transform), _twist(ref.transform), atol=1e-4)
    np.testing.assert_allclose(got.rmse.numpy(), np.asarray(ref.rmse), rtol=1e-3, atol=1e-7)
    samples = CFG.samples
    assert np.abs(got.num_matched.numpy() - np.asarray(ref.num_matched)).max() <= 0.01 * samples
    np.testing.assert_allclose(
        got.inlier_fraction.numpy(), np.asarray(ref.inlier_fraction), atol=0.01
    )


def test_register_depth_pair_matches_jax(pairs):
    src, dst, _ = pairs
    ref = jproj.register_depth_pair(j32(src[3]), j32(dst[3]), JINTR, JCFG)
    got = projective.register_depth_pair(torch.from_numpy(src[3:4]), torch.from_numpy(dst[3:4]), INTR, CFG)
    ref1 = jproj.ProjectiveIcpResult(*(np.asarray(x)[None] for x in ref))
    _assert_results_match(got, ref1)


def test_register_batch_matches_jax(pairs, jax_batch):
    src, dst, _ = pairs
    got = batched.register_batch(torch.from_numpy(src), torch.from_numpy(dst), INTR, CFG)
    _assert_results_match(got, jax_batch)


def test_register_batch_chunked_matches_jax_and_chunks(pairs, jax_batch):
    src, dst, _ = pairs
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    got = batched.register_batch_chunked(s, d, INTR, CFG, chunk=2)
    _assert_results_match(got, jax_batch)
    for i in (0, 2):
        part = batched.register_batch(s[i : i + 2], d[i : i + 2], INTR, CFG)
        for a, b in zip(got, part):
            torch.testing.assert_close(a[i : i + 2], b, rtol=0, atol=0)


def test_register_batch_chunked_rejects_ragged_batch(pairs):
    src, dst, _ = pairs
    with pytest.raises(ValueError, match="multiple"):
        batched.register_batch_chunked(torch.from_numpy(src[:3]), torch.from_numpy(dst[:3]), INTR, CFG, chunk=2)


@pytest.mark.parametrize("i, bar", [(0, 1e-4), (1, 2e-3), (2, 2e-3), (3, 5e-3)])
def test_register_batch_recovers_truth(pairs, i, bar):
    """The bars of tests/test_projective_icp.py (identity, translation,
    rotation, degraded frames)."""
    src, dst, truth = pairs
    got = batched.register_batch(torch.from_numpy(src[i : i + 1]), torch.from_numpy(dst[i : i + 1]), INTR, CFG)
    err = se3.log(se3.compose(se3.inverse(torch.from_numpy(truth[i])), got.transform[0]))
    assert err.abs().max().item() < bar


def test_projective_icp_pyramid_path_matches_jax(pairs):
    src, dst, _ = pairs
    cfg = CFG._replace(iters=(3, 3, 2), samples=1024)
    jsrc, intrs = jpyr.build_pyramid(j32(src[1]), JINTR, 3, use_kernel=False)
    jdst, _ = jpyr.build_pyramid(j32(dst[1]), JINTR, 3, use_kernel=False)
    ref = jproj.projective_icp(jsrc, jdst, tuple(intrs), cfg=jproj.ProjectiveIcpConfig(**cfg._asdict()))
    psrc, pintrs = pyramid.build_pyramid(torch.from_numpy(src[1:2]), INTR, 3)
    pdst, _ = pyramid.build_pyramid(torch.from_numpy(dst[1:2]), INTR, 3)
    got = projective.projective_icp(psrc, pdst, tuple(pintrs), cfg=cfg)
    _assert_results_match(got, jproj.ProjectiveIcpResult(*(np.asarray(x)[None] for x in ref)))


def test_association_and_normal_equations_match_jax(pairs):
    src, dst, _ = pairs
    jlevels, _ = jpyr.build_pyramid(j32(dst[3]), JINTR, 1, use_kernel=False)
    level = interop.pyramid_levels_from_numpy(jlevels)[0]
    pts, ok = jproj.sample_depth_points(j32(np.where(src[3] > 0.05, src[3], 0.0)), JINTR, 2048)
    T = np.asarray(se3.exp(torch.tensor([0.01, -0.01, 0.005, 0.004, 0.003, -0.002])), np.float32)

    jn, jd, jok = jproj.associate_planes_t(j32(T), pts.T, ok, jlevels[0], JINTR, JCFG)
    jH, jb, jaux = jproj.normal_equations_fixed_t(j32(T), pts.T, jn, jd, jok, JCFG)
    jT, jstats = jproj.solve_update(j32(T), jH, jb, jaux, 2048, JCFG)

    tT = torch.from_numpy(T)[None]
    tpts = torch.tensor(np.asarray(pts)).T[None]
    tok = torch.tensor(np.asarray(ok))[None]
    n, d, aok = projective.associate_planes_t(tT, tpts, tok, level, INTR, CFG)
    H, b, aux = projective.normal_equations_fixed_t(tT, tpts, n, d, aok, CFG)
    T_new, stats = projective.solve_update(tT, H, b, aux, 2048, CFG)

    np.testing.assert_array_equal(aok[0].numpy(), np.asarray(jok))
    np.testing.assert_allclose(n[0].numpy(), np.asarray(jn), atol=2e-5)
    np.testing.assert_allclose(d[0].numpy(), np.asarray(jd), atol=2e-5)
    np.testing.assert_allclose(H[0].numpy(), np.asarray(jH), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(jb), rtol=1e-4, atol=1e-5)
    assert int(aux[2][0]) == int(jaux[2])
    np.testing.assert_allclose(T_new[0].numpy(), np.asarray(jT), atol=1e-6)
    np.testing.assert_allclose(stats[0][0].item(), float(jstats[0]), rtol=1e-4)


def test_sample_depth_points_matches_sample_level_and_jax(pairs):
    src = pairs[0][0]
    masked = np.where((src > 0.05) & (src < 10.0), src, 0.0).astype(np.float32)
    levels, _ = pyramid.build_pyramid(torch.from_numpy(src)[None], INTR, 1, with_normals=False)
    pts_a, _, ok_a = projective.sample_level(levels[0], 1000)
    pts_b, ok_b = projective.sample_depth_points(torch.from_numpy(masked)[None], INTR, 1000)
    jpts, jok = jproj.sample_depth_points(j32(masked), JINTR, 1000)
    np.testing.assert_array_equal(ok_a.numpy(), ok_b.numpy())
    np.testing.assert_allclose(pts_a.numpy(), pts_b.numpy(), atol=1e-6)
    np.testing.assert_array_equal(ok_b[0].numpy(), np.asarray(jok))
    np.testing.assert_allclose(pts_b[0].numpy(), np.asarray(jpts), atol=1e-6)


def test_solve_update_guards_singular_system():
    T = se3.exp(torch.tensor([[0.1, 0.0, 0.0, 0.0, 0.2, 0.0], [0.0] * 6]))
    H = torch.stack([torch.full((6, 6), float("nan")), torch.eye(6)])
    b = torch.stack([torch.ones(6), torch.zeros(6)])
    aux = (torch.zeros(2), torch.zeros(2), torch.zeros(2, dtype=torch.int32))
    T_new, _ = projective.solve_update(T, H, b, aux, 16, CFG)
    torch.testing.assert_close(T_new, T, rtol=0, atol=1e-7)


def test_result_finite_on_empty_frames():
    """All-invalid depth must not produce NaNs (rank-deficient H guard),
    as tests/test_projective_icp.py:125-134."""
    d = torch.zeros(1, 120, 160)
    levels, intrs = pyramid.build_pyramid(d, INTR, 3)
    res = projective.projective_icp(
        levels, levels, tuple(intrs), cfg=CFG._replace(iters=(2, 2, 2), samples=512)
    )
    assert torch.isfinite(res.transform).all()
    torch.testing.assert_close(res.transform[0], torch.eye(4), rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "hw, iters",
    [((480, 640), (3, 3, 3, 2)), ((60, 80), (5, 4, 3, 2)), ((16, 16), (3, 3, 3, 2)), ((60, 80), (3, 3))],
)
def test_fit_levels_matches_jax(hw, iters):
    got = projective.fit_levels(CFG._replace(iters=iters), *hw)
    ref = jproj.fit_levels(JCFG._replace(iters=iters), *hw)
    assert got.iters == ref.iters


def test_normal_space_sampling_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        projective.register_depth_pair(
            torch.ones(1, 120, 160), torch.ones(1, 120, 160), INTR, CFG._replace(sample_mode="normal_space")
        )


def test_icp_config_defaults_match_jax():
    assert tuple(CFG) == tuple(JCFG)
    assert interop.icp_config_from_jax(JCFG) == CFG
    assert jnp.float32(CFG.gnc_mu) == jnp.float32(JCFG.gnc_mu)
