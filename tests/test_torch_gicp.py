"""Parity of the port's GICP (align/gicp.py) with the JAX package and the
NumPy oracles of tests/reference_impl.py and tests/test_gicp.py.

numpy makes every input from a seed, pinned to f32 (f64 for the whitening
derivatives, as tests/test_gicp.py:264-291 takes them, so that finite
differences are not noise-limited). Bars: poses to 1e-4 in twist (PARITY.md
C2-C19), covariances to 1e-5 (plain) and 1e-4 (the GICP remap), derivatives
to 1e-4 against finite differences and to 1e-9 against JAX's.

The clouds are generic: the GICP remap takes U from eigh, and a repeated
SMALLEST eigenvalue (a line-like neighbourhood) would make its covariance
depend on the basis eigh picks, which differs between LAPACK, JAX and
cuSOLVER.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import gicp as jgicp
from realsensetracker_tpu.ops import cloud as jcloud
from realsensetracker_tpu_torch.align import gicp
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops import cloud
from tests import reference_impl as ref
from tests.test_gicp import _covariances_np
from tests.torch_parity import apply_pose, pose, twist_gap

BAR = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _points(seed, n, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(n, 3)).astype(np.float32)


def _both(pts, mask=None):
    """The same cloud for the port and for JAX."""
    m = np.ones(len(pts), bool) if mask is None else mask
    return cloud.Cloud(_t(pts), _t(m)), jcloud.Cloud(jnp.asarray(pts), jnp.asarray(m))


def _spd(seed, n, dtype=np.float64):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, 3, 3)
    return (a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(dtype)


def _sym(seed, n):
    a = np.random.RandomState(seed).randn(n, 3, 3)
    return (a + a.transpose(0, 2, 1)) / 2


# --- covariances --------------------------------------------------------------


@pytest.mark.parametrize("use_gicp,n,k", [(False, 40, 8), (True, 40, 8), (False, 300, 32), (True, 300, 32)])
def test_covariances_match_oracle_and_jax(use_gicp, n, k):
    pts = _points(n + k, n)
    pc, jc = _both(pts)
    got = gicp.compute_covariances(pc, k=k, use_gicp=use_gicp).numpy()
    atol = 1e-4 if use_gicp else 1e-5
    np.testing.assert_allclose(got, _covariances_np(pts, k=k, use_gicp=use_gicp), atol=atol)
    np.testing.assert_allclose(got, np.asarray(jgicp.compute_covariances(jc, k=k, use_gicp=use_gicp)), atol=atol)
    if not use_gicp:
        np.testing.assert_allclose(got, ref.compute_covariances_np(pts, k=k), atol=1e-5)
    else:  # the remap's eigenvalues: (1e-2, 1, 1)
        vals = np.linalg.eigvalsh(got.astype(np.float64))
        np.testing.assert_allclose(vals, np.broadcast_to([1e-2, 1.0, 1.0], vals.shape), atol=BAR)


def test_covariances_weight_out_phantom_neighbours():
    """Five valid points of 64 with k = 8: the _BIG padding carries no
    weight; each covariance is that of the four real neighbours."""
    pts = np.zeros((64, 3), np.float32)
    pts[:5] = np.random.RandomState(3).rand(5, 3) * 0.2 + 1.0
    mask = np.arange(64) < 5
    pc, jc = _both(pts, mask)
    got = gicp.compute_covariances(pc, k=8).numpy()[:5]
    np.testing.assert_allclose(got, np.asarray(jgicp.compute_covariances(jc, k=8))[:5], atol=1e-6)
    for i in range(5):
        nb = np.delete(pts[:5], i, axis=0).astype(np.float64)
        d = nb - nb.mean(0)
        np.testing.assert_allclose(got[i], d.T @ d / 3, atol=1e-6)


# --- the whitening and its derivative ------------------------------------------


def test_whitening_matches_jax_and_inverts():
    M = _spd(1, 16, np.float32)
    W = gicp._whitening(_t(M)).numpy()
    np.testing.assert_allclose(W, np.asarray(jgicp._whitening(jnp.asarray(M))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(W @ M.astype(np.float64) @ W, np.broadcast_to(np.eye(3), M.shape), atol=1e-3)


def _jvp(M, dM):
    return torch.func.jvp(gicp._whitening_diff, (_t(M),), (_t(dM),))


@pytest.mark.parametrize("case", ["random", "repeated"])
def test_whitening_jvp_matches_jax_and_finite_differences(case):
    """Daleckii-Krein JVP, at generic M and at M = 2I, where eigh's own
    derivative divides by zero gaps and the exact answer is f'(2) dM."""
    if case == "random":
        M, dM = _spd(3, 5), _sym(4, 5)
    else:
        M, dM = np.stack([np.eye(3) * 2.0]), np.ones((1, 3, 3)) * 0.1
    W, got = _jvp(M, dM)
    assert torch.isfinite(got).all()
    _, jgot = jax.jvp(jgicp._whitening_diff, (jnp.asarray(M),), (jnp.asarray(dM),))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(W.numpy(), gicp._whitening(_t(M)).numpy(), rtol=0, atol=0)
    eps = 1e-6
    fd = (gicp._whitening(_t(M + eps * dM)) - gicp._whitening(_t(M - eps * dM))) / (2 * eps)
    np.testing.assert_allclose(got.numpy(), fd.numpy(), atol=BAR)
    if case == "repeated":
        np.testing.assert_allclose(got.numpy(), -0.5 * 2.0**-1.5 * dM, atol=1e-12)


@pytest.mark.parametrize("case", ["random", "repeated"])
def test_whitening_vjp_matches_jax_and_finite_differences(case):
    """backward = the same table on the symmetrised cotangent: JAX's VJP
    (the transpose of its JVP) for a symmetric cotangent, and <Mbar, dM> =
    <Wbar, dW> for any cotangent and symmetric dM."""
    M = _spd(5, 4) if case == "random" else np.stack([np.eye(3) * 2.0] * 4)
    Wbar = _sym(6, 4)
    Mt = _t(M).requires_grad_(True)
    (Mbar,) = torch.autograd.grad(gicp._whitening_diff(Mt), Mt, _t(Wbar))
    _, vjp = jax.vjp(jgicp._whitening_diff, jnp.asarray(M))
    np.testing.assert_allclose(Mbar.numpy(), np.asarray(vjp(jnp.asarray(Wbar))[0]), rtol=1e-9, atol=1e-9)
    Wbar_any = np.random.RandomState(7).randn(4, 3, 3)
    (Mbar,) = torch.autograd.grad(gicp._whitening_diff(Mt), Mt, _t(Wbar_any))
    dM = _sym(8, 4)
    eps = 1e-6
    fd = (gicp._whitening(_t(M + eps * dM)) - gicp._whitening(_t(M - eps * dM))).numpy() / (2 * eps)
    np.testing.assert_allclose((Mbar.numpy() * dM).sum(), (Wbar_any * fd).sum(), rtol=1e-5)


def test_whitening_jacfwd_matches_jax():
    """torch.func.jacfwd runs through the Function (its vmap rule is
    generated) and gives JAX's jacfwd of the custom_jvp."""
    M = _spd(9, 1)[0]
    got = torch.func.jacfwd(gicp._whitening_diff)(_t(M))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jacfwd(jgicp._whitening_diff)(jnp.asarray(M))),
                               rtol=1e-9, atol=1e-9)


# --- the inner solve ------------------------------------------------------------


def _golden_problem():
    """tests/test_gicp.py:159-194: noisy correspondences with outliers."""
    rng = np.random.RandomState(11)
    n = 60
    src = rng.randn(n, 3).astype(np.float32)
    T_true = pose([0.04, -0.02, 0.03, 0.03, -0.02, 0.04])
    dst = src @ T_true[:3, :3].T + T_true[:3, 3]
    dst += 0.01 * rng.randn(n, 3).astype(np.float32)
    dst[:6] += 2.0  # the Huber branch
    dst = dst.astype(np.float32)
    covs = [ref.compute_covariances_np(x, k=8).astype(np.float32) for x in (src, dst)]
    return src, dst, covs[0], covs[1]


@pytest.mark.parametrize("whitening", ["fixed", "autodiff"])
def test_solve_alignment_matches_oracle_and_jax(whitening):
    src, dst, cs, cd = _golden_problem()
    args = (src, dst, cs, cd, np.ones(len(src), bool), np.eye(4, dtype=np.float32))
    T, cost = gicp.solve_alignment(*map(_t, args), inner_iters=6, whitening=whitening)
    jT, jcost = jgicp.solve_alignment(*map(jnp.asarray, args), inner_iters=6, whitening=whitening)
    assert twist_gap(jT, T) < BAR
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-4)
    if whitening == "fixed":
        T_ref, cost_ref = ref.gicp_solve_np(src, dst, cs, cd, np.eye(4, dtype=np.float32), inner_iters=6)
        assert twist_gap(T_ref, T) < BAR
        np.testing.assert_allclose(float(cost), float(cost_ref), rtol=1e-3)


def test_solve_alignment_cost_is_at_the_returned_transform():
    src = _points(7, 48)
    dst = apply_pose(pose([0.03, -0.02, 0.02, 0.02, 0.01, -0.02]), src)
    covs = _t(np.tile(np.eye(3, dtype=np.float32)[None] * 1e-2, (48, 1, 1)))
    mask = torch.ones(48, dtype=torch.bool)
    T, c = gicp.solve_alignment(_t(src), _t(dst), covs, covs, mask, se3.identity(), inner_iters=4)
    T0, c0 = gicp.solve_alignment(_t(src), _t(dst), covs, covs, mask, T, inner_iters=0)
    assert torch.equal(T0, T)
    np.testing.assert_allclose(float(c), float(c0), rtol=1e-6)


def test_whitening_modes_share_the_fixed_point():
    """tests/test_gicp.py:293-330 on the port: one step differs in direction
    (the dW term), twelve reach the same pose."""
    rng = np.random.RandomState(0)
    n = 200
    src = rng.randn(n, 3).astype(np.float32)
    T_true = pose([0.04, -0.03, 0.05, 0.05, -0.04, 0.03])
    dst = apply_pose(T_true, src)

    def rand_covs():
        covs = np.zeros((n, 3, 3), np.float32)
        for i in range(n):
            q, _ = np.linalg.qr(rng.randn(3, 3))
            covs[i] = q @ np.diag([1.0, 0.1, 1e-3]) @ q.T
        return _t(covs)

    args = (_t(src), _t(dst), rand_covs(), rand_covs(), torch.ones(n, dtype=torch.bool), se3.identity())
    tw = [se3.log(gicp.solve_alignment(*args, inner_iters=1, whitening=w)[0]).numpy() for w in ("fixed", "autodiff")]
    angle = np.degrees(np.arccos(np.clip(tw[0] @ tw[1] / np.linalg.norm(tw[0]) / np.linalg.norm(tw[1]), -1, 1)))
    assert 0.01 < angle < 30.0
    T12 = [gicp.solve_alignment(*args, inner_iters=12, whitening=w)[0] for w in ("fixed", "autodiff")]
    assert max(twist_gap(T_true, T) for T in T12) < BAR
    assert twist_gap(*T12) < 1e-5


# --- full GICP -------------------------------------------------------------------


def _full_problem(case):
    rng = np.random.RandomState(12)
    n = 50
    src = rng.randn(n, 3).astype(np.float32)
    dst = apply_pose(pose([0.03, 0.02, -0.03, -0.02, 0.03, 0.02]), src)
    if case != "exact":
        dst = (dst + 0.005 * rng.randn(n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    if case == "masked":  # far invalid points that must not pull the fit
        src = np.concatenate([src, 50.0 + _points(13, 20)])
        mask = np.concatenate([mask, np.zeros(20, bool)])
    return src, mask, dst


@pytest.mark.parametrize("case,kw", [
    ("noisy", {}),
    ("noisy", {"whitening": "autodiff"}),
    ("exact", {"use_gicp_cov": True}),
    ("masked", {}),
])
def test_align_gicp_matches_jax_and_oracle(case, kw):
    src, mask, dst = _full_problem(case)
    (ps, js), (pd, jd) = _both(src, mask), _both(dst)
    res = gicp.align_gicp(ps, pd, max_outer=6, inner_iters=4, cov_k=8, **kw)
    jres = jgicp.align_gicp(js, jd, max_outer=6, inner_iters=4, cov_k=8, **kw)
    assert twist_gap(jres.transform, res.transform) < BAR
    np.testing.assert_allclose(float(res.cost), float(jres.cost), rtol=1e-3, atol=1e-7)
    assert int(res.num_valid) == int(jres.num_valid) == int(mask.sum())
    if case == "noisy" and not kw:
        T_ref, _ = ref.align_gicp_np(src, dst, max_outer=6, inner_iters=4, cov_k=8)
        assert twist_gap(T_ref, res.transform) < BAR


def test_align_gicp_degenerate_keeps_identity_and_infinite_cost():
    """A non-finite point makes every solve non-finite: delta = 0 within a
    round, the outer guard rejects each round, and the cost stays at its
    inf seed, as in JAX (align_gicp.cpp:146-151)."""
    src = _points(14, 40)
    dst = apply_pose(pose([0.01, 0, 0, 0, 0, 0.01]), src)
    src[3] = np.nan
    (ps, js), (pd, jd) = _both(src), _both(dst)
    res = gicp.align_gicp(ps, pd, max_outer=2, inner_iters=2, cov_k=8)
    jres = jgicp.align_gicp(js, jd, max_outer=2, inner_iters=2, cov_k=8)
    np.testing.assert_array_equal(res.transform.numpy(), np.asarray(jres.transform))
    np.testing.assert_array_equal(res.transform.numpy(), np.eye(4, dtype=np.float32))
    assert float(res.cost) == float(jres.cost) == float("inf")


def test_solve_alignment_rejects_unknown_whitening():
    x = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="whitening"):
        gicp.solve_alignment(x, x, torch.zeros(3, 3, 3), torch.zeros(3, 3, 3), torch.ones(3, dtype=torch.bool),
                             se3.identity(), whitening="exact")
