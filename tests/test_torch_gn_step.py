"""Parity of the port's GN round (plain version) with JAX, and its contract.

``gn_round_reference`` (associate_planes_t, then inner_iters x
(normal_equations_fixed_t -> solve_update)) is held against JAX's
align/projective._step on the same numpy inputs, pinned to f32: the pose
entries to 1e-5, rmse to 1e-5 relative, the matched count exactly and the
inlier fraction to 1e-7 (count / P in f32). Its parts are held against
JAX's parts: the association (n, d, ok) exactly, H and b to 1e-5 relative
to max|H| and max|b| (f32 sums over P points run in another order), wsse
and wsum to 1e-5 relative, the count exactly. The CUDA kernel gn_round is
held against gn_round_reference in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.ops import pyramid as jpyr
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.kernels import gn_step
from tests.torch_parity import intrinsics, j32, pair

JINTR, INTR = intrinsics(64, 128, 100.0)
CFG = projective.ProjectiveIcpConfig()
JCFG = jproj.ProjectiveIcpConfig()
RTOL = 1e-5

# (level, samples, twist of the pose, dropout): the sample counts cover a
# multiple of the kernel's 256 threads, a ragged count and a count above
# the coarse level's pixels; the last case moves most points out of view.
CASES = [
    (0, 2048, [0.01, -0.01, 0.005, 0.004, 0.003, -0.002], 0.0),
    (1, 1000, [0.0, 0.02, -0.01, 0.0, 0.01, 0.0], 0.2),
    (2, 2048, [0.02, 0.0, 0.0, 0.01, -0.01, 0.005], 0.0),
    (0, 777, [0.4, -0.3, 0.2, 0.2, 0.3, 0.0], 0.3),
]


@pytest.fixture(scope="module")
def frames():
    src, dst, _ = pair(INTR, [0.02, -0.01, 0.015, 0.01, 0.0, 0.01], seed=4)
    return src, dst


def _inputs(frames, level, samples, twist, dropout):
    """(JAX level, JAX points (P,3), JAX ok, port level, T (4,4) numpy)."""
    src, dst = frames
    src = src.copy()
    src[np.random.RandomState(level).rand(*src.shape) < dropout] = 0.0
    jlevels, jintrs = jpyr.build_pyramid(j32(dst), JINTR, 3, use_kernel=False)
    masked = j32(np.where((src > 0.05) & (src < 10.0), src, 0.0))
    for _ in range(level):
        masked, _ = jpyr.downsample_depth(masked, masked > 0)
    pts, ok = jproj.sample_depth_points(masked, jintrs[level], samples)
    port_level = interop.pyramid_levels_from_numpy(jlevels, device="cpu")[level]
    T = se3.exp(torch.tensor(twist, dtype=torch.float32)).numpy()
    return jlevels[level], jintrs[level], pts, ok, port_level, T


def _port_args(pts, ok, T):
    return (
        torch.from_numpy(T)[None].contiguous(),
        torch.tensor(np.asarray(pts)).T[None].contiguous(),
        torch.tensor(np.asarray(ok))[None].contiguous(),
    )


def _assert_system_close(H, b, aux, H_ref, b_ref, aux_ref):
    H, b = H[0].numpy(), b[0].numpy()
    H_ref, b_ref = np.asarray(H_ref), np.asarray(b_ref)
    assert np.abs(H - H_ref).max() <= RTOL * np.abs(H_ref).max()
    assert np.abs(b - b_ref).max() <= RTOL * np.abs(b_ref).max()
    np.testing.assert_allclose(aux[0][0].item(), float(aux_ref[0]), rtol=RTOL)
    np.testing.assert_allclose(aux[1][0].item(), float(aux_ref[1]), rtol=RTOL)
    assert int(aux[2][0]) == int(aux_ref[2])


@pytest.mark.parametrize("level, samples, twist, dropout", CASES)
def test_gn_step_reference_matches_jax(frames, level, samples, twist, dropout):
    """The parts of gn_round_reference -- the association and the first
    system at the round's pose -- against JAX's parts."""
    jlevel, jintr, pts, ok, port_level, T = _inputs(frames, level, samples, twist, dropout)
    jn, jd, jok = jproj.associate_planes_t(j32(T), pts.T, ok, jlevel, jintr, JCFG)
    jH, jb, jaux = jproj.normal_equations_fixed_t(j32(T), pts.T, jn, jd, jok, JCFG)

    tT, tpts, tok = _port_args(pts, ok, T)
    intr = interop.intrinsics_from_jax(jintr)
    n, d, aok = projective.associate_planes_t(tT, tpts, tok, port_level, intr, CFG)
    np.testing.assert_array_equal(aok[0].numpy(), np.asarray(jok))
    np.testing.assert_array_equal(n[0].numpy(), np.asarray(jn))
    np.testing.assert_array_equal(d[0].numpy(), np.asarray(jd))
    _assert_system_close(*projective.normal_equations_fixed_t(tT, tpts, n, d, aok, CFG), jH, jb, jaux)
    assert int(jaux[2]) > 0  # a non-empty system


# The round's cases: every level shape of CASES, and a ragged dropout case
# in place of CASES[3], whose 71 matched points give H a condition number
# of 5.7e8: f32 cannot fix its step (the f64 solves of the port's and
# JAX's systems, which agree to 1e-5, differ by 3.7e-4), so it is held
# only through its parts above.
ROUND_CASES = CASES[:3] + [(0, 777, [0.05, -0.03, 0.02, 0.02, 0.03, 0.0], 0.3)]


@pytest.mark.parametrize("inner_iters", [1, 2, 3])
@pytest.mark.parametrize("level, samples, twist, dropout", ROUND_CASES)
def test_gn_round_reference_matches_jax_step(frames, level, samples, twist, dropout, inner_iters):
    """One whole association round against JAX's _step: pose entries to
    1e-5, rmse to 1e-5 relative, the count exactly, the fraction to 1e-7."""
    jlevel, jintr, pts, ok, port_level, T = _inputs(frames, level, samples, twist, dropout)
    jT, (jrmse, jfrac, jcount) = jproj._step(
        j32(T), pts.T, ok, jlevel, jintr, JCFG._replace(inner_iters=inner_iters)
    )
    tT, tpts, tok = _port_args(pts, ok, T)
    intr = interop.intrinsics_from_jax(jintr)
    T_new, (rmse, frac, count) = gn_step.gn_round_reference(
        tT, tpts, tok, port_level.packed, intr, CFG._replace(inner_iters=inner_iters)
    )
    assert T_new.shape == (1, 4, 4) and count.dtype == torch.int32
    np.testing.assert_allclose(T_new[0].numpy(), np.asarray(jT), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rmse[0].item(), float(jrmse), rtol=RTOL, atol=0)
    assert int(count[0]) == int(jcount) > 0
    np.testing.assert_allclose(frac[0].item(), float(jfrac), rtol=0, atol=1e-7)


@pytest.mark.parametrize("level, samples, twist, dropout", CASES)
def test_gn_system_reference_matches_jax_build_normal_equations(frames, level, samples, twist, dropout):
    """gn_system's plain version is JAX's build_normal_equations: one
    association and the system at the same pose."""
    jlevel, jintr, pts, ok, port_level, T = _inputs(frames, level, samples, twist, dropout)
    H_ref, b_ref, aux_ref = jproj.build_normal_equations(j32(T), pts, ok, jlevel, jintr, JCFG)
    tT, tpts, tok = _port_args(pts, ok, T)
    before = dict(gn_step.LAUNCHES)
    H, b, aux = gn_step.gn_system(tT, tpts, tok, port_level.packed, interop.intrinsics_from_jax(jintr), CFG)
    assert gn_step.LAUNCHES == before  # CPU tensors never launch
    _assert_system_close(H, b, aux, H_ref, b_ref, aux_ref)


@pytest.mark.parametrize("level, samples, twist, dropout", CASES)
def test_gn_system_reference_with_an_association_pose_matches_jax(frames, level, samples, twist, dropout):
    """gn_system's plain version with T_assoc is the inner step of JAX's
    point-sharded round (parallel/sharded.py): associate_planes_t at
    T_assoc, then normal_equations_fixed_t at T against those planes."""
    jlevel, jintr, pts, ok, port_level, T_assoc = _inputs(frames, level, samples, twist, dropout)
    T = (se3.exp(torch.tensor([0.004, -0.002, 0.003, 0.002, -0.001, 0.003])) @ torch.from_numpy(T_assoc)).numpy()
    jn, jd, jok = jproj.associate_planes_t(j32(T_assoc), pts.T, ok, jlevel, jintr, JCFG)
    jH, jb, jaux = jproj.normal_equations_fixed_t(j32(T), pts.T, jn, jd, jok, JCFG)
    tT, tpts, tok = _port_args(pts, ok, T)
    tA = torch.from_numpy(T_assoc)[None].contiguous()
    intr = interop.intrinsics_from_jax(jintr)
    before = dict(gn_step.LAUNCHES)
    H, b, aux = gn_step.gn_system(tT, tpts, tok, port_level.packed, intr, CFG, T_assoc=tA)
    assert gn_step.LAUNCHES == before  # CPU tensors never launch
    _assert_system_close(H, b, aux, jH, jb, jaux)
    # The reduction ran at T, not at the association's pose.
    H_at_A, _, _ = gn_step.gn_system(tA, tpts, tok, port_level.packed, intr, CFG)
    assert not torch.equal(H, H_at_A)


@pytest.mark.parametrize("level, samples, twist, dropout", CASES[:2])
def test_gn_system_without_an_association_pose_is_unchanged(frames, level, samples, twist, dropout):
    """T_assoc=None and T_assoc=T give today's system bit for bit: the
    association and the reduction both at T."""
    _, jintr, pts, ok, port_level, T = _inputs(frames, level, samples, twist, dropout)
    tT, tpts, tok = _port_args(pts, ok, T)
    intr = interop.intrinsics_from_jax(jintr)
    n, d, aok = projective.associate_planes_t(tT, tpts, tok, port_level, intr, CFG)
    want = projective.normal_equations_fixed_t(tT, tpts, n, d, aok, CFG)
    for T_assoc in (None, tT.clone()):
        H, b, aux = gn_step.gn_system(tT, tpts, tok, port_level.packed, intr, CFG, T_assoc=T_assoc)
        for x, y in zip((H, b, *aux), (want[0], want[1], *want[2])):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("level, samples, twist, dropout", CASES[:2])
def test_fused_first_iteration_equals_separate_calls(frames, level, samples, twist, dropout):
    """gn_round's inner iterations run against the planes of its FIRST
    association: a two-step round is a one-step round, then one more
    normal_equations_fixed_t -> solve_update at the new pose against the
    old planes (not a re-association), bit for bit."""
    jlevel, jintr, pts, ok, port_level, T = _inputs(frames, level, samples, twist, dropout)
    tT, tpts, tok = _port_args(pts, ok, T)
    intr = interop.intrinsics_from_jax(jintr)
    before = dict(gn_step.LAUNCHES)
    T2, stats2 = gn_step.gn_round(tT, tpts, tok, port_level.packed, intr, CFG._replace(inner_iters=2))
    T1, _ = gn_step.gn_round(tT, tpts, tok, port_level.packed, intr, CFG._replace(inner_iters=1))
    assert gn_step.LAUNCHES == before  # CPU tensors never launch
    n, d, aok = projective.associate_planes_t(tT, tpts, tok, port_level, intr, CFG)
    H, b, aux = projective.normal_equations_fixed_t(T1, tpts, n, d, aok, CFG)
    T_sep, stats_sep = projective.solve_update(T1, H, b, aux, tpts.shape[-1], CFG)
    torch.testing.assert_close(T2, T_sep, rtol=0, atol=0)
    for x, y in zip(stats2, stats_sep):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(T1, T2)  # the second step moved the pose


@pytest.mark.parametrize(
    "bad, error",
    [
        ("pts_f64", TypeError),
        ("ok_shape", ValueError),
        ("pts_strided", ValueError),
        ("table_shape", ValueError),
        ("too_many_points", ValueError),
    ],
)
def test_wrappers_reject_bad_inputs(bad, error):
    """Both entries refuse what their kernels do not take. P has no cap
    (above REGISTER_POINTS gn_round streams on the card); too_many_points
    is more points than flags."""
    b, p = 2, 300
    T = se3.identity().expand(b, 4, 4).contiguous()
    pts = torch.rand((b, 3, p))
    ok = torch.ones((b, p), dtype=torch.bool)
    packed = torch.zeros((b, 4, INTR.height, INTR.width))
    if bad == "pts_f64":
        pts = pts.double()
    elif bad == "too_many_points":
        pts = torch.rand((b, 3, p + 1))
    elif bad == "ok_shape":
        ok = ok[:, :-1]
    elif bad == "pts_strided":
        pts = torch.rand((b, p, 3)).transpose(1, 2)
    elif bad == "table_shape":
        packed = packed[..., :-1]
    for entry in (gn_step.gn_round, gn_step.gn_system):
        with pytest.raises(error):
            entry(T, pts, ok, packed, INTR, CFG)


def test_projective_icp_on_cpu_keeps_the_plain_path(frames):
    """On CPU tensors the solver never reaches a kernel launch."""
    src, dst = frames
    before = dict(gn_step.LAUNCHES)
    res = projective.register_depth_pair(torch.from_numpy(src)[None], torch.from_numpy(dst)[None], INTR, CFG)
    assert gn_step.LAUNCHES == before
    assert torch.isfinite(res.transform).all()
    assert res.inlier_fraction[0].item() > 0.5
