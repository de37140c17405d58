"""Parity of the port's GN-step plain versions with JAX, and the fused contract.

``gn_step_reference`` (associate_planes_t + normal_equations_fixed_t,
packed into 30 floats) is held against JAX's associate_planes_t +
normal_equations_fixed_t on the same numpy inputs: the association (n, d,
ok) exactly, H and b to 1e-5 relative to max|H| and max|b| (f32 sums over
P points run in another order), wsse and wsum to 1e-5 relative, the count
exactly. The CUDA kernels are held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py.
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


def _assert_system_close(system, H_ref, b_ref, aux_ref):
    H, b, aux = gn_step.unpack_system(system)
    H, b = H[0].numpy(), b[0].numpy()
    H_ref, b_ref = np.asarray(H_ref), np.asarray(b_ref)
    assert np.abs(H - H_ref).max() <= RTOL * np.abs(H_ref).max()
    assert np.abs(b - b_ref).max() <= RTOL * np.abs(b_ref).max()
    np.testing.assert_allclose(aux[0][0].item(), float(aux_ref[0]), rtol=RTOL)
    np.testing.assert_allclose(aux[1][0].item(), float(aux_ref[1]), rtol=RTOL)
    assert int(aux[2][0]) == int(aux_ref[2])


@pytest.mark.parametrize("level, samples, twist, dropout", CASES)
def test_gn_step_reference_matches_jax(frames, level, samples, twist, dropout):
    jlevel, jintr, pts, ok, port_level, T = _inputs(frames, level, samples, twist, dropout)
    jn, jd, jok = jproj.associate_planes_t(j32(T), pts.T, ok, jlevel, jintr, JCFG)
    jH, jb, jaux = jproj.normal_equations_fixed_t(j32(T), pts.T, jn, jd, jok, JCFG)

    tT, tpts, tok = _port_args(pts, ok, T)
    intr = interop.intrinsics_from_jax(jintr)
    system, n, d, aok = gn_step.gn_step_reference(tT, tpts, tok, port_level.packed, intr, CFG)
    assert system.shape == (1, gn_step.SYSTEM_SIZE)
    np.testing.assert_array_equal(aok[0].numpy(), np.asarray(jok))
    np.testing.assert_array_equal(n[0].numpy(), np.asarray(jn))
    np.testing.assert_array_equal(d[0].numpy(), np.asarray(jd))
    _assert_system_close(system, jH, jb, jaux)
    assert int(jaux[2]) > 0  # a non-empty system


@pytest.mark.parametrize("level, samples, twist, dropout", CASES[:2])
def test_fused_first_iteration_equals_separate_calls(frames, level, samples, twist, dropout):
    """gn_associate_reduce's system is the system that gn_reduce_fixed and
    normal_equations_fixed_t give from its own association at the same pose."""
    jlevel, jintr, pts, ok, port_level, T = _inputs(frames, level, samples, twist, dropout)
    tT, tpts, tok = _port_args(pts, ok, T)
    intr = interop.intrinsics_from_jax(jintr)
    system, n, d, aok = gn_step.gn_associate_reduce(tT, tpts, tok, port_level.packed, intr, CFG)
    torch.testing.assert_close(gn_step.gn_reduce_fixed(tT, tpts, n, d, aok, CFG), system, rtol=0, atol=0)
    n2, d2, ok2 = projective.associate_planes_t(tT, tpts, tok, port_level, intr, CFG)
    H, b, aux = projective.normal_equations_fixed_t(tT, tpts, n2, d2, ok2, CFG)
    torch.testing.assert_close(gn_step.pack_system(H, b, aux), system, rtol=0, atol=0)
    # A later inner iteration: another pose against the same fixed planes.
    T2 = se3.compose(se3.exp(torch.tensor([0.001, 0.0, -0.002, 0.0, 0.001, 0.0])), tT).contiguous()
    H2, b2, aux2 = projective.normal_equations_fixed_t(T2, tpts, n, d, aok, CFG)
    torch.testing.assert_close(
        gn_step.gn_reduce_fixed(T2, tpts, n, d, aok, CFG), gn_step.pack_system(H2, b2, aux2), rtol=0, atol=0
    )


def test_pack_unpack_round_trip():
    g = torch.Generator().manual_seed(0)
    A = torch.randn((3, 6, 6), generator=g)
    H = A + A.transpose(1, 2)
    b = torch.randn((3, 6), generator=g)
    aux = (torch.rand(3, generator=g), torch.rand(3, generator=g), torch.tensor([0, 7, 2048], dtype=torch.int32))
    H2, b2, aux2 = gn_step.unpack_system(gn_step.pack_system(H, b, aux))
    torch.testing.assert_close(H2, H, rtol=0, atol=0)
    torch.testing.assert_close(b2, b, rtol=0, atol=0)
    for x, y in zip(aux2, aux):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize(
    "bad, error",
    [
        ("pts_f64", TypeError),
        ("ok_shape", ValueError),
        ("pts_strided", ValueError),
        ("table_shape", ValueError),
    ],
)
def test_wrappers_reject_bad_inputs(bad, error):
    b, p = 2, 300
    T = se3.identity().expand(b, 4, 4).contiguous()
    pts = torch.rand((b, 3, p))
    ok = torch.ones((b, p), dtype=torch.bool)
    packed = torch.zeros((b, 4, INTR.height, INTR.width))
    if bad == "pts_f64":
        pts = pts.double()
    elif bad == "ok_shape":
        ok = ok[:, :-1]
    elif bad == "pts_strided":
        pts = torch.rand((b, p, 3)).transpose(1, 2)
    elif bad == "table_shape":
        packed = packed[..., :-1]
    with pytest.raises(error):
        gn_step.gn_associate_reduce(T, pts, ok, packed, INTR, CFG)


def test_projective_icp_on_cpu_keeps_the_plain_path(frames):
    """On CPU tensors the solver never reaches a kernel launch."""
    src, dst = frames
    before = dict(gn_step.LAUNCHES)
    res = projective.register_depth_pair(torch.from_numpy(src)[None], torch.from_numpy(dst)[None], INTR, CFG)
    assert gn_step.LAUNCHES == before
    assert torch.isfinite(res.transform).all()
    assert res.inlier_fraction[0].item() > 0.5
