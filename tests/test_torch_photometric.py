"""Parity of the port's photometric alignment and of the point-major GN
system (projective.build_normal_equations) with the JAX package.

Inputs are the port's RGB-D renders of numpy-drawn scenes at the 120x90
intrinsics of tests/test_photometric.py:13, handed as f32 numpy arrays to
both packages. Tolerances: residuals and validity 1e-6 and exact; the
photometric Jacobian (forward-mode AD through the projection and the
bilinear sample) 1e-5 relative to its largest entry; H and b of the
geometric block 1e-5 relative to their largest entry (f32 sums over the
points in another order). The photometric block's H within 1e-5 of
trace(H), its b within 1e-5 of the sum of its terms' magnitudes,
sum_i |J_i w_i r_i|: a Jacobian row's entries carry the difference of two
neighbouring pixels, so the two AD orders part by up to 7e-5 of a row, and
b, a sum of such rows with cancellations, by up to 3.5e-5 of its largest
entry. align_photometric's pose 1e-4 in twist.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import photometric as jphoto
from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.align import rgbd as jrgbd
from realsensetracker_tpu.geometry import camera as jcam
from realsensetracker_tpu.geometry import se3 as jse3
from realsensetracker_tpu.ops import pyramid as jpyr
from realsensetracker_tpu.ops.sampling import bilinear_sample as jbilinear
from realsensetracker_tpu_torch.align import photometric, projective, rgbd
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.kernels import gn_step
from realsensetracker_tpu_torch.ops import pyramid
from tests.torch_parity import intrinsics, j32, pose, scene, twist_gap

JINTR, INTR = intrinsics(90, 120, 120.0)
ICP = projective.ProjectiveIcpConfig()
JICP = jproj.ProjectiveIcpConfig()
RGBD = rgbd.RgbdIcpConfig()
JRGBD = jrgbd.RgbdIcpConfig()
MOVED = [0.01, -0.008, 0.012, 0.006, -0.005, 0.008]


def _render(T, sc):
    d, c = synthetic.render_rgbd(INTR, torch.from_numpy(T), sc)
    return d.numpy(), synthetic.intensity_from_rgb(c).numpy()


@pytest.fixture(scope="module")
def frames():
    """(dst depth, dst gray, src depth, src gray, T_true): src is the camera
    moved by MOVED in the cluttered scene 0."""
    sc = scene(0)
    T = pose(MOVED)
    d0, g0 = _render(np.eye(4, dtype=np.float32), sc)
    d1, g1 = _render(T, sc)
    return d0, g0, d1, g1, T


@pytest.fixture(scope="module")
def samples(frames):
    """The source's stride sample (pts, inten, ok), 2048 points."""
    _, _, d1, g1, _ = frames
    pts, inten, ok = rgbd.sample_depth_gray_points(torch.from_numpy(d1)[None], torch.from_numpy(g1)[None],
                                                   INTR, 2048)
    return pts[0].numpy(), inten[0].numpy(), ok[0].numpy()


def _rel_close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rtol * np.abs(ref).max())


def test_sample_intensity_points_matches_compiled_jax(frames):
    """The JAX trackers sample under jax.jit, which scales by 1/fx: exact."""
    _, _, d1, g1, _ = frames
    pts, inten, ok = photometric.sample_intensity_points(torch.from_numpy(d1)[None], torch.from_numpy(g1)[None],
                                                         INTR, 1000)
    jfn = jax.jit(jrgbd.sample_depth_gray_points, static_argnums=(2, 3))
    jpts, jinten, jok = jfn(j32(d1), j32(g1), JINTR, 1000)
    np.testing.assert_array_equal(pts[0].numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(inten[0].numpy(), np.asarray(jinten))
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(jok))


@pytest.mark.parametrize("moved", [False, True])
def test_photometric_residuals_match_jax(frames, samples, moved):
    g0 = frames[1]
    pts, inten, _ = samples
    T = pose(MOVED) if moved else np.eye(4, dtype=np.float32)
    r, ok = photometric.photometric_residuals(torch.from_numpy(T)[None], torch.from_numpy(pts)[None],
                                              torch.from_numpy(inten)[None], torch.from_numpy(g0)[None], INTR)
    jr, jok = jphoto.photometric_residuals(j32(T), j32(pts), j32(inten), j32(g0), JINTR)
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(jok))
    np.testing.assert_allclose(r[0].numpy(), np.asarray(jr), rtol=0, atol=1e-6)


def test_huber_weight_matches_jax():
    r = np.array([0.0, 0.05, -0.08, 0.08, 0.1, -0.3, 2.0, 1e-32], np.float32)
    for delta in (0.08, 0.1):
        np.testing.assert_array_equal(photometric.huber_weight(torch.from_numpy(r), delta).numpy(),
                                      np.asarray(jphoto.huber_weight(j32(r), delta)))


def _jax_photo_jacobian(T, pts, inten, gray, intr):
    """JAX's _photo_system Jacobian (align/rgbd.py:104-124), by jax.jacfwd."""

    def residual(tw):
        p = jse3.transform_points(jse3.compose(jse3.exp(tw), T), pts)
        u, v, z = jcam.project(p, intr)
        vals, inb = jbilinear(gray, u, v)
        return jnp.where(inb & (z > 0.05), vals - inten, 0.0)

    return np.asarray(jax.jacfwd(residual)(jnp.zeros(6, jnp.float32)))


def _port_photo_jacobian(T, pts, inten, gray, intr):
    def residual(p):
        r, ok = photometric.residuals_at(p, inten, gray, intr)
        return r, ok

    return photometric.twist_jacobian(residual, se3.transform_points(T, pts))[0]


@pytest.mark.parametrize("moved", [False, True])
def test_photo_system_matches_jax(frames, samples, moved):
    """_photo_system's J, H, b and sums against JAX's at one pose."""
    g0 = frames[1]
    pts, inten, ok = samples
    T = pose(MOVED) if moved else np.eye(4, dtype=np.float32)
    tT, tpts, tint, tok, tg = (torch.from_numpy(a)[None] for a in (T, pts, inten, ok, g0))
    J = _port_photo_jacobian(tT, tpts, tint, tg, INTR)
    jJ = _jax_photo_jacobian(j32(T), j32(pts), j32(inten), j32(g0), JINTR)
    _rel_close(J[0].numpy(), jJ)
    H, b, (wsse, wsum) = rgbd._photo_system(tT, tpts, tint, tok, tg, INTR, RGBD)
    jH, jb, (jwsse, jwsum) = jrgbd._photo_system(j32(T), j32(pts), j32(inten), jnp.asarray(ok), j32(g0), JINTR,
                                                 JRGBD)
    jH, jb = np.asarray(jH), np.asarray(jb)
    np.testing.assert_allclose(H[0].numpy(), jH, rtol=0, atol=1e-5 * np.trace(jH))
    r, okp = photometric.photometric_residuals(tT, tpts, tint, tg, INTR)
    w = photometric.huber_weight(r, RGBD.photo_huber) * (okp & tok)
    terms = (np.abs(jJ) * np.abs((w * r)[0].numpy())[:, None]).sum(0)
    assert (np.abs(b[0].numpy() - jb) <= 1e-5 * terms).all()
    np.testing.assert_allclose([wsse.item(), wsum.item()], [float(jwsse), float(jwsum)], rtol=1e-5)


def test_photo_jacobian_at_a_point_on_the_edge_matches_jax():
    """A point built to project exactly onto column 0 (u = fx x / z + cx =
    64 (-0.5) / 1 + 32) and one onto the last row: their Jacobian rows
    carry the clip's tie derivative 0.5, as JAX's do."""
    args = dict(fx=64.0, fy=64.0, cx=32.0, cy=0.0, width=40, height=30)
    intr, jintr = camera.Intrinsics(**args), jcam.Intrinsics(**args)
    gray = np.random.RandomState(3).rand(30, 40).astype(np.float32)
    pts = np.array([[-0.5, 0.25, 1.0], [0.125, 29.0 / 64.0, 1.0], [0.1, 0.2, 1.0]], np.float32)
    inten = np.full(3, 0.5, np.float32)
    T = np.eye(4, dtype=np.float32)
    J = _port_photo_jacobian(*(torch.from_numpy(a)[None] for a in (T, pts, inten, gray)), intr)[0].numpy()
    jJ = _jax_photo_jacobian(j32(T), j32(pts), j32(inten), j32(gray), jintr)
    np.testing.assert_allclose(J, jJ, rtol=1e-6, atol=1e-6)
    # A full-derivative clip (torch.clamp) would differ on the edge rows.
    assert np.abs(jJ[:2]).max() > 0


def test_align_photometric_matches_jax():
    """Photometric-only alignment on an edge-free wall and floor
    (tests/test_rgbd.py:190-212): the pose within 1e-4 of JAX's."""
    sc = synthetic.Scene(torch.full((1, 3), 100.0), torch.full((1,), 0.01), None, 1.2, 4.0)
    T = pose(MOVED)
    d0, g0 = _render(np.eye(4, dtype=np.float32), sc)
    d1, g1 = _render(T, sc)
    pts, inten, ok = photometric.sample_intensity_points(torch.from_numpy(d1)[None], torch.from_numpy(g1)[None],
                                                         INTR, 2048)
    cfg = photometric.PhotometricConfig(iters=20)
    res = photometric.align_photometric(pts, inten, ok, torch.from_numpy(g0)[None], INTR, cfg=cfg)
    jres = jphoto.align_photometric(j32(pts[0]), j32(inten[0]), jnp.asarray(ok[0].numpy()), j32(g0), JINTR,
                                    cfg=jphoto.PhotometricConfig(iters=20))
    assert twist_gap(res.transform[0], jres.transform) < 1e-4
    assert twist_gap(res.transform[0], T) < 5e-3  # tests/test_rgbd.py:212
    np.testing.assert_allclose(res.rmse.item(), float(jres.rmse), rtol=1e-3)
    assert res.num_valid.item() == int(jres.num_valid)


@pytest.mark.parametrize("moved", [False, True])
def test_build_normal_equations_matches_jax(frames, samples, moved):
    d0 = frames[0]
    pts, _, ok = samples
    T = pose(MOVED) if moved else np.eye(4, dtype=np.float32)
    levels, _ = pyramid.build_pyramid(torch.from_numpy(d0)[None], INTR, 1)
    jlevels, _ = jpyr.build_pyramid(j32(d0), JINTR, 1, use_kernel=False)
    H, b, (wsse, wsum, count) = projective.build_normal_equations(
        torch.from_numpy(T)[None], torch.from_numpy(pts)[None], torch.from_numpy(ok)[None], levels[0], INTR, ICP
    )
    jH, jb, (jwsse, jwsum, jcount) = jproj.build_normal_equations(j32(T), j32(pts), jnp.asarray(ok), jlevels[0],
                                                                  JINTR, JICP)
    assert count.dtype == torch.int32 and count.item() == int(jcount) > 1000
    _rel_close(H[0].numpy(), jH)
    _rel_close(b[0].numpy(), jb)
    np.testing.assert_allclose([wsse.item(), wsum.item()], [float(jwsse), float(jwsum)], rtol=1e-5)


def test_point_major_functions_match_jax(frames, samples):
    d0 = frames[0]
    pts, _, ok = samples
    T = pose(MOVED)
    levels, _ = pyramid.build_pyramid(torch.from_numpy(d0)[None], INTR, 1)
    jlevels, _ = jpyr.build_pyramid(j32(d0), JINTR, 1, use_kernel=False)
    tT, tpts, tok = torch.from_numpy(T)[None], torch.from_numpy(pts)[None], torch.from_numpy(ok)[None]
    n, d, aok = projective.associate_planes(tT, tpts, tok, levels[0], INTR, ICP)
    jn, jd, jok = jproj.associate_planes(j32(T), j32(pts), jnp.asarray(ok), jlevels[0], JINTR, JICP)
    np.testing.assert_array_equal(aok[0].numpy(), np.asarray(jok))
    np.testing.assert_allclose(n[0].numpy(), np.asarray(jn), atol=2e-5)
    np.testing.assert_allclose(d[0].numpy(), np.asarray(jd), atol=2e-5)
    H, b, aux = projective.normal_equations_fixed(tT, tpts, n, d, aok, ICP)
    jH, jb, jaux = jproj.normal_equations_fixed(j32(T), j32(pts), jn, jd, jok, JICP)
    _rel_close(H[0].numpy(), jH)
    _rel_close(b[0].numpy(), jb)
    assert int(aux[2][0]) == int(jaux[2])


def test_build_normal_equations_on_cpu_is_gn_system_reference(frames, samples):
    """CPU tensors take the plain composition and never launch; a batch's
    rows equal their B=1 systems."""
    d0 = frames[0]
    pts, _, ok = samples
    Ts = torch.from_numpy(np.stack([np.eye(4, dtype=np.float32), pose(MOVED)]))
    levels, _ = pyramid.build_pyramid(torch.from_numpy(np.stack([d0, d0])), INTR, 1)
    tpts, tok = torch.from_numpy(np.stack([pts, pts])), torch.from_numpy(np.stack([ok, ok]))
    before = dict(gn_step.LAUNCHES)
    H, b, aux = projective.build_normal_equations(Ts, tpts, tok, levels[0], INTR, ICP)
    ref = gn_step.gn_system(Ts, tpts.transpose(1, 2).contiguous(), tok, levels[0].packed, INTR, ICP)
    assert gn_step.LAUNCHES == before
    for x, y in zip((H, b, *aux), (ref[0], ref[1], *ref[2])):
        assert torch.equal(x, y)
    for i in range(2):
        Hi, bi, _ = projective.build_normal_equations(Ts[i : i + 1], tpts[i : i + 1], tok[i : i + 1],
                                                      pyramid.PyramidLevel(*(t[i : i + 1] for t in levels[0])),
                                                      INTR, ICP)
        torch.testing.assert_close(Hi[0], H[i], rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(bi[0], b[i], rtol=1e-6, atol=1e-6)
