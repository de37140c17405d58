"""Parity of the port's RGB-D path with the JAX package: the RGB-D renderer,
the intensity pyramid and joint RGB-D registration (the trackers, the
facade and interop: tests/test_torch_rgbd_tracker.py).

Frames are the port's RGB-D renders of numpy-drawn scenes at the 200x150
intrinsics of tests/test_rgbd.py:22, handed as f32 numpy arrays to both
packages; the solver is RgbdIcpConfig(iters=(4, 4), samples=768), as
tests/test_windowed.py:577,626 use, except where a case names another.
Tolerances: poses 1e-4 in twist (1e-5 absolute per entry for trackers),
success and keyframe events exactly, rmse 1e-3 relative and inlier
fractions 0.01 (f32 sums in another order).
downsample_gray may part from XLA's CPU mean by up to 2 ulp: XLA sums a
2x2 block in an order that depends on the width (a standing record of
ROADMAP.md).
"""

import jax
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import rgbd as jrgbd
from realsensetracker_tpu.data import synthetic as jsyn
from realsensetracker_tpu_torch.align import rgbd
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.kernels import downsample, gn_step, level_kernel
from tests.torch_parity import intrinsics, j32, pose, scene, twist_gap

JINTR, INTR = intrinsics(150, 200, 160.0)
CFG = rgbd.RgbdIcpConfig(iters=(4, 4), samples=768)
JCFG = jrgbd.RgbdIcpConfig(iters=(4, 4), samples=768)


def _rgbd(T, sc, intr=INTR):
    """(depth, gray) f32 numpy frames of scene sc from pose T."""
    d, c = synthetic.render_rgbd(intr, torch.as_tensor(np.asarray(T, np.float32)), sc)
    return d.numpy(), synthetic.intensity_from_rgb(c).numpy()


def _sequence(n, step=(0.012, 0.0, 0.01, 0.0, 0.012, 0.0), seed=13):
    """n (depth, gray) frames of scene(seed) along a constant twist."""
    sc = scene(seed)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        poses.append(poses[-1] @ pose(step))
    frames = [_rgbd(T, sc) for T in poses]
    return [d for d, _ in frames], [g for _, g in frames]


def _failures_sequence():
    d, g = _sequence(4, step=(0.005, 0.0, 0.005, 0.0, 0.005, 0.0))
    blank = np.zeros_like(d[0])
    return d + [blank] * 3 + [d[-1]] * 2, g + [g[0]] * 3 + [g[-1]] * 2


@pytest.fixture(scope="module")
def stream():
    return _sequence(6)


@pytest.fixture(scope="module")
def failures():
    return _failures_sequence()


def _assert_results_match(a, b, rmse_rtol=1e-3, inlier_atol=0.01, pose_atol=1e-5):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.frame_index == rb.frame_index
        assert ra.success == rb.success, ra.frame_index
        for key in ("is_new_keyframe", "span_failures"):
            assert getattr(ra, key, None) == getattr(rb, key, None), (ra.frame_index, key)
        np.testing.assert_allclose(np.asarray(ra.pose), np.asarray(rb.pose), atol=pose_atol)
        np.testing.assert_allclose(ra.rmse, rb.rmse, rtol=rmse_rtol, atol=1e-7)
        assert abs(ra.inlier_fraction - rb.inlier_fraction) <= inlier_atol


def _assert_same_stream(a, b):
    """Port against port: the atol of tests/test_windowed.py:51-59."""
    _assert_results_match(a, b, rmse_rtol=0, inlier_atol=1e-5)


# --- rendering and the intensity pyramid --------------------------------------


@pytest.mark.parametrize("albedo", [True, False])
def test_render_rgbd_matches_jax(albedo):
    sc = scene(2)
    colors = np.random.RandomState(2).uniform(0.25, 0.95, (12, 3)).astype(np.float32)
    sc = sc._replace(sphere_albedo=torch.from_numpy(colors) if albedo else None)
    jsc = jsyn.Scene(j32(sc.sphere_centers), j32(sc.sphere_radii), j32(colors) if albedo else None)
    T = pose([0.02, -0.01, 0.015, 0.01, -0.008, 0.012])
    d, c = synthetic.render_rgbd(INTR, torch.from_numpy(T), sc)
    jd, jc = jsyn.render_rgbd(JINTR, j32(T), jsc)
    hit = np.asarray(jd) > 0
    np.testing.assert_array_equal(d.numpy() > 0, hit)
    # The depth renderers' tolerance (tests/test_torch_geometry.py:146); the
    # sphere normals and the texture's sines amplify the hit points' ulps.
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-4)
    assert np.median(np.abs(c.numpy() - np.asarray(jc))[hit]) < 1e-6
    np.testing.assert_allclose(synthetic.intensity_from_rgb(c).numpy(),
                               np.asarray(jsyn.intensity_from_rgb(jc)), atol=2e-4)


def test_render_trajectory_rgbd_shares_the_depth_trajectory():
    sc = scene(4)
    d, c, P = synthetic.render_trajectory_rgbd(INTR, 3, scene=sc, seed=7)
    d2, P2 = synthetic.render_trajectory(INTR, 3, scene=sc, seed=7)
    assert torch.equal(P, P2) and torch.equal(d, d2)
    assert c.shape == (3, INTR.height, INTR.width, 3) and 0 <= c.min() and c.max() <= 1


@pytest.mark.parametrize("hw", [(150, 200), (61, 83)])
def test_downsample_gray_within_two_ulp_of_jax(hw):
    g = np.random.RandomState(5).rand(*hw).astype(np.float32)
    got = rgbd.downsample_gray(torch.from_numpy(g)).numpy()
    ref = np.asarray(jrgbd.downsample_gray(j32(g)))
    assert got.shape == ref.shape == (hw[0] // 2, hw[1] // 2)
    assert np.abs(got.view(np.int32) - ref.view(np.int32)).max() <= 2


def test_rgbd_target_and_source_match_jax(stream):
    depths, grays = stream
    levels, grs, intrs = rgbd.build_rgbd_target(torch.from_numpy(depths[0])[None],
                                                torch.from_numpy(grays[0])[None], INTR, CFG)
    jlevels, jgrs, jintrs = jrgbd.build_rgbd_target(j32(depths[0]), j32(grays[0]), JINTR, JCFG)
    assert [tuple(i) for i in intrs] == [tuple(i) for i in jintrs]
    for lvl, jlvl, g, jg in zip(levels, jlevels, grs, jgrs):
        np.testing.assert_allclose(lvl.packed[0].numpy(), np.asarray(jlvl.packed), atol=2e-5)
        assert np.abs(g[0].numpy().view(np.int32) - np.asarray(jg).view(np.int32)).max() <= 2
    src = rgbd.sample_rgbd_source(torch.from_numpy(depths[1])[None], torch.from_numpy(grays[1])[None], intrs, CFG)
    jsrc = jax.jit(jrgbd.sample_rgbd_source, static_argnums=(2, 3))(j32(depths[1]), j32(grays[1]), jintrs, JCFG)
    for (pts, inten, ok), (jpts, jinten, jok) in zip(src, jsrc):
        np.testing.assert_array_equal(ok[0].numpy(), np.asarray(jok))
        np.testing.assert_allclose(pts[0].numpy(), np.asarray(jpts), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(inten[0].numpy(), np.asarray(jinten), rtol=3e-7, atol=0)


# --- joint registration -------------------------------------------------------


@pytest.mark.parametrize("case", ["cluttered", "slide"])
def test_register_rgbd_pair_matches_jax(case):
    """tests/test_rgbd.py:152-188 on the port's renders: the cluttered scene,
    and a flat wall where point-to-plane leaves the in-plane slide
    unobservable and the photometric term pins it."""
    if case == "cluttered":
        sc, tw, bar = scene(0), [0.02, -0.015, 0.02, 0.012, -0.01, 0.015], 2e-3
    else:
        sc = synthetic.Scene(torch.full((1, 3), 100.0), torch.full((1,), 0.01), None, 100.0, 3.0)
        tw, bar = [0.02, -0.015, 0.0, 0.0, 0.0, 0.01], 5e-4
    T = pose(tw)
    d0, g0 = _rgbd(np.eye(4, dtype=np.float32), sc)
    d1, g1 = _rgbd(T, sc)
    res = rgbd.register_rgbd_pair(*(torch.from_numpy(a)[None] for a in (d1, g1, d0, g0)), INTR, CFG)
    jres = jrgbd.register_rgbd_pair(j32(d1), j32(g1), j32(d0), j32(g0), JINTR, JCFG)
    assert twist_gap(res.transform[0], jres.transform) < 1e-4
    assert twist_gap(res.transform[0], T) < bar
    np.testing.assert_allclose([res.rmse.item(), res.photo_rmse.item()],
                               [float(jres.rmse), float(jres.photo_rmse)], rtol=1e-3, atol=1e-7)
    assert abs(res.num_matched.item() - int(jres.num_matched)) <= 0.01 * CFG.samples
    assert res.inlier_fraction.item() > 0.5


def test_register_rgbd_pair_runs_no_kernel_on_cpu_and_batches(stream):
    depths, grays = stream
    before = (downsample.LAUNCHES, level_kernel.LAUNCHES, dict(gn_step.LAUNCHES))
    src = [torch.from_numpy(np.stack(x[1:3])) for x in (depths, grays)]
    dst = [torch.from_numpy(np.stack(x[0:2])) for x in (depths, grays)]
    both = rgbd.register_rgbd_pair(src[0], src[1], dst[0], dst[1], INTR, CFG)
    assert (downsample.LAUNCHES, level_kernel.LAUNCHES, dict(gn_step.LAUNCHES)) == before
    for i in range(2):
        one = rgbd.register_rgbd_pair(src[0][i : i + 1], src[1][i : i + 1], dst[0][i : i + 1], dst[1][i : i + 1],
                                      INTR, CFG)
        assert twist_gap(one.transform[0], both.transform[i]) < 1e-6
