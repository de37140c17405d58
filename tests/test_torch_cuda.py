"""Tests of the port's CUDA kernels: they need a card and nvcc, and skip
elsewhere. This file imports neither JAX nor the JAX package, so it runs on
a machine with a card and no JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The downsample kernel is held against its plain torch version bit for bit
(both sum the children in one order and divide exactly); the level kernel
against its plain torch version at atol 2e-5 with the validity pattern
exact; the GN round (gn_round) against its plain version with the pose
within 1e-5 in twist, the matched count within max(1, 0.1% of P) (a ulp in
the point transform can move a point across a pixel's half-way line) and
rmse within 1e-4 relative (f32 sums in another order), bit-identical from
launch to launch and from batch to batch; the CUDA paths against the
same code on CPU: registration and the projective trackers to 1e-4, the
world map by count, the cloud trackers to 1e-3 (a near-tie nearest
neighbour can go the other way in another summation order).
"""

import numpy as np
import pytest
import torch

from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.kernels import downsample, gn_step, level_kernel
from realsensetracker_tpu_torch.ops import pyramid
from realsensetracker_tpu_torch.parallel import batched
from realsensetracker_tpu_torch.tracking.keyframe import KeyframeTracker

pytestmark = pytest.mark.cuda

ATOL = 2e-5
# (height, width): the level shapes of a 640x480 frame, the odd heights of
# tests/test_kernels.py, and odd dims.
SHAPES = [(480, 640), (240, 320), (120, 160), (60, 80), (482, 64), (36, 128), (61, 83)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the level kernel is CUDA-only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _intr(h, w):
    return camera.Intrinsics(fx=0.8 * w, fy=0.8 * w, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)


def _depths(intr, n, device):
    """n masked frames (0 = invalid) from small camera motions, with holes."""
    sc = synthetic.default_scene(seed=3, device=device)
    tw = 0.02 * torch.randn((n, 6), generator=torch.Generator().manual_seed(0))
    d = torch.stack([synthetic.render_depth(intr, se3.exp(t).to(device), sc) for t in tw])
    holes = torch.rand(d.shape, generator=torch.Generator().manual_seed(1)).to(device) < 0.05
    d = torch.where(holes, 0.0, d)
    return torch.where((d > 0.05) & (d < 10.0), d, 0.0).contiguous()


def _assert_plane_tables(got, ref):
    torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)
    assert torch.equal(got[:, :3].abs().sum(1) > 0, ref[:, :3].abs().sum(1) > 0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_matches_reference(cuda, shape):
    intr = _intr(*shape)
    d = _depths(intr, 3, cuda)
    before = level_kernel.LAUNCHES
    got = level_kernel.build_level_packed(d, intr)
    torch.cuda.synchronize()
    assert level_kernel.LAUNCHES == before + 1
    _assert_plane_tables(got, level_kernel.build_level_packed_reference(d, intr))


@pytest.mark.parametrize("num_levels", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_downsample_kernel_matches_reference(cuda, shape, num_levels):
    d = _depths(_intr(*shape), 3, cuda)
    before = downsample.LAUNCHES
    got = downsample.downsample_levels(d, num_levels, min_depth=0.05)
    torch.cuda.synchronize()
    assert downsample.LAUNCHES == before + (num_levels > 1)  # L = 1 launches nothing
    ref = downsample.downsample_levels_reference(d, num_levels)
    assert len(got) == len(ref) == num_levels - 1
    for (gd, gv), (rd, rv) in zip(got, ref):
        assert torch.equal(gv, rv)
        assert torch.equal(gd, rd)


def test_downsample_kernel_chains_past_five_levels(cuda):
    d = _depths(_intr(480, 640), 2, cuda)
    got = downsample.downsample_levels(d, 8, min_depth=0.05)
    for (gd, gv), (rd, rv) in zip(got, downsample.downsample_levels_reference(d, 8)):
        assert torch.equal(gv, rv) and torch.equal(gd, rd)


def test_pyramid_auto_uses_kernel(cuda):
    intr = _intr(120, 160)
    d = _depths(intr, 2, cuda)
    before, ds_before = level_kernel.LAUNCHES, downsample.LAUNCHES
    got, _ = pyramid.build_pyramid(d, intr, 3)
    assert level_kernel.LAUNCHES == before + 3
    assert downsample.LAUNCHES == ds_before + 1
    ref, _ = pyramid.build_pyramid(d, intr, 3, use_kernel=False)
    for g, r in zip(got, ref):
        _assert_plane_tables(g.packed, r.packed)
        assert torch.equal(g.valid, r.valid)


def _gn_inputs(shape, p, device):
    """(T (3,4,4), pts (3,3,P), ok (3,P), packed (3,4,H,W), intr) at one
    level shape: destination plane tables from the level kernel, source
    points sampled from frames moved by small twists."""
    intr = _intr(*shape)
    dst = _depths(intr, 3, device)
    packed = level_kernel.build_level_packed(dst, intr)
    src = torch.flip(dst, dims=(0,)).contiguous()  # another frame of the same scene
    pts, ok = projective.sample_depth_points(src, intr, p)
    tw = 0.01 * torch.randn((3, 6), generator=torch.Generator().manual_seed(2))
    T = se3.exp(tw).to(device).contiguous()
    return T, pts.transpose(1, 2).contiguous(), ok.contiguous(), packed, intr


def _assert_rounds_close(got, ref, p):
    """gn_round against gn_round_reference: the pose within 1e-5 in twist,
    the matched count within max(1, 0.1% of P) (a ulp of the transform can
    move a point across a pixel's half-way line or the distance gate), rmse
    within 1e-4 relative (f32 sums in another order)."""
    (T, (rmse, _, count)), (Tr, (rmser, _, countr)) = got, ref
    assert torch.isfinite(T).all()
    twist = se3.log(se3.compose(se3.inverse(Tr), T)).abs().amax()
    assert twist.item() <= 1e-5
    assert (count - countr).abs().max().item() <= max(1, 1e-3 * p)
    assert ((rmse - rmser).abs() <= 1e-4 * rmser + 1e-9).all()


def _assert_equal_rounds(a, b):
    (Ta, sa), (Tb, sb) = a, b
    assert torch.equal(Ta, Tb)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("inner_iters", [1, 2, 3])
@pytest.mark.parametrize("p", [2048, 777])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gn_round_matches_reference(cuda, shape, p, inner_iters):
    cfg = projective.ProjectiveIcpConfig(inner_iters=inner_iters)
    T, pts, ok, packed, intr = _gn_inputs(shape, p, cuda)
    before = gn_step.LAUNCHES["gn_round"]
    got = gn_step.gn_round(T, pts, ok, packed, intr, cfg)
    again = gn_step.gn_round(T, pts, ok, packed, intr, cfg)
    torch.cuda.synchronize()
    assert gn_step.LAUNCHES["gn_round"] == before + 2
    _assert_equal_rounds(again, got)  # no atomics: bit-identical
    _assert_rounds_close(got, gn_step.gn_round_reference(T, pts, ok, packed, intr, cfg), p)


@pytest.mark.parametrize("p", [3000, gn_step.MAX_POINTS])
def test_gn_round_above_one_point_per_thread(cuda, p):
    """Two and four points per thread (P > 2048), up to the cap; one more
    point raises."""
    cfg = projective.ProjectiveIcpConfig()
    T, pts, ok, packed, intr = _gn_inputs((480, 640), p, cuda)
    _assert_rounds_close(gn_step.gn_round(T, pts, ok, packed, intr, cfg),
                         gn_step.gn_round_reference(T, pts, ok, packed, intr, cfg), p)
    more = torch.cat([pts, pts[..., :1]], dim=-1)
    if more.shape[-1] > gn_step.MAX_POINTS:
        with pytest.raises(ValueError):
            gn_step.gn_round(T, more, torch.cat([ok, ok[:, :1]], dim=-1), packed, intr, cfg)


@pytest.mark.parametrize("p", [2048, 777, 256])
def test_gn_round_pair_does_not_depend_on_batch(cuda, p):
    """A pair's round at B=1 equals, bit for bit, its round inside B=8."""
    cfg = projective.ProjectiveIcpConfig()
    T, pts, ok, packed, intr = _gn_inputs((240, 320), p, cuda)
    order = torch.tensor([2, 0, 1, 1, 0, 2, 2, 1], device=cuda)
    batch = gn_step.gn_round(*(x[order].contiguous() for x in (T, pts, ok, packed)), intr, cfg)
    for row, i in enumerate(order.tolist()):
        single = gn_step.gn_round(T[i : i + 1], pts[i : i + 1], ok[i : i + 1], packed[i : i + 1], intr, cfg)
        _assert_equal_rounds(single, (batch[0][row : row + 1], tuple(s[row : row + 1] for s in batch[1])))


def test_gn_round_keeps_pose_without_a_solution(cuda):
    """An all-invalid pair (H = 0, so delta = 0) and a pair whose system
    overflows f32 (one matched point at depth 1e30 against the plane
    x = 0: J has a 1e30 entry, H an inf, the solve no finite step) keep
    their poses bit for bit, as solve_update's guard does; the third pair
    is a normal round."""
    cfg = projective.ProjectiveIcpConfig()
    T, pts, ok, packed, intr = _gn_inputs((120, 160), 2048, cuda)
    T, pts, ok, packed = T.clone(), pts.clone(), ok.clone(), packed.clone()
    ok[0] = False
    T[1] = se3.identity(device=cuda)
    pts[1, :, 0] = torch.tensor([0.0, 0.0, 1e30], device=cuda)
    ok[1, 0] = True
    packed[1] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=cuda)[:, None, None]
    got = gn_step.gn_round(T, pts, ok, packed, intr, cfg)
    ref = gn_step.gn_round_reference(T, pts, ok, packed, intr, cfg)
    torch.cuda.synchronize()
    for T_new in (got[0], ref[0]):
        assert torch.equal(T_new[:2], T[:2])
    assert got[1][2][0].item() == ref[1][2][0].item() == 0
    assert got[1][2][1].item() == ref[1][2][1].item() > 0
    _assert_rounds_close((got[0][2:], tuple(s[2:] for s in got[1])),
                         (ref[0][2:], tuple(s[2:] for s in ref[1])), 2048)


def _register_on_both(cuda, cfg):
    intr = _intr(120, 160)
    sc = synthetic.default_scene(seed=1)
    tw = torch.tensor([[0.02, -0.01, 0.015, 0.01, -0.015, 0.01], [0.0, 0.01, 0.0, 0.0, 0.0, 0.02]])
    dst = synthetic.render_depth(intr, se3.identity(), sc)[None].expand(2, -1, -1).contiguous()
    src = torch.stack([synthetic.render_depth(intr, se3.exp(t), sc) for t in tw])
    ref = batched.register_batch(src, dst, intr, cfg)
    before, gn_before, ds_before = level_kernel.LAUNCHES, dict(gn_step.LAUNCHES), downsample.LAUNCHES
    got = batched.register_batch(src.to(cuda), dst.to(cuda), intr, cfg)
    fitted = projective.fit_levels(cfg, 120, 160)
    pyramids = 2 if cfg.sample_mode == "normal_space" else 1  # + the source pyramid
    assert level_kernel.LAUNCHES == before + pyramids * len(fitted.iters)
    assert downsample.LAUNCHES == ds_before + 2  # destination pyramid + source levels
    rounds = sum(fitted.iters)
    assert gn_step.LAUNCHES["gn_round"] == gn_before["gn_round"] + rounds
    np.testing.assert_allclose(
        se3.log(got.transform.cpu()).numpy(), se3.log(ref.transform).numpy(), atol=1e-4
    )


def test_register_batch_on_cuda_matches_cpu(cuda):
    _register_on_both(cuda, projective.ProjectiveIcpConfig())


def test_normal_space_register_on_cuda_matches_cpu(cuda):
    _register_on_both(cuda, projective.ProjectiveIcpConfig(sample_mode="normal_space"))


def test_tracker_on_cuda_matches_cpu(cuda):
    intr = _intr(90, 120)
    depths, _ = synthetic.render_trajectory(intr, 5, seed=2)
    poses = []
    for device in ("cpu", cuda):
        tracker = Tracker(TrackerConfig(intrinsics=intr, device=str(device)))
        poses.append(np.stack([tracker.process(d).pose for d in depths]))
    np.testing.assert_allclose(poses[1], poses[0], atol=1e-4)


@pytest.mark.parametrize("window", [0, 4], ids=["per_frame", "window4"])
def test_keyframe_tracker_on_cuda_matches_cpu(cuda, window):
    """u16 frames, thresholds low enough that keyframes get promoted."""
    intr = _intr(90, 120)
    depths, _ = synthetic.render_trajectory(intr, 9, seed=2, step_scale=0.02)
    raw = [np.asarray(d.numpy() * 1000.0 + 0.5, np.uint16) for d in depths]
    runs = []
    for device in ("cpu", cuda):
        tracker = KeyframeTracker(intr, max_translation=0.04, max_rotation=0.04, device=device)
        if window:
            res, i = [], 0
            while i < len(raw):
                res += tracker.process_window(raw[i : i + window], pad_to=window, truncate_at_events=False)
                i = len(res)
        else:
            res = [tracker.process(d) for d in raw]
        runs.append(res)
    assert sum(r.is_new_keyframe for r in runs[0][1:]) >= 2
    for a, b in zip(*runs):
        assert a.success == b.success and a.is_new_keyframe == b.is_new_keyframe
        np.testing.assert_allclose(b.pose, a.pose, atol=1e-4)


def _stream(intr, n, device="cpu"):
    depths, _ = synthetic.render_trajectory(intr, n, seed=2)
    return depths.to(device)


def test_world_map_tracker_on_cuda_matches_cpu(cuda):
    intr = _intr(90, 120)
    depths = _stream(intr, 6)
    runs = []
    for device in ("cpu", cuda):
        tracker = Tracker(TrackerConfig(intrinsics=intr, map_capacity=8192, device=str(device)))
        poses = np.stack([tracker.process(d).pose for d in depths])
        runs.append((poses, int(tracker.world_map.count()), tracker.world_map))
    np.testing.assert_allclose(runs[1][0], runs[0][0], atol=1e-4)
    assert abs(runs[1][1] - runs[0][1]) <= 0.01 * runs[0][1]
    assert runs[1][2].points.is_cuda and runs[1][2].keys.dtype == torch.int32


@pytest.mark.parametrize("method", ["model", "icp"])
def test_cloud_trackers_on_cuda_match_cpu(cuda, method):
    from realsensetracker_tpu_torch.api.config import AlignConfig

    intr = _intr(90, 120)
    depths = _stream(intr, 4)
    runs = []
    for device in ("cpu", cuda):
        cfg = TrackerConfig(intrinsics=intr, method=method, align=AlignConfig(icp_max_iter=24, cloud_capacity=2048),
                            map_capacity=4096 if method == "model" else 0, device=str(device))
        tracker = Tracker(cfg)
        res = [tracker.process(d) for d in depths]
        assert all(r.success for r in res)
        runs.append(np.stack([r.pose for r in res]))
    np.testing.assert_allclose(runs[1], runs[0], atol=1e-3)

