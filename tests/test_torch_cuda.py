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
launch to launch and from batch to batch, in registers up to 8192 points
and streamed above; the GN system (gn_system) against its plain version
with H and b within 1e-5 of trace(H), the count within 1, bit-identical
likewise; the CUDA paths against the same code on CPU: registration, the
projective and RGB-D trackers to 1e-4, the world map by count, the cloud
trackers to 1e-3 (a near-tie nearest neighbour can go the other way in
another summation order).

The pairwise modules (k-NN, covariances, FPFH, GICP, the k-core screen,
robust registration, the registry's pipelines) are held to their own CPU
run at 8192 points: k-NN indices equal on a cloud whose coordinates are
multiples of 2^-10 (every squared distance exact, so only the tie rule
orders equal ones), covariances to 1e-6, poses to 1e-4 in twist, the
k-core exactly. FPFH is held row by row: a pair whose |n1.d| and |n2.d|
agree to an ulp (neighbours with the same k-NN set) takes the origin
switch by rounding (tests/test_torch_fpfh.py), so a few rows may part.

The backbone preconditioner (csrc/backbone.cu, block cyclic reduction in
f64) is held to its plain version within 1e-10 of the largest entry of
S_inv, U and z (the same operations in the same order: bit for bit is
expected) at n from 2 to 5000, odd n included; a singular block and a NaN
give non-finite factors on the same blocks and the apply returns r.

The dense kernels (the port's own: csrc/tsdf_integrate.cu and
csrc/tsdf_raycast.cu) are held to their plain torch versions at V = 48 and
128, full pass, slab window and colored: tsdf and weight within 1e-6 (they
compute the same operations in the same order, so bit for bit is
expected) with the update masks identical, a closed gate leaving the volume
bit-identical; the brick integrate bit for bit at V = 40, 48, 96 and 128
(full, slab window, colored, an x-slab off the brick boundaries, 32
adversarial poses each), the cull's list (cull_bricks) equal to the plain
twin's bricks (brick_mask_reference) and those holding every updated
voxel, a frame without valid depth or a closed gate keeping no brick, and
the slot entry (fuse_blocks, one launch of each kernel for S slots with
mixed gates) bit-identical to a launch per slot; the raycast with the hit
masks identical and depth within 1e-5 where both hit, full and
coarse-to-fine, and at 128^3 and 512^3 bit for bit (full, coarse-to-fine,
a per-ray z_start, a gate, no steps); the march of a volume's planes bit
for bit equal to the plain march of its field in the same cases, on fused
planes, on adversarial ones (weight 0 under any tsdf, tsdf beyond [-1, 1],
-0.0, NaN in tsdf and in weight) and on a slot of an (S, V, V, V) stream
volume, and a render of a whole volume launching the two plane marches and
coarse_seeds' ops and nothing else; Tracker(method="tsdf") on the card
within 1e-4 of the CPU.

Host I/O: 64 u16 frames through FrameStream(prefetch=2), each read by the
consumer's kernels behind a long matmul, equal to their host copies (the
upload's event wait and record_stream); the native PNG decoder bit-equal
to the numpy one; rs_replay on the card within 1e-4 of the CPU.

The CLIs: rs_benchmark's projective-icp JSON line well formed and its
transforms within 1e-4 of the CPU run; rs_streams' printed lines well
formed and its final poses within 1e-4 of the CPU run.

The multi-device layer: gn_system with an association pose against its
plain version (gn_system's bars), and without one bit-identical to the old
entry; the integrate kernel on four x-slabs bit-identical to the whole
volume's planes. Each sharded entry point on a world-size-1 NCCL group
(one card: the collectives run, each the identity): point-sharded
registration within 1e-5 in twist of register_batch with gn_system
launched sum(iters) x inner_iters times, data-parallel registration, the
slab TSDF and the sharded executor equal to their unsharded runs, the
multihost helpers, and dryrun_multichip(1). Two cards are never needed.
"""

import numpy as np
import pytest
import torch

from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.kernels import backbone, downsample, gn_step, level_kernel
from realsensetracker_tpu_torch.kernels import tsdf as tsdf_kernels
from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod
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


@pytest.mark.parametrize("p", [3000, gn_step.REGISTER_POINTS])
def test_gn_round_above_one_point_per_thread(cuda, p):
    """Two and four points per thread (P > 2048), up to the register path's
    8192; one more point takes the streamed path, with no error."""
    cfg = projective.ProjectiveIcpConfig()
    T, pts, ok, packed, intr = _gn_inputs((480, 640), p, cuda)
    _assert_rounds_close(gn_step.gn_round(T, pts, ok, packed, intr, cfg),
                         gn_step.gn_round_reference(T, pts, ok, packed, intr, cfg), p)
    more, ok_more = torch.cat([pts, pts[..., :1]], dim=-1), torch.cat([ok, ok[:, :1]], dim=-1)
    _assert_rounds_close(gn_step.gn_round(T, more, ok_more, packed, intr, cfg),
                         gn_step.gn_round_reference(T, more, ok_more, packed, intr, cfg), p + 1)


@pytest.mark.parametrize("p", [8193, 16384])
def test_gn_round_streams_above_the_register_path(cuda, p):
    """P > 8192: each inner iteration re-reads the points and their plane
    rows from the scratch buffer; the round still matches its plain version,
    is bit-identical from launch to launch and does not depend on B."""
    cfg = projective.ProjectiveIcpConfig(inner_iters=3)
    T, pts, ok, packed, intr = _gn_inputs((480, 640), p, cuda)
    got = gn_step.gn_round(T, pts, ok, packed, intr, cfg)
    _assert_equal_rounds(gn_step.gn_round(T, pts, ok, packed, intr, cfg), got)
    single = gn_step.gn_round(T[1:2], pts[1:2], ok[1:2], packed[1:2], intr, cfg)
    _assert_equal_rounds(single, (got[0][1:2], tuple(s[1:2] for s in got[1])))
    _assert_rounds_close(got, gn_step.gn_round_reference(T, pts, ok, packed, intr, cfg), p)


def _assert_systems_close(got, ref, p):
    """gn_system against gn_system_reference: H and b within 1e-5 of the
    pair's trace(H) (f32 sums in another order), wsse and wsum to 1e-5
    relative, the count within max(1, 0.1% of P), as gn_round's (a ulp of
    the transform can move a point across a pixel's half-way line or the
    gate)."""
    (H, b, (wsse, wsum, count)), (Hr, br, (wsser, wsumr, countr)) = got, ref
    scale = Hr.diagonal(dim1=-2, dim2=-1).sum(-1).clamp_min(1e-30)[:, None]
    assert ((H - Hr).abs().flatten(1) <= 1e-5 * scale).all()
    assert ((b - br).abs() <= 1e-5 * scale).all()
    assert torch.equal(H, H.transpose(1, 2))
    assert ((wsse - wsser).abs() <= 1e-5 * wsser + 1e-12).all()
    assert ((wsum - wsumr).abs() <= 1e-5 * wsumr + 1e-12).all()
    assert count.dtype == torch.int32 and (count - countr).abs().max().item() <= max(1, 1e-3 * p)


@pytest.mark.parametrize("p", [1, 2048, 8193, 16384])
@pytest.mark.parametrize("b", [1, 7, 512])
def test_gn_system_matches_reference(cuda, b, p):
    """One association and one reduction at T, the system out: against its
    plain version, bit-identical from launch to launch, each pair equal to
    its B=1 launch."""
    cfg = projective.ProjectiveIcpConfig()
    T, pts, ok, packed, intr = _gn_inputs((240, 320), p, cuda)
    rows = torch.arange(b, device=cuda) % 3
    T, pts, ok, packed = (x[rows].contiguous() for x in (T, pts, ok, packed))
    before = gn_step.LAUNCHES["gn_system"]
    got = gn_step.gn_system(T, pts, ok, packed, intr, cfg)
    again = gn_step.gn_system(T, pts, ok, packed, intr, cfg)
    torch.cuda.synchronize()
    assert gn_step.LAUNCHES["gn_system"] == before + 2
    for x, y in zip((got[0], got[1], *got[2]), (again[0], again[1], *again[2])):
        assert torch.equal(x, y)
    _assert_systems_close(got, gn_step.gn_system_reference(T, pts, ok, packed, intr, cfg), p)
    for i in range(min(b, 3)):
        one = gn_step.gn_system(T[i : i + 1], pts[i : i + 1], ok[i : i + 1], packed[i : i + 1], intr, cfg)
        for x, y in zip((one[0], one[1], *one[2]), (got[0], got[1], *got[2])):
            assert torch.equal(x[0], y[i])


def test_build_normal_equations_on_cuda_launches_gn_system(cuda):
    cfg = projective.ProjectiveIcpConfig()
    T, pts, ok, packed, intr = _gn_inputs((120, 160), 1000, cuda)
    level = pyramid.PyramidLevel(None, None, None, None, packed)
    before = dict(gn_step.LAUNCHES)
    H, b, aux = projective.build_normal_equations(T, pts.transpose(1, 2), ok, level, intr, cfg)
    assert gn_step.LAUNCHES == {**before, "gn_system": before["gn_system"] + 1}
    _assert_systems_close((H, b, aux), gn_step.gn_system_reference(T, pts, ok, packed, intr, cfg), 1000)


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


def test_rgbd_tracker_on_cuda_matches_cpu(cuda):
    """Tracker(method="rgbd") on u8 color, 3 frames: the poses within 1e-4
    of the same code on the CPU; gn_system launches sum(iters) + 1 times
    per tracked frame and gn_round never."""
    from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig

    intr = _intr(120, 160)
    depths, colors, _ = synthetic.render_trajectory_rgbd(intr, 3, seed=2)
    cfg = RgbdIcpConfig(iters=(4, 4), samples=768)
    runs = []
    for device in ("cpu", cuda):
        tracker = Tracker(TrackerConfig(intrinsics=intr, method="rgbd", rgbd=cfg, device=str(device)))
        before = dict(gn_step.LAUNCHES)
        res = [tracker.process(d, color=(c.numpy() * 255).astype(np.uint8)) for d, c in zip(depths, colors)]
        assert all(r.success for r in res)
        if device == cuda:
            want = {**before, "gn_system": before["gn_system"] + (sum(cfg.iters) + 1) * (len(res) - 1)}
            assert gn_step.LAUNCHES == want
        runs.append(np.stack([r.pose for r in res]))
    np.testing.assert_allclose(runs[1], runs[0], atol=1e-4)


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


@pytest.mark.parametrize("method", ["model", "icp", "gicp"])
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



# --- pairwise registration at 8192 points -------------------------------------------

N_FULL = 8192


def _quantized_cloud(seed, n=N_FULL):
    """Coordinates on a 2^-10 grid in [-1, 1): products and sums of three
    are exact in f32, so every squared distance is too, on every device."""
    return (np.random.RandomState(seed).randint(-1024, 1024, (n, 3)) / 1024.0).astype(np.float32)


def _on(device, pts, mask=None):
    from realsensetracker_tpu_torch.ops.cloud import Cloud

    m = np.ones(len(pts), bool) if mask is None else mask
    return Cloud(torch.from_numpy(pts).to(device), torch.from_numpy(m).to(device))


def test_knn_on_cuda_matches_cpu(cuda):
    from realsensetracker_tpu_torch.ops import correspond

    pts = _quantized_cloud(0)
    mask = np.random.RandomState(1).rand(N_FULL) > 0.05
    runs = []
    for device in ("cpu", cuda):
        c = _on(device, pts, mask)
        runs.append([x.cpu() for x in (*correspond.knn(c.points, c, 65), *correspond.knn_self(c, 32))])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_gicp", [False, True])
def test_covariances_on_cuda_match_cpu(cuda, use_gicp):
    from realsensetracker_tpu_torch.align import gicp

    pts = _quantized_cloud(2)
    got, ref = (gicp.compute_covariances(_on(d, pts), 32, use_gicp).cpu() for d in (cuda, "cpu"))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 if use_gicp else 1e-6)


def test_fpfh_on_cuda_matches_cpu(cuda):
    """Normals (faced to the viewpoint) to 1e-4 (cuSOLVER's Jacobi eigh
    against LAPACK's; 1.3e-5 seen where two small eigenvalues nearly
    meet). From the CPU's normals: SPFH rows exact but for at most 0.5%
    (switch near ties), FPFH rows within 1e-4 for at least 90% of the
    points (each flipped SPFH row spreads to the up to 64 rows whose
    neighbourhood holds it; 93.9% on an H100 80GB HBM3 at 700 W). The
    whole pipeline, each device with its own normals: the flag equal, half
    the rows within 1e-4, and every segment still of unit sum."""
    from realsensetracker_tpu_torch.ops import fpfh, normals

    pts = (0.5 * np.random.RandomState(3).randn(N_FULL, 3)).astype(np.float32)
    view = torch.tensor([0.0, 0.0, -3.0])
    n_cpu = normals.orient_normals(torch.from_numpy(pts), normals.knn_pca_normals(_on("cpu", pts), 16), view)
    c = _on(cuda, pts)
    n_gpu = normals.orient_normals(c.points, normals.knn_pca_normals(c, 16), view.to(cuda))
    torch.testing.assert_close(n_gpu.cpu(), n_cpu, rtol=0, atol=1e-4)
    spfh = [fpfh.compute_spfh(_on(d, pts), n_cpu.to(d), 0.3, 64)[0].cpu() for d in (cuda, "cpu")]
    assert ((spfh[0] - spfh[1]).abs().amax(1) > 1e-6).float().mean().item() <= 5e-3
    same = [fpfh.compute_fpfh_from_normals(_on(d, pts), n_cpu.to(d), 0.3, 64).cpu() for d in (cuda, "cpu")]
    assert ((same[0] - same[1]).abs().amax(1) <= 1e-4).float().mean().item() >= 0.9
    feats = [fpfh.compute_fpfh_checked(_on(d, pts), view.to(d), 16, 0.3, 64) for d in (cuda, "cpu")]
    assert bool(feats[0][1]) == bool(feats[1][1])
    assert ((feats[0][0].cpu() - feats[1][0]).abs().amax(1) <= 1e-4).float().mean().item() >= 0.5
    seg = feats[0][0].cpu().reshape(-1, 3, 11).sum(-1)
    assert bool((((seg - 1).abs() < 1e-4) | (seg < 1e-6)).all())


def _twist_gap(a, b):
    return se3.log(se3.compose(se3.inverse(b.cpu()), a.cpu())).abs().max().item()


def test_gicp_on_cuda_matches_cpu(cuda):
    """GicpConfig defaults (16 x 8, cov_k 32) on a 1 mm-noisy moved copy."""
    from realsensetracker_tpu_torch.align import gicp

    pts = (0.8 * np.random.RandomState(4).randn(N_FULL, 3)).astype(np.float32)
    T = se3.exp(torch.tensor([0.03, -0.02, 0.02, 0.02, 0.01, -0.03]))
    dst = (se3.transform_points(T, torch.from_numpy(pts)).numpy()
           + 1e-3 * np.random.RandomState(5).randn(N_FULL, 3)).astype(np.float32)
    got, ref = (gicp.align_gicp(_on(d, pts), _on(d, dst)) for d in (cuda, "cpu"))
    assert _twist_gap(got.transform, ref.transform) < 1e-4
    assert _twist_gap(got.transform, T) < 1e-3
    torch.testing.assert_close(got.cost.cpu(), ref.cost, rtol=1e-3, atol=0)


def _planted_graph(seed, n=N_FULL, p=0.002, clique=300):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, n) < p
    adj = a | a.T
    members = rng.choice(n, clique, replace=False)
    adj[np.ix_(members, members)] = True
    return adj, rng.rand(n) < 0.95, members


def test_max_kcore_on_cuda_matches_cpu(cuda):
    from realsensetracker_tpu_torch.align import robust_global

    adj, keep, members = _planted_graph(6)
    got, ref = (robust_global.max_kcore(torch.from_numpy(adj).to(d), torch.from_numpy(keep).to(d)).cpu()
                for d in (cuda, "cpu"))
    assert torch.equal(got, ref)
    assert set(np.nonzero(ref.numpy())[0]) == set(members[keep[members]])


def test_register_robust_on_cuda_matches_cpu(cuda):
    """Matched descriptors up to noise, 30% gross outliers, a large motion."""
    from realsensetracker_tpu_torch.align import robust_global

    rng = np.random.RandomState(7)
    src = rng.randn(N_FULL, 3).astype(np.float32)
    T = se3.exp(torch.tensor([0.3, 0.2, -0.4, 0.9, -0.6, 0.4]))
    dst = se3.transform_points(T, torch.from_numpy(src)).numpy()
    bad = rng.choice(N_FULL, N_FULL * 3 // 10, replace=False)
    dst[bad] = 3 * rng.randn(len(bad), 3)
    sf = rng.randn(N_FULL, 33).astype(np.float32)
    df = (sf + 0.01 * rng.randn(N_FULL, 33)).astype(np.float32)
    runs = [robust_global.register_robust(_on(d, src), _on(d, dst.astype(np.float32)), torch.from_numpy(sf).to(d),
                                          torch.from_numpy(df).to(d), 0.1) for d in (cuda, "cpu")]
    got, ref = runs
    assert bool(got.valid) and bool(ref.valid)
    assert _twist_gap(got.transform, ref.transform) < 1e-4 and _twist_gap(got.transform, T) < 5e-2
    assert int(got.num_correspondences) == int(ref.num_correspondences)
    assert int(got.num_inliers) == int(ref.num_inliers)


@pytest.mark.parametrize("name", ["projective-icp", "keyframe", "gnc-icp", "gicp", "fpfh-kabsch-icp",
                                  "robust-global"])
def test_pipelines_run_on_the_card_by_default(cuda, name):
    """No device argument: the card. The depth pipelines (a 160x120 pair)
    launch the CUDA kernels; the cloud pipelines take a 2048-point Gaussian
    cloud and its copy moved by the same twist (FPFH tells its points
    apart, which it cannot on the synthetic scene's planes and spheres).
    Every pipeline agrees with its CPU run within 1e-3."""
    import warnings

    from realsensetracker_tpu_torch.models import get_pipeline
    from realsensetracker_tpu_torch.ops.cloud import Cloud

    intr = _intr(120, 160)
    twist = torch.tensor([0.02, -0.01, 0.015, 0.01, -0.015, 0.01])
    if name in ("projective-icp", "keyframe"):
        d0, d1, _ = synthetic.render_pair(intr, twist, synthetic.default_scene(seed=1))
        inputs = {d: (d1.to(d), d0.to(d)) for d in (cuda, "cpu")}
        kw = {"intr": intr}
    else:
        pts = 0.8 * torch.randn((2048, 3), generator=torch.Generator().manual_seed(8))
        moved = se3.transform_points(se3.exp(twist), pts)
        mask = torch.ones(2048, dtype=torch.bool)
        inputs = {d: (Cloud(pts.to(d), mask.to(d)), Cloud(moved.to(d), mask.to(d))) for d in (cuda, "cpu")}
        kw = {}
    before = level_kernel.LAUNCHES
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = get_pipeline(name, **kw)(*inputs[cuda])
        ref = get_pipeline(name, device="cpu", **kw)(*inputs["cpu"])
    torch.cuda.synchronize()
    assert got.transform.is_cuda
    assert (level_kernel.LAUNCHES > before) == (name in ("projective-icp", "keyframe"))
    assert _twist_gap(got.transform, ref.transform) < 1e-3
    assert _twist_gap(got.transform, se3.exp(twist)) < 5e-3


# --- the backbone preconditioner and pose-graph optimization ------------------


def _backbone_blocks(n, seed=0):
    """The backbone blocks of a random chain: each chain edge's 6x12
    Jacobian adds J_i^T J_i and J_j^T J_j to its nodes' diagonal blocks and
    J_i^T J_j above them, + I (a well-conditioned system), node 0 an
    identity block."""
    g = torch.Generator().manual_seed(seed)
    J = torch.randn((n - 1, 6, 12), generator=g)
    Ji, Jj = J[:, :, :6], J[:, :, 6:]
    D = torch.zeros((n, 6, 6)) + torch.eye(6)
    D[:-1] += Ji.transpose(1, 2) @ Ji
    D[1:] += Jj.transpose(1, 2) @ Jj
    D[0] = torch.eye(6)
    O = Ji.transpose(1, 2) @ Jj
    O[0] = 0.0
    return D.contiguous(), O.contiguous(), torch.randn(6 * n, generator=g)


def _rel(got, ref):
    """max |got - ref| over max |ref| (0 when both are all zero)."""
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300)).item()


@pytest.mark.parametrize("n", [2, 3, 8, 64, 127, 1000, 1001, 5000])
def test_backbone_kernel_matches_reference(cuda, n):
    """Factor and apply against their plain versions on the same card
    tensors, at n of one and several levels, odd n, and past the 4096 nodes
    the apply keeps in shared memory: S_inv, U and z within 1e-10 of their
    largest entry (the kernel does the plain version's operations in its
    order, so bit for bit is expected); the launch counts."""
    D, O, r = (t.to(cuda) for t in _backbone_blocks(n))
    before = dict(backbone.LAUNCHES)
    S_inv, U = backbone.backbone_factor(D, O)
    z = backbone.backbone_apply(S_inv, U, r)
    S_ref, U_ref = backbone.backbone_factor_reference(D, O)
    z_ref = backbone.backbone_apply_reference(S_ref, U_ref, r)
    z_mixed = backbone.backbone_apply(S_ref.contiguous(), U_ref.contiguous(), r)
    torch.cuda.synchronize()
    assert backbone.LAUNCHES == {"backbone_factor": before["backbone_factor"] + 1,
                                 "backbone_apply": before["backbone_apply"] + 2}
    assert _rel(S_inv, S_ref) <= 1e-10
    assert _rel(U, U_ref) <= 1e-10
    assert _rel(z, z_ref) <= 1e-10
    assert _rel(z_mixed, z_ref) <= 1e-10  # the apply alone, on the same factors
    # M z = r: the factor solves the block-tridiagonal system.
    if n <= 1001:
        M = torch.zeros((6 * n, 6 * n), dtype=torch.float64, device=cuda)
        for i in range(n):
            M[6 * i : 6 * i + 6, 6 * i : 6 * i + 6] = D[i]
            if i + 1 < n:
                M[6 * i : 6 * i + 6, 6 * i + 6 : 6 * i + 12] = O[i]
                M[6 * i + 6 : 6 * i + 12, 6 * i : 6 * i + 6] = O[i].T
        M = M + 1e-10 * torch.eye(6 * n, dtype=torch.float64, device=cuda)
        resid = (M @ z.double() - r.double()).abs().max() / r.abs().max()
        assert resid.item() < 1e-5


def test_backbone_kernel_non_finite_guard(cuda):
    """A singular block (D_k = -1e-10 I and no coupling on either side, so
    A_k = 0 at every level until the reduction inverts it) leaves
    non-finite factors, in the kernel on the same blocks as in the plain
    version, and the apply then returns r itself, as CG's guard does; a
    NaN in D or in r does the same."""
    n, k = 64, 17
    D, O, r = (t.to(cuda) for t in _backbone_blocks(n, seed=1))
    D[k] = -backbone.DIAG * torch.eye(6, device=cuda)
    O[k - 1] = 0.0
    O[k] = 0.0
    def bad(S):  # blocks with a non-finite entry
        return (~torch.isfinite(S)).flatten(1).any(-1)

    S_inv, U = backbone.backbone_factor(D, O)
    S_ref, U_ref = backbone.backbone_factor_reference(D, O)
    assert torch.equal(bad(S_inv), bad(S_ref)) and bad(S_inv)[k]
    assert torch.equal(bad(U), bad(U_ref))
    assert torch.equal(backbone.backbone_apply(S_inv, U, r), r)
    assert torch.equal(backbone.backbone_apply_reference(S_ref, U_ref, r), r)
    D_nan = _backbone_blocks(n)[0].to(cuda)
    D_nan[k, 2, 3] = float("nan")
    S_nan, U_nan = backbone.backbone_factor(D_nan, O)
    assert torch.equal(bad(S_nan), bad(backbone.backbone_factor_reference(D_nan, O)[0]))
    assert torch.equal(bad(S_nan).cpu(), bad(backbone.backbone_factor_reference(D_nan.cpu(), O.cpu())[0]))
    assert torch.equal(backbone.backbone_apply(S_nan, U_nan, r), r)
    good_S, good_U = backbone.backbone_factor(*(t.to(cuda) for t in _backbone_blocks(n)[:2]))
    r_nan = r.clone()
    r_nan[5] = float("nan")
    assert torch.equal(backbone.backbone_apply(good_S, good_U, r_nan).isnan(), r_nan.isnan())


def test_backbone_kernel_left_singular_block(cuda):
    """A block singular only from the left (D_k = -1e-10 I, O_{k-1} = 0,
    O_k kept): M is indefinite and JAX's LDL^T returns r
    (tests/test_torch_pose_graph.py::
    test_backbone_left_singular_block_diverges_from_jax); the reduction
    solves it to a finite z, the kernel bit for bit as its plain version."""
    n, k = 64, 17
    D, O, r = (t.to(cuda) for t in _backbone_blocks(n, seed=1))
    D[k] = -backbone.DIAG * torch.eye(6, device=cuda)
    O[k - 1] = 0.0
    S_inv, U = backbone.backbone_factor(D, O)
    S_ref, U_ref = backbone.backbone_factor_reference(D, O)
    z = backbone.backbone_apply(S_inv, U, r)
    z_ref = backbone.backbone_apply_reference(S_ref, U_ref, r)
    assert torch.equal(S_inv, S_ref) and torch.equal(U, U_ref) and torch.equal(z, z_ref)
    assert torch.isfinite(z).all() and not torch.equal(z, r)


def test_optimize_pose_graph_on_cuda_matches_cpu(cuda):
    """A 64-node graph (two laps of 32, a loop edge every 4 nodes): three GN
    iterations of 60 backbone-preconditioned CG steps (the cost falls to
    its floor), the card within 1e-4 of the CPU; each GN iteration
    factors once and applies cg_iters + 1 times."""
    from realsensetracker_tpu_torch.optimize import pose_graph as pg

    gt, est, loops = synthetic.lap_graph(2, 32, seed=3, loop_every=4)
    out = {}
    for dev in ("cpu", cuda):
        before = dict(backbone.LAUNCHES)
        graph = pg.from_trajectory(est, loop_edges=loops, device=dev)
        poses, cost = pg.optimize_pose_graph(graph, gn_iters=3, cg_iters=60)
        out[str(dev)] = (poses.cpu(), float(cost))
        if dev != "cpu":
            assert backbone.LAUNCHES == {"backbone_factor": before["backbone_factor"] + 3,
                                         "backbone_apply": before["backbone_apply"] + 3 * 61}
    (p_cpu, c_cpu), (p_gpu, c_gpu) = out["cpu"], out[str(cuda)]
    assert (p_gpu - p_cpu).abs().max().item() < 1e-4
    assert abs(c_gpu / c_cpu - 1) < 1e-4
    err_before = np.abs(est[:, :3, 3] - gt[:, :3, 3]).max()
    assert np.abs(p_gpu.numpy()[:, :3, 3] - gt[:, :3, 3]).max() < 0.5 * err_before


# ---- dense mapping: the TSDF integrate and raycast kernels -------------------


def _tsdf_setup(v, device, n=4, color=False, slab=0):
    """(cfg, intr, depths (n, 120, 160), colors or None, poses) of a small
    walk through the default scene, for a V^3 volume over it."""
    cfg = tsdf_mod.sized_config(resolution=v, voxel_size=4.8 / v)._replace(integrate_slab=slab)
    if slab:
        cfg = cfg._replace(max_depth=2.0)  # the update support then fits the 3V/4 window
    intr = _intr(120, 160)
    sc = synthetic.default_scene(seed=3, device=device)
    poses = synthetic.poses_from_twists(0.02 * torch.randn((n - 1, 6), generator=torch.Generator().manual_seed(4))
                                        ).to(device)
    frames = [synthetic.render_rgbd(intr, T, sc) for T in poses]
    depths = torch.stack([d for d, _ in frames])
    colors = torch.stack([c for _, c in frames]).contiguous() if color else None
    return cfg, intr, depths, colors, poses


def _fuse_both(cfg, intr, depths, colors, poses, device):
    """The same frames fused by the kernel and by the plain version."""
    vk = tsdf_mod.init_volume(cfg, with_color=colors is not None, device=device)
    vp = tsdf_mod.clone_volume(vk)
    fits_seen = 0
    for i in range(depths.shape[0]):
        c = None if colors is None else colors[i]
        pcw = se3.inverse(poses[i])
        start = fits = None
        if 0 < cfg.integrate_slab < cfg.resolution:
            start, fits = tsdf_mod.slab_window(depths[i], poses[i], intr, cfg)
            fits_seen += int(fits)
        before = tsdf_kernels.LAUNCHES["tsdf_integrate"]
        tsdf_kernels.fuse_block(vk, depths[i], c, pcw, intr, cfg, start=start, fits=fits)
        assert tsdf_kernels.LAUNCHES["tsdf_integrate"] == before + 1
        tsdf_kernels.fuse_block_reference(vp, depths[i], c, pcw, intr, cfg, start=start, fits=fits)
    assert fits_seen > 0 or not 0 < cfg.integrate_slab < cfg.resolution  # the window engaged
    return vk, vp


@pytest.mark.parametrize("mode", ["full", "slab", "color"])
@pytest.mark.parametrize("v", [48, 128])
def test_tsdf_integrate_kernel_matches_reference(cuda, v, mode):
    cfg, intr, depths, colors, poses = _tsdf_setup(v, cuda, color=mode == "color",
                                                   slab=3 * v // 4 if mode == "slab" else 0)
    vk, vp = _fuse_both(cfg, intr, depths, colors, poses, cuda)
    torch.cuda.synchronize()
    assert torch.equal(vk.weight > 0, vp.weight > 0)
    assert int((vk.weight > 0).sum()) > 200
    for a, b in zip(vk, vp):
        if a is not None:
            assert (a - b).abs().max().item() <= 1e-6


@pytest.mark.parametrize("v", [48, 128])
def test_tsdf_integrate_closed_gate_leaves_the_volume(cuda, v):
    cfg, intr, depths, colors, poses = _tsdf_setup(v, cuda, color=True)
    vol, _ = _fuse_both(cfg, intr, depths[:2], colors[:2], poses[:2], cuda)
    before = tsdf_mod.clone_volume(vol)
    shut = torch.zeros((), dtype=torch.bool, device=cuda)
    tsdf_mod.integrate(vol, depths[2], poses[2], intr, cfg, color=colors[2], gate=shut)
    torch.cuda.synchronize()
    for a, b in zip(vol, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("coarse", [1, 4])
@pytest.mark.parametrize("v", [48, 128])
def test_tsdf_raycast_kernel_matches_reference(cuda, v, coarse):
    cfg, intr, depths, _, poses = _tsdf_setup(v, cuda)
    vol, _ = _fuse_both(cfg, intr, depths, None, poses, cuda)
    field = tsdf_mod.march_field(vol)
    T = poses[-1]
    if coarse == 1:
        args = (field, T, intr, cfg, cfg.num_steps)
        kw = dict(subvoxel_iters=cfg.subvoxel_iters)
        got, ref = tsdf_kernels.march(*args, **kw), tsdf_kernels.march_reference(*args, **kw)
    else:
        ci = tsdf_mod.coarse_intrinsics(intr, coarse)
        dc, dc_ref = (fn(field, T, ci, cfg, cfg.num_steps) for fn in (tsdf_kernels.march, tsdf_kernels.march_reference))
        assert torch.equal(dc > 0, dc_ref > 0)
        z0, seeded = tsdf_mod.coarse_seeds(dc_ref, coarse, cfg)
        kw = dict(z_start=z0, gate=seeded, subvoxel_iters=cfg.subvoxel_iters)
        got = tsdf_kernels.march(field, T, intr, cfg, cfg.refine_steps, **kw)
        ref = tsdf_kernels.march_reference(field, T, intr, cfg, cfg.refine_steps, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got > 0, ref > 0)
    assert int((got > 0).sum()) > 0.3 * got.numel()
    hit = got > 0
    assert (got[hit] - ref[hit]).abs().max().item() <= 1e-5


def _planes(v, device, kind):
    """(cfg, 240x320 intrinsics, a volume, the pose to render from) for the
    raycast bit-identity tests: ``fused`` the default scene's 240x320
    frames from _tsdf_setup's poses fused into V^3 (a 4.8 m cube);
    ``adversarial`` that volume with, by seeded masks, 5% of voxels at
    weight 0 under tsdf in [-3, 3], 5% of observed tsdf tripled (beyond
    [-1, 1]), 2% at -0.0, 1% NaN tsdf and 1% NaN weight; ``slot`` slot 1
    of a (3, V, V, V) stream volume (a view) holding it, the other slots
    other states."""
    cfg, _, _, _, poses = _tsdf_setup(v, device)
    intr = _intr(240, 320)
    sc = synthetic.default_scene(seed=3, device=device)
    vol = tsdf_mod.init_volume(cfg, device=device)
    for T in poses:
        tsdf_mod.integrate(vol, synthetic.render_depth(intr, T, sc), T, intr, cfg)
    if kind == "adversarial":
        g = torch.Generator(device=device).manual_seed(v)
        pick = lambda share: torch.rand(vol.tsdf.shape, generator=g, device=device) < share  # noqa: E731
        unseen, beyond, neg0, nan_t, nan_w = pick(0.05), pick(0.05), pick(0.02), pick(0.01), pick(0.01)
        tsdf = torch.where(unseen, 6.0 * torch.rand(vol.tsdf.shape, generator=g, device=device) - 3.0, vol.tsdf)
        tsdf = torch.where(beyond & (vol.weight > 0), 3.0 * tsdf, tsdf)
        tsdf = torch.where(neg0, -0.0, tsdf)
        tsdf = torch.where(nan_t, float("nan"), tsdf)
        weight = torch.where(unseen, 0.0, vol.weight)
        weight = torch.where(nan_w, float("nan"), weight)
        vol = tsdf_mod.TsdfVolume(tsdf.contiguous(), weight.contiguous())
    elif kind == "slot":
        stream = tsdf_mod.TsdfVolume(torch.stack([-vol.tsdf, vol.tsdf, vol.tsdf.flip(2)]),
                                     torch.stack([vol.weight.flip(0), vol.weight, vol.weight]))
        vol = tsdf_mod.TsdfVolume(stream.tsdf[1], stream.weight[1])
        assert vol.tsdf.is_contiguous() and vol.tsdf.data_ptr() != stream.tsdf.data_ptr()
    return cfg, intr, vol, poses[-1]


def _march_case(case, source, field, T, intr, cfg):
    """(n_steps, keywords) of one case of the raycast bit-identity tests:
    the full march, both phases of coarse-to-fine (coarse 4; the coarse
    phase marched from ``source`` and held here bit for bit to
    march_reference on ``field``), a per-ray z_start (numpy seed 9) with
    the refine budget, a random gate (the rays it closes are not marched),
    no steps."""
    rng = np.random.RandomState(9)
    full = tsdf_kernels.march_reference(field, T, intr, cfg, cfg.num_steps)
    z0 = torch.from_numpy(rng.uniform(0.0, 0.3, full.shape).astype(np.float32)).to(full.device)
    z0 = torch.where(full > 0, full - z0, float(cfg.min_depth)).contiguous()
    gate = torch.from_numpy(rng.rand(*full.shape) < 0.5).to(full.device)
    kw = dict(subvoxel_iters=cfg.subvoxel_iters)
    if case == "coarse_to_fine":
        ci = tsdf_mod.coarse_intrinsics(intr, 4)
        dc = tsdf_kernels.march(source, T, ci, cfg, cfg.num_steps)
        assert torch.equal(dc, tsdf_kernels.march_reference(field, T, ci, cfg, cfg.num_steps))
        z_c, seeded = tsdf_mod.coarse_seeds(dc, 4, cfg)
        return cfg.refine_steps, dict(kw, z_start=z_c, gate=seeded)
    if case == "z_start":
        return cfg.refine_steps, dict(kw, z_start=z0)
    if case == "gate":
        return cfg.num_steps, dict(kw, gate=gate)
    return (0 if case == "no_steps" else cfg.num_steps), kw


@pytest.mark.parametrize("case", ["full", "coarse_to_fine", "z_start", "gate", "no_steps"])
@pytest.mark.parametrize("v", [128, 512])
def test_tsdf_raycast_kernel_bit_identical(cuda, v, case):
    """The march against march_reference, bit for bit, at 240x320 into
    128^3 and 512^3 (4.8 m cubes): the full march, both phases of
    coarse-to-fine (coarse 4), a per-ray z_start (numpy seed 9) with the
    refine budget, a random gate (the rays it closes are not marched), and
    no steps (all zeros)."""
    cfg, intr, vol, T = _planes(v, cuda, "fused")
    field = tsdf_mod.march_field(vol)
    n_steps, kw = _march_case(case, field, field, T, intr, cfg)
    before = tsdf_kernels.LAUNCHES["tsdf_raycast"]
    got = tsdf_kernels.march(field, T, intr, cfg, n_steps, **kw)
    ref = tsdf_kernels.march_reference(field, T, intr, cfg, n_steps, **kw)
    torch.cuda.synchronize()
    assert tsdf_kernels.LAUNCHES["tsdf_raycast"] == before + 1
    assert torch.equal(got, ref)
    share = (got > 0).float().mean().item()
    assert share == 0.0 if case == "no_steps" else share > (0.15 if case == "gate" else 0.3)


@pytest.mark.parametrize("kind", ["fused", "adversarial", "slot"])
@pytest.mark.parametrize("case", ["full", "coarse_to_fine", "z_start", "gate", "no_steps"])
@pytest.mark.parametrize("v", [128, 512])
def test_tsdf_raycast_planes_bit_identical(cuda, v, case, kind):
    """The march of a volume's tsdf and weight planes (no march field built)
    against march_reference on march_field(vol), and against the kernel's
    march of that field, bit for bit, in the cases of
    test_tsdf_raycast_kernel_bit_identical, on fused, adversarial and slot
    planes (_planes). Each plane march counts once in
    LAUNCHES["tsdf_raycast_planes"] and once in LAUNCHES["tsdf_raycast"]."""
    cfg, intr, vol, T = _planes(v, cuda, kind)
    field = tsdf_mod.march_field(vol)
    n_steps, kw = _march_case(case, vol, field, T, intr, cfg)
    before = dict(tsdf_kernels.LAUNCHES)
    got = tsdf_kernels.march(vol, T, intr, cfg, n_steps, **kw)
    assert tsdf_kernels.LAUNCHES == {**before, "tsdf_raycast": before["tsdf_raycast"] + 1,
                                     "tsdf_raycast_planes": before["tsdf_raycast_planes"] + 1}
    ref = tsdf_kernels.march_reference(field, T, intr, cfg, n_steps, **kw)
    by_field = tsdf_kernels.march(field, T, intr, cfg, n_steps, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got, by_field)
    share = (got > 0).float().mean().item()
    assert share == 0.0 if case == "no_steps" else share > (0.1 if case == "gate" else 0.2)


def _device_kernels(fn):
    """(fn(), the sorted names of the device operations it ran)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sorted(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.parametrize("coarse", [1, 4])
def test_tsdf_render_of_a_whole_volume_builds_no_field(cuda, coarse):
    """render_model_depth on a whole 512^3 volume on the card marches its
    planes: two plane marches (one without coarse-to-fine), and no device
    operation besides them but coarse_seeds' own; the render's memory grows
    by far less than one V^3 plane (the field and its two temporaries were
    9 bytes a voxel); the depth equals the march of the field."""
    v = 512
    cfg, intr, vol, T = _planes(v, cuda, "fused")
    cfg = cfg._replace(raycast_coarse=coarse)
    tsdf_mod.render_model_depth(vol, T, intr, cfg)  # warm: the kernel's build, the profiler's start
    before = dict(tsdf_kernels.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    depth, names = _device_kernels(lambda: tsdf_mod.render_model_depth(vol, T, intr, cfg))
    grew = torch.cuda.max_memory_allocated() - base
    marches = 2 if coarse > 1 else 1
    assert {k: tsdf_kernels.LAUNCHES[k] - before[k] for k in before} == {
        "tsdf_depth_tiles": 0, "tsdf_cull": 0, "tsdf_integrate": 0, "tsdf_raycast": marches,
        "tsdf_raycast_planes": marches}
    assert grew < v ** 3, grew
    assert sum("raycast_kernel" in n for n in names) == marches
    others = [n for n in names if "raycast_kernel" not in n]
    field = tsdf_mod.march_field(vol)
    if coarse > 1:
        dc = tsdf_kernels.march(field, T, tsdf_mod.coarse_intrinsics(intr, coarse), cfg, cfg.num_steps)
        _, seeds = _device_kernels(lambda: tsdf_mod.coarse_seeds(dc, coarse, cfg))
        assert others == seeds and len(seeds) > 0
        z_c, seeded = tsdf_mod.coarse_seeds(dc, coarse, cfg)
        want = tsdf_kernels.march(field, T, intr, cfg, cfg.refine_steps, z_start=z_c, gate=seeded,
                                  subvoxel_iters=cfg.subvoxel_iters)
    else:
        assert others == []
        want = tsdf_kernels.march(field, T, intr, cfg, cfg.num_steps, subvoxel_iters=cfg.subvoxel_iters)
    torch.cuda.synchronize()
    assert torch.equal(depth, want) and (depth > 0).float().mean().item() > 0.2


def _fuse_checked(vk, vp, depth, color, pose_wc, intr, cfg, gate=None, start=None, fits=None, x0=0):
    """One frame through the kernel (vk) and its plain version (vp); the
    cull launched alone on the same frame (depth_tiles, cull_bricks) lists
    the plain twin's bricks, and those hold every brick whose voxels the
    update predicate takes (on a copy with zero weights). Returns the
    twin's (nbx, nby, nbz) mask."""
    nx = vk.tsdf.shape[0]
    h, w = depth.shape
    pcw = se3.inverse(pose_wc).contiguous()
    zero = tsdf_mod.TsdfVolume(*(None if a is None else (torch.zeros_like(a) if i % 2 else a.clone())
                                 for i, a in enumerate(vp)))
    tsdf_kernels.fuse_block(vk, depth, color, pcw, intr, cfg, gate=gate, start=start, fits=fits, x0=x0)
    tsdf_kernels.fuse_block_reference(vp, depth, color, pcw, intr, cfg, gate, start, fits, x0)
    tsdf_kernels.fuse_block_reference(zero, depth, color, pcw, intr, cfg, gate, start, fits, x0)
    one = lambda t: None if t is None else t[None]  # noqa: E731
    count = torch.empty((1,), dtype=torch.int32, device=depth.device)
    tiles = tsdf_kernels.depth_tiles(depth[None], cfg, count)
    kept = tsdf_kernels.cull_bricks(pcw[None], tiles, count, intr, cfg, h, w, x0, nx, one(gate), one(start),
                                    one(fits))[: int(count.item())]
    twin = tsdf_kernels.brick_mask_reference(pcw[None], intr, cfg, tsdf_kernels.depth_tiles_reference(depth[None], cfg),
                                             h, w, x0, nx, one(gate), one(start), one(fits))[0]
    assert torch.equal(torch.sort(kept).values, torch.nonzero(twin.reshape(-1))[:, 0])
    assert not bool((tsdf_kernels.bricks_holding(zero.weight > 0) & ~twin).any())
    return twin


def _bit_identical(vk, vp):
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(vk, vp) if a is not None)


@pytest.mark.parametrize("mode", ["full", "slab", "color", "x_slab"])
@pytest.mark.parametrize("v", [40, 48, 96, 128])
def test_tsdf_integrate_bit_identical(cuda, v, mode):
    """The brick integrate bit for bit equal to fuse_block_reference, full,
    slab window, colored and on an x-slab off the brick boundaries."""
    cfg, intr, depths, colors, poses = _tsdf_setup(v, cuda, color=mode == "color",
                                                   slab=3 * v // 4 if mode == "slab" else 0)
    x0, nx = (v // 3 + 1, v // 2 - 1) if mode == "x_slab" else (0, v)
    vk = tsdf_mod.TsdfVolume(*(None if a is None else a[x0 : x0 + nx].clone()
                               for a in tsdf_mod.init_volume(cfg, with_color=mode == "color", device=cuda)))
    vp = tsdf_mod.clone_volume(vk)
    for i in range(depths.shape[0]):
        start = fits = None
        if mode == "slab":
            start, fits = tsdf_mod.slab_window(depths[i], poses[i], intr, cfg)
        _fuse_checked(vk, vp, depths[i], None if colors is None else colors[i], poses[i], intr, cfg, None, start,
                      fits, x0)
    assert _bit_identical(vk, vp) and int((vk.weight > 0).sum()) > 100


@pytest.mark.parametrize("v", [40, 48, 96, 128])
def test_tsdf_integrate_adversarial_poses(cuda, v):
    """32 poses of chip_smoke.adversarial_poses (on brick corners and faces
    along the axes, grazing, outside looking in, tilted), the scene rendered
    at 160x120 with 5% NaN holes: bit-identical, the kept bricks the twin's
    and sound."""
    from chip_smoke import adversarial_poses

    cfg = tsdf_mod.sized_config(resolution=v, voxel_size=4.8 / v)
    intr = _intr(120, 160)
    sc = synthetic.default_scene(seed=3, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(v)
    vk = tsdf_mod.init_volume(cfg, device=cuda)
    vp = tsdf_mod.clone_volume(vk)
    for T in torch.from_numpy(adversarial_poses(cfg, 32, seed=v)).to(cuda):
        d = synthetic.render_depth(intr, T, sc)
        d = torch.where(torch.rand(d.shape, generator=g, device=cuda) < 0.05, float("nan"), d).contiguous()
        _fuse_checked(vk, vp, d, None, T, intr, cfg)
    assert _bit_identical(vk, vp) and int((vk.weight > 0).sum()) > 200


@pytest.mark.parametrize("case", ["nan", "zero", "beyond", "gate"])
@pytest.mark.parametrize("v", [48, 128])
def test_tsdf_integrate_without_valid_depth_or_gate(cuda, v, case):
    """A frame with no valid depth, or a closed gate, keeps no brick and
    leaves the volume bit-identical."""
    cfg, intr, depths, colors, poses = _tsdf_setup(v, cuda, color=True)
    vol, _ = _fuse_both(cfg, intr, depths[:2], colors[:2], poses[:2], cuda)
    d = {"nan": torch.full_like(depths[2], float("nan")), "zero": torch.zeros_like(depths[2]),
         "beyond": torch.full_like(depths[2], 2.0 * cfg.max_depth), "gate": depths[2]}[case]
    gate = torch.tensor(case != "gate", device=cuda)
    vk, vp = tsdf_mod.clone_volume(vol), tsdf_mod.clone_volume(vol)
    kept = _fuse_checked(vk, vp, d, colors[2], poses[2], intr, cfg, gate)
    assert not bool(kept.any()) and _bit_identical(vk, vol) and _bit_identical(vp, vol)


@pytest.mark.parametrize("mode", ["depth", "color", "slab"])
def test_tsdf_fuse_blocks_equals_single_launches(cuda, mode):
    """The slot entry: S = 4 slots with gates (1, 0, 1, 1), one launch of
    each kernel per step, bit-identical to a launch per slot."""
    s = 4
    cfg, intr, depths, colors, poses = _tsdf_setup(96, cuda, n=s + 2, color=mode == "color",
                                                   slab=72 if mode == "slab" else 0)
    slots = tsdf_mod.TsdfVolume(*(None if a is None else a.expand(s, *a.shape).clone()
                                  for a in tsdf_mod.init_volume(cfg, with_color=mode == "color", device=cuda)))
    single = tsdf_mod.clone_volume(slots)
    gates = torch.tensor([True, False, True, True], device=cuda)
    for f in range(3):
        d, P = depths[f : f + s].contiguous(), poses[f : f + s]
        pcw = torch.stack([se3.inverse(T) for T in P]).contiguous()
        c = None if colors is None else colors[f : f + s].contiguous()
        starts = fits = None
        if mode == "slab":
            windows = [tsdf_mod.slab_window(d[i], P[i], intr, cfg) for i in range(s)]
            starts, fits = torch.stack([a for a, _ in windows]), torch.stack([b for _, b in windows])
        before = dict(tsdf_kernels.LAUNCHES)
        tsdf_kernels.fuse_blocks(slots, d, c, pcw, intr, cfg, gates=gates, starts=starts, fits=fits)
        assert {k: tsdf_kernels.LAUNCHES[k] - before[k] for k in before} == {
            "tsdf_depth_tiles": 1, "tsdf_cull": 1, "tsdf_integrate": 1, "tsdf_raycast": 0, "tsdf_raycast_planes": 0}
        for i in range(s):
            tsdf_kernels.fuse_block(tsdf_mod.TsdfVolume(*(None if a is None else a[i] for a in single)), d[i],
                                    None if c is None else c[i], pcw[i], intr, cfg, gate=gates[i],
                                    start=None if starts is None else starts[i], fits=None if fits is None else fits[i])
    assert _bit_identical(slots, single)
    assert int((slots.weight[0] > 0).sum()) > 200 and not bool((slots.weight[1] > 0).any())


def test_tsdf_integrate_slots_equals_integrate_per_slot(cuda):
    """mapping/tsdf.integrate_slots (the dense serving slots' call) against
    integrate() on each slot's planes."""
    s = 3
    cfg, intr, depths, _, poses = _tsdf_setup(64, cuda, n=s)
    slots = tsdf_mod.TsdfVolume(torch.ones((s, 64, 64, 64), device=cuda), torch.zeros((s, 64, 64, 64), device=cuda))
    single = tsdf_mod.clone_volume(slots)
    gates = torch.tensor([True, True, False], device=cuda)
    tsdf_mod.integrate_slots(slots, depths, poses, intr, cfg, gates=gates)
    for i in range(s):
        tsdf_mod.integrate(tsdf_mod.TsdfVolume(single.tsdf[i], single.weight[i]), depths[i], poses[i], intr, cfg,
                           gate=gates[i])
    assert _bit_identical(slots, single)


def test_tsdf_tracker_on_cuda_matches_cpu(cuda):
    intr = _intr(120, 160)
    depths, _ = synthetic.render_trajectory(intr, 6, seed=2, step_scale=0.01)
    cfg = tsdf_mod.sized_config(resolution=64, voxel_size=0.08)
    poses = []
    for device in ("cpu", cuda):
        tracker = Tracker(TrackerConfig(intrinsics=intr, method="tsdf", tsdf=cfg, device=str(device)))
        before = dict(tsdf_kernels.LAUNCHES)
        res = [tracker.process(d) for d in depths]
        assert all(r.success for r in res)
        if device != "cpu":
            assert tsdf_kernels.LAUNCHES == {"tsdf_depth_tiles": before["tsdf_depth_tiles"] + 6,
                                             "tsdf_cull": before["tsdf_cull"] + 6,
                                             "tsdf_integrate": before["tsdf_integrate"] + 6,
                                             "tsdf_raycast": before["tsdf_raycast"] + 5,
                                             "tsdf_raycast_planes": before["tsdf_raycast_planes"] + 5}
        poses.append(np.stack([r.pose for r in res]))
    np.testing.assert_allclose(poses[1], poses[0], atol=1e-4)


# ---- multi-stream steps and the batching executor on the card ----------------


def _stream_frames(intr, s, n, device):
    """(n, s, H, W) f32 frames: s short walks through one scene each."""
    out = []
    for i in range(s):
        d, _ = synthetic.render_trajectory(intr, n, scene=synthetic.default_scene(seed=20 + i), seed=i,
                                           step_scale=0.01)
        out.append(d)
    return torch.stack(out, 1).to(device)


def test_masked_streams_on_cuda_match_cpu(cuda):
    """step_streams_masked at S = 4 (staggered seeding, an inactive slot)
    on the card within 1e-4 of the same code on the CPU, one gn_round
    launch per association round for all slots."""
    from realsensetracker_tpu_torch.parallel import streams

    intr, cfg = _intr(120, 160), projective.ProjectiveIcpConfig(iters=(3, 3, 3))
    frames = _stream_frames(intr, 4, 4, cuda)
    states = {d: streams.blank_streams(intr, cfg, num_streams=4, device=d) for d in ("cpu", cuda)}
    for r in range(4):
        active = torch.tensor([True, True, r >= 1, r != 2])
        seed = torch.tensor([r == 0, r == 0, r == 1, r == 0])
        rows = {}
        for d in ("cpu", cuda):
            before = gn_step.LAUNCHES["gn_round"]
            states[d], rows[d] = streams.step_streams_masked(states[d], frames[r].to(d), active.to(d), seed.to(d),
                                                             intr, cfg)
            if d != "cpu":
                assert gn_step.LAUNCHES["gn_round"] - before == sum(cfg.iters)
        np.testing.assert_allclose(rows[cuda].cpu().numpy(), rows["cpu"].numpy(), rtol=0, atol=1e-4)
        assert torch.equal(rows[cuda][:, 32].cpu(), rows["cpu"][:, 32])


def test_masked_streams_batch_invariant_on_cuda(cuda):
    """A slot's stats row does not depend on which other slots share its
    step: slot 0 advanced alone (others inactive) equals slot 0 advanced
    with all slots active, bit for bit."""
    from realsensetracker_tpu_torch.parallel import streams

    intr, cfg = _intr(120, 160), projective.ProjectiveIcpConfig(iters=(3, 3, 3))
    frames = _stream_frames(intr, 4, 3, cuda)
    on = torch.ones(4, dtype=torch.bool, device=cuda)
    only0 = torch.tensor([True, False, False, False], device=cuda)
    seed0 = torch.ones(4, dtype=torch.bool, device=cuda)
    a = streams.blank_streams(intr, cfg, num_streams=4, device=cuda)
    b = streams.blank_streams(intr, cfg, num_streams=4, device=cuda)
    a, _ = streams.step_streams_masked(a, frames[0], on, seed0, intr, cfg)
    b, _ = streams.step_streams_masked(b, frames[0], on, seed0, intr, cfg)
    for r in (1, 2):
        a, ra = streams.step_streams_masked(a, frames[r], on, ~seed0, intr, cfg)
        alone = torch.where(only0[:, None, None], frames[r], 0.0)
        b, rb = streams.step_streams_masked(b, alone, only0, ~seed0, intr, cfg)
        assert torch.equal(ra[0], rb[0])


def test_batched_executor_on_cuda_matches_cpu(cuda):
    """BatchedExecutor on the card, u16 frames at 1/5000 m, two sessions
    through masked rounds: within 1e-4 of the CPU executor."""
    from realsensetracker_tpu_torch.api.batching import BatchedExecutor, BatchingConfig

    intr = _intr(120, 160)
    frames = (_stream_frames(intr, 2, 4, "cpu").numpy() * 5000.0 + 0.5).astype(np.uint16)
    poses = {}
    for d in ("cpu", "cuda"):
        ex = BatchedExecutor(BatchingConfig(intrinsics=intr, capacity=4, depth_scale=2e-4, device=d,
                                            request_timeout_s=60.0))
        try:
            trackers = [ex.make_session_tracker() for _ in range(2)]
            poses[d] = np.stack([[trackers[i].process(frames[f, i]).pose for f in range(4)] for i in range(2)])
            assert ex.stats()["errors"] == 0
        finally:
            ex.close()
    np.testing.assert_allclose(poses["cuda"], poses["cpu"], rtol=0, atol=1e-4)


def test_frame_stream_orders_uploads_before_the_consumer(cuda):
    """64 u16 640x480 frames through FrameStream(prefetch=2) while the
    consumer's stream is held back by a long matmul before each read: every
    frame the consumer's kernels read equals its host copy. A missing
    record_stream would let a later upload reuse a frame's memory while the
    held-back consumer has yet to read it."""
    from realsensetracker_tpu_torch.data.stream import FrameStream

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 65536, (480, 640), dtype=np.uint16) for _ in range(64)]
    big = torch.randn(2048, 2048, device=cuda)
    copies, sums = [], []
    with FrameStream(((float(i), f) for i, f in enumerate(frames)), prefetch=2, device=cuda) as fs:
        for ts, d in fs:
            assert d.is_cuda and d.dtype == torch.uint16
            for _ in range(4):  # keep the consumer's stream busy
                big = (big @ big).clamp_(-1.0, 1.0)
            copies.append(d.to(torch.int32))
            sums.append(d.to(torch.float64).sum())
            del d
    torch.cuda.synchronize()
    assert len(copies) == 64
    for host, got, s in zip(frames, copies, sums):
        assert torch.equal(got.cpu(), torch.from_numpy(host.astype(np.int32)))
        assert s.item() == float(host.astype(np.float64).sum())


def test_frame_stream_counts_its_uploads(cuda):
    """stream.UPLOADS: one frame and one array per u16 frame, two arrays
    for a (depth, color) frame, none for a None entry or a tensor already
    on the card."""
    from realsensetracker_tpu_torch.data import stream

    depth = np.zeros((48, 64), np.uint16)
    color = np.zeros((48, 64, 3), np.uint8)
    on_card = torch.zeros((48, 64), device=cuda)
    source = [(0.0, depth), (1.0, depth), (2.0, (depth, color)), (3.0, (depth, None)), (4.0, on_card)]
    before = dict(stream.UPLOADS)
    with stream.FrameStream(iter(source), device=cuda) as fs:
        assert len(list(fs)) == 5
    assert {k: stream.UPLOADS[k] - before[k] for k in before} == {"frames": 5, "arrays": 5}


def test_frame_stream_consumer_waits_for_a_slow_upload(cuda):
    """The upload side held back instead: a spin kernel queued on the
    stream's side stream before each frame's copy, so the consumer is handed
    every frame while its upload is still queued, and reads it at once.
    Every read equals its host copy only if the consumer's stream waits on
    the upload's event."""
    from realsensetracker_tpu_torch.data.stream import FrameStream

    class SlowUploads(FrameStream):
        def _upload(self, frame):
            with torch.cuda.device(self.device), torch.cuda.stream(self._side):
                torch.cuda._sleep(20_000_000)  # ~10 ms of clock cycles
            return super()._upload(frame)

    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 65536, (480, 640), dtype=np.uint16) for _ in range(64)]
    copies = []
    with SlowUploads(((float(i), f) for i, f in enumerate(frames)), prefetch=2, device=cuda) as fs:
        for ts, d in fs:
            copies.append(d.to(torch.int32))
            del d
    torch.cuda.synchronize()
    assert len(copies) == 64
    for host, got in zip(frames, copies):
        assert torch.equal(got.cpu(), torch.from_numpy(host.astype(np.int32)))


def test_native_png_decoder_matches_numpy(cuda, tmp_path):
    """The native PNG16 decoder (single and batched) against the port's
    numpy decoder, bit for bit, on a written 640x480 sequence."""
    from realsensetracker_tpu_torch.data import tum
    from realsensetracker_tpu_torch.native import png_io

    root = tum.synthesize_tum_sequence(str(tmp_path / "seq"), num_frames=6, width=640, height=480)
    seq = tum.TumSequence.open(root)
    assert tum.png_backend() == ("native", "")
    paths = [f"{root}/{rel}" for _, rel in seq.depth_index]
    ref = np.stack([tum.read_png(p) for p in paths])
    np.testing.assert_array_equal(np.stack([png_io.read_png16(p) for p in paths]), ref)
    np.testing.assert_array_equal(png_io.read_png16_batch(paths, 480, 640), ref)


def test_rs_replay_on_cuda_matches_cpu(cuda, tmp_path):
    """rs_replay --method projective over raw u16 TUM frames streamed onto
    the card: poses within 1e-4 of the same replay on the CPU."""
    import contextlib
    import io
    import json

    from realsensetracker_tpu_torch.cli import rs_replay
    from realsensetracker_tpu_torch.data import tum

    root = tum.synthesize_tum_sequence(str(tmp_path / "seq"), num_frames=8, width=160, height=120)
    poses = {}
    for d in ("cpu", "cuda"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert rs_replay.main(["--tum", root, "--json", "--device", d]) == 0
        poses[d] = np.array([json.loads(ln)["pose"] for ln in out.getvalue().splitlines() if ln.startswith("{")])
    assert poses["cuda"].shape == (8, 16)
    np.testing.assert_allclose(poses["cuda"], poses["cpu"], rtol=0, atol=1e-4)


def _cli(main, argv):
    """main(argv) with its standard output captured: (rc, lines)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


def test_rs_benchmark_on_cuda_matches_cpu(cuda, monkeypatch):
    """rs_benchmark projective-icp at 80x60: one well-formed JSON line with
    the JAX CLI's keys, and the transforms of every call within 1e-4 of the
    same run on the CPU (register_batch wrapped to keep them)."""
    import json

    from realsensetracker_tpu_torch.cli import rs_benchmark

    argv = ["--batch", "4", "--iters", "2", "--width", "80", "--height", "60", "--samples", "256",
            "--level-iters", "2,2"]
    got = {}
    real = batched.register_batch
    for d in ("cpu", "cuda"):
        kept = []

        def keep(*a, **k):
            out = real(*a, **k)
            kept.append(out.transform.cpu())
            return out

        monkeypatch.setattr(batched, "register_batch", keep)
        rc, lines = _cli(rs_benchmark.main, argv + ["--device", d])
        assert rc == 0 and len(lines) == 1
        rec = json.loads(lines[0])
        assert list(rec) == ["pipeline", "batch", "resolution", "pairs_per_sec_per_chip", "ms_per_batch"]
        assert rec["pipeline"] == "projective-icp" and rec["resolution"] == "80x60" and rec["pairs_per_sec_per_chip"] > 0
        got[d] = torch.stack(kept)
    assert got["cuda"].shape == (3, 4, 4, 4)  # the warm-up and 2 timed calls
    torch.testing.assert_close(got["cuda"], got["cpu"], rtol=0, atol=1e-4)


def test_rs_streams_on_cuda_matches_cpu(cuda, monkeypatch):
    """rs_streams, 2 streams x 3 frames at 80x60: the printed lines well
    formed, every stream tracking, and the final poses within 1e-4 of the
    same run on the CPU (step_streams wrapped to keep the state)."""
    from realsensetracker_tpu_torch.cli import rs_streams
    from realsensetracker_tpu_torch.parallel import streams

    argv = ["--streams", "2", "--frames", "3", "--width", "80", "--height", "60"]
    poses = {}
    real = streams.step_streams
    for d in ("cpu", "cuda"):
        box = {}

        def keep(*a, **k):
            out = real(*a, **k)
            box["state"] = out[0]
            return out

        monkeypatch.setattr(streams, "step_streams", keep)
        rc, lines = _cli(rs_streams.main, argv + ["--device", d])
        assert rc == 0
        assert lines[0] == "rendering 2 x 3 synthetic frames ..."
        assert lines[1:3] == ["frame 1: 2/2 streams tracking", "frame 2: 2/2 streams tracking"]
        assert lines[3].startswith("2 streams x 2 steps in ") and "FPS/stream" in lines[3]
        assert lines[4] in ("config-5 target 30 FPS/stream: MET", "config-5 target 30 FPS/stream: NOT MET")
        poses[d] = box["state"].poses.cpu()
    torch.testing.assert_close(poses["cuda"], poses["cpu"], rtol=0, atol=1e-4)


# --- the multi-device layer: kernel extensions and world-size-1 NCCL ---------------


@pytest.mark.parametrize("p", [2048, 777, 16384])
@pytest.mark.parametrize("b", [1, 512])
def test_gn_system_with_an_association_pose_matches_reference(cuda, b, p):
    """gn_system(T, ..., T_assoc): the association at T_assoc, the reduction
    at T (the point-sharded inner step), against its plain version with
    gn_system's bars, bit-identical from launch to launch; T_assoc=None is
    the old entry, bit for bit the same as T_assoc=T."""
    cfg = projective.ProjectiveIcpConfig()
    T_assoc, pts, ok, packed, intr = _gn_inputs((240, 320), p, cuda)
    rows = torch.arange(b, device=cuda) % 3
    T_assoc, pts, ok, packed = (x[rows].contiguous() for x in (T_assoc, pts, ok, packed))
    step = se3.exp(torch.tensor([0.003, -0.002, 0.004, 0.002, -0.001, 0.002])).to(cuda)
    T = (step @ T_assoc).contiguous()
    before = gn_step.LAUNCHES["gn_system"]
    got = gn_step.gn_system(T, pts, ok, packed, intr, cfg, T_assoc=T_assoc)
    again = gn_step.gn_system(T, pts, ok, packed, intr, cfg, T_assoc=T_assoc)
    torch.cuda.synchronize()
    assert gn_step.LAUNCHES["gn_system"] == before + 2
    for x, y in zip((got[0], got[1], *got[2]), (again[0], again[1], *again[2])):
        assert torch.equal(x, y)
    _assert_systems_close(got, gn_step.gn_system_reference(T, pts, ok, packed, intr, cfg, T_assoc), p)
    old = gn_step.gn_system(T, pts, ok, packed, intr, cfg)
    same = gn_step.gn_system(T, pts, ok, packed, intr, cfg, T_assoc=T.clone())
    for x, y in zip((old[0], old[1], *old[2]), (same[0], same[1], *same[2])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["full", "color"])
@pytest.mark.parametrize("v", [48, 128])
def test_tsdf_integrate_x_slabs_match_the_whole_volume(cuda, v, mode):
    """Four x-slabs (V/4 planes each, from x0 = k V/4) fused by the kernel
    are bit-identical to the whole-volume kernel's planes, and the slab
    kernel to its plain version; x0 = 0, nx = V is the old entry."""
    cfg, intr, depths, colors, poses = _tsdf_setup(v, cuda, color=mode == "color")
    whole, _ = _fuse_both(cfg, intr, depths, colors, poses, cuda)
    n = v // 4
    for k in range(4):
        x0 = k * n
        vk = tsdf_mod.TsdfVolume(*(None if a is None else a[:n].clone() for a in tsdf_mod.init_volume(
            cfg, with_color=colors is not None, device=cuda)))
        vp = tsdf_mod.clone_volume(vk)
        for i in range(depths.shape[0]):
            c = None if colors is None else colors[i]
            pcw = se3.inverse(poses[i])
            before = tsdf_kernels.LAUNCHES["tsdf_integrate"]
            tsdf_kernels.fuse_block(vk, depths[i], c, pcw, intr, cfg, x0=x0)
            assert tsdf_kernels.LAUNCHES["tsdf_integrate"] == before + 1
            tsdf_kernels.fuse_block_reference(vp, depths[i], c, pcw, intr, cfg, x0=x0)
        torch.cuda.synchronize()
        for a, b, w in zip(vk, vp, whole):
            if a is not None:
                assert torch.equal(a, w[x0 : x0 + n])
                assert (a - b).abs().max().item() <= 1e-6


@pytest.fixture(scope="module")
def nccl_mesh():
    """A world-size-1 NCCL group in this process and its 1x1 mesh: every
    collective of the sharded paths runs, each the identity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL)")
    import torch.distributed as dist

    from realsensetracker_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    yield mesh
    dist.destroy_process_group()


def test_point_sharded_registration_on_one_nccl_rank(cuda, nccl_mesh):
    """register_batch_point_sharded at 640x480: gn_system with T_assoc once
    per inner step (no gn_round), within 1e-5 in twist of register_batch;
    register_batch_sharded equal to register_batch bit for bit."""
    from realsensetracker_tpu_torch.parallel import sharded

    intr, cfg = camera.TUM_FR1, projective.ProjectiveIcpConfig()
    sc = synthetic.default_scene(device=cuda)
    pairs = [synthetic.render_pair(intr, torch.tensor([0.01 * i, 0.004, -0.003, 0.006, 0.002, -0.004]), sc)
             for i in range(4)]
    src = torch.stack([p[1] for p in pairs])
    dst = torch.stack([p[0] for p in pairs])
    before = dict(gn_step.LAUNCHES)
    T, rmse = sharded.register_batch_point_sharded(nccl_mesh, src, dst, intr, cfg)
    torch.cuda.synchronize()
    assert gn_step.LAUNCHES["gn_system"] - before["gn_system"] == sum(cfg.iters) * cfg.inner_iters
    assert gn_step.LAUNCHES["gn_round"] == before["gn_round"]
    ref = batched.register_batch(src, dst, intr, cfg)
    twist = se3.log(se3.compose(se3.inverse(ref.transform), T)).abs().amax()
    assert twist.item() <= 1e-5 and torch.isfinite(rmse).all()
    res = batched.register_batch_sharded(nccl_mesh, src, dst, intr, cfg)
    assert torch.equal(res.transform, ref.transform) and torch.equal(res.num_matched, ref.num_matched)


def test_sharded_tsdf_on_one_nccl_rank(cuda, nccl_mesh):
    from realsensetracker_tpu_torch.mapping import sharded as sh

    cfg, intr, depths, _, poses = _tsdf_setup(128, cuda)
    vol, ref = sh.init_volume_sharded(cfg, nccl_mesh), tsdf_mod.init_volume(cfg, device=cuda)
    for i in range(depths.shape[0]):
        sh.integrate(vol, depths[i], poses[i], intr, cfg)
        tsdf_mod.integrate(ref, depths[i], poses[i], intr, cfg)
    local, x0 = sh.local_slab(vol)
    assert x0 == 0 and torch.equal(local.tsdf, ref.tsdf) and torch.equal(local.weight, ref.weight)
    got, want = sh.raycast(vol, poses[-1], intr, cfg), tsdf_mod.raycast(ref, poses[-1], intr, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got > 0, want > 0) and (got - want).abs().max().item() <= 1e-5


def test_sharded_executor_and_helpers_on_one_nccl_rank(cuda, nccl_mesh):
    """BatchingConfig(mesh=...) on the card equals the one-device executor
    bit for bit (the scatter and the gather are the identity); the
    multihost helpers run over NCCL."""
    from realsensetracker_tpu_torch.api.batching import BatchedExecutor, BatchingConfig
    from realsensetracker_tpu_torch.parallel import multihost

    intr = _intr(120, 160)
    frames = (_stream_frames(intr, 2, 4, "cpu").numpy() * 5000.0 + 0.5).astype(np.uint16)
    poses = {}
    for mesh in (None, nccl_mesh):
        ex = BatchedExecutor(BatchingConfig(intrinsics=intr, capacity=4, depth_scale=2e-4, mesh=mesh,
                                            request_timeout_s=60.0))
        try:
            trackers = [ex.make_session_tracker() for _ in range(2)]
            poses[mesh is None] = np.stack([[trackers[i].process(frames[f, i]).pose for f in range(4)]
                                            for i in range(2)])
            assert ex.stats()["errors"] == 0
        finally:
            ex.close()
    np.testing.assert_array_equal(poses[False], poses[True])
    multihost.all_processes_ready()
    g = multihost.global_frame_batch(np.zeros((2, 12, 16), np.float32), nccl_mesh)
    assert tuple(g.shape) == (2, 12, 16) and g.to_local().is_cuda


def test_dryrun_multichip_on_one_card(cuda):
    from realsensetracker_tpu_torch.parallel.dryrun import dryrun_multichip

    d = dryrun_multichip(1)
    assert d["mesh"] == [1, 1] and d["register_max_abs_err"] <= 1e-5 and d["raycast_hit_share"] > 0.3
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(torch.cuda.device_count() + 1)
