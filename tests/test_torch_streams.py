"""Parity of the port's multi-stream steps (realsensetracker_tpu_torch/
parallel/streams.py) with the JAX package's, on the CPU.

Mirrors TestMultiStream, TestTsdfStreams and TestU16Streams of
tests/test_streams_checkpoint.py and the masked-step cases of
tests/test_batching.py (TestMaskedStep, the RGB-D and TSDF masked and
window cases), at their shapes: the 100x75 INTR of tests/test_batching.py:32
with S = 3 streams of 4 frames, 64x48 RGB-D with S = 2, and 80x60 dense
slots into a 48^3 x 12 cm volume. The frames are JAX's own synthetic
renders (seeded), fed to both sides as f32 numpy arrays.

Bars: poses within 1e-4 of JAX per entry and stats rows within 1e-4;
seeding rows (identity pose and relative, rmse 0, inlier 1) and the held
rows of inactive slots exact; success flags equal; RGB-D at the same 1e-4;
the port's window against its own per-step run within 1e-6; dense volumes
through tests/torch_parity.tracked_volumes_close (1e-4, at most 0.01% of
voxels parted); an inactive dense slot bit-identical; the slots' one
integrate call (integrate_slots) bit-identical to integrate() per slot and
within volumes_close of JAX's integrate vmapped over the slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.align import rgbd as jrgbd
from realsensetracker_tpu.data import synthetic as jsyn
from realsensetracker_tpu.geometry import camera as jcam
from realsensetracker_tpu.mapping import tsdf as jtsdf
from realsensetracker_tpu.mapping.tsdf import TsdfConfig as JTsdfConfig
from realsensetracker_tpu.parallel import streams as jst
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.mapping import tsdf as ptsdf
from realsensetracker_tpu_torch.parallel import streams as pst
from realsensetracker_tpu_torch.tracking.tsdf_tracker import TsdfTracker
from tests.torch_parity import tracked_volumes_close, twist_gap, volumes_close

JINTR = jcam.Intrinsics(fx=100.0, fy=100.0, cx=49.5, cy=37.0, width=100, height=75)
JCFG = jproj.ProjectiveIcpConfig(iters=(5, 5, 6), samples=1024)
INTR, CFG = interop.intrinsics_from_jax(JINTR), interop.icp_config_from_jax(JCFG)
S, F = 3, 4
ATOL = 1e-4

JRGBD_INTR = jcam.Intrinsics(fx=64.0, fy=64.0, cx=31.5, cy=23.5, width=64, height=48)
JRGBD_CFG = jrgbd.RgbdIcpConfig(iters=(4, 4), samples=512, min_samples=128)
RGBD_INTR, RGBD_CFG = interop.intrinsics_from_jax(JRGBD_INTR), interop.rgbd_config_from_jax(JRGBD_CFG)
S2 = 2

JTSDF_INTR = jcam.Intrinsics(fx=64.0, fy=64.0, cx=39.5, cy=29.5, width=80, height=60)
JTSDF_ICP = jproj.ProjectiveIcpConfig(iters=(3, 3), inner_iters=2, samples=768, min_samples=192)
JVOL = JTsdfConfig(resolution=48, voxel_size=0.12, origin=(-2.88, -2.16, -0.4), trunc=0.36, max_range=5.0)
TSDF_INTR, TSDF_ICP = interop.intrinsics_from_jax(JTSDF_INTR), interop.icp_config_from_jax(JTSDF_ICP)
VOL = interop.tsdf_config_from_jax(JVOL)
S3 = 2


def _render(intr, s, frames, seed0, step_scale):
    out = []
    for i in range(s):
        d, _ = jsyn.render_trajectory(intr, frames, scene=jsyn.default_scene(seed=seed0 + i), seed=i,
                                      step_scale=step_scale)
        out.append(np.asarray(d, np.float32))
    return np.stack(out, 1)  # (F, S, H, W)


@pytest.fixture(scope="module")
def stream_data():
    """(F, S, H, W): tests/test_batching.py's S independent trajectories."""
    return _render(JINTR, S, F, 20, 0.015)


@pytest.fixture(scope="module")
def ckpt_data():
    """(5, S, H, W): tests/test_streams_checkpoint.py's trajectories (seed 10+i)
    and their true poses."""
    out, poses = [], []
    for i in range(S):
        d, p = jsyn.render_trajectory(JINTR, 5, scene=jsyn.default_scene(seed=10 + i), seed=i, step_scale=0.015)
        out.append(np.asarray(d, np.float32))
        poses.append(np.asarray(p, np.float32))
    return np.stack(out, 1), np.stack(poses, 1)


@pytest.fixture(scope="module")
def rgbd_data():
    depths, grays = [], []
    for i in range(S2):
        d, c, _ = jsyn.render_trajectory_rgbd(JRGBD_INTR, F, scene=jsyn.default_scene(seed=70 + i), seed=i,
                                              step_scale=0.01)
        depths.append(np.asarray(d, np.float32))
        grays.append(np.asarray(jsyn.intensity_from_rgb(c), np.float32))
    return np.stack(depths, 1), np.stack(grays, 1)


@pytest.fixture(scope="module")
def tsdf_data():
    return _render(JTSDF_INTR, S3, F, 30, 0.01)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows_close(jrows, prows, seeding=None, inactive=None, held=None):
    """Stats rows within ATOL; seeding rows exact; inactive rows report
    failure and, given ``held`` (the port's poses before the step), hold
    that pose exactly."""
    jrows, prows = np.asarray(jrows), prows.numpy()
    np.testing.assert_allclose(prows, jrows, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(prows[..., 32] > 0.5, jrows[..., 32] > 0.5)
    eye = np.eye(4, dtype=np.float32).reshape(16)
    for i in np.flatnonzero(seeding if seeding is not None else []):
        np.testing.assert_array_equal(prows[i, :16], eye)
        np.testing.assert_array_equal(prows[i, 16:32], eye)
        assert prows[i, 32] == 1.0 and prows[i, 33] == 0.0 and prows[i, -1] == 1.0
    for i in np.flatnonzero(inactive if inactive is not None else []):
        assert prows[i, 32] == 0.0
        if held is not None:
            np.testing.assert_array_equal(prows[i, :16], held[i].reshape(16).numpy())


def _state_close(jstate, pstate):
    np.testing.assert_allclose(pstate.poses.numpy(), np.asarray(jstate.poses), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pstate.frame_count.numpy(), np.asarray(jstate.frame_count))
    np.testing.assert_array_equal(pstate.initialized.numpy(), np.asarray(jstate.initialized))


def _aligned_reference(stream_data, frames):
    """JAX: every slot advanced ``frames`` frames via the always-on step."""
    ref = jst.init_streams(jnp.asarray(stream_data[0]), JINTR, JCFG)
    for f in range(1, frames):
        ref, _ = jst.step_streams(ref, jnp.asarray(stream_data[f]), JINTR, JCFG)
    return ref


# --- always-on steps (tests/test_streams_checkpoint.py TestMultiStream) -------


class TestMultiStream:
    def test_streams_track_independently_and_match_jax(self, ckpt_data):
        depths, truth = ckpt_data
        js = jst.init_streams(jnp.asarray(depths[0]), JINTR, JCFG)
        ps = pst.init_streams(t(depths[0]), INTR, CFG)
        for f in range(1, 4):
            js, jr = jst.step_streams(js, jnp.asarray(depths[f]), JINTR, JCFG)
            ps, pr = pst.step_streams(ps, t(depths[f]), INTR, CFG)
            assert bool(pr.success.all())
            np.testing.assert_array_equal(pr.success.numpy(), np.asarray(jr.success))
            np.testing.assert_allclose(pr.rmse.numpy(), np.asarray(jr.rmse), rtol=0, atol=ATOL)
            np.testing.assert_allclose(pr.inlier_fraction.numpy(), np.asarray(jr.inlier_fraction), rtol=0, atol=ATOL)
        _state_close(js, ps)
        for i in range(S):
            assert twist_gap(truth[3, i], ps.poses[i].numpy()) < 0.05

    def test_windowed_step_matches_sequential(self, ckpt_data):
        depths, _ = ckpt_data
        ref = pst.init_streams(t(depths[0]), INTR, CFG)
        win = pst.init_streams(t(depths[0]), INTR, CFG)
        seq = []
        for f in range(1, 5):
            ref, r = pst.step_streams(ref, t(depths[f]), INTR, CFG)
            seq.append(r)
        window = np.moveaxis(depths[1:5], 0, 1)
        win, wr = pst.step_streams_window(win, t(window), INTR, CFG)
        assert wr.poses.shape == (S, 4, 4, 4)
        np.testing.assert_allclose(win.poses.numpy(), ref.poses.numpy(), rtol=0, atol=1e-6)
        for f in range(4):
            assert torch.equal(wr.success[:, f], seq[f].success)
            np.testing.assert_allclose(wr.poses[:, f].numpy(), seq[f].poses.numpy(), rtol=0, atol=1e-6)
        jwin, jwr = jst.step_streams_window(jst.init_streams(jnp.asarray(depths[0]), JINTR, JCFG),
                                            jnp.moveaxis(jnp.asarray(depths[1:5]), 0, 1), JINTR, JCFG)
        np.testing.assert_allclose(wr.poses.numpy(), np.asarray(jwr.poses), rtol=0, atol=ATOL)
        _state_close(jwin, win)

    def test_failed_stream_holds_pose_and_reference(self, ckpt_data):
        depths, _ = ckpt_data
        state = pst.init_streams(t(depths[0, :2]), INTR, CFG)
        bad = depths[1, :2].copy()
        bad[0] = 0.0  # kill stream 0's second frame
        state1, res = pst.step_streams(state, t(bad), INTR, CFG)
        assert not bool(res.success[0]) and bool(res.success[1])
        np.testing.assert_array_equal(state1.poses[0].numpy(), np.eye(4, dtype=np.float32))
        # Stream 0's reference is still frame 0: the next good frame
        # registers against it.
        _, res2 = pst.step_streams(state1, t(depths[1, :2]), INTR, CFG)
        assert bool(res2.success[0])


# --- masked steps (tests/test_batching.py TestMaskedStep) ---------------------


class TestMaskedStep:
    def test_all_active_matches_step_streams(self, stream_data):
        ref = pst.init_streams(t(stream_data[0]), INTR, CFG)
        msk = pst.init_streams(t(stream_data[0]), INTR, CFG)
        on, off = torch.ones(S, dtype=torch.bool), torch.zeros(S, dtype=torch.bool)
        for f in range(1, F):
            ref, r = pst.step_streams(ref, t(stream_data[f]), INTR, CFG)
            msk, stats = pst.step_streams_masked(msk, t(stream_data[f]), on, off, INTR, CFG)
            assert stats.shape == (S, pst.MASKED_STATS_WIDTH)
            np.testing.assert_allclose(msk.poses.numpy(), ref.poses.numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(stats[:, :16].reshape(S, 4, 4).numpy(), ref.poses.numpy(), rtol=0, atol=1e-6)
            assert torch.equal(stats[:, 32] > 0.5, r.success)

    def test_staggered_seeding_matches_jax(self, stream_data):
        """Slot i joins at round i: every round's stats rows against JAX's,
        seeding rows and held inactive rows exact, and the final state
        against JAX's aligned all-active run."""
        js = jst.blank_streams(JINTR, JCFG, num_streams=S)
        ps = pst.blank_streams(INTR, CFG, num_streams=S, device="cpu")
        for r in range(F + S - 1):
            depths = np.zeros((S,) + stream_data.shape[2:], np.float32)
            active, seed = np.zeros(S, bool), np.zeros(S, bool)
            for i in range(S):
                f = r - i
                if 0 <= f < F:
                    depths[i], active[i], seed[i] = stream_data[f, i], True, f == 0
            prev_poses, prev_count = ps.poses.clone(), ps.frame_count.clone()
            js, jstats = jst.step_streams_masked(js, jnp.asarray(depths), jnp.asarray(active), jnp.asarray(seed),
                                                 JINTR, JCFG)
            ps, pstats = pst.step_streams_masked(ps, t(depths), t(active), t(seed), INTR, CFG)
            _rows_close(jstats, pstats, seeding=active & seed, inactive=~active, held=prev_poses)
            for i in np.flatnonzero(~active):  # untouched
                assert torch.equal(ps.poses[i], prev_poses[i]) and ps.frame_count[i] == prev_count[i]
            _state_close(js, ps)
        ref = _aligned_reference(stream_data, F)
        np.testing.assert_allclose(ps.poses.numpy(), np.asarray(ref.poses), rtol=0, atol=ATOL)
        assert bool(ps.initialized.all())

    def test_blank_slot_rows_match_jax(self, stream_data):
        """Never-seeded slots register all-zero depth against all-zero
        references; their rows (held identity pose, success 0) equal JAX's."""
        js = jst.blank_streams(JINTR, JCFG, num_streams=S)
        ps = pst.blank_streams(INTR, CFG, num_streams=S, device="cpu")
        active = np.array([True, False, False])
        depths = np.zeros((S,) + stream_data.shape[2:], np.float32)
        depths[0] = stream_data[0, 0]
        for seed0 in (True, False):
            seed = np.array([seed0, False, False])
            js, jstats = jst.step_streams_masked(js, jnp.asarray(depths), jnp.asarray(active), jnp.asarray(seed),
                                                 JINTR, JCFG)
            ps, pstats = pst.step_streams_masked(ps, t(depths), t(active), t(seed), INTR, CFG)
            _rows_close(jstats, pstats, seeding=active & seed, inactive=~active)
            assert bool(torch.isfinite(pstats).all())
            np.testing.assert_array_equal(pstats[1:].numpy(), np.asarray(jstats)[1:])

    def test_window_scan_matches_sequential_masked_steps(self, stream_data):
        """step_streams_masked_window == W sequential masked steps, with a
        ragged active pattern (slot i carries i+1 frames, slot 2 reseeds),
        and == JAX's window."""
        W = 3
        a = pst.init_streams(t(stream_data[0]), INTR, CFG)
        b = pst.init_streams(t(stream_data[0]), INTR, CFG)
        depths = np.zeros((S, W) + stream_data.shape[2:], np.float32)
        active, seed = np.zeros((S, W), bool), np.zeros((S, W), bool)
        for i in range(S):
            depths[i, : i + 1] = stream_data[1 : 2 + i, i]
            active[i, : i + 1] = True
        seed[2, 0] = True
        a, stats_a = pst.step_streams_masked_window(a, t(depths), t(active), t(seed), INTR, CFG)
        per = []
        for j in range(W):
            b, st = pst.step_streams_masked(b, t(depths[:, j]), t(active[:, j]), t(seed[:, j]), INTR, CFG)
            per.append(st)
        assert stats_a.shape == (S, W, pst.MASKED_STATS_WIDTH)
        np.testing.assert_allclose(stats_a.numpy(), torch.stack(per, 1).numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a.frame_count.numpy(), b.frame_count.numpy())
        js, jstats = jst.step_streams_masked_window(
            jst.init_streams(jnp.asarray(stream_data[0]), JINTR, JCFG), jnp.asarray(depths), jnp.asarray(active),
            jnp.asarray(seed), JINTR, JCFG)
        np.testing.assert_allclose(stats_a.numpy(), np.asarray(jstats), rtol=0, atol=ATOL)
        _state_close(js, a)

    def test_random_activity_matches_per_slot_replay(self, stream_data):
        """Sessions join late, skip rounds and resume: each slot ends where
        JAX's aligned all-active run of its own frames ends."""
        rng = np.random.default_rng(7)
        state = pst.blank_streams(INTR, CFG, num_streams=S, device="cpu")
        next_frame = np.zeros(S, int)
        rounds = 0
        while (next_frame < F).any():
            rounds += 1
            depths = np.zeros((S,) + stream_data.shape[2:], np.float32)
            active, seed = np.zeros(S, bool), np.zeros(S, bool)
            for i in range(S):
                if next_frame[i] < F and rng.random() < 0.6:
                    depths[i], active[i], seed[i] = stream_data[next_frame[i], i], True, next_frame[i] == 0
                    next_frame[i] += 1
            state, _ = pst.step_streams_masked(state, t(depths), t(active), t(seed), INTR, CFG)
        assert rounds > F
        ref = _aligned_reference(stream_data, F)
        np.testing.assert_allclose(state.poses.numpy(), np.asarray(ref.poses), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(state.frame_count.numpy(), F)

    def test_reseed_resets_a_live_slot(self, stream_data):
        state = pst.init_streams(t(stream_data[0]), INTR, CFG)
        on, off = torch.ones(S, dtype=torch.bool), torch.zeros(S, dtype=torch.bool)
        state, _ = pst.step_streams_masked(state, t(stream_data[1]), on, off, INTR, CFG)
        moved = state.poses.clone()
        assert not torch.allclose(moved[0], torch.eye(4), atol=1e-6)
        state, _ = pst.step_streams_masked(state, t(stream_data[2]), on, torch.tensor([True, False, False]), INTR,
                                           CFG)
        assert torch.equal(state.poses[0], torch.eye(4))
        assert not torch.allclose(state.poses[1], moved[1], atol=1e-9)  # kept moving


# --- u16 (tests/test_streams_checkpoint.py TestU16Streams) ---------------------


class TestU16Streams:
    def test_masked_u16_matches_f32_and_jax(self, ckpt_data):
        depths, _ = ckpt_data
        scale = 1.0 / 5000.0
        raw = np.asarray(depths[:4] * 5000.0 + 0.5, np.uint16)
        quant = raw.astype(np.float32) * np.float32(scale)
        on, off = torch.ones(S, dtype=torch.bool), torch.zeros(S, dtype=torch.bool)
        a = pst.blank_streams(INTR, CFG, num_streams=S, device="cpu")
        b = pst.blank_streams(INTR, CFG, num_streams=S, device="cpu")
        j = jst.blank_streams(JINTR, JCFG, num_streams=S)
        for f in range(4):
            sd = on if f == 0 else off
            a, sa = pst.step_streams_masked(a, t(quant[f]), on, sd, INTR, CFG)
            b, sb = pst.step_streams_masked(b, t(raw[f]), on, sd, INTR, CFG, depth_scale=scale)
            j, sj = jst.step_streams_masked(j, jnp.asarray(raw[f]), jnp.asarray(on.numpy()), jnp.asarray(sd.numpy()),
                                            JINTR, JCFG, depth_scale=scale)
            np.testing.assert_allclose(sa.numpy(), sb.numpy(), rtol=0, atol=1e-6)
            _rows_close(sj, sb)
        np.testing.assert_allclose(a.poses.numpy(), b.poses.numpy(), rtol=0, atol=1e-6)

    def test_windowed_u16_matches_f32(self, ckpt_data):
        depths, _ = ckpt_data
        scale = 1.0 / 5000.0
        raw = np.asarray(depths[:, :2] * 5000.0 + 0.5, np.uint16)
        quant = raw.astype(np.float32) * np.float32(scale)
        a = pst.init_streams(t(quant[0]), INTR, CFG)
        b = pst.init_streams(t(raw[0]), INTR, CFG, depth_scale=scale)
        a, ra = pst.step_streams_window(a, t(np.moveaxis(quant[1:5], 0, 1)), INTR, CFG)
        b, rb = pst.step_streams_window(b, t(np.moveaxis(raw[1:5], 0, 1)), INTR, CFG, depth_scale=scale)
        np.testing.assert_allclose(ra.poses.numpy(), rb.poses.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.poses.numpy(), b.poses.numpy(), rtol=0, atol=1e-6)


# --- RGB-D slots (tests/test_batching.py TestRgbdBatched) ---------------------


class TestRgbdStreams:
    def test_masked_rgbd_matches_jax(self, rgbd_data):
        depths, grays = rgbd_data
        js = jst.blank_streams_rgbd(JRGBD_INTR, JRGBD_CFG, num_streams=S2)
        ps = pst.blank_streams_rgbd(RGBD_INTR, RGBD_CFG, num_streams=S2, device="cpu")
        for f in range(F):
            active = np.array([True, f != 2])  # slot 1 sits out round 2
            seed = np.full(S2, f == 0)
            prev = ps.poses.clone()
            js, jstats = jst.step_streams_masked_rgbd(js, jnp.asarray(depths[f]), jnp.asarray(grays[f]),
                                                      jnp.asarray(active), jnp.asarray(seed), JRGBD_INTR, JRGBD_CFG)
            ps, pstats = pst.step_streams_masked_rgbd(ps, t(depths[f]), t(grays[f]), t(active), t(seed), RGBD_INTR,
                                                      RGBD_CFG)
            assert pstats.shape == (S2, pst.MASKED_RGBD_STATS_WIDTH)
            _rows_close(jstats, pstats, seeding=active & seed, inactive=~active, held=prev)
            _state_close(js, ps)
        assert (pstats[:, 32] > 0.5).all() and bool(torch.isfinite(pstats[:, 34]).all())

    def test_rgbd_window_matches_steps(self, rgbd_data):
        depths, grays = rgbd_data
        sa = pst.blank_streams_rgbd(RGBD_INTR, RGBD_CFG, num_streams=S2, device="cpu")
        sb = pst.blank_streams_rgbd(RGBD_INTR, RGBD_CFG, num_streams=S2, device="cpu")
        d, g = t(np.moveaxis(depths, 0, 1)), t(np.moveaxis(grays, 0, 1))
        active = torch.ones((S2, F), dtype=torch.bool)
        seed = torch.zeros((S2, F), dtype=torch.bool)
        seed[:, 0] = True
        sa, stats_a = pst.step_streams_masked_rgbd_window(sa, d, g, active, seed, RGBD_INTR, RGBD_CFG)
        per = []
        for j in range(F):
            sb, st = pst.step_streams_masked_rgbd(sb, d[:, j], g[:, j], active[:, j], seed[:, j], RGBD_INTR,
                                                  RGBD_CFG)
            per.append(st)
        np.testing.assert_allclose(stats_a.numpy(), torch.stack(per, 1).numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(sa.poses.numpy(), sb.poses.numpy(), rtol=0, atol=1e-6)


# --- dense slots (TestTsdfStreams and the TSDF masked cases) -------------------


class TestTsdfStreams:
    def test_always_on_matches_jax_and_single_tracker(self, tsdf_data):
        js = jst.init_tsdf_streams(jnp.asarray(tsdf_data[0]), JTSDF_INTR, JVOL)
        ps = pst.init_tsdf_streams(t(tsdf_data[0]), TSDF_INTR, VOL)
        for f in range(1, F):
            js, jr = jst.step_tsdf_streams(js, jnp.asarray(tsdf_data[f]), JTSDF_INTR, JVOL, JTSDF_ICP)
            ps, pr = pst.step_tsdf_streams(ps, t(tsdf_data[f]), TSDF_INTR, VOL, TSDF_ICP)
            assert bool(pr.success.all()), f"frame {f}"
            np.testing.assert_allclose(pr.poses.numpy(), np.asarray(jr.poses), rtol=0, atol=ATOL)
        _state_close(js, ps)
        for i in range(S3):
            tracked_volumes_close(_slot(js.volume, i), ptsdf.TsdfVolume(ps.volume.tsdf[i], ps.volume.weight[i]))
            tr = TsdfTracker(TSDF_INTR, volume=VOL, icp=TSDF_ICP, device="cpu")
            for f in range(F):
                tr.process(tsdf_data[f, i], float(f))
            np.testing.assert_allclose(ps.poses[i].numpy(), tr.pose, rtol=0, atol=1e-5)

    def test_window_matches_per_frame(self, tsdf_data):
        a = pst.init_tsdf_streams(t(tsdf_data[0]), TSDF_INTR, VOL)
        b = pst.init_tsdf_streams(t(tsdf_data[0]), TSDF_INTR, VOL)
        per = []
        for f in range(1, F):
            a, res = pst.step_tsdf_streams(a, t(tsdf_data[f]), TSDF_INTR, VOL, TSDF_ICP)
            per.append(res.poses)
        b, resw = pst.step_tsdf_streams_window(b, t(np.moveaxis(tsdf_data[1:], 0, 1)), TSDF_INTR, VOL, TSDF_ICP)
        for f in range(F - 1):
            np.testing.assert_allclose(resw.poses[:, f].numpy(), per[f].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.volume.tsdf.numpy(), b.volume.tsdf.numpy(), rtol=0, atol=1e-6)

    def test_masked_matches_jax(self, tsdf_data):
        js = jst.blank_tsdf_streams(JTSDF_INTR, JVOL, num_streams=S3)
        ps = pst.blank_tsdf_streams(TSDF_INTR, VOL, num_streams=S3, device="cpu")
        for f in range(F):
            active = np.array([True, f != 2])
            seed = np.full(S3, f == 0)
            prev = ps.poses.clone()
            js, jstats = jst.step_tsdf_streams_masked(js, jnp.asarray(tsdf_data[f]), jnp.asarray(active),
                                                      jnp.asarray(seed), JTSDF_INTR, JVOL, JTSDF_ICP)
            ps, pstats = pst.step_tsdf_streams_masked(ps, t(tsdf_data[f]), t(active), t(seed), TSDF_INTR, VOL,
                                                      TSDF_ICP)
            _rows_close(jstats, pstats, seeding=active & seed, inactive=~active, held=prev)
            _state_close(js, ps)
        for i in range(S3):
            tracked_volumes_close(_slot(js.volume, i), ptsdf.TsdfVolume(ps.volume.tsdf[i], ps.volume.weight[i]))

    def test_inactive_slots_bit_identical_and_reseed(self, tsdf_data):
        state = pst.blank_tsdf_streams(TSDF_INTR, VOL, num_streams=S3, device="cpu")
        both = torch.ones(S3, dtype=torch.bool)
        state, _ = pst.step_tsdf_streams_masked(state, t(tsdf_data[0]), both, both, TSDF_INTR, VOL, TSDF_ICP)
        only0 = torch.tensor([True, False])
        before_vol1 = state.volume.tsdf[1].clone()
        before_w1 = state.volume.weight[1].clone()
        before_pose1 = state.poses[1].clone()
        state, stats = pst.step_tsdf_streams_masked(state, t(tsdf_data[1]), only0, torch.zeros(S3, dtype=torch.bool),
                                                    TSDF_INTR, VOL, TSDF_ICP)
        assert torch.equal(state.volume.tsdf[1], before_vol1) and torch.equal(state.volume.weight[1], before_w1)
        assert torch.equal(state.poses[1], before_pose1)
        assert stats[1, 32] < 0.5
        state, _ = pst.step_tsdf_streams_masked(state, t(tsdf_data[2]), only0, only0, TSDF_INTR, VOL, TSDF_ICP)
        assert torch.equal(state.poses[0], torch.eye(4))
        fresh = ptsdf.integrate(ptsdf.init_volume(VOL, device="cpu"), t(tsdf_data[2, 0]), se3.identity(), TSDF_INTR,
                                VOL)
        assert torch.equal(state.volume.tsdf[0], fresh.tsdf) and torch.equal(state.volume.weight[0], fresh.weight)

    def test_masked_window_matches_steps(self, tsdf_data):
        sa = pst.blank_tsdf_streams(TSDF_INTR, VOL, num_streams=S3, device="cpu")
        sb = pst.blank_tsdf_streams(TSDF_INTR, VOL, num_streams=S3, device="cpu")
        d = t(np.moveaxis(tsdf_data, 0, 1))
        active = torch.ones((S3, F), dtype=torch.bool)
        seed = torch.zeros((S3, F), dtype=torch.bool)
        seed[:, 0] = True
        sa, stats_a = pst.step_tsdf_streams_masked_window(sa, d, active, seed, TSDF_INTR, VOL, TSDF_ICP)
        per = []
        for j in range(F):
            sb, st = pst.step_tsdf_streams_masked(sb, d[:, j], active[:, j], seed[:, j], TSDF_INTR, VOL, TSDF_ICP)
            per.append(st)
        np.testing.assert_allclose(stats_a.numpy(), torch.stack(per, 1).numpy(), rtol=0, atol=1e-6)
        assert torch.equal(sa.volume.tsdf, sb.volume.tsdf) and torch.equal(sa.volume.weight, sb.volume.weight)

    def test_integrate_every_and_slab_off(self, tsdf_data):
        """The integrate_every cadence keys on each slot's frame_count and
        the slab window is forced off, as in JAX."""
        jvol = JVOL._replace(integrate_every=2, integrate_slab=24)
        vol = interop.tsdf_config_from_jax(jvol)
        js = jst.blank_tsdf_streams(JTSDF_INTR, jvol, num_streams=S3)
        ps = pst.blank_tsdf_streams(TSDF_INTR, vol, num_streams=S3, device="cpu")
        on = np.ones(S3, bool)
        for f in range(F):
            seed = np.full(S3, f == 0)
            js, jstats = jst.step_tsdf_streams_masked(js, jnp.asarray(tsdf_data[f]), jnp.asarray(on),
                                                      jnp.asarray(seed), JTSDF_INTR, jvol, JTSDF_ICP)
            ps, pstats = pst.step_tsdf_streams_masked(ps, t(tsdf_data[f]), t(on), t(seed), TSDF_INTR, vol, TSDF_ICP)
            _rows_close(jstats, pstats, seeding=on & seed)
        for i in range(S3):
            tracked_volumes_close(_slot(js.volume, i), ptsdf.TsdfVolume(ps.volume.tsdf[i], ps.volume.weight[i]))


def test_integrate_slots_matches_per_slot_and_jax_vmap():
    """The dense slots' one integrate call (mapping/tsdf.integrate_slots,
    kernels/tsdf.fuse_blocks_reference on the CPU) over S3 slots with gates
    (1, 0), two frames of each slot's walk at their poses: bit-identical to
    integrate() on each slot's planes, and equal to JAX's integrate vmapped
    over the slots with the same gates (volumes_close: weights equal, tsdf
    within 1e-6)."""
    frames, poses = [], []
    for i in range(S3):
        d, P = jsyn.render_trajectory(JTSDF_INTR, 2, scene=jsyn.default_scene(seed=30 + i), seed=i, step_scale=0.01)
        frames.append(np.asarray(d, np.float32))
        poses.append(np.asarray(P, np.float32))
    frames, poses = np.stack(frames, 1), np.stack(poses, 1)  # (2, S3, H, W), (2, S3, 4, 4)
    gates = np.array([True, False])
    v = VOL.resolution
    slots = ptsdf.TsdfVolume(torch.ones((S3, v, v, v)), torch.zeros((S3, v, v, v)))
    per = ptsdf.clone_volume(slots)
    one = jtsdf.init_volume(JVOL)
    jvol = jtsdf.TsdfVolume(jnp.stack([one.tsdf] * S3), jnp.stack([one.weight] * S3))

    @jax.jit
    @jax.vmap
    def jstep(vol, d, P, g):
        new = jtsdf.integrate(vol, d, P, JTSDF_INTR, JVOL)
        return jtsdf.TsdfVolume(jnp.where(g, new.tsdf, vol.tsdf), jnp.where(g, new.weight, vol.weight))

    for f in range(2):
        ptsdf.integrate_slots(slots, t(frames[f]), t(poses[f]), TSDF_INTR, VOL, gates=t(gates))
        for i in range(S3):
            ptsdf.integrate(ptsdf.TsdfVolume(per.tsdf[i], per.weight[i]), t(frames[f, i]), t(poses[f, i]),
                            TSDF_INTR, VOL, gate=t(gates[i]))
        jvol = jstep(jvol, jnp.asarray(frames[f]), jnp.asarray(poses[f]), jnp.asarray(gates))
    assert torch.equal(slots.tsdf, per.tsdf) and torch.equal(slots.weight, per.weight)
    assert int((slots.weight[0] > 0).sum()) > 500 and not bool((slots.weight[1] > 0).any())
    for i in range(S3):
        volumes_close(_slot(jvol, i), ptsdf.TsdfVolume(slots.tsdf[i], slots.weight[i]))


def _slot(jvol, i):
    return type("JVol", (), {"tsdf": np.asarray(jvol.tsdf[i]), "weight": np.asarray(jvol.weight[i]), "color": None})


# --- interop: a state carried from JAX, one step on both sides -----------------


class TestStreamInterop:
    def test_depth_state_from_jax(self, stream_data):
        js = _aligned_reference(stream_data, 2)
        ps = interop.stream_state_from_jax(js, device="cpu")
        _state_close(js, ps)
        prev = ps.poses.clone()
        active, seed = np.array([True, False, True]), np.zeros(S, bool)
        js, jstats = jst.step_streams_masked(js, jnp.asarray(stream_data[2]), jnp.asarray(active), jnp.asarray(seed),
                                             JINTR, JCFG)
        ps, pstats = pst.step_streams_masked(ps, t(stream_data[2]), t(active), t(seed), INTR, CFG)
        _rows_close(jstats, pstats, inactive=~active, held=prev)
        _state_close(js, ps)

    def test_rgbd_state_from_jax(self, rgbd_data):
        depths, grays = rgbd_data
        on = np.ones(S2, bool)
        js = jst.blank_streams_rgbd(JRGBD_INTR, JRGBD_CFG, num_streams=S2)
        js, _ = jst.step_streams_masked_rgbd(js, jnp.asarray(depths[0]), jnp.asarray(grays[0]), jnp.asarray(on),
                                             jnp.asarray(on), JRGBD_INTR, JRGBD_CFG)
        ps = interop.rgbd_stream_state_from_jax(js, device="cpu")
        js, jstats = jst.step_streams_masked_rgbd(js, jnp.asarray(depths[1]), jnp.asarray(grays[1]), jnp.asarray(on),
                                                  jnp.asarray(~on), JRGBD_INTR, JRGBD_CFG)
        ps, pstats = pst.step_streams_masked_rgbd(ps, t(depths[1]), t(grays[1]), t(on), t(~on), RGBD_INTR, RGBD_CFG)
        _rows_close(jstats, pstats)
        _state_close(js, ps)

    def test_tsdf_state_from_jax(self, tsdf_data):
        js = jst.init_tsdf_streams(jnp.asarray(tsdf_data[0]), JTSDF_INTR, JVOL)
        ps = interop.tsdf_stream_state_from_jax(js, device="cpu")
        on = np.ones(S3, bool)
        js, jstats = jst.step_tsdf_streams_masked(js, jnp.asarray(tsdf_data[1]), jnp.asarray(on), jnp.asarray(~on),
                                                  JTSDF_INTR, JVOL, JTSDF_ICP)
        ps, pstats = pst.step_tsdf_streams_masked(ps, t(tsdf_data[1]), t(on), t(~on), TSDF_INTR, VOL, TSDF_ICP)
        _rows_close(jstats, pstats)
        for i in range(S3):
            tracked_volumes_close(_slot(js.volume, i), ptsdf.TsdfVolume(ps.volume.tsdf[i], ps.volume.weight[i]))

    def test_entry_points_default_to_cuda(self):
        if torch.cuda.is_available():
            assert pst.blank_streams(INTR, CFG, num_streams=2).poses.is_cuda
            return
        with pytest.raises(RuntimeError, match="CUDA"):
            pst.blank_streams(INTR, CFG, num_streams=2)
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.stream_state_from_jax(jst.blank_streams(JINTR, JCFG, num_streams=2))
