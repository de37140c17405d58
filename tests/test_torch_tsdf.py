"""Parity of the port's TSDF volume (realsensetracker_tpu_torch/mapping/tsdf.py)
with the JAX package's jitted functions, on the CPU (the kernels run their
plain torch versions there).

Inputs: the spheres of torch_parity.scene rendered by the port at 80x60,
fed to both sides as f32 numpy frames, into the 48^3 x 5 cm volume of
tests/test_submaps.py:30-32. Bars: integrate (full, slab, colored) tsdf and
color within 1e-6 with weights and update masks equal; raycast (full and
coarse-to-fine) hit masks equal and depth within 1e-5; render_model_rgbd
within 1e-5; the three surface extractions with equal masks and order and
values within 1e-6 on the same volume. The march of a volume (the card
reads its planes) equals the march of its field bit for bit, and only a
whole, contiguous volume on the card is marched as a volume
(mapping/tsdf.march_source); the benchmark's raycast roofline reads such a
march as it reads a march of the field.

The integrate kernel's brick cull is held sound through its plain twin
(kernels/tsdf.brick_mask_reference): no voxel that _fuse_block's predicate
updates lies in a culled brick, over hypothesis cases (poses inside,
outside and on the faces of the volume, along the axes and tilted; frames
rendered or random with holes, NaN, inf and depth past max_depth; V = 40,
48, 96; x-slabs, slab windows, colored volumes, closed gates), over
torch_parity.adversarial_poses and on render_trajectory's 640x480 frames
into the default 128^3 volume, where it drops more than half the bricks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from realsensetracker_tpu.mapping import tsdf as J
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.mapping import tsdf as P
import tests.torch_parity as tests_torch_parity
from tests.torch_parity import (adversarial_poses, dense_configs, intrinsics, j32, look_at, render, render_rgbd,
                                volumes_close, walk)

JINTR, INTR = intrinsics(60, 80, 64.0)
JCFG, CFG = dense_configs()
POSES = walk(6)
# A 4.8 m cube of 10 cm voxels that sees depth to 2.2 m only: the frustum's
# update support fits a 36^3 window, so the slab path engages.
SLAB = dict(voxel_size=0.1, origin=(-2.4, -2.4, -0.3), trunc=0.3, max_depth=2.2, integrate_slab=36)


@pytest.fixture(scope="module")
def frames():
    depths, colors = render_rgbd(INTR, POSES, seed=1)
    return depths, colors


@pytest.fixture(scope="module")
def fused(frames):
    """The JAX volume after 6 frames and its copy in the port (the raycast
    and extraction tests' shared input)."""
    depths, colors = frames
    jv = J.init_volume(JCFG, with_color=True)
    for d, c, T in zip(depths, colors, POSES):
        jv = J.integrate(jv, j32(d), j32(T), JINTR, JCFG, color=j32(c))
    return jv, interop.tsdf_volume_from_jax(jv, device="cpu")


def test_config_matches_jax():
    assert P.TsdfConfig._fields == J.TsdfConfig._fields
    assert tuple(P.TsdfConfig()) == tuple(J.TsdfConfig())
    assert P.TsdfConfig().num_steps == J.TsdfConfig().num_steps == 75
    assert CFG.num_steps == JCFG.num_steps
    for res, vox in ((64, 0.0), (0, 0.02), (96, 0.05)):
        assert tuple(P.sized_config(res, vox)) == tuple(J.sized_config(res, vox))
    assert hash(CFG) == hash(P.TsdfConfig(**CFG._asdict()))


def test_init_volume_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert P.init_volume(CFG).tsdf.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.init_volume(CFG)
    vol = P.init_volume(CFG, with_color=True, device="cpu")
    jv = J.init_volume(JCFG, with_color=True)
    for a, b in zip(vol, jv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", ["full", "slab", "color", "slab_color"])
def test_integrate_matches_jax(frames, mode):
    depths, colors = frames
    color = "color" in mode
    jcfg, cfg = dense_configs(**(SLAB if "slab" in mode else {}))
    jv = J.init_volume(jcfg, with_color=color)
    pv = P.init_volume(cfg, with_color=color, device="cpu")
    for d, c, T in zip(depths, colors, POSES):
        jv = J.integrate(jv, j32(d), j32(T), JINTR, jcfg, color=j32(c) if color else None)
        out = P.integrate(pv, torch.from_numpy(d), torch.from_numpy(T), INTR, cfg,
                          color=torch.from_numpy(c) if color else None)
        assert out is pv  # in place
        volumes_close(jv, pv)
    assert int((pv.weight > 0).sum()) > 500


def test_slab_window_equals_the_full_pass(frames):
    depths, _ = frames
    _, slab_cfg = dense_configs(**SLAB)
    full_cfg = slab_cfg._replace(integrate_slab=0)
    full = P.init_volume(full_cfg, device="cpu")
    slab = P.init_volume(slab_cfg, device="cpu")
    fits = []
    for d, T in zip(depths, POSES):
        d, T = torch.from_numpy(d), torch.from_numpy(T)
        fits.append(bool(P.slab_window(d, T, INTR, slab_cfg)[1]))
        P.integrate(full, d, T, INTR, full_cfg)
        P.integrate(slab, d, T, INTR, slab_cfg)
        assert torch.equal(full.tsdf, slab.tsdf) and torch.equal(full.weight, slab.weight)
    assert all(fits)  # the window engages on every frame of this scene


@pytest.mark.parametrize("x0, nx", [(0, 48), (0, 12), (12, 12), (36, 12), (20, 7)])
@pytest.mark.parametrize("mode", ["full", "window", "color"])
def test_x_slab_fuse_equals_the_slice_of_the_whole_volume(frames, x0, nx, mode):
    """fuse_block_reference on the planes x0 .. x0+nx-1 alone (the x-slab
    of mapping/sharded.py) is bit-identical to the same planes of the
    whole-volume update, and within the integrate bars of JAX's volume;
    x0 = 0, nx = V is the whole volume itself."""
    from realsensetracker_tpu_torch.kernels import tsdf as K

    depths, colors = frames
    color = mode == "color"
    jcfg, cfg = dense_configs(**(SLAB if mode == "window" else {}))
    jv = J.init_volume(jcfg, with_color=color)
    full = P.init_volume(cfg, with_color=color, device="cpu")
    slab = P.TsdfVolume(*(None if a is None else a[x0 : x0 + nx].clone() for a in full))
    for d, c, T in zip(depths[:3], colors[:3], POSES[:3]):
        jv = J.integrate(jv, j32(d), j32(T), JINTR, jcfg, color=j32(c) if color else None)
        d, T = torch.from_numpy(d), torch.from_numpy(T)
        c = torch.from_numpy(c) if color else None
        P.integrate(full, d, T, INTR, cfg, color=c)
        window = P.slab_window(d, T, INTR, cfg) if mode == "window" else (None, None)
        K.fuse_block_reference(slab, d, c, P.se3.inverse(T).contiguous(), INTR, cfg,
                               start=window[0], fits=window[1], x0=x0)
    for a, b in zip(slab, full):
        if a is not None:
            assert torch.equal(a, b[x0 : x0 + nx])
    volumes_close(J.TsdfVolume(*(None if a is None else a[x0 : x0 + nx] for a in jv)), slab)
    assert int((full.weight > 0).sum()) > 500


def test_x_slab_outside_the_grid_is_refused():
    from realsensetracker_tpu_torch.kernels import tsdf as K

    vol = P.init_volume(CFG._replace(resolution=8), device="cpu")
    with pytest.raises(ValueError, match="outside a grid"):
        K.fuse_block(vol, torch.ones((60, 80)), None, torch.eye(4), INTR, CFG, x0=42)


def test_slab_rounding_bound_is_checked():
    """A configuration whose 2-voxel margin cannot cover half a pixel at
    max_depth + trunc (ADVICE r5) is refused instead of trusted."""
    intr = INTR._replace(fx=8.0, fy=8.0)
    _, cfg = dense_configs(integrate_slab=36, voxel_size=0.01)
    assert not P.slab_bound_ok(intr, cfg) and P.slab_bound_ok(INTR, CFG)
    vol = P.init_volume(cfg, device="cpu")
    with pytest.raises(ValueError, match="rounding margin"):
        P.integrate(vol, torch.ones((60, 80)), torch.eye(4), intr, cfg)


def test_closed_gate_holds_the_volume(frames):
    depths, _ = frames
    vol = P.init_volume(CFG, device="cpu")
    P.integrate(vol, torch.from_numpy(depths[0]), torch.from_numpy(POSES[0]), INTR, CFG)
    before = P.clone_volume(vol)
    P.integrate(vol, torch.from_numpy(depths[1]), torch.from_numpy(POSES[1]), INTR, CFG, gate=torch.tensor(False))
    assert torch.equal(vol.tsdf, before.tsdf) and torch.equal(vol.weight, before.weight)
    P.integrate(vol, torch.from_numpy(depths[1]), torch.from_numpy(POSES[1]), INTR, CFG, gate=torch.tensor(True))
    assert not torch.equal(vol.weight, before.weight)


def test_color_frame_must_match_the_volume():
    with pytest.raises(ValueError, match="colored volume"):
        P.integrate(P.init_volume(CFG, device="cpu"), torch.ones((60, 80)), torch.eye(4), INTR, CFG,
                    color=torch.ones((60, 80, 3)))


def test_march_field_matches_jax(fused):
    jv, pv = fused
    np.testing.assert_array_equal(P.march_field(pv).numpy(), np.asarray(J.march_field(jv)))


@pytest.mark.parametrize("k", [0, 3, 5])
def test_raycast_matches_jax(fused, k):
    jv, pv = fused
    want = np.asarray(J.raycast(jv, j32(POSES[k]), JINTR, JCFG))
    got = P.raycast(pv, torch.from_numpy(POSES[k]), INTR, CFG).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert (want > 0).mean() > 0.25
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("coarse", [2, 4])
def test_raycast_coarse_to_fine_matches_jax(fused, coarse):
    jv, pv = fused
    T = POSES[5]
    want = np.asarray(J.raycast_coarse_to_fine(jv, j32(T), JINTR, JCFG, coarse=coarse, refine_steps=8))
    got = P.raycast_coarse_to_fine(pv, torch.from_numpy(T), INTR, CFG, coarse=coarse, refine_steps=8).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        P.raycast_coarse_to_fine(pv, torch.from_numpy(T), INTR, CFG, coarse=7)


@pytest.mark.parametrize("case", ["z_start", "gate", "short_budget", "no_steps"])
def test_march_reference_matches_jax_march(fused, case):
    """The raycast kernel's plain version (kernels/tsdf.march_reference, the
    yardstick the card's kernel is held to bit for bit) against JAX's
    jitted _march + _refine_subvoxel with a per-ray z_start (numpy seed
    8, within 0.4 m before the surface), a random gate (half the rays), a
    budget of 8 steps from those starts, and no steps at all: hit masks
    equal, depth within 1e-5."""
    from realsensetracker_tpu_torch.kernels import tsdf as K

    jv, pv = fused
    T = POSES[4]
    rng = np.random.RandomState(8)
    full = np.asarray(J.raycast(jv, j32(T), JINTR, JCFG))
    z_start = np.where(full > 0, full - rng.uniform(0.0, 0.4, full.shape), CFG.min_depth).astype(np.float32)
    gate = rng.rand(*full.shape) < 0.5
    n_steps = {"z_start": CFG.num_steps, "gate": CFG.num_steps, "short_budget": 8, "no_steps": 0}[case]
    gated = case == "gate"

    @jax.jit
    def jax_march(field, T, z0, g):
        t = T[:3, 3]
        dirs = J._ray_dirs(T, JINTR)
        z_hit, found = J._march(field, t, dirs, z0, n_steps, JCFG)
        found = found & g
        z_hit = J._refine_subvoxel(field, t, dirs, z_hit, found, JCFG)
        return jnp.where(found, z_hit, 0.0)

    want = np.asarray(jax_march(J.march_field(jv), j32(T), j32(z_start), jnp.asarray(gate if gated else full >= 0)))
    got = K.march_reference(P.march_field(pv), torch.from_numpy(T), INTR, CFG, n_steps,
                            z_start=torch.from_numpy(z_start), gate=torch.from_numpy(gate) if gated else None,
                            subvoxel_iters=CFG.subvoxel_iters).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert (want > 0).any() == (n_steps > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_render_model_depth_dispatches_on_raycast_coarse(fused):
    _, pv = fused
    T = torch.from_numpy(POSES[2])
    c2f = CFG._replace(raycast_coarse=4)
    assert torch.equal(P.render_model_depth(pv, T, INTR, CFG), P.raycast(pv, T, INTR, CFG))
    assert torch.equal(P.render_model_depth(pv, T, INTR, c2f), P.raycast_coarse_to_fine(pv, T, INTR, c2f, 4, 8))


def _march_calls(source, field, case):
    """kernels/tsdf.march on ``source`` (a volume or ``field``, its march
    field) as the renders and the card tests call it: the full march, both
    phases of coarse-to-fine (coarse 4), a per-ray z_start (numpy seed 9)
    with the refine budget, a random gate, no steps. Returns the depths of
    the calls."""
    from realsensetracker_tpu_torch.kernels import tsdf as K

    T = torch.from_numpy(POSES[4])
    full = K.march_reference(field, T, INTR, CFG, CFG.num_steps)
    rng = np.random.RandomState(9)
    z0 = torch.where(full > 0, full - torch.from_numpy(rng.uniform(0.0, 0.3, full.shape).astype(np.float32)),
                     float(CFG.min_depth)).contiguous()
    gate = torch.from_numpy(rng.rand(*full.shape) < 0.5)
    n_steps, kw = CFG.num_steps, dict(subvoxel_iters=CFG.subvoxel_iters)
    if case == "coarse_to_fine":
        dc = K.march(source, T, P.coarse_intrinsics(INTR, 4), CFG, CFG.num_steps, subvoxel_iters=0)
        z_c, seeded = P.coarse_seeds(dc, 4, CFG)
        return [dc, K.march(source, T, INTR, CFG, CFG.refine_steps, z_start=z_c, gate=seeded, **kw)]
    if case == "z_start":
        n_steps, kw = CFG.refine_steps, dict(kw, z_start=z0)
    elif case == "gate":
        kw = dict(kw, gate=gate)
    elif case == "no_steps":
        n_steps = 0
    return [K.march(source, T, INTR, CFG, n_steps, **kw)]


@pytest.mark.parametrize("case", ["full", "coarse_to_fine", "z_start", "gate", "no_steps"])
def test_march_of_a_volume_equals_the_march_of_its_field(fused, case):
    """kernels/tsdf.march given the volume (the card reads its planes; the
    CPU builds its field) equals the call given march_field(vol), bit for
    bit, in every case of the card's bit-identity test."""
    _, pv = fused
    vol = P.TsdfVolume(pv.tsdf, pv.weight)
    field = P.march_field(vol)
    got, want = _march_calls(vol, field, case), _march_calls(field, field, case)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((got[-1] > 0).any()) == (case != "no_steps")


class _CardLike(torch.Tensor):
    """A CPU tensor that says it is on the card: march_source's route decided
    as for a CUDA volume without one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case", ["card", "cpu", "strided_tsdf", "strided_weight", "sharded"])
def test_march_source_marches_only_whole_contiguous_card_volumes(fused, case):
    """mapping/tsdf.march_source hands the kernel the volume itself only
    where it is whole, on the card and its planes contiguous; a CPU volume,
    a strided plane (never copied behind the caller's back) and a sharded
    volume (one-rank gloo mesh: its field gathered along x) take the flat
    march field, equal to the whole volume's, and render the same depth."""
    import torch.distributed as dist

    from realsensetracker_tpu_torch.mapping import sharded
    from realsensetracker_tpu_torch.parallel.mesh import make_mesh

    _, pv = fused
    tsdf, weight = pv.tsdf, pv.weight
    if case.startswith("strided"):  # the same values through a transposed view
        strided = lambda a: a.transpose(0, 2).contiguous().transpose(0, 2)  # noqa: E731
        tsdf, weight = (strided(tsdf), weight) if case == "strided_tsdf" else (tsdf, strided(weight))
        assert not (tsdf.is_contiguous() and weight.is_contiguous())
    if case in ("card", "strided_tsdf", "strided_weight"):
        tsdf, weight = tsdf.as_subclass(_CardLike), weight.as_subclass(_CardLike)
    vol = P.TsdfVolume(tsdf, weight)
    want = P.march_field(P.TsdfVolume(pv.tsdf, pv.weight))
    if case == "sharded":
        mesh = make_mesh(device="cpu")
        try:
            vol = sharded.shard_volume(vol, mesh)
            got = P.march_source(vol)
            render = sharded.raycast(vol, torch.from_numpy(POSES[3]), INTR, CFG)
        finally:
            dist.destroy_process_group()
        assert isinstance(got, torch.Tensor) and torch.equal(got, want)
        assert torch.equal(render, P.raycast(pv, torch.from_numpy(POSES[3]), INTR, CFG))
        return
    got = P.march_source(vol)
    if case == "card":
        assert got is vol
    else:
        assert isinstance(got, torch.Tensor) and torch.equal(got.as_subclass(torch.Tensor), want)


def test_roofline_reader_keeps_a_planes_march_as_a_field_march(fused):
    """The benchmark's raycast roofline (h100bench/metrics/tsdf_raycast_roofline)
    records kernels/tsdf.march by name, n_steps at position 4 and z_start,
    gate and subvoxel_iters as keywords: a march of the volume keeps the
    same depth, start, gate, steps and refinements as the march of its
    field, so the reader's work is the same."""
    import importlib

    from h100bench import hooks, roofline
    from h100bench.metrics import tsdf_raycast_roofline as reader

    _, pv = fused
    vol = P.TsdfVolume(pv.tsdf, pv.weight)
    (module, name, keep), = reader.RECORDS.values()
    field = P.march_field(vol)
    logs = []
    for source in (vol, field):
        log = []
        with hooks.recording(importlib.import_module(module), name, log, keep):
            _march_calls(source, field, "coarse_to_fine")
        logs.append(log)
    assert len(logs[0]) == len(logs[1]) == 2
    step = P.f32(CFG.step_frac * CFG.trunc)
    for (out, z0, gate, n, refine), (out_f, z0_f, gate_f, n_f, refine_f) in zip(*logs):
        assert torch.equal(out, out_f) and (n, refine) == (n_f, refine_f)
        for a, b in ((z0, z0_f), (gate, gate_f)):
            assert (a is None and b is None) or torch.equal(a, b)
        start = CFG.min_depth if z0 is None else z0
        assert roofline.march_gathers(out, start, gate, n, step, refine) == roofline.march_gathers(
            out_f, start, gate_f, n_f, step, refine_f) > 0
    assert [n for _, _, _, n, _ in logs[0]] == [CFG.num_steps, CFG.refine_steps]


def test_render_model_rgbd_matches_jax(fused):
    jv, pv = fused
    T = POSES[3]
    jd, jg = J.render_model_rgbd(jv, j32(T), JINTR, JCFG)
    pd, pg = P.render_model_rgbd(pv, torch.from_numpy(T), INTR, CFG)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0, atol=1e-5)
    assert (np.asarray(jg) > 0).mean() > 0.25
    with pytest.raises(ValueError, match="with_color"):
        P.render_model_rgbd(P.TsdfVolume(pv.tsdf, pv.weight), torch.from_numpy(T), INTR, CFG)


def test_masked_gradient_matches_jax(fused):
    jv, pv = fused
    seen = np.asarray(jv.weight) > 0
    want = np.asarray(J._masked_gradient(jv.tsdf, jnp.asarray(seen)))
    np.testing.assert_allclose(P._masked_gradient(pv.tsdf, pv.weight > 0).numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["points", "colored", "oriented"])
@pytest.mark.parametrize("capacity", [1024, 65536])
def test_extract_surface_matches_jax(fused, kind, capacity):
    """Same masks and order (the compaction is a stable sort in both), values
    within 1e-6; at 1024 the capacity subsample keeps the same rows."""
    jv, pv = fused
    fn = {"points": "extract_surface", "colored": "extract_surface_colored", "oriented": "extract_surface_oriented"}
    want = getattr(J, fn[kind])(jv, JCFG, capacity)
    got = getattr(P, fn[kind])(pv, CFG, capacity)
    if kind == "points":
        want, got = (want, None), (got, None)
    (wc, wx), (gc, gx) = want, got
    np.testing.assert_array_equal(gc.mask.numpy(), np.asarray(wc.mask))
    assert int(gc.mask.sum()) > 500
    np.testing.assert_allclose(gc.points.numpy(), np.asarray(wc.points), rtol=0, atol=1e-6)
    if wx is not None:
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0, atol=1e-6)


def test_extract_surface_colored_needs_color(fused):
    _, pv = fused
    with pytest.raises(ValueError, match="colored volume"):
        P.extract_surface_colored(P.TsdfVolume(pv.tsdf, pv.weight), CFG)


def test_raycast_of_a_known_wall():
    """A wall at z = 2 m seen head on: the fused volume renders it back to
    within a fraction of a voxel (the geometry oracle of tests/test_tsdf.py)."""
    depth = torch.full((60, 80), 2.0)
    vol = P.init_volume(CFG, device="cpu")
    for _ in range(3):
        P.integrate(vol, depth, torch.eye(4), INTR, CFG)
    out = P.raycast(vol, torch.eye(4), INTR, CFG)
    centre = out[20:40, 30:50]
    assert bool((centre > 0).all())
    assert float((centre - 2.0).abs().max()) < 0.1 * CFG.voxel_size
    assert math.isclose(float(P.march_field(vol).max()), P.UNOBSERVED)


# --- the integrate's brick cull (kernels/tsdf.brick_mask_reference) ------------


def _cull_and_update(depth, color, pose_wc, intr, cfg, x0=0, nx=None, gate=None, start=None, fits=None):
    """(the twin's brick mask, the bricks _fuse_block's predicate updates):
    the update on a copy whose weights are zero, where every updated voxel
    changes weight."""
    from realsensetracker_tpu_torch.kernels import tsdf as K

    v = cfg.resolution
    nx = v if nx is None else nx
    depth = torch.as_tensor(depth, dtype=torch.float32)
    pcw = P.se3.inverse(torch.as_tensor(pose_wc, dtype=torch.float32)).contiguous()
    vol = P.TsdfVolume(torch.ones((nx, v, v)), torch.zeros((nx, v, v)),
                       *((torch.zeros((nx, v, v, 3)), torch.zeros((nx, v, v))) if color is not None else ()))
    K.fuse_block_reference(vol, depth, color, pcw, intr, cfg, gate, start, fits, x0)
    if color is not None:
        assert not bool(((vol.color_weight > 0) & ~(vol.weight > 0)).any())  # color fuses over a subset
    one = lambda t: None if t is None else t[None]  # noqa: E731
    mask = K.brick_mask_reference(pcw[None], intr, cfg, K.depth_tiles_reference(depth[None], cfg), *depth.shape,
                                  x0, nx, one(gate), one(start), one(fits))[0]
    return mask, K.bricks_holding(vol.weight > 0)


@st.composite
def _cull_cases(draw):
    v = draw(st.sampled_from([40, 48, 96]))
    cfg = P.TsdfConfig(**{**tests_torch_parity.DENSE_VOL, "resolution": v, "voxel_size": 2.4 / v})
    lo, ext = np.array(cfg.origin), 2.4
    unit = st.floats(-1.0, 1.0)
    axis = draw(st.integers(0, 5))
    forward = np.eye(3)[axis % 3] * (1 if axis < 3 else -1)
    where = draw(st.sampled_from(["inside", "outside", "graze"]))
    if where == "inside":
        pos = lo + ext * (0.5 + 0.45 * np.array([draw(unit) for _ in range(3)]))
    elif where == "outside":
        d = np.array([draw(unit) for _ in range(3)]) + 1e-3
        pos = lo + ext * 0.5 + ext * draw(st.floats(0.6, 2.0)) * d / np.linalg.norm(d)
    else:  # on a face's plane (+- 2 voxels), looking along the face
        face = draw(st.integers(0, 5))
        pos = lo + ext * (0.5 + 0.6 * np.array([draw(unit) for _ in range(3)]))
        pos[face % 3] = lo[face % 3] + ext * (face >= 3) + draw(st.floats(-2.0, 2.0)) * cfg.voxel_size
        forward = np.eye(3)[(face + 1 + draw(st.integers(0, 1))) % 3] * (1 if draw(st.booleans()) else -1)
    if draw(st.booleans()):  # tilted off the axis
        forward = forward + draw(st.floats(0.0, 0.8)) * np.array([draw(unit) for _ in range(3)])
    h, w = draw(st.sampled_from([(48, 64), (29, 37)]))
    fx = draw(st.floats(30.0, 90.0))
    intr = P.camera.Intrinsics(fx=fx, fy=fx * draw(st.floats(0.8, 1.25)), cx=(w - 1) / 2 + draw(st.floats(-6, 6)),
                               cy=(h - 1) / 2 + draw(st.floats(-6, 6)), width=w, height=h)
    pose_wc = look_at(forward, pos)
    rng = np.random.RandomState(draw(st.integers(0, 2**31 - 1)))
    if draw(st.booleans()):
        depth = render(intr, pose_wc[None], seed=int(rng.randint(100)))[0]
    else:
        depth = rng.uniform(0.01, 1.3 * cfg.max_depth, (h, w)).astype(np.float32)
    for bad in (0.0, np.nan, np.inf, 2.0 * cfg.max_depth):  # holes, NaN, inf, beyond max_depth
        depth[rng.rand(h, w) < draw(st.sampled_from([0.0, 0.1, 0.5]))] = bad
    x0, nx = 0, v
    if draw(st.booleans()):  # an x-slab off the brick boundaries
        x0 = draw(st.integers(0, v - 1))
        nx = draw(st.integers(1, v - x0))
    start = fits = None
    if draw(st.booleans()):
        size = draw(st.integers(1, v - 1))
        cfg = cfg._replace(integrate_slab=size)
        start = torch.tensor([draw(st.integers(0, v - size)) for _ in range(3)], dtype=torch.int32)
        fits = torch.tensor(draw(st.booleans()))
    color = torch.from_numpy(rng.rand(h, w, 3).astype(np.float32)) if draw(st.booleans()) else None
    gate = torch.tensor(draw(st.sampled_from([True, True, True, False])))
    return depth, color, pose_wc, intr, cfg, x0, nx, gate, start, fits


@settings(max_examples=60, deadline=None, derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(_cull_cases())
def test_brick_cull_is_sound(case):
    """No voxel that _fuse_block's predicate updates (behind the gate and
    the slab window) lies in a brick the cull's plain twin drops: poses
    inside, outside and on the faces of the volume, along the axes and
    tilted, frames rendered or random with holes, NaN, inf and depth past
    max_depth, V = 40, 48, 96, x-slabs, windows and colored volumes."""
    depth, color, pose_wc, intr, cfg, x0, nx, gate, start, fits = case
    mask, updated = _cull_and_update(depth, color, pose_wc, intr, cfg, x0, nx, gate, start, fits)
    assert not bool((updated & ~mask).any()), f"{int((updated & ~mask).sum())} updated bricks culled"
    if not bool(gate):
        assert not bool(mask.any())


@pytest.mark.parametrize("bad", [0.0, float("nan"), 20.0, "pose"])
def test_brick_cull_of_a_frame_without_valid_depth(bad):
    """A frame with no valid depth (0, NaN, beyond max_depth) or a
    non-finite pose updates nothing and the cull drops every brick."""
    from realsensetracker_tpu_torch.kernels import tsdf as K

    depth = np.full((60, 80), 2.0 if bad == "pose" else bad, np.float32)
    pose_wc = POSES[0].copy()
    if bad == "pose":
        pose_wc[0, 1] = np.nan
    else:
        assert not bool(K.depth_tiles_reference(torch.from_numpy(depth)[None], CFG).isfinite().any())
    mask, updated = _cull_and_update(depth, None, pose_wc, INTR, CFG)
    assert not bool(mask.any()) and not bool(updated.any())


def test_depth_tiles_reference():
    from realsensetracker_tpu_torch.kernels import tsdf as K

    rng = np.random.RandomState(5)
    d = rng.uniform(0.0, 6.0, (2, 37, 50)).astype(np.float32)
    d[0, :16, :16] = np.nan
    d[1, 20:, 48:] = 0.0
    got = K.depth_tiles_reference(torch.from_numpy(d), CFG).numpy()
    assert got.shape == (2, 3, 4)
    for s in range(2):
        for ty in range(3):
            for tx in range(4):
                blk = d[s, 16 * ty : 16 * ty + 16, 16 * tx : 16 * tx + 16]
                ok = blk[np.isfinite(blk) & (blk > CFG.min_depth) & (blk < CFG.max_depth)]
                assert got[s, ty, tx] == (ok.max() if ok.size else -np.inf)


def test_brick_cull_removes_half_the_bricks():
    """On synthetic.render_trajectory's 640x480 frames into the default
    128^3 volume the cull drops more than half of the bricks, and stays
    sound there."""
    from realsensetracker_tpu_torch.data import synthetic

    cfg = P.TsdfConfig()
    depths, poses = synthetic.render_trajectory(P.camera.TUM_FR1, 3, seed=0)
    for d, T in zip(depths, poses):
        mask, updated = _cull_and_update(d, None, T, P.camera.TUM_FR1, cfg)
        assert not bool((updated & ~mask).any())
        assert mask.float().mean().item() < 0.5 and bool(updated.any())


@pytest.mark.parametrize("v", [40, 48, 96])
def test_brick_cull_is_sound_on_adversarial_poses(v):
    """torch_parity.adversarial_poses (brick corners and faces along the axes,
    grazing, outside looking in, tilted) with the scene rendered and 5% of
    the pixels holes or NaN: no updated voxel in a culled brick."""
    cfg = P.TsdfConfig(**{**tests_torch_parity.DENSE_VOL, "resolution": v, "voxel_size": 2.4 / v})
    _, intr = intrinsics(48, 64, 48.0)
    rng = np.random.RandomState(v)
    poses = adversarial_poses(cfg, 16, seed=v)
    depths = render(intr, poses, seed=3)
    for d, T in zip(depths, poses):
        d[rng.rand(*d.shape) < 0.05] = rng.choice([0.0, np.nan])
        mask, updated = _cull_and_update(d, None, T, intr, cfg)
        assert not bool((updated & ~mask).any())
