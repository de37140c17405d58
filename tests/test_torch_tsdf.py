"""Parity of the port's TSDF volume (realsensetracker_tpu_torch/mapping/tsdf.py)
with the JAX package's jitted functions, on the CPU (the kernels run their
plain torch versions there).

Inputs: the spheres of torch_parity.scene rendered by the port at 80x60,
fed to both sides as f32 numpy frames, into the 48^3 x 5 cm volume of
tests/test_submaps.py:30-32. Bars: integrate (full, slab, colored) tsdf and
color within 1e-6 with weights and update masks equal; raycast (full and
coarse-to-fine) hit masks equal and depth within 1e-5; render_model_rgbd
within 1e-5; the three surface extractions with equal masks and order and
values within 1e-6 on the same volume.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.mapping import tsdf as J
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.mapping import tsdf as P
from tests.torch_parity import dense_configs, intrinsics, j32, render_rgbd, volumes_close, walk

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
