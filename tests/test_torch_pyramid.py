"""Parity of the port's pyramid and level builder with the JAX package.

The plain torch level builder is held against JAX's Pallas kernel (in
interpret mode) and against JAX build_pyramid(use_kernel=False), at atol
2e-5 with the validity pattern exact (tests/test_kernels.py,
tests/test_tpu_gated.py). The same numpy arrays, pinned to f32, feed both
sides. The CUDA kernel's own tests are in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.geometry import camera as jcam
from realsensetracker_tpu.kernels import level_kernel as jlk
from realsensetracker_tpu.ops import pyramid as jpyr
from realsensetracker_tpu_torch.kernels import level_kernel
from realsensetracker_tpu_torch.ops import normals, pyramid
from tests.torch_parity import intrinsics, render

ATOL = 2e-5  # f32 normalization rounding, as tests/test_kernels.py:29

# (height, width, fx, fy): the shapes of tests/test_kernels.py, including
# the 36- and 482-row heights, plus odd dims whose halving floors.
SHAPES = [
    (64, 128, 100.0, 100.0),
    (36, 128, 50.0, 50.0),
    (482, 64, 60.0, 60.0),
    (61, 83, 70.0, 70.0),
]


# One compiled program per call signature: much faster than eager op-by-op.
# Single-level only: under jit XLA rewrites the pooling's division, and the
# coarser levels then drift from eager JAX by ~4e-5 in the normals.
_jax_pyramid = jax.jit(
    jpyr.build_pyramid, static_argnums=(1, 2), static_argnames=("with_normals", "use_kernel")
)


def _depth(intr, seed):
    """One frame of the seed's scene with holes punched in it."""
    d = render(intr, np.eye(4, dtype=np.float32)[None], seed)[0]
    rng = np.random.RandomState(seed)
    d[rng.rand(*d.shape) < 0.05] = 0.0
    d[10:14, 20:30] = 0.0
    return d


def _masked(d):
    return np.where((d > 0.05) & (d < 10.0), d, 0.0).astype(np.float32)


def _assert_plane_tables(got, ref):
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_array_equal(np.abs(got[..., :3, :, :]).sum(-3) > 0, np.abs(ref[..., :3, :, :]).sum(-3) > 0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_reference_matches_jax_pallas_interpret(shape):
    jintr, intr = intrinsics(*shape)
    d = _masked(_depth(intr, seed=3))
    ref = np.asarray(jlk.build_level_packed(jnp.asarray(d), jintr, tile_h=16, interpret=True))
    got = level_kernel.build_level_packed_reference(torch.from_numpy(d)[None], intr)[0].numpy()
    _assert_plane_tables(got, ref)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_wrapper_on_cpu_matches_jax_xla_pyramid(shape):
    jintr, intr = intrinsics(*shape)
    d = _depth(intr, seed=4)
    levels, _ = _jax_pyramid(jnp.asarray(d), jintr, 1, use_kernel=False)
    before = level_kernel.LAUNCHES
    got = level_kernel.build_level_packed(torch.from_numpy(_masked(d))[None], intr)[0].numpy()
    assert level_kernel.LAUNCHES == before  # the CPU path launches nothing
    _assert_plane_tables(got, np.asarray(levels[0].packed))


@pytest.mark.parametrize(
    "jax_fn", [jlk.build_level_packed_batched, jlk.build_level_packed_rows], ids=["batched", "rows"]
)
def test_reference_matches_jax_batched_variants(jax_fn):
    """The TPU's batched-grid and boundary-row probes compute the same
    table; the port's one batched kernel (held against this plain version
    on the card) covers both."""
    jintr, intr = intrinsics(*SHAPES[0])
    d = np.stack([_masked(_depth(intr, seed=s)) for s in (3, 4, 5)])
    ref = np.asarray(jax_fn(jnp.asarray(d), jintr, tile_h=16, interpret=True))
    got = level_kernel.build_level_packed_reference(torch.from_numpy(d), intr).numpy()
    _assert_plane_tables(got, ref)


@pytest.mark.parametrize("with_normals", [True, False])
@pytest.mark.parametrize("shape", SHAPES[2:], ids=lambda s: f"{s[0]}x{s[1]}")
def test_build_pyramid_matches_jax(shape, with_normals):
    jintr, intr = intrinsics(*shape)
    ds = np.stack([_depth(intr, seed=s) for s in (5, 6)])
    got, got_intrs = pyramid.build_pyramid(torch.from_numpy(ds), intr, 3, with_normals=with_normals)
    for b in range(2):
        ref, _ = jpyr.build_pyramid(jnp.asarray(ds[b]), jintr, 3, with_normals=with_normals, use_kernel=False)
        assert [tuple(i) for i in got_intrs] == [tuple(i) for i in jpyr.level_intrinsics(jintr, 3)]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.valid[b].numpy(), np.asarray(r.valid))
            np.testing.assert_array_equal(g.vertex_valid[b].numpy(), np.asarray(r.vertex_valid))
            np.testing.assert_allclose(g.vertex_map[b].numpy(), np.asarray(r.vertex_map), atol=1e-6)
            np.testing.assert_allclose(g.normal_map[b].numpy(), np.asarray(r.normal_map), atol=ATOL)
            np.testing.assert_allclose(g.packed[b].numpy(), np.asarray(r.packed), atol=ATOL)


def test_grid_normals_matches_jax():
    from realsensetracker_tpu.ops import normals as jnorm

    jintr, intr = intrinsics(*SHAPES[0])
    d = _masked(_depth(intr, seed=7))
    vmap = jcam.unproject_depth(jnp.asarray(d), jintr)
    ref_n, ref_ok = jnorm.grid_normals(vmap, jnp.asarray(d > 0))
    got_n, got_ok = normals.grid_normals(torch.tensor(np.asarray(vmap)), torch.from_numpy(d > 0))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(ref_n), atol=ATOL)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 4)])
def test_downsample_depth_matches_jax(hw):
    rng = np.random.RandomState(sum(hw))
    d = (rng.rand(2, *hw) * 3).astype(np.float32)
    valid = rng.rand(2, *hw) > 0.3
    got_d, got_v = pyramid.downsample_depth(torch.from_numpy(d), torch.from_numpy(valid))
    ref_d, ref_v = jpyr.downsample_depth(jnp.asarray(d), jnp.asarray(valid))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-6)


def test_level_intrinsics_floor_odd_dims():
    jintr, intr = intrinsics(487, 641, 100.0, 100.0)
    got = pyramid.level_intrinsics(intr, 4)
    ref = jpyr.level_intrinsics(jintr, 4)
    assert [tuple(i) for i in got] == [tuple(i) for i in ref]
    assert got[1].height == 243 and got[1].width == 320


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_depth_to_meters_matches_jax(dtype):
    raw = (np.arange(12).reshape(3, 4) * 700).astype(dtype)
    got = pyramid.depth_to_meters(torch.from_numpy(raw.astype(np.int32) if dtype == np.uint16 else raw), 2e-4)
    ref = jpyr.depth_to_meters(jnp.asarray(raw), 2e-4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_use_kernel_true_on_cpu_raises():
    _, intr = intrinsics(*SHAPES[0])
    with pytest.raises(ValueError, match="CUDA"):
        pyramid.build_pyramid(torch.ones(1, 64, 128), intr, 1, use_kernel=True)


@pytest.mark.parametrize(
    "bad, err",
    [
        (torch.ones(64, 128), ValueError),  # 2-D
        (torch.ones(1, 64, 128, dtype=torch.float64), TypeError),
        (torch.ones(1, 128, 64).transpose(1, 2), ValueError),  # non-contiguous
        (torch.ones(1, 32, 128), ValueError),  # shape != intrinsics
    ],
    ids=["2d", "f64", "noncontiguous", "wrong-shape"],
)
def test_wrapper_rejects_bad_input(bad, err):
    _, intr = intrinsics(*SHAPES[0])
    with pytest.raises(err):
        level_kernel.build_level_packed(bad, intr)
