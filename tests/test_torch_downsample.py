"""Parity of the port's pyramid downsample with the JAX package.

``downsample_levels_reference`` (the plain version of the CUDA kernel in
csrc/downsample.cu) is held to JAX ``downsample_depth`` applied level
after level, on masked frames with holes: validity identical, depth exact
or within 2 ulp. The port sums the four children row pairs first,
(a00 + a01) + (a10 + a11), and divides by the count in f32. XLA on the CPU
takes that order when the width is a power of two (482x64, 36x128: exact
there) and the left fold ((a00 + a01) + a10) + a11 otherwise (75x100,
90x120 and the 640x480 level shapes): the sums then differ by an ulp, which
the divide by a count of 3 can stretch to 2 ulp of the mean. The kernel itself is held to this plain version in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.ops import pyramid as jpyr
from realsensetracker_tpu_torch.kernels import downsample
from realsensetracker_tpu_torch.ops import pyramid
from tests.torch_parity import intrinsics, render

# (height, width): odd heights of tests/test_kernels.py and two frame sizes
# whose halving floors an odd dimension.
SHAPES = [(482, 64), (36, 128), (75, 100), (90, 120)]
PAIRED_ROWS = {(482, 64), (36, 128)}  # XLA sums in the port's order here (docstring)


def _frames(h, w, b=3, seed=0):
    """b masked frames (0 = invalid) with 5% holes and a hole block."""
    _, intr = intrinsics(h, w, 0.8 * w)
    poses = np.stack([np.eye(4, dtype=np.float32)] * b)
    poses[:, 0, 3] = np.linspace(0.0, 0.1, b)
    d = render(intr, poses, seed)
    rng = np.random.RandomState(seed)
    d[rng.rand(*d.shape) < 0.05] = 0.0
    d[:, 4:9, 3:12] = 0.0
    return np.where((d > 0.05) & (d < 10.0), d, 0.0).astype(np.float32)


def _jax_chain(d, num_levels):
    jd, jv = jnp.asarray(d), jnp.asarray(d > 0)
    out = []
    for _ in range(num_levels - 1):
        jd, jv = jpyr.downsample_depth(jd, jv)
        out.append((np.asarray(jd), np.asarray(jv)))
    return out


@pytest.mark.parametrize("num_levels", [2, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_reference_matches_jax_chained(shape, num_levels):
    d = _frames(*shape)
    got = downsample.downsample_levels_reference(torch.from_numpy(d), num_levels)
    ref = _jax_chain(d, num_levels)
    assert len(got) == len(ref) == num_levels - 1
    for (gd, gv), (rd, rv) in zip(got, ref):
        assert gd.shape == rd.shape and gd.dtype == torch.float32 and gv.dtype == torch.bool
        np.testing.assert_array_equal(gv.numpy(), rv)
        if shape in PAIRED_ROWS:
            np.testing.assert_array_equal(gd.numpy(), rd)
        else:
            np.testing.assert_array_max_ulp(gd.numpy(), rd, maxulp=2)


@pytest.mark.parametrize("num_levels", [1, 3])
def test_wrapper_on_cpu_runs_the_reference_without_a_launch(num_levels):
    d = torch.from_numpy(_frames(75, 100))
    before = downsample.LAUNCHES
    got = downsample.downsample_levels(d, num_levels, min_depth=0.05)
    assert downsample.LAUNCHES == before
    ref = downsample.downsample_levels_reference(d, num_levels)
    assert len(got) == num_levels - 1
    for (gd, gv), (rd, rv) in zip(got, ref):
        assert torch.equal(gd, rd) and torch.equal(gv, rv)


def test_level_shapes_floor():
    assert downsample.level_shapes(482, 64, 4) == [(241, 32), (120, 16), (60, 8)]
    assert downsample.level_shapes(75, 101, 3) == [(37, 50), (18, 25)]
    assert downsample.level_shapes(8, 8, 1) == []


def test_validity_is_depth_above_zero():
    """The kernel reads validity as depth > 0: true of every level when the
    input was masked with min_depth >= 0."""
    for d, v in downsample.downsample_levels_reference(torch.from_numpy(_frames(90, 120)), 4):
        assert torch.equal(v, d > 0)


@pytest.mark.parametrize(
    "bad, err",
    [
        (lambda: downsample.downsample_levels(torch.zeros(8, 8), 2), ValueError),
        (lambda: downsample.downsample_levels(torch.zeros(1, 8, 8, dtype=torch.float64), 2), TypeError),
        (lambda: downsample.downsample_levels(torch.zeros(1, 8, 16)[:, :, ::2], 2), ValueError),
        (lambda: downsample.downsample_levels(torch.zeros(1, 8, 8), 0), ValueError),
        (lambda: downsample.downsample_levels(torch.zeros(1, 8, 8), 2, min_depth=-1.0), ValueError),
    ],
    ids=["not_batched", "float64", "strided", "no_levels", "negative_min_depth"],
)
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        bad()


def test_build_pyramid_coarse_levels_match_jax():
    """build_pyramid's coarse levels now come from downsample_levels: their
    vertex maps and validity equal JAX's exactly (at a width where the two
    sum the children in one order)."""
    jintr, intr = intrinsics(36, 128, 100.0)
    d = _frames(36, 128, b=1)[0]
    got, _ = pyramid.build_pyramid(torch.from_numpy(d)[None], intr, 3, with_normals=False)
    ref, _ = jpyr.build_pyramid(jnp.asarray(d), jintr, 3, with_normals=False)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.vertex_valid[0].numpy(), np.asarray(r.vertex_valid))
        np.testing.assert_array_equal(g.vertex_map[0].numpy(), np.asarray(r.vertex_map))


def test_build_pyramid_rejects_negative_min_depth():
    _, intr = intrinsics(36, 128, 50.0)
    with pytest.raises(ValueError, match="min_depth"):
        pyramid.build_pyramid(torch.ones(1, 36, 128), intr, 2, min_depth=-0.1)
