"""Parity of the port's ops.sampling with the JAX package, on the same f32
numpy inputs.

bilinear_sample's values agree to 1e-6 and its forward-mode derivatives in
u and v to 1e-6, including points that land exactly on the first or last
column or row: there jnp.clip's derivative is 0.5 (lax.max / lax.min split
a tie) where torch.clamp's would be 1. image_gradients agrees exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from realsensetracker_tpu.ops import sampling as jsampling
from realsensetracker_tpu_torch.ops import sampling
from tests.torch_parity import j32

H, W = 12, 17
TOL = 1e-6


def _image(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "gray":
        return rng.rand(H, W).astype(np.float32)
    if kind == "rgb":
        return rng.rand(H, W, 3).astype(np.float32)
    return rng.randint(0, 256, size=(H, W)).astype(np.uint8)


def _coords(seed=1, n=64):
    """Random coordinates over and beyond the image, and the exact edges."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(-2.0, W + 1.0, n).astype(np.float32)
    v = rng.uniform(-2.0, H + 1.0, n).astype(np.float32)
    edges_u = np.array([0.0, W - 1.0, 3.25, 0.0, W - 1.0, 5.0, 5.5, W - 1.0], np.float32)
    edges_v = np.array([4.5, 2.0, 0.0, H - 1.0, H - 1.0, 7.0, H - 1.0, 0.0], np.float32)
    return np.concatenate([u, edges_u]), np.concatenate([v, edges_v])


@pytest.mark.parametrize("kind", ["gray", "rgb", "uint8"])
def test_bilinear_sample_matches_jax(kind):
    img = _image(kind)
    u, v = _coords()
    got, ok = sampling.bilinear_sample(torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v))
    ref, jok = jsampling.bilinear_sample(jnp.asarray(img), j32(u), j32(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_bilinear_sample_batched_samples_each_image():
    imgs = np.stack([_image("gray", s) for s in range(3)])
    u, v = _coords()
    us, vs = np.stack([u, u[::-1], u]), np.stack([v, v, v[::-1]])
    got, ok = sampling.bilinear_sample(torch.from_numpy(imgs), torch.from_numpy(us), torch.from_numpy(vs),
                                       batched=True)
    for b in range(3):
        ref, rok = sampling.bilinear_sample(torch.from_numpy(imgs[b]), torch.from_numpy(us[b]),
                                            torch.from_numpy(vs[b]))
        assert torch.equal(got[b], ref) and torch.equal(ok[b], rok)


@pytest.mark.parametrize("where", ["interior", "first_column", "last_column", "first_row", "last_row"])
def test_bilinear_jacobian_matches_jax(where):
    """d value / d (u, v) by forward-mode AD on both sides, at points built
    to land exactly on an edge (the tie of the clip)."""
    img = _image("gray")
    u, v = {
        "interior": ([3.3, 10.75], [2.5, 8.125]),
        "first_column": ([0.0, 0.0], [3.5, 0.0]),
        "last_column": ([W - 1.0, W - 1.0], [6.25, H - 1.0]),
        "first_row": ([4.5, 11.0], [0.0, 0.0]),
        "last_row": ([2.75, 9.0], [H - 1.0, H - 1.0]),
    }[where]
    uv = np.stack([np.float32(u), np.float32(v)])

    def port(t):
        return sampling.bilinear_sample(torch.from_numpy(img), t[0], t[1])[0]

    def ref(t):
        return jsampling.bilinear_sample(jnp.asarray(img), t[0], t[1])[0]

    J = jacfwd(port)(torch.from_numpy(uv))
    Jj = jax.jacfwd(ref)(j32(uv))
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), rtol=TOL, atol=TOL)
    assert np.abs(np.asarray(Jj)).max() > 0


def test_clip_derivative_is_half_at_the_edges():
    x = torch.tensor([0.0, 2.0, 5.0, -1.0, 6.0])
    d = torch.diagonal(jacfwd(lambda t: sampling._clip(t, 0.0, 5.0))(x))
    assert d.tolist() == [0.5, 1.0, 0.5, 0.0, 0.0]
    dj = jnp.diagonal(jax.jacfwd(lambda t: jnp.clip(t, 0.0, 5.0))(j32(x.numpy())))
    assert np.asarray(dj).tolist() == d.tolist()


@pytest.mark.parametrize("kind", ["gray", "ramp"])
def test_image_gradients_match_jax_exactly(kind):
    img = _image("gray") if kind == "gray" else np.tile(np.arange(W, dtype=np.float32) * 0.5, (H, 1))
    gx, gy = sampling.image_gradients(torch.from_numpy(img))
    jgx, jgy = jsampling.image_gradients(jnp.asarray(img))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jgy))
