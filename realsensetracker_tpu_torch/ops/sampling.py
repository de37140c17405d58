"""Differentiable bilinear image sampling.

Port of realsensetracker_tpu/ops/sampling.py. torch.func differentiates
through the bilinear weights, which is what the photometric term
(align/photometric.py, align/rgbd.py) needs.
"""

from __future__ import annotations

import torch


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """x clipped to [lo, hi] with jnp.clip's derivative: min(max(x, lo), hi)
    splits a tie, so the derivative is 0.5 at exactly lo or hi, as JAX's
    lax.max / lax.min give (torch.clamp gives 1 there). A point that
    projects exactly onto the first or last row or column is in bounds, so
    its Jacobian row depends on it. The bounds are 0-d CPU tensors, which
    a CUDA operation takes as scalars, with no copy."""
    return torch.minimum(torch.maximum(x, torch.tensor(lo, dtype=x.dtype)), torch.tensor(hi, dtype=x.dtype))


def bilinear_sample(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor, batched: bool = False):
    """Sample image at float pixel coordinates (u, v).

    image is (H, W) or (H, W, C), with u and v of any one shape; or, with
    ``batched=True``, (B, H, W) with u and v of shape (B, ...), row b of
    u, v sampling image b. Returns (values, in_bounds_mask). Out-of-bounds
    samples clamp to the edge and are flagged invalid. Differentiable in u
    and v. Integer images are sampled with f32 weights.
    """
    h, w = (image.shape[1], image.shape[2]) if batched else (image.shape[0], image.shape[1])
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    uc = _clip(u, 0.0, w - 1.0)
    vc = _clip(v, 0.0, h - 1.0)
    u0 = torch.clamp(torch.floor(uc), 0, w - 2).long()
    v0 = torch.clamp(torch.floor(vc), 0, h - 2).long()
    # Weights stay FLOAT: casting them to an integer image's dtype would
    # truncate every fraction to 0.
    wdtype = image.dtype if image.is_floating_point() else torch.float32
    du = (uc - u0).to(wdtype)
    dv = (vc - v0).to(wdtype)
    image = image.to(wdtype)

    if batched:
        b = image.shape[0]
        flat = image.reshape(b, h * w)

        def at(vi, ui):
            return torch.gather(flat, 1, (vi * w + ui).reshape(b, -1)).reshape(vi.shape)
    else:

        def at(vi, ui):
            return image[vi, ui]

    i00 = at(v0, u0)
    i01 = at(v0, u0 + 1)
    i10 = at(v0 + 1, u0)
    i11 = at(v0 + 1, u0 + 1)
    if image.dim() == 3 and not batched:
        du = du[..., None]
        dv = dv[..., None]
    top = i00 * (1.0 - du) + i01 * du
    bot = i10 * (1.0 - du) + i11 * du
    return top * (1.0 - dv) + bot * dv, inb


def image_gradients(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (gx, gy) of an (H, W) image, zero on the
    border columns (gx) and rows (gy)."""
    gx = 0.5 * (torch.roll(image, -1, dims=1) - torch.roll(image, 1, dims=1))
    gy = 0.5 * (torch.roll(image, -1, dims=0) - torch.roll(image, 1, dims=0))
    gx[:, 0] = 0.0
    gx[:, -1] = 0.0
    gy[0, :] = 0.0
    gy[-1, :] = 0.0
    return gx, gy
