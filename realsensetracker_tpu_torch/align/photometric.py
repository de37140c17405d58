"""Photometric (direct) alignment: intensity residuals over projected points.

Port of realsensetracker_tpu/align/photometric.py, batched over a leading
B:

    r_i(xi) = I_dst( project(exp(xi) T p_i) ) - I_src(p_i's pixel)

with bilinear sampling (ops/sampling.py) and the (P, 6) Jacobian of each
pair by torch.func.jacfwd through the twist's action on the points, the
projection AND the bilinear interpolation, solved by damped Gauss-Newton
with Huber weights. JAX's fori_loop is a Python loop whose pose stays on
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.ops.sampling import bilinear_sample


class PhotometricConfig(NamedTuple):
    iters: int = 10
    samples: int = 2048
    huber_delta: float = 0.1  # intensity units
    damping: float = 1e-5
    min_depth: float = 0.05


class PhotometricResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4)
    rmse: torch.Tensor  # (B,) weighted intensity RMSE at the returned transform
    num_valid: torch.Tensor  # (B,) valid source points


def photometric_residuals(T, src_pts, src_intensity, dst_image, intr: camera.Intrinsics, min_depth: float = 0.05):
    """Residuals r (B,P) and validity of points src_pts (B,P,3) moved by
    T (B,4,4) (or one (1,4,4) for all) into dst_image (B,H,W). A projection
    whose transformed depth is at or below min_depth is invalid."""
    return residuals_at(se3.transform_points(T, src_pts), src_intensity, dst_image, intr, min_depth)


def residuals_at(p, src_intensity, dst_image, intr: camera.Intrinsics, min_depth: float = 0.05):
    """photometric_residuals of points p (B,P,3) already in the destination
    camera's frame."""
    u, v, z = camera.project(p, intr)
    vals, inb = bilinear_sample(dst_image, u, v, batched=True)
    ok = inb & (z > min_depth)
    return torch.where(ok, vals - src_intensity, 0.0), ok


def huber_weight(r, delta):
    """IRLS weight of the Huber loss on a plain residual (shared by the
    standalone photometric aligner and the joint RGB-D term). delta is a
    0-d tensor in the quotient: a Python number would make it
    reciprocal(a) * delta, an ulp away from JAX's division."""
    a = r.abs()
    return torch.where(a <= delta, 1.0, torch.tensor(delta, dtype=a.dtype) / torch.clamp(a, min=1e-30))


def twist_jacobian(residual, q):
    """(J (B,P,6), aux) of residual(p) = (r (B,P), aux) with respect to the
    left twist tw = [v, w] that moves the points q (B,P,3) = T src to
    exp(tw) q, at tw = 0, by forward-mode AD; aux is residual's second
    output at q.

    The twist acts to first order, q + v + w x q: that is exp(tw) q's
    derivative at 0 exactly (JAX's jacfwd through se3.exp, whose Taylor
    branch there gives the same tangents), for far fewer operations than
    differentiating the exponential and the composition. One (1, 6) twist
    moves every pair (the B poses are independent), so row b of the
    Jacobian is pair b's own."""
    zero = torch.zeros((1, 6), dtype=q.dtype, device=q.device)

    def moved(tw):
        w = tw[:, None, 3:].expand_as(q)
        return residual(q + tw[:, None, :3] + torch.linalg.cross(w, q, dim=-1))

    J, aux = jacfwd(moved, has_aux=True)(zero)
    return J.reshape(*J.shape[:2], 6), aux


def gn_delta(H, g, damping: float):
    """The damped GN step -solve(H + lam I, g), lam = damping trace(H) +
    1e-12, per pair; 0 where the solve fails or leaves a non-finite step.
    solve_ex neither raises nor synchronizes on a singular system."""
    lam = damping * H.diagonal(dim1=-2, dim2=-1).sum(-1) + 1e-12
    x, info = torch.linalg.solve_ex(H + lam[:, None, None] * torch.eye(6, dtype=H.dtype, device=H.device), g)
    delta = -x
    good = torch.isfinite(delta).all(-1) & (info == 0)
    return torch.where(good[:, None], delta, 0.0)


def weighted_system(J, r, w):
    """(J^T W J (B,6,6), J^T W r (B,6)) in true f32."""
    Jw = J * w[..., None]
    Jt = Jw.transpose(1, 2)
    return torch.matmul(Jt, J), torch.matmul(Jt, r[..., None])[..., 0]


def align_photometric(
    src_pts: torch.Tensor,  # (B, P, 3) source points (camera frame)
    src_intensity: torch.Tensor,  # (B, P) intensities at those points
    src_ok: torch.Tensor,  # (B, P) validity
    dst_image: torch.Tensor,  # (B, H, W) destination intensity images
    intr: camera.Intrinsics,
    init_transform: torch.Tensor | None = None,
    cfg: PhotometricConfig = PhotometricConfig(),
) -> PhotometricResult:
    """Direct image alignment of sampled source points onto dst_image."""
    src_pts = src_pts.to(torch.float32)
    src_intensity = src_intensity.to(torch.float32)
    dst_image = dst_image.to(torch.float32)
    b, dev = src_pts.shape[0], src_pts.device
    if init_transform is None:
        T = se3.identity(device=dev).expand(b, 4, 4)
    else:
        T = init_transform.to(device=dev, dtype=torch.float32).expand(b, 4, 4)

    def weighted(p):
        r, ok = residuals_at(p, src_intensity, dst_image, intr, cfg.min_depth)
        return r, huber_weight(r, cfg.huber_delta) * (ok & src_ok).to(r.dtype)

    def residual(p):
        r, w = weighted(p)
        return r, (r, w)

    for _ in range(cfg.iters):
        J, (r, w) = twist_jacobian(residual, se3.transform_points(T, src_pts))
        H, g = weighted_system(J, r, w)
        T = se3.compose(se3.exp(gn_delta(H, g, cfg.damping)), T)
    # Final statistics AT the returned transform.
    r, w = weighted(se3.transform_points(T, src_pts))
    rmse = torch.sqrt((w * r * r).sum(-1) / torch.clamp(w.sum(-1), min=1e-12))
    return PhotometricResult(transform=T, rmse=rmse, num_valid=src_ok.sum(-1))


def sample_intensity_points(depth, gray, intr: camera.Intrinsics, count: int, min_depth=0.05, max_depth=10.0):
    """Stride-sample (points (B,P,3), intensities (B,P), ok (B,P)) from
    depth and gray batches (B,H,W): align.rgbd.sample_depth_gray_points."""
    from realsensetracker_tpu_torch.align.rgbd import sample_depth_gray_points

    return sample_depth_gray_points(depth, gray, intr, count, min_depth, max_depth)
