"""Joint geometric + photometric RGB-D registration (direct odometry).

Port of realsensetracker_tpu/align/rgbd.py, batched over a leading B:

    E(xi) = sum_i w_g(r_g) r_g^2  +  lambda^2 sum_i w_p(r_p) r_p^2
    r_g = n_dst . (T p_i) - d_dst          (point-to-plane, meters)
    r_p = I_dst(project(T p_i)) - i_src    (intensity, [0,1] units)

Both blocks share one source sample set (points + attached intensities)
and reduce into one 6x6 system per Gauss-Newton iteration. The geometric
block is projective.build_normal_equations: on CUDA tensors one launch of
the gn_system kernel per iteration. The photometric block is
torch.func.jacfwd through the twist's action on the points, the
projection and the bilinear sample, plain torch. The destination's plane-table pyramid goes through
ops.pyramid.build_pyramid (the downsample and level kernels on the card),
the source's depth levels through kernels.downsample.downsample_levels;
intensity levels are 2x2 means. Coarse-to-fine, with JAX's fori_loops as
Python loops whose pose stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realsensetracker_tpu_torch.align import photometric, projective
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.kernels import downsample
from realsensetracker_tpu_torch.ops.pyramid import build_pyramid


class RgbdIcpConfig(NamedTuple):
    """Solver configuration, defaults as in the JAX package."""

    iters: tuple[int, ...] = (6, 5, 4)  # per level, coarse -> fine
    samples: int = 2048
    coarse_sample_divisor: int = 4
    min_samples: int = 256
    dist_threshold: float = 0.25
    gnc_mu: float = 1e-2
    damping: float = 1e-6
    min_depth: float = 0.05
    max_depth: float = 10.0
    photo_weight: float = 0.1  # lambda: meters per intensity unit
    photo_huber: float = 0.08  # Huber delta on intensity residuals


class RgbdResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4)
    rmse: torch.Tensor  # (B,) geometric point-to-plane RMSE at the finest level
    photo_rmse: torch.Tensor  # (B,) photometric RMSE at the finest level
    inlier_fraction: torch.Tensor  # (B,)
    num_matched: torch.Tensor  # (B,) int32


def downsample_gray(gray: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling of (..., H, W) intensities; a trailing odd row or
    column is dropped. The four are summed (a00 + a01) + (a10 + a11), on
    every device; XLA's CPU reduce takes another order at some widths, up
    to 2 ulp away (tests/test_torch_rgbd.py)."""
    h, w = gray.shape[-2] // 2 * 2, gray.shape[-1] // 2 * 2
    g = gray[..., :h, :w].reshape(*gray.shape[:-2], h // 2, 2, w // 2, 2)
    return ((g[..., 0, :, 0] + g[..., 0, :, 1]) + (g[..., 1, :, 0] + g[..., 1, :, 1])) / 4.0


def sample_depth_gray_points(
    depth: torch.Tensor,
    gray: torch.Tensor,
    intr: camera.Intrinsics,
    count: int,
    min_depth: float = 0.05,
    max_depth: float = 10.0,
):
    """Stride-sample (points (B,P,3), intensities (B,P), ok (B,P)) straight
    from depth and gray batches (B,H,W), the index pattern of
    projective.sample_depth_points. x and y scale by the f32 reciprocal of
    fx and fy (camera.reciprocal), as the JAX trackers' compiled sampling
    does, on every device."""
    b, h, w = depth.shape
    npix = h * w
    count = min(count, npix)
    stride = npix // count
    idx = torch.arange(count, device=depth.device) * stride
    d = depth.reshape(b, npix)[:, : count * stride : stride]
    i_src = gray.reshape(b, npix)[:, : count * stride : stride]
    ok = torch.isfinite(d) & (d > min_depth) & (d < max_depth)
    d = torch.where(ok, d, 0.0)
    u = (idx % w).to(d.dtype)
    v = (idx // w).to(d.dtype)
    x = d * (u - intr.cx) * camera.reciprocal(intr.fx)
    y = d * (v - intr.cy) * camera.reciprocal(intr.fy)
    return torch.stack([x, y, d], dim=-1), i_src, ok


def _photo_system(T, src_pts, src_inten, src_ok, dst_gray, intr: camera.Intrinsics, cfg: RgbdIcpConfig):
    """Photometric block at T (B,4,4): (H (B,6,6), b (B,6), (wsse (B,),
    wsum (B,))), J by forward-mode AD through the twist's action, the
    projection and the bilinear sample (photometric.twist_jacobian)."""

    def residual(p):
        r, ok = photometric.residuals_at(p, src_inten, dst_gray, intr, cfg.min_depth)
        return r, (r, ok)

    J, (r, ok) = photometric.twist_jacobian(residual, se3.transform_points(T, src_pts))
    w = photometric.huber_weight(r, cfg.photo_huber) * (ok & src_ok).to(r.dtype)
    H, b = photometric.weighted_system(J, r, w)
    return H, b, ((w * r * r).sum(-1), w.sum(-1))


def _icp_config(cfg: RgbdIcpConfig) -> projective.ProjectiveIcpConfig:
    return projective.ProjectiveIcpConfig(
        iters=cfg.iters, samples=cfg.samples, coarse_sample_divisor=cfg.coarse_sample_divisor,
        min_samples=cfg.min_samples, dist_threshold=cfg.dist_threshold, gnc_mu=cfg.gnc_mu,
        damping=cfg.damping, min_depth=cfg.min_depth, max_depth=cfg.max_depth,
    )


def _step(T, sample, dst_level, dst_gray, intr: camera.Intrinsics, cfg: RgbdIcpConfig, icp_cfg):
    """One joint GN iteration: both blocks reduce into one 6x6 solve per
    pair. Returns (T_new, (rmse, photo_rmse, inlier_fraction, matched)),
    the statistics at T."""
    src_pts, src_inten, src_ok = sample
    Hg, bg, (wsse_g, wsum_g, ok_count) = projective.build_normal_equations(
        T, src_pts, src_ok, dst_level, intr, icp_cfg
    )
    Hp, bp, (wsse_p, wsum_p) = _photo_system(T, src_pts, src_inten, src_ok, dst_gray, intr, cfg)
    lam2 = cfg.photo_weight * cfg.photo_weight
    delta = photometric.gn_delta(Hg + lam2 * Hp, bg + lam2 * bp, cfg.damping)
    T_new = se3.compose(se3.exp(delta), T)
    stats = (
        torch.sqrt(wsse_g / (wsum_g + 1e-12)),
        torch.sqrt(wsse_p / (wsum_p + 1e-12)),
        ok_count.to(torch.float32) / src_pts.shape[1],
        ok_count,
    )
    return T_new, stats


def rgbd_icp_sampled(
    src_samples,  # per level (fine -> coarse): (pts (B,P,3), inten (B,P), ok (B,P))
    dst_levels,  # destination plane-table pyramid (fine -> coarse)
    dst_grays,  # destination intensity pyramid (fine -> coarse), (B,H_l,W_l)
    intrs: tuple[camera.Intrinsics, ...],
    init_transform: torch.Tensor | None = None,
    cfg: RgbdIcpConfig = RgbdIcpConfig(),
) -> RgbdResult:
    """Coarse-to-fine joint RGB-D alignment of pre-sampled source points.
    ``init_transform`` is (4,4) or (B,4,4). The statistics are taken at the
    returned transform on the finest level, by one more joint step whose
    update is dropped (tracking/rgbd.py's gate reads them)."""
    num_levels = len(intrs)
    if len(cfg.iters) != num_levels:
        raise ValueError(f"cfg.iters has {len(cfg.iters)} entries for {num_levels} levels")
    packed = dst_levels[0].packed
    batch, device = packed.shape[0], packed.device
    if init_transform is None:
        T = se3.identity(device=device).expand(batch, 4, 4).contiguous()
    else:
        T = init_transform.to(device=device, dtype=torch.float32).expand(batch, 4, 4).contiguous()
    icp_cfg = _icp_config(cfg)
    for li in range(num_levels - 1, -1, -1):  # coarse -> fine
        for _ in range(cfg.iters[num_levels - 1 - li]):
            T, _ = _step(T, src_samples[li], dst_levels[li], dst_grays[li], intrs[li], cfg, icp_cfg)
    _, (rmse, photo_rmse, frac, matched) = _step(
        T, src_samples[0], dst_levels[0], dst_grays[0], intrs[0], cfg, icp_cfg
    )
    return RgbdResult(transform=T, rmse=rmse, photo_rmse=photo_rmse, inlier_fraction=frac, num_matched=matched)


def build_rgbd_target(depth, gray, intr: camera.Intrinsics, cfg: RgbdIcpConfig = RgbdIcpConfig()):
    """Destination side of B frames (B,H,W): (plane-table levels, gray
    levels (B,H_l,W_l), intrs), fine to coarse, for cfg fitted to the
    frame size. On the card the plane tables come from the downsample and
    level kernels."""
    cfg = projective.fit_levels(cfg, *depth.shape[-2:])
    num_levels = len(cfg.iters)
    levels, intrs = build_pyramid(depth, intr, num_levels, cfg.min_depth, cfg.max_depth)
    grays = [gray.to(torch.float32)]
    for _ in range(num_levels - 1):
        grays.append(downsample_gray(grays[-1]))
    return tuple(levels), tuple(grays), tuple(intrs)


def sample_rgbd_source(depth, gray, intrs, cfg: RgbdIcpConfig = RgbdIcpConfig()):
    """Source side of B frames (B,H,W): (pts, inten, ok) at every level,
    no vertex or normal map built. The coarse depths come from one
    downsample_levels call (one launch on the card)."""
    depth = depth.to(torch.float32)
    g = gray.to(torch.float32)
    valid = camera.valid_mask(depth, cfg.min_depth, cfg.max_depth)
    d = torch.where(valid, depth, 0.0)
    depths = [d] + [dl for dl, _ in downsample.downsample_levels(d, len(intrs), cfg.min_depth)]
    samples = []
    for li, (dl, intr) in enumerate(zip(depths, intrs)):
        count = max(cfg.samples // (cfg.coarse_sample_divisor**li), cfg.min_samples)
        samples.append(sample_depth_gray_points(dl, g, intr, count, cfg.min_depth, cfg.max_depth))
        if li + 1 < len(intrs):
            g = downsample_gray(g)
    return tuple(samples)


def register_rgbd_pair(
    src_depth,
    src_gray,
    dst_depth,
    dst_gray,
    intr: camera.Intrinsics,
    cfg: RgbdIcpConfig = RgbdIcpConfig(),
    init_transform: torch.Tensor | None = None,
) -> RgbdResult:
    """End-to-end RGB-D registration of B pairs: depth and gray (B,H,W) in,
    the src-to-dst SE(3) transforms out."""
    if src_depth.dim() != 3 or src_depth.shape != dst_depth.shape:
        raise ValueError(
            f"need (B, H, W) batches of one shape, got {tuple(src_depth.shape)} and {tuple(dst_depth.shape)}"
        )
    cfg = projective.fit_levels(cfg, *src_depth.shape[-2:])
    dst_levels, dst_grays, intrs = build_rgbd_target(dst_depth, dst_gray, intr, cfg)
    src_samples = sample_rgbd_source(src_depth, src_gray, intrs, cfg)
    return rgbd_icp_sampled(src_samples, dst_levels, dst_grays, intrs, init_transform, cfg)
