"""Projective point-to-plane ICP, batched over a leading B.

Port of realsensetracker_tpu/align/projective.py. Correspondence is a
camera projection into the destination's plane table, the residual is
point-to-plane with a Geman-McClure/GNC weight and a distance gate, and
each pose update solves damped 6x6 Gauss-Newton normal equations on
se(3). Where JAX vmapped a single pair, every function here carries the
batch dimension B itself; where JAX used fori_loop, a Python loop runs.
On CUDA tensors each association round -- the association, every inner
iteration's reduction, damped solve and SE(3) update -- is one launch of
kernels/gn_step.gn_round, and build_normal_equations (the unsolved system
of the joint RGB-D step) one launch of kernels/gn_step.gn_system; CPU
tensors take their plain versions, the associate_planes_t,
normal_equations_fixed_t and solve_update below.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.kernels import downsample, gn_step
from realsensetracker_tpu_torch.ops.pyramid import PyramidLevel, build_pyramid
from realsensetracker_tpu_torch.utils.tracing import span


class ProjectiveIcpConfig(NamedTuple):
    """Solver configuration, defaults as in the JAX package."""

    iters: tuple[int, ...] = (3, 3, 3, 2)  # association rounds per level,
    # coarse -> fine; 4 levels (coarsest 80x60 at 640x480)
    inner_iters: int = 2  # GN steps per association (fixed planes)
    samples: int = 2048  # source points sampled at the FINEST level
    sample_mode: str = "stride"  # "stride" | "normal_space" (BASELINE config 3)
    coarse_sample_divisor: int = 4  # level l uses samples / divisor**l
    min_samples: int = 256  # floor for the coarsest levels
    dist_threshold: float = 0.25  # meters; plane-distance correspondence gate
    gnc_mu: float = 1e-2  # GNC weight scale on plane residual^2
    damping: float = 1e-6  # Levenberg damping (relative to trace)
    min_depth: float = 0.05
    max_depth: float = 10.0


class ProjectiveIcpResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4)
    rmse: torch.Tensor  # (B,) weighted point-to-plane RMSE at the finest level
    inlier_fraction: torch.Tensor  # (B,) fraction of sampled points matched
    num_matched: torch.Tensor  # (B,) int32


def fit_levels(cfg, height: int, width: int, min_extent: int = 24):
    """Truncate ``cfg.iters`` so the coarsest level keeps its smaller image
    dimension >= ``min_extent`` pixels; drops COARSE entries only."""
    levels = len(cfg.iters)
    e = min(int(height), int(width))
    max_levels = 1
    while max_levels < levels and (e >> max_levels) >= min_extent:
        max_levels += 1
    if max_levels >= levels:
        return cfg
    return cfg._replace(iters=cfg.iters[levels - max_levels:])


def _level_samples(cfg: ProjectiveIcpConfig, li: int) -> int:
    return max(cfg.samples // (cfg.coarse_sample_divisor**li), cfg.min_samples)


def sample_level(level: PyramidLevel, count: int):
    """Deterministic stride subsample of one level: (pts (B,P,3),
    normals (B,P,3), ok (B,P)); invalid samples carry ok = False."""
    b, h, w = level.valid.shape
    npix = h * w
    count = min(count, npix)
    stride = npix // count
    lim = count * stride
    pts = level.vertex_map.reshape(b, npix, 3)[:, :lim:stride]
    nrm = level.normal_map.reshape(b, npix, 3)[:, :lim:stride]
    ok = level.valid.reshape(b, npix)[:, :lim:stride]
    return pts, nrm, ok


def sample_level_normal_space(level: PyramidLevel, count: int, bins: int = 6):
    """Normal-space sampling (BASELINE config 3): samples balanced across
    surface orientations, so one dominant surface cannot starve the
    constraint directions. Returns (pts (B,P,3), normals (B,P,3), ok (B,P)).

    Normals are binned by their dominant signed axis (6 bins, invalid
    pixels last); a stable argsort keeps pixel order inside each bin's
    segment, and bin b contributes the head of its segment: count // bins
    samples, one more for the first count % bins bins. A window that would
    run past the end is clamped left, and ``off`` masks the entries it then
    borrows from the previous segment. Under-full bins spill into the next
    segment (valid points, slightly unbalanced). Needs a pyramid built with
    normals.
    """
    b, h, w = level.valid.shape
    npix = h * w
    count = min(count, npix)
    n = level.normal_map.reshape(b, npix, 3)
    ok = level.valid.reshape(b, npix)
    axis = torch.argmax(n.abs(), dim=-1)  # first maximum on ties, as jnp
    sign = torch.gather(n, 2, axis[..., None])[..., 0] < 0
    bin_id = torch.where(ok, axis + 3 * sign.long(), bins)  # invalid -> bins
    order = torch.argsort(bin_id, dim=1, stable=True)
    counts = torch.zeros((b, bins + 1), dtype=torch.long, device=n.device)
    counts.scatter_add_(1, bin_id, torch.ones_like(bin_id))
    starts = torch.cumsum(counts, dim=1) - counts  # exclusive

    # Lane plan, made on the device: the bin each output lane reads
    # (bins 0..rem-1 take per_bin + 1 lanes, the rest per_bin), that bin's
    # share, and the lane's place in it.
    per_bin, rem = divmod(count, bins)
    j = torch.arange(count, device=n.device)
    head = rem * (per_bin + 1)
    lane_bin = torch.where(j < head, j // (per_bin + 1), rem + (j - head) // max(per_bin, 1))
    lane_take = per_bin + (lane_bin < rem).long()
    lane = j - (lane_bin * per_bin + torch.clamp(lane_bin, max=rem))

    seg_start = starts[:, lane_bin]  # (B, count)
    start = torch.minimum(seg_start, npix - lane_take)
    off = seg_start - start
    seg_ok = (lane >= off) & (lane < off + torch.minimum(counts[:, lane_bin], lane_take))
    idx = torch.gather(order, 1, start + lane)
    pts = torch.gather(level.vertex_map.reshape(b, npix, 3), 1, idx[..., None].expand(-1, -1, 3))
    nrm = torch.gather(n, 1, idx[..., None].expand(-1, -1, 3))
    return pts, nrm, torch.gather(ok, 1, idx) & seg_ok


def sample_depth_points(
    depth: torch.Tensor,
    intr: camera.Intrinsics,
    count: int,
    min_depth: float = 0.05,
    max_depth: float = 10.0,
):
    """Stride-sample source points straight from a depth batch (B, H, W):
    the same points and validity as sample_level on a source pyramid,
    without building its vertex map. Returns (pts (B,P,3), ok (B,P))."""
    b, h, w = depth.shape
    npix = h * w
    count = min(count, npix)
    stride = npix // count
    idx = torch.arange(count, device=depth.device) * stride
    d = depth.reshape(b, npix)[:, : count * stride : stride]
    ok = torch.isfinite(d) & (d > min_depth) & (d < max_depth)
    d = torch.where(ok, d, 0.0)
    u = (idx % w).to(d.dtype)
    v = (idx // w).to(d.dtype)
    pts = torch.stack([d * (u - intr.cx) / intr.fx, d * (v - intr.cy) / intr.fy, d], dim=-1)
    return pts, ok


def _pixel_index(c: torch.Tensor, size: int) -> torch.Tensor:
    """Round-half-to-even pixel index clamped to [0, size-1], as JAX's
    clip(round(c).astype(int32)). The clamp happens in float first, so a
    non-finite or huge coordinate (masked by the caller anyway) still gives
    a defined gather index."""
    c = torch.nan_to_num(c, nan=0.0, posinf=float(size - 1), neginf=0.0)
    return torch.round(torch.clamp(c, 0.0, float(size - 1))).long()


def associate_planes_t(
    T, src_pts_t, src_ok, dst_level: PyramidLevel, intr: camera.Intrinsics, cfg: ProjectiveIcpConfig
):
    """Projective association at poses T (B,4,4) of lane-major points
    src_pts_t (B,3,P): ONE gather of 4 floats per point from the plane
    table. Returns (n_t (B,3,P), d_plane (B,P), ok (B,P))."""
    p = se3.transform_points_t(T, src_pts_t)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    z_safe = torch.where(z.abs() > 1e-12, z, 1e-12)
    u = intr.fx * x / z_safe + intr.cx
    v = intr.fy * y / z_safe + intr.cy
    inb = camera.in_bounds(u, v, intr) & (z > cfg.min_depth)
    ui = _pixel_index(u, intr.width)
    vi = _pixel_index(v, intr.height)

    packed = dst_level.packed
    b, _, h, w = packed.shape
    idx = (vi * w + ui)[:, None, :].expand(b, 4, -1)
    rows = torch.gather(packed.reshape(b, 4, h * w), 2, idx)  # (B, 4, P)
    n_t = rows[:, 0:3]
    d_plane = rows[:, 3]
    ok = src_ok & inb & ((n_t * n_t).sum(1) > 0.5)
    return n_t, d_plane, ok


def _cross_t(a, b):
    """Cross product of lane-major (B, 3, P) stacks."""
    return torch.stack(
        [
            a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
        ],
        dim=1,
    )


def normal_equations_fixed_t(T, src_pts_t, n_t, d_plane, assoc_ok, cfg: ProjectiveIcpConfig):
    """Gate, weight and accumulate the 6x6 GN systems against FIXED planes.

    Returns (H (B,6,6), b (B,6), aux (wsse (B,), wsum (B,), ok_count (B,))).
    The products run in true f32 (torch.matmul with TF32 off).
    """
    p = se3.transform_points_t(T, src_pts_t)
    r = (n_t * p).sum(1) - d_plane  # point-to-plane residual
    ok = assoc_ok & (r.abs() < cfg.dist_threshold)
    r = torch.where(ok, r, 0.0)
    l_rt = cfg.gnc_mu / (r * r + cfg.gnc_mu)  # GNC weight on the residual
    w = l_rt * l_rt * ok.to(p.dtype)

    J = torch.cat([n_t, _cross_t(p, n_t)], dim=1)  # (B, 6, P), twist [v, w]
    Jw = J * w[:, None, :]
    H = torch.matmul(Jw, J.transpose(1, 2))
    bvec = torch.matmul(Jw, r[:, :, None])[..., 0]
    aux = ((w * r * r).sum(-1), w.sum(-1), ok.sum(-1, dtype=torch.int32))
    return H, bvec, aux


def associate_planes(
    T, src_pts, src_ok, dst_level: PyramidLevel, intr: camera.Intrinsics, cfg: ProjectiveIcpConfig
):
    """Point-major associate_planes_t: src_pts (B,P,3) -> (n (B,P,3),
    d_plane (B,P), ok (B,P))."""
    n_t, d_plane, ok = associate_planes_t(T, src_pts.transpose(1, 2), src_ok, dst_level, intr, cfg)
    return n_t.transpose(1, 2), d_plane, ok


def normal_equations_fixed(T, src_pts, n, d_plane, assoc_ok, cfg: ProjectiveIcpConfig):
    """Point-major normal_equations_fixed_t: src_pts and n are (B,P,3)."""
    return normal_equations_fixed_t(T, src_pts.transpose(1, 2), n.transpose(1, 2), d_plane, assoc_ok, cfg)


def build_normal_equations(
    T, src_pts, src_ok, dst_level: PyramidLevel, intr: camera.Intrinsics, cfg: ProjectiveIcpConfig
):
    """Associate and accumulate the 6x6 GN systems at poses T (B,4,4) of
    point-major src_pts (B,P,3): (H (B,6,6), b (B,6), (wsse (B,), wsum
    (B,), ok_count (B,) int32)), unsolved. CUDA tensors: one gn_system
    launch; CPU tensors: its plain version, associate_planes_t ->
    normal_equations_fixed_t."""
    args = (T.contiguous(), src_pts.transpose(1, 2).contiguous(), src_ok.contiguous(), dst_level.packed)
    if src_pts.is_cuda:
        return gn_step.gn_system(*args, intr, cfg)
    return gn_step.gn_system_reference(*args, intr, cfg)


def solve_update(T, H, b, aux, num_samples: int, cfg: ProjectiveIcpConfig):
    """Damped 6x6 solves + left-multiplied SE(3) updates.

    solve_ex neither raises nor synchronizes on a singular system; a pair
    whose solve failed or went non-finite keeps its pose.
    """
    lam = cfg.damping * H.diagonal(dim1=-2, dim2=-1).sum(-1) + 1e-12
    Hd = H + lam[:, None, None] * torch.eye(6, dtype=H.dtype, device=H.device)
    x, info = torch.linalg.solve_ex(Hd, b)
    delta = -x
    good = torch.isfinite(delta).all(-1) & (info == 0)
    delta = torch.where(good[:, None], delta, 0.0)
    T_new = se3.compose(se3.exp(delta), T)

    wsse, wsum, ok_count = aux
    rmse = torch.sqrt(wsse / (wsum + 1e-12))
    frac = ok_count.to(torch.float32) / num_samples
    return T_new, (rmse, frac, ok_count)


def _step(T, src_pts_t, src_ok, dst_level: PyramidLevel, intr: camera.Intrinsics, cfg: ProjectiveIcpConfig):
    """One association round: one plane gather at the current poses, then
    cfg.inner_iters GN updates against those fixed planes. CUDA tensors:
    one gn_round launch; CPU tensors: its plain version, the functions above.
    """
    if src_pts_t.is_cuda:
        return gn_step.gn_round(T, src_pts_t, src_ok, dst_level.packed, intr, cfg)
    return gn_step.gn_round_reference(T, src_pts_t, src_ok, dst_level.packed, intr, cfg)


def _initial(batch: int, init_transform, device):
    if init_transform is None:
        return se3.identity(device=device).expand(batch, 4, 4).contiguous()
    return init_transform.to(device=device, dtype=torch.float32).expand(batch, 4, 4).contiguous()


def _zero_stats(batch: int, device):
    zeros = torch.zeros(batch, dtype=torch.float32, device=device)
    return (zeros, zeros, torch.zeros(batch, dtype=torch.int32, device=device))


def projective_icp_sampled(
    src_samples,  # per level (fine -> coarse): (pts (B,P,3), ok (B,P))
    dst_levels: Sequence[PyramidLevel],
    intrs: tuple[camera.Intrinsics, ...],
    init_transform: torch.Tensor | None = None,
    cfg: ProjectiveIcpConfig = ProjectiveIcpConfig(),
) -> ProjectiveIcpResult:
    """Coarse-to-fine registration of pre-sampled source points onto the
    destination pyramids. ``init_transform`` is (4,4) or (B,4,4)."""
    num_levels = len(intrs)
    if len(cfg.iters) != num_levels:
        raise ValueError(f"cfg.iters has {len(cfg.iters)} entries for {num_levels} levels")
    packed = dst_levels[0].packed
    batch, device = packed.shape[0], packed.device
    T = _initial(batch, init_transform, device)
    stats = _zero_stats(batch, device)
    for li in range(num_levels - 1, -1, -1):  # coarse -> fine
        src_pts, src_ok = src_samples[li]
        src_pts_t = src_pts.transpose(1, 2).contiguous()  # lane-major, once per level
        src_ok = src_ok.contiguous()
        for _ in range(cfg.iters[num_levels - 1 - li]):
            T, stats = _step(T, src_pts_t, src_ok, dst_levels[li], intrs[li], cfg)
    rmse, inlier_frac, matched = stats
    return ProjectiveIcpResult(
        transform=T, rmse=rmse, inlier_fraction=inlier_frac, num_matched=matched
    )


def projective_icp(
    src_levels: Sequence[PyramidLevel],
    dst_levels: Sequence[PyramidLevel],
    intrs: tuple[camera.Intrinsics, ...],
    init_transform: torch.Tensor | None = None,
    cfg: ProjectiveIcpConfig = ProjectiveIcpConfig(),
) -> ProjectiveIcpResult:
    """Coarse-to-fine registration of src pyramids onto dst pyramids
    (both from ops.pyramid.build_pyramid, fine -> coarse; cfg.iters is
    coarse -> fine), sampling each source level by cfg.sample_mode
    ("normal_space" needs source levels built with normals)."""
    sample = sample_level_normal_space if cfg.sample_mode == "normal_space" else sample_level
    samples = []
    for li, level in enumerate(src_levels[: len(intrs)]):
        pts, _, ok = sample(level, _level_samples(cfg, li))
        samples.append((pts, ok))
    return projective_icp_sampled(samples, dst_levels, intrs, init_transform, cfg)


def register_depth_pair(
    src_depth: torch.Tensor,
    dst_depth: torch.Tensor,
    intr: camera.Intrinsics,
    cfg: ProjectiveIcpConfig = ProjectiveIcpConfig(),
    init_transform: torch.Tensor | None = None,
) -> ProjectiveIcpResult:
    """End-to-end registration of B pairs: depths (B, H, W) in -> the
    src-to-dst SE(3) transforms out. The destination builds plane-table
    pyramids; the source is sampled straight from its depth levels, or,
    for sample_mode="normal_space", from a full pyramid with normals."""
    with span("rst.projective.register"):
        if src_depth.dim() != 3 or src_depth.shape != dst_depth.shape:
            raise ValueError(
                f"need two (B, H, W) batches of one shape, got {tuple(src_depth.shape)} "
                f"and {tuple(dst_depth.shape)}"
            )
        cfg = fit_levels(cfg, *src_depth.shape[-2:])
        num_levels = len(cfg.iters)
        dst_levels, intrs = build_pyramid(dst_depth, intr, num_levels, cfg.min_depth, cfg.max_depth)
        if cfg.sample_mode == "normal_space":
            src_levels, _ = build_pyramid(src_depth, intr, num_levels, cfg.min_depth, cfg.max_depth)
            return projective_icp(src_levels, dst_levels, tuple(intrs), init_transform, cfg)
        src_depth = src_depth.to(torch.float32)
        valid = camera.valid_mask(src_depth, cfg.min_depth, cfg.max_depth)
        d = torch.where(valid, src_depth, 0.0)
        depths = [d] + [dl for dl, _ in downsample.downsample_levels(d, num_levels, cfg.min_depth)]
        samples = [
            sample_depth_points(dl, intrs[li], _level_samples(cfg, li), cfg.min_depth, cfg.max_depth)
            for li, dl in enumerate(depths)
        ]
        return projective_icp_sampled(samples, dst_levels, tuple(intrs), init_transform, cfg)
