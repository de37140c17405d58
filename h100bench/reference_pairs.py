"""Plain reference of batched projective point-to-plane ICP.

Written from the algorithm the port documents (``align/projective.py``,
``ops/pyramid.py``, ``ops/normals.py``), in plain torch, batched over
pairs, importing nothing of the port. ``dtype`` sets the precision of the
data path (depth, vertices, normals, residuals, the 6x6 sums); the 6x6
solve, the SE(3) exponential and the pose products stay in float32, since
torch solves no bfloat16 system.

Per pair: mask the depths to (min_depth, max_depth); build the destination
pyramid by 2x2 validity-aware means; at each level unproject, take
central-difference normals facing the camera, and the plane offset
d = n . q; stride-sample the source levels; then coarse to fine, per
association round, gather the destination plane at the projected pixel
(rounded half to even), gate and weight the point-to-plane residuals
(Geman-McClure), and take ``inner_iters`` damped Gauss-Newton steps on
se(3) against those planes.
"""

from __future__ import annotations

import math

import torch


def fit_levels(iters: tuple, height: int, width: int, min_extent: int = 24) -> tuple:
    """Drop coarse levels until the coarsest keeps min(H, W) >= min_extent."""
    levels, e, keep = len(iters), min(height, width), 1
    while keep < levels and (e >> keep) >= min_extent:
        keep += 1
    return tuple(iters[levels - keep:]) if keep < levels else tuple(iters)


def level_cameras(cam, levels: int):
    """Per-level (fx, fy, cx, cy, W, H), fine to coarse: halved, sizes floored."""
    fx, fy, cx, cy, w, h = cam
    out = []
    for _ in range(levels):
        out.append((fx, fy, cx, cy, w, h))
        fx, fy, cx, cy, w, h = fx * 0.5, fy * 0.5, (cx + 0.5) * 0.5 - 0.5, (cy + 0.5) * 0.5 - 0.5, w // 2, h // 2
    return out


def halve(depth: torch.Tensor) -> torch.Tensor:
    """2x2 mean of the valid (> 0) children; 0 where none is valid."""
    b, h, w = depth.shape
    d = depth[:, : h // 2 * 2, : w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2)
    valid = d > 0
    s = (d[:, :, 0, :, 0] + d[:, :, 0, :, 1]) + (d[:, :, 1, :, 0] + d[:, :, 1, :, 1])
    cnt = valid.sum(dim=(2, 4)).to(depth.dtype)
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), 0.0)


def vertices(depth: torch.Tensor, lc) -> torch.Tensor:
    """(B, H, W, 3) camera-frame points of masked depth (0 stays 0)."""
    fx, fy, cx, cy, w, h = lc
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    return torch.stack([depth * (u - cx) / fx, depth * (v - cy) / fy, depth], dim=-1)


def plane_table(depth: torch.Tensor, lc) -> tuple[torch.Tensor, torch.Tensor]:
    """(normals (B, H, W, 3), offsets (B, H, W)): central-difference
    normals where a pixel and its four neighbours have depth and it is off
    the border, facing the camera, zero elsewhere; offset d = n . q."""
    q = vertices(depth, lc)
    valid = depth > 0
    n = torch.zeros_like(q)
    c = (slice(None), slice(1, -1), slice(1, -1))
    dx = q[:, 1:-1, 2:] - q[:, 1:-1, :-2]
    dy = q[:, 2:, 1:-1] - q[:, :-2, 1:-1]
    cr = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.vector_norm(cr, dim=-1, keepdim=True)
    ok = (valid[c] & valid[:, 1:-1, 2:] & valid[:, 1:-1, :-2] & valid[:, 2:, 1:-1] & valid[:, :-2, 1:-1]
          & (norm[..., 0] > 1e-12))
    nn = cr / torch.clamp(norm, min=1e-12)
    nn = torch.where(((nn * q[c]).sum(-1) > 0)[..., None], -nn, nn)
    n[c] = torch.where(ok[..., None], nn, 0.0)
    return n, (n * q).sum(-1)


def stride_samples(depth: torch.Tensor, lc, count: int, min_depth: float, max_depth: float):
    """(points (B, P, 3), ok (B, P)): every (H W // P)-th pixel, in order."""
    fx, fy, cx, cy, w, h = lc
    b, npix = depth.shape[0], h * w
    count = min(count, npix)
    stride = npix // count
    idx = torch.arange(count, device=depth.device) * stride
    d = depth.reshape(b, npix)[:, idx]
    ok = torch.isfinite(d) & (d > min_depth) & (d < max_depth)
    d = torch.where(ok, d, 0.0)
    u, v = (idx % w).to(d.dtype), (idx // w).to(d.dtype)
    return torch.stack([d * (u - cx) / fx, d * (v - cy) / fy, d], dim=-1), ok


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """exp of twists (B, 6) = [v, w] as (B, 4, 4), computed in float64."""
    xi = xi.double()
    v, w = xi[:, :3], xi[:, 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2)
    small = th2 < 1e-8
    ts = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th2 / 6, torch.sin(ts) / ts)
    bb = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(ts)) / (ts * ts))
    cc = torch.where(small, 1.0 / 6 - th2 / 120, (ts - torch.sin(ts)) / (ts * ts * ts))
    z = torch.zeros_like(th)
    W = torch.stack([z, -w[:, 2], w[:, 1], w[:, 2], z, -w[:, 0], -w[:, 1], w[:, 0], z], -1).reshape(-1, 3, 3)
    W2 = W @ W
    eye = torch.eye(3, dtype=W.dtype, device=W.device)
    R = eye + a[:, None, None] * W + bb[:, None, None] * W2
    V = eye + bb[:, None, None] * W + cc[:, None, None] * W2
    T = torch.zeros((xi.shape[0], 4, 4), dtype=torch.float64, device=xi.device)
    T[:, :3, :3], T[:, :3, 3], T[:, 3, 3] = R, (V @ v[:, :, None])[..., 0], 1.0
    return T


def twist_gap(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """Per pair, sqrt(angle^2 + |t|^2) of inv(T_a) @ T_b (radians, meters)."""
    D = torch.linalg.inv(T_a.double()) @ T_b.double()
    cos = ((D[:, 0, 0] + D[:, 1, 1] + D[:, 2, 2] - 1.0) / 2.0).clamp(-1.0, 1.0)
    skew = torch.stack([D[:, 2, 1] - D[:, 1, 2], D[:, 0, 2] - D[:, 2, 0], D[:, 1, 0] - D[:, 0, 1]], -1)
    angle = torch.atan2(0.5 * skew.norm(dim=-1), cos)
    return torch.sqrt(angle * angle + (D[:, :3, 3] ** 2).sum(-1))


def _round(T, pts, ok_src, n_tab, d_tab, lc, icp, dtype):
    """One association round, then inner_iters damped GN steps."""
    fx, fy, cx, cy, w, h = lc
    b, p, _ = pts.shape
    Td = T.to(dtype)
    q = pts @ Td[:, :3, :3].transpose(1, 2) + Td[:, None, :3, 3]
    z = q[..., 2]
    zs = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
    u = fx * q[..., 0] / zs + cx
    v = fy * q[..., 1] / zs + cy
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (z > icp["min_depth"])

    def pix(c, size):
        c = torch.nan_to_num(c.float(), nan=0.0, posinf=float(size - 1), neginf=0.0)
        return torch.round(torch.clamp(c, 0.0, float(size - 1))).long()

    flat = pix(v, h) * w + pix(u, w)
    n = torch.gather(n_tab.reshape(b, h * w, 3), 1, flat[..., None].expand(b, p, 3))
    d = torch.gather(d_tab.reshape(b, h * w), 1, flat)
    ok = ok_src & inb & ((n * n).sum(-1) > 0.5)
    stats = None
    for _ in range(max(int(icp["inner_iters"]), 1)):
        Td = T.to(dtype)
        q = pts @ Td[:, :3, :3].transpose(1, 2) + Td[:, None, :3, 3]
        r = (n * q).sum(-1) - d
        okr = ok & (r.abs() < icp["dist_threshold"])
        r = torch.where(okr, r, 0.0)
        mu = icp["gnc_mu"]
        wgt = (mu / (r * r + mu)) ** 2 * okr.to(dtype)
        J = torch.cat([n, torch.linalg.cross(q, n, dim=-1)], dim=-1)  # (B, P, 6)
        Jw = J * wgt[..., None]
        H = (Jw.transpose(1, 2) @ J).float()
        g = (Jw * r[..., None]).sum(1).float()
        lam = icp["damping"] * H.diagonal(dim1=-2, dim2=-1).sum(-1) + 1e-12
        x, info = torch.linalg.solve_ex(H + lam[:, None, None] * torch.eye(6, device=H.device), g)
        good = torch.isfinite(x).all(-1) & (info == 0)
        delta = torch.where(good[:, None], -x, 0.0)
        T = (se3_exp(delta) @ T.double()).float()
        wsse, wsum = (wgt * r * r).sum(-1).float(), wgt.sum(-1).float()
        stats = (torch.sqrt(wsse / (wsum + 1e-12)), okr.sum(-1).float() / p)
    return T, stats


def register(src: torch.Tensor, dst: torch.Tensor, cam, icp: dict, dtype=torch.float32):
    """(transform (B, 4, 4) f32, rmse (B,), inlier_fraction (B,)) of the
    src -> dst registration of B depth pairs (meters, (B, H, W))."""
    iters = fit_levels(tuple(icp["iters"]), src.shape[1], src.shape[2])
    levels = len(iters)
    cams = level_cameras(cam, levels)
    lo, hi = icp["min_depth"], icp["max_depth"]

    def masked(d):
        d = d.to(dtype)
        return torch.where(torch.isfinite(d) & (d > lo) & (d < hi), d, 0.0)

    dpyr, spyr = [masked(dst)], [masked(src)]
    for _ in range(levels - 1):
        dpyr.append(halve(dpyr[-1]))
        spyr.append(halve(spyr[-1]))
    T = torch.eye(4, dtype=torch.float32, device=src.device).expand(src.shape[0], 4, 4).contiguous()
    stats = None
    for li in range(levels - 1, -1, -1):
        count = max(icp["samples"] // (icp["coarse_sample_divisor"] ** li), icp["min_samples"])
        pts, ok = stride_samples(spyr[li], cams[li], count, lo, hi)
        n_tab, d_tab = plane_table(dpyr[li], cams[li])
        for _ in range(iters[levels - 1 - li]):
            T, stats = _round(T, pts, ok, n_tab, d_tab, cams[li], icp, dtype)
    return T, stats[0], stats[1]


def register_blocks(src, dst, cam, icp: dict, block: int = 128, dtype=torch.float32):
    """register() over blocks of ``block`` pairs, so that it fits beside
    the pool; results concatenated."""
    outs = [register(src[i : i + block], dst[i : i + block], cam, icp, dtype) for i in range(0, src.shape[0], block)]
    return tuple(torch.cat(x) for x in zip(*outs))


def truth_gap(transforms: torch.Tensor, truth: torch.Tensor) -> float:
    """Largest twist gap to the rendered motion (informational)."""
    return float(twist_gap(truth, transforms).max()) if transforms.numel() else math.nan
