"""GNC-weighted point-to-point ICP, reference-exact semantics.

Port of realsensetracker_tpu/align/icp.py (AlignIcp3d, align_icp.cpp:73-167).
The per-iteration KD-tree 1-NN becomes the dense brute-force search of
ops/correspond.py; the rest follows the reference:

* src_mean is taken ONCE, from the untransformed source;
* Geman-McClure/GNC weight l = (mu / (d^2 + mu))^2, mu /= 1.4 every 8
  iterations, skipping iteration 0;
* dst_mean is the unweighted mean of the matched destination points;
* the weighted cross-covariance uses the ORIGINAL source coordinates, so
  each iteration solves the absolute transform again;
* SVD + det column fix; success is sqrt(cost / n) < 10000.

The JAX ``fori_loop`` becomes a Python loop whose carry (transform, cost)
stays on the device; mu follows the f32 schedule of the JAX loop, computed
on the host, and enters each iteration as a 0-d device tensor so the
weight is a true divide on every device. The covariance accumulates in
f64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from realsensetracker_tpu_torch.align.kabsch import kabsch_from_cross_covariance
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops import correspond
from realsensetracker_tpu_torch.ops.cloud import Cloud


class IcpResult(NamedTuple):
    transform: torch.Tensor  # (4, 4) absolute src -> dst transform
    mean_cost: torch.Tensor  # sqrt(sum d^2 / n)
    success: torch.Tensor  # bool
    num_valid: torch.Tensor


def gnc_schedule(max_iter: int) -> list[float]:
    """mu of each iteration, rounded to f32 at every step as the JAX loop
    carries it: 1, divided by 1.4 at iterations 8, 16, ..."""
    mu, out = np.float32(1.0), []
    for it in range(max_iter):
        if it > 0 and it % 8 == 0:
            mu = np.float32(mu / np.float32(1.4))
        out.append(float(mu))
    return out


def align_icp(
    src: Cloud,
    dst: Cloud,
    max_iter: int = 128,
    init_transform: torch.Tensor | None = None,
    chunk: int = 2048,
) -> IcpResult:
    """Align src onto dst; returns the absolute transform like AlignIcp3d."""
    dev = src.points.device
    f64 = torch.float64
    if init_transform is None:
        init_transform = se3.identity(device=dev)
    src_m = src.mask.to(torch.float32)
    n_src = torch.clamp(src_m.sum(), min=1.0)
    src64 = src.points.to(f64)
    m64 = src_m.to(f64)[:, None]
    src_mean64 = (src64 * m64).sum(0) / n_src.to(f64)
    src_mean = src_mean64.to(torch.float32)
    src_centred = src64 - src_mean64

    xfm = init_transform
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    for mu_value in gnc_schedule(max_iter):
        mu = torch.full((), mu_value, dtype=torch.float32, device=dev)
        p = se3.transform_points(xfm, src.points)
        nbr_idx, _ = correspond.nearest_neighbors(p, dst, chunk=chunk)
        matched = dst.points[nbr_idx]
        # The matched distance again, directly: the |a|^2+|b|^2-2ab form of
        # the search loses ~1e-7 absolute, which the GNC weights and the
        # cost feel once d^2 -> 0 near convergence.
        diff = p - matched
        d2 = torch.where(src.mask, (diff * diff).sum(-1), 0.0)
        cost = d2.sum()
        l_rt = mu / (d2 + mu)
        w = l_rt * l_rt * src_m
        dst_mean64 = (matched.to(f64) * m64).sum(0) / n_src.to(f64)
        dd = matched.to(f64) - dst_mean64
        cov = dd.T @ (src_centred * w[:, None].to(f64))
        xfm = kabsch_from_cross_covariance(cov, src_mean, dst_mean64.to(torch.float32))

    mean_cost = torch.sqrt(cost / n_src)
    enough = (src.mask.sum() >= 3) & (dst.mask.sum() >= 3)
    return IcpResult(
        transform=torch.where(enough, xfm, init_transform),
        mean_cost=mean_cost,
        success=enough & (mean_cost < 10000.0),
        num_valid=src.mask.sum(),
    )
