"""Coarse-to-fine pairwise cloud alignment: the rs_align_app pipeline.

Port of realsensetracker_tpu/models/pairwise.py (rs_align_app.cpp:243-314):
voxel downsample both clouds, FPFH features, 2-NN feature matches, Lowe
pruning with Gaussian weights, a weighted Kabsch seed, GNC-ICP refinement
and optional robust global registration, over fixed-capacity masked
clouds. Three host reads remain, as in JAX: the auto-sized FPFH cap, the
truncation flags (one read for both) and ``success``.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from realsensetracker_tpu_torch.align import icp as icp_mod
from realsensetracker_tpu_torch.align import kabsch as kabsch_mod
from realsensetracker_tpu_torch.align import robust_global
from realsensetracker_tpu_torch.api.config import AlignConfig
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops import cloud as cloud_mod
from realsensetracker_tpu_torch.ops import fpfh as fpfh_mod
from realsensetracker_tpu_torch.ops import voxel as voxel_mod


class AlignPairResult(NamedTuple):
    transform: torch.Tensor
    num_matches: torch.Tensor
    icp_mean_cost: torch.Tensor
    success: bool
    # Intermediates, so that inspection need not run the downsample and the
    # O(N^2) FPFH again:
    src_down: object = None  # voxel-downsampled source Cloud
    src_feats: object = None  # its FPFH features (None without FPFH/robust)


def align_pair(
    src: cloud_mod.Cloud,
    dst: cloud_mod.Cloud,
    cfg: AlignConfig = AlignConfig(),
    viewpoint: torch.Tensor | None = None,
) -> AlignPairResult:
    """Register src onto dst following the rs_align_app recipe."""
    dev = src.points.device
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=torch.float32, device=dev)  # rs_align_app.cpp:275-278

    src_d = voxel_mod.downsample_voxel(src, cfg.voxel_size)
    dst_d = voxel_mod.downsample_voxel(dst, cfg.voxel_size)
    # cfg.cloud_capacity bounds the O(N^2) FPFH and ICP searches.
    cap = cfg.cloud_capacity
    if cap and src_d.capacity > cap:
        src_d = cloud_mod.subsample_to_capacity(src_d, cap)
    if cap and dst_d.capacity > cap:
        dst_d = cloud_mod.subsample_to_capacity(dst_d, cap)

    xfm = se3.identity(device=dev)
    n_matches = torch.zeros((), dtype=torch.int64, device=dev)
    src_f = dst_f = None
    if cfg.init_with_fpfh or cfg.use_robust:
        max_nbrs = cfg.fpfh_max_neighbors
        if max_nbrs == 0:  # auto: the cap covers the densest true ball
            max_nbrs = fpfh_mod.auto_max_neighbors((src_d, cfg.feature_radius), (dst_d, cfg.feature_radius))
        src_f, trunc_s = fpfh_mod.compute_fpfh_checked(src_d, viewpoint, cfg.normal_k, cfg.feature_radius, max_nbrs)
        dst_f, trunc_d = fpfh_mod.compute_fpfh_checked(dst_d, viewpoint, cfg.normal_k, cfg.feature_radius, max_nbrs)
        if bool(trunc_s | trunc_d):
            warnings.warn(
                "FPFH neighborhood cap truncates the radius ball "
                f"(fpfh_max_neighbors={max_nbrs} < densest ball); features "
                "will drift from radiusSearch semantics (fpfh.cpp:133-147). "
                "Set fpfh_max_neighbors=0 for auto sizing.",
                stacklevel=2,
            )

    if cfg.init_with_fpfh:
        matches, _ = fpfh_mod.compute_matches(src_f, dst_f, src_d.mask, dst_d.mask, 2)
        j_best, weights, keep = fpfh_mod.prune_matches_lowe(matches, src_f, dst_f, cfg.lowe_ratio, src_d.mask)
        n_matches = keep.sum()
        xfm = kabsch_mod.solve_kabsch(src_d.points, dst_d.points[j_best], weights=weights, mask=keep)

    icp_cost = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.refine_with_icp:
        res = icp_mod.align_icp(src_d, dst_d, cfg.icp_max_iter, init_transform=xfm)
        xfm, icp_cost = res.transform, res.mean_cost

    if cfg.use_robust:
        rr = robust_global.register_robust(src_d, dst_d, src_f, dst_f, cfg.noise_bound)
        xfm = torch.where(rr.valid, rr.transform, xfm)

    return AlignPairResult(
        transform=xfm,
        num_matches=n_matches,
        icp_mean_cost=icp_cost,
        success=bool(torch.isfinite(xfm).all()),
        src_down=src_d,
        src_feats=src_f,
    )
