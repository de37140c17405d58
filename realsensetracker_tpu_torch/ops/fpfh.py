"""FPFH (Fast Point Feature Histograms) on masked fixed-capacity clouds.

Port of realsensetracker_tpu/ops/fpfh.py, the reference's fpfh.cpp: the
radius neighbourhood (nanoflann radiusSearch) becomes the K nearest
neighbours (dense distances, ties to the lower index) intersected with the
radius ball; pair features are computed for all (i, k) at once; histograms
are one-hot products, which sum in a fixed order on every device (a
scatter_add on CUDA would sum in the order its atomics land). The
reference's semantics hold:

* the origin switches when |n1.d| < |n2.d| (fpfh.cpp:38-48);
* zero-distance and |u_d| >= 1 pairs contribute nothing (:27, :54);
* bin = clamp(floor(11 (f scale + 0.5)), 0, 10), scale = (1/2pi, .5, .5)
  (:75, :93-95);
* the SPFH weight is 1/(n_neighbours - 1), self counted (:77);
* the FPFH leaves out the point's own SPFH (:154) and normalises each
  11-bin segment to unit sum (:169-174).

The truncation flags are device tensors; ``densest_ball_count`` and what
calls it read one number on the host, as JAX's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from realsensetracker_tpu_torch.ops import correspond, normals as normals_mod
from realsensetracker_tpu_torch.ops.cloud import Cloud

NUM_BINS = 11  # kNumBins, fpfh.cpp:14
FPFH_SIZE = 3 * NUM_BINS  # kFpfhSize, fpfh.cpp:15
_SCALE = (1.0 / (2.0 * math.pi), 0.5, 0.5)  # fpfh.cpp:75


def pair_features(p1, n1, p2, n2):
    """Darboux pair features of stacked pairs (..., 3) -> (features (..., 3),
    valid (...)): ComputePfh (fpfh.cpp:21-67), NaN-free by masked
    denominators; invalid pairs give zeros."""
    delta = p2 - p1
    dist = torch.linalg.vector_norm(delta, dim=-1)
    ok = dist > 0.0
    inv = torch.where(ok, 1.0 / torch.clamp(dist, min=1e-30), 0.0)
    d = delta * inv[..., None]

    n1_d = (n1 * d).sum(-1)
    n2_d = (n2 * d).sum(-1)
    switch = n1_d.abs() < n2_d.abs()  # fpfh.cpp:41
    u_d = torch.where(switch, -n2_d, n1_d)
    nt_d = torch.where(switch, -n1_d, n2_d)

    ok = ok & (u_d.abs() < 1.0)  # fpfh.cpp:54
    v_norm = torch.sqrt(torch.clamp(1.0 - u_d * u_d, min=0.0))
    inv_v = torch.where(ok, 1.0 / torch.clamp(v_norm, min=1e-30), 0.0)
    n1n2 = (n1 * n2).sum(-1)
    f0 = torch.atan2(nt_d - n1n2 * u_d, n1n2 * v_norm)  # f4, fpfh.cpp:62
    f1 = (d * torch.linalg.cross(n1, n2, dim=-1)).sum(-1) * inv_v  # f1, fpfh.cpp:63
    feats = torch.stack([f0, f1, u_d], dim=-1)  # u_d: f3, fpfh.cpp:64
    return torch.where(ok[..., None], feats, 0.0), ok


def _histogram(feats: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(..., K, 3) features + (..., K) weights -> (..., 33) histogram."""
    scale = torch.tensor(_SCALE, dtype=feats.dtype, device=feats.device)
    raw = torch.floor(NUM_BINS * (feats * scale + 0.5)).to(torch.int64)
    bins = torch.clamp(raw, 0, NUM_BINS - 1)  # fpfh.cpp:95
    onehot = F.one_hot(bins, NUM_BINS).to(feats.dtype)  # (..., K, 3, 11)
    hist = torch.einsum("...kfb,...k->...fb", onehot, weights)
    return hist.reshape(hist.shape[:-2] + (FPFH_SIZE,))


def compute_spfh(cloud: Cloud, normals: torch.Tensor, radius: float, max_neighbors: int = 64):
    """SPFH histograms (N, 33) and the neighbourhood (idx, nbr_ok, dist,
    truncated).

    The neighbourhood is the K = min(max_neighbors, N) nearest points within
    ``radius``, self included; a cap at least the densest true ball gives
    exact radiusSearch parity. ``truncated`` (a 0-d bool tensor) says
    whether some point's ball exceeds the cap: its (K+1)-th nearest
    neighbour, one more column of the same search, lies within the radius.
    """
    n = cloud.capacity
    k = min(max_neighbors, n)
    k_probe = min(k + 1, n)
    idx_p, _ = correspond.knn(cloud.points, cloud, k_probe)  # self included
    idx = idx_p[:, :k]
    p1 = cloud.points[:, None, :]  # (N, 1, 3)
    p2 = cloud.points[idx]  # (N, K, 3)
    # Exact distances: the search's matmul form loses precision near zero.
    dist = torch.linalg.vector_norm(p2 - p1, dim=-1)
    if k_probe > k:
        far = idx_p[:, k]
        d_probe = torch.linalg.vector_norm(cloud.points[far] - cloud.points, dim=-1)
        truncated = ((d_probe <= radius) & cloud.mask[far] & cloud.mask).any()
    else:
        truncated = torch.zeros((), dtype=torch.bool, device=cloud.points.device)
    nbr_ok = (dist <= radius) & cloud.mask[idx] & cloud.mask[:, None]
    is_self = idx == torch.arange(n, device=idx.device)[:, None]

    feats, pfh_ok = pair_features(p1, normals[:, None, :].expand(p2.shape), p2, normals[idx])
    n_nbrs = nbr_ok.sum(-1)  # counts self, as radiusSearch does
    dhist = torch.where(n_nbrs > 1, 1.0 / torch.clamp(n_nbrs - 1, min=1), 0.0)  # fpfh.cpp:77
    w = (nbr_ok & ~is_self & pfh_ok).to(feats.dtype) * dhist[:, None]
    return _histogram(feats, w), idx, nbr_ok, dist, truncated


def compute_fpfh_from_normals_checked(cloud: Cloud, normals: torch.Tensor, radius: float, max_neighbors: int = 64):
    """FPFH features (N, 33) and the 0-d ``truncated`` flag (compute_spfh)
    from oriented normals: fpfh_i = sum over the radius neighbours j != i
    of spfh_j / dist_ij, each 11-bin segment then normalised to unit sum
    (ComputeFpfhImpl, fpfh.cpp:114-176)."""
    spfh, idx, nbr_ok, dist, truncated = compute_spfh(cloud, normals, radius, max_neighbors)
    is_self = idx == torch.arange(cloud.capacity, device=idx.device)[:, None]
    contrib_ok = nbr_ok & ~is_self & (dist > 0)
    w = torch.where(contrib_ok, 1.0 / torch.clamp(dist, min=1e-30), 0.0)  # fpfh.cpp:164-165
    feat = torch.einsum("nk,nkf->nf", w, spfh[idx])
    seg = feat.reshape(-1, 3, NUM_BINS)
    seg_sum = seg.sum(-1, keepdim=True)
    seg = torch.where(seg_sum > 0, seg / torch.clamp(seg_sum, min=1e-30), seg)  # :169-174
    return seg.reshape(-1, FPFH_SIZE), truncated


def compute_fpfh_from_normals(cloud: Cloud, normals: torch.Tensor, radius: float, max_neighbors: int = 64):
    """FPFH features (N, 33); see compute_fpfh_from_normals_checked."""
    return compute_fpfh_from_normals_checked(cloud, normals, radius, max_neighbors)[0]


def compute_fpfh_checked(
    cloud: Cloud,
    viewpoint: torch.Tensor,
    normal_k: int = 16,
    feature_radius: float = 0.5,
    max_neighbors: int = 64,
):
    """ComputeFpfh (fpfh.cpp:238-254): k-NN PCA normals, faced toward the
    viewpoint, then FPFH; with the 0-d truncation flag."""
    n = normals_mod.knn_pca_normals(cloud, k=normal_k)
    n = normals_mod.orient_normals(cloud.points, n, viewpoint)
    return compute_fpfh_from_normals_checked(cloud, n, feature_radius, max_neighbors)


def compute_fpfh(
    cloud: Cloud,
    viewpoint: torch.Tensor,
    normal_k: int = 16,
    feature_radius: float = 0.5,
    max_neighbors: int = 64,
):
    """FPFH features (N, 33); see compute_fpfh_checked."""
    return compute_fpfh_checked(cloud, viewpoint, normal_k, feature_radius, max_neighbors)[0]


def ball_counts(cloud: Cloud, radius: float, chunk: int = 1024) -> torch.Tensor:
    """Valid points (self included) within ``radius`` of each point (N,),
    0 for invalid points: the true radiusSearch ball (fpfh.cpp:133-147)
    that compute_spfh's cap must cover. Direct differences, chunked."""
    pts = cloud.points.to(torch.float32)
    r2 = float(np.float32(radius) * np.float32(radius))  # squared in f32, as JAX does
    counts = []
    for start in range(0, cloud.capacity, chunk):
        pc = pts[start : start + chunk]
        d2 = ((pc[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        cnt = ((d2 <= r2) & cloud.mask[None, :]).sum(-1)
        counts.append(torch.where(cloud.mask[start : start + chunk], cnt, 0))
    return torch.cat(counts)


def densest_ball_count(cloud: Cloud, radius: float) -> int:
    """Occupancy of the densest radius ball (a host int, self included)."""
    return int(ball_counts(cloud, radius).max())


def ball_truncated(cloud: Cloud, radius: float, max_neighbors: int) -> bool:
    """True if some point's radius ball holds more than ``max_neighbors``
    points, so the cap would drop radiusSearch neighbours."""
    return densest_ball_count(cloud, radius) > max_neighbors


def auto_max_neighbors(*clouds_radius: tuple[Cloud, float], floor: int = 32) -> int:
    """The smallest multiple of 16 (at least ``floor``) that covers every
    radius ball of every (cloud, radius) pair, capped at the largest
    capacity."""
    need = floor
    for cloud, radius in clouds_radius:
        need = max(need, densest_ball_count(cloud, radius))
    k = (need + 15) // 16 * 16
    return min(k, max(c.capacity for c, _ in clouds_radius)) if clouds_radius else k


def compute_matches(
    src_fpfh: torch.Tensor,
    dst_fpfh: torch.Tensor,
    src_mask: torch.Tensor,
    dst_mask: torch.Tensor,
    num_matches: int = 2,
):
    """k-NN in the 33-D feature space (ComputeMatches, fpfh.cpp:282-296):
    (indices (N, k), squared distances (N, k)). Invalid sources get
    matches too; callers mask them."""
    del src_mask
    return correspond.knn(src_fpfh, Cloud(points=dst_fpfh, mask=dst_mask), num_matches)


def prune_matches_lowe(
    matches: torch.Tensor,  # (N, 2) candidate dst indices
    src_fpfh: torch.Tensor,
    dst_fpfh: torch.Tensor,
    lowe_ratio: float = 0.9,
    src_mask: torch.Tensor | None = None,
):
    """Lowe's ratio test with Gaussian feature-distance weights
    (PruneMatchesLowe, rs_align_app.cpp:177-217): the closer candidate is
    kept when d_best < lowe_ratio * d_other, weight exp(-d_best / 0.25^2).
    Returns (dst_index (N,), weight (N,), keep (N,))."""
    d0 = ((src_fpfh - dst_fpfh[matches[:, 0]]) ** 2).sum(-1)
    d1 = ((src_fpfh - dst_fpfh[matches[:, 1]]) ** 2).sum(-1)
    first_closer = d0 < d1
    d_best = torch.where(first_closer, d0, d1)
    d_other = torch.where(first_closer, d1, d0)
    j_best = torch.where(first_closer, matches[:, 0], matches[:, 1])
    keep = d_best < lowe_ratio * d_other
    if src_mask is not None:
        keep = keep & src_mask
    weight = torch.exp(-d_best / (0.25 * 0.25))  # rs_align_app.cpp:199
    return j_best, torch.where(keep, weight, 0.0), keep
