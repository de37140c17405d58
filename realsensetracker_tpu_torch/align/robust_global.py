"""Robust global registration: GNC-TLS rotation + component-wise translation.

Port of realsensetracker_tpu/align/robust_global.py, the dense replacement
for the reference's TEASER++ bridge (teaser_interface.cpp:20-133): GNC_TLS
rotation (at most 2048 rounds, gnc_factor 1.4, cost threshold 1e-6),
cbar2 = 1, no scale, the k-core screen in place of exact max clique, mutual
FPFH matches and at least 3 of them (:66-99). The steps:

1. mutual 1-NN feature matching (two dense searches);
2. the pairwise consistency graph, ||p_i - p_j| - |q_i - q_j|| <= 2
   noise_bound, screened to its MAXIMUM k-core: a binary search over k,
   each probe peeling vertices of degree < k to a fixed point;
3. GNC-TLS rotation over translation-invariant measurements (TIMs) of a
   shifted-pair basis, by weighted rotation-only Kabsch;
4. per axis, the translation window with the most votes, averaged.

JAX's while_loops become Python loops whose state stays on the device; the
host reads a stop flag every few rounds. Extra peel rounds after a fixed
point change nothing; the GNC state freezes (torch.where) from the round
that stops it, so its rotation is the one JAX returns. Each GNC round's
SVD checks its result on the host (align/kabsch.py), one sync per round.
``ITERATIONS`` counts the peel and GNC rounds run, for the card's smoke run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from realsensetracker_tpu_torch.align.kabsch import rotation_from_cross_covariance
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops import correspond
from realsensetracker_tpu_torch.ops.cloud import Cloud

PEEL_CHECK_EVERY = 4  # peel rounds between host reads of "changed"
GNC_CHECK_EVERY = 8  # GNC rounds between host reads of "done"
ITERATIONS = {"peel": 0, "gnc": 0}  # rounds run, including those after a stop


class RobustRegistrationResult(NamedTuple):
    transform: torch.Tensor  # (4, 4)
    valid: torch.Tensor  # bool: enough consistent correspondences
    num_correspondences: torch.Tensor
    num_inliers: torch.Tensor
    rotation_inlier_fraction: torch.Tensor


def mutual_matches(src_feats: torch.Tensor, dst_feats: torch.Tensor, src_mask: torch.Tensor, dst_mask: torch.Tensor):
    """Cross-checked 1-NN feature correspondences (Matcher cross_check=true,
    teaser_interface.cpp:66-68): (dst_index (N,), keep (N,))."""
    fwd_idx, _ = correspond.nearest_neighbors(src_feats, Cloud(dst_feats, dst_mask))
    bwd_idx, _ = correspond.nearest_neighbors(dst_feats, Cloud(src_feats, src_mask))
    keep = (bwd_idx[fwd_idx] == torch.arange(src_feats.shape[0], device=fwd_idx.device)) & src_mask
    return fwd_idx, keep


def _core_at(adj: torch.Tensor, keep: torch.Tensor, k) -> torch.Tensor:
    """Peel vertices of degree < k (simultaneous removal) until nothing
    changes, at most N rounds, as JAX's while_loop; the host checks for a
    change every PEEL_CHECK_EVERY rounds."""
    n = keep.shape[0]
    alive = keep
    for start in range(0, n, PEEL_CHECK_EVERY):
        before = alive
        for _ in range(min(PEEL_CHECK_EVERY, n - start)):
            alive = alive & ((adj & alive[None, :]).sum(-1) >= k)
            ITERATIONS["peel"] += 1
        if not bool((alive != before).any()):
            break
    return alive


def max_kcore(adj: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Membership (N,) of the maximum non-empty k-core of ``adj``.

    The dense surrogate of TEASER's max-clique screen (teaser_interface.cpp:
    92-99): a clique of size c lies in the (c-1)-core. adj: (N, N) bool
    symmetric (self-loops ignored); keep: (N,) bool candidates. All-False
    iff keep is all-False.
    """
    n = keep.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    adj = adj & ~eye & keep[:, None] & keep[None, :]
    # The largest k with a non-empty k-core: core_at(0) == keep, and a
    # degree below n bounds k. lo stays feasible.
    lo = torch.zeros((), dtype=torch.int64, device=adj.device)
    hi = torch.full((), n, dtype=torch.int64, device=adj.device)
    best = keep
    for _ in range(max(1, math.ceil(math.log2(n + 1)) + 1)):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        core = _core_at(adj, keep, mid)
        nonempty = core.any()
        lo = torch.where(nonempty, mid, lo)
        hi = torch.where(nonempty, hi, mid - 1)
        best = torch.where(nonempty, core, best)
    return best


def _gnc_tls_rotation(
    a: torch.Tensor,  # (M, 3) source TIMs
    b: torch.Tensor,  # (M, 3) destination TIMs
    mask: torch.Tensor,  # (M,)
    noise_bound: float,
    max_iters: int = 2048,
    gnc_factor: float = 1.4,
    cost_threshold: float = 1e-6,
):
    """GNC-TLS rotation (teaser params, teaser_interface.cpp:83-91): weighted
    rotation-only Kabsch -> TLS residuals -> GNC weights, mu *= gnc_factor,
    until |cost - prev| <= cost_threshold * prev (a relative form of
    TEASER's rotation_cost_threshold exit), a non-finite cost, or max_iters.
    The round that stops the loop gives the rotation. Returns (R, inliers)."""
    m = mask.to(torch.float32)
    cbar2 = noise_bound * noise_bound  # cbar2 multiplier = 1 (:81)

    def solve_rotation(w):
        return rotation_from_cross_covariance((b * w[:, None]).T @ a)

    def sq_residuals(R):
        return ((b - torch.matmul(a, R.T)) ** 2).sum(-1)

    # mu starts from the largest residual (the standard GNC-TLS schedule).
    R = solve_rotation(m)
    r2_max = torch.clamp((sq_residuals(R) * m).max(), min=cbar2 * (1.0 + 1e-6))
    mu = 1.0 / (2.0 * r2_max / cbar2 - 1.0)
    # A NEGATIVE first prev_cost: |cost - prev| <= thr * prev cannot hold in
    # round 0 (an inf sentinel would satisfy inf <= inf).
    prev_cost = torch.full((), -1.0, dtype=torch.float32, device=a.device)
    done = torch.zeros((), dtype=torch.bool, device=a.device)
    for i in range(max_iters):
        r2 = sq_residuals(R)
        lo = mu / (mu + 1.0) * cbar2
        hi = (mu + 1.0) / mu * cbar2
        w_mid = torch.sqrt(cbar2 * mu * (mu + 1.0) / torch.clamp(r2, min=1e-30)) - mu
        w = torch.where(r2 <= lo, 1.0, torch.where(r2 >= hi, 0.0, torch.clamp(w_mid, 0.0, 1.0))) * m
        R_new = solve_rotation(w)
        cost = (w * r2).sum()
        # A non-finite cost (NaN TIMs) never meets the test: stop on it.
        stop = ((cost - prev_cost).abs() <= cost_threshold * prev_cost) | ~torch.isfinite(cost)
        R = torch.where(done, R, R_new)
        mu = torch.where(done, mu, mu * gnc_factor)
        prev_cost = torch.where(done, prev_cost, cost)
        done = done | stop
        ITERATIONS["gnc"] += 1
        if (i + 1) % GNC_CHECK_EVERY == 0 and bool(done):
            break
    return R, (sq_residuals(R) <= cbar2) & mask


def _consensus_translation(t_cand: torch.Tensor, mask: torch.Tensor, beta: float) -> torch.Tensor:
    """Per axis, the candidate whose +-beta window holds the most votes (the
    first such), then the mean of that window (TEASER's adaptive voting)."""
    out = []
    for x in t_cand.unbind(-1):
        votes = ((x[:, None] - x[None, :]).abs() <= beta) & mask[None, :] & mask[:, None]
        sel = votes[torch.argmax(votes.sum(-1))].to(x.dtype)
        out.append((x * sel).sum() / torch.clamp(sel.sum(), min=1.0))
    return torch.stack(out)


def symmetric_overlap(T: torch.Tensor, src: Cloud, dst: Cloud, tau):
    """Fractions of src within tau of dst under T (src -> dst), and of dst
    within tau of src under T^-1: a correct registration makes the
    overlapping surfaces meet both ways."""
    R, t = T[:3, :3], T[:3, 3]
    tau2 = torch.as_tensor(tau, dtype=torch.float32, device=T.device) ** 2
    _, d2f = correspond.nearest_neighbors(torch.matmul(src.points, R.T) + t, dst)
    fwd = ((d2f < tau2) & src.mask).sum() / torch.clamp(src.mask.sum(), min=1)
    t_inv = -torch.matmul(R.T, t)
    _, d2b = correspond.nearest_neighbors(torch.matmul(dst.points, R) + t_inv, src)
    bwd = ((d2b < tau2) & dst.mask).sum() / torch.clamp(dst.mask.sum(), min=1)
    return fwd, bwd


def _pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """|x_i - x_j| (N, N), summed axis by axis without an (N, N, 3) tensor."""
    acc = None
    for c in range(x.shape[-1]):
        d = x[:, None, c] - x[None, :, c]
        d = d.mul_(d)
        acc = d if acc is None else acc.add_(d)
    return acc.sqrt_()


def register_robust(
    src: Cloud,
    dst: Cloud,
    src_feats: torch.Tensor,
    dst_feats: torch.Tensor,
    noise_bound: float = 0.25,
    max_tims: int = 1024,
    gnc_iters: int = 2048,  # a bound: the GNC loop stops at TEASER's cost threshold
) -> RobustRegistrationResult:
    """Robust global registration (ref RegisterTeaser,
    teaser_interface.cpp:20-133): mutual feature matches -> max-k-core
    screen -> GNC-TLS rotation on TIMs -> consensus translation."""
    n = src.capacity
    match_idx, keep = mutual_matches(src_feats, dst_feats, src.mask, dst.mask)
    p = src.points
    q = dst.points[match_idx]

    # True inliers are mutually consistent (a clique); structured outlier
    # groups form smaller cliques, which the maximum core leaves out.
    compat = (_pairwise_dist(p) - _pairwise_dist(q)).abs() <= 2.0 * noise_bound
    compat = compat & keep[:, None] & keep[None, :]
    screened = max_kcore(compat, keep)

    # TIMs from a shifted-pair basis (chain + strides), at most max_tims each.
    m = min(max_tims, n)
    base = torch.arange(m, device=p.device)
    shifts = (1, 2, 5, 11)
    idx_i = torch.cat([base for _ in shifts])
    idx_j = torch.cat([(base + s) % n for s in shifts])
    tim_mask = screened[idx_i] & screened[idx_j]
    R, rot_inliers = _gnc_tls_rotation(p[idx_i] - p[idx_j], q[idx_i] - q[idx_j], tim_mask, 2.0 * noise_bound,
                                       max_iters=gnc_iters)

    t = _consensus_translation(q - torch.matmul(p, R.T), screened, noise_bound)
    resid = torch.linalg.vector_norm(q - (torch.matmul(p, R.T) + t), dim=-1)
    n_corr = keep.sum()
    return RobustRegistrationResult(
        transform=se3.from_rt(R, t),
        valid=n_corr > 3,  # teaser_interface.cpp:71-73
        num_correspondences=n_corr,
        num_inliers=(screened & (resid <= noise_bound)).sum(),
        rotation_inlier_fraction=rot_inliers.sum() / torch.clamp(tim_mask.sum(), min=1),
    )
