"""GICP: plane-to-plane registration with Mahalanobis whitening.

Port of realsensetracker_tpu/align/gicp.py, the reference's Ceres stack
(align_gicp.cpp + gicp_cost.hpp) as an analytic damped Gauss-Newton solver
on se(3):

* per-point covariances as ComputeCovariances (point_cloud_utils.cpp:
  100-161): 32-NN without self, scatter / (k - 1), or the GICP remap of
  the singular values to (1, 1, 1e-2);
* residual r = (C_dst + R C_src R^T)^{-1/2} (R p + t - q) (gicp_cost.hpp:
  40-73), the whitening held fixed within a GN step, or differentiated
  through its eigendecomposition ("autodiff", as Ceres's Jets do);
* Ceres HuberLoss(0.5) IRLS weights (align_gicp.cpp:67);
* 16 outer rounds of 1-NN correspondences, each a fixed number of damped
  GN steps seeded from the running estimate (align_gicp.cpp:105-163).

JAX's fori_loops become Python loops whose carry stays on the device. One
thing stops the stream: ``torch.linalg.eigh`` on a CUDA tensor checks its
result on the host, one sync per call -- with "fixed" whitening one per GN
step and one per round's cost, 144 per call at the defaults. It stays, as
GNC-ICP's SVD does, for exact semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops import correspond
from realsensetracker_tpu_torch.ops.cloud import Cloud
from realsensetracker_tpu_torch.ops.normals import eigh, neighbourhood_scatter


def compute_covariances(cloud: Cloud, k: int = 32, use_gicp: bool = False) -> torch.Tensor:
    """Per-point neighbourhood covariances (N, 3, 3) over the k nearest
    neighbours without self, centred on their centroid: scatter / (k - 1),
    or (use_gicp) U diag(1, 1, 1e-2) U^T with U the scatter's eigenvectors
    by descending eigenvalue."""
    idx, d2 = correspond.knn_self(cloud, k)
    cov, cnt = neighbourhood_scatter(cloud.points, idx, d2)
    if use_gicp:
        # A symmetric PSD matrix: singular vectors = eigenvectors, the
        # descending singular values = the ascending eigenvalues reversed.
        u = eigh(cov)[1].flip(-1)
        vals = torch.tensor([1.0, 1.0, 1e-2], dtype=cov.dtype, device=cov.device)
        return (u * vals) @ u.transpose(-1, -2)
    return cov / torch.clamp(cnt - 1.0, min=1.0)[:, None, None]


def _inv_sqrt_parts(M: torch.Tensor):
    """(eigenvectors, clamped eigenvalues, their rsqrt) of PSD (..., 3, 3)."""
    vals, vecs = eigh(M)
    lam = torch.clamp(vals, min=1e-12)
    return vecs, lam, torch.rsqrt(lam)


def _whitening(M: torch.Tensor) -> torch.Tensor:
    """Symmetric inverse square root of PSD (..., 3, 3) matrices
    (gicp_cost.hpp:57-68)."""
    vecs, _, f = _inv_sqrt_parts(M)
    return (vecs * f[..., None, :]) @ vecs.transpose(-1, -2)


def _divided_differences(M: torch.Tensor):
    """(V, G) with G_ij = (f(l_i) - f(l_j)) / (l_i - l_j) for f = rsqrt
    over the eigenvalues l of M, guarded to f'(l) = -1/2 l^{-3/2} where the
    gap vanishes: the Daleckii-Krein table of the derivative of M^{-1/2},
    finite at repeated eigenvalues."""
    vecs, lam, f = _inv_sqrt_parts(M)
    li, lj = lam[..., :, None], lam[..., None, :]
    gap = li - lj
    small = gap.abs() < 1e-9 * torch.maximum(li, lj)
    deriv = -0.5 * torch.rsqrt(li) / li
    G = torch.where(small, deriv, (f[..., :, None] - f[..., None, :]) / torch.where(small, 1.0, gap))
    return vecs, G


def _apply_table(V: torch.Tensor, G: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """V (G * (V^T X V)) V^T."""
    Vt = V.transpose(-1, -2)
    return V @ (G * (Vt @ X @ V)) @ Vt


class _WhiteningDiff(torch.autograd.Function):
    """_whitening with the derivative of the matrix FUNCTION M^{-1/2}.

    Ceres differentiates gicp_cost.hpp:57-68 through the eigendecomposition
    with Jets. ``eigh``'s own derivative divides by eigenvalue gaps,
    singular at the repeated eigenvalues an isotropic neighbourhood gives;
    here dW = V (G * (V^T dM V)) V^T with the Daleckii-Krein table G of
    _divided_differences, finite for any PSD input. G is symmetric, so the
    adjoint applies the same table to the (symmetrised) cotangent. The vmap
    rule is generated, so ``torch.func.jacfwd`` runs through it.
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(M):
        return _whitening(M)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (M,) = inputs
        ctx.save_for_forward(M)
        ctx.save_for_backward(M)

    @staticmethod
    def jvp(ctx, dM):
        (M,) = ctx.saved_tensors
        return _apply_table(*_divided_differences(M), dM)

    @staticmethod
    def backward(ctx, dW):
        (M,) = ctx.saved_tensors
        return _apply_table(*_divided_differences(M), 0.5 * (dW + dW.transpose(-1, -2)))


def _whitening_diff(M: torch.Tensor) -> torch.Tensor:
    """_whitening, differentiable by the Daleckii-Krein formula."""
    return _WhiteningDiff.apply(M)


def _huber_weight(s: torch.Tensor, delta: float) -> torch.Tensor:
    """Ceres HuberLoss rho'(s) for the squared residual norm s, b = delta^2."""
    b = delta * delta
    return torch.where(s <= b, 1.0, torch.sqrt(b / torch.clamp(s, min=1e-30)))


class GicpResult(NamedTuple):
    transform: torch.Tensor  # (4, 4)
    cost: torch.Tensor  # 0.5 * sum rho(|r|^2), Ceres final_cost convention
    num_valid: torch.Tensor


def solve_alignment(
    src_points: torch.Tensor,  # (N, 3) matched source points
    dst_points: torch.Tensor,  # (N, 3) matched destination points
    src_covs: torch.Tensor,  # (N, 3, 3)
    dst_covs: torch.Tensor,  # (N, 3, 3)
    pair_mask: torch.Tensor,  # (N,)
    seed: torch.Tensor,  # (4, 4)
    inner_iters: int = 8,
    huber_delta: float = 0.5,
    damping: float = 1e-6,
    whitening: str = "fixed",
):
    """Inner NLLS solve (ref inner ComputeAlignment, align_gicp.cpp:41-103):
    ``inner_iters`` damped Gauss-Newton steps with re-whitening, then the
    cost at the returned transform. Returns (T, cost).

    whitening: "fixed" holds W constant within a step (the standard GICP
    linearisation, one eigh per step); "autodiff" takes J = dr/d(delta)
    through the whitening with ``torch.func.jacfwd``, as Ceres does. The
    two share every fixed point.
    """
    if whitening not in ("fixed", "autodiff"):
        raise ValueError(f"whitening must be 'fixed' or 'autodiff', got {whitening!r}")
    m = pair_mask.to(torch.float32)
    eye6 = torch.eye(6, dtype=torch.float32, device=seed.device)

    def residuals_at(T):
        """Whitened residuals r(T) (N, 3), the transformed points and W."""
        R = se3.rotation(T)
        p = se3.transform_points(T, src_points)
        M = dst_covs + R @ src_covs @ R.T
        W = _whitening_diff(M)
        r = torch.einsum("nij,nj->ni", W, p - dst_points)
        return r, p, W

    T = seed
    for _ in range(inner_iters):
        r, p, W = residuals_at(T)
        w = _huber_weight((r * r).sum(-1), huber_delta) * m
        if whitening == "autodiff":
            def r_of_delta(delta, T=T):
                # exp of a (1, 6) twist: on a 0-d tensor, x / 24.0 in exp
                # gets a float64 tangent under forward-mode AD.
                return residuals_at(se3.compose(se3.exp(delta[None]), T)[0])[0]

            J = torch.func.jacfwd(r_of_delta)(torch.zeros(6, dtype=torch.float32, device=T.device))  # (N, 3, 6)
        else:
            # J_pt = [I | -hat(p')] for the left twist [v, w]; J = W J_pt.
            J = torch.cat([W, -torch.matmul(W, se3.hat(p))], dim=-1)  # (N, 3, 6)
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        g = torch.einsum("nri,nr->i", Jw, r)
        lam = damping * torch.trace(H) + 1e-12
        # solve_ex neither raises nor syncs on a singular system, where
        # jnp.linalg.solve returns non-finite values; both become delta = 0.
        x, info = torch.linalg.solve_ex(H + lam * eye6, g)
        delta = torch.where(torch.isfinite(x).all() & (info == 0), -x, 0.0)
        T = se3.compose(se3.exp(delta), T)

    # The cost AT the returned transform (Ceres final_cost).
    r, _, _ = residuals_at(T)
    s = (r * r).sum(-1)
    b = huber_delta * huber_delta
    rho = torch.where(s <= b, s, 2.0 * torch.sqrt(b * torch.clamp(s, min=0.0)) - b)
    return T, 0.5 * (rho * m).sum()


def align_gicp(
    src: Cloud,
    dst: Cloud,
    max_outer: int = 16,
    inner_iters: int = 8,
    cov_k: int = 32,
    use_gicp_cov: bool = False,
    huber_delta: float = 0.5,
    chunk: int = 2048,
    whitening: str = "fixed",
) -> GicpResult:
    """Full GICP (ref outer ComputeAlignment, align_gicp.cpp:105-163).

    The reference passes use_gicp=false to ComputeCovariances
    (align_gicp.cpp:121-123), so plain scatter / (k - 1) covariances are
    the default; use_gicp_cov=True gives the regularised variant.
    """
    src_covs = compute_covariances(src, cov_k, use_gicp_cov)
    dst_covs = compute_covariances(dst, cov_k, use_gicp_cov)
    T = se3.identity(device=src.points.device)
    # The cost seeds at inf: the reference aborts with infinity when the
    # very first solve degenerates (align_gicp.cpp:146-151).
    cost = torch.full((), float("inf"), dtype=torch.float32, device=T.device)
    for _ in range(max_outer):
        nn_idx, _ = correspond.nearest_neighbors(se3.transform_points(T, src.points), dst, chunk=chunk)
        T_new, cost_new = solve_alignment(
            src.points, dst.points[nn_idx], src_covs, dst_covs[nn_idx], src.mask, T,
            inner_iters=inner_iters, huber_delta=huber_delta, whitening=whitening,
        )
        # NaN guard (align_gicp.cpp:146-151): a rejected step keeps the
        # previous estimate AND its cost.
        ok = torch.isfinite(T_new).all() & torch.isfinite(cost_new)
        T = torch.where(ok, T_new, T)
        cost = torch.where(ok, cost_new, cost)
    return GicpResult(transform=T, cost=cost, num_valid=src.mask.sum())
