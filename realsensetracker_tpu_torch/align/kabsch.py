"""Weighted Kabsch rigid alignment (SVD).

Port of realsensetracker_tpu/align/kabsch.py, with the reference's quirks
(SolveKabsch, align_icp.cpp:18-71):

* centroids are UNWEIGHTED means over the matched pairs even when weights
  are given;
* the cross-covariance accumulates in float64, always (the JAX package
  does so under the test suite's x64; on the TPU it cannot);
* the reflection fix flips the third column of the composed R = U V^T;
* t = dst_mean - R @ src_mean.

``torch.linalg.svd`` on a CUDA tensor stalls the host twice per call, both
inside the op (traced on an H100 by chip_smoke.py's sync_ops, phases icp
and model): cuSOLVER's gesvdj convergence check copies its status to
pageable host memory (``aten::to`` in ``aten::_linalg_svd``), and the
result check reads the info (``aten::_linalg_check_errors``). So cloud ICP
makes two syncs per iteration. The SVD stays for exact semantics on
rank-deficient covariances; a closed-form 3x3 SVD would remove both.
"""

from __future__ import annotations

import torch

from realsensetracker_tpu_torch.geometry import se3


def _det3(R: torch.Tensor) -> torch.Tensor:
    """det of (..., 3, 3) as r0 . (r1 x r2), elementwise: no LU, no host copy."""
    return (R[..., 0, :] * torch.linalg.cross(R[..., 1, :], R[..., 2, :], dim=-1)).sum(-1)


def rotation_from_cross_covariance(cov: torch.Tensor) -> torch.Tensor:
    """R = U V^T of a 3x3 cross-covariance (dst-centred x src-centred^T) in
    f32, its third column flipped where det(R) < 0, as the reference does.
    A non-finite covariance gives a NaN rotation, as LAPACK's SVD gives
    JAX, where torch's would raise."""
    finite = torch.isfinite(cov).all(-1).all(-1)[..., None, None]
    # Two host syncs on a CUDA tensor (module docstring).
    u, _, vt = torch.linalg.svd(torch.where(finite, cov, torch.eye(3, dtype=cov.dtype, device=cov.device)))
    R = torch.where(finite, u @ vt, torch.nan).to(torch.float32)
    sign = torch.where(_det3(R) < 0, -1.0, 1.0)
    return torch.cat([R[..., :, :2], R[..., :, 2:] * sign[..., None, None]], dim=-1)


def kabsch_from_cross_covariance(cov: torch.Tensor, src_mean: torch.Tensor, dst_mean: torch.Tensor) -> torch.Tensor:
    """Rotation from a 3x3 cross-covariance with the reference's det fix,
    then the translation: a (..., 4, 4) f32 pose."""
    R = rotation_from_cross_covariance(cov)
    t = dst_mean - (R @ src_mean[..., :, None])[..., 0]
    return se3.from_rt(R, t)


def solve_kabsch(
    src_points: torch.Tensor,
    dst_points: torch.Tensor,
    weights: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rigid transform aligning matched src -> dst pairs (..., N, 3).

    ``mask`` marks valid pairs; ``weights`` scale only the covariance terms.
    """
    acc = torch.float64
    if mask is None:
        mask = torch.ones(src_points.shape[:-1], dtype=torch.bool, device=src_points.device)
    m = mask.to(acc)
    n = torch.clamp(m.sum(-1), min=1.0)
    src64 = src_points.to(acc)
    dst64 = dst_points.to(acc)
    src_mean = (src64 * m[..., None]).sum(-2) / n[..., None]
    dst_mean = (dst64 * m[..., None]).sum(-2) / n[..., None]
    w = m if weights is None else m * weights.to(acc)
    ds = (src64 - src_mean[..., None, :]) * w[..., None]
    dd = dst64 - dst_mean[..., None, :]
    cov = dd.transpose(-1, -2) @ ds
    return kabsch_from_cross_covariance(cov, src_mean.to(torch.float32), dst_mean.to(torch.float32))
