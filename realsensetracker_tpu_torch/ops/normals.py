"""Surface normals: k-NN PCA on clouds, central differences on vertex maps.

Port of realsensetracker_tpu/ops/normals.py:

* ``knn_pca_normals`` and ``orient_normals`` follow the reference's
  ComputeNormals / OrientNormals (point_cloud_utils.cpp:176-216): dense
  k-NN (self included), the neighbourhood's scatter matrix, the
  eigenvector of its smallest eigenvalue, flipped to face a viewpoint;
* ``grid_normals`` is the plain composition the CUDA level kernel
  (kernels/level_kernel.py) is held against.

``torch.linalg.eigh`` on a CUDA tensor checks its result on the host: one
stream sync per call.
"""

from __future__ import annotations

import torch

from realsensetracker_tpu_torch.ops import correspond
from realsensetracker_tpu_torch.ops.cloud import Cloud


def eigh(M: torch.Tensor):
    """``torch.linalg.eigh`` of symmetric (..., 3, 3) matrices, except that
    a matrix with a non-finite entry gets NaN eigenvalues and eigenvectors,
    as LAPACK's gives JAX, where torch's would raise."""
    finite = torch.isfinite(M).all(-1).all(-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    vals, vecs = torch.linalg.eigh(torch.where(finite[..., None, None], M, eye))
    return torch.where(finite[..., None], vals, torch.nan), torch.where(finite[..., None, None], vecs, torch.nan)


def neighbourhood_scatter(points: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor):
    """Unnormalised scatter matrices (N, 3, 3) of the k-NN sets ``idx``
    (N, k) about their centroids, and the count of real neighbours (N,).
    Entries at _BIG distance (fewer valid candidates than k) are weighted
    out: phantom zero rows would pull a sparse cloud's neighbourhoods
    toward the origin."""
    real = d2 < 1e29
    wn = real.to(points.dtype)[..., None]
    cnt = torch.clamp(real.sum(-1), min=1).to(points.dtype)
    nbrs = points[idx]  # (N, k, 3)
    ctr = (nbrs * wn).sum(-2, keepdim=True) / cnt[:, None, None]
    delta = (nbrs - ctr) * wn
    return torch.einsum("nki,nkj->nij", delta, delta), cnt


def knn_pca_normals(cloud: Cloud, k: int = 16) -> torch.Tensor:
    """Per-point PCA normals (N, 3) over the k nearest neighbours, the
    point itself included, of unit length and arbitrary sign."""
    idx, d2 = correspond.knn(cloud.points, cloud, k)
    cov, _ = neighbourhood_scatter(cloud.points, idx, d2)
    # eigh's eigenvalues ascend: column 0 belongs to the smallest.
    return eigh(cov)[1][..., :, 0]


def orient_normals(points: torch.Tensor, normals: torch.Tensor, viewpoint: torch.Tensor) -> torch.Tensor:
    """Flip normals to face the viewpoint: where (p - viewpoint) . n > 0."""
    flip = ((points - viewpoint) * normals).sum(-1) > 0
    return torch.where(flip[..., None], -normals, normals)


def grid_normals(vertex_map: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normals of a vertex map (..., H, W, 3) -> (normals, normal_valid).

    A normal is valid where the pixel and its 4 neighbours are valid, the
    cross product is non-degenerate and the pixel is not on the border.
    Normals face the camera (n . p <= 0) and are zero where invalid.
    """
    right = torch.roll(vertex_map, -1, dims=-2)
    left = torch.roll(vertex_map, 1, dims=-2)
    down = torch.roll(vertex_map, -1, dims=-3)
    up = torch.roll(vertex_map, 1, dims=-3)
    n = torch.linalg.cross(right - left, down - up, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ok = (
        valid
        & torch.roll(valid, -1, dims=-1)
        & torch.roll(valid, 1, dims=-1)
        & torch.roll(valid, -1, dims=-2)
        & torch.roll(valid, 1, dims=-2)
        & (norm[..., 0] > 1e-12)
    )
    # Border pixels wrap with roll; mark them invalid.
    h, w = vertex_map.shape[-3], vertex_map.shape[-2]
    row = torch.arange(h, device=valid.device)[:, None]
    col = torch.arange(w, device=valid.device)
    ok = ok & (row > 0) & (row < h - 1) & (col > 0) & (col < w - 1)
    n = n / torch.clamp(norm, min=1e-12)
    # Orient toward the camera at the origin: want n . p < 0.
    flip = (n * vertex_map).sum(-1) > 0
    n = torch.where(flip[..., None], -n, n)
    n = torch.where(ok[..., None], n, 0.0)
    return n, ok
