"""Correspondence search: exact brute-force nearest neighbours.

Port of realsensetracker_tpu/ops/correspond.py. The reference queries a
KD-tree per point; here the squared-distance matrix is |a|^2 + |b|^2 -
2 a.b^T, the cross term one f32 ``torch.matmul`` (TF32 stays off, as the
JAX package asks XLA for HIGHEST precision), chunked over the queries to
bound memory: a 2048-query chunk against a 32768-point model is a 268 MB
matrix.

Every search breaks ties by the lower index, as ``jax.lax.top_k`` and the
NumPy oracles' stable argsort do: ``torch.topk`` alone does not, and on a
voxel grid, where equal distances are common, it returns other neighbour
sets.
"""

from __future__ import annotations

import torch

from realsensetracker_tpu_torch.ops.cloud import Cloud

_BIG = 1e30


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., N, M) between a (..., N, D) and b (..., M, D)."""
    a2 = (a * a).sum(-1)
    b2 = (b * b).sum(-1)
    cross = torch.matmul(a, b.transpose(-1, -2))
    d2 = a2[..., :, None] + b2[..., None, :]
    return torch.clamp_(d2.sub_(cross.mul_(2.0)), min=0.0)  # (a2 + b2) - 2 cross, in place


def _masked_sqdist(q: torch.Tensor, dst: Cloud) -> torch.Tensor:
    return pairwise_sqdist(q, dst.points).masked_fill_(~dst.mask[..., None, :], _BIG)


def nearest_neighbors(src_points: torch.Tensor, dst: Cloud, chunk: int = 2048):
    """Exact 1-NN of each src point (N, 3) among the valid dst points:
    (indices (N,) long, squared distances (N,)). Ties take the lowest
    index; an invalid dst point is never chosen while a valid one exists."""
    idx, d2 = [], []
    for q in torch.split(src_points, chunk):
        d = _masked_sqdist(q, dst)
        i = torch.argmin(d, dim=-1)
        idx.append(i)
        d2.append(torch.gather(d, 1, i[:, None])[:, 0])
    return torch.cat(idx), torch.cat(d2)


def k_smallest(d2: torch.Tensor, k: int):
    """The k smallest entries of each row of a non-negative f32 (n, m)
    matrix, nearest first, equal values in index order: (indices (n, k)
    long, values (n, k)). The key is the value's bits (monotone for floats
    >= 0) above the column index, so no two keys tie and ``topk`` has one
    answer."""
    col = torch.arange(d2.shape[-1], device=d2.device)
    key = (d2.view(torch.int32).to(torch.int64) << 32) | col
    i = torch.topk(key, k, dim=-1, largest=False, sorted=True).indices
    return i, torch.gather(d2, -1, i)


def knn(src_points: torch.Tensor, dst: Cloud, k: int, chunk: int = 1024):
    """Exact k-NN: (indices (N, k) long, squared distances (N, k)), nearest
    first, ties to the lower index."""
    idx, d2 = [], []
    for q in torch.split(src_points, chunk):
        i, dist = k_smallest(_masked_sqdist(q, dst), k)
        idx.append(i)
        d2.append(dist)
    return torch.cat(idx), torch.cat(d2)


def knn_self(points: Cloud, k: int, chunk: int = 1024):
    """k nearest neighbours of each point within its own cloud, self
    excluded (the reference's k+1-then-skip-self, point_cloud_utils.cpp:
    104-127): each query's own column takes _BIG, as do invalid points.
    (indices (N, k) long, squared distances (N, k)), nearest first, ties to
    the lower index."""
    idx, d2 = [], []
    for start in range(0, points.capacity, chunk):
        q = points.points[start : start + chunk]
        d = _masked_sqdist(q, points)
        d.diagonal(offset=start).fill_(_BIG)  # entry (r, start + r): the query itself
        i, dist = k_smallest(d, k)
        idx.append(i)
        d2.append(dist)
    return torch.cat(idx), torch.cat(d2)
