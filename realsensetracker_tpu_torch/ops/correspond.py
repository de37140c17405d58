"""Correspondence search: exact brute-force nearest neighbours.

Port of realsensetracker_tpu/ops/correspond.py (``knn_self`` waits for the
k-NN normals of ROADMAP queue 1 item 7). The reference queries a KD-tree
per point; here the squared-distance matrix is |a|^2 + |b|^2 - 2 a.b^T,
the cross term one f32 ``torch.matmul`` (TF32 stays off, as the JAX
package asks XLA for HIGHEST precision), chunked over the queries to bound
memory: a 2048-query chunk against a 32768-point model is a 268 MB matrix.
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


def knn(src_points: torch.Tensor, dst: Cloud, k: int, chunk: int = 1024):
    """Exact k-NN: (indices (N, k) long, squared distances (N, k)), nearest
    first."""
    idx, d2 = [], []
    for q in torch.split(src_points, chunk):
        dist, i = torch.topk(_masked_sqdist(q, dst), k, dim=-1, largest=False, sorted=True)
        idx.append(i)
        d2.append(dist)
    return torch.cat(idx), torch.cat(d2)
