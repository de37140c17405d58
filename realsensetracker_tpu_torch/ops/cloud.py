"""Masked fixed-capacity point clouds and basic reductions.

Port of realsensetracker_tpu/ops/cloud.py. A cloud is an (N, 3) tensor
plus a boolean validity mask: "removing" a point clears its mask bit, and
every reduction is mask-weighted, so no cloud ever takes a size that
depends on the data (that would copy a count to the host and stall the
stream).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.geometry.camera import reciprocal


class Cloud(NamedTuple):
    """Fixed-capacity point cloud: points (..., N, 3), mask (..., N) bool."""

    points: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> torch.Tensor:
        """Number of valid points (a device tensor)."""
        return self.mask.sum(-1)


def from_points(points: torch.Tensor, mask: torch.Tensor | None = None) -> Cloud:
    if mask is None:
        mask = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    return Cloud(points=points, mask=mask)


def mask_nonfinite(cloud: Cloud) -> Cloud:
    """Clear the mask of points with a non-finite coordinate and zero them."""
    mask = cloud.mask & torch.isfinite(cloud.points).all(-1)
    return Cloud(points=torch.where(mask[..., None], cloud.points, 0.0), mask=mask)


def centroid(cloud: Cloud) -> torch.Tensor:
    """Mask-weighted centroid."""
    w = cloud.mask.to(cloud.points.dtype)
    total = w.sum(-1)
    s = (cloud.points * w[..., None]).sum(-2)
    return s / torch.clamp(total, min=1.0)[..., None]


def weighted_centroid(points: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    total = weights.sum(-1)
    s = (points * weights[..., None]).sum(-2)
    return s / torch.clamp(total, min=1e-12)[..., None]


def extents(cloud: Cloud) -> tuple[torch.Tensor, torch.Tensor]:
    """Axis-aligned bounding box of the valid points."""
    big = torch.finfo(cloud.points.dtype).max
    m = cloud.mask[..., None]
    return (
        torch.where(m, cloud.points, big).amin(-2),
        torch.where(m, cloud.points, -big).amax(-2),
    )


def subsample_to_capacity(cloud: Cloud, capacity: int) -> Cloud:
    """Reduce a front-compacted cloud (N, 3) to ``capacity`` rows, spatially
    uniform: ``capacity`` evenly spaced survivors when more than that are
    valid (a head slice would crop the high-x end of the key-sorted
    voxel survivors), an exact pass-through otherwise. Requires the valid
    rows compacted to the front, as downsample_voxel leaves them. A
    capacity above N repeats row N-1 in the masked tail, as JAX's clamped
    gather does."""
    s = cloud.mask.sum().to(torch.int32)
    k = torch.arange(capacity, dtype=torch.int32, device=cloud.points.device)
    stride_idx = torch.floor(k.to(torch.float32) * (s.to(torch.float32) * reciprocal(capacity))).to(torch.int32)
    idx = torch.where(s > capacity, torch.minimum(stride_idx, s - 1), k)
    idx = torch.clamp(idx, max=cloud.capacity - 1).long()
    return Cloud(points=cloud.points[idx], mask=k < torch.clamp(s, max=capacity))


def pad_to_capacity(points, capacity: int, mask=None, device=device_mod.DEFAULT) -> Cloud:
    """Host-side variable-length points -> a Cloud of ``capacity`` rows on
    ``device``: the first n rows are the input, points beyond capacity are
    dropped."""
    device = device_mod.resolve(device)
    points = np.asarray(points, dtype=np.float32)
    n = min(points.shape[0], capacity)
    out = np.zeros((capacity, 3), dtype=np.float32)
    out[:n] = points[:n]
    m = np.zeros((capacity,), dtype=bool)
    m[:n] = True if mask is None else np.asarray(mask)[:n]
    return Cloud(points=torch.from_numpy(out).to(device), mask=torch.from_numpy(m).to(device))
