"""Voxel-hash world model, fixed capacity, device resident.

Port of realsensetracker_tpu/tracking/accumulator.py, the reference's
CloudAccumulator: one point per voxel, the FIRST point to claim a voxel
wins, voxel indices truncate toward zero. The map is a fixed-capacity
array plus packed int32 voxel keys; an insert is concat -> stable dedupe
preferring existing entries -> keep the lowest positions, all on the
device with no host copy, so the map stays on the card across a stream.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.ops import voxel
from realsensetracker_tpu_torch.ops.cloud import Cloud


class MapAccumulator(NamedTuple):
    points: torch.Tensor  # (C, 3) world-frame points
    keys: torch.Tensor  # (C,) packed voxel keys (int32)
    mask: torch.Tensor  # (C,) occupancy

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum()

    def extract_cloud(self) -> Cloud:
        return Cloud(points=self.points, mask=self.mask)


def init_map(capacity: int, device=device_mod.DEFAULT) -> MapAccumulator:
    device = device_mod.resolve(device)
    return MapAccumulator(
        points=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        keys=torch.full((capacity,), voxel.INVALID_KEY, dtype=torch.int32, device=device),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def add_cloud(acc: MapAccumulator, transform: torch.Tensor, cloud: Cloud, voxel_size: float = 0.05) -> MapAccumulator:
    """Insert a camera-frame cloud at pose ``transform`` (4, 4); existing
    voxel entries win over new points and nothing is ever evicted.

    Keys persist across inserts, so unlike downsample_voxel's they are not
    recentred: the 10-bit/axis key covers +-511 voxels around the world
    origin (+-25.6 m at 0.05 m voxels); geometry beyond clamps into the
    boundary voxels.
    """
    c = acc.capacity
    p_w = se3.transform_points(transform.to(torch.float32), cloud.points.to(torch.float32))
    new_keys = voxel.pack_keys(voxel.voxel_coords(p_w, voxel_size, mode="trunc"), cloud.mask)
    all_pts = torch.cat([acc.points, p_w])  # (C + N, 3)
    all_keys = torch.cat([acc.keys, new_keys])
    order = torch.argsort(all_keys, stable=True)  # ties: existing (lower position) first
    # Head flags back at their positions (order is a permutation), then the
    # C heads of lowest position: existing entries first, so the map never
    # evicts an old voxel to admit a new one.
    head_at_pos = torch.empty_like(all_keys, dtype=torch.bool).scatter_(0, order, voxel.segment_heads(all_keys[order]))
    surv = voxel.front_order(head_at_pos)[:c]
    ok = torch.arange(c, device=all_keys.device) < head_at_pos.sum()
    return MapAccumulator(
        points=torch.where(ok[:, None], all_pts[surv], 0.0),
        keys=torch.where(ok, all_keys[surv], voxel.INVALID_KEY),
        mask=ok,
    )
