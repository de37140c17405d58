"""Voxel-grid operations: downsampling and key quantization.

Port of realsensetracker_tpu/ops/voxel.py. The reference keeps one point per
voxel in a hash map where the first point inserted wins; here that is
quantize -> pack a key -> stable sort -> segment heads -> compact, which
keeps the semantics exactly:

* one surviving point per occupied voxel;
* the survivor is the LOWEST-INDEX point of its voxel (the stable sort
  keeps the original order within a key);
* a fixed-capacity output with a validity mask, survivors at the front.

Nothing here copies to the host: the survivor count stays a device tensor.
"""

from __future__ import annotations

import torch

from realsensetracker_tpu_torch.geometry.camera import reciprocal
from realsensetracker_tpu_torch.ops.cloud import Cloud

# Packed voxel key layout: 10 bits per axis (coordinates clamped to +-511
# voxels around the origin) -> a 30-bit non-negative int32 key. One spare
# key value marks invalid points so they sort to the end.
_KEY_BITS = 10
_KEY_OFFSET = 1 << (_KEY_BITS - 1)  # 512
_KEY_MAX = (1 << _KEY_BITS) - 1
INVALID_KEY = 1 << 30


def voxel_coords(points: torch.Tensor, voxel_size: float, mode: str = "floor") -> torch.Tensor:
    """Integer voxel coordinates (int32): mode 'floor' as the reference's
    DownsampleVoxel, 'trunc' (toward zero) as its CloudAccumulator. The
    scale multiplies by the f32 reciprocal of voxel_size, as JAX's compiled
    voxel functions do (camera.reciprocal): keys are theirs bit for bit, on
    the CPU and on the card. (Eager JAX divides: a point lying exactly on a
    voxel face can then take the neighbouring key.)"""
    scaled = points * reciprocal(voxel_size)
    if mode == "floor":
        return torch.floor(scaled).to(torch.int32)
    if mode == "trunc":
        return scaled.to(torch.int32)  # truncation toward zero
    raise ValueError(mode)


def pack_keys(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pack (N, 3) int32 voxel coords into sortable non-negative int32 keys;
    masked points get INVALID_KEY."""
    c = torch.clamp(coords + _KEY_OFFSET, 0, _KEY_MAX)
    key = (c[..., 0] << (2 * _KEY_BITS)) | (c[..., 1] << _KEY_BITS) | c[..., 2]
    return torch.where(mask, key, INVALID_KEY)


def segment_heads(sorted_keys: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the first entry of each run of equal valid keys."""
    first = torch.ones(1, dtype=torch.bool, device=sorted_keys.device)
    return torch.cat([first, sorted_keys[1:] != sorted_keys[:-1]]) & (sorted_keys != INVALID_KEY)


def front_order(flags: torch.Tensor) -> torch.Tensor:
    """(N,) long permutation listing the True entries of ``flags`` in order,
    then the False ones in order (a stable argsort of ~flags, in O(N)).

    JAX compacts by scattering every False entry into slot N-1; on CUDA a
    scatter with repeated indices keeps an arbitrary one. Here each entry
    has a slot of its own, so the result is deterministic on every device.
    """
    n = flags.shape[0]
    pos = torch.arange(n, device=flags.device)
    csum = torch.cumsum(flags, 0)
    dest = torch.where(flags, csum - 1, csum[-1] + pos - csum)
    return torch.empty_like(pos).scatter_(0, dest, pos)


def voxel_select_indices(cloud: Cloud, voxel_size: float, mode: str = "floor"):
    """(indices (N,) long, mask (N,) bool): the surviving points (lowest
    index per voxel), compacted to the front in voxel-key order.

    Keys are recentred on the cloud's masked minimum voxel first, so the
    10-bit range binds on the cloud's span, not its distance from the
    origin (a scene 8 m out at 1 cm voxels would otherwise clamp into
    boundary voxels and vanish).
    """
    n = cloud.capacity
    coords = voxel_coords(cloud.points, voxel_size, mode)
    big = 1 << 30
    cmin = torch.where(cloud.mask[:, None], coords, big).amin(0)
    cmin = torch.clamp(cmin, max=big - 1)  # all-invalid cloud: any shift works
    keys = pack_keys(coords - cmin - _KEY_OFFSET, cloud.mask)
    order = torch.argsort(keys, stable=True)  # ties keep the original index order
    is_head = segment_heads(keys[order])
    out_mask = torch.arange(n, device=keys.device) < is_head.sum()
    out_idx = order[front_order(is_head)]
    return torch.where(out_mask, out_idx, 0), out_mask


def downsample_voxel(cloud: Cloud, voxel_size: float, mode: str = "floor") -> Cloud:
    """First-point-wins voxel downsample at fixed capacity: survivors
    compacted to the front, the mask marks real rows, the rest are zero."""
    idx, mask = voxel_select_indices(cloud, voxel_size, mode)
    return Cloud(points=torch.where(mask[:, None], cloud.points[idx], 0.0), mask=mask)
