"""Depth/vertex pyramids for coarse-to-fine projective ICP.

Port of realsensetracker_tpu/ops/pyramid.py, batched over a leading B:
every level's tensors carry the batch first. The destination role builds
the planar (B, 4, H, W) plane table [n | d = n . q] that projective ICP
gathers from, with the CUDA level kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.kernels import level_kernel


class PyramidLevel(NamedTuple):
    vertex_map: torch.Tensor  # (B, H, W, 3)
    normal_map: torch.Tensor  # (B, H, W, 3); zero where invalid
    valid: torch.Tensor  # (B, H, W) bool: vertex AND normal valid
    vertex_valid: torch.Tensor  # (B, H, W) bool: vertex valid
    packed: torch.Tensor  # (B, 4, H, W) planar plane table [nx, ny, nz, d]


def downsample_depth(depth: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """2x2 validity-aware mean pooling of (..., H, W); a trailing odd
    row/column is dropped (floor), as Intrinsics.halved() assumes."""
    h, w = depth.shape[-2] // 2 * 2, depth.shape[-1] // 2 * 2
    lead = depth.shape[:-2]
    d = depth[..., :h, :w].reshape(*lead, h // 2, 2, w // 2, 2)
    m = valid[..., :h, :w].reshape(*lead, h // 2, 2, w // 2, 2)
    cnt = m.sum(dim=(-3, -1))
    s = torch.where(m, d, 0.0).sum(dim=(-3, -1))
    out_valid = cnt > 0
    out = torch.where(out_valid, s / torch.clamp(cnt, min=1), 0.0)
    return out, out_valid


def level_intrinsics(intr: camera.Intrinsics, num_levels: int) -> tuple[camera.Intrinsics, ...]:
    """Per-level intrinsics, fine to coarse: the single source of truth."""
    out = []
    cur = intr
    for _ in range(num_levels):
        out.append(cur)
        cur = cur.halved()
    return tuple(out)


def depth_to_meters(depth: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Raw integer depth (any leading dims) -> f32 meters on its device;
    float frames are already meters."""
    if not depth.is_floating_point():
        return depth.to(torch.float32) * scale
    return depth.to(torch.float32)


def _use_kernel(use_kernel: str | bool, depth: torch.Tensor) -> bool:
    if use_kernel == "auto":
        return depth.is_cuda
    if use_kernel is True and not depth.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor: the level kernel is CUDA-only")
    return bool(use_kernel)


def build_pyramid(
    depth: torch.Tensor,
    intr: camera.Intrinsics,
    num_levels: int = 3,
    min_depth: float = 0.05,
    max_depth: float = 10.0,
    with_normals: bool = True,
    use_kernel: str | bool = "auto",
) -> tuple[list[PyramidLevel], list[camera.Intrinsics]]:
    """Depth batch (B, H, W) -> list of levels, fine to coarse.

    with_normals=False builds a SOURCE-role pyramid (no normals, zero
    plane table). use_kernel: 'auto' runs the CUDA level kernel for CUDA
    tensors and the plain torch version for CPU tensors; True forces the
    kernel (a CPU tensor raises), False the plain version.
    """
    if depth.dim() != 3:
        raise ValueError(f"depth must be (B, H, W), got shape {tuple(depth.shape)}")
    kernel = _use_kernel(use_kernel, depth)
    build_level = (
        level_kernel.build_level_packed if kernel else level_kernel.build_level_packed_reference
    )
    depth = depth.to(torch.float32)
    valid = camera.valid_mask(depth, min_depth, max_depth)
    d = torch.where(valid, depth, 0.0)  # the kernel takes MASKED depth
    levels: list[PyramidLevel] = []
    intrs = list(level_intrinsics(intr, num_levels))
    for cur_intr in intrs:
        vmap = camera.unproject_depth(d, cur_intr)
        if with_normals:
            packed = build_level(d, cur_intr)
            nmap = packed[:, 0:3].permute(0, 2, 3, 1)
            lvl_valid = (packed[:, 0:3] ** 2).sum(1) > 0.5
        else:
            nmap = torch.zeros_like(vmap)
            lvl_valid = valid
            packed = torch.zeros((d.shape[0], 4) + d.shape[1:], dtype=d.dtype, device=d.device)
        levels.append(
            PyramidLevel(
                vertex_map=vmap,
                normal_map=nmap,
                valid=lvl_valid,
                vertex_valid=valid,
                packed=packed,
            )
        )
        d, valid = downsample_depth(d, valid)
    return levels, intrs
