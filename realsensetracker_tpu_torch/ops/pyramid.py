"""Depth/vertex pyramids for coarse-to-fine projective ICP.

Port of realsensetracker_tpu/ops/pyramid.py, batched over a leading B:
every level's tensors carry the batch first. The destination role builds
the planar (B, 4, H, W) plane table [n | d = n . q] that projective ICP
gathers from. For CUDA tensors one launch of the downsample kernel makes
every coarse level's depth and the level kernel builds each table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.kernels import downsample, level_kernel
from realsensetracker_tpu_torch.utils.tracing import span


class PyramidLevel(NamedTuple):
    vertex_map: torch.Tensor  # (B, H, W, 3)
    normal_map: torch.Tensor  # (B, H, W, 3); zero where invalid
    valid: torch.Tensor  # (B, H, W) bool: vertex AND normal valid
    vertex_valid: torch.Tensor  # (B, H, W) bool: vertex valid
    packed: torch.Tensor  # (B, 4, H, W) planar plane table [nx, ny, nz, d]


def downsample_depth(depth: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """2x2 validity-aware mean pooling of (..., H, W); a trailing odd
    row/column is dropped (floor), as Intrinsics.halved() assumes.

    The four children are summed in a fixed order, row pairs first:
    (a00 + a01) + (a10 + a11), the order torch's sum over the two dims
    takes on the CPU, written out so that the CUDA kernel can repeat it bit
    for bit. XLA's CPU reduce takes this order at power-of-two widths and
    ((a00 + a01) + a10) + a11 elsewhere, up to an ulp away."""
    h, w = depth.shape[-2] // 2 * 2, depth.shape[-1] // 2 * 2
    lead = depth.shape[:-2]
    d = depth[..., :h, :w].reshape(*lead, h // 2, 2, w // 2, 2)
    m = valid[..., :h, :w].reshape(*lead, h // 2, 2, w // 2, 2)
    cnt = m.sum(dim=(-3, -1))
    a = torch.where(m, d, 0.0)
    s = (a[..., 0, :, 0] + a[..., 0, :, 1]) + (a[..., 1, :, 0] + a[..., 1, :, 1])
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
    plane table). use_kernel: 'auto' runs the CUDA kernels (the coarse
    levels' downsample, one launch, and the level builder) for CUDA
    tensors and their plain torch versions for CPU tensors; True forces the
    kernels (a CPU tensor raises), False the plain versions. min_depth must
    be >= 0 (the downsample reads validity as depth > 0).
    """
    with span("rst.pyramid.build"):
        if depth.dim() != 3:
            raise ValueError(f"depth must be (B, H, W), got shape {tuple(depth.shape)}")
        kernel = _use_kernel(use_kernel, depth)
        build_level = (
            level_kernel.build_level_packed if kernel else level_kernel.build_level_packed_reference
        )
        if min_depth < 0:
            raise ValueError(f"min_depth {min_depth} < 0: the pyramid reads validity as depth > 0")
        depth = depth.to(torch.float32)
        valid = camera.valid_mask(depth, min_depth, max_depth)
        d = torch.where(valid, depth, 0.0)  # the kernels take MASKED depth
        if kernel:
            coarse = downsample.downsample_levels(d, num_levels, min_depth)
        else:
            coarse = downsample.downsample_levels_reference(d, num_levels)
        levels: list[PyramidLevel] = []
        intrs = list(level_intrinsics(intr, num_levels))
        for li, cur_intr in enumerate(intrs):
            if li:
                d, valid = coarse[li - 1]
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
        return levels, intrs
