"""The least time the card could take for a kernel's work.

Peaks: NVIDIA H100 SXM data sheet, at its full 700 W power limit: 3.35 TB/s
of HBM3, 67 TFLOP/s in float32 outside the tensor cores. Bytes count each
input byte read once and each output byte written once; operations count
what these inputs need, as the algorithm defines the work, whatever the
kernel that does it. The per-kernel counts are those the port's kernel
table states (PERF.md, Findings), computed here from the cell's shapes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """Seconds: the larger of bytes over bandwidth and operations over peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def level_work(batch: int, shapes) -> tuple[int, int]:
    """Plane tables of the destination pyramid: per pixel of each level 4 B
    of depth in and 16 B of [n | d] out, ~60 operations."""
    px = batch * sum(h * w for h, w in shapes)
    return px * 20, px * 60


def downsample_work(batch: int, height: int, width: int, shapes) -> tuple[int, int]:
    """Every coarse level from one masked depth: the depth read once, 4 B of
    depth and 1 B of validity out per coarse pixel, ~8 operations each."""
    coarse = batch * sum(h * w for h, w in shapes)
    return batch * height * width * 4 + coarse * 5, coarse * 8


def gn_round_work(batch: int, points: int, valid: int, inner: int) -> tuple[int, int]:
    """One association round of B pairs of P source points, ``valid`` of
    them with depth: the poses in and out (64 B each) and 12 B of stats per
    pair, 13 B per point (xyz and flag) and a 16 B plane row per valid
    point; ~40 operations to associate a valid point, ~105 per point and
    inner step, ~400 per pair and inner step for the 6x6 solve and the
    update. The association count is taken as the valid count: the bytes
    bound these shapes either way."""
    nbytes = batch * (64 + 64 + 12) + batch * points * 13 + valid * 16
    return nbytes, valid * 40 + inner * (valid * 105 + batch * 400)


def integrate_work(frame_pixels: int, updated_voxels: int) -> tuple[int, int]:
    """The frame read once (4 B a pixel); tsdf and weight read and written at
    each voxel the update predicate takes (16 B); ~10 operations each."""
    return frame_pixels * 4 + updated_voxels * 16, updated_voxels * 10


def march_work(gathers: int, rays: int, voxels: int) -> tuple[int, int]:
    """A ray march: the distinct field words its samples can touch (at most
    the grid) and the depth written; ~30 operations per sample."""
    return min(gathers, voxels) * 4 + rays * 4, gathers * 30


def march_gathers(out, z_start, gate, n_steps: int, step: float, refine: int) -> int:
    """Samples one march takes for these rays: the start sample and one per
    step up to the hit (all ``n_steps`` for a miss), 16 per refinement of a
    hit, none for a ray its gate closes. ``out`` is the march's depth (0 on
    a miss); ``z_start`` a tensor or a number; ``gate`` None or a mask."""
    import torch

    hit = out > 0
    steps = torch.where(hit, torch.ceil((out - z_start) / step).clamp(1, n_steps), float(n_steps))
    per_ray = steps + 1 + hit.to(steps.dtype) * 16 * refine
    if gate is not None:
        per_ray = torch.where(gate, per_ray, 0.0)
    return int(per_ray.sum().item())
