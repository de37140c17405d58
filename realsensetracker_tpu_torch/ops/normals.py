"""Surface normals of an organized vertex map by central differences.

Port of ``grid_normals`` from realsensetracker_tpu/ops/normals.py: the
plain composition the CUDA level kernel (kernels/level_kernel.py) is held
against. The kNN/PCA normals of the JAX module wait (ROADMAP queue 1
item 7).
"""

from __future__ import annotations

import torch


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
