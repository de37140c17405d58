"""Pinhole camera model: intrinsics, project/unproject, pyramid scaling.

Port of realsensetracker_tpu/geometry/camera.py. Intrinsics stay plain
Python numbers; the functions broadcast over any leading batch dims and
run on the device of the tensor they are given.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    """Pinhole intrinsics as plain Python floats/ints."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def scaled(self, factor: float) -> "Intrinsics":
        """Intrinsics of an image downscaled by `factor` (e.g. 0.5 per level)."""
        return Intrinsics(
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=(self.cx + 0.5) * factor - 0.5,
            cy=(self.cy + 0.5) * factor - 0.5,
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
        )

    def halved(self) -> "Intrinsics":
        """Intrinsics of the next pyramid level.

        Dimensions FLOOR (width // 2), matching ops.pyramid.downsample_depth,
        which drops a trailing odd row/column before 2x2 pooling; scaled(0.5)
        rounds instead and would let in_bounds accept a row the level lacks.
        """
        return Intrinsics(
            fx=self.fx * 0.5,
            fy=self.fy * 0.5,
            cx=(self.cx + 0.5) * 0.5 - 0.5,
            cy=(self.cy + 0.5) * 0.5 - 0.5,
            width=self.width // 2,
            height=self.height // 2,
        )


# TUM RGB-D "freiburg1" defaults (fr1/desk), the dataset named by BASELINE.md.
TUM_FR1 = Intrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
# ROS/Kinect generic defaults, used by TUM tools when calibration is absent.
TUM_DEFAULT = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


def unproject_depth(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Depth image (..., H, W) -> vertex map (..., H, W, 3) in camera frame.

    Invalid depths (<= 0 or non-finite) yield zero vertices.
    """
    h, w = depth.shape[-2], depth.shape[-1]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    d = torch.where(torch.isfinite(depth) & (depth > 0), depth, 0.0)
    x = d * (u - intr.cx) / intr.fx
    y = d * (v - intr.cy) / intr.fy
    return torch.stack([x, y, d], dim=-1)


def valid_mask(
    depth: torch.Tensor, min_depth: float = 1e-6, max_depth: float = math.inf
) -> torch.Tensor:
    return torch.isfinite(depth) & (depth > min_depth) & (depth < max_depth)


def project(points: torch.Tensor, intr: Intrinsics):
    """Points (..., 3) -> (u, v, z) float pixel coordinates + depth."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    z_safe = torch.where(z.abs() > 1e-12, z, 1e-12)
    u = intr.fx * x / z_safe + intr.cx
    v = intr.fy * y / z_safe + intr.cy
    return u, v, z


def in_bounds(u: torch.Tensor, v: torch.Tensor, intr: Intrinsics, margin: float = 0.0) -> torch.Tensor:
    return (
        (u >= margin)
        & (u <= intr.width - 1 - margin)
        & (v >= margin)
        & (v <= intr.height - 1 - margin)
    )
