"""Carry configuration and tracker state across from the JAX package.

The system has no weights: what a user carries is configuration and
tracker state. These functions read the JAX objects' NamedTuple fields and
arrays through numpy, so this module imports neither JAX nor
realsensetracker_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from realsensetracker_tpu_torch.align.projective import ProjectiveIcpConfig
from realsensetracker_tpu_torch.geometry.camera import Intrinsics
from realsensetracker_tpu_torch.ops.pyramid import PyramidLevel
from realsensetracker_tpu_torch.tracking.frame_to_frame import FrameToFrameTracker
from realsensetracker_tpu_torch.tracking.trajectory import Trajectory


def intrinsics_from_jax(obj) -> Intrinsics:
    return Intrinsics(
        fx=float(obj.fx), fy=float(obj.fy), cx=float(obj.cx), cy=float(obj.cy),
        width=int(obj.width), height=int(obj.height),
    )


def icp_config_from_jax(cfg) -> ProjectiveIcpConfig:
    fields = {name: getattr(cfg, name) for name in ProjectiveIcpConfig._fields}
    fields["iters"] = tuple(int(i) for i in cfg.iters)
    return ProjectiveIcpConfig(**fields)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def pyramid_levels_from_numpy(levels, device="cpu") -> list[PyramidLevel]:
    """JAX PyramidLevels of one frame -> port PyramidLevels with B = 1."""
    return [PyramidLevel(*(_tensor(a, device)[None] for a in lvl)) for lvl in levels]


def frame_to_frame_state_from_jax(jax_tracker, device="cpu") -> FrameToFrameTracker:
    """A port FrameToFrameTracker that continues the JAX tracker's stream:
    same pose, reference pyramid, frame index, trajectory and fitted cfg."""
    tracker = FrameToFrameTracker(
        intrinsics_from_jax(jax_tracker.intr),
        icp_config_from_jax(jax_tracker.cfg),
        min_inlier_fraction=float(jax_tracker.min_inlier_fraction),
        map_capacity=int(jax_tracker.map_capacity),
        device=device,
    )
    if jax_tracker._prev_levels is not None:
        tracker._prev_levels = tuple(pyramid_levels_from_numpy(jax_tracker._prev_levels, device))
        tracker._pose = _tensor(jax_tracker._pose, device)
        tracker._pose_np = np.asarray(jax_tracker._pose_np, dtype=np.float32)
    tracker._index = int(jax_tracker._index)
    tracker.trajectory = Trajectory(
        list(jax_tracker.trajectory.timestamps),
        [np.array(p, dtype=np.float64) for p in jax_tracker.trajectory.poses],
    )
    return tracker
