"""Pose-graph optimization (GN-CG with the backbone preconditioner)."""

from realsensetracker_tpu_torch.optimize.pose_graph import (  # noqa: F401
    PoseGraph,
    optimize_pose_graph,
)
