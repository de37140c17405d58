"""Geometry: SE(3) Lie-group maps and the pinhole camera."""

from realsensetracker_tpu_torch.geometry import camera, se3  # noqa: F401
