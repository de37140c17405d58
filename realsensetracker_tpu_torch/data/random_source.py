"""Random data sources: hardware-free fake backends.

Port of realsensetracker_tpu/data/random_source.py: the reference's
RandomSource (data_source.hpp:22-41), uniform random point clouds with a
fixed timestep, and a random depth source for the image pipeline. Draws
come from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
card unless the caller passes ``device="cpu"``); JAX's threefry stream is
not reproduced, so the two packages' draws differ for one seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.ops.cloud import Cloud


@dataclass
class RandomCloudSource:
    """Uniform random clouds in [-1, 1]^3 (ref data_source.hpp:29-36:
    Eigen setRandom is uniform in [-1, 1])."""

    size: int = 128
    timestep: float = 100.0
    seed: int = 0
    device: str = device_mod.DEFAULT

    def __post_init__(self):
        self._device = device_mod.resolve(self.device)
        self._gen = torch.Generator(device=self._device).manual_seed(self.seed)

    def get_cloud(self, prev_stamp: float) -> tuple[Cloud, float]:
        u = torch.rand((self.size, 3), generator=self._gen, device=self._device)
        pts = 2.0 * u - 1.0
        return Cloud(points=pts, mask=torch.ones(self.size, dtype=torch.bool, device=self._device)), \
            prev_stamp + self.timestep


@dataclass
class RandomDepthSource:
    """Smooth random depth maps (low-frequency noise): uniform [1, 3) m on
    a 1/16 grid, bilinearly upsampled (half-pixel centers, as
    jax.image.resize)."""

    intr: camera.Intrinsics = camera.TUM_DEFAULT
    timestep: float = 1.0 / 30.0
    seed: int = 0
    device: str = device_mod.DEFAULT

    def __post_init__(self):
        self._device = device_mod.resolve(self.device)
        self._gen = torch.Generator(device=self._device).manual_seed(self.seed)

    def get_depth(self, prev_stamp: float) -> tuple[torch.Tensor, float]:
        h, w = self.intr.height, self.intr.width
        coarse = 1.0 + 2.0 * torch.rand((h // 16, w // 16), generator=self._gen, device=self._device)
        depth = F.interpolate(coarse[None, None], size=(h, w), mode="bilinear", align_corners=False)[0, 0]
        return depth, prev_stamp + self.timestep
