"""Named pipeline registry: string -> configured registration callable.

Port of realsensetracker_tpu/models/registry.py. Each pipeline is built by
``get_pipeline(name, **overrides)`` and called as run(src, dst) -> an
object with a .transform (4, 4): the depth pipelines ("projective-icp",
"keyframe") take two (H, W) depth images, the others two masked Clouds.
Inputs go to the factory's ``device``, the card unless the caller passes
``device="cpu"``; the depth pipelines run the CUDA kernels there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.align import gicp as gicp_mod
from realsensetracker_tpu_torch.align import icp as icp_mod
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.api.config import AlignConfig, GicpConfig
from realsensetracker_tpu_torch.geometry import camera
from realsensetracker_tpu_torch.models.pairwise import align_pair
from realsensetracker_tpu_torch.ops.cloud import Cloud
from realsensetracker_tpu_torch.ops.pyramid import build_pyramid

_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def list_pipelines() -> list[str]:
    return sorted(_REGISTRY)


def get_pipeline(name: str, **kwargs) -> Callable:
    """Build pipeline ``name`` with keyword overrides; returns fn(src, dst)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown pipeline {name!r}; have {list_pipelines()}")
    return _REGISTRY[name](**kwargs)


def _depth(d, dev) -> torch.Tensor:
    """One (H, W) depth image as a (1, H, W) f32 batch on dev."""
    return torch.as_tensor(d, device=dev).to(torch.float32)[None]


def _cloud(c: Cloud, dev) -> Cloud:
    return Cloud(torch.as_tensor(c.points, device=dev), torch.as_tensor(c.mask, device=dev))


def _single(res: projective.ProjectiveIcpResult) -> projective.ProjectiveIcpResult:
    """The one pair of a B = 1 result."""
    return projective.ProjectiveIcpResult(*(x[0] for x in res))


@register("projective-icp")
def _projective(intr: camera.Intrinsics = camera.TUM_DEFAULT,
                cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
                device=device_mod.DEFAULT):
    dev = device_mod.resolve(device)

    def run(src_depth, dst_depth):
        return _single(projective.register_depth_pair(_depth(src_depth, dev), _depth(dst_depth, dev), intr, cfg))

    return run


@register("gnc-icp")
def _gnc_icp(max_iter: int = 128, device=device_mod.DEFAULT):
    dev = device_mod.resolve(device)

    def run(src, dst):
        return icp_mod.align_icp(_cloud(src, dev), _cloud(dst, dev), max_iter)

    return run


@register("gicp")
def _gicp(cfg: GicpConfig = GicpConfig(), device=device_mod.DEFAULT):
    dev = device_mod.resolve(device)

    def run(src, dst):
        return gicp_mod.align_gicp(_cloud(src, dev), _cloud(dst, dev), **dataclasses.asdict(cfg))

    return run


@register("fpfh-kabsch-icp")
def _fpfh(cfg: AlignConfig = AlignConfig(), device=device_mod.DEFAULT):
    dev = device_mod.resolve(device)

    def run(src, dst):
        return align_pair(_cloud(src, dev), _cloud(dst, dev), cfg)

    return run


@register("robust-global")
def _robust(cfg: AlignConfig | None = None, device=device_mod.DEFAULT):
    dev = device_mod.resolve(device)
    cfg = cfg or AlignConfig(init_with_fpfh=False, refine_with_icp=False, use_robust=True)

    def run(src, dst):
        return align_pair(_cloud(src, dev), _cloud(dst, dev), cfg)

    return run


@register("keyframe")
def _keyframe(intr: camera.Intrinsics = camera.TUM_DEFAULT,
              cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
              device=device_mod.DEFAULT):
    """The keyframe tracker's registration as a pair: the src depth image
    onto dst by the same coarse-to-fine projective pipeline (a full dst
    pyramid, a src pyramid without normals)."""
    dev = device_mod.resolve(device)

    def run(src_depth, dst_depth):
        fit = projective.fit_levels(cfg, int(intr.height), int(intr.width))
        dst_levels, intrs = build_pyramid(_depth(dst_depth, dev), intr, len(fit.iters))
        src_levels, _ = build_pyramid(_depth(src_depth, dev), intr, len(fit.iters), with_normals=False)
        return _single(projective.projective_icp(tuple(src_levels), tuple(dst_levels), tuple(intrs), cfg=fit))

    return run
