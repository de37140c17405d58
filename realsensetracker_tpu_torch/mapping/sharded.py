"""Multi-device dense mapping: the TSDF volume in x-slabs over a mesh axis.

Port of realsensetracker_tpu/mapping/sharded.py. A dense volume is the
one tracker state that outgrows a single device -- 512^3 float32
tsdf+weight is 1 GB, and integration touches every voxel every frame.
Both scale by sharding the grid:

* Layout: x-slabs. Each plane of the volume is a DTensor of global shape
  (V, V, V) (color (V, V, V, 3)) sharded on dim 0 over the mesh dim
  ``axis`` and replicated over the others; the rank at coordinate r holds
  planes r V/n .. (r+1) V/n - 1 as its local (V/n, V, V) tensor.
* ``integrate`` needs no communication: every voxel's update is
  independent, and the (H, W) frame is replicated. Each rank launches the
  integrate kernel on its slab with the slab's global offset x0
  (kernels/tsdf.fuse_block), which takes voxel centres from the global
  index, so the slabs round exactly as the whole volume does.
* ``raycast`` samples the volume at arbitrary ray positions: the march
  field (one f32 per voxel) is all-gathered along x once per render, and
  the march runs replicated on every rank. That is XLA's own plan for the
  JAX function, made explicit.

mapping/tsdf.py routes a sharded volume here by itself: ``integrate``
to this module's integrate, and every render through ``march_field``,
which gathers; the surface and mesh extractions gather the planes first.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod
from realsensetracker_tpu_torch.parallel import mesh as mesh_mod


def volume_sharding(mesh: DeviceMesh, axis: str = "data") -> list:
    """The DTensor placements of a volume plane: x-slabs (dim 0) over the
    mesh dim ``axis``, replicated over the other dims (JAX's
    NamedSharding(mesh, P(axis, None, None)))."""
    return mesh_mod.placements(mesh, axis)


def is_sharded(vol) -> bool:
    """Whether ``vol``'s planes are x-slab DTensors."""
    from torch.distributed.tensor import DTensor

    return isinstance(vol.tsdf, DTensor)


def _axis(vol) -> str:
    from torch.distributed.tensor import Shard

    mesh = vol.tsdf.device_mesh
    return next(name for name, p in zip(mesh.mesh_dim_names, vol.tsdf.placements) if isinstance(p, Shard))


def local_slab(vol) -> tuple[tsdf_mod.TsdfVolume, int]:
    """(this rank's slab as a TsdfVolume of (V/n, V, V) tensors that share
    the sharded volume's storage, its first global plane x0)."""
    mesh, axis = vol.tsdf.device_mesh, _axis(vol)
    local = tsdf_mod.TsdfVolume(*(None if a is None else a.to_local() for a in vol))
    return local, mesh_mod.axis_index(mesh, axis) * local.tsdf.shape[0]


def _wrap(local: tsdf_mod.TsdfVolume, mesh: DeviceMesh, axis: str) -> tsdf_mod.TsdfVolume:
    from torch.distributed.tensor import DTensor

    place = volume_sharding(mesh, axis)
    return tsdf_mod.TsdfVolume(
        *(None if a is None else DTensor.from_local(a, mesh, place, run_check=False) for a in local)
    )


def _check_divisible(resolution: int, mesh: DeviceMesh, axis: str) -> None:
    n = mesh_mod.axis_size(mesh, axis)
    if resolution % n != 0:
        raise ValueError(f"volume resolution {resolution} not divisible by mesh axis {axis!r} of size {n}")


def shard_volume(vol: tsdf_mod.TsdfVolume, mesh: DeviceMesh, axis: str = "data") -> tsdf_mod.TsdfVolume:
    """Lay a whole volume (every rank holds the same) out as x-slabs across
    ``mesh``'s ``axis``: each rank keeps a copy of its planes on its device.

    Requires the resolution to be divisible by the axis size. Color
    planes (4-D) shard on the same grid axis."""
    _check_divisible(vol.resolution, mesh, axis)
    sl = mesh_mod.block(vol.resolution, mesh, axis, "resolution")
    dev = mesh_mod.mesh_device(mesh)
    return _wrap(tsdf_mod.TsdfVolume(*(None if a is None else a[sl].to(dev, copy=True) for a in vol)), mesh, axis)


def init_volume_sharded(
    cfg: tsdf_mod.TsdfConfig,
    mesh: DeviceMesh,
    axis: str = "data",
    with_color: bool = False,
) -> tsdf_mod.TsdfVolume:
    """init_volume laid out directly in x-slabs: each rank allocates only
    its (V/n, V, V) planes (no whole-volume staging)."""
    _check_divisible(cfg.resolution, mesh, axis)
    v, dev = cfg.resolution, mesh_mod.mesh_device(mesh)
    nx = v // mesh_mod.axis_size(mesh, axis)
    z = lambda *s: torch.zeros((nx, v, v) + s, dtype=torch.float32, device=dev)  # noqa: E731
    local = tsdf_mod.TsdfVolume(
        tsdf=torch.ones((nx, v, v), dtype=torch.float32, device=dev),
        weight=z(),
        color=z(3) if with_color else None,
        color_weight=z() if with_color else None,
    )
    return _wrap(local, mesh, axis)


def integrate(vol, depth, pose_world_from_cam, intr, cfg, color=None, gate=None):
    """Sharded integrate: tsdf.integrate's update on each rank's slab, in
    place, with no communication; returns ``vol``.

    TsdfConfig.integrate_slab is forced off here: the frustum window spans
    slab boundaries, and each rank already visits only its own slab, the
    same (V/n)-fold cut the window buys on one device."""
    if getattr(cfg, "integrate_slab", 0):
        cfg = cfg._replace(integrate_slab=0)
    local, x0 = local_slab(vol)
    tsdf_mod._integrate_planes(local, depth, pose_world_from_cam, intr, cfg, color, gate, x0)
    return vol


def gather_march_field(vol) -> torch.Tensor:
    """The flat (V^3,) march field of a sharded volume on every rank: each
    rank's slab field, then one all-gather along x on the axis's group."""
    local, _ = local_slab(vol)
    return mesh_mod.all_gather(tsdf_mod.march_field(local), vol.tsdf.device_mesh, _axis(vol))


def gather_volume(vol) -> tsdf_mod.TsdfVolume:
    """The whole volume on every rank (one all-gather per plane)."""
    local, _ = local_slab(vol)
    mesh, axis = vol.tsdf.device_mesh, _axis(vol)
    return tsdf_mod.TsdfVolume(*(None if a is None else mesh_mod.all_gather(a, mesh, axis) for a in local))


def raycast(vol, pose_world_from_cam, intr, cfg):
    """Render from a sharded volume: the march field gathers once along x,
    then the raycast kernel marches replicated (tsdf.raycast, which routes
    a sharded volume's field through gather_march_field)."""
    return tsdf_mod.raycast(vol, pose_world_from_cam, intr, cfg)
