"""Device meshes over torch.distributed ranks.

Port of realsensetracker_tpu/parallel/mesh.py. JAX drives every chip from
one process through a ``jax.sharding.Mesh``; PyTorch runs one process per
device, and a ``torch.distributed.device_mesh.DeviceMesh`` of the ranks
with the same two named dims stands in for the Mesh:

* ``data``: independent frame pairs, stream slots, volume slabs and atlas
  pairs (registrations are embarrassingly parallel);
* ``point``: sample points of a single registration, whose 6x6 normal
  equations are summed by an all-reduce over the dim's group
  (parallel/sharded.py) where JAX psums.

Where XLA inserts a collective for a sharding annotation, the port's
sharded functions call it explicitly on the dim's process group
(``mesh.get_group(name)``): NCCL on the card, gloo on the CPU. A rank's
device is ``cuda:<local rank>``; NCCL cannot put two ranks on one card, so
a world larger than the card count raises, and nothing falls back to gloo
or to the CPU on its own.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from realsensetracker_tpu_torch import device as device_mod


def _start_single_rank_group(dev: torch.device) -> None:
    """A world-size-1 process group in this process (an in-memory store):
    NCCL for a card, gloo for the CPU."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def local_rank() -> int:
    """This process's index among the ranks of its host (LOCAL_RANK, as
    torchrun sets it; else the global rank: one host)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def rank_device(device=device_mod.DEFAULT) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` for a card, else the CPU.
    Raises on a card when the world has more ranks than the host has cards
    (NCCL refuses two ranks on one card)."""
    dev = device_mod.resolve(device)
    if dev.type != "cuda":
        return dev
    world, cards = dist.get_world_size(), torch.cuda.device_count()
    if world > cards:
        raise ValueError(
            f"{world} ranks need {world} cards, this host has {cards} (NCCL cannot share a card between ranks; "
            "pass device='cpu' for gloo ranks on the CPU)"
        )
    return torch.device("cuda", local_rank())


def make_mesh(
    n_devices: int | None = None,
    data_axis: str = "data",
    point_axis: str = "point",
    point_parallelism: int = 1,
    device=device_mod.DEFAULT,
) -> DeviceMesh:
    """A (data, point) mesh of shape (n / point_parallelism,
    point_parallelism) over ranks 0 .. n-1 (n: the world size when None).

    With no process group yet and n_devices None or 1, this process starts
    a world-size-1 group (NCCL on "cuda", gloo on "cpu"), so a one-card
    caller needs no launcher. Otherwise the group must exist: every rank
    calls make_mesh with the same arguments (it builds the dims' groups
    collectively). Each rank's current CUDA device becomes cuda:<local rank>.
    """
    dev = device_mod.resolve(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh({n_devices}) needs {n_devices} ranks: start them first "
                "(torch.distributed.init_process_group in each; parallel.dryrun shows how)"
            )
        _start_single_rank_group(dev)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    if n_devices % point_parallelism != 0:
        raise ValueError("point_parallelism must divide n_devices")
    if n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices in a world of {world} ranks: the port's mesh spans every rank "
            "(start as many ranks as the mesh has devices)"
        )
    rdev = rank_device(dev)
    if rdev.type == "cuda":
        torch.cuda.set_device(rdev)
    grid = torch.arange(n_devices).reshape(n_devices // point_parallelism, point_parallelism)
    return DeviceMesh(rdev.type, grid, mesh_dim_names=(data_axis, point_axis))


def balanced_mesh(n_devices: int | None = None, device=device_mod.DEFAULT) -> DeviceMesh:
    """Mesh with point axis = 2 when the device count allows, else pure data."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    pp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return make_mesh(n_devices, point_parallelism=pp, device=device)


# -- helpers the sharded modules share ---------------------------------------


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of the mesh dim ``axis`` (JAX's mesh.shape[axis])."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along the mesh dim ``axis``."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def placements(mesh: DeviceMesh, axis: str, dim: int = 0) -> list:
    """DTensor placements sharding tensor dim ``dim`` over the mesh dim
    ``axis`` and replicating over the others (JAX's P(axis) spec)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(dim) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The blocks ``x`` of every rank along ``axis``, concatenated on dim 0
    in coordinate order: one all-gather on the dim's group."""
    n = axis_size(mesh, axis)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.get_group(axis))
    return out


def block(n: int, mesh: DeviceMesh, axis: str, what: str = "batch") -> slice:
    """This rank's contiguous block of ``n`` items split over ``axis``;
    ``n`` must divide evenly."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{what} of {n} does not split evenly over mesh axis {axis!r} of size {size}")
    per = n // size
    i = axis_index(mesh, axis)
    return slice(i * per, (i + 1) * per)


def local_shard(x, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """This rank's block of dim 0 of ``x`` over ``axis``, on its device:
    the local tensor of a DTensor laid out by global_frame_batch, or the
    block of a whole batch that every rank passes alike."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        if x.device_mesh != mesh or list(x.placements) != placements(mesh, axis):
            raise ValueError(f"a DTensor laid out as {x.placements} on another mesh or axis than {axis!r}")
        x = x.to_local()
    else:
        x = torch.as_tensor(x)
        x = x[block(x.shape[0], mesh, axis)]
    return x.to(mesh_device(mesh))
