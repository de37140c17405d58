"""Multi-process utilities: dataset sharding across ranks.

Port of realsensetracker_tpu/parallel/multihost.py. Every rank loads only
its own shard of streams or pairs; ``global_frame_batch`` wraps that local
shard as a DTensor whose global shape spans the mesh, the counterpart of
jax.make_array_from_process_local_data. With one rank the global batch is
the local one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from realsensetracker_tpu_torch.parallel import mesh as mesh_mod


def _rank_and_world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_frame_batch(local_frames, mesh: DeviceMesh, data_axis: str = "data"):
    """The global (B_global, H, W) batch whose local shard is this rank's
    frames (B_local, H, W): a DTensor sharded over ``data_axis`` on dim 0 and
    replicated over the other dims (ranks that share a data coordinate pass
    the same frames). Every rank must pass an equal B_local."""
    from torch.distributed.tensor import DTensor

    local = torch.as_tensor(local_frames).to(mesh_mod.mesh_device(mesh)).contiguous()
    return DTensor.from_local(local, mesh, mesh_mod.placements(mesh, data_axis), run_check=False)


def process_stream_slice(num_streams: int) -> slice:
    """Which stream indices this rank owns (contiguous block split).

    num_streams must divide evenly across ranks: global_frame_batch needs
    every rank to contribute an equal local batch."""
    rank, n = _rank_and_world()
    if num_streams % n != 0:
        raise ValueError(
            f"num_streams={num_streams} must be a multiple of "
            f"process_count={n} (equal per-process shards required by "
            "global_frame_batch); pad the stream list to a multiple"
        )
    per = num_streams // n
    return slice(rank * per, (rank + 1) * per)


_barrier_calls = 0


def all_processes_ready() -> None:
    """Cross-rank barrier: an all-reduce of this call's number over every
    rank, which cannot complete until every rank has entered it. The sum
    is read back and checked against world size x call number, so a rank
    that skipped or repeated a barrier is caught, not waited past. The
    count lives on the current card of an NCCL group, else on the CPU.
    Without a process group there is one rank and nothing to wait for."""
    global _barrier_calls
    _barrier_calls += 1
    if not dist.is_initialized():
        return
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    n = dist.get_world_size()
    total = torch.tensor([float(_barrier_calls)], dtype=torch.float64, device=device)
    dist.all_reduce(total)
    got = float(total.item())
    if got != n * _barrier_calls:
        raise RuntimeError(f"barrier mismatch: {got} != {n} ranks x call {_barrier_calls}")
