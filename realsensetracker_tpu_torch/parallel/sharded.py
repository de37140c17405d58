"""Point-sharded registration: the 6x6 normal equations all-reduced over ranks.

Port of realsensetracker_tpu/parallel/sharded.py, the "tensor parallel"
axis of this workload: the sample points of one registration split over
the mesh's ``point`` ranks, each rank builds a partial (H, b) from its
block, and an all-reduce over the point group sums them before the small
replicated solve. Pairs split over the ``data`` ranks.

Preprocessing is the unsharded fast path's, on the port's kernels:
destination plane-table pyramids by ops.pyramid.build_pyramid (level and
downsample kernels) and source points sampled straight from the depth
levels (projective.sample_depth_points). The GN loop keeps JAX's
outer/inner split: each association round fixes its planes at the round's
pose T, and each inner step is one ``gn_system`` launch that associates at
T and reduces at the inner pose (kernels/gn_step.gn_system with T_assoc),
then one all-reduce of the packed (H, b, wsse, wsum, count), then
projective.solve_update. On the CPU gn_system runs its plain version.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.kernels import downsample, gn_step
from realsensetracker_tpu_torch.ops.pyramid import build_pyramid
from realsensetracker_tpu_torch.parallel import mesh as mesh_mod

# Columns of the all-reduced row per pair: H (36), b (6), wsse, wsum, count.
_SYSTEM = 45


def _level_sample_counts(cfg: projective.ProjectiveIcpConfig, intr, num_levels):
    """Static per-level source sample counts (fine -> coarse), pre-padding."""
    counts = []
    h, w = intr.height, intr.width
    for li in range(num_levels):
        want = max(cfg.samples // (cfg.coarse_sample_divisor**li), cfg.min_samples)
        counts.append(min(want, h * w))
        h, w = h // 2, w // 2
    return counts


def _pad_to_multiple(pts, ok, multiple):
    """Pad the sample axis (B, P, .) to a multiple of the point-axis size;
    padding carries ok=False so it adds nothing to the reduction."""
    rem = (-pts.shape[1]) % multiple
    if rem == 0:
        return pts, ok
    b = pts.shape[0]
    pts = torch.cat([pts, pts.new_zeros((b, rem, 3))], dim=1)
    ok = torch.cat([ok, ok.new_zeros((b, rem))], dim=1)
    return pts, ok


def _reduced_system(T, T_assoc, pts_t, ok, packed, intr, cfg, group):
    """One inner step's system, summed over the point group: a gn_system
    launch (association at T_assoc, reduction at T) and one all-reduce."""
    H, b, (wsse, wsum, count) = gn_step.gn_system(T, pts_t, ok, packed, intr, cfg, T_assoc=T_assoc)
    n = T.shape[0]
    row = torch.cat([H.reshape(n, 36), b, wsse[:, None], wsum[:, None], count[:, None].to(torch.float32)], dim=1)
    dist.all_reduce(row, group=group)
    aux = (row[:, 42], row[:, 43], row[:, 44].round().to(torch.int32))
    return row[:, :36].reshape(n, 6, 6), row[:, 36:42], aux


def register_batch_point_sharded(
    mesh: DeviceMesh,
    src_depths,  # (B, H, W): the whole batch on every rank, or global_frame_batch's DTensor
    dst_depths,
    intr: camera.Intrinsics,
    cfg: projective.ProjectiveIcpConfig = projective.ProjectiveIcpConfig(),
    data_axis: str = "data",
    point_axis: str = "point",
):
    """Register a batch with pairs sharded over ``data_axis`` and each pair's
    GN reduction sharded over ``point_axis`` (an all-reduce of H, b per
    inner step). Every rank of the mesh calls it alike.

    Returns (transforms (B, 4, 4), rmse (B,)) on every rank: each data rank
    registers its block of B / n_data pairs, and the results are
    all-gathered over the data group. The sample axis of each level pads
    with ok=False to a multiple of the point size; the rank at point
    coordinate j takes block j of it.
    """
    src = mesh_mod.local_shard(src_depths, mesh, data_axis).to(torch.float32)
    dst = mesh_mod.local_shard(dst_depths, mesh, data_axis).to(torch.float32).contiguous()
    pp = mesh_mod.axis_size(mesh, point_axis)
    j = mesh_mod.axis_index(mesh, point_axis)
    group = mesh.get_group(point_axis)
    cfg = projective.fit_levels(cfg, int(intr.height), int(intr.width))
    num_levels = len(cfg.iters)
    counts = _level_sample_counts(cfg, intr, num_levels)

    dst_levels, intrs = build_pyramid(dst, intr, num_levels, cfg.min_depth, cfg.max_depth)
    valid = camera.valid_mask(src, cfg.min_depth, cfg.max_depth)
    d = torch.where(valid, src, 0.0).contiguous()
    depths = [d] + [dl for dl, _ in downsample.downsample_levels(d, num_levels, cfg.min_depth)]
    blocks = []
    for li, dl in enumerate(depths):
        pts, ok = projective.sample_depth_points(dl, intrs[li], counts[li], cfg.min_depth, cfg.max_depth)
        pts, ok = _pad_to_multiple(pts, ok, pp)
        per = pts.shape[1] // pp
        mine = slice(j * per, (j + 1) * per)
        blocks.append((pts[:, mine].transpose(1, 2).contiguous(), ok[:, mine].contiguous()))

    b = src.shape[0]
    T = se3.identity(device=src.device).expand(b, 4, 4).contiguous()
    rmse = torch.zeros(b, dtype=torch.float32, device=src.device)
    for li in range(num_levels - 1, -1, -1):  # coarse -> fine
        pts_t, ok = blocks[li]
        packed = dst_levels[li].packed
        for _ in range(cfg.iters[num_levels - 1 - li]):
            T_assoc = T  # the round's planes stay fixed at its first pose
            for _ in range(max(cfg.inner_iters, 1)):
                H, bvec, aux = _reduced_system(T, T_assoc, pts_t, ok, packed, intrs[li], cfg, group)
                T, (rmse, _, _) = projective.solve_update(T, H, bvec, aux, cfg.samples, cfg)
    out = mesh_mod.all_gather(torch.cat([T.reshape(b, 16), rmse[:, None]], dim=1), mesh, data_axis)
    return out[:, :16].reshape(-1, 4, 4), out[:, 16]
