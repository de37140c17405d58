"""Share of its roofline that the TSDF integrate reaches: its three
kernels (tile map, brick cull, update of the kept bricks) summed, against
the least time for the frames read once and tsdf and weight read and
written at each voxel the update predicate takes (roofline.integrate_work),
the voxels counted by the benchmark's own copy of the predicate from the
frames, poses and gates of every integrate of the traced stretch. One
reader for every cell group (``tsdf_integrate_roofline.<group>``)."""

import torch

from h100bench import readers, reference_tsdf, roofline, scene

KERNELS = ("depth_tiles_kernel", "cull_kernel", "visit_kernel")
# The frames (S, H, W) in meters, the poses camera-from-world and the gates.
RECORDS = {"fuse_blocks": ("realsensetracker_tpu_torch.kernels.tsdf", "fuse_blocks",
                           lambda a, k, out: (a[1], a[3], k.get("gates")))}


def read(run):
    log = run.logs.get("fuse_blocks", [])
    if not log:
        return None
    cam, g = scene.camera_of(run.config), reference_tsdf.grid_of(run.config["tsdf"])
    updated = pixels = 0
    for depths, poses_cfw, gates in log:
        for i in range(depths.shape[0]):
            pixels += depths[i].numel()
            if gates is None or bool(gates[i]):
                updated += reference_tsdf.updated_voxels(depths[i], torch.linalg.inv(poses_cfw[i].double()), cam, g)
    return readers.roofline_pct(run, KERNELS, roofline.integrate_work(pixels, updated))
