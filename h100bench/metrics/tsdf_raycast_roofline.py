"""Share of its roofline that the raycast march reaches: the coarse and
the refine march of every render of the traced stretch summed, against the
least time for the field words their samples can touch and the depth
written (roofline.march_work, the samples counted from each march's rays
by roofline.march_gathers). One reader for every cell group
(``tsdf_raycast_roofline.<group>``)."""

from h100bench import readers, reference_tsdf, roofline

KERNELS = ("raycast_kernel",)
# Each march's depth out, its start depth, its gate, its steps and refinements.
RECORDS = {"march": ("realsensetracker_tpu_torch.kernels.tsdf", "march",
                     lambda a, k, out: (out, k.get("z_start"), k.get("gate"), a[4], int(k.get("subvoxel_iters", 0))))}


def read(run):
    g = reference_tsdf.grid_of(run.config["tsdf"])
    work = readers.summed(
        roofline.march_work(roofline.march_gathers(out, g.min_depth if z0 is None else z0, gate, n, g.step, refine),
                            out.numel(), g.v ** 3)
        for out, z0, gate, n, refine in run.logs.get("march", []))
    return readers.roofline_pct(run, KERNELS, work)
