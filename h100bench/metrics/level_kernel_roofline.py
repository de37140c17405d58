"""Share of its roofline that the level kernel (build_level_packed: one
pyramid level's plane table) reaches: the least time for its bytes (4 B of
depth in, 16 B of [n | d] out per pixel, roofline.level_work) summed over
every call of the traced stretch, over its traced device time. One reader
for every cell group (``level_kernel_roofline.<group>``)."""

from h100bench import readers, roofline

KERNELS = ("level_packed_kernel",)
RECORDS = {"build_level_packed": ("realsensetracker_tpu_torch.kernels.level_kernel", "build_level_packed",
                                  lambda a, k, out: tuple(a[0].shape))}


def read(run):
    work = readers.summed(roofline.level_work(b, [(h, w)]) for b, h, w in run.logs.get("build_level_packed", []))
    return readers.roofline_pct(run, KERNELS, work)
