"""Device microseconds per registered pair spent in kernels that are not
the port's hand-written ones: the plain torch ops of ops.pyramid and
align.projective (masks, where, vertex maps, transposes) and torch's own
solvers. Copies and sets are left out. One reader for
``plain_ops_us_per_pair`` and ``plain_ops_us_per_pair.<group>``."""

from h100bench import readers

HANDWRITTEN = ("level_packed_kernel", "downsample_kernel", "gn_round_kernel", "gn_system_kernel",
               "depth_tiles_kernel", "cull_kernel", "visit_kernel", "raycast_kernel",
               "backbone_factor_kernel", "backbone_apply_kernel")


def read(run):
    return readers.other_kernels_us_per_unit(run, HANDWRITTEN)
