"""Tiny patched sizes at which the cells run on the CPU in seconds."""

TINY_CAMERA = {"fx": 64.6625, "fy": 64.5625, "cx": 39.7, "cy": 31.85, "width": 80, "height": 60}
TINY_TSDF = {"resolution": 48, "voxel_size": 0.12, "origin_z_frac": -0.109375, "trunc": 0.36, "max_weight": 64.0,
             "min_depth": 0.05, "max_depth": 10.0, "max_range": 4.5, "step_frac": 0.5, "raycast_coarse": 4,
             "refine_steps": 8, "track_scale": 1, "integrate_every": 1, "subvoxel_iters": 1}

# Per cell: (config patch, cell patch) that a CPU run holds in seconds.
TINY = {
    "pairs.fr1.b512": ({"camera": TINY_CAMERA, "pairs": 8}, {"batch": 8, "chunk": 4, "trace_calls": 1}),
    "kinfu512.16cam.live": ({"camera": TINY_CAMERA, "cameras": 2, "tsdf": TINY_TSDF},
                            {"check_cameras": 2, "trace_calls": 1}),
    "kinfu512.16cam.w8": ({"camera": TINY_CAMERA, "cameras": 2, "tsdf": TINY_TSDF},
                          {"window": 2, "check_cameras": 2, "trace_calls": 1}),
}
