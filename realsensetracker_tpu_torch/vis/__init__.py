"""Offline (PNG/PLY) and live (HTTP) visualization: copies of
realsensetracker_tpu/vis, numpy and the standard library only."""

from realsensetracker_tpu_torch.vis.render import (  # noqa: F401
    render_cloud_png,
    render_depth_png,
    render_matches_png,
    fpfh_pca_colors,
    export_ply,
    load_xyzrgb,
    save_xyzrgb,
)
