"""Offline visualization writers.

The reference renders through a live SubprocessViewer (rs_viewer.cpp,
rs_align_app.cpp DrawAxis/DrawCloud/DrawMatches :135-241) -- an interactive
window this headless framework replaces with PNG/PLY writers covering the
same debugging views: colored clouds, correspondence lines, FPFH-PCA false
coloring (ComputePCAProjection/ApplyPCAProjection, rs_align_app.cpp:90-133),
PLY export (basic_capture.cpp:45), and the xyzrgb text format
(view_xyzrgb.cpp:14-39).

A copy of realsensetracker_tpu/vis/render.py: numpy, with matplotlib imported
lazily by the three render_*_png functions only.
"""

from __future__ import annotations

import numpy as np


def _scatter(ax, pts, colors, size=1.0):
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=colors, s=size, linewidths=0)


def _setup_axes(fig):
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    # Axis triad (DrawAxis analog, rs_align_app.cpp:135-166).
    for vec, c in zip(np.eye(3) * 0.1, ["r", "g", "b"]):
        ax.plot([0, vec[0]], [0, vec[1]], [0, vec[2]], c=c, linewidth=2)
    return ax


def render_cloud_png(path: str, clouds: list, size: float = 1.0) -> None:
    """Render [(points, color_or_rgbarray), ...] to a PNG scatter plot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 6))
    ax = _setup_axes(fig)
    for pts, color in clouds:
        pts = np.asarray(pts)
        if len(pts):
            _scatter(ax, pts, color, size)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def render_depth_png(path: str, depth, max_depth: float = 5.0) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(np.asarray(depth), cmap="viridis", vmin=0, vmax=max_depth)
    fig.colorbar(im, ax=ax, label="depth [m]")
    fig.savefig(path, dpi=110)
    plt.close(fig)


def render_matches_png(path: str, src_pts, dst_pts, pairs, color="b") -> None:
    """Correspondence lines (DrawMatches analog, rs_align_app.cpp:219-241)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 6))
    ax = _setup_axes(fig)
    src_pts, dst_pts = np.asarray(src_pts), np.asarray(dst_pts)
    _scatter(ax, src_pts, "r", 1.0)
    _scatter(ax, dst_pts, "g", 1.0)
    for i, j in pairs:
        a, b = src_pts[i], dst_pts[j]
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], c=color, linewidth=0.3)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def fpfh_pca_colors(fpfh: np.ndarray) -> np.ndarray:
    """FPFH -> RGB in [0,1] via whitened 3-component PCA.

    ComputePCAProjection + ApplyPCAProjection + the (x+2)/4 color mapping
    (rs_align_app.cpp:90-120, :345-353).
    """
    f = np.asarray(fpfh, np.float64)
    n = len(f)
    center = f.mean(0)
    centered = (f - center).T  # (33, N)
    u, s, _ = np.linalg.svd(centered, full_matrices=False)
    # Fewer than 3 feature rows -> SVD yields < 3 components; pad so the
    # output is always a valid (N, 3) RGB array (gray for missing axes).
    if u.shape[1] < 3:
        u = np.pad(u, ((0, 0), (0, 3 - u.shape[1])))
        s = np.pad(s, (0, 3 - s.shape[0]))
    scale = np.sqrt(max(n - 1.0, 1.0)) / np.maximum(s[:3], 1e-12)
    proj = (u[:, :3] * scale).T  # (3, 33)
    coords = (proj @ centered).T  # (N, 3)
    return np.clip((coords + 2.0) / 4.0, 0.0, 1.0)


def export_ply(path: str, points, colors=None, normals=None) -> None:
    """ASCII PLY export (basic_capture.cpp:45 export_to_ply analog).
    Optional per-point ``normals`` (N, 3) emit nx/ny/nz properties
    (oriented clouds, e.g. tsdf.extract_surface_oriented)."""
    points = np.asarray(points)
    n = len(points)
    nrm = np.asarray(normals, np.float32) if normals is not None else None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if nrm is not None:
            f.write("property float nx\nproperty float ny\n"
                    "property float nz\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        c8 = (
            np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            if colors is not None else None
        )
        for i, p in enumerate(points):
            row = f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
            if nrm is not None:
                row += f" {nrm[i][0]:.6f} {nrm[i][1]:.6f} {nrm[i][2]:.6f}"
            if c8 is not None:
                row += f" {c8[i][0]} {c8[i][1]} {c8[i][2]}"
            f.write(row + "\n")


def weld_mesh(triangles, colors=None, decimals: int = 6):
    """Merge a triangle soup's shared vertices into an indexed mesh.

    ``triangles`` is (T, 3, 3); adjacent cells' marching-tetrahedra
    output computes shared edge vertices from the same two voxel values,
    so welding on coordinates rounded to ``decimals`` reconnects the
    surface exactly (the rounding only absorbs float association noise,
    orders of magnitude below a voxel). Returns (vertices (N, 3),
    faces (T, 3) int32[, vertex_colors (N, 3)]) -- last-writer-wins on
    per-vertex color, which agree across triangles anyway (same lerp).
    """
    tris = np.asarray(triangles, np.float64).reshape(-1, 3)
    keys = np.round(tris, decimals)
    uniq, index, inverse = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    vertices = tris[index].astype(np.float32)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    if colors is None:
        return vertices, faces
    vcol = np.zeros((len(vertices), 3), np.float32)
    vcol[inverse] = np.asarray(colors, np.float32).reshape(-1, 3)
    return vertices, faces, vcol


def export_mesh_ply(path: str, triangles, colors=None,
                    weld: bool = True) -> None:
    """ASCII PLY TRIANGLE-MESH export (vertices + faces).

    ``triangles`` is a (T, 3, 3) soup (already mask-filtered);
    ``colors`` an optional matching (T, 3, 3) per-vertex RGB in [0, 1].
    With ``weld`` (default) shared vertices are merged so the file is a
    connected mesh, not 3T duplicated points.
    """
    triangles = np.asarray(triangles)
    if weld:
        out = weld_mesh(triangles, colors)
        vertices, faces = out[0], out[1]
        vcol = out[2] if colors is not None else None
    else:
        vertices = triangles.reshape(-1, 3)
        faces = np.arange(vertices.shape[0], dtype=np.int32).reshape(-1, 3)
        vcol = (
            np.asarray(colors, np.float32).reshape(-1, 3)
            if colors is not None else None
        )
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if vcol is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        if vcol is None:
            for p in vertices:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        else:
            c8 = np.clip(vcol * 255, 0, 255).astype(np.uint8)
            for p, c in zip(vertices, c8):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{c[0]} {c[1]} {c[2]}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def save_xyzrgb(path: str, points, colors) -> None:
    """xyzrgb text format writer (counterpart of view_xyzrgb.cpp:14-39)."""
    points = np.asarray(points)
    colors = np.asarray(colors)
    with open(path, "w") as f:
        for p, c in zip(points, colors):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def load_xyzrgb(path: str):
    """xyzrgb text parser (LoadXyzrgb, view_xyzrgb.cpp:14-39)."""
    pts, cols = [], []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) < 6:
                continue
            pts.append([float(v) for v in vals[:3]])
            cols.append([float(v) for v in vals[3:6]])
    return np.asarray(pts, np.float32), np.asarray(cols, np.float32)
