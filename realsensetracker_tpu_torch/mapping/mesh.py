"""Triangle-mesh extraction from a TSDF volume (marching tetrahedra).

Port of realsensetracker_tpu/mapping/mesh.py, plain torch (an on-demand
export path, not the tracking loop). Each cube splits into the 6 Kuhn
tetrahedra around its main diagonal; a tetrahedron has 16 sign cases of at
most 2 triangles each, and the (6, 16, 2, 3) table is derived at import
time (crossing-edge enumeration and a numerical winding check against the
in-tet linear field's gradient, so normals point from inside, tsdf < 0,
into free space). The port keeps its own copy of the derivation. Every tet
pass is one dense sweep over the (V-1)^3 cells compacted straight to
``capacity`` (a stable compaction: the port's triangles come in JAX's
order), then the six passes merge.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod

# Cube corner c in 0..7 sits at offset (c & 1, c >> 1 & 1, c >> 2 & 1)
# voxel units from the cell's base voxel centre.
_CORNER_BITS = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int32)

# Kuhn subdivision: the 6 tetrahedra {0 <= x_s3 <= x_s2 <= x_s1 <= 1} over
# axis orderings, all sharing the 0-7 main diagonal; conforming across cells.
_TETS = ((0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7), (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7))

# The 6 edges of a tetrahedron as (lo, hi) local vertex index pairs.
_TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_EDGE_INDEX = {e: i for i, e in enumerate(_TET_EDGES)}


def _build_tri_tables() -> np.ndarray:
    """The (6, 16, 2, 3) triangulation table: entry [t, case, k] holds the
    k-th triangle's 3 edge indices (into _TET_EDGES) for tet t under sign
    case ``case`` (bit i set = local vertex i inside, tsdf < 0), -1-padded.
    Each candidate triangle is evaluated on the representative field
    (inside -1, outside +1, edge midpoints) and flipped unless its normal
    agrees with the linear field's gradient (inside -> outside)."""
    table = np.full((6, 16, 2, 3), -1, np.int32)
    for t, tet in enumerate(_TETS):
        pos = _CORNER_BITS[list(tet)].astype(np.float64)  # (4, 3)
        for case in range(16):
            neg = [i for i in range(4) if case >> i & 1]
            if len(neg) in (0, 4):
                continue
            vals = np.where([(case >> i) & 1 for i in range(4)], -1.0, 1.0)
            A = np.concatenate([pos, np.ones((4, 1))], axis=1)
            grad = np.linalg.solve(A, vals)[:3]  # the linear field's gradient, outward

            def orient(tri_edges, pos=pos, grad=grad):
                p = [0.5 * (pos[_TET_EDGES[e][0]] + pos[_TET_EDGES[e][1]]) for e in tri_edges]
                if np.dot(np.cross(p[1] - p[0], p[2] - p[0]), grad) < 0:
                    return (tri_edges[0], tri_edges[2], tri_edges[1])
                return tri_edges

            if len(neg) in (1, 3):
                k = neg[0] if len(neg) == 1 else next(i for i in range(4) if i not in neg)
                others = [i for i in range(4) if i != k]
                table[t, case, 0] = orient(tuple(_EDGE_INDEX[tuple(sorted((k, o)))] for o in others))
            else:  # 2 inside, 2 outside: a quad, split into 2 triangles
                na, nb = neg
                pc, pd = [i for i in range(4) if i not in neg]
                # Quad cycle ac -> ad -> bd -> bc (consecutive points share a face).
                e = [_EDGE_INDEX[tuple(sorted(pair))] for pair in ((na, pc), (na, pd), (nb, pd), (nb, pc))]
                table[t, case, 0] = orient((e[0], e[1], e[2]))
                table[t, case, 1] = orient((e[0], e[2], e[3]))
    return table


_TRI_TABLES = _build_tri_tables()


class TriangleMesh(NamedTuple):
    """Fixed-capacity triangle soup: vertices (T, 3, 3), mask (T,) bool,
    optional per-vertex colors (T, 3, 3) in [0, 1]."""

    vertices: torch.Tensor
    mask: torch.Tensor
    colors: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.vertices.shape[0]

    def count(self) -> torch.Tensor:
        return self.mask.sum()


def _corner_view(grid: torch.Tensor, c: int) -> torch.Tensor:
    """(V-1)^3 view of ``grid`` (trailing channel dims kept) at cube-corner offset c."""
    v = grid.shape[0]
    bx, by, bz = (int(b) for b in _CORNER_BITS[c])
    return grid[bx:bx + v - 1, by:by + v - 1, bz:bz + v - 1]


def _tet_candidates(vol: tsdf_mod.TsdfVolume, cfg: tsdf_mod.TsdfConfig, t: int, with_color: bool):
    """All candidate triangles of tet ``t`` across every cell: rows
    (2 (V-1)^3, 9 [+ 9 color]) f32 and their validity mask."""
    tet = _TETS[t]
    c = cfg.resolution - 1
    n = c * c * c
    dev = vol.tsdf.device
    vs = tsdf_mod.f32(cfg.voxel_size)
    # Base voxel-centre coordinate line per axis, (c, 3).
    line = torch.tensor([tsdf_mod.f32(o) for o in cfg.origin], dtype=torch.float32, device=dev)[None, :] + (
        (torch.arange(c, dtype=torch.float32, device=dev) + 0.5)[:, None] * vs
    )
    vals = [_corner_view(vol.tsdf, k) for k in tet]
    seen = _corner_view(vol.weight, tet[0]) > 0
    for k in tet[1:]:
        seen = seen & (_corner_view(vol.weight, k) > 0)
    case = sum((vals[i] < 0).to(torch.int64) << i for i in range(4)).reshape(n)

    cols = cws = None
    if with_color:
        cols = [_corner_view(vol.color, k).reshape(n, 3) for k in tet]
        # Color fuses only in the near-surface band: a crossing may straddle a
        # voxel that never received color; take the colored endpoint there.
        cws = [(_corner_view(vol.color_weight, k) > 0).reshape(n) for k in tet]

    edge_pts, edge_cols = [], []
    for a, b in _TET_EDGES:
        va, vb = vals[a], vals[b]
        denom = va - vb
        frac = (va / torch.where(denom.abs() > 1e-12, denom, tsdf_mod.f32(1e-12))).clamp(0.0, 1.0).reshape(n)
        bits_a = _CORNER_BITS[tet[a]]
        delta = (_CORNER_BITS[tet[b]] - bits_a).astype(np.float32)
        axes = []
        for ax in range(3):
            shape = [c if d == ax else 1 for d in range(3)]
            base = line[:, ax].reshape(shape) + float(bits_a[ax]) * vs
            p = base.expand(c, c, c).reshape(n)
            if delta[ax]:
                p = tsdf_mod.fma(frac, float(delta[ax]) * vs, p)
            axes.append(p)
        edge_pts.append(torch.stack(axes, dim=-1))  # (n, 3)
        if with_color:
            ca, cb = cols[a], cols[b]
            lerp = tsdf_mod.fma(frac[:, None], cb - ca, ca)
            both = (cws[a] & cws[b])[:, None]
            edge_cols.append(torch.where(both, lerp, torch.where(cws[a][:, None], ca, cb)))
    epts = torch.stack(edge_pts, dim=1)  # (n, 6, 3)

    ids = torch.as_tensor(_TRI_TABLES[t], device=dev)[case]  # (n, 2, 3)
    flat = ids.clamp(min=0).reshape(n, 6).long()
    rows = torch.gather(epts, 1, flat[:, :, None].expand(n, 6, 3)).reshape(n * 2, 9)
    valid = ((ids[:, :, 0] >= 0) & seen.reshape(n)[:, None]).reshape(n * 2)
    if with_color:
        ecol = torch.stack(edge_cols, dim=1)  # (n, 6, 3)
        crow = torch.gather(ecol, 1, flat[:, :, None].expand(n, 6, 3)).reshape(n * 2, 9)
        rows = torch.cat([rows, crow], dim=-1)
    return rows, valid


def extract_mesh(vol: tsdf_mod.TsdfVolume, cfg: tsdf_mod.TsdfConfig = tsdf_mod.TsdfConfig(),
                 capacity: int = 131072, with_color: bool = False) -> TriangleMesh:
    """Zero-level surface of ``vol`` as a fixed-capacity triangle mesh.

    Triangles appear only where all four tet corners are observed (weight >
    0), normals face free space, and above ``capacity`` crossings the
    compaction keeps a spatially uniform subsample
    (ops.cloud.subsample_to_capacity). ``with_color`` interpolates the fused
    RGB onto each vertex (colored volumes). A sharded volume's planes are
    gathered first (tsdf.whole)."""
    if with_color and vol.color is None:
        raise ValueError("extract_mesh(with_color=True) needs a colored volume (init_volume(with_color=True))")
    vol = tsdf_mod.whole(vol)
    parts = [tsdf_mod._compact_to_capacity(*_tet_candidates(vol, cfg, t, with_color), capacity) for t in range(6)]
    merged = tsdf_mod._compact_to_capacity(torch.cat([p.points for p in parts]),
                                           torch.cat([p.mask for p in parts]), capacity)
    verts = merged.points[:, :9].reshape(capacity, 3, 3)
    colors = merged.points[:, 9:].reshape(capacity, 3, 3) if with_color else None
    return TriangleMesh(vertices=verts, mask=merged.mask, colors=colors)
