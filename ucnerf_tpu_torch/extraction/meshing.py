"""Isosurface meshing (surface nets) + PLY export (a copy of
``ucnerf_tpu/extraction/meshing.py``, which is numpy; ``mesh_from_tsdf``
takes the port's ``TSDFGrid``, whose arrays are torch tensors).

Replaces the reference's marching-cubes + pymeshlab/trimesh stack
(the reference's ``nerf/extract.py:290-638``, ``tsdf.py:196-222``) with a
dependency-free naive surface-nets mesher: one vertex per sign-changing cell
at the mean of its edge crossings, quads across sign-changing faces (split
into triangles).  Surface nets produce comparably smooth, watertight meshes
without the 256-case tables, and vectorize cleanly in numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Cell-corner offsets and the 12 edges of a cube (corner index pairs).
_CORNERS = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                     for k in (0, 1)])
_EDGES = np.array([
    (0, 1), (2, 3), (4, 5), (6, 7),   # z edges
    (0, 2), (1, 3), (4, 6), (5, 7),   # y edges
    (0, 4), (1, 5), (2, 6), (3, 7),   # x edges
])


def surface_nets(sdf, level=0.0, origin=(0.0, 0.0, 0.0), voxel_size=1.0,
                 mask=None):
    """Mesh the `level` isosurface of a dense SDF volume.

    Args:
      sdf: [X, Y, Z] scalar field.
      level: iso level.
      origin: world position of voxel (0,0,0)'s corner.
      voxel_size: world size of one voxel.
      mask: optional [X, Y, Z] bool of valid voxels (e.g. TSDF weight > 0);
        cells touching invalid voxels are skipped.

    Returns:
      (vertices [V, 3] float32, faces [F, 3] int32).
    """
    sdf = np.asarray(sdf, np.float32) - level
    nx, ny, nz = sdf.shape

    # Corner values per cell: [nx-1, ny-1, nz-1, 8].
    c = np.stack([
        sdf[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
        for dx, dy, dz in _CORNERS
    ], axis=-1)
    if mask is not None:
        mvalid = np.stack([
            mask[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
            for dx, dy, dz in _CORNERS
        ], axis=-1).all(-1)
    else:
        mvalid = np.ones(c.shape[:-1], bool)

    neg = c < 0
    crossing = mvalid & ~(neg.all(-1) | (~neg).all(-1))
    cells = np.argwhere(crossing)  # [M, 3]
    if len(cells) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    cvals = c[crossing]  # [M, 8]

    # Vertex = mean of the cell's edge crossings (linear interpolation).
    v0 = cvals[:, _EDGES[:, 0]]
    v1 = cvals[:, _EDGES[:, 1]]
    cross_e = (v0 < 0) != (v1 < 0)  # [M, 12]
    t = np.where(cross_e, v0 / np.where(np.abs(v0 - v1) > 1e-12, v0 - v1, 1),
                 0.0)
    p0 = _CORNERS[_EDGES[:, 0]].astype(np.float32)  # [12, 3]
    p1 = _CORNERS[_EDGES[:, 1]].astype(np.float32)
    pts = p0[None] + t[..., None] * (p1 - p0)[None]  # [M, 12, 3]
    w = cross_e[..., None].astype(np.float32)
    verts_local = (pts * w).sum(1) / np.maximum(w.sum(1), 1e-9)
    verts = (cells + verts_local) * voxel_size + np.asarray(origin)

    # Map cell -> vertex id.
    vert_id = -np.ones(crossing.shape, np.int64)
    vert_id[crossing] = np.arange(len(cells))

    faces = []
    # For each axis, faces dual to sign-changing edges along that axis.
    for axis in range(3):
        a0 = sdf[tuple(slice(0, -1) if ax == axis else slice(1, None)
                       for ax in range(3))]
        a1 = sdf[tuple(slice(1, None) for ax in range(3))]
        flip_edge = (a0 < 0) != (a1 < 0)
        edge_cells = np.argwhere(flip_edge)  # in the shifted frame
        if len(edge_cells) == 0:
            continue
        # The 4 cells sharing this edge: offsets in the two other axes.
        oa = [ax for ax in range(3) if ax != axis]
        quads = []
        ok = np.ones(len(edge_cells), bool)
        for d0 in (0, 1):
            for d1 in (0, 1):
                # argwhere indices: along `axis` they equal the edge's cell
                # index; along the other axes the slice(1, None) already
                # shifted them to p_other - 1, so adding d in {0, 1} yields
                # the two adjacent cells {p_other - 1, p_other}.
                cell = edge_cells.copy()
                cell[:, oa[0]] += d0
                cell[:, oa[1]] += d1
                inb = ((cell >= 0).all(1)
                       & (cell[:, 0] < crossing.shape[0])
                       & (cell[:, 1] < crossing.shape[1])
                       & (cell[:, 2] < crossing.shape[2]))
                vid = np.full(len(cell), -1, np.int64)
                vid[inb] = vert_id[tuple(cell[inb].T)]
                quads.append(vid)
                ok &= vid >= 0
        q = np.stack(quads, axis=1)[ok]  # [Q, 4] order (00, 01, 10, 11)
        orient = (a1[flip_edge] < 0)[ok]  # surface faces the negative side
        # Two triangles per quad; flip winding by sign orientation.
        t1 = np.where(orient[:, None], q[:, [0, 1, 3]], q[:, [0, 3, 1]])
        t2 = np.where(orient[:, None], q[:, [0, 3, 2]], q[:, [0, 2, 3]])
        faces.append(t1)
        faces.append(t2)

    faces = (np.concatenate(faces, 0).astype(np.int32) if faces
             else np.zeros((0, 3), np.int32))
    return verts.astype(np.float32), faces


def write_ply(path, vertices, faces, colors=None):
    """Binary little-endian PLY writer (replaces trimesh export)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    n_v, n_f = len(vertices), len(faces)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n_v}",
                  "property float x", "property float y", "property float z"]
        if colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += [f"element face {n_f}",
                   "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(header) + "\n").encode())
        if colors is not None:
            cols = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
            rec = np.zeros(n_v, dtype=[("xyz", np.float32, 3),
                                       ("rgb", np.uint8, 3)])
            rec["xyz"] = vertices
            rec["rgb"] = cols
            f.write(rec.tobytes())
        else:
            f.write(vertices.tobytes())
        frec = np.zeros(n_f, dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())


def _host(x):
    """A numpy copy of a torch tensor (on any device) or an array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def mesh_from_tsdf(grid, min_weight=1.0):
    """Extract the zero level set of a TSDFGrid (tsdf.py:196-222)."""
    sdf = _host(grid.tsdf)
    weight = _host(grid.weight)
    mask = weight >= min_weight
    verts, faces = surface_nets(
        sdf, level=0.0,
        origin=(-grid.radius + 0.5 * grid.voxel_size,) * 3,
        voxel_size=grid.voxel_size, mask=mask)
    colors = None
    if grid.color is not None and len(verts):
        # Nearest-voxel vertex colors.
        idx = np.clip(((verts + grid.radius) / grid.voxel_size - 0.5).round()
                      .astype(int), 0, grid.resolution - 1)
        colors = _host(grid.color)[idx[:, 0], idx[:, 1], idx[:, 2]]
    return verts, faces, colors
