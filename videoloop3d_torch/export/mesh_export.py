"""Tile meshes of the plane geometry (the part of
``videoloop3d_tpu/export/mesh_export.py`` the stage-1 trainer's mesh
previews need; numpy only).  The viewer export (`export_mtv`) arrives
with ROADMAP Queue A item 7.
"""
from __future__ import annotations

import numpy as np

from videoloop3d_torch.export.objio import save_obj


def tile_vertex_indices(geom, d, i, j):
    """Vertex-grid indices of tile (plane d, row i, col j) corners
    0 - 1
    | \\ |
    2 - 3   (triangles (0,1,3), (3,2,0), parity MPI.py:74-77)."""
    nvw = geom.n_tiles_w + 1
    nvh = geom.n_tiles_h + 1
    v0 = d * nvh * nvw + i * nvw + j
    v2 = v0 + nvw
    return v0, v0 + 1, v2, v2 + 1


def build_mesh_for_map(geom, tile_map):
    """Faces of every kept tile in a tile map, ordered by packed index."""
    D, nth, ntw = tile_map.shape
    order = sorted((int(tile_map[d, i, j]), d, i, j)
                   for d in range(D) for i in range(nth) for j in range(ntw)
                   if tile_map[d, i, j] >= 0)
    faces = []
    for _, d, i, j in order:
        v0, v1, v2, v3 = tile_vertex_indices(geom, d, i, j)
        faces.append([v0, v1, v3])
        faces.append([v3, v2, v0])
    return np.array(faces, np.int64).reshape(-1, 3)


def uvfaces_for_tiles(n_tiles):
    """UV faces indexing 4 uv verts per tile (parity MPI.py:415-418)."""
    offsets = np.array([[0, 1, 3], [3, 2, 0]])
    base = np.arange(n_tiles)[:, None, None] * 4
    return (base + offsets[None]).reshape(-1, 3)


def save_mesh_preview(geom, tile_map_static, tile_map_dyn, path_prefix):
    """Training-cadence OBJ dumps (ref MPI.py:223-239 save_mesh):
    `<prefix>.obj` for the static tile mesh and `<prefix>_dyn.obj` for the
    dynamic one.  Dense phase: tile_map_static full, tile_map_dyn None."""
    verts = geom.vertex_grid()
    for tm, suffix in ((tile_map_static, ""), (tile_map_dyn, "_dyn")):
        if tm is None:
            continue
        faces = build_mesh_for_map(geom, np.asarray(tm))
        if not len(faces):
            continue
        n_tiles = len(faces) // 2
        # previews carry a unit uv per tile corner
        uvs = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]],
                               np.float64), (n_tiles, 1))
        save_obj(path_prefix + suffix + ".obj", verts, faces, uvs,
                 uvfaces_for_tiles(n_tiles))


def full_tile_map(geom):
    """All-tiles map for dense-phase mesh previews."""
    n = geom.n_planes * geom.n_tiles_h * geom.n_tiles_w
    return np.arange(n, dtype=np.int32).reshape(
        geom.n_planes, geom.n_tiles_h, geom.n_tiles_w)
