"""Export a trained MTV to the WebGL viewer format, and the trainers' mesh
previews (counterpart of ``videoloop3d_tpu/export/mesh_export.py``).

`export_mtv` writes the artifact set of reference
scripts/script_export_mesh.py:76-191: ``geometry.obj`` (vertex-coloured,
faces depth-sorted far to near for painter's-algorithm blending),
``static.png``, ``dynamic/%04d.png`` and ``meta.json``, which the external
VideoLoopUI player loads.  Kept tiles are packed into a near-square grid
with the aspect heuristic of the reference cull (MPI.py:367-377) and the
UV islands are made as in MPI.py:403-418.  Host work: numpy, and the
texel activation as a torch op on CPU tensors.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from videoloop3d_torch.core.activations import get_activation
from videoloop3d_torch.data.video import write_image
from videoloop3d_torch.export.objio import (
    cull_unused, normalize_uv, save_obj, save_obj_with_vcolor)


def packing_grid(n, max_ratio=4):
    """Near-square (rows, cols) with rows*cols >= n
    (parity: MPI.py:367-377 get_hw)."""
    if n == 0:
        return 0, 0
    n_min = int(np.sqrt(n / max_ratio))
    n_max = int(np.sqrt(n))
    tries = np.arange(max(n_min, 1), max(n_max, n_min + 1) + 1)
    sel = int(np.argmin(tries - n % tries))
    rows = int(tries[sel])
    cols = n // rows + 1
    return rows, cols


def pack_tiles_to_atlas(tiles):
    """(N, th, tw, C) -> (atlas (H, W, C), per-tile uv rects in [-1,1])."""
    n, th, tw, c = tiles.shape
    rows, cols = packing_grid(n)
    atlas = np.zeros((rows * th, cols * tw, c), tiles.dtype)
    uv_rects = np.zeros((n, 4, 2), np.float64)        # corners 0,1,2,3
    ah, aw = atlas.shape[:2]
    span_u = 2 / (aw - 1) * (tw - 1)
    span_v = 2 / (ah - 1) * (th - 1)
    for k in range(n):
        r, col = divmod(k, cols)
        atlas[r * th:(r + 1) * th, col * tw:(col + 1) * tw] = tiles[k]
        u0 = col * tw / (aw - 1) * 2 - 1
        v0 = r * th / (ah - 1) * 2 - 1
        uv_rects[k] = [[u0, v0], [u0 + span_u, v0],
                       [u0, v0 + span_v], [u0 + span_u, v0 + span_v]]
    return atlas, uv_rects


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


def export_mtv(outdir, geom, params, tile_map_static, tile_map_dyn,
               scene_meta, rgb_activate="sigmoid", alpha_activate="sigmoid",
               fps=25):
    """Write geometry.obj / static.png / dynamic/%04d.png / meta.json."""
    os.makedirs(outdir, exist_ok=True)
    act_rgb = get_activation(rgb_activate)
    act_a = get_activation(alpha_activate)

    def activate(t):
        t = torch.from_numpy(np.ascontiguousarray(t, np.float32))
        return torch.cat([act_rgb(t[..., :3]), act_a(t[..., 3:4])],
                         -1).numpy()

    static_tiles = np.asarray(params["atlas"], np.float32)
    dyn_tiles = np.asarray(params["atlas_dyn"], np.float32)
    # dynamic layout (Nd, th, tw, F, 4) -> (F, Nd, th, tw, 4)
    if dyn_tiles.ndim == 5:
        dyn_frames = np.moveaxis(dyn_tiles, 3, 0)
    else:
        dyn_frames = dyn_tiles[None]

    verts = geom.vertex_grid()

    static_atlas, uv_s = pack_tiles_to_atlas(activate(static_tiles))
    n_frames = dyn_frames.shape[0]
    packed = [pack_tiles_to_atlas(activate(f)) for f in dyn_frames]
    dyn_packed = [atlas for atlas, _ in packed]
    uv_d = packed[0][1]

    faces_s = build_mesh_for_map(geom, tile_map_static)
    faces_d = build_mesh_for_map(geom, tile_map_dyn)
    uvs_s = uv_s[:len(faces_s) // 2].reshape(-1, 2)
    uvs_d = uv_d[:len(faces_d) // 2].reshape(-1, 2)
    uvf_s = uvfaces_for_tiles(len(faces_s) // 2)
    uvf_d = uvfaces_for_tiles(len(faces_d) // 2)

    uvs_s = normalize_uv(uvs_s, *static_atlas.shape[:2]) \
        if len(uvs_s) else uvs_s.reshape(-1, 2)
    uvs_d = normalize_uv(uvs_d, *dyn_packed[0].shape[:2]) \
        if len(uvs_d) else uvs_d.reshape(-1, 2)

    # vertex-coloured split: red = static, green = dynamic (ref :159-169)
    sv, sf = cull_unused(verts, faces_s) if len(faces_s) \
        else (verts[:0], faces_s)
    suv, suvf = (cull_unused(uvs_s, uvf_s) if len(uvf_s)
                 else (uvs_s, uvf_s))
    dv, df = cull_unused(verts, faces_d) if len(faces_d) \
        else (verts[:0], faces_d)
    duv, duvf = (cull_unused(uvs_d, uvf_d) if len(uvf_d)
                 else (uvs_d, uvf_d))
    scolor = np.zeros_like(sv)
    scolor[:, 0] = 1
    dcolor = np.zeros_like(dv)
    dcolor[:, 1] = 1
    newv = np.concatenate([np.concatenate([sv, scolor], -1),
                           np.concatenate([dv, dcolor], -1)])
    newuv = np.concatenate([suv, duv]) if len(suv) or len(duv) else suv
    newf = np.concatenate([sf, df + len(sv)]) if len(df) else sf
    newuvf = np.concatenate([suvf, duvf + len(suv)]) if len(duvf) else suvf

    # painter's algorithm: far -> near (ref :177-181)
    depth = newv[newf[:, 0]][:, 2]
    order = np.argsort(depth)[::-1]
    newf = newf[order]
    newuvf = newuvf[order]

    save_obj_with_vcolor(os.path.join(outdir, "geometry.obj"),
                         newv, newf, newuv, newuvf)
    if static_atlas.size:
        write_image(os.path.join(outdir, "static.png"),
                    np.clip(static_atlas * 255, 0, 255).astype(np.uint8))
    dyndir = os.path.join(outdir, "dynamic")
    os.makedirs(dyndir, exist_ok=True)
    for i, frame in enumerate(dyn_packed):
        if frame.size:
            write_image(os.path.join(dyndir, f"{i:04d}.png"),
                        np.clip(frame * 255, 0, 255).astype(np.uint8))

    meta = dict(scene_meta)
    meta.setdefault("fps", fps)
    meta["frame_count"] = n_frames
    with open(os.path.join(outdir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=4)
    return outdir


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


def scene_meta_from_llff(scene):
    """The camera metadata block (ref script_export_mesh.py:88-111)."""
    poses = scene["poses"]
    bds = scene["bds"]
    intrins = scene["intrins"]
    up = poses[:, :3, 1].sum(0)
    up = (up / np.linalg.norm(up)).tolist()
    up[1] = -up[1]
    close, inf = bds.min() * 0.9, bds.max() * 5.0
    focal = 1.0 / ((1.0 - 0.75) / close + 0.75 / inf)
    rads = np.abs(poses[:, :3, 3]).max(0) * 0.8
    f = intrins[:, 0, 0].mean()
    cy = intrins[:, 1, 2].mean()
    return {
        "fov": float(np.arctan(cy / f) * 2 / np.pi * 180),
        "near": float(bds.min()),
        "far": float(bds.max()),
        "up": up,
        "lookat": [0, 0, float(focal)],
        "limit": rads.tolist(),
    }
