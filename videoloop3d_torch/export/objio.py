"""Wavefront OBJ writer and mesh utilities (the part of
``videoloop3d_tpu/export/objio.py`` the stage-1 mesh previews need;
parity: reference utils.py:367-435)."""
from __future__ import annotations

import numpy as np


def cull_unused(verts, faces):
    """Drop vertices unreferenced by faces, reindexing faces.
    Parity: utils.py:410-416."""
    used = np.unique(faces)
    remap = np.full(len(verts), -1, used.dtype)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def save_obj(path, verts, faces, uvs, uvfaces, rm_unused=True):
    if rm_unused:
        verts, faces = cull_unused(verts, faces)
        uvs, uvfaces = cull_unused(uvs, uvfaces)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for uv in uvs:
            f.write(f"vt {uv[0]} {uv[1]}\n")
        for face, uvf in zip(faces + 1, uvfaces + 1):
            f.write(f"f {face[0]}/{uvf[0]} {face[1]}/{uvf[1]} "
                    f"{face[2]}/{uvf[2]}\n")
        f.write("\n")
