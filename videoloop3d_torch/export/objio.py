"""Wavefront OBJ writers and mesh utilities (counterpart of
``videoloop3d_tpu/export/objio.py``; numpy only).

Parity: reference utils.py:367-435 (save_obj, save_obj_with_vcolor,
save_obj_multimaterial, cull_unused, normalize_uv)."""
from __future__ import annotations

import numpy as np


def normalize_uv(uv, h, w):
    """[-1,1] atlas coords -> OBJ texture coords (flip v, texel centers).
    Parity: utils.py:403-407."""
    uv = np.array(uv, np.float64, copy=True)
    uv[:, 1] = -uv[:, 1]
    uv = uv * 0.5 + 0.5
    uv = uv * np.array([w - 1, h - 1]) / np.array([w, h]) \
        + 0.5 / np.array([w, h])
    return uv


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


def save_obj_with_vcolor(path, verts_colors, faces, uvs, uvfaces):
    with open(path, "w") as f:
        for vc in verts_colors:
            f.write(f"v {vc[0]} {vc[1]} {vc[2]} {vc[3]} {vc[4]} {vc[5]}\n")
        for uv in uvs:
            f.write(f"vt {uv[0]} {uv[1]}\n")
        for face, uvf in zip(faces + 1, uvfaces + 1):
            f.write(f"f {face[0]}/{uvf[0]} {face[1]}/{uvf[1]} "
                    f"{face[2]}/{uvf[2]}\n")
        f.write("\n")


def save_obj_multimaterial(path, verts, faces_list, uvs, uvfaces_list,
                           mtls_list):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for uv in uvs:
            f.write(f"vt {uv[0]} {uv[1]}\n")
        for mtl, faces, uvfaces in zip(mtls_list, faces_list, uvfaces_list):
            f.write(f"usemtl {mtl}\ns off\n")
            for face, uvf in zip(faces + 1, uvfaces + 1):
                f.write(f"f {face[0]}/{uvf[0]} {face[1]}/{uvf[1]} "
                        f"{face[2]}/{uvf[2]}\n")
        f.write("\n")


def load_obj(path):
    """Minimal OBJ reader: (verts, uvs, faces, uvfaces) with 0-based
    indices."""
    verts, uvs, faces, uvfaces = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                fv, fuv = [], []
                for p in parts[1:4]:
                    a = p.split("/")
                    fv.append(int(a[0]) - 1)
                    fuv.append(int(a[1]) - 1 if len(a) > 1 and a[1] else 0)
                faces.append(fv)
                uvfaces.append(fuv)
    return (np.array(verts), np.array(uvs), np.array(faces),
            np.array(uvfaces))
