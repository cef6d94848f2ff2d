"""The host triangle rasterizer (counterpart of
``videoloop3d_tpu/render/raster_cpp.py``): the native stand-in for the
reference's PyTorch3D ``rasterize_meshes`` (utils.py:20-70
SimpleRasterizer), for golden tests of the plane-sweep renderer.

``csrc/rasterizer.cpp`` (the port's own copy of the JAX package's
source) is built with ``g++`` at first use into
``build/raster/librasterizer-<source hash>.so`` at the repository root
and bound with ctypes.  Host numpy in and out; no device.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "rasterizer.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "raster")


def _build_lib():
    """The library's path, built when none exists for this source (keyed
    by the source's hash, not by mtimes, which a checkout does not
    keep)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"librasterizer-{digest}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = out + ".tmp"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                            _SRC, "-o", tmp], check=True)
            os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _get_lib():
    lib = ctypes.CDLL(_build_lib())
    lib.rasterize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.rasterize.restype = None
    return lib


def rasterize(verts, faces, h, w, faces_per_pixel):
    """Rasterize triangles on the host.

    verts (N, 3) float32: (x_pix, y_pix, z_view), pixel centers at
    integer coordinates; faces (F, 3) int32; faces_per_pixel: the K
    nearest faces kept per pixel.  Returns (pix_to_face (h, w, K) int32,
    -1 where empty; zbuf (h, w, K) f32; bary (h, w, K, 3) f32,
    perspective-corrected)."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    K = int(faces_per_pixel)
    pix_to_face = np.full((h, w, K), -1, np.int32)
    zbuf = np.full((h, w, K), -1.0, np.float32)
    bary = np.zeros((h, w, K, 3), np.float32)
    _get_lib().rasterize(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(faces), h, w, K,
        pix_to_face.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        zbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bary.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return pix_to_face, zbuf, bary


def project_vertices(verts_ref, extrin, intrin):
    """Reference-space vertices -> screen-space (x_pix, y_pix, z_view)."""
    v = np.asarray(verts_ref, np.float64)
    R = np.asarray(extrin)[:3, :3]
    t = np.asarray(extrin)[:3, 3]
    pv = v @ R.T + t
    proj = pv @ np.asarray(intrin).T
    return np.stack([proj[:, 0] / pv[:, 2], proj[:, 1] / pv[:, 2],
                     pv[:, 2]], axis=-1).astype(np.float32)
