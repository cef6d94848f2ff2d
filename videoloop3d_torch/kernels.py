"""Build, load and count the port's CUDA kernels.

The sources are ``csrc/*.cu`` with a plain C interface.  At first use,
`library()` compiles each source with its own ``nvcc`` process (all
started together) for ``sm_90a`` and links them into
``build/torch_kernels/libvl3d_kernels.so`` at the repository root, then
loads it with ``ctypes``.  A stamp file holds a hash of the sources and
flags, so a changed source rebuilds.  A failed build raises with nvcc's
output; nothing falls back to the plain versions.

Every wrapper (``render/renderer.py:warp_lookup`` K1,
``render/sample.py:bilinear_tiles`` K2 and its gradient
``bilinear_tiles_grad`` K9, ``bilinear_tiles_tilemajor`` K3 and its
gradient ``bilinear_tiles_tilemajor_grad`` K10, ``sample_dense`` K5 and
its backward K6, ``render/fused.py:composite`` K4,
``render/fused_s1.py:fused_composite_s1`` forward K7 and backward K8,
``losses/patch_nn.py:nn_argmin`` K11 and ``nn_fold`` K12,
``render/compact.py:compact_sweep`` K13, ``render/fused.py:fused_s2_fwd``
K14 and ``fused_s2_bwd`` K15, ``render/sample.py:bilinear_planes_tilemajor``
K16 and its gradient ``bilinear_planes_tilemajor_grad`` K17,
``losses/patch_nn.py:nn_band_argmin`` K18 and ``nn_band_err`` K19,
``render/geo_warp.py:geo_warp_fwd`` K20 and ``geo_warp_bwd`` K21,
``render/sample.py:sample_dense_coord_grad`` K22 and
``bilinear_tiles_coord_grad`` K23, and K1's coordinate entry
``render/renderer.py:tile_lookup_coords``, ``losses/swd.py:swd_project``
K24, ``swd_sort_l1`` K25 and ``swd_project_grad`` K26, the swd mask
branch's ``swd_mask_sort`` K27 and ``swd_mask_l1`` K28, and the two modes
of K11 and K12 that ``losses/patch_nn.py`` counts apart: the ssim
distance of ``nn_argmin`` (``nn_argmin_ssim``), gpnn_down's parent
fold of ``nn_fold`` (``nn_fold_parent``), and the frame-parallel gpnn
loss's column minima ``nn_argmin_colmin``, search against given minima
``nn_argmin_given`` and undivided fold ``nn_fold_numer``) adds
one to its entry of `LAUNCHES` where it launches its kernel, and nowhere
else.  Thirty other designs stay in the library beside their
redesigns for the comparisons of ``chip_smoke.py`` (and the card tests),
and no wrapper calls them: ``vl3d_sample_dense_coord_grad_first`` (K22
at any C with one thread a sample walking its channels),
``vl3d_bilinear_tiles_first`` (K2 at any C
with one thread a sample writing its C channels),
``vl3d_bilinear_tiles_tilemajor_first`` (K3 at any C with one thread a
(sample, frame) writing its C channels),
``vl3d_bilinear_tiles_coord_grad_first`` (K23 with one thread a sample
and a run-time channel loop, into outputs its caller zero-fills),
``vl3d_fused_s1_fwd_first`` (K7 with one thread a pixel decoding its
pixel and its right and lower neighbours again at each plane),
``vl3d_fused_s1_bwd_first`` (K8 with one thread a pixel, T_in in local
memory and every neighbour decoded again at each plane),
``vl3d_swd_mask_l1_first`` (K28 writing each sign as an f32 at x's
payload and reading it back, the deficit's copies sorted in a local
array),
``vl3d_geo_warp_fwd_first`` (K20 with one
thread a sample searching from global memory),
``vl3d_bilinear_tiles_grad_atomic`` (K9 at C != 4 with its zero fill
and C / vec vector atomics a corner), ``vl3d_swd_sort_l1_first`` (K25
ranking each entry by a scan of its column in shared memory),
``vl3d_geo_warp_bwd_first`` (K21 with 9 global atomics a sample),
``vl3d_compact_sweep_first`` (K13 with one
thread per pixel walking its planes near to far),
``vl3d_nn_band_err_first`` (K19 with one block per (crop, column), each
thread a strided share of the flat (i, k, q) index),
``vl3d_composite_first`` (K4 with one thread
per (pixel, frame), each plane's hit byte, then its sample, decoded per
frame), ``vl3d_bilinear_tiles_grad_first`` (K9 with four scalar atomics a
corner and channel), ``vl3d_fused_s2_fwd_first`` (K14 with one thread per
(pixel, frame), its sample and both neighbours decoded per slot and
frame), ``vl3d_bilinear_tiles_tilemajor_grad_first`` (K10 with four
scalar atomics a corner and channel into a zero-filled buffer),
``vl3d_fused_s2_bwd_first`` (K15 with one thread per
(pixel, frame), whole pixels a block, every sample and neighbour decoded
per frame), ``vl3d_nn_fold_first`` (K12, both modes, with one thread per
output voxel and channel reading each term's index from device memory),
``vl3d_nn_argmin_simt``, ``vl3d_nn_argmin_ssim_first``
and ``vl3d_nn_band_argmin_first`` (K11's "mse" search on f32 or bf16
inputs, its ssim mode and K18 on the first CUDA-core template: 64 x 64
tiles of 4 x 4, one column a block), ``vl3d_sample_dense_grad_scalar``
(K6 with four scalar atomics a corner), ``vl3d_sample_dense_grad_window``
(K6 with shared-memory accumulation, measured slower),
``vl3d_sample_dense_per_channel`` (K5 at any C, one thread per (sample,
channel)), ``vl3d_swd_mask_sort_first`` (K27 with per-pass histograms
and a scatter straight into device memory), and ``vl3d_swd_project_first``
and ``vl3d_swd_project_grad_first`` (K24 and K26 on 64 x 64 tiles of 4 x 4
with one staging buffer, K26's scratch folded w-fastest),
``vl3d_bilinear_planes_tilemajor_first`` (K16 with one thread per
(sample, frame) and C scalar loads a corner) and
``vl3d_bilinear_planes_tilemajor_grad_first`` (K17 with four scalar
atomics a corner into a zero-filled buffer).  ``first_designs.py`` holds
the one caller of each but the two K6 designs.
``vl3d_sample_dense_coord_grad_staged`` runs K22's staged kernel at any
C and texel type, for the comparisons where the wrapper keeps the first
design (C = 4; bf16 texels at C % 4 != 0).  Sixteen layout
functions (``vl3d_sample_dense_coord_grad_layout``,
``vl3d_bilinear_tiles_layout``,
``vl3d_bilinear_tiles_tilemajor_layout``, ``vl3d_fused_s1_fwd_layout``,
``vl3d_fused_s1_bwd_layout``, ``vl3d_swd_mask_l1_layout``,
``vl3d_geo_bwd_layout``, ``vl3d_static_grad_layout``,
``vl3d_compact_layout``,
``vl3d_nn_band_err_layout``,
``vl3d_composite_layout``, ``vl3d_planes_grad_layout``,
``vl3d_tiles_grad_layout``,
``vl3d_fused_s2_fwd_layout``, ``vl3d_fused_s2_bwd_layout``,
``vl3d_nn_fold_layout``) return what a kernel computes on the host, for
the card's checks against their Python mirrors, and ``vl3d_round_bf16``
runs K9's rounding pass on its own for the same checks
(``render/sample.py:round_bf16_``).
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "torch_kernels")
LIB_NAME = "libvl3d_kernels.so"
# no --use_fast_math: K1's tile index must round exactly like the
# plain version, and the lerps/sigmoids stay IEEE
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"warp_lookup": 0, "bilinear_tiles": 0,
            "bilinear_tiles_grad": 0, "bilinear_tiles_tilemajor": 0,
            "composite": 0, "sample_dense": 0, "sample_dense_grad": 0,
            "fused_s1_fwd": 0, "fused_s1_bwd": 0,
            "bilinear_tiles_tilemajor_grad": 0, "nn_argmin": 0, "nn_fold": 0,
            "compact_sweep": 0, "fused_s2_fwd": 0, "fused_s2_bwd": 0,
            "bilinear_planes_tilemajor": 0,
            "bilinear_planes_tilemajor_grad": 0, "nn_band_argmin": 0,
            "nn_band_err": 0, "geo_warp_fwd": 0, "geo_warp_bwd": 0,
            "sample_dense_coord_grad": 0, "bilinear_tiles_coord_grad": 0,
            "tile_lookup_coords": 0, "swd_project": 0, "swd_sort_l1": 0,
            "swd_project_grad": 0, "nn_argmin_ssim": 0, "nn_fold_parent": 0,
            "swd_mask_sort": 0, "swd_mask_l1": 0, "nn_argmin_colmin": 0,
            "nn_argmin_given": 0, "nn_fold_numer": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IA = ctypes.POINTER(ctypes.c_int)
_LA = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "vl3d_warp_lookup": [_P] * 5 + [_I] * 6 + [_F] * 4 + [_P] * 9,
    "vl3d_bilinear_tiles": [_P, _I, _I, _P, _P, _P, _L, _I, _I, _I, _I, _P,
                            _P],
    "vl3d_bilinear_tiles_first": [_P, _I, _I, _P, _P, _P, _L, _I, _I, _I,
                                  _I, _P, _P],
    "vl3d_bilinear_tiles_layout": [_L, _I, _LA],
    "vl3d_bilinear_tiles_grad": [_P, _P, _P, _P, _L] + [_I] * 6
    + [_P, _P, _P],
    "vl3d_bilinear_tiles_grad_atomic": [_P, _P, _P, _P, _L] + [_I] * 6
    + [_P, _P, _P],
    "vl3d_bilinear_tiles_grad_gather": [_P] * 4 + [_I, _L] + [_I] * 6
    + [_P, _L, _P, _P],
    "vl3d_static_grad_layout": [_I, _L] + [_I] * 5 + [_LA],
    "vl3d_round_bf16": [_P, _L, _P, _I, _P],
    "vl3d_bilinear_tiles_grad_first": [_P, _P, _P, _P, _L, _I, _I, _I, _I,
                                       _P, _P],
    "vl3d_bilinear_tiles_tilemajor": [_P, _I, _I] + [_P] * 4 + [_L]
    + [_I] * 6 + [_P] * 2,
    "vl3d_bilinear_tiles_tilemajor_first": [_P, _I, _I] + [_P] * 4 + [_L]
    + [_I] * 6 + [_P] * 2,
    "vl3d_bilinear_tiles_tilemajor_layout": [_L, _I, _I, _LA],
    "vl3d_composite": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _P, _P],
    "vl3d_composite_first": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _P,
                             _P],
    "vl3d_composite_layout": [_I, _I, _LA],
    "vl3d_sample_dense": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _P, _P,
                          _P],
    "vl3d_sample_dense_grad": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _P,
                               _P, _P],
    "vl3d_sample_dense_grad_scalar": [_P] * 4 + [_I, _I, _L, _I, _I]
    + [_P] * 3,
    "vl3d_sample_dense_grad_window": [_P] * 4 + [_I] * 7 + [_P] * 4,
    "vl3d_fused_s1_fwd": [_P] * 4 + [_I] * 5 + [_F] * 7 + [_P] * 8,
    "vl3d_fused_s1_fwd_first": [_P] * 4 + [_I] * 5 + [_F] * 7 + [_P] * 7,
    "vl3d_fused_s1_fwd_layout": [_I, _LA],
    "vl3d_fused_s1_bwd": [_P] * 9 + [_I] * 5 + [_F] * 6 + [_P] * 3,
    "vl3d_fused_s1_bwd_first": [_P] * 9 + [_I] * 5 + [_F] * 6 + [_P] * 3,
    "vl3d_fused_s1_bwd_layout": [_I, _LA],
    "vl3d_bilinear_tiles_tilemajor_grad": [_P] * 4 + [_I, _L] + [_I] * 7
    + [_P, _L, _P, _P],
    "vl3d_bilinear_tiles_tilemajor_grad_first": [_P] * 4 + [_L] + [_I] * 5
    + [_P] * 2,
    "vl3d_tiles_grad_layout": [_I, _L] + [_I] * 6 + [_LA],
    "vl3d_nn_argmin": [_P] * 2 + [_I] * 6 + [_IA, _I, _I, _F, _I, _P, _P],
    "vl3d_nn_argmin_colmin": [_P] * 2 + [_I] * 6 + [_IA, _I, _P, _P],
    "vl3d_nn_argmin_given": [_P] * 2 + [_I] * 6 + [_IA, _F, _P, _I, _P,
                                                    _P],
    "vl3d_nn_fold_numer": [_P] * 2 + [_I] * 5 + [_IA] + [_I] * 4
    + [_P] * 2,
    "vl3d_nn_argmin_simt": [_P] * 2 + [_I] * 6 + [_IA, _I, _F, _I, _P, _P],
    "vl3d_nn_argmin_ssim_first": [_P] * 2 + [_I] * 6
    + [_IA, _I, _F, _I, _P, _P],
    "vl3d_nn_fold": [_P] * 2 + [_I] * 5 + [_IA] + [_I] * 4 + [_P] * 2,
    "vl3d_nn_fold_first": [_P] * 2 + [_I] * 5 + [_IA] + [_I] * 4
    + [_P] * 2,
    "vl3d_nn_fold_layout": [_IA] + [_I] * 5 + [_LA],
    "vl3d_compact_sweep": [_P] * 6 + [_I, _L, _I] + [_P] * 7,
    "vl3d_compact_sweep_first": [_P] * 6 + [_I, _L, _I] + [_P] * 7,
    "vl3d_compact_layout": [_I, _I, _LA],
    "vl3d_fused_s2_fwd": [_P] * 6 + [_I] * 5 + [_F] * 7 + [_P] * 7,
    "vl3d_fused_s2_fwd_first": [_P] * 6 + [_I] * 5 + [_F] * 7 + [_P] * 6,
    "vl3d_fused_s2_fwd_layout": [_I, _I, _LA],
    "vl3d_fused_s2_bwd": [_P] * 10 + [_I] * 5 + [_F] * 6 + [_P] * 3,
    "vl3d_fused_s2_bwd_first": [_P] * 10 + [_I] * 5 + [_F] * 6 + [_P] * 3,
    "vl3d_fused_s2_bwd_layout": [_I, _I, _LA],
    "vl3d_bilinear_planes_tilemajor": [_P, _I, _I, _P, _P, _P, _I, _L]
    + [_I] * 7 + [_P] * 2,
    "vl3d_bilinear_planes_tilemajor_grad": [_P] * 3 + [_I, _L] + [_I] * 6
    + [_P, _L, _P, _P],
    "vl3d_planes_grad_layout": [_I, _L] + [_I] * 5 + [_LA],
    "vl3d_bilinear_planes_tilemajor_first": [_P, _I, _P, _P, _P, _I, _L]
    + [_I] * 5 + [_P] * 2,
    "vl3d_bilinear_planes_tilemajor_grad_first": [_P] * 3 + [_I, _L]
    + [_I] * 4 + [_P] * 2,
    "vl3d_nn_band_argmin": [_P] * 2 + [_I] * 6 + [_IA, _I, _I, _F, _I]
    + [_P] * 3,
    "vl3d_nn_tile_smem": [_IA, _I, _I],
    "vl3d_nn_band_argmin_first": [_P] * 2 + [_I] * 6
    + [_IA, _I, _I, _F, _I] + [_P] * 3,
    "vl3d_nn_band_err": [_P] * 2 + [_I] * 6 + [_IA] + [_I] * 4
    + [_P] * 4,
    "vl3d_nn_band_err_first": [_P] * 2 + [_I] * 6 + [_IA, _I] + [_P] * 4,
    "vl3d_nn_band_err_layout": [_I] * 11 + [_LA],
    "vl3d_partial_rows": [_L],
    "vl3d_geo_warp_fwd": [_P] * 7 + [_I] * 6 + [_F] * 2 + [_P] * 7,
    "vl3d_geo_warp_fwd_first": [_P] * 7 + [_I] * 6 + [_F] * 2 + [_P] * 6,
    "vl3d_geo_warp_bwd": [_P] * 11 + [_I] * 6 + [_P] * 6,
    "vl3d_geo_warp_bwd_first": [_P] * 11 + [_I] * 6 + [_P] * 4,
    "vl3d_geo_bwd_layout": [_I] * 6 + [_LA],
    "vl3d_sample_dense_coord_grad": [_P, _P, _I] + [_P] * 4
    + [_I, _I, _L, _I, _I, _I] + [_P] * 3,
    "vl3d_sample_dense_coord_grad_first": [_P, _P, _I] + [_P] * 4
    + [_I, _I, _L, _I, _I, _I] + [_P] * 3,
    "vl3d_sample_dense_coord_grad_staged": [_P, _P, _I] + [_P] * 4
    + [_I, _I, _L, _I, _I, _I] + [_P] * 3,
    "vl3d_sample_dense_coord_grad_layout": [_L] + [_I] * 4 + [_LA],
    "vl3d_bilinear_tiles_coord_grad": [_P, _I] + [_P] * 4 + [_L] + [_I] * 4
    + [_P] * 3,
    "vl3d_bilinear_tiles_coord_grad_first": [_P, _I] + [_P] * 4 + [_L]
    + [_I] * 4 + [_P] * 3,
    "vl3d_tile_lookup_coords": [_P] * 5 + [_I, _I, _L, _I, _I, _F, _F]
    + [_P] * 5,
    "vl3d_swd_project": [_P] * 2 + [_I] * 9 + [_P] * 2,
    "vl3d_swd_sort_l1": [_P, _P, _L, _I, _I, _I] + [_P] * 4 + [_F]
    + [_P] * 4,
    "vl3d_swd_sort_l1_first": [_P, _P, _L, _I, _I, _I, _P, _P, _F]
    + [_P] * 4,
    "vl3d_swd_project_grad": [_P] * 2 + [_I] * 9 + [_P] * 3,
    "vl3d_swd_project_grad_scratch": [_I] * 8,
    "vl3d_swd_project_first": [_P] * 2 + [_I] * 9 + [_P] * 2,
    "vl3d_swd_project_grad_first": [_P] * 2 + [_I] * 9 + [_P] * 3,
    "vl3d_swd_mask_sort": [_P, _L, _P, _I, _L] + [_P] * 6,
    "vl3d_swd_mask_sort_scratch": [_I, _L],
    "vl3d_swd_mask_sort_first": [_P, _L, _P, _I, _L] + [_P] * 6,
    "vl3d_sample_dense_per_channel": [_P, _P, _P, _P, _I, _I, _L, _I, _I,
                                      _I, _P, _P, _P],
    "vl3d_swd_mask_l1": [_P] * 3 + [_I, _L, _L, _I, _I, _L, _L, _P, _F, _F]
    + [_P] * 5,
    "vl3d_swd_mask_l1_first": [_P] * 3
    + [_I, _L, _L, _I, _I, _L, _L, _P, _F, _F] + [_P] * 5,
    "vl3d_swd_mask_l1_layout": [_I, _L, _LA],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(paths):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build():
    """Compile ``csrc/*.cu`` into the shared library if its stamp is stale.
    Returns (library path, ptxas report text).  A file lock in the build
    directory makes processes that start together (the ranks of one job)
    build once and the others wait for it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked()


def _build_locked():
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    digest = _digest(sources + headers)
    lib = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = lib + ".sha256"
    report = os.path.join(BUILD_DIR, "ptxas.txt")
    if os.path.isfile(lib) and os.path.isfile(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                with open(report) as r:
                    return lib, r.read()
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = os.path.join(BUILD_DIR,
                           os.path.basename(src).replace(".cu", ".o"))
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, err = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}{err}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(logs))
    tmp = lib + ".tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
         *[obj for _, obj, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + link.stdout + link.stderr)
    os.replace(tmp, lib)
    text = "\n".join(logs)
    with open(report, "w") as f:
        f.write(text)
    with open(stamp, "w") as f:
        f.write(digest)
    return lib, text


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vl3d_swd_mask_sort_scratch.restype = ctypes.c_longlong
    lib.vl3d_swd_project_grad_scratch.restype = ctypes.c_longlong
    return lib


def stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream


def partial_rows(n):
    """Rows of the per-block partials scratch that K7 and K14 fill for a
    launch over n elements (the library's block size decides)."""
    return library().vl3d_partial_rows(n)


def check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_tensor(name, t, device, dtype=None, shape=None):
    """Raise unless t is a contiguous tensor on `device` with the given
    dtype (or one of a tuple of dtypes) and shape, that requires no
    gradient.  (The `torch.autograd.Function`s of the stage-1 kernels
    pass detached tensors.)"""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if dtype is not None and t.dtype not in allowed:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.requires_grad:
        raise RuntimeError(f"{name}: forward-only kernel; the tensor "
                           "requires grad")
