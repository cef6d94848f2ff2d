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
``losses/patch_nn.py:nn_band_argmin`` K18 and ``nn_band_err`` K19) adds
one to its entry of `LAUNCHES` where it launches its kernel, and nowhere
else.
"""
from __future__ import annotations

import ctypes
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
            "nn_band_err": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IA = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "vl3d_warp_lookup": [_P] * 5 + [_I] * 6 + [_F] * 4 + [_P] * 9,
    "vl3d_bilinear_tiles": [_P, _I, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P],
    "vl3d_bilinear_tiles_grad": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P],
    "vl3d_bilinear_tiles_tilemajor": [_P, _I, _P, _P, _P, _P, _L, _I, _I,
                                      _I, _I, _I, _I, _P, _P],
    "vl3d_composite": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _P, _P],
    "vl3d_sample_dense": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _P, _P, _P],
    "vl3d_sample_dense_grad": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _P, _P,
                               _P],
    "vl3d_fused_s1_fwd": [_P] * 4 + [_I] * 5 + [_F] * 7 + [_P] * 7,
    "vl3d_fused_s1_bwd": [_P] * 9 + [_I] * 5 + [_F] * 6 + [_P] * 3,
    "vl3d_bilinear_tiles_tilemajor_grad": [_P] * 4 + [_L] + [_I] * 5
    + [_P] * 2,
    "vl3d_nn_argmin": [_P] * 2 + [_I] * 6 + [_IA, _I, _F, _I, _P, _P],
    "vl3d_nn_fold": [_P] * 2 + [_I] * 5 + [_IA] + [_I] * 3 + [_P] * 2,
    "vl3d_compact_sweep": [_P] * 6 + [_I, _L, _I] + [_P] * 7,
    "vl3d_fused_s2_fwd": [_P] * 6 + [_I] * 5 + [_F] * 7 + [_P] * 6,
    "vl3d_fused_s2_bwd": [_P] * 10 + [_I] * 5 + [_F] * 6 + [_P] * 3,
    "vl3d_bilinear_planes_tilemajor": [_P, _I, _P, _P, _P, _I, _L]
    + [_I] * 5 + [_P] * 2,
    "vl3d_bilinear_planes_tilemajor_grad": [_P] * 3 + [_I, _L] + [_I] * 4
    + [_P] * 2,
    "vl3d_nn_band_argmin": [_P] * 2 + [_I] * 6 + [_IA, _I, _I, _F, _I]
    + [_P] * 3,
    "vl3d_nn_band_err": [_P] * 2 + [_I] * 6 + [_IA, _I] + [_P] * 4,
    "vl3d_partial_rows": [_L],
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
    Returns (library path, ptxas report text)."""
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
    os.makedirs(BUILD_DIR, exist_ok=True)
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
