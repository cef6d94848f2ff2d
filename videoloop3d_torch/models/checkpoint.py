"""Checkpoint schemas: dense stage-1, sparse stage-1, stage-2 video.

Counterpart of ``videoloop3d_tpu/models/checkpoint.py`` with the same
on-disk format: one ``.npz`` holding ``param/<name>`` arrays, the tile
maps, and a ``__meta__`` JSON blob (geometry, phase flags, tile layout,
training progress).  A checkpoint written by either package loads in the
other.  `params_from_numpy` turns the numpy parameters (and tile maps)
into the port's device tensors.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from videoloop3d_torch.models.geometry import MPIGeometry

SCHEMA_VERSION = 1


def geom_from_meta(meta) -> MPIGeometry:
    m = dict(meta)
    m["depths"] = tuple(m["depths"])
    m["ref_intrin_mpi"] = tuple(tuple(r) for r in m["ref_intrin_mpi"])
    m["ref_extrin"] = tuple(tuple(r) for r in m["ref_extrin"])
    return MPIGeometry(**m)


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path, *, geom, params, stage, is_sparse=False,
                    has_dyn=False, tile_map_static=None, tile_map_dyn=None,
                    tile_hw=None, frm_num=None, extra_meta=None):
    """params: dict of numpy arrays or tensors.  Written atomically (temp
    file + rename)."""
    meta = {
        "schema": SCHEMA_VERSION,
        "stage": stage,                      # 'mpi' | 'mpv'
        "is_sparse": bool(is_sparse),
        "has_dyn": bool(has_dyn),
        "tile_hw": list(tile_hw) if tile_hw else None,
        "frm_num": frm_num,
        "geometry": dataclasses.asdict(geom),
        "extra": extra_meta or {},
        "param_keys": sorted(params.keys()),
    }
    arrays = {f"param/{k}": _to_numpy(v) for k, v in params.items()}
    if tile_map_static is not None:
        arrays["tile_map_static"] = _to_numpy(tile_map_static)
    if tile_map_dyn is not None:
        arrays["tile_map_dyn"] = _to_numpy(tile_map_dyn)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path):
    """Returns {"meta", "params" (numpy), "geom", "tile_map_static",
    "tile_map_dyn"}."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        params = {k: z[f"param/{k}"] for k in meta["param_keys"]}
        out = {"meta": meta, "params": params,
               "geom": geom_from_meta(meta["geometry"])}
        for k in ("tile_map_static", "tile_map_dyn"):
            out[k] = z[k] if k in z.files else None
    return out


def load_checkpoint_meta(path):
    """Only the ``__meta__`` blob of a checkpoint (no arrays are read)."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def latest_checkpoint(dirpath, suffix=".npz"):
    """Newest (lexicographically last) checkpoint in a run directory."""
    if not os.path.isdir(dirpath):
        return None
    cands = sorted(f for f in os.listdir(dirpath)
                   if f.endswith(suffix) and "ckpt" in f)
    return os.path.join(dirpath, cands[-1]) if cands else None


def params_from_numpy(params, device, dtype=torch.float32):
    """Numpy parameters (the JAX package's layout: dense stage 1
    ``{"atlas": (D,Ht,Wt,4), "atlas_mask": (D,Ht,Wt,1), "verts": (n,3)}``,
    sparse stage 1 ``{"atlas": (Ns,th,tw,4), "atlas_dyn": (Nd,th,tw,4),
    "verts"}``, sparse mpv ``{"atlas": (Ns,th,tw,4), "atlas_dyn":
    (Nd,th,tw,F,4)}``, dense mpv (a scratch start or a dense stage-1
    checkpoint: the whole scene is the frame-stacked dynamic atlas, the
    static atlas is empty, there are no tile maps) ``{"atlas": (0,1,1,4),
    "atlas_dyn": (D,Ht,Wt,F,4), "verts": (n,3)}``) -> contiguous tensors
    on ``device``, every key carried across: floating arrays as
    ``dtype``, integer arrays (the tile maps) as int32."""
    def conv(v):
        v = np.require(v, requirements=["C", "W"])
        kind = torch.int32 if np.issubdtype(v.dtype, np.integer) else dtype
        return torch.from_numpy(v).to(device=device, dtype=kind)
    return {k: conv(v) for k, v in params.items()}
