"""Checkpoint schemas: dense stage-1, sparse stage-1, stage-2 video.

Counterpart of ``videoloop3d_tpu/models/checkpoint.py`` with the same
on-disk format: one ``.npz`` holding ``param/<name>`` arrays, the tile
maps, and a ``__meta__`` JSON blob (geometry, phase flags, tile layout,
training progress).  A checkpoint written by either package loads in the
other, with one exception: the NeX / MLP decoders' nested weight dict
``params["decoder"]``.  The JAX package writes it as a pickled 0-d object
array (``param/decoder``), which ``np.load`` then refuses to read (no
pickles), so its ``nex_rgb`` / ``mlp_alpha`` checkpoints do not load in
either package.  The port writes each decoder leaf as a plain array,
``param/decoder/l0/w`` and so on, and reads them back into the nested
dict (`flat_params`, `nest_params`).  `params_from_numpy` turns the
numpy parameters (and tile maps) into the port's device tensors.
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


def flat_params(params):
    """{name: array or tensor}, the nested decoder dict flattened to
    ``decoder/<layer>/<w|b>`` names (sorted within it)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for sub, leaf in flat_params(v).items():
                out[f"{k}/{sub}"] = leaf
        else:
            out[k] = v
    return out


def nest_params(flat):
    """The inverse of `flat_params`: names with '/' become nested dicts."""
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def save_checkpoint(path, *, geom, params, stage, is_sparse=False,
                    has_dyn=False, tile_map_static=None, tile_map_dyn=None,
                    tile_hw=None, frm_num=None, extra_meta=None):
    """params: dict of numpy arrays or tensors (the decoder's nested dict
    written leaf by leaf, `flat_params`).  Written atomically (temp file +
    rename)."""
    params = flat_params(params)
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
    """Returns {"meta", "params" (numpy; a decoder nested again),
    "geom", "tile_map_static", "tile_map_dyn"}."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        params = nest_params({k: z[f"param/{k}"]
                              for k in meta["param_keys"]})
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
    "atlas_dyn": (D,Ht,Wt,F,4), "verts": (n,3)}``; C channels in place of
    4 for the other decoders, and the NeX / MLP weights as the nested
    ``"decoder": {"l0": {"w", "b"}, "l1": {...}}``) -> contiguous tensors
    on ``device``, every key carried across, nested dicts as nested
    dicts: floating arrays as ``dtype``, integer arrays (the tile maps)
    as int32."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(u) for k, u in v.items()}
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.require(v, requirements=["C", "W"])
        kind = torch.int32 if np.issubdtype(v.dtype, np.integer) else dtype
        return torch.from_numpy(v).to(device=device, dtype=kind)
    return {k: conv(v) for k, v in params.items()}
