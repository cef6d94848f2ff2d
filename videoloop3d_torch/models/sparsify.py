"""Tile culling: the sparsification of a dense stage-1 MPI into packed
static and dynamic tile atlases (counterpart of
``videoloop3d_tpu/models/sparsify.py``, ref MPI.py:289-442
`sparsify_faces`).

Kept tiles live in packed (N, tile_h, tile_w, C) arrays addressed by
per-plane int32 tile maps (-1 = culled).  The culling decision and the
tile resample are host-side numpy, as in the JAX package: culling runs
once between the training phases, and the same float arithmetic keeps
every decision equal to the JAX package's.
"""
from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi
import torch

from videoloop3d_torch.core.activations import ALPHA_INIT_VAL
from videoloop3d_torch.models.geometry import MPIGeometry


def _np_bilinear_planes(tex, x, y):
    """tex (D, Ht, Wt, C); x, y (D, ...) -> (D, ..., C), clamped
    borders (float64 weights, f32 accumulator)."""
    D, Ht, Wt, C = tex.shape
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    out = np.zeros(x.shape + (C,), np.float32)
    didx = np.arange(D).reshape((D,) + (1,) * (x.ndim - 1))
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi = np.clip(x0 + dx, 0, Wt - 1)
            yi = np.clip(y0 + dy, 0, Ht - 1)
            out += tex[didx, yi, xi] * wx * wy
    return out


def extract_tiles(atlas, geom: MPIGeometry, tile_hw=None):
    """Resample every tile of every plane into a packed tile array.

    atlas: (D, Ht, Wt, C) numpy.  Returns (tiles (D*nth*ntw, th, tw, C)
    f32, tile_map (D, nth, ntw) int32 holding 0..N-1).
    """
    atlas = np.asarray(atlas)
    D = geom.n_planes
    nth, ntw = geom.n_tiles_h, geom.n_tiles_w
    th, tw = tile_hw or geom.default_tile_texels()
    sy, sx = geom.tile_span
    ii, jj = np.meshgrid(np.arange(nth), np.arange(ntw), indexing="ij")
    aa, bb = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    # plane texel coordinates of each tile sample: (nth, ntw, th, tw)
    y = (ii[..., None, None] + aa[None, None] / (th - 1)) * sy
    x = (jj[..., None, None] + bb[None, None] / (tw - 1)) * sx
    y = np.broadcast_to(y[None], (D,) + y.shape)
    x = np.broadcast_to(x[None], (D,) + x.shape)
    tiles = _np_bilinear_planes(atlas, x, y)      # (D, nth, ntw, th, tw, C)
    tiles = tiles.reshape(D * nth * ntw, th, tw, atlas.shape[-1])
    tile_map = np.arange(D * nth * ntw, dtype=np.int32).reshape(D, nth, ntw)
    return tiles.astype(np.float32), tile_map


def _erode(x):
    """3x3 min filter with zero padding (ref utils.py:309-317)."""
    return ndi.minimum_filter(x, size=(1, 3, 3), mode="constant", cval=0.0)


def _dilate(x):
    return ndi.maximum_filter(x, size=(1, 3, 3), mode="constant", cval=0.0)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _host(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def tile_cull(params, geom: MPIGeometry, alpha_activate, erode_num=2,
              alpha_thresh=0.03, loop_thresh=0.5, rm_first_layers=0,
              tile_hw=None):
    """The tile-culling decision and the packed tiles.

    params: 'atlas' (D, Ht, Wt, C) and optionally 'atlas_mask'
    (D, Ht, Wt, 1), tensors or numpy.  alpha_activate: the model's alpha
    activation (tensor -> tensor).  rm_first_layers drops every tile of
    the N NEAREST planes (storage is far-first, so the slice is taken
    from the end; ref MPI.py:345-348).

    Returns {static_tiles (Ns, th, tw, C), dyn_tiles (Nd, th, tw, C),
    tile_map_static / tile_map_dyn (D, nth, ntw) int32 (-1 = culled),
    tile_hw, keep_frac, dyn_frac}, all on the host.
    """
    atlas = _host(params["atlas"]).astype(np.float32, copy=False)
    D = geom.n_planes
    nth, ntw = geom.n_tiles_h, geom.n_tiles_w

    # opacity; texels training never touched keep their exact init value
    # and are forced transparent (ref MPI.py:322 sets them to -10).  The
    # raw alpha is the LAST channel for every decoder, as in the JAX
    # package (models/sparsify.py:106), though nex_rgb / mlp_alpha decode
    # alpha from channel 0 and rgba_sh's last channel is alpha's last SH
    # coefficient
    raw_alpha = atlas[..., -1].copy()
    raw_alpha[raw_alpha == ALPHA_INIT_VAL] = -10.0
    alpha = alpha_activate(torch.from_numpy(raw_alpha)).numpy()

    if params.get("atlas_mask") is not None:
        raw_loop = _host(params["atlas_mask"]).astype(np.float32)[..., 0]
        raw_loop = raw_loop.copy()
        raw_loop[raw_loop == ALPHA_INIT_VAL] = -10.0
        loop = _sigmoid(raw_loop)
    else:
        loop = np.zeros_like(alpha)

    for _ in range(erode_num):
        loop = _erode(loop)
    for _ in range(erode_num):
        loop = _dilate(loop)
    for _ in range(erode_num):
        alpha = _erode(alpha)
    for _ in range(erode_num + 2):
        alpha = _dilate(alpha)

    sy, sx = geom.tile_span

    def tile_max(field):
        """Per-tile max over the tile's texel rectangle."""
        out = np.zeros((D, nth, ntw), np.float32)
        for i in range(nth):
            y0, y1 = int(np.floor(i * sy)), int(np.ceil((i + 1) * sy)) + 1
            for j in range(ntw):
                x0, x1 = int(np.floor(j * sx)), int(np.ceil((j + 1) * sx)) + 1
                out[:, i, j] = field[:, y0:y1, x0:x1].max(axis=(1, 2))
        return out

    keep = tile_max(alpha) > alpha_thresh
    if rm_first_layers > 0:
        keep[D - rm_first_layers:] = False
    is_dyn = (tile_max(loop) > loop_thresh) & keep
    is_static = keep & ~is_dyn

    tiles, _ = extract_tiles(atlas, geom, tile_hw)
    flat_static = is_static.reshape(-1)
    flat_dyn = is_dyn.reshape(-1)
    tile_map_static = np.full(D * nth * ntw, -1, np.int32)
    tile_map_static[flat_static] = np.arange(flat_static.sum())
    tile_map_dyn = np.full(D * nth * ntw, -1, np.int32)
    tile_map_dyn[flat_dyn] = np.arange(flat_dyn.sum())
    n_total = D * nth * ntw
    return {
        "static_tiles": tiles[flat_static],
        "dyn_tiles": tiles[flat_dyn],
        "tile_map_static": tile_map_static.reshape(D, nth, ntw),
        "tile_map_dyn": tile_map_dyn.reshape(D, nth, ntw),
        "tile_hw": tuple(tiles.shape[1:3]),
        "keep_frac": float(keep.sum()) / n_total,
        "dyn_frac": float(is_dyn.sum()) / max(int(keep.sum()), 1),
    }


def apply_tile_cull(model, params, alpha_activate, erode_num=2,
                    alpha_thresh=0.03, loop_thresh=0.5, rm_first_layers=0,
                    tile_hw=None):
    """Turn an MPMesh into its sparse phase.  Sets the model's tile maps
    (int32 tensors on model.device) and returns (new params on
    model.device, the tile_cull result).  The loop mask is consumed by
    the decision and dropped (ref MPI.py:441-442); verts and the NeX / MLP
    decoder weights are kept (the JAX package drops the decoder here, so
    its sparse phase of those decoders has no weights to decode with)."""
    result = tile_cull(params, model.geom, alpha_activate, erode_num,
                       alpha_thresh, loop_thresh, rm_first_layers, tile_hw)
    model.set_sparse(result["tile_map_static"], result["tile_map_dyn"],
                     result["tile_hw"])
    dev = model.device
    new_params = {
        "atlas": torch.from_numpy(result["static_tiles"]).to(dev),
        "atlas_dyn": torch.from_numpy(result["dyn_tiles"]).to(dev),
    }
    if "verts" in params:
        new_params["verts"] = params["verts"].detach()
    if "decoder" in params:
        new_params["decoder"] = {
            layer: {k: t.detach() for k, t in leaves.items()}
            for layer, leaves in params["decoder"].items()}
    return new_params, result
