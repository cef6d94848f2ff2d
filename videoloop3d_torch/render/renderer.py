"""Plane-sweep renderer (counterpart of ``videoloop3d_tpu/render/renderer.py``).

1. per-(view, plane) inverse homographies (``core/planes.py``),
2. warp the target pixel grid into plane texel coordinates and look up
   the packed static and dynamic tile of every sample — kernel K1
   `warp_lookup` (``csrc/warp_lookup.cu``), whose plain version is
   `warp_coordinates` + `tile_lookup2`; under ``--optimize_geo_start``
   the warp goes through the vertex grids (``render/geo_warp.py``) and
   K1's coordinate entry `tile_lookup_coords` looks the warped samples up,
3. gather texels: packed tiles (``render/sample.py``, kernels K2 and K3;
   differentiable in the static-layout tiles through K9) or, in the
   dense stage-1 phase, whole plane textures (`sample_dense`, kernels
   K5/K6), or, in the dense stage-2 phase, frame-stacked plane textures
   (``render/sample.py:sample_planes_tilemajor``, kernels K16/K17); with
   ``--add_uv_noise`` a training render jitters the sample positions
   first (`add_texel_noise`; inside K1 on the sparse routes),
4. decode and over-composite (``render/fused.py``, kernel K4; stage-1
   training: `composite_planes` under autograd, or
   ``render/fused_s1.py``, kernels K7/K8).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from videoloop3d_torch import kernels
from videoloop3d_torch.core import planes as plane_math
from videoloop3d_torch.core.activations import clip
from videoloop3d_torch.models.geometry import MPIGeometry
from videoloop3d_torch.render import sample as S


class WarpCoords(NamedTuple):
    """Per-(view, plane, pixel) warp results; shapes (B, D, H, W)."""
    x: torch.Tensor
    y: torch.Tensor
    zview: torch.Tensor
    valid: torch.Tensor     # in front of camera AND inside the plane rect


def homographies(geom: MPIGeometry, extrins, intrins):
    """(B, D, 3, 3) plane homographies of `geom` for target views whose
    extrinsics are RELATIVE to the reference camera."""
    return plane_math.plane_homographies(
        geom.depths_np(), geom.ref_intrin_mpi_np(), extrins, intrins)


def _coords_from_G(G, h, w, mpi_h, mpi_w):
    x, y, zview = plane_math.warp_grid(G, h, w)
    inside = (x >= 0) & (x <= mpi_w - 1) & (y >= 0) & (y <= mpi_h - 1)
    valid = inside & (zview > 1e-6)
    return WarpCoords(x, y, zview, valid)


def warp_coordinates(geom: MPIGeometry, extrins, intrins, h, w) -> WarpCoords:
    """Steps 1-2 of the sweep (plain). extrins are RELATIVE to the ref
    camera."""
    G = homographies(geom, extrins, intrins)
    return _coords_from_G(G, h, w, geom.mpi_h, geom.mpi_w)


def add_texel_noise(coords: WarpCoords, nx, ny) -> WarpCoords:
    """The +-1-texel jitter of the sample positions (``--add_uv_noise``,
    ref MPI.py:519-523; JAX ``render/renderer.py:48-54``) with the draws
    nx, ny given (the JAX package draws them from its key): x + nx, y + ny;
    valid, the un-jittered sample's, is kept."""
    return coords._replace(x=coords.x + nx, y=coords.y + ny)


def texel_noise(gen, shape):
    """The (nx, ny) draws of `add_texel_noise`: uniform in [-1, 1) from the
    torch.Generator gen, on its device (JAX's ``jax.random.uniform`` draws
    from another stream)."""
    return tuple(torch.rand(shape, generator=gen, device=gen.device)
                 * 2.0 - 1.0 for _ in range(2))


def _span(tile_span, device):
    """(sy, sx) as f32 tensors on `device` (a division by a tensor rounds
    like K1's division; one by a Python scalar may not)."""
    return tuple(torch.tensor(s, dtype=torch.float32, device=device)
                 for s in tile_span)


def _tiles_of(tile_span, tile_map_a, tile_map_b, x, y, valid):
    """Tile (i, j) (int32, clipped to the grid) of every sample and the two
    maps' entries there (-1 where the sample is invalid)."""
    sy, sx = _span(tile_span, x.device)
    D, nth, ntw = tile_map_a.shape
    j = torch.floor(x / sx).to(torch.int32).clamp(0, ntw - 1)
    i = torch.floor(y / sy).to(torch.int32).clamp(0, nth - 1)
    cell = (torch.arange(D, device=j.device)[:, None, None] * (nth * ntw)
            + i.long() * ntw + j.long())                  # (B, D, H, W)
    minus = torch.full((), -1, dtype=torch.int32, device=j.device)
    k_a = torch.where(valid, tile_map_a.reshape(-1)[cell], minus)
    k_b = torch.where(valid, tile_map_b.reshape(-1)[cell], minus)
    return k_a, k_b, i, j


def tile_fractions(x, y, i, j, tile_span):
    """In-tile fractions fu = (x - j sx) / sx, fv = (y - i sy) / sy of the
    samples (x, y) in tiles (i, j), rounded as K1 rounds them;
    differentiable in x and y."""
    sy, sx = _span(tile_span, x.device)
    return (x - j.to(torch.float32) * sx) / sx, \
        (y - i.to(torch.float32) * sy) / sy


def _lookup(tile_span, tile_map_a, tile_map_b, coords: WarpCoords):
    k_a, k_b, i, j = _tiles_of(tile_span, tile_map_a, tile_map_b, coords.x,
                               coords.y, coords.valid)
    fu, fv = tile_fractions(coords.x, coords.y, i, j, tile_span)
    return k_a, k_b, fu, fv


def tile_lookup2(geom: MPIGeometry, tile_map_a, tile_map_b,
                 coords: WarpCoords):
    """Packed static and dynamic tile index (-1 = culled or invalid) and
    in-tile fractions (fu, fv) of every sample (plain).  Tile maps are
    (D, n_tiles_h, n_tiles_w) int32 tensors."""
    return _lookup(geom.tile_span, tile_map_a, tile_map_b, coords)


def tile_lookup2_blocked(geom: MPIGeometry, tile_map_a, tile_map_b,
                         coords: WarpCoords, spans):
    """The training lookup of the JAX package (per-scanline tile-map
    blocks selected by one-hot contractions, planned by a (Ti, J) span
    bound).  It returns `tile_lookup2`'s values whenever its bound holds,
    and K1 reads the tile map directly, so here it is `tile_lookup2` and
    `spans` plans nothing."""
    del spans
    return tile_lookup2(geom, tile_map_a, tile_map_b, coords)


def warp_lookup_plain(G, tile_map_s, tile_map_d, h, w, mpi_hw, tile_span,
                      nx=None, ny=None):
    """Plain version of K1: `warp_coordinates` (+ `add_texel_noise`) +
    `tile_lookup2` from G."""
    coords = _coords_from_G(G, h, w, *mpi_hw)
    if nx is not None:
        coords = add_texel_noise(coords, nx, ny)
    return (coords,) + _lookup(tile_span, tile_map_s, tile_map_d, coords)


def warp_lookup(G, tile_map_s, tile_map_d, h, w, mpi_hw, tile_span,
                nx=None, ny=None):
    """K1: warp the (h, w) pixel grid through G (B, D, 3, 3) f32 and look
    up both (D, nth, ntw) int32 tile maps.  mpi_hw = (mpi_h, mpi_w) of the
    plane texture; tile_span = (sy, sx) floats, used as f32.  With the
    (B, D, h, w) f32 uv-noise draws nx, ny (`texel_noise`) the lookup
    reads the jittered sample (`add_texel_noise`: valid stays the
    un-jittered one's).

    Returns (WarpCoords(x, y, zview, valid), k_s, k_d, fu, fv), each
    (B, D, h, w): f32 (x, y jittered), bool, int32 (-1 where culled or
    invalid), f32.
    """
    dev = G.device
    kernels.check_tensor("warp_lookup.G", G, dev, dtype=torch.float32)
    if G.dim() != 4 or G.shape[2:] != (3, 3):
        raise ValueError(f"warp_lookup.G: shape {tuple(G.shape)}, expected "
                         "(B, D, 3, 3)")
    B, D = G.shape[:2]
    kernels.check_tensor("warp_lookup.tile_map_s", tile_map_s, dev,
                         dtype=torch.int32)
    nth, ntw = tile_map_s.shape[1:]
    kernels.check_tensor("warp_lookup.tile_map_d", tile_map_d, dev,
                         dtype=torch.int32, shape=(D, nth, ntw))
    if tile_map_s.shape[0] != D:
        raise ValueError(f"warp_lookup: {tile_map_s.shape[0]} tile-map "
                         f"planes for {D} homographies")
    shape = (B, D, h, w)
    if (nx is None) != (ny is None):
        raise ValueError("warp_lookup: pass both uv-noise draws or neither")
    if nx is not None:
        kernels.check_tensor("warp_lookup.nx", nx, dev, dtype=torch.float32,
                             shape=shape)
        kernels.check_tensor("warp_lookup.ny", ny, dev, dtype=torch.float32,
                             shape=shape)
    if dev.type == "cpu":
        return warp_lookup_plain(G, tile_map_s, tile_map_d, h, w, mpi_hw,
                                 tile_span, nx, ny)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    x, y, zview = (torch.empty(shape, **f32) for _ in range(3))
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    k_s, k_d = torch.empty(shape, **i32), torch.empty(shape, **i32)
    fu, fv = torch.empty(shape, **f32), torch.empty(shape, **f32)
    mpi_h, mpi_w = mpi_hw
    sy, sx = tile_span
    err = kernels.library().vl3d_warp_lookup(
        G.data_ptr(), tile_map_s.data_ptr(), tile_map_d.data_ptr(),
        None if nx is None else nx.data_ptr(),
        None if ny is None else ny.data_ptr(), B, D, h, w, nth, ntw,
        float(mpi_w - 1), float(mpi_h - 1), sy, sx,
        x.data_ptr(), y.data_ptr(), zview.data_ptr(), valid.data_ptr(),
        k_s.data_ptr(), k_d.data_ptr(), fu.data_ptr(), fv.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.LAUNCHES["warp_lookup"] += 1
    kernels.check_launch("warp_lookup", err)
    return WarpCoords(x, y, zview, valid), k_s, k_d, fu, fv


def tile_lookup_coords_plain(x, y, valid, tile_map_s, tile_map_d,
                             tile_span):
    """Plain version of K1's coordinate entry: `tile_lookup2` on given
    coordinates.  Returns (k_s, k_d, i, j) int32."""
    return _tiles_of(tile_span, tile_map_s, tile_map_d, x, y, valid)


def tile_lookup_coords(x, y, valid, tile_map_s, tile_map_d, tile_span):
    """K1's coordinate entry (the vertex warp's sparse route): look up both
    (D, nth, ntw) int32 tile maps at the given (B, D, h, w) f32 sample
    coordinates x, y (jittered under uv noise) with validity valid (bool,
    the un-jittered sample's).  tile_span = (sy, sx), used as f32.
    Returns (k_s, k_d, i, j), each (B, D, h, w) int32: the packed tile
    indices (-1 where culled or invalid) and the tile; `tile_fractions`
    gives the differentiable in-tile fractions."""
    dev = x.device
    kernels.check_tensor("tile_lookup_coords.x", x, dev, dtype=torch.float32)
    if x.dim() != 4:
        raise ValueError(f"tile_lookup_coords.x: shape {tuple(x.shape)}, "
                         "expected (B, D, h, w)")
    B, D, h, w = x.shape
    kernels.check_tensor("tile_lookup_coords.y", y, dev, dtype=torch.float32,
                         shape=x.shape)
    kernels.check_tensor("tile_lookup_coords.valid", valid, dev,
                         dtype=torch.bool, shape=x.shape)
    kernels.check_tensor("tile_lookup_coords.tile_map_s", tile_map_s, dev,
                         dtype=torch.int32)
    nth, ntw = tile_map_s.shape[1:]
    kernels.check_tensor("tile_lookup_coords.tile_map_d", tile_map_d, dev,
                         dtype=torch.int32, shape=(D, nth, ntw))
    if tile_map_s.shape[0] != D:
        raise ValueError(f"tile_lookup_coords: {tile_map_s.shape[0]} "
                         f"tile-map planes for {D} coordinate planes")
    if dev.type == "cpu":
        return tile_lookup_coords_plain(x, y, valid, tile_map_s, tile_map_d,
                                        tile_span)
    k_s, k_d, i, j = (torch.empty(x.shape, dtype=torch.int32, device=dev)
                      for _ in range(4))
    sy, sx = tile_span
    err = kernels.library().vl3d_tile_lookup_coords(
        x.data_ptr(), y.data_ptr(), valid.data_ptr(), tile_map_s.data_ptr(),
        tile_map_d.data_ptr(), B, D, h * w, nth, ntw, sy, sx, k_s.data_ptr(),
        k_d.data_ptr(), i.data_ptr(), j.data_ptr(), kernels.stream_ptr(dev))
    kernels.LAUNCHES["tile_lookup_coords"] += 1
    kernels.check_launch("tile_lookup_coords", err)
    return k_s, k_d, i, j


def sample_sparse(tiles, k, fu, fv, gather_dtype=None):
    """Gather packed tiles at in-tile fractions: K2/K9 on (N, th, tw, C)
    static tiles, K3/K10 on (N, th, tw, F, C) tile-major tiles (all
    frames; read at gather_dtype, None: their own), differentiable in the
    tiles (``sample.sample_tiles``).  k, fu, fv (...) from the lookup or
    the compaction.  Returns ((..., [F,] C) values, (...) hit mask)."""
    th, tw = tiles.shape[1], tiles.shape[2]
    return S.sample_tiles(tiles, k, fu * (tw - 1), fv * (th - 1),
                          gather_dtype)


def sample_dense(atlas, atlas_mask, coords: WarpCoords):
    """Gather the dense plane textures at the warp coordinates (K5/K6).
    atlas (D, Ht, Wt, C), atlas_mask (D, Ht, Wt, 1) or None.  Returns raw
    features (B, D, H, W, C) and mask features (B, D, H, W, 1) or None,
    zero outside the plane; activation is applied by the model."""
    return S.sample_dense(atlas, atlas_mask, coords.x.contiguous(),
                          coords.y.contiguous())


def composite_planes(alpha, content):
    """Composite over the plane axis (axis 1), planes stored FAR -> NEAR,
    with a reverse cumulative-product transmittance (the JAX package's
    unfused chain).  alpha (B, D, H, W); content (B, D, H, W, C).
    Returns (rgb (B, H, W, C), blend_weight (B, D, H, W)).  Differentiable
    everywhere, also where 1 - alpha is 0 (``torch.cumprod``'s backward
    handles zero factors)."""
    trans = torch.flip(torch.cumprod(torch.flip(1.0 - alpha, [1]), 1), [1])
    trans = torch.cat([trans[:, 1:], torch.ones_like(trans[:, :1])], dim=1)
    w = alpha * trans
    return torch.sum(content * w[..., None], dim=1), w


def normalized_disparity(geom: MPIGeometry, coords: WarpCoords,
                         blend_weight, normalize_by_alpha=False):
    """Per-pixel disparity map from blend weights (ref MPI.py:563-566)."""
    one = torch.ones((), dtype=coords.zview.dtype, device=coords.zview.device)
    z = torch.where(coords.valid, coords.zview, one)
    disp = (1.0 / z - 1.0 / geom.far) / (1.0 / geom.near - 1.0 / geom.far)
    disp = torch.where(coords.valid, disp, 0.0)
    num = torch.sum(disp * blend_weight, dim=1)
    if normalize_by_alpha:
        num = num / clip(torch.sum(blend_weight, dim=1), 1e-10)
    return num


def apply_background(rgb, alpha_sum, bg_color: Optional[torch.Tensor]):
    """Mix a background color (ref MPI.py:555-561)."""
    if bg_color is None:
        return rgb
    return rgb * alpha_sum[..., None] + bg_color * (1.0 - alpha_sum[..., None])
