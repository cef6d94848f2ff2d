"""Differentiable rendering through the vertex grids (counterpart of
``videoloop3d_tpu/render/geo_warp.py``; ``--optimize_geo_start``).

The reference rasterizes the per-plane quad meshes and interpolates fixed
per-vertex UVs with screen-space barycentrics (MPI.py:452-536), so moving
a vertex slides atlas content across the screen and gradients reach the
vertices through the barycentrics.  As in the JAX package, a pixel's
containing quad under the moved grid is searched among the 3x3 quads
around its quad under the FLAT grid (which the plane-sweep homography
gives in closed form); of the two triangles of each quad (the
reference's 013/320 split) the front-facing one with the largest
min-barycentric wins, and its fixed texel-space UVs are interpolated.

The warp has two parts:

* the vertex projection (`project_verts`): view-space and pixel
  positions of the (B, D, Hv, Wv) vertices, plain torch (an einsum in the
  JAX package, outside any kernel), differentiable by autograd;
* the triangle search (`_GeoWarp`): kernel K20 `geo_warp_fwd` gives the
  coordinates and the winning triangle of each (view, plane, pixel) and
  K21 `geo_warp_bwd` adds the cotangents of x, y and z into the
  projected vertex arrays (``csrc/geo_warp.cu``). Both take a block a
  plane and a tile of pixels, with the window of vertices its searches
  can reach (`geo_bwd_layout`, one plan for both): K20 stages the window
  and each triangle's pixel-free terms once a block, and each sample
  searches from them, dividing only for the triangles whose numerators
  leave them a chance to win, bit for bit the one-thread-a-sample
  search; K21 sums its samples onto the window on chip, and a second
  pass adds each vertex's windows in block order.  Their plain versions,
  `geo_warp_fwd_plain` and `geo_warp_bwd_plain`, run on CPU tensors.

`warp_coordinates_verts_plain` is the JAX loop line by line in torch ops,
differentiable by autograd; the tests and ``chip_smoke.py`` hold the
kernels against it.  The selection is discrete: gradients flow only
through the winning triangle's barycentrics, like a rasterizer's hard
visibility.  Plane order stays global (far -> near); `vertex_crossing_report`
is the guard of that bound.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from videoloop3d_torch import kernels
from videoloop3d_torch.render import renderer as R

_TRIANGLES = ((0, 1, 2), (2, 3, 0))     # 013 = TL, TR, BR; 320 = BR, BL, TL
_OFFSETS = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))
# K20's and K21's block: a tile of rows x pixels (csrc/geo_warp.cu
# kGeoTileH, kGeoTileW), each of its 8 warps _GEO_WARP_ROWS rows
# (kGeoRows), its window of at most _WIN_CAP vertices and _WIN_MAX_C
# columns, and the ints of its header (kHdrInts)
_GEO_TILE = (32, 32)
_GEO_WARP_ROWS = 4
_WIN_CAP = 256
_WIN_MAX_C = 32
_HDR_INTS = 8


def denormalize_verts(geom, verts, normalize):
    """Undo the per-plane depth normalization (ref MPI.py:445-449)."""
    if not normalize:
        return verts
    depths = torch.as_tensor(geom.depths_np(), device=verts.device)
    return (verts.reshape(geom.n_planes, -1)
            * depths[:, None]).reshape(verts.shape)


def vertex_crossing_report(geom, verts, normalize=False):
    """(max |dz|, half the inter-plane gap) of the vertex grids (host
    numpy): two adjacent plane surfaces can cross once a vertex deviates
    by half the gap, where the reference's z-buffered rasterizer would
    reorder fragments and the global plane order here would not.  The
    trainer warns when max |dz| > half-gap."""
    v = (verts.detach().cpu().numpy() if isinstance(verts, torch.Tensor)
         else np.asarray(verts, np.float32))
    D = geom.n_planes
    depths = geom.depths_np()
    if normalize:
        v = (v.reshape(D, -1) * depths[:, None]).reshape(v.shape)
    vz = v.reshape(D, -1, 3)[..., 2]
    dz = float(np.abs(vz - depths[:, None]).max())
    half_gap = float(np.abs(np.diff(depths)).min()) / 2.0
    return dz, half_gap


def vertex_uvs(geom, device):
    """The fixed per-vertex texel coordinates (ref uvs_voxel): uvx (Wv,)
    and uvy (Hv,) f32, the regular texel grid of the tile corners."""
    Hv, Wv = geom.n_tiles_h + 1, geom.n_tiles_w + 1
    uvx = np.linspace(0.0, geom.mpi_w - 1.0, Wv).astype(np.float32)
    uvy = np.linspace(0.0, geom.mpi_h - 1.0, Hv).astype(np.float32)
    return (torch.as_tensor(uvx, device=device),
            torch.as_tensor(uvy, device=device))


def project_verts(geom, verts, extrins, intrins, normalize=False):
    """Project the (D*Hv*Wv, 3) reference-camera vertices into target
    views with extrinsics (B, 4, 4) RELATIVE to the reference camera and
    intrinsics (B, 3, 3).  Returns (vpx, vpy, vz), each (B, D, Hv, Wv)
    f32: pixel x, y (divided by the clamped pixel depth) and the
    view-space depth (a vertex is in front where vz > 1e-6).
    Differentiable in verts."""
    D = geom.n_planes
    Hv, Wv = geom.n_tiles_h + 1, geom.n_tiles_w + 1
    v = denormalize_verts(geom, verts, normalize).reshape(D, Hv, Wv, 3)
    Rm = extrins[:, :3, :3][:, None, None, None]
    t = extrins[:, :3, 3][:, None, None, None]
    v_view = (Rm * v[None, ..., None, :]).sum(-1) + t
    pix = (intrins[:, None, None, None] * v_view[..., None, :]).sum(-1)
    pz = pix[..., 2]
    pz_safe = torch.where(pz.abs() < 1e-6, 1e-6, pz)
    return ((pix[..., 0] / pz_safe).contiguous(),
            (pix[..., 1] / pz_safe).contiguous(),
            v_view[..., 2].contiguous())


def flat_quad_guess(geom, extrins, intrins, h, w):
    """The quad (qi0, qj0) of each (B, D, h, w) sample under the flat grid,
    from the closed-form plane sweep: int32 row and column in
    [0, Hv-2] x [0, Wv-2]."""
    Hv, Wv = geom.n_tiles_h + 1, geom.n_tiles_w + 1
    flat = R.warp_coordinates(geom, extrins, intrins, h, w)
    dev = flat.x.device
    span_y = torch.tensor((geom.mpi_h - 1.0) / (Hv - 1), device=dev)
    span_x = torch.tensor((geom.mpi_w - 1.0) / (Wv - 1), device=dev)
    # clamp in float before the int conversion (far-off coordinates)
    qi0 = torch.floor(flat.y / span_y).clamp(-1, Hv).to(torch.int32)
    qj0 = torch.floor(flat.x / span_x).clamp(-1, Wv).to(torch.int32)
    return qi0.clamp(0, Hv - 2).contiguous(), qj0.clamp(0, Wv - 2).contiguous()


def _bary(px, py, ax, ay, bx, by, cx, cy):
    """2-D barycentrics of (px, py) in triangle (a, b, c); sign-safe."""
    v0x, v0y = bx - ax, by - ay
    v1x, v1y = cx - ax, cy - ay
    v2x, v2y = px - ax, py - ay
    den = v0x * v1y - v1x * v0y
    den = torch.where(den.abs() < 1e-12,
                      torch.where(den < 0, -1e-12, 1e-12), den)
    b1 = (v2x * v1y - v1x * v2y) / den
    b2 = (v0x * v2y - v2x * v0y) / den
    return 1.0 - b1 - b2, b1, b2


def _quad(qi0, qj0, di, dj, Hv, Wv):
    qi = (qi0 + di).clamp(0, Hv - 2).long()
    qj = (qj0 + dj).clamp(0, Wv - 2).long()
    # corners TL, TR, BR, BL
    return ((qi, qj), (qi, qj + 1), (qi + 1, qj + 1), (qi + 1, qj))


def _gather(arr, i, j):
    """Per-sample gather of vertex-grid values: arr (B, D, Hv, Wv), i, j
    (B, D, h, w) -> (B, D, h, w)."""
    B, D, Hv, Wv = arr.shape
    idx = (i * Wv + j).reshape(B, D, -1)
    return torch.gather(arr.reshape(B, D, Hv * Wv), 2, idx).reshape(i.shape)


def _pixels(h, w, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return xs, ys


def _search(vpx, vpy, vz, qi0, qj0, uvx, uvy):
    """The JAX package's 3x3-quad x 2-triangle loop in torch ops
    (differentiable through the winners by autograd).  Returns (x, y, z,
    best score, winning triangle int8: quad offset * 2 + triangle, -1
    where no front-facing triangle exists)."""
    Hv, Wv = vpx.shape[2:]
    h, w = qi0.shape[2:]
    xs, ys = _pixels(h, w, vpx.device)
    infront = vz > 1e-6
    best_score = torch.full(qi0.shape, -float("inf"), device=vpx.device)
    best_x = torch.zeros(qi0.shape, device=vpx.device)
    best_y = torch.zeros(qi0.shape, device=vpx.device)
    best_z = torch.ones(qi0.shape, device=vpx.device)
    tri = torch.full(qi0.shape, -1, dtype=torch.int8, device=vpx.device)
    for q, (di, dj) in enumerate(_OFFSETS):
        cs = _quad(qi0, qj0, di, dj, Hv, Wv)
        cpx = [_gather(vpx, i, j) for i, j in cs]
        cpy = [_gather(vpy, i, j) for i, j in cs]
        cz = [_gather(vz, i, j) for i, j in cs]
        cok = [_gather(infront, i, j) for i, j in cs]
        cux = [uvx[j] for _, j in cs]
        cuy = [uvy[i] for i, _ in cs]
        for t, (a, b, c) in enumerate(_TRIANGLES):
            b0, b1, b2 = _bary(xs, ys, cpx[a], cpy[a], cpx[b], cpy[b],
                               cpx[c], cpy[c])
            score = torch.minimum(torch.minimum(b0, b1), b2)
            front = cok[a] & cok[b] & cok[c]
            score = torch.where(front, score, -float("inf"))
            upd = score > best_score
            ux = b0 * cux[a] + b1 * cux[b] + b2 * cux[c]
            uy = b0 * cuy[a] + b1 * cuy[b] + b2 * cuy[c]
            uz = b0 * cz[a] + b1 * cz[b] + b2 * cz[c]
            best_score = torch.where(upd, score, best_score)
            best_x = torch.where(upd, ux, best_x)
            best_y = torch.where(upd, uy, best_y)
            best_z = torch.where(upd, uz, best_z)
            tri = torch.where(upd, torch.full_like(tri, 2 * q + t), tri)
    return best_x, best_y, best_z, best_score, tri


def _valid(x, y, z, score, mpi_hw):
    """Inside some triangle (tolerance for shared edges), in front, and
    inside the plane texture."""
    mpi_h, mpi_w = mpi_hw
    inside = (x >= 0) & (x <= mpi_w - 1) & (y >= 0) & (y <= mpi_h - 1)
    return (score > -1e-4) & (z > 1e-6) & inside


def warp_coordinates_verts_plain(geom, verts, extrins, intrins, h, w,
                                 normalize=False):
    """The JAX package's `warp_coordinates_verts` line by line in torch
    ops: pixel -> texel warp through the vertex grids verts (D*Hv*Wv, 3)
    for extrinsics (B, 4, 4) RELATIVE to the reference camera.  Returns
    WarpCoords with gradients flowing to verts by autograd."""
    vpx, vpy, vz = project_verts(geom, verts, extrins, intrins, normalize)
    qi0, qj0 = flat_quad_guess(geom, extrins, intrins, h, w)
    uvx, uvy = vertex_uvs(geom, vpx.device)
    x, y, z, score, _ = _search(vpx, vpy, vz, qi0, qj0, uvx, uvy)
    return R.WarpCoords(x, y, z, _valid(x, y, z, score,
                                        (geom.mpi_h, geom.mpi_w)))


def geo_warp_fwd_plain(vpx, vpy, vz, qi0, qj0, uvx, uvy, mpi_hw):
    """Plain version of K20.  Returns (x, y, z, valid, tri)."""
    with torch.no_grad():
        x, y, z, score, tri = _search(vpx, vpy, vz, qi0, qj0, uvx, uvy)
    return x, y, z, _valid(x, y, z, score, mpi_hw), tri


def geo_warp_bwd_plain(gx, gy, gz, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy):
    """Plain version of K21: the gradient of (x, y, z) with respect to
    (vpx, vpy, vz) for the cotangents gx, gy, gz (B, D, h, w), through
    each sample's winning triangle `tri` (autograd of its barycentric
    interpolation; a scatter onto its three vertices).  Returns
    (d_vpx, d_vpy, d_vz), each (B, D, Hv, Wv)."""
    Hv, Wv = vpx.shape[2:]
    h, w = qi0.shape[2:]
    xs, ys = _pixels(h, w, vpx.device)
    leaves = [t.detach().clone().requires_grad_(True) for t in (vpx, vpy, vz)]
    has = tri >= 0
    corners = _winner_corners(qi0, qj0, tri, Hv, Wv)
    with torch.enable_grad():
        px_, py_, pz_ = leaves
        cpx = [_gather(px_, i, j) for i, j in corners]
        cpy = [_gather(py_, i, j) for i, j in corners]
        cz = [_gather(pz_, i, j) for i, j in corners]
        b0, b1, b2 = _bary(xs, ys, cpx[0], cpy[0], cpx[1], cpy[1],
                           cpx[2], cpy[2])
        ux = b0 * uvx[corners[0][1]] + b1 * uvx[corners[1][1]] \
            + b2 * uvx[corners[2][1]]
        uy = b0 * uvy[corners[0][0]] + b1 * uvy[corners[1][0]] \
            + b2 * uvy[corners[2][0]]
        uz = b0 * cz[0] + b1 * cz[1] + b2 * cz[2]
        zero = torch.zeros((), device=vpx.device)
        outs = [torch.where(has, o, zero) for o in (ux, uy, uz)]
        grads = torch.autograd.grad(outs, leaves, (gx, gy, gz),
                                    allow_unused=True)
    return tuple(torch.zeros_like(v) if g is None else g
                 for g, v in zip(grads, (vpx, vpy, vz)))


def _winner_corners(qi0, qj0, tri, Hv, Wv):
    """The (row, column) int64 of each triangle corner of every sample's
    winner (3 each, in the kernels' corner order; tri < 0 as tri 0)."""
    code = tri.long().clamp(min=0)
    q, t = code // 2, code % 2
    di = torch.as_tensor([o[0] for o in _OFFSETS], device=qi0.device)[q]
    dj = torch.as_tensor([o[1] for o in _OFFSETS], device=qi0.device)[q]
    cs = _quad(qi0, qj0, di, dj, Hv, Wv)
    return [tuple(torch.where(t == 0, cs[a][k], cs[b][k]) for k in (0, 1))
            for a, b in zip(_TRIANGLES[0], _TRIANGLES[1])]


def geo_bwd_layout(qi0, qj0, Hv, Wv, tri=None, live=None):
    """K20's and K21's plan for the quad guesses qi0, qj0 (B, D, h, w) on
    (Hv, Wv) vertex grids (csrc/geo_warp.cu:vl3d_geo_bwd_layout and the
    windows geo_fwd_tile_kernel and geo_bwd_tile_kernel write in their
    headers).  Blocks run over (view, plane), then tiles of _GEO_TILE
    (rows, pixels) row-major.  A block's window spans the vertex rows
    from the smallest clamped qi0 - 1 to the largest clamped qi0 + 1,
    plus 1 (the quad's far corner), columns likewise, cut to at most
    _WIN_MAX_C columns and _WIN_CAP vertices.  "search_global" marks the
    samples whose 3 x 3 reach leaves their block's window (K20's route
    from global memory).  With the winners tri (int8) and `live` (bool,
    the samples that add: tri >= 0 by default), "overflow" marks the
    samples with a winning corner outside their block's window (K21's
    atomic route).  Returns {"tile", "tiles", "blocks", "win_cap",
    "win_max_cols", "hdr_ints", "scratch", "sum_block", "windows"
    (blocks, 4) int32 (first row, first column, rows, columns),
    "search_global" (B, D, h, w) bool, "n_search_global" and "n_samples"
    (blocks,) int64 and, with tri, "overflow" (B, D, h, w) bool,
    "n_overflow" and "n_live" (blocks,) int64}."""
    B, D, h, w = qi0.shape
    th, tw = _GEO_TILE
    ty, tx = -(-h // th), -(-w // tw)
    blocks = B * D * ty * tx
    out = {"tile": _GEO_TILE, "tiles": (ty, tx), "blocks": blocks,
           "win_cap": _WIN_CAP, "win_max_cols": _WIN_MAX_C,
           "hdr_ints": _HDR_INTS, "scratch": blocks * 3 * _WIN_CAP,
           "sum_block": 256}
    big = 2 ** 30

    def tiled(a, fill):
        a = torch.nn.functional.pad(a.reshape(B * D, h, w),
                                    (0, tx * tw - w, 0, ty * th - h),
                                    value=fill)
        return a.reshape(B * D, ty, th, tx, tw)
    rlo = tiled((qi0 - 1).clamp(0, Hv - 2), big).amin((2, 4))
    rhi = tiled((qi0 + 1).clamp(0, Hv - 2) + 1, -1).amax((2, 4))
    clo = tiled((qj0 - 1).clamp(0, Wv - 2), big).amin((2, 4))
    chi = tiled((qj0 + 1).clamp(0, Wv - 2) + 1, -1).amax((2, 4))
    nc = (chi - clo + 1).clamp(max=_WIN_MAX_C)
    nr = torch.minimum(rhi - rlo + 1, _WIN_CAP // nc)
    out["windows"] = torch.stack([rlo, clo, nr, nc], -1).reshape(
        blocks, 4).to(torch.int32)
    win = out["windows"].long().reshape(B * D, ty, 1, tx, 1, 4)
    t_in = tiled(torch.ones_like(qi0, dtype=torch.bool), False)
    out_rows = ((tiled((qi0 - 1).clamp(0, Hv - 2), 0) < win[..., 0])
                | (tiled((qi0 + 1).clamp(0, Hv - 2) + 1, 0)
                   >= win[..., 0] + win[..., 2]))
    out_cols = ((tiled((qj0 - 1).clamp(0, Wv - 2), 0) < win[..., 1])
                | (tiled((qj0 + 1).clamp(0, Wv - 2) + 1, 0)
                   >= win[..., 1] + win[..., 3]))
    reach = (out_rows | out_cols) & t_in
    out["search_global"] = reach.reshape(B * D, ty * th, tx * tw)[
        :, :h, :w].reshape(B, D, h, w)
    out["n_search_global"] = reach.sum((2, 4)).reshape(blocks)
    out["n_samples"] = t_in.sum((2, 4)).reshape(blocks)
    if tri is None:
        return out
    live = (tri >= 0) if live is None else live & (tri >= 0)
    over = torch.zeros((B * D, ty, th, tx, tw), dtype=torch.bool,
                       device=qi0.device)
    for vi, vj in _winner_corners(qi0, qj0, tri, Hv, Wv):
        li = tiled(vi, -1) - win[..., 0]
        lj = tiled(vj, -1) - win[..., 1]
        over |= ~((li >= 0) & (li < win[..., 2]) & (lj >= 0)
                  & (lj < win[..., 3]))
    t_live = tiled(live, False)
    over &= t_live
    out["overflow"] = over.reshape(B * D, ty * th, tx * tw)[:, :h, :w] \
        .reshape(B, D, h, w)
    out["n_overflow"] = over.sum((2, 4)).reshape(blocks)
    out["n_live"] = t_live.sum((2, 4)).reshape(blocks)
    return out


def kernel_geo_bwd_layout(B, D, h, w, Hv, Wv):
    """csrc/geo_warp.cu:vl3d_geo_bwd_layout, K20's and K21's plan as the
    library computes it: the keys of `geo_bwd_layout` that depend on the
    shapes only."""
    out = (ctypes.c_longlong * 10)()
    err = kernels.library().vl3d_geo_bwd_layout(B, D, h, w, Hv, Wv, out)
    kernels.check_launch("geo_bwd_layout", err)
    v = list(out)
    return {"tile": (v[0], v[1]), "tiles": (v[2], v[3]), "blocks": v[4],
            "win_cap": v[5], "win_max_cols": v[6], "hdr_ints": v[7],
            "scratch": v[8], "sum_block": v[9]}


def _check_warp(name, vpx, vpy, vz, qi0, qj0, uvx, uvy):
    dev = vpx.device
    if vpx.dim() != 4:
        raise ValueError(f"{name}.vpx: shape {tuple(vpx.shape)}, expected "
                         "(B, D, Hv, Wv)")
    B, D, Hv, Wv = vpx.shape
    for key, t in (("vpx", vpx), ("vpy", vpy), ("vz", vz)):
        kernels.check_tensor(f"{name}.{key}", t, dev, dtype=torch.float32,
                             shape=(B, D, Hv, Wv))
    kernels.check_tensor(f"{name}.qi0", qi0, dev, dtype=torch.int32)
    if qi0.dim() != 4 or qi0.shape[:2] != (B, D):
        raise ValueError(f"{name}.qi0: shape {tuple(qi0.shape)}, expected "
                         f"({B}, {D}, h, w)")
    kernels.check_tensor(f"{name}.qj0", qj0, dev, dtype=torch.int32,
                         shape=qi0.shape)
    kernels.check_tensor(f"{name}.uvx", uvx, dev, dtype=torch.float32,
                         shape=(Wv,))
    kernels.check_tensor(f"{name}.uvy", uvy, dev, dtype=torch.float32,
                         shape=(Hv,))
    if Hv < 2 or Wv < 2:
        raise ValueError(f"{name}: a vertex grid needs 2 x 2 vertices")


def geo_warp_fwd(vpx, vpy, vz, qi0, qj0, uvx, uvy, mpi_hw,
                 with_headers=False):
    """K20: the triangle search of the vertex warp.  vpx, vpy, vz
    (B, D, Hv, Wv) f32 from `project_verts`; qi0, qj0 (B, D, h, w) int32
    from `flat_quad_guess`; uvx (Wv,), uvy (Hv,) from `vertex_uvs`;
    mpi_hw = (mpi_h, mpi_w).  Returns (x, y, z (B, D, h, w) f32, valid
    bool, tri int8: the winning triangle, -1 for none); with_headers,
    also the blocks' headers ((blocks, 8) int32: window, the samples
    searched from global memory and the samples, `geo_bwd_layout`'s),
    None on the CPU."""
    _check_warp("geo_warp_fwd", vpx, vpy, vz, qi0, qj0, uvx, uvy)
    dev = vpx.device
    if dev.type == "cpu":
        out = geo_warp_fwd_plain(vpx, vpy, vz, qi0, qj0, uvx, uvy, mpi_hw)
        return (out, None) if with_headers else out
    B, D, Hv, Wv = vpx.shape
    h, w = qi0.shape[2:]
    lay = kernel_geo_bwd_layout(B, D, h, w, Hv, Wv)
    x, y, z = (torch.empty(qi0.shape, dtype=torch.float32, device=dev)
               for _ in range(3))
    valid = torch.empty(qi0.shape, dtype=torch.bool, device=dev)
    tri = torch.empty(qi0.shape, dtype=torch.int8, device=dev)
    hdr = torch.empty((lay["blocks"], _HDR_INTS), dtype=torch.int32,
                      device=dev)
    mpi_h, mpi_w = mpi_hw
    err = kernels.library().vl3d_geo_warp_fwd(
        vpx.data_ptr(), vpy.data_ptr(), vz.data_ptr(), qi0.data_ptr(),
        qj0.data_ptr(), uvx.data_ptr(), uvy.data_ptr(), B, D, h, w, Hv, Wv,
        float(mpi_w - 1), float(mpi_h - 1), x.data_ptr(), y.data_ptr(),
        z.data_ptr(), valid.data_ptr(), tri.data_ptr(), hdr.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.LAUNCHES["geo_warp_fwd"] += 1
    kernels.check_launch("geo_warp_fwd", err)
    out = (x, y, z, valid, tri)
    return (out, hdr) if with_headers else out


def geo_warp_bwd(gx, gy, gz, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy,
                 with_headers=False):
    """K21: the gradient of K20's (x, y, z) with respect to (vpx, vpy, vz)
    for the f32 cotangents gx, gy, gz (B, D, h, w), through each sample's
    winning triangle tri (int8, from K20).  Returns (d_vpx, d_vpy, d_vz),
    each (B, D, Hv, Wv) f32, summed in a fixed order (the same bits on
    every call where no sample takes the atomic route); with_headers,
    also the blocks' headers ((blocks, 8) int32: window, overflow and live
    samples, `geo_bwd_layout`'s), None on the CPU."""
    _check_warp("geo_warp_bwd", vpx, vpy, vz, qi0, qj0, uvx, uvy)
    dev = vpx.device
    for key, t in (("gx", gx), ("gy", gy), ("gz", gz)):
        kernels.check_tensor(f"geo_warp_bwd.{key}", t, dev,
                             dtype=torch.float32, shape=qi0.shape)
    kernels.check_tensor("geo_warp_bwd.tri", tri, dev, dtype=torch.int8,
                         shape=qi0.shape)
    if dev.type == "cpu":
        grads = geo_warp_bwd_plain(gx, gy, gz, vpx, vpy, vz, qi0, qj0, tri,
                                   uvx, uvy)
        return (grads, None) if with_headers else grads
    B, D, Hv, Wv = vpx.shape
    h, w = qi0.shape[2:]
    lay = kernel_geo_bwd_layout(B, D, h, w, Hv, Wv)
    grads = torch.zeros((3,) + tuple(vpx.shape), dtype=torch.float32,
                        device=dev)
    hdr = torch.empty((lay["blocks"], _HDR_INTS), dtype=torch.int32,
                      device=dev)
    part = torch.empty(lay["scratch"], dtype=torch.float32, device=dev)
    err = kernels.library().vl3d_geo_warp_bwd(
        gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), vpx.data_ptr(),
        vpy.data_ptr(), vz.data_ptr(), qi0.data_ptr(), qj0.data_ptr(),
        tri.data_ptr(), uvx.data_ptr(), uvy.data_ptr(), B, D, h, w, Hv, Wv,
        hdr.data_ptr(), part.data_ptr(), *(g.data_ptr() for g in grads),
        kernels.stream_ptr(dev))
    kernels.LAUNCHES["geo_warp_bwd"] += 1
    kernels.check_launch("geo_warp_bwd", err)
    return (tuple(grads), hdr) if with_headers else tuple(grads)


class _GeoWarp(torch.autograd.Function):
    """K20 forward, K21 backward (the plain versions on CPU tensors).  The
    quad guess and the UVs get no gradient; valid is not differentiable."""

    @staticmethod
    def forward(ctx, vpx, vpy, vz, qi0, qj0, uvx, uvy, mpi_hw):
        vpx, vpy, vz = (t.detach().contiguous() for t in (vpx, vpy, vz))
        x, y, z, valid, tri = geo_warp_fwd(vpx, vpy, vz, qi0, qj0, uvx, uvy,
                                           mpi_hw)
        ctx.save_for_backward(vpx, vpy, vz, qi0, qj0, tri, uvx, uvy)
        ctx.mark_non_differentiable(valid)
        return x, y, z, valid

    @staticmethod
    def backward(ctx, gx, gy, gz, _):
        vpx, vpy, vz, qi0, qj0, tri, uvx, uvy = ctx.saved_tensors
        d = geo_warp_bwd(gx.contiguous(), gy.contiguous(), gz.contiguous(),
                         vpx, vpy, vz, qi0, qj0, tri, uvx, uvy)
        return (*d, None, None, None, None, None)


def warp_coordinates_verts(geom, verts, extrins, intrins, h, w,
                           normalize=False):
    """Pixel -> texel warp through the vertex grids: verts (D*Hv*Wv, 3)
    reference-camera positions (differentiable), extrinsics (B, 4, 4)
    RELATIVE to the reference camera, intrinsics (B, 3, 3).  The
    projection is plain torch, the triangle search K20/K21.  Returns
    WarpCoords (B, D, h, w) with gradients flowing to verts."""
    vpx, vpy, vz = project_verts(geom, verts, extrins, intrins, normalize)
    qi0, qj0 = flat_quad_guess(geom, extrins, intrins, h, w)
    uvx, uvy = vertex_uvs(geom, vpx.device)
    x, y, z, valid = _GeoWarp.apply(vpx, vpy, vz, qi0, qj0, uvx, uvy,
                                    (geom.mpi_h, geom.mpi_w))
    return R.WarpCoords(x, y, z, valid)
