"""The first designs of K2 (at C != 4), K3 (at C != 4), K4, K5 (at C !=
4), K7, K8, K9 (and its atomic route at C != 4), K10, K11 (its "mse"
search on the CUDA cores and its ssim mode), K12 (both modes), K13, K14,
K15, K16, K17, K18, K19, K20, K21, K22 (at C != 4), K23, K24, K25, K26,
K27 and K28, kept beside their redesigns for comparison only.

``chip_smoke.py`` and the card tests call these to hold each redesign bit
for bit against the design it replaced and to time both; no path of the
port calls them, and they add to no launch count.  Each takes the
arguments of its wrapper and returns what that wrapper returns.
"""
from __future__ import annotations

import numpy as np
import torch

from videoloop3d_torch import kernels
from videoloop3d_torch.losses import patch_nn as PN
from videoloop3d_torch.losses import swd as SW
from videoloop3d_torch.render import compact as CP
from videoloop3d_torch.render import fused as FU
from videoloop3d_torch.render import fused_s1 as F1
from videoloop3d_torch.render import sample as S


def sort_keys(v):
    """csrc/swd_mask.cu:f2key in torch: the order-preserving keys of f32
    values (-0 as +0) as int32 bits, K27's output format."""
    u = v.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    k = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return (k - ((k >= 2 ** 31).long() << 32)).to(torch.int32)


def bilinear_tiles_first(tiles, tile_idx, u, v, gather_dtype=None):
    """K2's first design at any C, one thread a sample writing its C
    channels (csrc/bilinear_tiles.cu:vl3d_bilinear_tiles_first), with
    `render.sample.bilinear_tiles`'s arguments: (values, valid)."""
    S._check_samples("bilinear_tiles (first design)", tiles, tile_idx, u, v)
    gather_dtype = tiles.dtype if gather_dtype is None else gather_dtype
    if tiles.shape[0] == 0:
        return (torch.zeros(tile_idx.shape + tiles.shape[3:],
                            dtype=torch.float32, device=tiles.device),
                tile_idx >= 0)
    return S.launch_tiles("vl3d_bilinear_tiles_first", tiles, tile_idx, u, v,
                          gather_dtype)


def bilinear_tiles_tilemajor_first(tiles, tile_idx, u, v, ts=None,
                                   gather_dtype=None):
    """K3's first design at any C, one thread a (sample, frame) writing its
    C channels (csrc/bilinear_tiles_tilemajor.cu:
    vl3d_bilinear_tiles_tilemajor_first), with
    `render.sample.bilinear_tiles_tilemajor`'s arguments: (values,
    valid)."""
    S._check_samples("bilinear_tiles_tilemajor (first design)", tiles,
                     tile_idx, u, v)
    gather_dtype = tiles.dtype if gather_dtype is None else gather_dtype
    F_sel = tiles.shape[3] if ts is None else ts.numel()
    if tiles.shape[0] == 0 or F_sel == 0:
        return (torch.zeros(tile_idx.shape + (F_sel, tiles.shape[4]),
                            dtype=torch.float32, device=tiles.device),
                tile_idx >= 0)
    return S.launch_tilemajor("vl3d_bilinear_tiles_tilemajor_first", tiles,
                              tile_idx, u, v, ts, gather_dtype)


def bilinear_tiles_coord_grad_first(ct, tiles, tile_idx, u, v):
    """K23's first design, its two zero fills, then one thread a sample
    with a run-time channel loop (csrc/bilinear_tiles.cu:
    vl3d_bilinear_tiles_coord_grad_first), with
    `render.sample.bilinear_tiles_coord_grad`'s arguments: (g_u, g_v)."""
    S._check_samples("bilinear_tiles_coord_grad (first design)", tiles,
                     tile_idx, u, v)
    g_u = torch.zeros(tile_idx.shape, dtype=torch.float32, device=ct.device)
    g_v = torch.zeros(tile_idx.shape, dtype=torch.float32, device=ct.device)
    if tiles.shape[0]:
        S.launch_coord_grad("vl3d_bilinear_tiles_coord_grad_first", ct, tiles,
                            tile_idx, u, v, g_u, g_v)
    return g_u, g_v


def sample_dense_coord_grad_first(g, g_mask, atlas, atlas_mask, x, y):
    """K22's first design at any C, one thread a sample walking its
    channels (csrc/sample_dense.cu:vl3d_sample_dense_coord_grad_first),
    with `render.sample.sample_dense_coord_grad`'s arguments: (g_x,
    g_y)."""
    _check_dense_coord_grad("sample_dense_coord_grad (first design)", g,
                            g_mask, atlas, atlas_mask, x, y)
    return S.launch_dense_coord_grad("vl3d_sample_dense_coord_grad_first",
                                     g, g_mask, atlas, atlas_mask, x, y)


def sample_dense_coord_grad_staged(g, g_mask, atlas, atlas_mask, x, y):
    """K22's staged kernel at any C and texel type
    (csrc/sample_dense.cu:vl3d_sample_dense_coord_grad_staged), for the
    comparison where the wrapper keeps the first design (C = 4; bf16 at
    C % 4 != 0); with `render.sample.sample_dense_coord_grad`'s arguments:
    (g_x, g_y)."""
    _check_dense_coord_grad("sample_dense_coord_grad (staged)", g, g_mask,
                            atlas, atlas_mask, x, y)
    D, Ht, Wt, C = atlas.shape
    S.dense_coord_grad_layout(x.numel(), C, D, Ht, Wt)
    return S.launch_dense_coord_grad("vl3d_sample_dense_coord_grad_staged",
                                     g, g_mask, atlas, atlas_mask, x, y)


def _check_dense_coord_grad(name, g, g_mask, atlas, atlas_mask, x, y):
    S.check_dense_coord_grad(name, g, g_mask, atlas, atlas_mask, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors only")


def fused_s1_fwd_first(cfg, feats, valid, mask_feats, dinv):
    """K7's first design, one thread a pixel decoding its pixel and its
    right and lower neighbours again at each plane
    (csrc/fused_s1.cu:vl3d_fused_s1_fwd_first), with
    `render.fused_s1.fused_s1_fwd`'s arguments: (out, asum, disp, label,
    regs)."""
    F1._check_inputs("fused_s1_fwd (first design)", cfg, feats, valid,
                     mask_feats, dinv)
    return F1.launch_fwd("vl3d_fused_s1_fwd_first", cfg, feats, valid,
                         mask_feats, dinv)


def fused_s1_bwd_first(cfg, feats, valid, mask_feats, dinv, g_out, g_asum,
                       g_disp, g_label, g_regs):
    """K8's first design, one thread a pixel with T_in in local memory and
    every neighbour decoded again at each plane
    (csrc/fused_s1.cu:vl3d_fused_s1_bwd_first), with
    `render.fused_s1.fused_s1_bwd`'s arguments: (d_feats, d_mask or
    None)."""
    return F1.launch_bwd("vl3d_fused_s1_bwd_first", cfg, feats, valid,
                         mask_feats, dinv, g_out, g_asum, g_disp, g_label,
                         g_regs)


def sample_dense_first(atlas, mask, x, y):
    """K5's first design at any C, one thread per (sample, channel)
    (csrc/sample_dense.cu:vl3d_sample_dense_per_channel), with
    `render.sample.sample_dense_fwd`'s arguments: (feats, mask feats or
    None)."""
    B, D, h, w = x.shape
    _, Ht, Wt, C = atlas.shape
    out = torch.empty((B, D, h, w, C), dtype=torch.float32, device=x.device)
    out_m = None if mask is None else torch.empty(
        (B, D, h, w, 1), dtype=torch.float32, device=x.device)
    err = kernels.library().vl3d_sample_dense_per_channel(
        atlas.data_ptr(), None if mask is None else mask.data_ptr(),
        x.data_ptr(), y.data_ptr(), B, D, h * w, Ht, Wt, C, out.data_ptr(),
        None if out_m is None else out_m.data_ptr(),
        kernels.stream_ptr(x.device))
    kernels.check_launch("sample_dense (first design)", err)
    return out, out_m


def swd_mask_sort_first(o, gather, payload):
    """K27's first design: per-pass histograms of 2,048-key tiles, their
    scan, and a scatter straight into device memory
    (csrc/swd_mask.cu:vl3d_swd_mask_sort_first), with
    `losses.swd.swd_mask_sort`'s arguments: (keys, payload or None)."""
    P, n = o.shape[0], gather.shape[0]
    keys = torch.empty((P, n), dtype=torch.int32, device=o.device)
    alt = torch.empty_like(keys)
    pay = torch.empty_like(keys) if payload else None
    pay_alt = torch.empty_like(keys) if payload else None
    hist = torch.empty((P, 256, -(-n // 2048)), dtype=torch.int32,
                       device=o.device)
    err = kernels.library().vl3d_swd_mask_sort_first(
        o.data_ptr(), o[0].numel(), gather.data_ptr(), P, n, keys.data_ptr(),
        alt.data_ptr(), None if pay is None else pay.data_ptr(),
        None if pay_alt is None else pay_alt.data_ptr(), hist.data_ptr(),
        kernels.stream_ptr(o.device))
    kernels.check_launch("swd_mask_sort (first design)", err)
    return keys, pay


def swd_mask_l1_first(kx, ix, ky, plan, L, cfx):
    """K28's first design: the sign written as an f32 at x's payload, then
    each entry's copies read back, the deficit's sorted in a local array
    of at most 64 (csrc/swd_mask.cu:vl3d_swd_mask_l1_first), with
    `losses.swd.swd_mask_l1`'s arguments: (loss, gx)."""
    dev = kx.device
    P, n, n_x = SW._check_mask_l1("swd_mask_l1 (first design)", kx, ix, ky,
                                  L, cfx)
    if n != n_x and n // n_x > SW._MASK_MAX_REPS:
        raise ValueError(f"swd_mask_l1 (first design): x is tiled "
                         f"{n // n_x} times (at most {SW._MASK_MAX_REPS})")
    count = np.float32(P * n)
    gm = torch.empty((P, n), dtype=torch.float32, device=dev)
    partial = torch.empty(-(-(P * n) // 256), dtype=torch.float64,
                          device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    gx = torch.empty((P, L, cfx), dtype=torch.float32, device=dev)
    invp = plan["invp"]
    err = kernels.library().vl3d_swd_mask_l1_first(
        kx.data_ptr(), ky.data_ptr(), ix.data_ptr(), P, n, n_x, L, cfx,
        plan["tiled"], plan["deficit"],
        None if invp is None else invp.data_ptr(),
        float(np.float32(1.0) / count), float(count), gm.data_ptr(),
        partial.data_ptr(), loss.data_ptr(), gx.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check_launch("swd_mask_l1 (first design)", err)
    return loss, gx


def swd_project_first(v, rand, psz, strides):
    """K24's first design: 64 x 64 tiles of 4 x 4 outputs, 32 entries
    staged at a time in one buffer (csrc/swd.cu:vl3d_swd_project_first),
    with `losses.swd.swd_project`'s arguments: (P, ch * cw, cf) f32."""
    cf, ch, cw = SW._grid(v.shape, psz, strides)
    P = rand.shape[0]
    out = torch.empty((P, ch * cw, cf), dtype=torch.float32, device=v.device)
    err = kernels.library().vl3d_swd_project_first(
        v.data_ptr(), rand.data_ptr(), *v.shape, *psz[:2], *strides[:2], P,
        out.data_ptr(), kernels.stream_ptr(v.device))
    kernels.check_launch("swd_project (first design)", err)
    return out


def swd_sort_l1_first(ox, oy, map_x, map_y):
    """K25's first design, each entry's stable rank by a scan of its
    column in shared memory (csrc/swd.cu:vl3d_swd_sort_l1_first), with
    `losses.swd.swd_sort_l1`'s arguments: (loss, gx).  Every NaN takes
    rank 0 there: on columns with NaNs it is not the stable sort."""
    n = SW._check_sort_l1("swd_sort_l1 (first design)", ox, oy, map_x,
                          map_y)
    ncols = ox.shape[0] * ox.shape[1]
    partial = torch.empty(-(-ncols // SW._SORT_COLS_PER_BLOCK),
                          dtype=torch.float32, device=ox.device)
    loss = torch.empty((), dtype=torch.float32, device=ox.device)
    gx = torch.empty_like(ox)
    err = kernels.library().vl3d_swd_sort_l1_first(
        ox.data_ptr(), oy.data_ptr(), ncols, ox.shape[2], oy.shape[2], n,
        map_x.data_ptr() if map_x is not None else None,
        map_y.data_ptr() if map_y is not None else None,
        float(np.float32(ncols * n)), partial.data_ptr(), loss.data_ptr(),
        gx.data_ptr(), kernels.stream_ptr(ox.device))
    kernels.check_launch("swd_sort_l1 (first design)", err)
    return loss, gx


def swd_project_grad_first(gx, rand, shape, psz, strides):
    """K26's first design: the first design's GEMM into a (cf ch cw, d)
    scratch, folded w-fastest (csrc/swd.cu:vl3d_swd_project_grad_first),
    with `losses.swd.swd_project_grad`'s arguments: (C, T, H, W) f32."""
    cf, ch, cw = SW._grid(shape, psz, strides)
    scratch = torch.empty((cf * ch * cw, rand.shape[1]), dtype=torch.float32,
                          device=gx.device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=gx.device)
    err = kernels.library().vl3d_swd_project_grad_first(
        gx.data_ptr(), rand.data_ptr(), *shape, *psz[:2], *strides[:2],
        rand.shape[0], scratch.data_ptr(), out.data_ptr(),
        kernels.stream_ptr(gx.device))
    kernels.check_launch("swd_project_grad (first design)", err)
    return out


def first_search_smem(plan, d, mode):
    """Shared bytes of the first design of K11 and K18
    (csrc/nn_argmin.cu:nn_search_first_kernel; d the chain's length, C pt
    ph pw or, for "band", C ph pw): the offsets of x and y, two staged 32
    x 65 chunks, the norms (ssim: means), the column minima, the
    distances (K18: the (fx, fy) per-frame and (ntx, nty) banded ones),
    and the ssim variances."""
    (pt, _, _), (st, _, _) = plan.psz, plan.strides
    ntx, nty = plan.grid[:2]
    if mode == "band":
        fx, fy = (ntx - 1) * st + pt, (nty - 1) * st + pt
        return 4 * (2 * d + 2 * 32 * 65 + fx + fy + nty + fx * fy
                    + ntx * nty)
    ssim = ntx + nty if mode == "ssim" else 0
    return 4 * (2 * d + 2 * 32 * 65 + ntx + 2 * nty + ntx * nty + ssim)


def nn_argmin_first(x, y, plan, alpha=None, dist_fn="mse"):
    """K11's first design, 64 x 64 tiles of 4 x 4 and one column a block
    (csrc/nn_argmin.cu:vl3d_nn_argmin_simt, "mse" on f32 or bf16 inputs;
    vl3d_nn_argmin_ssim_first, the ssim mode), with
    `losses.patch_nn.nn_argmin`'s arguments and indices."""
    C, Tx, H, W = x.shape
    ntx, _, nh, nw = plan.grid
    d = C * int(np.prod(plan.psz))
    nn = torch.empty((len(plan.hs) * len(plan.ws), nh * nw, ntx),
                     dtype=torch.int32, device=x.device)
    fn = kernels.library().vl3d_nn_argmin_ssim_first if dist_fn == "ssim" \
        else kernels.library().vl3d_nn_argmin_simt
    err = fn(x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), C,
             Tx, y.shape[1], H, W, PN._plan_ints(plan),
             int(alpha is not None), float(alpha or 0.0),
             first_search_smem(plan, d, dist_fn), nn.data_ptr(),
             kernels.stream_ptr(x.device))
    kernels.check_launch(f"nn_argmin {dist_fn} (first design)", err)
    return nn


def nn_band_argmin_first(x, y, plan, alpha=None, scale_by_pt=False,
                         both_directions=False):
    """K18's first design (csrc/nn_argmin.cu:vl3d_nn_band_argmin_first),
    with `losses.patch_nn.nn_band_argmin`'s arguments: (rows, cols or
    None)."""
    C, Tx, H, W = x.shape
    ntx, nty, nh, nw = plan.grid
    n_crops = len(plan.hs) * len(plan.ws)
    rows = torch.empty((n_crops, nh * nw, ntx), dtype=torch.int32,
                       device=x.device)
    cols = torch.empty((n_crops, nh * nw, nty), dtype=torch.int32,
                       device=x.device) if both_directions else None
    err = kernels.library().vl3d_nn_band_argmin_first(
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), C, Tx,
        y.shape[1], H, W, PN._plan_ints(plan), int(scale_by_pt),
        int(alpha is not None), float(alpha or 0.0),
        first_search_smem(plan, C * plan.psz[1] * plan.psz[2], "band"),
        rows.data_ptr(), cols.data_ptr() if both_directions else None,
        kernels.stream_ptr(x.device))
    kernels.check_launch("nn_band_argmin (first design)", err)
    return rows, cols


def bilinear_planes_tilemajor_first(tex, x, y, ts=None):
    """K16's first design, one thread per (sample, frame) and C scalar
    loads a corner (csrc/bilinear_planes_tilemajor.cu:
    vl3d_bilinear_planes_tilemajor_first), on texels of their own dtype,
    with `render.sample.bilinear_planes_tilemajor`'s arguments: (D, ...,
    F_sel, C) f32."""
    D, Ht, Wt, F_all, C = tex.shape
    F_sel = F_all if ts is None else ts.numel()
    out = torch.empty(x.shape + (F_sel, C), dtype=torch.float32,
                      device=x.device)
    err = kernels.library().vl3d_bilinear_planes_tilemajor_first(
        tex.data_ptr(), int(tex.dtype == torch.bfloat16), x.data_ptr(),
        y.data_ptr(), None if ts is None else ts.data_ptr(), D,
        x.numel() // D, Ht, Wt, F_all, F_sel, C, out.data_ptr(),
        kernels.stream_ptr(x.device))
    kernels.check_launch("bilinear_planes_tilemajor (first design)", err)
    return out


def bilinear_planes_tilemajor_grad_first(ct, x, y, tex_shape):
    """K17's first design, four scalar f32 atomicAdds a corner into a
    zero-filled buffer (csrc/bilinear_planes_tilemajor.cu:
    vl3d_bilinear_planes_tilemajor_grad_first; the zero fill included),
    with `render.sample.bilinear_planes_tilemajor_grad`'s arguments: the
    (D, Ht, Wt, F, C) f32 sums, unrounded."""
    D, Ht, Wt, F, C = tex_shape
    grad = torch.zeros(tex_shape, dtype=torch.float32, device=ct.device)
    err = kernels.library().vl3d_bilinear_planes_tilemajor_grad_first(
        ct.data_ptr(), x.data_ptr(), y.data_ptr(), D, x.numel() // D, Ht, Wt,
        F, C, grad.data_ptr(), kernels.stream_ptr(ct.device))
    kernels.check_launch("bilinear_planes_tilemajor_grad (first design)",
                         err)
    return grad


def fused_s2_bwd_first(cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv, g_out,
                       g_asum, g_disp, g_regs):
    """K15's first design, one thread per (pixel, frame), whole pixels a
    block, T_in in a per-thread array and every sample and neighbour
    decoded per frame (csrc/fused_s2.cu:vl3d_fused_s2_bwd_first), with
    `render.fused.fused_s2_bwd`'s arguments: (d_vals_s, d_vals_d)."""
    S, h, w, F, _ = vals_d.shape
    d_vals_s = torch.empty_like(vals_s)
    d_vals_d = torch.empty_like(vals_d)
    n = FU._norms(cfg, S, h, w, F)
    err = kernels.library().vl3d_fused_s2_bwd_first(
        vals_s.data_ptr(), vals_d.data_ptr(), m_s.data_ptr(),
        hit_d.data_ptr(), m_d.data_ptr(),
        dinv.data_ptr() if cfg.want_disp else None, g_out.data_ptr(),
        g_asum.data_ptr(), g_disp.data_ptr(), g_regs.data_ptr(), S, h, w, F,
        cfg.flags(), cfg.sp_eps, float(n["n_pix"] * n["sqrt_planes"]),
        float(n["n_rgb_dx"]), float(n["n_rgb_dy"]), float(n["n_dx"]),
        float(n["n_dy"]), d_vals_s.data_ptr(), d_vals_d.data_ptr(),
        kernels.stream_ptr(vals_d.device))
    kernels.check_launch("fused_s2_bwd (first design)", err)
    return d_vals_s, d_vals_d


def fused_s2_fwd_first(cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv):
    """K14's first design, one thread per (pixel, frame), its own sample
    and both neighbours decoded per slot and frame, the sums reduced in
    blocks of 256 consecutive (pixel, frame)s (csrc/fused_s2.cu:
    vl3d_fused_s2_fwd_first), with `render.fused.fused_s2_fwd`'s
    arguments: (out, alpha_sum, disp, regs)."""
    S, h, w, F, _ = vals_d.shape
    f32 = dict(dtype=torch.float32, device=vals_d.device)
    out = torch.empty((h, w, F, 3), **f32)
    asum = torch.empty((h, w, F), **f32)
    disp = torch.empty((h, w, F), **f32)
    partials = torch.empty((kernels.partial_rows(h * w * F), 5), **f32)
    regs = torch.zeros((3,), **f32)
    n = FU._norms(cfg, S, h, w, F)
    err = kernels.library().vl3d_fused_s2_fwd_first(
        vals_s.data_ptr(), vals_d.data_ptr(), m_s.data_ptr(),
        hit_d.data_ptr(), m_d.data_ptr(),
        dinv.data_ptr() if cfg.want_disp else None, S, h, w, F, cfg.flags(),
        cfg.sp_eps, float(n["n_pix"]), n["sqrt_planes"],
        float(n["n_rgb_dx"]), float(n["n_rgb_dy"]), float(n["n_dx"]),
        float(n["n_dy"]), out.data_ptr(), asum.data_ptr(), disp.data_ptr(),
        partials.data_ptr(), regs.data_ptr(),
        kernels.stream_ptr(vals_d.device))
    kernels.check_launch("fused_s2_fwd (first design)", err)
    return out, asum, disp, regs


def tiles_tilemajor_grad_first(ct, tile_idx, u, v, tiles_shape):
    """K10's first design, four scalar f32 atomicAdds a corner and channel
    into a zero-filled buffer (csrc/bilinear_tiles_tilemajor.cu:
    vl3d_bilinear_tiles_tilemajor_grad_first; the zero fill included),
    with `render.sample.bilinear_tiles_tilemajor_grad`'s arguments: the
    (N, th, tw, F, C) f32 sums, unrounded."""
    N, th, tw, F, C = tiles_shape
    grad = torch.zeros(tiles_shape, dtype=torch.float32, device=ct.device)
    err = kernels.library().vl3d_bilinear_tiles_tilemajor_grad_first(
        ct.data_ptr(), tile_idx.data_ptr(), u.data_ptr(), v.data_ptr(),
        tile_idx.numel(), N, th, tw, F, C, grad.data_ptr(),
        kernels.stream_ptr(ct.device))
    kernels.check_launch("bilinear_tiles_tilemajor_grad (first design)",
                         err)
    return grad


def nn_fold_first(y, nn, plan, parent=1):
    """K12's first design, one thread per output voxel and channel, the
    indices read from device memory per term (csrc/nn_fold.cu:
    vl3d_nn_fold_first), with `losses.patch_nn.nn_fold`'s arguments: y2x
    (C, fit_tx, fit_h, fit_w) f32."""
    C, Ty, H, W = y.shape
    ft, fh, fw = plan.fit
    out = torch.empty((C, ft, fh, fw), dtype=torch.float32, device=y.device)
    err = kernels.library().vl3d_nn_fold_first(
        y.data_ptr(), nn.data_ptr(), int(y.dtype == torch.bfloat16), C, Ty,
        H, W, PN._plan_ints(plan), parent, ft, fh, fw, out.data_ptr(),
        kernels.stream_ptr(y.device))
    kernels.check_launch("nn_fold (first design)", err)
    return out


def composite_first(vals_s, m_s, vals_d, hit_d, m_d):
    """K4's first design, one thread per (pixel, frame), each plane's hit
    byte, then its sample as four scalar loads, decoded per frame
    (csrc/composite.cu:vl3d_composite_first), with
    `render.fused.composite`'s arguments: (out, alpha_sum)."""
    S, h, w, F, C = FU.check_composite_inputs(vals_s, m_s, vals_d, hit_d,
                                              m_d)
    f32 = dict(dtype=torch.float32, device=vals_d.device)
    out = torch.empty((h, w, F, 3), **f32)
    asum = torch.empty((h, w, F), **f32)
    err = kernels.library().vl3d_composite_first(
        vals_s.data_ptr(), vals_d.data_ptr(), m_s.data_ptr(),
        hit_d.data_ptr(), m_d.data_ptr(), S, h * w, F, C, out.data_ptr(),
        asum.data_ptr(), kernels.stream_ptr(vals_d.device))
    kernels.check_launch("composite (first design)", err)
    return out, asum


def bilinear_tiles_grad_first(ct, tile_idx, u, v, tiles_shape):
    """K9's first design, four scalar f32 atomicAdds a corner and channel
    into a zero-filled buffer (csrc/bilinear_tiles.cu:
    vl3d_bilinear_tiles_grad_first; the zero fill included), with
    `render.sample.bilinear_tiles_grad`'s arguments: the (N, th, tw, C)
    f32 sums, unrounded."""
    N, th, tw, C = tiles_shape
    grad = torch.zeros(tiles_shape, dtype=torch.float32, device=ct.device)
    err = kernels.library().vl3d_bilinear_tiles_grad_first(
        ct.data_ptr(), tile_idx.data_ptr(), u.data_ptr(), v.data_ptr(),
        tile_idx.numel(), N, th, tw, C, grad.data_ptr(),
        kernels.stream_ptr(ct.device))
    kernels.check_launch("bilinear_tiles_grad (first design)", err)
    return grad


def bilinear_tiles_grad_atomic(ct, tile_idx, u, v, tiles_shape,
                               gather_dtype=None):
    """K9's atomic route, which its gather replaced at C != 4: its own
    zero fill, C / vec vector atomics a corner (vec 4, 2 or 1 as C and
    the pointers allow) and, with a bf16 gather_dtype, the tiles' flags
    and the rounding pass (csrc/bilinear_tiles.cu:
    vl3d_bilinear_tiles_grad_atomic), with
    `render.sample.bilinear_tiles_grad`'s arguments."""
    N, th, tw, C = tiles_shape
    grad = torch.empty(tiles_shape, dtype=torch.float32, device=ct.device)
    rnd = gather_dtype == torch.bfloat16
    flags = torch.empty(N, dtype=torch.uint8, device=ct.device) if rnd \
        else None
    err = kernels.library().vl3d_bilinear_tiles_grad_atomic(
        ct.data_ptr(), tile_idx.data_ptr(), u.data_ptr(), v.data_ptr(),
        tile_idx.numel(), N, th, tw, C, S._vec_width(C, ct, grad), int(rnd),
        None if flags is None else flags.data_ptr(), grad.data_ptr(),
        kernels.stream_ptr(ct.device))
    kernels.check_launch("bilinear_tiles_grad (atomic route)", err)
    return grad


def nn_band_err_first(x, y, plan, nn, reverse=False):
    """K19's first design, one 256-thread block per (crop, column), each
    thread a strided share of the flat (i, k, q) index
    (csrc/nn_band_err.cu:vl3d_nn_band_err_first), with
    `losses.patch_nn.nn_band_err`'s arguments: (n_crops,) f32."""
    ntx, nty, nh, nw = plan.grid
    ns = nty if reverse else ntx
    n_crops = len(plan.hs) * len(plan.ws)
    C, _, H, W = x.shape
    src, tar = (y, x) if reverse else (x, y)
    partial = torch.empty(n_crops * nh * nw, dtype=torch.float32,
                          device=x.device)
    out = torch.empty(n_crops, dtype=torch.float32, device=x.device)
    err = kernels.library().vl3d_nn_band_err_first(
        src.data_ptr(), tar.data_ptr(), int(x.dtype == torch.bfloat16), C,
        src.shape[1], tar.shape[1], H, W, PN._plan_ints(plan), ns,
        nn.data_ptr(), partial.data_ptr(), out.data_ptr(),
        kernels.stream_ptr(x.device))
    kernels.check_launch("nn_band_err (first design)", err)
    return out


def compact_sweep_first(k_s, k_d, fu, fv, valid, zview, n_slots):
    """K13's first design, one thread a pixel walking its planes near to
    far (csrc/compact.cu:vl3d_compact_sweep_first), with
    `render.compact.compact_sweep`'s arguments: a `CompactedSweep`."""
    D, h, w = k_s.shape
    S = int(n_slots)
    f32 = dict(dtype=torch.float32, device=k_s.device)
    o_ks, o_kd = (torch.empty((S, h, w), dtype=torch.int32,
                              device=k_s.device) for _ in range(2))
    o_fu, o_fv, o_z = (torch.empty((S, h, w), **f32) for _ in range(3))
    o_valid = torch.empty((S, h, w), dtype=torch.bool, device=k_s.device)
    err = kernels.library().vl3d_compact_sweep_first(
        k_s.data_ptr(), k_d.data_ptr(), fu.data_ptr(), fv.data_ptr(),
        valid.data_ptr(), zview.data_ptr(), D, h * w, S, o_ks.data_ptr(),
        o_kd.data_ptr(), o_fu.data_ptr(), o_fv.data_ptr(), o_valid.data_ptr(),
        o_z.data_ptr(), kernels.stream_ptr(k_s.device))
    kernels.check_launch("compact_sweep (first design)", err)
    return CP.CompactedSweep(o_ks, o_kd, o_fu, o_fv, o_valid, o_z)


def geo_warp_fwd_first(vpx, vpy, vz, qi0, qj0, uvx, uvy, mpi_hw):
    """K20's first design, one thread a sample searching its 3 x 3 quads
    from global memory (csrc/geo_warp.cu:vl3d_geo_warp_fwd_first), with
    `render.geo_warp.geo_warp_fwd`'s arguments: (x, y, z, valid, tri)."""
    B, D, Hv, Wv = vpx.shape
    h, w = qi0.shape[2:]
    dev = vpx.device
    x, y, z = (torch.empty(qi0.shape, dtype=torch.float32, device=dev)
               for _ in range(3))
    valid = torch.empty(qi0.shape, dtype=torch.bool, device=dev)
    tri = torch.empty(qi0.shape, dtype=torch.int8, device=dev)
    mpi_h, mpi_w = mpi_hw
    err = kernels.library().vl3d_geo_warp_fwd_first(
        vpx.data_ptr(), vpy.data_ptr(), vz.data_ptr(), qi0.data_ptr(),
        qj0.data_ptr(), uvx.data_ptr(), uvy.data_ptr(), B, D, h, w, Hv, Wv,
        float(mpi_w - 1), float(mpi_h - 1), x.data_ptr(), y.data_ptr(),
        z.data_ptr(), valid.data_ptr(), tri.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check_launch("geo_warp_fwd (first design)", err)
    return x, y, z, valid, tri


def geo_warp_bwd_first(gx, gy, gz, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy):
    """K21's first design, one thread a sample adding its 9 values with
    global atomics into a zero-filled buffer (csrc/geo_warp.cu:
    vl3d_geo_warp_bwd_first; the zero fill included), with
    `render.geo_warp.geo_warp_bwd`'s arguments: (d_vpx, d_vpy, d_vz)."""
    B, D, Hv, Wv = vpx.shape
    h, w = qi0.shape[2:]
    grads = [torch.zeros_like(vpx) for _ in range(3)]
    err = kernels.library().vl3d_geo_warp_bwd_first(
        gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), vpx.data_ptr(),
        vpy.data_ptr(), vz.data_ptr(), qi0.data_ptr(), qj0.data_ptr(),
        tri.data_ptr(), uvx.data_ptr(), uvy.data_ptr(), B, D, h, w, Hv, Wv,
        *(g.data_ptr() for g in grads), kernels.stream_ptr(vpx.device))
    kernels.check_launch("geo_warp_bwd (first design)", err)
    return tuple(grads)
