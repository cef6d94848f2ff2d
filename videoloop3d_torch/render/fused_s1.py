"""Stage-1 fused decode + composite + loop-mask composite + regularizers:
kernels K7 `fused_s1_fwd` and K8 `fused_s1_bwd` (``csrc/fused_s1.cu``)
and their plain versions.

Counterpart of ``videoloop3d_tpu/render/fused_s1.py:fused_composite_s1``
(``--fused_render``).  On the shipped decoder (direct texels, sigmoid rgb
and alpha) it computes, over planes stored far first, the near -> far
over-composite, the alpha sum, the optional disparity, the loop-mask
composite with the alpha detached (ref MPI.py:578) and the sparsity /
rgb-smooth / a-smooth / l-smooth regularizers, as one
`torch.autograd.Function` whose backward is the JAX package's two-sweep
VJP (sweep A recomputes decode and incoming transmittance near -> far;
sweep B is the division-free reverse composite far -> near:
``da_i = T_in[i] (g_i - dT);  dT <- a_i g_i + (1 - a_i) dT``).

The VJP returns no gradient for ``valid`` and ``dinv`` (the per-plane
normalized disparity derives from camera geometry; the model detaches
it).  On CPU tensors the Function runs `fused_composite_s1_plain_fwd` and
`fused_composite_s1_plain_bwd`; on CUDA tensors it launches K7 and K8.
Both run on 16 x 8 pixel tiles, K7 with the one-sided halo the forward
reads (`fused_s1_fwd_layout`), K8 with a one-pixel halo
(`fused_s1_bwd_layout`): each (plane, tile or halo pixel) decoded once a
pass into shared memory, K8's T_in kept there; the bits of their first
designs (one thread a pixel, ``first_designs.fused_s1_fwd_first`` and
``fused_s1_bwd_first``).
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from videoloop3d_torch import kernels


@dataclass(frozen=True)
class FusedS1Cfg:
    n_planes: int
    use_sparsity: bool
    use_rgb_smooth: bool
    use_a_smooth: bool
    use_l_smooth: bool
    use_loop: bool                # mask_feats is real, composite a label
    want_disp: bool
    sp_eps: float = 1e-6

    def flags(self):
        """The kernels' flag bits (see ``csrc/fused_s1.cu``)."""
        return (int(self.use_sparsity) | int(self.use_rgb_smooth) << 1
                | int(self.use_a_smooth) << 2 | int(self.use_l_smooth) << 3
                | int(self.use_loop) << 4 | int(self.want_disp) << 5)


REG_NAMES = ("sparsity", "rgb_smooth", "a_smooth", "l_smooth")


def _norms(cfg, B, D, h, w):
    """The regularizers' element counts, as the JAX module divides by
    them."""
    return dict(n_pix=B * h * w, sqrt_planes=math.sqrt(cfg.n_planes),
                n_rgb_dx=B * D * h * (w - 1) * 3,
                n_rgb_dy=B * D * (h - 1) * w * 3,
                n_dx=B * D * h * (w - 1), n_dy=B * D * (h - 1) * w)


def _decode_plane(feats, valid, s):
    """Per-plane decoded rgb (B, h, w, 3), alpha (B, h, w) and the
    sigmoid (B, h, w, 4): rgb = sigmoid(:3) * valid,
    alpha = where(valid, sigmoid(3), 0)."""
    sig = torch.sigmoid(feats[:, s].float())
    v = valid[:, s]
    rgb = sig[..., :3] * v[..., None]
    alpha = torch.where(v, sig[..., 3], 0.0)
    return rgb, alpha, sig


def _smooth_sums(x):
    """sum |diff| along w (axis 2) and along h (axis 1) of (B, h, w, ...)."""
    dx = torch.sum(torch.abs(torch.diff(x, dim=2)))
    dy = torch.sum(torch.abs(torch.diff(x, dim=1)))
    return dx, dy


def _smooth_grad(x, g_dx, g_dy):
    """d/dx of sum|diff_w(x)| g_dx + sum|diff_h(x)| g_dy (x (B, h, w, ...))."""
    def spread(s, axis):
        lo = [0, 0] * (x.dim() - 1 - axis) + [1, 0]
        hi = [0, 0] * (x.dim() - 1 - axis) + [0, 1]
        return (torch.nn.functional.pad(s, lo)
                - torch.nn.functional.pad(s, hi))

    sx = torch.sign(torch.diff(x, dim=2))
    sy = torch.sign(torch.diff(x, dim=1))
    return g_dx * spread(sx, 2) + g_dy * spread(sy, 1)


def fused_composite_s1_plain_fwd(cfg: FusedS1Cfg, feats, valid, mask_feats,
                                 dinv):
    """Plain version of K7.  feats (B, D, h, w, 4) raw atlas samples;
    valid (B, D, h, w) bool; mask_feats (B, D, h, w) raw loop-mask samples
    or None (read iff cfg.use_loop); dinv (B, D, h, w) or None (read iff
    cfg.want_disp).  Returns out (B, h, w, 3), alpha_sum (B, h, w),
    disp (B, h, w), label (B, h, w, 1) and regs (4,) =
    [sparsity, rgb_smooth, a_smooth, l_smooth]; terms that are off are 0.
    """
    B, D, h, w, C = feats.shape
    f32 = dict(dtype=torch.float32, device=feats.device)
    T = torch.ones((B, h, w), **f32)
    out = torch.zeros((B, h, w, 3), **f32)
    asum = torch.zeros((B, h, w), **f32)
    disp = torch.zeros((B, h, w), **f32)
    label = torch.zeros((B, h, w), **f32)
    sp_l1 = torch.zeros((B, h, w), **f32)
    sp_l2sq = torch.zeros((B, h, w), **f32)
    zero = torch.zeros((), **f32)
    rs_dx = rs_dy = as_dx = as_dy = ls_dx = ls_dy = zero
    for s in range(D - 1, -1, -1):          # near -> far
        rgb, alpha, _ = _decode_plane(feats, valid, s)
        bw = alpha * T
        out = out + rgb * bw[..., None]
        asum = asum + bw
        if cfg.want_disp:
            disp = disp + dinv[:, s] * bw
        if cfg.use_loop:
            lp = torch.where(valid[:, s], torch.sigmoid(mask_feats[:, s]),
                             0.0)
            label = label + lp * bw
            if cfg.use_l_smooth:
                dx, dy = _smooth_sums(lp)
                ls_dx, ls_dy = ls_dx + dx, ls_dy + dy
        T = T * (1.0 - alpha)
        if cfg.use_sparsity:
            sp_l1 = sp_l1 + torch.abs(alpha)
            sp_l2sq = sp_l2sq + alpha * alpha
        if cfg.use_rgb_smooth:
            dx, dy = _smooth_sums(rgb)
            rs_dx, rs_dy = rs_dx + dx, rs_dy + dy
        if cfg.use_a_smooth:
            dx, dy = _smooth_sums(alpha)
            as_dx, as_dy = as_dx + dx, as_dy + dy

    n = _norms(cfg, B, D, h, w)
    regs = [zero] * 4
    if cfg.use_sparsity:
        l2 = torch.sqrt(sp_l2sq).clamp(min=cfg.sp_eps)
        regs[0] = torch.mean(sp_l1 / l2) / n["sqrt_planes"]
    if cfg.use_rgb_smooth:
        regs[1] = rs_dx / n["n_rgb_dx"] + rs_dy / n["n_rgb_dy"]
    if cfg.use_a_smooth:
        regs[2] = as_dx / n["n_dx"] + as_dy / n["n_dy"]
    if cfg.use_loop and cfg.use_l_smooth:
        regs[3] = ls_dx / n["n_dx"] + ls_dy / n["n_dy"]
    return out, asum, disp, label[..., None], torch.stack(regs)


def fused_composite_s1_plain_bwd(cfg: FusedS1Cfg, feats, valid, mask_feats,
                                 dinv, g_out, g_asum, g_disp, g_label,
                                 g_regs):
    """Plain version of K8: the JAX package's VJP (fused_s1.py:150-244).
    g_regs (4,) are the cotangents of [sparsity, rgb_smooth, a_smooth,
    l_smooth].  Returns (d_feats (B, D, h, w, 4), d_mask (B, D, h, w) or
    None)."""
    B, D, h, w, C = feats.shape
    f32 = dict(dtype=torch.float32, device=feats.device)
    n = _norms(cfg, B, D, h, w)
    zero = torch.zeros((), **f32)
    g_sp = g_regs[0] if cfg.use_sparsity else zero
    g_rs_dx = g_rs_dy = g_as_dx = g_as_dy = g_ls_dx = g_ls_dy = zero
    if cfg.use_rgb_smooth:
        g_rs_dx = g_regs[1] / n["n_rgb_dx"]
        g_rs_dy = g_regs[1] / n["n_rgb_dy"]
    if cfg.use_a_smooth:
        g_as_dx = g_regs[2] / n["n_dx"]
        g_as_dy = g_regs[2] / n["n_dy"]
    if cfg.use_loop and cfg.use_l_smooth:
        g_ls_dx = g_regs[3] / n["n_dx"]
        g_ls_dy = g_regs[3] / n["n_dy"]
    g_lab = g_label[..., 0] if cfg.use_loop else None

    # sweep A (near -> far): recompute decode + incoming transmittance
    rgbs, alphas, sigs, T_in = [None] * D, [None] * D, [None] * D, [None] * D
    T = torch.ones((B, h, w), **f32)
    sp_l1 = torch.zeros((B, h, w), **f32)
    sp_l2sq = torch.zeros((B, h, w), **f32)
    for s in range(D - 1, -1, -1):
        rgbs[s], alphas[s], sigs[s] = _decode_plane(feats, valid, s)
        T_in[s] = T
        T = T * (1.0 - alphas[s])
        if cfg.use_sparsity:
            sp_l1 = sp_l1 + torch.abs(alphas[s])
            sp_l2sq = sp_l2sq + alphas[s] * alphas[s]

    if cfg.use_sparsity:
        l2 = torch.sqrt(sp_l2sq)
        l2c = l2.clamp(min=cfg.sp_eps)
        scale = g_sp / (n["n_pix"] * n["sqrt_planes"])
        sp_a_coef = scale / l2c                          # * sign(a_i)
        sp_b_coef = torch.where(
            l2 >= cfg.sp_eps,
            scale * sp_l1 / (l2c * l2c * l2.clamp(min=cfg.sp_eps)),
            0.0)                                         # * a_i

    # sweep B (far -> near): division-free composite cotangents
    d_feats = [None] * D
    d_mask = [None] * D
    dT = torch.zeros((B, h, w), **f32)
    for s in range(D):
        rgb, alpha, sig = rgbs[s], alphas[s], sigs[s]
        v = valid[:, s]
        g_i = torch.sum(rgb * g_out, dim=-1) + g_asum
        if cfg.want_disp:
            g_i = g_i + dinv[:, s] * g_disp
        bw = alpha * T_in[s]
        da = T_in[s] * (g_i - dT)
        dT = alpha * g_i + (1.0 - alpha) * dT
        d_rgb = bw[..., None] * g_out
        if cfg.use_sparsity:
            da = da + sp_a_coef * torch.sign(alpha) - sp_b_coef * alpha
        if cfg.use_rgb_smooth:
            d_rgb = d_rgb + _smooth_grad(rgb, g_rs_dx, g_rs_dy)
        if cfg.use_a_smooth:
            da = da + _smooth_grad(alpha, g_as_dx, g_as_dy)
        d_feats[s] = torch.cat([
            d_rgb * v[..., None] * (sig[..., :3] * (1.0 - sig[..., :3])),
            (torch.where(v, da, 0.0) * sig[..., 3]
             * (1.0 - sig[..., 3]))[..., None]], dim=-1)
        if cfg.use_loop:
            lsig = torch.sigmoid(mask_feats[:, s])
            d_lp = g_lab * bw
            if cfg.use_l_smooth:
                lp = torch.where(v, lsig, 0.0)
                d_lp = d_lp + _smooth_grad(lp, g_ls_dx, g_ls_dy)
            d_mask[s] = torch.where(v, d_lp, 0.0) * lsig * (1.0 - lsig)
    d_mask_out = torch.stack(d_mask, dim=1) if cfg.use_loop else None
    return torch.stack(d_feats, dim=1), d_mask_out


def _check_inputs(name, cfg, feats, valid, mask_feats, dinv):
    dev = feats.device
    kernels.check_tensor(f"{name}.feats", feats, dev, dtype=torch.float32)
    if feats.dim() != 5 or feats.shape[-1] != 4:
        raise ValueError(f"{name}.feats: shape {tuple(feats.shape)}, "
                         "expected (B, D, h, w, 4)")
    B, D, h, w, _ = feats.shape
    if D != cfg.n_planes:
        raise ValueError(f"{name}: {D} planes, cfg.n_planes {cfg.n_planes}")
    kernels.check_tensor(f"{name}.valid", valid, dev, dtype=torch.bool,
                         shape=(B, D, h, w))
    for nm, t, on in (("mask_feats", mask_feats, cfg.use_loop),
                      ("dinv", dinv, cfg.want_disp)):
        if on:
            kernels.check_tensor(f"{name}.{nm}", t, dev,
                                 dtype=torch.float32, shape=(B, D, h, w))
    if dev.type == "cuda" and feats.data_ptr() % 16:
        raise ValueError(f"{name}.feats: not 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


# K7's pixel tile (K8's, csrc/fused_s1.cu:kTw, kTh), one thread a pixel,
# with the one-sided halo the forward reads (the column to the right, the
# row below) decoded by one warp of ring threads; the layout's keys
FWD_TILE_W, FWD_TILE_H = 16, 8
# K7's planes staged between two barriers (csrc/fused_s1.cu:kFwdPlanes)
FWD_PLANES = 2
FUSED_S1_FWD_LAYOUT_KEYS = ("tile_w", "tile_h", "halo", "threads", "smem")


def fused_s1_fwd_layout(D):
    """K7's layout for D planes (csrc/fused_s1.cu:fwd_layout): a block's
    `tile_w` x `tile_h` pixels, one thread each, and the `halo` entries
    staged a plane (the tile with the column to its right and the row
    below it; the corner unused), whose ring takes one more warp:
    `threads` in all; `smem`, the block's shared bytes: two buffers of
    FWD_PLANES staged planes' rgba (float4) and loop probability (float)
    at each entry.  The forward keeps no per-plane state, so D has no
    upper limit; raises for D < 1."""
    if D < 1:
        raise ValueError(f"fused_s1_fwd: at least 1 plane, got {D}")
    pixels = FWD_TILE_W * FWD_TILE_H
    halo = (FWD_TILE_W + 1) * (FWD_TILE_H + 1)
    ring_threads = -(-(FWD_TILE_W + FWD_TILE_H) // 32) * 32
    return dict(tile_w=FWD_TILE_W, tile_h=FWD_TILE_H, halo=halo,
                threads=pixels + ring_threads,
                smem=(16 + 4) * 2 * FWD_PLANES * halo)


def kernel_fused_s1_fwd_layout(D):
    """K7's layout as csrc/fused_s1.cu computes it
    (vl3d_fused_s1_fwd_layout; needs the CUDA library), keyed as
    `fused_s1_fwd_layout`; None where the kernel refuses D."""
    out = (ctypes.c_longlong * len(FUSED_S1_FWD_LAYOUT_KEYS))()
    if kernels.library().vl3d_fused_s1_fwd_layout(D, out):
        return None
    return dict(zip(FUSED_S1_FWD_LAYOUT_KEYS, out))


def launch_fwd(entry, cfg, feats, valid, mask_feats, dinv):
    """Call the library's `entry` (vl3d_fused_s1_fwd or its first design)
    on K7's checked inputs on the card.  Returns (out, asum, disp, label, regs)."""
    B, D, h, w, _ = feats.shape
    dev = feats.device
    fused_s1_fwd_layout(D)
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B, h, w, 3), **f32)
    asum = torch.empty((B, h, w), **f32)
    disp = torch.empty((B, h, w), **f32)
    label = torch.empty((B, h, w, 1), **f32)
    # the redesign's pixels' sums (7, B h w) and its tree's ticket word;
    # the first design takes none
    pix = None if entry.endswith("_first") else torch.empty(
        7 * B * h * w + 1, **f32)
    partials = torch.empty((kernels.partial_rows(B * h * w), 7), **f32)
    regs = torch.zeros((4,), **f32)
    n = _norms(cfg, B, D, h, w)
    err = getattr(kernels.library(), entry)(
        feats.data_ptr(), valid.data_ptr(),
        _ptr(mask_feats if cfg.use_loop else None),
        _ptr(dinv if cfg.want_disp else None), B, D, h, w, cfg.flags(),
        cfg.sp_eps, float(n["n_pix"]), n["sqrt_planes"], float(n["n_rgb_dx"]),
        float(n["n_rgb_dy"]), float(n["n_dx"]), float(n["n_dy"]),
        out.data_ptr(), asum.data_ptr(), disp.data_ptr(), label.data_ptr(),
        *(() if pix is None else (pix.data_ptr(),)), partials.data_ptr(),
        regs.data_ptr(), kernels.stream_ptr(dev))
    kernels.check_launch(entry, err)
    return out, asum, disp, label, regs


def fused_s1_fwd(cfg, feats, valid, mask_feats, dinv):
    """K7 without autograd: `fused_composite_s1_plain_fwd`'s outputs for
    gradient-free inputs (the plain version on CPU tensors).  On the card
    a block owns a pixel tile and decodes each (plane, tile or halo pixel)
    once into shared memory (`fused_s1_fwd_layout`); each pixel's
    regularizer sums are reduced by the first design's tree: its bits
    (`first_designs.fused_s1_fwd_first`)."""
    _check_inputs("fused_s1_fwd", cfg, feats, valid, mask_feats, dinv)
    if feats.device.type == "cpu":
        return fused_composite_s1_plain_fwd(cfg, feats, valid, mask_feats,
                                            dinv)
    outs = launch_fwd("vl3d_fused_s1_fwd", cfg, feats, valid, mask_feats,
                      dinv)
    kernels.LAUNCHES["fused_s1_fwd"] += 1
    return outs


# K8's pixel tile (csrc/fused_s1.cu:kTw, kTh), one thread a pixel, with a
# one-pixel halo decoded by whole warps of ring threads; the plane limit;
# the layout's keys
BWD_TILE_W, BWD_TILE_H = 16, 8
BWD_MAX_PLANES = 128
FUSED_S1_BWD_LAYOUT_KEYS = ("tile_w", "tile_h", "halo", "threads", "smem")


def fused_s1_bwd_layout(D):
    """K8's layout for D planes (csrc/fused_s1.cu:bwd_layout): a block's
    `tile_w` x `tile_h` pixels, one thread each, and the ring of its
    `halo` (the tile with a one-pixel border) decoded by the warps after
    them: `threads` in all; `smem`, the block's dynamic shared bytes: two
    staged planes' rgba (float4) and loop probability (float) at each halo
    pixel, and T_in [D][tile pixels] (float).  Raises beyond 1 <= D <=
    128."""
    if not 1 <= D <= BWD_MAX_PLANES:
        raise ValueError(f"fused_s1_bwd: 1 to {BWD_MAX_PLANES} planes, "
                         f"got {D}")
    pixels = BWD_TILE_W * BWD_TILE_H
    halo = (BWD_TILE_W + 2) * (BWD_TILE_H + 2)
    ring_threads = -(-(halo - pixels) // 32) * 32
    return dict(tile_w=BWD_TILE_W, tile_h=BWD_TILE_H, halo=halo,
                threads=pixels + ring_threads,
                smem=(16 + 4) * 2 * halo + 4 * D * pixels)


def kernel_fused_s1_bwd_layout(D):
    """K8's layout as csrc/fused_s1.cu computes it
    (vl3d_fused_s1_bwd_layout; needs the CUDA library), keyed as
    `fused_s1_bwd_layout`; None where the kernel refuses D."""
    out = (ctypes.c_longlong * len(FUSED_S1_BWD_LAYOUT_KEYS))()
    if kernels.library().vl3d_fused_s1_bwd_layout(D, out):
        return None
    return dict(zip(FUSED_S1_BWD_LAYOUT_KEYS, out))


def launch_bwd(entry, cfg, feats, valid, mask_feats, dinv, g_out, g_asum,
               g_disp, g_label, g_regs):
    """Check K8's inputs on the card and call the library's `entry`
    (vl3d_fused_s1_bwd or its first design) on them.  Returns (d_feats,
    d_mask or None)."""
    B, D, h, w, _ = feats.shape
    dev = feats.device
    fused_s1_bwd_layout(D)
    grads = (("g_out", g_out, (B, h, w, 3)), ("g_asum", g_asum, (B, h, w)),
             ("g_disp", g_disp, (B, h, w)), ("g_label", g_label, (B, h, w, 1)),
             ("g_regs", g_regs, (4,)))
    for nm, t, shape in grads:
        kernels.check_tensor(f"fused_s1_bwd.{nm}", t, dev,
                             dtype=torch.float32, shape=shape)
    d_feats = torch.empty_like(feats)
    d_mask = torch.empty((B, D, h, w), dtype=torch.float32, device=dev) \
        if cfg.use_loop else None
    n = _norms(cfg, B, D, h, w)
    err = getattr(kernels.library(), entry)(
        feats.data_ptr(), valid.data_ptr(),
        _ptr(mask_feats if cfg.use_loop else None),
        _ptr(dinv if cfg.want_disp else None), g_out.data_ptr(),
        g_asum.data_ptr(), g_disp.data_ptr(), g_label.data_ptr(),
        g_regs.data_ptr(), B, D, h, w, cfg.flags(), cfg.sp_eps,
        float(n["n_pix"] * n["sqrt_planes"]), float(n["n_rgb_dx"]),
        float(n["n_rgb_dy"]), float(n["n_dx"]), float(n["n_dy"]),
        d_feats.data_ptr(), _ptr(d_mask), kernels.stream_ptr(dev))
    kernels.check_launch(entry, err)
    return d_feats, d_mask


def fused_s1_bwd(cfg, feats, valid, mask_feats, dinv, g_out, g_asum, g_disp,
                 g_label, g_regs):
    """K8: `fused_composite_s1_plain_bwd` for contiguous cotangents (the
    plain version on CPU tensors).  On the card a block owns a pixel
    tile, decodes each (plane, tile or halo pixel) once a pass into
    shared memory and keeps T_in there (`fused_s1_bwd_layout`; at most
    128 planes): the first design's bits.  Returns (d_feats, d_mask or
    None)."""
    if feats.device.type == "cpu":
        return fused_composite_s1_plain_bwd(cfg, feats, valid, mask_feats,
                                            dinv, g_out, g_asum, g_disp,
                                            g_label, g_regs)
    out = launch_bwd("vl3d_fused_s1_bwd", cfg, feats, valid, mask_feats,
                     dinv, g_out, g_asum, g_disp, g_label, g_regs)
    kernels.LAUNCHES["fused_s1_bwd"] += 1
    return out


class _FusedS1(torch.autograd.Function):
    """K7 forward and K8 backward on CUDA tensors, the plain versions on
    CPU tensors.  Saves only the raw inputs for the backward."""

    @staticmethod
    def forward(ctx, cfg, feats, valid, mask_feats, dinv):
        feats = feats.detach()
        mask_feats = None if mask_feats is None else mask_feats.detach()
        ctx.cfg = cfg
        ctx.save_for_backward(feats, valid, mask_feats, dinv)
        return fused_s1_fwd(cfg, feats, valid, mask_feats, dinv)

    @staticmethod
    def backward(ctx, g_out, g_asum, g_disp, g_label, g_regs):
        feats, valid, mask_feats, dinv = ctx.saved_tensors
        grads = [t.contiguous() for t in (g_out, g_asum, g_disp, g_label,
                                          g_regs)]
        d_feats, d_mask = fused_s1_bwd(ctx.cfg, feats, valid, mask_feats,
                                       dinv, *grads)
        return None, d_feats, None, d_mask, None


def fused_composite_s1(cfg: FusedS1Cfg, feats, valid, mask_feats=None,
                       dinv=None):
    """K7/K8: the fused stage-1 decode + composite + regularizers.

    feats (B, D, h, w, 4) f32 raw atlas samples; valid (B, D, h, w) bool;
    mask_feats (B, D, h, w) f32 raw loop-mask samples (required iff
    cfg.use_loop); dinv (B, D, h, w) f32 per-plane normalized disparity
    (required iff cfg.want_disp; gets no gradient).  Differentiable in
    feats and mask_feats.

    Returns (out (B, h, w, 3), alpha_sum (B, h, w), disp (B, h, w) or
    None, label (B, h, w, 1) or None, regs {name: scalar} for the terms
    that are on) — the JAX function's outputs.
    """
    return select_outputs(cfg, *_FusedS1.apply(cfg, feats, valid,
                                               mask_feats, dinv))


def select_outputs(cfg: FusedS1Cfg, out, asum, disp, label, regs):
    """The five outputs of K7 / the plain forward in the JAX function's
    form: None for the disparity and label that are off, and the
    regularizers that are on as a {name: scalar} dict."""
    on = (cfg.use_sparsity, cfg.use_rgb_smooth, cfg.use_a_smooth,
          cfg.use_loop and cfg.use_l_smooth)
    reg = {k: regs[i] for i, k in enumerate(REG_NAMES) if on[i]}
    return (out, asum, disp if cfg.want_disp else None,
            label if cfg.use_loop else None, reg)
