"""Decode + static/dynamic select + over-composite (counterpart of
``videoloop3d_tpu/render/fused.py``): three kernels, each beside its plain
version.

* K4 `composite` (``csrc/composite.cu``): the eval render's forward, with
  the regularizer sums and the disparity off; a block owns a run of
  pixels and all frames (`composite_layout`): each static sample decoded
  once into a shared table, the dynamic and the live static planes (those
  that do not decode to exact zeros) as bit words, then one thread per
  (pixel, frame) walks those planes near to far, bit for bit the first
  design's per-(pixel, frame) loop over every plane.
* K14 `fused_s2_fwd` and K15 `fused_s2_bwd` (``csrc/fused_s2.cu``, both
  on a pixel tile with a halo that walks the frames in chunks,
  `fused_s2_fwd_layout` and `fused_s2_bwd_layout`): the
  stage-2 training route's `fused_composite` (``--fused_render``), the
  JAX function as one `torch.autograd.Function`: decode, select,
  composite, the sparsity / rgb-smooth / a-smooth sums and the disparity
  forward, and the JAX package's two-sweep VJP backward (sweep A
  recomputes decode and incoming transmittance near -> far; sweep B is
  the division-free reverse composite far -> near:
  ``da_i = T_in[i] (g_i - dT);  dT <- a_i g_i + (1 - a_i) dT``).

All three work on the shipped decoder (direct texels, sigmoid rgb and
alpha) over S slots stored far first (S = D planes, or the compacted
slots of ``render/compact.py``).  The composite is the sequential
near -> far product
    bw = a * T,  out += rgb * bw,  alpha_sum += bw,  T *= 1 - a;
it equals the unfused chain's cumprod (``renderer.composite_planes``) up
to float reassociation.  The VJP returns no gradient for the masks or
``dinv`` (the per-slot masked reciprocal depth derives from camera
geometry; the model computes it without gradient).  On CPU tensors the
wrappers run the plain versions; on CUDA tensors they launch the kernels.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from videoloop3d_torch import kernels


def composite_plain(vals_s, m_s, vals_d, hit_d, m_d):
    """Plain version of K4.

    vals_s (S, h, w, C), vals_d (S, h, w, F, C) raw texel samples (C = 4,
    f32); m_s, hit_d, m_d (S, h, w) bool.  Returns out (h, w, F, 3) and
    alpha_sum (h, w, F), f32.
    """
    S, h, w, F, C = vals_d.shape
    f32 = dict(dtype=torch.float32, device=vals_d.device)
    T = torch.ones((h, w, F), **f32)
    out = torch.zeros((h, w, F, 3), **f32)
    asum = torch.zeros((h, w, F), **f32)
    for s in range(S - 1, -1, -1):          # near -> far
        sig_d = torch.sigmoid(vals_d[s].float())            # (h, w, F, C)
        sig_s = torch.sigmoid(vals_s[s].float())            # (h, w, C)
        md, ms, hd = m_d[s][..., None], m_s[s][..., None], hit_d[s][..., None]
        rgb_d = sig_d[..., :3] * md[..., None]
        a_d = torch.where(md, sig_d[..., 3], 0.0)
        rgb_s = sig_s[..., :3] * ms
        a_s = torch.where(m_s[s], sig_s[..., 3], 0.0)
        rgb = torch.where(hd[..., None], rgb_d, rgb_s[..., None, :])
        alpha = torch.where(hd, a_d, a_s[..., None])
        bw = alpha * T
        out = out + rgb * bw[..., None]
        asum = asum + bw
        T = T * (1.0 - alpha)
    return out, asum


# K4's layout, mirrored by csrc/composite.cu:composite_layout
_K4_TABLE = 2048               # decoded static samples a block (32 KB)
_K4_MAX_PIX = 32               # pixels a block
_K4_MIN_THREADS = 128
_K4_MAX_THREADS = 512
K4_MAX_PLANES = _K4_TABLE      # at least one pixel a block
K4_BATCH = 4                   # stage 1: samples a thread loads at once
K4_BUF = 4                     # stage 2: hit samples a thread loads at once


def composite_layout(D, F):
    """K4's layout for D planes and F frames, as a dict: `pix` pixels a
    block (as many as keep the shared table of their D decoded static
    samples within _K4_TABLE entries, at most _K4_MAX_PIX), `words` bit
    words a pixel (hit_d, m_d and the live static planes, 32 planes a
    word), `threads` a block (pix * F rounded to warps, _K4_MIN_THREADS
    to _K4_MAX_THREADS; stage 1 strides them over the pix * D (plane,
    pixel) pairs, K4_BATCH at a time, stage 2 over the pix * F (pixel,
    frame) pairs) and `smem` dynamic shared bytes (the float4 table, then
    the three bit arrays)."""
    pix = 0 if D > _K4_TABLE else min(_K4_TABLE // D, _K4_MAX_PIX)
    words = -(-D // 32)
    threads = min(max(-(-(pix * F) // 32) * 32, _K4_MIN_THREADS),
                  _K4_MAX_THREADS)
    return dict(pix=pix, words=words, threads=threads,
                smem=16 * pix * D + 12 * pix * words)


COMPOSITE_LAYOUT_KEYS = ("pix", "words", "threads", "smem")


def kernel_composite_layout(D, F):
    """K4's layout as csrc/composite.cu computes it (vl3d_composite_layout;
    needs the CUDA library), keyed as `composite_layout`."""
    out = (ctypes.c_longlong * len(COMPOSITE_LAYOUT_KEYS))()
    kernels.library().vl3d_composite_layout(D, F, out)
    return dict(zip(COMPOSITE_LAYOUT_KEYS, out))


def check_composite_inputs(vals_s, m_s, vals_d, hit_d, m_d):
    """Raise unless the stacks are K4's: contiguous f32 samples (C = 4;
    16-byte aligned on the card) and bool masks on one device, at most
    K4_MAX_PLANES planes.  Returns (S, h, w, F, C)."""
    dev = vals_d.device
    kernels.check_tensor("composite.vals_d", vals_d, dev, dtype=torch.float32)
    if vals_d.dim() != 5 or vals_d.shape[-1] != 4:
        raise ValueError(f"composite.vals_d: shape {tuple(vals_d.shape)}, "
                         "expected (S, h, w, F, 4)")
    S, h, w, F, C = vals_d.shape
    if S > K4_MAX_PLANES:
        raise ValueError(f"composite: {S} planes, limit {K4_MAX_PLANES}")
    kernels.check_tensor("composite.vals_s", vals_s, dev, dtype=torch.float32,
                         shape=(S, h, w, C))
    for name, m in (("m_s", m_s), ("hit_d", hit_d), ("m_d", m_d)):
        kernels.check_tensor(f"composite.{name}", m, dev, dtype=torch.bool,
                             shape=(S, h, w))
    for name, t in (("vals_s", vals_s), ("vals_d", vals_d)):
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"composite.{name}: not 16-byte aligned")
    return S, h, w, F, C


def composite(vals_s, m_s, vals_d, hit_d, m_d):
    """K4: decode, select and composite the sampled plane stacks.  Same
    arguments and results as `composite_plain`; inputs must be contiguous
    f32 samples (16-byte aligned on the card) and bool masks on one
    device, at most K4_MAX_PLANES planes."""
    dev = vals_d.device
    S, h, w, F, C = check_composite_inputs(vals_s, m_s, vals_d, hit_d, m_d)
    if dev.type == "cpu":
        return composite_plain(vals_s, m_s, vals_d, hit_d, m_d)
    out = torch.empty((h, w, F, 3), dtype=torch.float32, device=dev)
    asum = torch.empty((h, w, F), dtype=torch.float32, device=dev)
    err = kernels.library().vl3d_composite(
        vals_s.data_ptr(), vals_d.data_ptr(), m_s.data_ptr(),
        hit_d.data_ptr(), m_d.data_ptr(), S, h * w, F, C, out.data_ptr(),
        asum.data_ptr(), kernels.stream_ptr(dev))
    kernels.LAUNCHES["composite"] += 1
    kernels.check_launch("composite", err)
    return out, asum


@dataclass(frozen=True)
class FusedCfg:
    """The JAX package's ``FusedCfg`` (``render/fused.py:48``)."""
    n_planes: int                 # sparsity normalization (mpi_d)
    use_sparsity: bool
    use_rgb_smooth: bool
    use_a_smooth: bool
    want_disp: bool
    sp_eps: float = 1e-4

    def flags(self):
        """The kernels' flag bits (see ``csrc/fused_s2.cu``)."""
        return (int(self.use_sparsity) | int(self.use_rgb_smooth) << 1
                | int(self.use_a_smooth) << 2 | int(self.want_disp) << 3)


REG_NAMES = ("sparsity", "rgb_smooth", "a_smooth")


def _norms(cfg, S, h, w, F):
    """The regularizers' element counts, as the JAX module divides by
    them (the smooth sums by the slot count S, the sparsity by
    sqrt(mpi_d))."""
    return dict(n_pix=h * w * F, sqrt_planes=math.sqrt(cfg.n_planes),
                n_rgb_dx=S * h * (w - 1) * F * 3,
                n_rgb_dy=S * (h - 1) * w * F * 3,
                n_dx=S * h * (w - 1) * F, n_dy=S * (h - 1) * w * F)


def _decode_slot(vals_s, m_s, vals_d, hit_d, m_d, s):
    """Slot s's decoded rgb (h, w, F, 3) and alpha (h, w, F) after the
    static/dynamic select, and the sigmoids before the masks (dynamic
    (h, w, F, 4), static (h, w, 4))."""
    sig_d = torch.sigmoid(vals_d[s].float())
    sig_s = torch.sigmoid(vals_s[s].float())
    md = m_d[s][..., None]                              # (h, w, 1)
    rgb_d = sig_d[..., :3] * md[..., None]
    a_d = torch.where(md, sig_d[..., 3], 0.0)
    rgb_s = sig_s[..., :3] * m_s[s][..., None]
    a_s = torch.where(m_s[s], sig_s[..., 3], 0.0)
    hd = hit_d[s][..., None]
    rgb = torch.where(hd[..., None], rgb_d, rgb_s[..., None, :])
    alpha = torch.where(hd, a_d, a_s[..., None])
    return rgb, alpha, sig_d, sig_s


def _smooth_sums(x):
    """sum |diff| along w (axis 1) and along h (axis 0) of (h, w, ...)."""
    return (torch.sum(torch.abs(torch.diff(x, dim=1))),
            torch.sum(torch.abs(torch.diff(x, dim=0))))


def _smooth_grad(x, g_dx, g_dy):
    """d/dx of sum|diff_w(x)| g_dx + sum|diff_h(x)| g_dy (x (h, w, ...))."""
    def spread(s, axis):
        lo = [0, 0] * (x.dim() - 1 - axis) + [1, 0]
        hi = [0, 0] * (x.dim() - 1 - axis) + [0, 1]
        return (torch.nn.functional.pad(s, lo)
                - torch.nn.functional.pad(s, hi))

    return (g_dx * spread(torch.sign(torch.diff(x, dim=1)), 1)
            + g_dy * spread(torch.sign(torch.diff(x, dim=0)), 0))


def fused_composite_fwd_plain(cfg: FusedCfg, vals_s, m_s, vals_d, hit_d,
                              m_d, dinv):
    """Plain version of K14 (the JAX package's ``_fused_fwd``).

    vals_s (S, h, w, 4) and vals_d (S, h, w, F, 4) raw texel samples;
    m_s, hit_d, m_d (S, h, w) bool; dinv (S, h, w) f32 or None (read iff
    cfg.want_disp).  Returns out (h, w, F, 3), alpha_sum (h, w, F),
    disp (h, w, F) and regs (3,) = [sparsity, rgb_smooth, a_smooth];
    terms that are off are 0."""
    S, h, w, F, C = vals_d.shape
    f32 = dict(dtype=torch.float32, device=vals_d.device)
    T = torch.ones((h, w, F), **f32)
    out = torch.zeros((h, w, F, 3), **f32)
    asum = torch.zeros((h, w, F), **f32)
    disp = torch.zeros((h, w, F), **f32)
    sp_l1 = torch.zeros((h, w, F), **f32)
    sp_l2sq = torch.zeros((h, w, F), **f32)
    zero = torch.zeros((), **f32)
    rs_dx = rs_dy = as_dx = as_dy = zero
    for s in range(S - 1, -1, -1):                      # near -> far
        rgb, alpha, _, _ = _decode_slot(vals_s, m_s, vals_d, hit_d, m_d, s)
        bw = alpha * T
        out = out + rgb * bw[..., None]
        asum = asum + bw
        if cfg.want_disp:
            disp = disp + dinv[s][..., None] * bw
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

    n = _norms(cfg, S, h, w, F)
    regs = [zero] * 3
    if cfg.use_sparsity:
        l2 = torch.sqrt(sp_l2sq).clamp(min=cfg.sp_eps)
        regs[0] = torch.mean(sp_l1 / l2) / n["sqrt_planes"]
    if cfg.use_rgb_smooth:
        regs[1] = rs_dx / n["n_rgb_dx"] + rs_dy / n["n_rgb_dy"]
    if cfg.use_a_smooth:
        regs[2] = as_dx / n["n_dx"] + as_dy / n["n_dy"]
    return out, asum, disp, torch.stack(regs)


def fused_composite_bwd_plain(cfg: FusedCfg, vals_s, m_s, vals_d, hit_d,
                              m_d, dinv, g_out, g_asum, g_disp, g_regs):
    """Plain version of K15 (the JAX package's ``_fused_bwd``).  g_regs
    (3,) are the cotangents of [sparsity, rgb_smooth, a_smooth].  Returns
    (d_vals_s (S, h, w, 4), d_vals_d (S, h, w, F, 4)), f32: a static
    slot's cotangent is summed over the frames."""
    S, h, w, F, C = vals_d.shape
    f32 = dict(dtype=torch.float32, device=vals_d.device)
    n = _norms(cfg, S, h, w, F)
    zero = torch.zeros((), **f32)
    g_sp = g_regs[0] if cfg.use_sparsity else zero
    g_rs_dx = g_rs_dy = g_as_dx = g_as_dy = zero
    if cfg.use_rgb_smooth:
        g_rs_dx = g_regs[1] / n["n_rgb_dx"]
        g_rs_dy = g_regs[1] / n["n_rgb_dy"]
    if cfg.use_a_smooth:
        g_as_dx = g_regs[2] / n["n_dx"]
        g_as_dy = g_regs[2] / n["n_dy"]

    # sweep A (near -> far): recompute decode + incoming transmittance
    dec, T_in = [None] * S, [None] * S
    T = torch.ones((h, w, F), **f32)
    sp_l1 = torch.zeros((h, w, F), **f32)
    sp_l2sq = torch.zeros((h, w, F), **f32)
    for s in range(S - 1, -1, -1):
        dec[s] = _decode_slot(vals_s, m_s, vals_d, hit_d, m_d, s)
        alpha = dec[s][1]
        T_in[s] = T
        T = T * (1.0 - alpha)
        if cfg.use_sparsity:
            sp_l1 = sp_l1 + torch.abs(alpha)
            sp_l2sq = sp_l2sq + alpha * alpha

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
    d_vals_s, d_vals_d = [None] * S, [None] * S
    dT = torch.zeros((h, w, F), **f32)
    for s in range(S):
        rgb, alpha, sig_d, sig_s = dec[s]
        g_i = torch.sum(rgb * g_out, dim=-1) + g_asum
        if cfg.want_disp:
            g_i = g_i + dinv[s][..., None] * g_disp
        bw = alpha * T_in[s]
        da = T_in[s] * (g_i - dT)
        dT = alpha * g_i + (1.0 - alpha) * dT
        d_rgb = bw[..., None] * g_out                    # (h, w, F, 3)
        if cfg.use_sparsity:
            da = da + sp_a_coef * torch.sign(alpha) - sp_b_coef * alpha
        if cfg.use_rgb_smooth:
            d_rgb = d_rgb + _smooth_grad(rgb, g_rs_dx, g_rs_dy)
        if cfg.use_a_smooth:
            da = da + _smooth_grad(alpha, g_as_dx, g_as_dy)

        # undo the static/dynamic select, then the masks and sigmoids
        hd = hit_d[s][..., None]                         # (h, w, 1)
        da_d = torch.where(hd, da, 0.0)
        da_s = torch.sum(torch.where(hd, 0.0, da), dim=-1)
        d_rgb_d = torch.where(hd[..., None], d_rgb, 0.0)
        d_rgb_s = torch.sum(torch.where(hd[..., None], 0.0, d_rgb), dim=-2)
        md = m_d[s][..., None]
        d_vals_d[s] = torch.cat([
            d_rgb_d * md[..., None] * (sig_d[..., :3] * (1.0 - sig_d[..., :3])),
            (torch.where(md, da_d, 0.0) * sig_d[..., 3]
             * (1.0 - sig_d[..., 3]))[..., None]], dim=-1)
        d_vals_s[s] = torch.cat([
            d_rgb_s * m_s[s][..., None]
            * (sig_s[..., :3] * (1.0 - sig_s[..., :3])),
            (torch.where(m_s[s], da_s, 0.0) * sig_s[..., 3]
             * (1.0 - sig_s[..., 3]))[..., None]], dim=-1)
    return torch.stack(d_vals_s), torch.stack(d_vals_d)


# K15's tile (csrc/fused_s2.cu): kTw x kTh pixels and a one-pixel halo,
# chunks of at most kFcMax frames, a block's shared bytes at most
# kBwdSmemLimit (kBwdSmemTwo for two blocks an SM)
BWD_TILE_W, BWD_TILE_H, BWD_FC_MAX = 8, 4, 10
BWD_HALO = (BWD_TILE_W + 2) * (BWD_TILE_H + 2)
BWD_SMEM_LIMIT, BWD_SMEM_TWO = 232448, 115712
# the keys of fused_s2_bwd_layout, in the order vl3d_fused_s2_bwd_layout
# returns them
FUSED_S2_BWD_LAYOUT_KEYS = ("fc", "threads", "smem")


def _bwd_smem(S, fc):
    npx = BWD_TILE_W * BWD_TILE_H
    b = (16 * (S * BWD_HALO + S * npx + 2 * npx + 2 * BWD_HALO * fc
               + 2 * npx * fc)
         + 4 * S * npx * fc + S * BWD_HALO + S + 2 * npx)
    return -(-b // 16) * 16


def fused_s2_bwd_layout(S, F):
    """K15's layout for S slots and F frames (csrc/fused_s2.cu:bwd_layout):
    `fc` frames a chunk, the largest up to BWD_FC_MAX that splits F into
    equal chunks and whose block leaves room for a second one on the SM
    (BWD_SMEM_TWO), else the largest whose block fits BWD_SMEM_LIMIT;
    `threads` a block, one per (pixel, frame) of a chunk; `smem`, the
    block's dynamic shared bytes: the static sigmoids of the tile and halo
    and the running static sums for all S slots, two slots' smoothness
    gradients of static neighbourhoods, a chunk's dynamic sigmoids and
    parked static cotangents of two slots (float4 each), T_in
    [S][threads] (float), the flags, a "some dynamic sample" byte a slot
    and two slots' "static neighbourhood" bytes."""
    for limit in (BWD_SMEM_TWO, BWD_SMEM_LIMIT):
        chunks = -(-F // BWD_FC_MAX)
        while True:
            fc = -(-F // chunks)
            if _bwd_smem(S, fc) <= limit:
                return dict(fc=fc, threads=BWD_TILE_W * BWD_TILE_H * fc,
                            smem=_bwd_smem(S, fc))
            if fc == 1:
                break
            chunks += 1
    return dict(fc=1, threads=BWD_TILE_W * BWD_TILE_H, smem=_bwd_smem(S, 1))


# K14's tile (csrc/fused_s2.cu): K15's kTw x kTh pixels with a halo of one
# column on the right and one row below, chunks of at most FWD_FC_MAX frames
FWD_FC_MAX = 10
FWD_HALO = (BWD_TILE_W + 1) * (BWD_TILE_H + 1)
FUSED_S2_FWD_LAYOUT_KEYS = ("fc", "threads", "smem")


def _fwd_smem(S, fc):
    mask_words = -(-128 // 32)          # csrc/fused_s2.cu:kMaskWords
    b = (16 * S * FWD_HALO * fc + 4 * S * BWD_TILE_W * BWD_TILE_H
         + 4 * FWD_HALO * mask_words)
    return -(-b // 16) * 16


def fused_s2_fwd_layout(S, F):
    """K14's layout for S slots and F frames (csrc/fused_s2.cu:fwd_layout):
    `fc` frames a chunk, the largest up to FWD_FC_MAX that splits F into
    equal chunks and whose block leaves room for a second one on the SM
    (BWD_SMEM_TWO), else the largest whose block fits BWD_SMEM_LIMIT;
    `threads` a block, one per (pixel, frame) of a chunk; `smem`, the
    block's dynamic shared bytes: the masked values of every (slot, tile or
    halo pixel, frame of a chunk) (float4), the tile's reciprocal depths
    and each tile or halo pixel's bit mask of dynamic slots."""
    for limit in (BWD_SMEM_TWO, BWD_SMEM_LIMIT):
        chunks = -(-F // FWD_FC_MAX)
        while True:
            fc = -(-F // chunks)
            if _fwd_smem(S, fc) <= limit:
                return dict(fc=fc, threads=BWD_TILE_W * BWD_TILE_H * fc,
                            smem=_fwd_smem(S, fc))
            if fc == 1:
                break
            chunks += 1
    return dict(fc=1, threads=BWD_TILE_W * BWD_TILE_H, smem=_fwd_smem(S, 1))


def kernel_fused_s2_fwd_layout(S, F):
    """K14's layout as csrc/fused_s2.cu computes it
    (vl3d_fused_s2_fwd_layout; needs the CUDA library), keyed as
    `fused_s2_fwd_layout`, for the checks that the two agree."""
    out = (ctypes.c_longlong * len(FUSED_S2_FWD_LAYOUT_KEYS))()
    kernels.library().vl3d_fused_s2_fwd_layout(S, F, out)
    return dict(zip(FUSED_S2_FWD_LAYOUT_KEYS, out))


def kernel_fused_s2_bwd_layout(S, F):
    """K15's layout as csrc/fused_s2.cu computes it
    (vl3d_fused_s2_bwd_layout; needs the CUDA library), keyed as
    `fused_s2_bwd_layout`, for the checks that the two agree."""
    out = (ctypes.c_longlong * len(FUSED_S2_BWD_LAYOUT_KEYS))()
    kernels.library().vl3d_fused_s2_bwd_layout(S, F, out)
    return dict(zip(FUSED_S2_BWD_LAYOUT_KEYS, out))


def _check_fused(name, cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv):
    dev = vals_d.device
    kernels.check_tensor(f"{name}.vals_d", vals_d, dev, dtype=torch.float32)
    if vals_d.dim() != 5 or vals_d.shape[-1] != 4:
        raise ValueError(f"{name}.vals_d: shape {tuple(vals_d.shape)}, "
                         "expected (S, h, w, F, 4)")
    S, h, w, F, C = vals_d.shape
    kernels.check_tensor(f"{name}.vals_s", vals_s, dev, dtype=torch.float32,
                         shape=(S, h, w, C))
    for nm, m in (("m_s", m_s), ("hit_d", hit_d), ("m_d", m_d)):
        kernels.check_tensor(f"{name}.{nm}", m, dev, dtype=torch.bool,
                             shape=(S, h, w))
    if cfg.want_disp:
        kernels.check_tensor(f"{name}.dinv", dinv, dev, dtype=torch.float32,
                             shape=(S, h, w))
    if dev.type == "cuda" and (vals_s.data_ptr() % 16 or vals_d.data_ptr() % 16):
        raise ValueError(f"{name}: samples not 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_s2_fwd(cfg: FusedCfg, vals_s, m_s, vals_d, hit_d, m_d, dinv):
    """K14 without autograd: `fused_composite_fwd_plain`'s outputs for
    gradient-free inputs (the plain version on CPU tensors).  The kernel
    takes S <= 128 slots and F <= 1,024 frames; a block holds a tile of
    pixels and the frames in chunks (`fused_s2_fwd_layout`); with a
    regularizer on, each (pixel, frame)'s five sums pass through a scratch
    of h w F x 5 floats to the first design's reduction."""
    _check_fused("fused_s2_fwd", cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv)
    if vals_d.device.type == "cpu":
        return fused_composite_fwd_plain(cfg, vals_s, m_s, vals_d, hit_d, m_d,
                                         dinv)
    S, h, w, F, _ = vals_d.shape
    dev = vals_d.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((h, w, F, 3), **f32)
    asum = torch.empty((h, w, F), **f32)
    disp = torch.empty((h, w, F), **f32)
    item_sums = torch.empty((h * w * F, 5), **f32) if cfg.flags() & 7 \
        else None
    partials = torch.empty((kernels.partial_rows(h * w * F), 5), **f32)
    regs = torch.zeros((3,), **f32)
    n = _norms(cfg, S, h, w, F)
    err = kernels.library().vl3d_fused_s2_fwd(
        vals_s.data_ptr(), vals_d.data_ptr(), m_s.data_ptr(), hit_d.data_ptr(),
        m_d.data_ptr(), _ptr(dinv if cfg.want_disp else None), S, h, w, F,
        cfg.flags(), cfg.sp_eps, float(n["n_pix"]), n["sqrt_planes"],
        float(n["n_rgb_dx"]), float(n["n_rgb_dy"]), float(n["n_dx"]),
        float(n["n_dy"]), out.data_ptr(), asum.data_ptr(), disp.data_ptr(),
        _ptr(item_sums), partials.data_ptr(), regs.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.LAUNCHES["fused_s2_fwd"] += 1
    kernels.check_launch("fused_s2_fwd", err)
    return out, asum, disp, regs


def fused_s2_bwd(cfg: FusedCfg, vals_s, m_s, vals_d, hit_d, m_d, dinv, g_out,
                 g_asum, g_disp, g_regs):
    """K15: `fused_composite_bwd_plain` for contiguous f32 cotangents (the
    plain version on CPU tensors).  Returns (d_vals_s, d_vals_d).  The
    kernel takes S <= 128 slots and F <= 1,024 frames; a block holds a
    tile of pixels and the frames in chunks (`fused_s2_bwd_layout`)."""
    _check_fused("fused_s2_bwd", cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv)
    if vals_d.device.type == "cpu":
        return fused_composite_bwd_plain(cfg, vals_s, m_s, vals_d, hit_d, m_d,
                                         dinv, g_out, g_asum, g_disp, g_regs)
    S, h, w, F, _ = vals_d.shape
    dev = vals_d.device
    grads =(("g_out", g_out, (h, w, F, 3)), ("g_asum", g_asum, (h, w, F)),
             ("g_disp", g_disp, (h, w, F)), ("g_regs", g_regs, (3,)))
    for nm, t, shape in grads:
        kernels.check_tensor(f"fused_s2_bwd.{nm}", t, dev,
                             dtype=torch.float32, shape=shape)
    d_vals_s = torch.empty_like(vals_s)
    d_vals_d = torch.empty_like(vals_d)
    n = _norms(cfg, S, h, w, F)
    err = kernels.library().vl3d_fused_s2_bwd(
        vals_s.data_ptr(), vals_d.data_ptr(), m_s.data_ptr(), hit_d.data_ptr(),
        m_d.data_ptr(), _ptr(dinv if cfg.want_disp else None),
        g_out.data_ptr(), g_asum.data_ptr(), g_disp.data_ptr(),
        g_regs.data_ptr(), S, h, w, F, cfg.flags(), cfg.sp_eps,
        float(n["n_pix"] * n["sqrt_planes"]), float(n["n_rgb_dx"]),
        float(n["n_rgb_dy"]), float(n["n_dx"]), float(n["n_dy"]),
        d_vals_s.data_ptr(), d_vals_d.data_ptr(), kernels.stream_ptr(dev))
    kernels.LAUNCHES["fused_s2_bwd"] += 1
    kernels.check_launch("fused_s2_bwd", err)
    return d_vals_s, d_vals_d


class _FusedS2(torch.autograd.Function):
    """K14 forward and K15 backward on CUDA tensors, the plain versions on
    CPU tensors.  Saves only the samples, masks and dinv."""

    @staticmethod
    def forward(ctx, cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv):
        vals_s, vals_d = vals_s.detach(), vals_d.detach()
        ctx.cfg = cfg
        ctx.save_for_backward(vals_s, m_s, vals_d, hit_d, m_d, dinv)
        return fused_s2_fwd(cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv)

    @staticmethod
    def backward(ctx, g_out, g_asum, g_disp, g_regs):
        grads = [t.contiguous() for t in (g_out, g_asum, g_disp, g_regs)]
        d_vals_s, d_vals_d = fused_s2_bwd(ctx.cfg, *ctx.saved_tensors, *grads)
        return None, d_vals_s, None, d_vals_d, None, None, None


def fused_composite(cfg: FusedCfg, vals_s, m_s, vals_d, hit_d, m_d, dinv):
    """K14/K15: the fused stage-2 decode + select + composite +
    regularizers (``--fused_render``).

    vals_s (S, h, w, 4) and vals_d (S, h, w, F, 4) f32 raw texel samples;
    m_s, hit_d, m_d (S, h, w) bool; dinv (S, h, w) f32 per-slot masked
    reciprocal depth (required iff cfg.want_disp; gets no gradient).
    Differentiable in vals_s and vals_d.

    Returns (out (h, w, F, 3), alpha_sum (h, w, F), disp (h, w, F) or
    None, regs {name: scalar} for the terms that are on): the JAX
    function's outputs."""
    return select_outputs(cfg, *_FusedS2.apply(cfg, vals_s, m_s, vals_d,
                                               hit_d, m_d, dinv))


def select_outputs(cfg: FusedCfg, out, asum, disp, regs):
    """The four outputs of K14 / the plain forward in the JAX function's
    form: None for a disparity that is off, and the regularizers that are
    on as a {name: scalar} dict."""
    on = (cfg.use_sparsity, cfg.use_rgb_smooth, cfg.use_a_smooth)
    reg = {k: regs[i] for i, k in enumerate(REG_NAMES) if on[i]}
    return out, asum, disp if cfg.want_disp else None, reg
