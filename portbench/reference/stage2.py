"""Plain reference of one stage-2 optimizer step of a sparse Multi-plane
Tile Video (MTV), in plain PyTorch and float32.

It follows the published model (VideoLoop3D, ``MPV.py`` and
``utils_vid.py``) as the configuration states it, and imports nothing of
the program under test.  It recomputes what the program derives from the
benchmark's inputs: the plane geometry, the per-level slot bound S, the
hit compaction, the bf16 texel reads and the patch crops.

The step of a patch:

1. per plane, the inverse homography of the view; the pixel grid warped
   onto the plane texture; the packed static and dynamic tile of every
   sample (-1 where culled or outside);
2. the sweep compacted per pixel to its S farthest-first hit planes;
3. the texels read as bfloat16 (``--fp16``) and sampled bilinearly
   inside the tile; each texel's gradient is summed in float32 and
   rounded once to bfloat16;
4. decode (direct: sigmoid; rgb_sh: degree-1 spherical harmonics of the
   view direction, then sigmoid), static/dynamic select, the
   over-composite of the far-first slots, the content-smoothness terms
   on the slot stacks renormalized by S / D;
5. the "gpnn_lm" looping loss: per crop and spatial patch column, every
   (pt, p, p) patch of the loop-padded render finds its nearest video
   patch (searched in bfloat16, distances in float32, divided by
   alpha + the column minimum when alpha is on); the chosen patches are
   folded into a target, and the loss is a robust penalty on the
   difference;
6. Adam (eps outside the square root, bias correction).

Deliberate departures: none in the arithmetic; the sums run in another
order than the program's kernels, so results agree to rounding, and a
near tie of the patch search may pick another patch.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def geometry(scene):
    """The planes of the scene: far first, uniform in disparity, each
    covering the texel rectangle of the reference image enlarged by
    mpi_scale, cut into (verts - 1) tiles a side."""
    H, W = scene["H"], scene["W"]
    mpi_h = int(scene["mpi_scale"] * H)
    mpi_w = int(scene["mpi_scale"] * W)
    km = np.asarray(ref_intrinsic(scene), np.float64).copy()
    km[0, 2] += (mpi_w - W) // 2
    km[1, 2] += (mpi_h - H) // 2
    D = scene["planes"]
    depths = np.reciprocal(np.linspace(1.0 / scene["far"], 1.0 / scene["near"],
                                       D, dtype=np.float64)).astype(np.float32)
    nth, ntw = scene["verts_h"] - 1, scene["verts_w"] - 1
    span = ((mpi_h - 1) / nth, (mpi_w - 1) / ntw)
    return SimpleNamespace(n_planes=D, mpi_h=mpi_h, mpi_w=mpi_w, nth=nth,
                           ntw=ntw, depths=depths,
                           km=km.astype(np.float32), span=span,
                           tile_hw=(max(int(round(span[0])) + 1, 2),
                                    max(int(round(span[1])) + 1, 2)))


def ref_intrinsic(scene):
    H, W = scene["H"], scene["W"]
    f = scene["focal_scale"] * W
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


def _intrinsic_inverse(K):
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    s = K[..., 0, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    inv_fx, inv_fy = 1.0 / fx, 1.0 / fy
    row0 = torch.stack([inv_fx, -s * inv_fx * inv_fy,
                        (s * cy * inv_fy - cx) * inv_fx], dim=-1)
    row1 = torch.stack([zeros, inv_fy, -cy * inv_fy], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def homographies(geom, extrin, intrin):
    """(B, D, 3, 3) maps from target pixels to plane texels: the inverse
    of Kt (z R + t e3^T) Km^-1, by Sherman-Morrison.  extrin (B, 4, 4)
    relative to the reference camera, intrin (B, 3, 3)."""
    dev = extrin.device
    depths = torch.as_tensor(geom.depths, device=dev)
    Km = torch.as_tensor(geom.km, device=dev)
    R = extrin[:, :3, :3].float()
    t = extrin[:, :3, 3].float()
    Kt_inv = _intrinsic_inverse(intrin.float())
    B_mat = R.transpose(-1, -2)[:, None] / depths[None, :, None, None]
    Bt = torch.einsum("bdij,bj->bdi", B_mat, t)
    denom = 1.0 + Bt[..., 2]
    outer = Bt[..., :, None] * B_mat[..., 2, None, :]
    A_inv = B_mat - outer / denom[..., None, None]
    return torch.einsum("ij,bdjk,bkl->bdil", Km, A_inv, Kt_inv)


def sweep(geom, maps, G, h, w):
    """The (B, D, h, w) samples of the pixel grid: plane coordinates,
    view depth, validity, packed tile indices and in-tile fractions."""
    dev = G.device
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    Gb = G[..., None, None]

    def row(i):
        return (Gb[:, :, i, 0] * px + Gb[:, :, i, 1] * py) + Gb[:, :, i, 2]

    den = row(2)
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    x, y, zview = row(0) / den, row(1) / den, 1.0 / den
    valid = ((x >= 0) & (x <= geom.mpi_w - 1) & (y >= 0)
             & (y <= geom.mpi_h - 1) & (zview > 1e-6))
    sy, sx = (torch.tensor(s, dtype=torch.float32, device=dev)
              for s in geom.span)
    j = torch.floor(x / sx).to(torch.int32).clamp(0, geom.ntw - 1)
    i = torch.floor(y / sy).to(torch.int32).clamp(0, geom.nth - 1)
    tm_s, tm_d = maps
    D = tm_s.shape[0]
    cell = (torch.arange(D, device=dev)[:, None, None] * (geom.nth * geom.ntw)
            + i.long() * geom.ntw + j.long())
    minus = torch.full((), -1, dtype=torch.int32, device=dev)
    k_s = torch.where(valid, tm_s.reshape(-1)[cell], minus)
    k_d = torch.where(valid, tm_d.reshape(-1)[cell], minus)
    fu = (x - j.to(torch.float32) * sx) / sx
    fv = (y - i.to(torch.float32) * sy) / sy
    return dict(valid=valid, zview=zview, k_s=k_s, k_d=k_d, fu=fu, fv=fv)


def slot_bound(geom, maps, extrins, intrins, h, w, jitter_px=0.55,
               margin=2):
    """The per-level bound S on a pixel's hit planes over all training
    views, at the pixel grid and with the principal point moved by
    +-jitter_px on both axes (the +-0.5 px intrinsic noise), plus a
    margin; at most D."""
    dev = maps[0].device
    jit = [(0.0, 0.0), (-jitter_px, -jitter_px), (-jitter_px, jitter_px),
           (jitter_px, -jitter_px), (jitter_px, jitter_px)]
    most = 0
    for ext, intr in zip(extrins, intrins):
        Ks = []
        for dy, dx in jit:
            K = torch.as_tensor(np.asarray(intr, np.float32)).clone()
            K[0, 2] += dx
            K[1, 2] += dy
            Ks.append(K)
        K = torch.stack(Ks).to(dev)
        E = torch.as_tensor(np.asarray(ext, np.float32), device=dev)
        G = homographies(geom, E.expand(len(jit), 4, 4), K).contiguous()
        s = sweep(geom, maps, G, h, w)
        hits = (((s["k_s"] >= 0) | (s["k_d"] >= 0)) & s["valid"]).any(dim=0)
        most = max(most, int(hits.sum(dim=0).max()))
    return int(min(geom.n_planes, most + margin))


def compact(s, n_slots):
    """Per pixel, keep the n_slots hit planes nearest the camera, in
    far-first order; empty slots hold k = -1.  s: one view's (D, h, w)
    arrays.  Returns the (S, h, w) arrays."""
    k_s, k_d = s["k_s"], s["k_d"]
    D, h, w = k_s.shape
    S = int(n_slots)
    hit = (k_s >= 0) | (k_d >= 0)
    nearer = torch.flip(torch.cumsum(torch.flip(hit.long(), [0]), 0), [0])
    slot = S - nearer
    keep = (hit & (slot >= 0)).reshape(D, -1)
    pix = torch.arange(h * w, device=k_s.device).expand(D, h * w)
    dst = (slot.reshape(D, -1) * (h * w) + pix)[keep]

    def take(x, empty):
        out = torch.full((S * h * w,), empty, dtype=x.dtype, device=x.device)
        out[dst] = x.reshape(D, -1)[keep]
        return out.view(S, h, w)

    return {k: take(s[k], e) for k, e in (("k_s", -1), ("k_d", -1),
                                          ("fu", 0.0), ("fv", 0.0),
                                          ("valid", False), ("zview", 0.0))}


# ---------------------------------------------------------------------------
# texel reads
# ---------------------------------------------------------------------------

class _Rounded(torch.autograd.Function):
    """The texels as the configuration reads them (bfloat16 under --fp16),
    widened to float32; each texel's summed gradient rounded once to
    bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.detach().to(BF16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(BF16).float()


def sample_tiles(tiles, k, fu, fv):
    """Bilinear samples inside packed tiles (N, th, tw[, F], C) at the
    in-tile fractions, texel corners clamped to the tile; zero where
    k < 0.  Returns (values (..., [F,] C) f32, hit (...))."""
    th, tw = tiles.shape[1], tiles.shape[2]
    tex = _Rounded.apply(tiles)
    hit = k >= 0
    kk = k.clamp(min=0).long()
    zero = torch.zeros((), device=fu.device)
    u = torch.where(hit, (fu * (tw - 1)).clamp(0.0, tw - 1.0), zero)
    v = torch.where(hit, (fv * (th - 1)).clamp(0.0, th - 1.0), zero)
    u0, v0 = torch.floor(u), torch.floor(v)
    au, av = u - u0, v - v0
    u0i, v0i = u0.long(), v0.long()
    u1i = (u0i + 1).clamp(max=tw - 1)
    v1i = (v0i + 1).clamp(max=th - 1)
    extra = tiles.dim() - 3
    au = au.reshape(au.shape + (1,) * extra)
    av = av.reshape(av.shape + (1,) * extra)

    def lerp(a, b, f):
        return a * (1 - f) + b * f

    top = lerp(tex[kk, v0i, u0i], tex[kk, v0i, u1i], au)
    bot = lerp(tex[kk, v1i, u0i], tex[kk, v1i, u1i], au)
    vals = lerp(top, bot, av)
    return torch.where(hit.reshape(hit.shape + (1,) * extra), vals, 0.0), hit


# ---------------------------------------------------------------------------
# decode, composite, regularizers
# ---------------------------------------------------------------------------

_SH_C0, _SH_C1 = 0.28209479177387814, 0.4886025119029199


def view_dirs(h, w, extrin, intrin):
    """Unit view directions (h, w, 3) of a patch's pixels."""
    pose = torch.linalg.inv(extrin[0].double()).float()
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                       device=extrin.device),
                          torch.arange(w, dtype=torch.float32,
                                       device=extrin.device), indexing="ij")
    pix = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    d = pix @ torch.linalg.inv(intrin[0].double()).float().T @ pose[:3, :3].T
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def decode(feats, decoder, dirs):
    """Texel features (..., C) -> (rgb, alpha) after the sigmoid.
    direct: rgba in the first 4 channels; rgb_sh: per colour the degree-1
    real SH coefficients (4 a colour, 12) of the view direction, alpha
    last.  dirs broadcastable to (..., 3)."""
    if decoder == "direct":
        rgba = feats[..., :4]
    elif decoder == "rgb_sh":
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        base = torch.stack([torch.full_like(x, _SH_C0), -_SH_C1 * y,
                            _SH_C1 * z, -_SH_C1 * x], dim=-1)
        coef = feats[..., :-1].reshape(feats.shape[:-1] + (3, 4))
        rgb = torch.sum(base[..., None, :] * coef, dim=-1)
        rgba = torch.cat([rgb, feats[..., -1:]], dim=-1)
    else:
        raise ValueError(f"the reference has no decoder {decoder!r}")
    return torch.sigmoid(rgba[..., :3]), torch.sigmoid(rgba[..., 3])


class _Abs(torch.autograd.Function):
    """|x| with derivative +1 at 0 (the published model's jnp.abs)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def smooth(x):
    """Mean |difference| of neighbouring pixels along w plus along h; x
    (L, h, w, ...)."""
    return (torch.mean(_Abs.apply(torch.diff(x, dim=2)))
            + torch.mean(_Abs.apply(torch.diff(x, dim=1))))


def render(params, geom, maps, n_slots, extrin, intrin, h, w, cfg):
    """Training render of one patch (all frames), texels read as bfloat16.
    Returns rgb (F, h, w, 3) and the regularizer terms {name: value}
    (before their weights)."""
    G = homographies(geom, extrin, intrin).contiguous()
    s = {k: v[0] for k, v in sweep(geom, maps, G, h, w).items()}
    if n_slots < geom.n_planes:
        s = compact(s, n_slots)
    vs, hit_s = sample_tiles(params["atlas"], s["k_s"], s["fu"], s["fv"])
    vd, hit_d = sample_tiles(params["atlas_dyn"], s["k_d"], s["fu"], s["fv"])
    valid = s["valid"]
    m_s, m_d = valid & hit_s, valid & hit_d
    dirs = None if cfg["decoder"] == "direct" else view_dirs(h, w, extrin,
                                                             intrin)
    rgb_s, a_s = decode(vs, cfg["decoder"], None if dirs is None
                        else dirs[None])
    rgb_d, a_d = decode(vd, cfg["decoder"], None if dirs is None
                        else dirs[None, :, :, None])
    rgb_s = rgb_s * m_s[..., None]
    a_s = torch.where(m_s, a_s, 0.0)
    rgb_d = rgb_d * m_d[..., None, None]
    a_d = torch.where(m_d[..., None], a_d, 0.0)
    hd = hit_d[..., None]
    rgb_p = torch.where(hd[..., None], rgb_d, rgb_s[..., None, :])
    alpha = torch.where(hd, a_d, a_s[..., None])           # (L, h, w, F)
    # over-composite, slots far first: T_i = prod_{j > i} (1 - a_j)
    trans = torch.flip(torch.cumprod(torch.flip(1.0 - alpha, [0]), 0), [0])
    trans = torch.cat([trans[1:], torch.ones_like(trans[:1])], dim=0)
    weight = alpha * trans
    out = torch.sum(rgb_p * weight[..., None], dim=0)      # (h, w, F, 3)
    denorm = alpha.shape[0] / geom.n_planes
    regs = {}
    if cfg["weights"].get("rgb_smooth", 0) > 0:
        regs["rgb_smooth"] = smooth(rgb_p) * denorm
    if cfg["weights"].get("a_smooth", 0) > 0:
        regs["a_smooth"] = smooth(alpha[..., None]) * denorm
    return out.movedim(2, 0), regs


# ---------------------------------------------------------------------------
# the looping loss
# ---------------------------------------------------------------------------

def _fit(size, p, s):
    return (size - p) // s * s + p


def _n(size, p, s):
    return (size - p) // s + 1


def _starts(size, macro, p, s):
    stride = macro - p + s
    return sorted({min(st, size - macro)
                   for st in range(0, size - macro + stride, stride)})


def _coverage(length, p, s):
    prof = np.zeros(length, np.float32)
    for i in range(_n(length, p, s)):
        prof[i * s:i * s + p] += 1.0
    return prof


def crop_plan(Tx, Ty, H, W, psz, strides, macro):
    """The loss's crops: square macro blocks fitted to the patch grid,
    starts clamped so all share one size; the number of patches covering
    each voxel of the fitted extent; grid (ntx, nty, nh, nw), the temporal
    patches of x and y and the spatial patches of a crop."""
    (pt, p, _), (st, s, _) = psz, strides
    macro = _fit(macro, p, s)
    fh, fw, ft = _fit(H, p, s), _fit(W, p, s), _fit(Tx, pt, st)
    macro = min(macro, fh, fw)
    hs, ws = _starts(fh, macro, p, s), _starts(fw, macro, p, s)
    crop_w = (_coverage(ft, pt, st)[:, None, None]
              * _coverage(macro, p, s)[None, :, None]
              * _coverage(macro, p, s)[None, None, :])
    weight = np.zeros((ft, fh, fw), np.float32)
    for h0 in hs:
        for w0 in ws:
            weight[:, h0:h0 + macro, w0:w0 + macro] += crop_w
    fit_ty = _fit(Ty, pt, st)
    return SimpleNamespace(psz=psz, strides=strides, hs=hs, ws=ws,
                           macro=macro, fit=(ft, fh, fw), fit_ty=fit_ty,
                           grid=(_n(ft, pt, st), _n(fit_ty, pt, st),
                                 _n(macro, p, s), _n(macro, p, s)),
                           weight=np.clip(weight, 1e-10, None))


def patches(x, psz, strides):
    """(C, T, H, W) -> (nt, nh * nw, C * pt * ph * pw)."""
    (pt, ph, pw), (st, sh, sw) = psz, strides
    v = x.unfold(1, pt, st).unfold(2, ph, sh).unfold(3, pw, sw)
    nt, nh, nw = v.shape[1:4]
    return v.permute(1, 2, 3, 0, 4, 5, 6).reshape(nt, nh * nw, -1), (nh, nw)


def retarget(x, y, plan, alpha, dist_dtype=torch.float32, choices=None):
    """The target: per crop and column, each x patch's nearest y patch
    (squared distance over the patch size, computed in `dist_dtype`, over
    alpha + the column minimum when alpha is on), folded back and divided
    by the coverage.  `choices`, a list, receives each crop's indices."""
    ft, fh, fw = plan.fit
    m = plan.macro
    x = x[:, :ft, :fh, :fw]
    y = y[:, :plan.fit_ty, :fh, :fw]
    C = y.shape[0]
    out = torch.zeros((C, ft, fh, fw), dtype=torch.float32, device=y.device)
    (pt, ph, pw), (st, sh, sw) = plan.psz, plan.strides
    for h0 in plan.hs:
        for w0 in plan.ws:
            X, (nh, nw) = patches(x[..., h0:h0 + m, w0:w0 + m], plan.psz,
                                  plan.strides)
            Y, _ = patches(y[..., h0:h0 + m, w0:w0 + m], plan.psz,
                           plan.strides)
            X = X.to(dist_dtype).transpose(0, 1)
            Y = Y.to(dist_dtype).transpose(0, 1)
            d = (torch.sum(X * X, -1)[..., :, None]
                 + torch.sum(Y * Y, -1)[..., None, :]
                 - 2.0 * torch.bmm(X, Y.transpose(1, 2))) / X.shape[-1]
            if alpha is not None:
                d = d / (alpha + torch.amin(d, dim=1, keepdim=True))
            nn = torch.argmin(d, dim=2)                     # (cols, ntx)
            if choices is not None:
                choices.append(nn)
            Y = Y.float()
            sel = torch.take_along_dim(Y, nn[..., None], dim=1)
            ntx = sel.shape[1]
            sel = sel.transpose(0, 1).reshape(ntx, nh, nw, C, pt, ph, pw)
            crop = torch.zeros((C, ft, m, m), dtype=torch.float32,
                               device=y.device)
            # overlap-add: scatter every patch voxel to its place
            ti = (torch.arange(ntx, device=y.device)[:, None] * st
                  + torch.arange(pt, device=y.device)[None, :])
            hi = (torch.arange(nh, device=y.device)[:, None] * sh
                  + torch.arange(ph, device=y.device)[None, :])
            wi = (torch.arange(nw, device=y.device)[:, None] * sw
                  + torch.arange(pw, device=y.device)[None, :])
            idx = ((ti[:, None, None, :, None, None] * m
                    + hi[None, :, None, None, :, None]) * m
                   + wi[None, None, :, None, None, :])   # (ntx,nh,nw,pt,ph,pw)
            vals = sel.permute(3, 0, 1, 2, 4, 5, 6).reshape(C, -1)
            crop.view(C, -1).index_add_(1, idx.reshape(-1), vals)
            out[..., h0:h0 + m, w0:w0 + m] += crop
    return out / torch.from_numpy(plan.weight).to(y.device)[None]


def loss_input(rgb, video, lc):
    """The looping loss's x (loop-padded, times the scale-invariant gain)
    and y from the render rgb and the video (F, h, w, 3)."""
    x = rgb.permute(3, 0, 1, 2)
    pad = lc["patcht_size"] - 1
    if pad > 0:
        x = torch.cat([x, x[:, :pad]], dim=1)
    gt, re = torch.mean(video, dim=0), torch.mean(rgb.detach(), dim=0)
    gain = torch.exp(torch.mean(torch.log((gt + 0.01) / (re + 0.01))))
    return x * ((gain + 3.0) / 4.0), video.permute(3, 0, 1, 2)


def search_choices(x, y, lc, dist_dtype=torch.float32):
    """The patch search's choices (each crop's (cols, ntx) indices), the
    distances computed in `dist_dtype`."""
    psz = (lc["patcht_size"], lc["patch_size"], lc["patch_size"])
    strides = (lc["stridet"], lc["stride"], lc["stride"])
    alpha = lc["alpha"]
    alpha = None if alpha is None or alpha > 100 else alpha
    plan = crop_plan(x.shape[1], y.shape[1], x.shape[2], x.shape[3], psz,
                     strides, lc["macro_block"])
    out = []
    retarget(x.detach().to(BF16), y.to(BF16), plan, alpha, dist_dtype, out)
    return out


def robust(x, rou, scale, eps=1e-6):
    """The general robust penalty of the published loss (rou < 0 here)."""
    rou = float(rou)
    z = (x / scale) ** 2
    if rou == 0:
        return torch.log1p(z * 0.5)
    if rou == 2:
        return 0.5 * z
    b = abs(rou - 2) + eps
    d = rou + eps if rou >= 0 else rou - eps
    return (b / d) * (torch.pow(z / b + 1.0, 0.5 * d) - 1.0) * (scale * 10)


def looping_loss(x, y, lc):
    """'gpnn_lm' of the render x (3, F + pt - 1, h, w) against the video
    y (3, F, h, w)."""
    psz = (lc["patcht_size"], lc["patch_size"], lc["patch_size"])
    strides = (lc["stridet"], lc["stride"], lc["stride"])
    alpha = lc["alpha"]
    alpha = None if alpha is None or alpha > 100 else alpha
    with torch.no_grad():
        plan = crop_plan(x.shape[1], y.shape[1], x.shape[2], x.shape[3], psz,
                         strides, lc["macro_block"])
        target = retarget(x.detach().to(BF16), y.to(BF16), plan, alpha)
    ft, fh, fw = plan.fit
    return torch.mean(robust(x[:, :ft, :fh, :fw] - target, lc["rou"],
                             lc["scaling"]))


def step_loss(params, geom, maps, n_slots, batch, cfg):
    """The total loss of one patch."""
    h, w = cfg["patch"]
    rgb, regs = render(params, geom, maps, n_slots, batch["extrin"],
                       batch["intrin"], h, w, cfg)
    lc = batch["losscfg"]
    # the scale-invariant gain is a constant in the gradient
    x, y = loss_input(rgb, batch["video"], lc)
    gain_l = float(lc["loss_gain"])
    main = looping_loss(x, y, lc) * gain_l
    total = main
    for k, v in regs.items():
        total = total + cfg["weights"][k] * v * gain_l
    return total


class Adam:
    """torch.optim.Adam's published update: m, v moments, bias
    correction, eps outside the square root."""

    def __init__(self, params, betas=(0.9, 0.999), eps=6e-8):
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads, lr):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.sub_(lr / c1 * self.m[k] / denom)


def follow(params, geom, maps, n_slots, batches, cfg,
           param_dtype=torch.float32):
    """The reference's first len(batches) steps from params (updated in
    place).  Returns (each step's loss, the first step's gradient norm a
    leaf, the norm of each leaf's change over the steps)."""
    # float32 products stay float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def store(ps):
        """The parameters as stored (`param_dtype`; a control lowers the
        configuration's float32)."""
        if param_dtype != torch.float32:
            with torch.no_grad():
                for p in ps.values():
                    p.copy_(p.to(param_dtype).float())

    store(params)
    start = {k: p.detach().clone() for k, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    opt = Adam(params)
    losses, grad_norms = [], None
    for b in batches:
        total = step_loss(params, geom, maps, n_slots, b, cfg)
        grads = torch.autograd.grad(total, list(params.values()))
        grads = dict(zip(params.keys(), grads))
        losses.append(float(total.detach()))
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(g.double()))
                          for k, g in grads.items()}
        del total
        opt.step(params, grads, b["lr"])
        store(params)
        del grads
    change = {k: float(torch.linalg.vector_norm(
        (params[k].detach() - start[k]).double())) for k in params}
    return losses, grad_norms, change
