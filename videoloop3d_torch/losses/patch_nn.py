"""3-D patch nearest-neighbour (GPNN) looping losses, the stage-2 loss
(counterpart of ``videoloop3d_tpu/losses/patch_nn.py``; ref
utils_vid.py:10-445).

The render x (C, Tx, H, W) and the video y (C, Ty, H, W) are cut into
crops; in every crop each (pt, p, p) patch of x, at stride (st, s, s),
finds its nearest y patch AT THE SAME SPATIAL POSITION among the
temporal patches of y; the selected y patches are folded back
(overlap-add) into a target y2x, divided by the number of patches
covering each voxel, and the loss is a robust penalty on x - y2x.  The
search and the fold run under no gradient: only the penalty is
differentiated (plain autograd, as plain `jnp` in JAX).

Four kernels live here, each beside its plain PyTorch version:

* K11 `nn_argmin` (``csrc/nn_argmin.cu``; bf16 "mse" searches on the
  tensor cores, ``csrc/nn_argmin_mma.cu``, from one staged copy of each
  column's frames (`mma_layout`): their Gram summed along the band or the
  Gram of their patch rows; videos too long to stage stay on the CUDA-core
  search, `tile_layout`): the search,
  `_pairwise_sqdist` + `nn_indices_from_dist` of the JAX package, with no
  patch tensor and no distance matrix in device memory; its ssim mode
  (``dist_fn="ssim"``) searches under `_pairwise_ssim_dist`;
* K12 `nn_fold` (``csrc/nn_fold.cu``): selection, fold, crop overlap-add
  and the division by the fold weight, one thread per output voxel; its
  parent mode (``parent=f``) folds `gpnn_downsample_loss`'s full-resolution
  patches with the indices of their low-resolution parents;
* K18 `nn_band_argmin` (``csrc/nn_argmin.cu``): the temporally decomposed
  search (`banded_temporal_dist` of the JAX package): per-frame patch
  distances, their banded sums over the pt frames of a temporal patch,
  the argmin of every row and, for the eval, of every column;
* K19 `nn_band_err` (``csrc/nn_band_err.cu``): the eval's summed
  |selected - source| of one direction of K18's search
  (``eval/nnmse.py``), a block a crop column cut into (channel, patch
  range) units (`nn_band_err_layout`), a sliding register window over
  the source frames at st = 1.

The crops are `gpnn_lowmem_loss`'s macro blocks (clamped starts, all of
one size) or, for `gpnn_direct_loss`, one crop covering the fitted frame;
`gpnn_downsample_loss` searches the macro blocks of a video downsampled
by its factor and folds full-resolution crops (`down_plans`); the eval's
macro blocks are `lowmem_plan`'s too.  ``--fast_nn_dist``
(`fast_nn_dist=True`) searches with K18 where the JAX package takes
`_nn_retarget_temporal`: the "mse" distance and pt > 1.  The "ssim"
distance is computed in f32 for bf16 inputs too (the JAX package rounds
its statistics to bf16 there).  The SWD loss is ``losses/swd.py``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from videoloop3d_torch import kernels
from videoloop3d_torch.core.resize import weight_matrix

_NN_DTYPES = (torch.float32, torch.bfloat16)
# K11 keeps the (ntx, nty) distances of one crop column in shared memory
_SMEM_LIMIT = 227 * 1024


# ---------------------------------------------------------------------------
# robust loss (ref utils_vid.py:10-26)
# ---------------------------------------------------------------------------

def robust_lossfun(x, rou, scale, epsilon=1e-6):
    """General robust penalty rho(x); `rou` in {'mse', 'abs'} or a float
    (the Barron-style family of the reference, with its * (scale * 10)
    for a general rou)."""
    if rou == "mse":
        return x ** 2
    if rou == "abs":
        return torch.abs(x)
    rou = float(rou)
    z = (x / scale) ** 2
    if rou == 0:
        return torch.log1p(z * 0.5)
    if rou == 2:
        return 0.5 * z
    b = abs(rou - 2) + epsilon
    d = rou + epsilon if rou >= 0 else rou - epsilon
    loss = (b / d) * (torch.pow(z / b + 1.0, 0.5 * d) - 1.0)
    return loss * (scale * 10)


# ---------------------------------------------------------------------------
# static planning (numpy)
# ---------------------------------------------------------------------------

def n_patches(size, p, s):
    return (size - p) // s + 1


def fit_patch_size(size, p, s):
    """Largest size' <= size with (size' - p) % s == 0 (ref
    utils_vid.py:308-318 fit_patch)."""
    return (size - p) // s * s + p


def _fold_profile_1d(length, p, s):
    n = n_patches(length, p, s)
    prof = np.zeros(length, np.float32)
    for i in range(n):
        prof[i * s:i * s + p] += 1.0
    return prof


def fold_weight(out_shape, psz, strides):
    """Analytic fold of ones: the outer product of per-axis coverage
    counts."""
    T, H, W = out_shape
    (pt, ph, pw), (st, sh, sw) = psz, strides
    wt = _fold_profile_1d(T, pt, st)
    wh = _fold_profile_1d(H, ph, sh)
    ww = _fold_profile_1d(W, pw, sw)
    return wt[:, None, None] * wh[None, :, None] * ww[None, None, :]


def _macro_starts(size, macro, p, s):
    """Crop starts; the last start is clamped to size - macro so that all
    crops share one shape (the reference lets the last block be ragged)."""
    stride = macro - p + s
    starts = list(range(0, size - macro + stride, stride))
    starts = [min(st, size - macro) for st in starts]
    return sorted(set(starts))


@functools.lru_cache(maxsize=64)
def _lm_plan(shape_x_t, shape_y_t, h, w, psz, strides, macro):
    """Fitted sizes, crop starts and the total fold weight (clipped at
    1e-10) of `gpnn_lowmem_retarget`."""
    (pt, p, _), (st, s, _) = psz, strides
    macro = fit_patch_size(macro, p, s)
    fit_h = fit_patch_size(h, p, s)
    fit_w = fit_patch_size(w, p, s)
    fit_tx = fit_patch_size(shape_x_t, pt, st)
    macro = min(macro, fit_h, fit_w)
    hs = _macro_starts(fit_h, macro, p, s)
    ws = _macro_starts(fit_w, macro, p, s)
    weight = np.zeros((fit_tx, fit_h, fit_w), np.float32)
    w_crop = fold_weight((fit_tx, macro, macro), psz, strides)
    for h0 in hs:
        for w0 in ws:
            weight[:, h0:h0 + macro, w0:w0 + macro] += w_crop
    weight = np.clip(weight, 1e-10, None)
    return macro, fit_tx, fit_h, fit_w, tuple(hs), tuple(ws), weight


@dataclasses.dataclass(frozen=True, eq=False)
class CropPlan:
    """The crops of one NN retarget: patch size psz (pt, p, p) and strides
    (st, s, s); crop starts hs x ws (row-major crop order), each crop
    crop_hw (mh, mw); the fitted x extent fit = (fit_tx, fit_h, fit_w)
    and y frame count fit_ty; weight (fit_tx, fit_h, fit_w), the number
    of patches covering each voxel clipped at 1e-10."""
    psz: tuple
    strides: tuple
    hs: tuple
    ws: tuple
    crop_hw: tuple
    fit: tuple
    fit_ty: int
    weight: np.ndarray

    @property
    def grid(self):
        """(ntx, nty, nh, nw): temporal patches of x and y, spatial
        patches of a crop."""
        (pt, ph, pw), (st, sh, sw) = self.psz, self.strides
        mh, mw = self.crop_hw
        return (n_patches(self.fit[0], pt, st), n_patches(self.fit_ty, pt, st),
                n_patches(mh, ph, sh), n_patches(mw, pw, sw))


def lowmem_plan(Tx, Ty, H, W, psz, strides, macro_block):
    """`gpnn_lowmem_retarget`'s macro-block crops (`_lm_plan`)."""
    macro, fit_tx, fit_h, fit_w, hs, ws, weight = _lm_plan(
        Tx, Ty, H, W, psz, strides, macro_block)
    return CropPlan(psz, strides, hs, ws, (macro, macro),
                    (fit_tx, fit_h, fit_w),
                    fit_patch_size(Ty, psz[0], strides[0]), weight)


def direct_plan(Tx, Ty, H, W, psz, strides):
    """`gpnn_direct_loss`'s single crop over the fitted frame."""
    (pt, ph, pw), (st, sh, sw) = psz, strides
    ft = fit_patch_size(Tx, pt, st)
    fh = fit_patch_size(H, ph, sh)
    fw = fit_patch_size(W, pw, sw)
    weight = np.clip(fold_weight((ft, fh, fw), psz, strides), 1e-10, None)
    return CropPlan(psz, strides, (0,), (0,), (fh, fw), (ft, fh, fw),
                    fit_patch_size(Ty, pt, st), weight)


# ---------------------------------------------------------------------------
# plain versions of K11 and K12
# ---------------------------------------------------------------------------

def extract_patches_3d(x, psz, strides):
    """x (C, T, H, W) -> (nt, nh, nw, C * pt * ph * pw), the flat channel
    ordered (C, dt, dy, dx) as the JAX package's patch extraction."""
    (pt, ph, pw), (st, sh, sw) = psz, strides
    v = x.unfold(1, pt, st).unfold(2, ph, sh).unfold(3, pw, sw)
    nt, nh, nw = v.shape[1:4]
    return v.permute(1, 2, 3, 0, 4, 5, 6).reshape(nt, nh, nw, -1)


def _fold_axis(v, length, stride):
    """v (..., n, p) -> (..., length): out[i * stride + dp] += v[i, dp]."""
    n, p = v.shape[-2], v.shape[-1]
    out = torch.zeros(v.shape[:-2] + (length,), dtype=v.dtype,
                      device=v.device)
    span = (n - 1) * stride + 1
    for dp in range(p):
        out[..., dp:dp + span:stride] += v[..., :, dp]
    return out


def fold_patches_3d(patches, out_shape, strides):
    """Overlap-add, the inverse of extraction: patches (nt, nh, nw, C, pt,
    ph, pw) -> (C, T, H, W), folded along w, then h, then t."""
    T, H, W = out_shape
    st, sh, sw = strides
    v = patches.permute(3, 0, 4, 1, 5, 2, 6)      # (C, nt, pt, nh, ph, nw, pw)
    v = _fold_axis(v, W, sw)                      # (C, nt, pt, nh, ph, W)
    v = v.movedim((3, 4), (-2, -1))               # (C, nt, pt, W, nh, ph)
    v = _fold_axis(v, H, sh)                      # (C, nt, pt, W, H)
    v = v.movedim((1, 2), (-2, -1))               # (C, W, H, nt, pt)
    v = _fold_axis(v, T, st)                      # (C, W, H, T)
    return v.permute(0, 3, 2, 1)


def _pairwise_sqdist(X, Y):
    """X (B, n, d), Y (B, m, d) -> (B, n, m) f32 (||X||^2 + ||Y||^2 -
    2 X.Y) / d.  bf16 inputs are widened to f32 first (exact: their
    products are f32 values)."""
    X, Y = X.float(), Y.float()
    xx = torch.einsum("bnd,bnd->bn", X, X)[..., :, None]
    yy = torch.einsum("bmd,bmd->bm", Y, Y)[..., None, :]
    xy = torch.bmm(X, Y.transpose(1, 2))
    return (xx + yy - 2.0 * xy) / X.shape[-1]


def _pairwise_ssim_dist(X, Y):
    """X (B, n, d), Y (B, m, d) -> (B, n, m) f32: 1 - SSIM of every pair
    from whole-patch statistics (the JAX package's `_pairwise_ssim_dist`:
    lower is more similar), mean and two-pass variance per row; bf16
    inputs are widened to f32 first."""
    X, Y = X.float(), Y.float()
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    d = X.shape[-1]
    mx, my = X.mean(-1), Y.mean(-1)
    vx = ((X - mx[..., None]) ** 2).mean(-1)
    vy = ((Y - my[..., None]) ** 2).mean(-1)
    xy = torch.bmm(X, Y.transpose(1, 2)) / d
    cov = xy - mx[..., :, None] * my[..., None, :]
    num = (2 * mx[..., :, None] * my[..., None, :] + C1) * (2 * cov + C2)
    den = ((mx ** 2)[..., :, None] + (my ** 2)[..., None, :] + C1) \
        * (vx[..., :, None] + vy[..., None, :] + C2)
    return 1.0 - num / den


DIST_FNS = {"mse": _pairwise_sqdist, "ssim": _pairwise_ssim_dist}


def normalized_dist(dist, alpha=None, colmin=None):
    """The (B, n, m) distances, each column divided by (alpha + its
    minimum over n) when alpha is given (the JAX package's
    `nn_indices_from_dist` before its argmin); NaN propagates through the
    minimum.  colmin (B, m), when given, replaces the minimum (the
    frame-parallel loss's minima over every rank's x)."""
    if alpha is None:
        return dist
    if colmin is None:
        colmin = torch.amin(dist, dim=1)
    return dist / (alpha + colmin[:, None, :])


def _fitted(x, y, plan):
    """x and y cut to the plan's fitted extent."""
    ft, fh, fw = plan.fit
    return x[:, :ft, :fh, :fw], y[:, :plan.fit_ty, :fh, :fw]


def _crops(x, plan):
    mh, mw = plan.crop_hw
    return [x[..., h0:h0 + mh, w0:w0 + mw] for h0 in plan.hs
            for w0 in plan.ws]


def nn_dist_plain(x, y, plan, alpha=None, dist_fn="mse", colmin=None):
    """The distances K11 minimizes: (n_crops, nh * nw, ntx, nty) f32, per
    crop and spatial patch column, between every temporal x patch and
    every temporal y patch under `dist_fn` ("mse" or "ssim",
    `normalized_dist` when alpha is given, with the minima colmin
    (n_crops, nh * nw, nty) when given).  x (C, Tx, H, W), y (C, Ty, H,
    W), f32 or bf16."""
    dist = DIST_FNS[dist_fn]
    out = []
    for ci, (xc, yc) in enumerate(zip(*(_crops(t, plan)
                                        for t in _fitted(x, y, plan)))):
        Xp = extract_patches_3d(xc, plan.psz, plan.strides)
        Yp = extract_patches_3d(yc, plan.psz, plan.strides)
        ntx, nh, nw, dim = Xp.shape
        Xf = Xp.reshape(ntx, nh * nw, dim).transpose(0, 1)
        Yf = Yp.reshape(Yp.shape[0], nh * nw, dim).transpose(0, 1)
        out.append(normalized_dist(dist(Xf, Yf), alpha,
                                   None if colmin is None else colmin[ci]))
    return torch.stack(out)


def nn_argmin_plain(x, y, plan, alpha=None, dist_fn="mse", colmin=None):
    """Plain version of K11 (and of its ssim mode, and with colmin of its
    given-minima mode).  Returns (n_crops, nh * nw, ntx) int32: for every
    crop, spatial patch column and temporal x patch, the index of its
    nearest temporal y patch in the same column: `nn_dist_plain`'s argmin,
    the first NaN, else the first minimum (`jnp.argmin`'s and
    `torch.argmin`'s rule)."""
    return torch.argmin(nn_dist_plain(x, y, plan, alpha, dist_fn, colmin),
                        dim=3).to(torch.int32)


def nn_colmin_plain(x, y, plan):
    """Plain version of K11's minima mode: (n_crops, nh * nw, nty) f32,
    each column's least "mse" distance over the temporal x patches (NaN
    propagates)."""
    return torch.amin(nn_dist_plain(x, y, plan), dim=2)


def parent_indices(nn, plan, parent):
    """The indices of `nn_fold`'s parent mode expanded to every column of
    the plan's crops: (n_crops, nh / f * nw / f, ntx) -> (n_crops, nh *
    nw, ntx), column (ih, iw) taking its parent's (ih // f, iw // f)."""
    if parent == 1:
        return nn
    _, _, nh, nw = plan.grid
    n_crops, _, ntx = nn.shape
    g = nn.reshape(n_crops, nh // parent, nw // parent, ntx)
    g = g.repeat_interleave(parent, dim=1).repeat_interleave(parent, dim=2)
    return g.reshape(n_crops, nh * nw, ntx)


def nn_fold_plain(y, nn, plan, parent=1, numer=False):
    """Plain version of K12 (and of its parent and numerator modes).  y
    (C, Ty, H, W) f32 or bf16; nn from `nn_argmin` (with parent f, one
    index per f x f columns: `parent_indices`).  Returns y2x (C, fit_tx,
    fit_h, fit_w) f32: the selected y patches folded per crop, the crops
    added, divided by plan.weight unless numer."""
    nn = parent_indices(nn, plan, parent)
    C = y.shape[0]
    ft, fh, fw = plan.fit
    mh, mw = plan.crop_hw
    ntx = plan.grid[0]
    y = y[:, :plan.fit_ty, :fh, :fw]
    y2x = torch.zeros((C, ft, fh, fw), dtype=torch.float32, device=y.device)
    ci = 0
    for h0 in plan.hs:
        for w0 in plan.ws:
            Yp = extract_patches_3d(y[..., h0:h0 + mh, w0:w0 + mw],
                                    plan.psz, plan.strides).float()
            nty, nh, nw, dim = Yp.shape
            Yf = Yp.reshape(nty, nh * nw, dim).transpose(0, 1)
            sel = torch.take_along_dim(Yf, nn[ci].long()[..., None], dim=1)
            sel = sel.transpose(0, 1).reshape(
                (ntx, nh, nw, C) + tuple(plan.psz))
            y2x[..., h0:h0 + mh, w0:w0 + mw] += fold_patches_3d(
                sel, (ft, mh, mw), plan.strides)
            ci += 1
    if numer:
        return y2x
    return y2x / torch.from_numpy(plan.weight).to(y.device)[None]


def banded_temporal_dist_plain(d1, pt, st, ntx, nty):
    """Plain Q9, the JAX package's `banded_temporal_dist`: temporal-patch
    distances as a banded sum of per-frame distances, dist(i, j) =
    sum_{k < pt} d1(i * st + k, j * st + k), added in k order.  d1 (B,
    Fx, Fy) -> (B, ntx, nty)."""
    def band(k):
        return d1[:, k:k + (ntx - 1) * st + 1:st, k:k + (nty - 1) * st + 1:st]
    dist = band(0)
    for k in range(1, pt):
        dist = dist + band(k)
    return dist


def _frame_patches(xc, plan):
    """(nh * nw, T, C * ph * pw): the per-frame (1, ph, pw) patches of every
    frame of a crop xc (C, T, mh, mw), one row per spatial column."""
    (_, ph, pw), (_, sh, sw) = plan.psz, plan.strides
    P = extract_patches_3d(xc, (1, ph, pw), (1, sh, sw))
    T, nh, nw, d = P.shape
    return P.reshape(T, nh * nw, d).transpose(0, 1)


def nn_band_dist_plain(x, y, plan, alpha=None, scale_by_pt=False):
    """The distances K18 minimizes: (n_crops, nh * nw, ntx, nty) f32, the
    banded sums of the per-frame patch distances `_pairwise_sqdist` (/ pt
    when scale_by_pt, as `_nn_retarget_temporal` does before alpha), then
    `normalized_dist`.  x (C, Tx, H, W), y (C, Ty, H, W), f32 or bf16."""
    (pt, _, _), (st, _, _) = plan.psz, plan.strides
    ntx, nty = plan.grid[:2]
    out = []
    for xc, yc in zip(*(_crops(t, plan) for t in _fitted(x, y, plan))):
        d1 = _pairwise_sqdist(_frame_patches(xc, plan),
                              _frame_patches(yc, plan))
        dist = banded_temporal_dist_plain(d1, pt, st, ntx, nty)
        if scale_by_pt:
            dist = dist / pt
        out.append(normalized_dist(dist, alpha))
    return torch.stack(out)


def nn_band_argmin_plain(x, y, plan, alpha=None, scale_by_pt=False,
                         both_directions=False):
    """Plain version of K18.  Returns (rows, cols): rows (n_crops, nh * nw,
    ntx) int32, the nearest temporal y patch of every temporal x patch
    (`nn_band_dist_plain`'s argmin over j: the first NaN, else the first
    minimum), and with both_directions cols (n_crops, nh * nw, nty), the
    nearest x patch of every y patch (its argmin over i), else None."""
    dist = nn_band_dist_plain(x, y, plan, alpha, scale_by_pt)
    rows = torch.argmin(dist, dim=3).to(torch.int32)
    cols = torch.argmin(dist, dim=2).to(torch.int32) if both_directions \
        else None
    return rows, cols


def nn_band_err_plain(x, y, plan, nn, reverse=False, dtype=torch.float32):
    """Plain version of K19.  (n_crops,) f32: per crop, the sum over the
    spatial columns, the source's temporal patches i, their frames k < pt
    and the per-frame patch channels of |target[nn(i) * st + k] -
    source[i * st + k]|; the source is x and nn K18's rows, or with
    reverse y and K18's cols.  dtype: the type the terms are widened to
    and summed in (float64 for a reference sum)."""
    (pt, _, _), (st, _, _) = plan.psz, plan.strides
    src, tar = _fitted(x, y, plan)
    if reverse:
        src, tar = tar, src
    ns = nn.shape[2]
    nt = plan.grid[0] if reverse else plan.grid[1]
    sums = []
    for ci, (sc, tc) in enumerate(zip(_crops(src, plan), _crops(tar, plan))):
        A = _frame_patches(sc, plan).to(dtype)
        B = _frame_patches(tc, plan).to(dtype)
        idx = nn[ci].long()[..., None]
        total = 0.0
        for k in range(pt):
            sel = torch.take_along_dim(B[:, k:k + (nt - 1) * st + 1:st], idx,
                                       dim=1)
            total = total + (sel - A[:, k:k + (ns - 1) * st + 1:st]).abs().sum()
        sums.append(total)
    return torch.stack(sums)


# ---------------------------------------------------------------------------
# K11, K12, K18 and K19
# ---------------------------------------------------------------------------

# crop starts per axis that K11 and K12 take (csrc/nn_crops.cuh kMaxStarts)
_MAX_STARTS = 64


def _plan_ints(plan):
    """The plan as the int array that csrc/nn_crops.cuh unpacks into
    NnCrops: patch size, strides, crop size, `grid`, the start counts, then
    the starts hs and ws."""
    if max(len(plan.hs), len(plan.ws)) > _MAX_STARTS:
        raise ValueError(f"{len(plan.hs)} x {len(plan.ws)} crops: the NN "
                         f"kernels take at most {_MAX_STARTS} starts per axis")
    vals = [*plan.psz, *plan.strides, *plan.crop_hw, *plan.grid,
            len(plan.hs), len(plan.ws), *plan.hs, *plan.ws]
    return (ctypes.c_int * len(vals))(*vals)


def _check_nn_inputs(name, x, y, plan):
    dev = x.device
    kernels.check_tensor(f"{name}.x", x, dev, dtype=_NN_DTYPES)
    kernels.check_tensor(f"{name}.y", y, dev, dtype=x.dtype)
    if x.dim() != 4 or y.dim() != 4 or x.shape[0] != y.shape[0] \
            or x.shape[2:] != y.shape[2:]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must be (C, T, H, W) with "
                         "equal C, H, W")
    ft, fh, fw = plan.fit
    if ft > x.shape[1] or plan.fit_ty > y.shape[1] or fh > x.shape[2] \
            or fw > x.shape[3]:
        raise ValueError(f"{name}: the plan's fitted extent {plan.fit} "
                         f"exceeds x {tuple(x.shape)}")


# K11's tensor-core kernel (csrc/nn_argmin_mma.cu:mma_layout): shared bytes
# up to which a block takes more columns, and the column slots it has
_MMA_COL_BUDGET = 88 * 1024
_MMA_COL_SLOTS = 8


def mma_frame_pitch(cpp):
    """The staged pitch of one frame's cpp = C ph pw values in K11's
    tensor-core kernel: padded to 8 times an odd number of bf16, so rows
    stay 16-byte aligned and an ldmatrix's eight rows (pitch fp) fall in
    distinct bank groups."""
    u = -(-cpp // 8)
    return 8 * (u + 1 - u % 2)


def mma_layout(plan, C):
    """K11's tensor-core layout for C channels: (fp, the frame pitch; ncb,
    columns a block; the block's shared bytes).  A column holds the nfx x
    and nfy y footprint frames (bf16, pitch fp; later the (ntx, nty)
    distances in their place), their sums of squares, the norms, the
    column minima and the Gram of the frames (nfx, nfy) or, where that
    takes fewer rounds of warp tasks, of the patches (ntx, nty): room for
    the larger."""
    (pt, ph, pw), (st, _, _) = plan.psz, plan.strides
    ntx, nty = plan.grid[:2]
    cpp = C * ph * pw
    fp = mma_frame_pitch(cpp)
    nfx, nfy = (ntx - 1) * st + pt, (nty - 1) * st + pt
    nf = nfx + nfy
    col = max(2 * nf * fp, 4 * ntx * nty) \
        + 4 * (nf + ntx + 2 * nty + nfx * nfy)
    col = -(-col // 16) * 16
    shared = 8 * _MMA_COL_SLOTS + 8 * cpp   # column bases, offsets
    ncb = 1
    while ncb < _MMA_COL_SLOTS and 2 * ncb * col + shared <= _MMA_COL_BUDGET:
        ncb *= 2
    return fp, ncb, ncb * col + shared


# K11's and K18's CUDA-core search (csrc/nn_argmin.cu:tile_layout): an
# output tile's threads, columns a block at most, chain entries a stage at
# least (where ph allows), Gram rows of an output tile at most, the register
# tiles compiled (rows x columns a thread, smallest first), shared bytes
# that leave room for two blocks an SM
_TILE_COL_THREADS = 64
_TILE_COLS = 4
_TILE_STAGE = 24
_TILE_ROWS = 64
_TILE_SHAPES = ((6, 6), (7, 6), (7, 7), (8, 8))
_SMEM_HALF = 113 * 1024


def _tile_split(n):
    """(rows a thread, output tiles) for n Gram rows over 8 thread rows:
    tiles of at most _TILE_ROWS rows, as even as 8-row steps allow."""
    n_tiles = -(-n // _TILE_ROWS)
    per = -(-n // n_tiles)
    return -(-per // 8), n_tiles


def tile_layout(plan, C, mode):
    """The CUDA-core search's layout for C channels and mode "mse", "ssim"
    (K11: Gram rows the temporal patches) or "band" (K18: the frames), as
    a dict.  Thread (ti, tj) of an output tile's 8 x 8 holds ra rows and
    rb columns (csrc/nn_argmin.cu:slot_row), (ra, rb) the least of
    _TILE_SHAPES that covers the tile; n_ti x n_tj tiles a column.  A
    block takes ncb neighbouring columns of one row of a crop's columns
    (the row in `chunks` blocks), 64 threads each.  Its shared floats: a
    ring of two stages, each nb dy rows of the block's window (wb = pw +
    (ncb - 1) sw positions), a position's x rows at pitch px = 8 ra + 4
    and y rows at py = 8 rb + 4; the columns' Grams (nx, ny | 1), over
    the ring when a column is one tile; then per column K18's band (ntx,
    nty | 1), the norms or means, the ssim variances and the column
    minima; each padded to 16 bytes; for ssim the offsets of x and y (8 d
    bytes).  ncb: the most, up to 4, that leave room for two blocks an SM
    (_SMEM_HALF), else for one (_SMEM_LIMIT)."""
    (pt, ph, pw), (st, _, sw) = plan.psz, plan.strides
    ntx, nty, _, nw = plan.grid
    band = mode == "band"
    nx = (ntx - 1) * st + pt if band else ntx
    ny = (nty - 1) * st + pt if band else nty
    d = C * (1 if band else pt) * ph * pw
    (ra, n_ti), (rb, n_tj) = _tile_split(nx), _tile_split(ny)
    ra, rb = next(t for t in _TILE_SHAPES if t[0] >= ra and t[1] >= rb)
    px, py = 8 * ra + 4, 8 * rb + 4
    nb = min(ph, -(-_TILE_STAGE // pw))
    gram = -(-nx * (ny | 1) // 4) * 4
    rest = -(-((ntx * (nty | 1) if band else 0) + nx + ny
               + (nx + ny if mode == "ssim" else 0) + nty) // 4) * 4
    one = n_ti * n_tj == 1
    shared = 8 * d if mode == "ssim" else 0

    def fit(n):
        chunks = -(-nw // n)
        ncb = -(-nw // chunks)
        wb = pw + (ncb - 1) * sw
        stage = nb * wb * (px + py)
        o_rest = max(2 * stage, ncb * gram) if one \
            else 2 * stage + ncb * gram
        return dict(ncb=ncb, chunks=chunks, wb=wb, stage=stage,
                    o_gram=0 if one else 2 * stage, o_rest=o_rest,
                    smem=4 * (o_rest + ncb * rest) + shared)
    for limit in (_SMEM_HALF, _SMEM_LIMIT):
        for n in range(_TILE_COLS, 0, -1):
            lay = fit(n)
            if lay["smem"] <= limit:
                break
        if lay["smem"] <= _SMEM_HALF:
            break
    return dict(lay, ra=ra, rb=rb, n_ti=n_ti, n_tj=n_tj, px=px, py=py,
                nb=nb, gram=gram, rest=rest,
                threads=lay["ncb"] * _TILE_COL_THREADS)


def _argmin_smem(plan, d, dist_fn="mse", bf16=False):
    """Shared bytes of one K11 block: the tensor-core kernel's for bf16
    "mse" searches whose layout fits _SMEM_LIMIT (`mma_layout`; the C
    entry point makes the same choice, csrc/nn_argmin_mma.cu:nn_mma_fits),
    the CUDA-core search's otherwise (`tile_layout`: f32, ssim, and bf16
    searches over videos too long to stage)."""
    C = d // int(np.prod(plan.psz))
    if bf16 and dist_fn == "mse":
        smem = mma_layout(plan, C)[2]
        if smem <= _SMEM_LIMIT:
            return smem
    return tile_layout(plan, C, dist_fn)["smem"]


def nn_argmin(x, y, plan, alpha=None, dist_fn="mse"):
    """K11: the nearest temporal y patch of every temporal x patch, per
    crop and spatial patch column (`nn_argmin_plain`'s function), under
    the "mse" or (its ssim mode, counted as ``nn_argmin_ssim``) the "ssim"
    distance.  x (C, Tx, H, W) and y (C, Ty, H, W) contiguous, both f32
    or both bf16 (f32 sums; bf16 "mse" on the tensor cores,
    ``csrc/nn_argmin_mma.cu``, where its layout fits shared memory,
    `_argmin_smem`; the other bf16 searches widened to f32, exactly,
    before the launch of the CUDA-core search); alpha None or a float
    (the completeness normalization).  Returns (n_crops, nh * nw, ntx)
    int32."""
    _check_nn_inputs("nn_argmin", x, y, plan)
    if dist_fn not in DIST_FNS:
        raise ValueError(f"nn_argmin: unknown patch distance '{dist_fn}'")
    if x.device.type == "cpu":
        return nn_argmin_plain(x, y, plan, alpha, dist_fn)
    x, y, bf16, smem = _argmin_launch_inputs("nn_argmin", x, y, plan,
                                             dist_fn)
    ssim = dist_fn == "ssim"
    C, Tx, H, W = x.shape
    ntx, _, nh, nw = plan.grid
    n_crops = len(plan.hs) * len(plan.ws)
    nn = torch.empty((n_crops, nh * nw, ntx), dtype=torch.int32,
                     device=x.device)
    err = kernels.library().vl3d_nn_argmin(
        x.data_ptr(), y.data_ptr(), int(bf16), C, Tx,
        y.shape[1], H, W, _plan_ints(plan), int(ssim),
        int(alpha is not None), float(alpha or 0.0), smem, nn.data_ptr(),
        kernels.stream_ptr(x.device))
    name = "nn_argmin_ssim" if ssim else "nn_argmin"
    kernels.LAUNCHES[name] += 1
    kernels.check_launch(name, err)
    return nn


def nn_argmin_colmin(x, y, plan):
    """K11's minima mode (counted as ``nn_argmin_colmin``): `nn_colmin_plain`'s
    (n_crops, nh * nw, nty) f32 column minima of the "mse" distances, from
    `nn_argmin`'s kernel for these inputs, which writes them where it
    would add alpha and searches nothing.  The frame-parallel gpnn loss
    takes their minimum over its ranks for `nn_argmin_given`."""
    _check_nn_inputs("nn_argmin_colmin", x, y, plan)
    if x.device.type == "cpu":
        return nn_colmin_plain(x, y, plan)
    x, y, bf16, smem = _argmin_launch_inputs("nn_argmin_colmin", x, y, plan)
    C, Tx, H, W = x.shape
    _, nty, nh, nw = plan.grid
    n_crops = len(plan.hs) * len(plan.ws)
    cmin = torch.empty((n_crops, nh * nw, nty), dtype=torch.float32,
                       device=x.device)
    err = kernels.library().vl3d_nn_argmin_colmin(
        x.data_ptr(), y.data_ptr(), int(bf16), C, Tx, y.shape[1], H, W,
        _plan_ints(plan), smem, cmin.data_ptr(), kernels.stream_ptr(x.device))
    kernels.LAUNCHES["nn_argmin_colmin"] += 1
    kernels.check_launch("nn_argmin_colmin", err)
    return cmin


def nn_argmin_given(x, y, plan, alpha, colmin):
    """K11's given-minima mode (counted as ``nn_argmin_given``): `nn_argmin`
    under the "mse" distance with each column divided by alpha + colmin
    (n_crops, nh * nw, nty) f32, the minima over every rank's x, in place
    of its own.  With colmin = `nn_argmin_colmin(x, y, plan)` the indices
    are `nn_argmin(x, y, plan, alpha)`'s bit for bit."""
    _check_nn_inputs("nn_argmin_given", x, y, plan)
    _, nty, nh, nw = plan.grid
    n_crops = len(plan.hs) * len(plan.ws)
    kernels.check_tensor("nn_argmin_given.colmin", colmin, x.device,
                         dtype=torch.float32, shape=(n_crops, nh * nw, nty))
    if x.device.type == "cpu":
        return nn_argmin_plain(x, y, plan, alpha, colmin=colmin)
    x, y, bf16, smem = _argmin_launch_inputs("nn_argmin_given", x, y, plan)
    C, Tx, H, W = x.shape
    nn = torch.empty((n_crops, nh * nw, plan.grid[0]), dtype=torch.int32,
                     device=x.device)
    err = kernels.library().vl3d_nn_argmin_given(
        x.data_ptr(), y.data_ptr(), int(bf16), C, Tx, y.shape[1], H, W,
        _plan_ints(plan), float(alpha), colmin.data_ptr(), smem,
        nn.data_ptr(), kernels.stream_ptr(x.device))
    kernels.LAUNCHES["nn_argmin_given"] += 1
    kernels.check_launch("nn_argmin_given", err)
    return nn


def _argmin_launch_inputs(name, x, y, plan, dist_fn="mse"):
    """(x, y, bf16, smem) of a K11 launch: bf16 "mse" stays bf16 for the
    tensor cores where their layout fits, the other bf16 searches are
    widened to f32, exactly, for the CUDA-core search, which reads f32.
    Raises where the block's shared memory passes _SMEM_LIMIT."""
    C = x.shape[0]
    ntx, nty = plan.grid[:2]
    d = C * int(np.prod(plan.psz))
    bf16 = x.dtype == torch.bfloat16
    smem = _argmin_smem(plan, d, dist_fn, bf16)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: {ntx} x {nty} patches of dim {d} need "
                         f"{smem} B of shared memory (limit {_SMEM_LIMIT})")
    if bf16 and (dist_fn == "ssim" or mma_layout(plan, C)[2] > _SMEM_LIMIT):
        x, y, bf16 = x.float(), y.float(), False
    return x.contiguous(), y.contiguous(), bf16, smem


def _band_smem(plan, d):
    """Shared bytes of one K18 block (`tile_layout`'s "band" mode)."""
    return tile_layout(plan, d // (plan.psz[1] * plan.psz[2]),
                       "band")["smem"]


def nn_band_argmin(x, y, plan, alpha=None, scale_by_pt=False,
                   both_directions=False):
    """K18: `nn_band_argmin_plain`'s function, with no patch tensor and no
    distance matrix in device memory.  x (C, Tx, H, W) and y (C, Ty, H, W)
    contiguous, both f32 or both bf16 (widened to f32 before the launch,
    f32 sums);
    alpha None or a float.  Returns (rows (n_crops, nh * nw, ntx) int32,
    cols (n_crops, nh * nw, nty) int32 or None)."""
    _check_nn_inputs("nn_band_argmin", x, y, plan)
    if x.device.type == "cpu":
        return nn_band_argmin_plain(x, y, plan, alpha, scale_by_pt,
                                    both_directions)
    C, Tx, H, W = x.shape
    ntx, nty, nh, nw = plan.grid
    d = C * plan.psz[1] * plan.psz[2]
    smem = _band_smem(plan, d)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"nn_band_argmin: {plan.fit[0]} x {plan.fit_ty} "
                         f"frames of patch dim {d} need {smem} B of shared "
                         f"memory (limit {_SMEM_LIMIT})")
    # the CUDA-core search reads f32: bf16 is widened here, exactly
    x, y = x.float(), y.float()
    n_crops = len(plan.hs) * len(plan.ws)
    rows = torch.empty((n_crops, nh * nw, ntx), dtype=torch.int32,
                       device=x.device)
    cols = torch.empty((n_crops, nh * nw, nty), dtype=torch.int32,
                       device=x.device) if both_directions else None
    err = kernels.library().vl3d_nn_band_argmin(
        x.data_ptr(), y.data_ptr(), 0, C, Tx,
        y.shape[1], H, W, _plan_ints(plan), int(scale_by_pt),
        int(alpha is not None), float(alpha or 0.0), smem, rows.data_ptr(),
        cols.data_ptr() if both_directions else None,
        kernels.stream_ptr(x.device))
    kernels.LAUNCHES["nn_band_argmin"] += 1
    kernels.check_launch("nn_band_argmin", err)
    return rows, cols


# K19's layout (csrc/nn_band_err.cu:band_err_layout): a block takes the
# largest power of two up to 8 of columns with at most _ERR_TILE_UNITS
# (column, channel) pairs, about _ERR_UNITS (column, channel, patch
# range) units, at most _ERR_MAX_THREADS threads, the register window at
# st = 1 for pt in _ERR_WINDOWS, the block's target footprint staged in
# shared memory where it takes at most _ERR_STAGE_MAX bytes
_ERR_TILE_UNITS, _ERR_UNITS, _ERR_MAX_THREADS = 1536, 256, 512
_ERR_STAGE_MAX = 64 * 1024
_ERR_WINDOWS = (3, 5, 7)
# the keys of nn_band_err_layout, in the order vl3d_nn_band_err_layout
# returns them
NN_BAND_ERR_LAYOUT_KEYS = ("threads", "groups", "span", "units",
                           "per_thread", "chain", "window", "tw", "tiles",
                           "fw", "stage", "smem")


def _err_shape(plan, reverse):
    """(ns, nt, tt): source and target patches of one direction and the
    target frames they read."""
    (pt, _, _), (st, _, _) = plan.psz, plan.strides
    ntx, nty = plan.grid[:2]
    ns, nt = (nty, ntx) if reverse else (ntx, nty)
    return ns, nt, (nt - 1) * st + pt


def nn_band_err_layout(plan, C, reverse=False, tw=-1, stage=-1):
    """K19's block for `plan`, C channels and one direction.  A block takes
    `tw` neighbouring columns of one row of a crop (`tiles` blocks a row;
    tw -1: the largest power of two up to 8 with tw d at most
    _ERR_TILE_UNITS), whose footprint is `fw` = (tw - 1) sw + pw pixels
    wide; its work is `units` = `groups` x tw x d units (a column, a
    channel q of the d = C ph pw and a range of `span` consecutive source
    patches; `groups` = _ERR_UNITS / (tw d) ranges, at least 1);
    `threads` take `per_thread` units each in turn (the fewest that keep
    threads within _ERR_MAX_THREADS, the units over it rounded up to
    warps); `chain` the longest f32 chain (span * pt terms); `window` pt
    where the source frames slide through registers (st = 1, pt 3, 5 or
    7), else 0; `stage` 1 where the footprint's target window (tt = (nt -
    1) st + pt frames x C ph fw, f32) is staged in shared memory (stage
    -1: where it takes at most _ERR_STAGE_MAX bytes; 0 never; 1 where it
    fits _SMEM_LIMIT); `smem` the dynamic shared bytes (the footprint's
    target offsets, the tile's selected patches, 32 warp sums, the
    stage)."""
    (pt, ph, pw), (st, _, sw) = plan.psz, plan.strides
    nw = plan.grid[3]
    ns, _, tt = _err_shape(plan, reverse)
    d = C * ph * pw
    n = max(ns, 1)
    if tw <= 0:
        tw = 8
        while tw > 1 and tw * d > _ERR_TILE_UNITS:
            tw //= 2
    tw = min(tw, max(nw, 1))
    fw = (tw - 1) * sw + pw
    g = min(max(_ERR_UNITS // (tw * d), 1), n)
    span = -(-n // g)
    groups = -(-n // span)
    units = groups * tw * d
    per_thread = -(-units // _ERR_MAX_THREADS)
    threads = -(-(-(-units // per_thread)) // 32) * 32
    nf = C * ph * fw
    base = 4 * (nf + tw * n + 32)
    stg = 4 * tt * nf
    staged = stg <= _ERR_STAGE_MAX if stage < 0 else \
        (stage > 0 and base + stg <= _SMEM_LIMIT)
    return dict(threads=threads, groups=groups, span=span, units=units,
                per_thread=per_thread, chain=span * pt,
                window=pt if st == 1 and pt in _ERR_WINDOWS else 0, tw=tw,
                tiles=-(-nw // tw), fw=fw, stage=int(staged),
                smem=base + (stg if staged else 0))


def kernel_nn_band_err_layout(plan, C, reverse=False, tw=-1, stage=-1):
    """K19's layout as csrc/nn_band_err.cu computes it
    (vl3d_nn_band_err_layout; needs the CUDA library), keyed as
    `nn_band_err_layout`."""
    (pt, ph, pw), (st, _, sw) = plan.psz, plan.strides
    ns, _, tt = _err_shape(plan, reverse)
    out = (ctypes.c_longlong * len(NN_BAND_ERR_LAYOUT_KEYS))()
    kernels.library().vl3d_nn_band_err_layout(
        C, ph, pw, sw, plan.grid[3], ns, pt, st, tt, tw, stage, out)
    return dict(zip(NN_BAND_ERR_LAYOUT_KEYS, out))


def _check_err_limits(x, y, plan, ns, reverse):
    """K19's limits: its shared memory without the stage (the layout's
    smem at stage 0) within _SMEM_LIMIT, fewer than 2^31 terms a column
    and elements an input."""
    d = x.shape[0] * plan.psz[1] * plan.psz[2]
    if nn_band_err_layout(plan, x.shape[0], reverse, stage=0)["smem"] \
            > _SMEM_LIMIT \
            or ns * plan.psz[0] * d >= 2 ** 31 \
            or max(x.numel(), y.numel()) >= 2 ** 31:
        raise ValueError(f"nn_band_err: {ns} patches of {plan.psz[0]} "
                         f"frames of dim {d} on inputs of {x.numel()} and "
                         f"{y.numel()} elements exceed the kernel's limits")


def nn_band_err_launch(x, y, plan, nn, reverse=False, tw=-1, stage=-1):
    """Launch K19 on card tensors (no checks, no count): tw columns a block
    and the target read from device memory (stage 0) or staged (1), -1 as
    the layout chooses.  For `nn_band_err` and the card's comparison of
    the forms."""
    ntx, nty, nh, nw = plan.grid
    ns, nt = (nty, ntx) if reverse else (ntx, nty)
    n_crops = len(plan.hs) * len(plan.ws)
    C, _, H, W = x.shape
    src, tar = (y, x) if reverse else (x, y)
    partial = torch.empty(n_crops * nh * nw, dtype=torch.float32,
                          device=x.device)
    out = torch.empty(n_crops, dtype=torch.float32, device=x.device)
    err = kernels.library().vl3d_nn_band_err(
        src.data_ptr(), tar.data_ptr(), int(x.dtype == torch.bfloat16), C,
        src.shape[1], tar.shape[1], H, W, _plan_ints(plan), ns, nt, tw,
        stage, nn.data_ptr(), partial.data_ptr(), out.data_ptr(),
        kernels.stream_ptr(x.device))
    kernels.check_launch("nn_band_err", err)
    return out


def nn_band_err(x, y, plan, nn, reverse=False):
    """K19: `nn_band_err_plain`'s per-crop sums (n_crops,) f32, summed in a
    fixed order in f32 (bf16 inputs widened), with no atomics
    (`nn_band_err_layout`).  nn: K18's rows, or its cols with reverse.
    Shapes beyond the kernel's limits raise, on the CPU too."""
    _check_nn_inputs("nn_band_err", x, y, plan)
    ntx, nty, nh, nw = plan.grid
    ns = nty if reverse else ntx
    n_crops = len(plan.hs) * len(plan.ws)
    kernels.check_tensor("nn_band_err.nn", nn, x.device, dtype=torch.int32,
                         shape=(n_crops, nh * nw, ns))
    _check_err_limits(x, y, plan, ns, reverse)
    if x.device.type == "cpu":
        return nn_band_err_plain(x, y, plan, nn, reverse)
    out = nn_band_err_launch(x, y, plan, nn, reverse)
    kernels.LAUNCHES["nn_band_err"] += 1
    return out


# K12's block (csrc/nn_fold.cu): 32 w (a warp's lanes) by one row h by
# tb t, at most _FOLD_WARPS warps, at most _FOLD_CG channels staged at
# once, in at most _FOLD_SMEM_LIMIT shared bytes
_FOLD_W, _FOLD_WARPS, _FOLD_CG, _FOLD_SMEM_LIMIT = 32, 8, 4, 232448
# the keys of nn_fold_layout, in the order vl3d_nn_fold_layout returns them
NN_FOLD_LAYOUT_KEYS = ("tb", "cg", "rmax", "qmax", "pmax", "ntmax", "smem")


def n_span(lo, hi, p, s, n, m):
    """csrc/nn_fold.cu:n_span: the patches of size p at stride s (n of
    them in an extent m) covering some position of [lo, hi]."""
    lo, hi = max(lo, 0), min(hi, m - 1)
    if lo > hi:
        return 0
    first = max(0, -(-(lo - p + 1) // s))
    return max(0, min(n - 1, hi // s) - first + 1)


def nn_fold_layout(plan, C, Ty):
    """K12's block layout for `plan`, C channels and Ty frames of y
    (csrc/nn_fold.cu:fold_layout): `tb` t a block, `cg` channels staged at
    once, `rmax` the most (crop, ih) rows covering one output row, `qmax`
    the most (crop, iw) columns covering some w of a 32-wide tile, `pmax`
    the most (row, column) pairs covering one voxel (rmax times the most
    columns covering one w), `ntmax` the most temporal patches covering
    some t of a block, and `smem`, a block's dynamic shared bytes: the
    staged y (cg x Ty x 32 f32), the staged indices (rmax x qmax x ntmax
    ints), the row and column lists (two ints an entry) and the lanes'
    pair lists (pmax x 32 ints).  tb starts at fit_tx and cg at
    min(C, 4); while the shared bytes exceed the limit, tb halves (not
    below 8), then cg, then tb."""
    (pt, ph, pw), (st, sh, sw) = plan.psz, plan.strides
    mh, mw = plan.crop_hw
    ntx, _, nh, nw = plan.grid
    ft, fh, fw = plan.fit
    rmax = max((sum(n_span(h - h0, h - h0, ph, sh, nh, mh) for h0 in plan.hs)
                for h in range(fh)), default=0)
    qmax = max((sum(n_span(x0 - w0, min(x0 + _FOLD_W, fw) - 1 - w0, pw, sw,
                           nw, mw) for w0 in plan.ws)
                for x0 in range(0, fw, _FOLD_W)), default=0)
    cwmax = max((sum(n_span(w - w0, w - w0, pw, sw, nw, mw) for w0 in plan.ws)
                 for w in range(fw)), default=0)
    pmax = rmax * cwmax
    tb, cg = ft, min(C, _FOLD_CG)
    while True:
        ntmax = max((n_span(t0, min(t0 + tb, ft) - 1, pt, st, ntx, ft)
                     for t0 in range(0, ft, tb)), default=0)
        smem = 4 * (cg * Ty * _FOLD_W + rmax * qmax * ntmax + 2 * rmax
                    + 2 * qmax + pmax * _FOLD_W)
        if smem <= _FOLD_SMEM_LIMIT:
            break
        if tb > _FOLD_WARPS:
            tb = max(_FOLD_WARPS, (tb + 1) // 2)
        elif cg > 1:
            cg = (cg + 1) // 2
        elif tb > 1:
            tb = (tb + 1) // 2
        else:
            break
    return dict(tb=tb, cg=cg, rmax=rmax, qmax=qmax, pmax=pmax, ntmax=ntmax,
                smem=smem)


def kernel_nn_fold_layout(plan, C, Ty):
    """K12's layout as csrc/nn_fold.cu computes it (vl3d_nn_fold_layout;
    needs the CUDA library), keyed as `nn_fold_layout`, for the checks
    that the two agree."""
    out = (ctypes.c_longlong * len(NN_FOLD_LAYOUT_KEYS))()
    kernels.library().vl3d_nn_fold_layout(_plan_ints(plan), C, Ty, *plan.fit,
                                          out)
    return dict(zip(NN_FOLD_LAYOUT_KEYS, out))


def nn_fold(y, nn, plan, parent=1, numer=False):
    """K12: y2x (C, fit_tx, fit_h, fit_w) f32, `nn_fold_plain`'s function:
    for every voxel, the sum over the crops and patches covering it of the
    selected y patch's voxel (the same pixel, frame nn * st + the
    in-patch offset), divided by the number of such patches (the plan's
    fold weight).  Sums run in a fixed order in f32 (bf16 y is widened),
    with no atomics; a block stages its tile's y and indices
    (`nn_fold_layout`).  With
    parent f > 1 (the parent mode, counted as ``nn_fold_parent``) nn holds
    one index per f x f patch columns (`parent_indices`).  With numer (the
    numerator mode, counted as ``nn_fold_numer``) each voxel's sum is
    returned undivided: the frame-parallel gpnn loss divides it after the
    spill from the previous rank."""
    dev = y.device
    kernels.check_tensor("nn_fold.y", y, dev, dtype=_NN_DTYPES)
    ntx, _, nh, nw = plan.grid
    if parent < 1 or nh % parent or nw % parent:
        raise ValueError(f"nn_fold: parent factor {parent} does not divide "
                         f"the {nh} x {nw} patch columns")
    kernels.check_tensor("nn_fold.nn", nn, dev, dtype=torch.int32,
                         shape=(len(plan.hs) * len(plan.ws),
                                nh * nw // parent ** 2, ntx))
    if dev.type == "cpu":
        return nn_fold_plain(y, nn, plan, parent, numer)
    C, Ty, H, W = y.shape
    ft, fh, fw = plan.fit
    out = torch.empty((C, ft, fh, fw), dtype=torch.float32, device=dev)
    lib = kernels.library()
    err = (lib.vl3d_nn_fold_numer if numer else lib.vl3d_nn_fold)(
        y.data_ptr(), nn.data_ptr(), int(y.dtype == torch.bfloat16), C, Ty,
        H, W, _plan_ints(plan), parent, ft, fh, fw, out.data_ptr(),
        kernels.stream_ptr(dev))
    name = "nn_fold_numer" if numer else \
        "nn_fold_parent" if parent > 1 else "nn_fold"
    kernels.LAUNCHES[name] += 1
    kernels.check_launch(name, err)
    return out


# ---------------------------------------------------------------------------
# retarget and the public losses (registry: ref MPV.py:131-138)
# ---------------------------------------------------------------------------

def nn_retarget(x, y, plan, alpha=None, fast_nn_dist=False, dist_fn="mse"):
    """y2x (C, fit_tx, fit_h, fit_w) f32 for the crops of `plan` (K11 +
    K12; with fast_nn_dist, the "mse" distance and pt > 1
    `_nn_retarget_temporal`, as the JAX package's rule).  x, y are
    detached (C, T, H, W) tensors."""
    x, y = x.contiguous(), y.contiguous()
    if fast_nn_dist and dist_fn == "mse" and plan.psz[0] > 1:
        return _nn_retarget_temporal(x, y, plan, alpha)
    return nn_fold(y, nn_argmin(x, y, plan, alpha, dist_fn), plan)


def _nn_retarget_temporal(x, y, plan, alpha):
    """`nn_retarget` with the temporally decomposed search (K18, the banded
    sum divided by pt so that alpha sees the direct form's scale), then
    K12's fold: equal to the direct search up to float summation order
    (ties may break otherwise)."""
    nn, _ = nn_band_argmin(x, y, plan, alpha, scale_by_pt=True)
    return nn_fold(y, nn, plan)


def _norm_alpha(alpha):
    """alpha > 100 means disabled (ref utils_vid.py:208)."""
    if alpha is None or alpha > 100:
        return None
    return alpha


def _nn_cast(xs, ys, nn_bf16):
    """The search and fold inputs in bf16 under nn_bf16 (they carry no
    gradient); the folded target is f32 either way."""
    if nn_bf16:
        return xs.to(torch.bfloat16), ys.to(torch.bfloat16)
    return xs, ys


def gpnn_lowmem_retarget(x, y, patch_size=7, patcht_size=7, stride=2,
                         stridet=2, alpha=None, macro_block=64,
                         dist_fn="mse", fast_nn_dist=False):
    """Macro-block NN retarget.  x (C, Tx, H, W) render (loop-padded), y
    (C, Ty, H, W) video.  Returns (y2x (C, fit_tx, fit_h, fit_w) f32,
    weight-normalized, (fit_tx, fit_h, fit_w))."""
    psz = (patcht_size, patch_size, patch_size)
    strides = (stridet, stride, stride)
    plan = lowmem_plan(x.shape[1], y.shape[1], x.shape[2], x.shape[3], psz,
                       strides, macro_block)
    return nn_retarget(x, y, plan, alpha, fast_nn_dist, dist_fn), plan.fit


def gpnn_lowmem_loss(x, y, *, patch_size=7, patcht_size=7, stride=2,
                     stridet=2, alpha=1e10, rou=0, scaling=0.2,
                     macro_block=64, dist_fn="mse", fast_nn_dist=False,
                     nn_bf16=False, **_):
    """'gpnn_lm', the default stage-2 looping loss.  x (C, Tx, H, W)
    render (gradients flow); y (C, Ty, H, W) video.  The target is built
    without gradient; the loss is mean(robust(x - y2x))."""
    with torch.no_grad():
        xs, ys = _nn_cast(x.detach(), y.detach(), nn_bf16)
        y2x, (ft, fh, fw) = gpnn_lowmem_retarget(
            xs, ys, patch_size=patch_size, patcht_size=patcht_size,
            stride=stride, stridet=stridet, alpha=_norm_alpha(alpha),
            macro_block=macro_block, dist_fn=dist_fn,
            fast_nn_dist=fast_nn_dist)
    diff = x[:, :ft, :fh, :fw] - y2x
    return torch.mean(robust_lossfun(diff, rou, scaling))


def gpnn_direct_loss(x, y, *, patch_size=7, patcht_size=7, stride=1,
                     stridet=1, alpha=1e10, rou=0, scaling=0.2,
                     dist_fn="mse", fast_nn_dist=False, nn_bf16=False,
                     **_):
    """'gpnn': the whole-patch NN of one crop covering the fitted frame
    (ref utils_vid.py:265-287)."""
    psz = (patcht_size, patch_size, patch_size)
    strides = (stridet, stride, stride)
    plan = direct_plan(x.shape[1], y.shape[1], x.shape[2], x.shape[3], psz,
                       strides)
    ft, fh, fw = plan.fit
    with torch.no_grad():
        xs, ys = _nn_cast(x.detach(), y.detach(), nn_bf16)
        y2x = nn_retarget(xs, ys, plan, _norm_alpha(alpha), fast_nn_dist,
                          dist_fn)
    diff = x[:, :ft, :fh, :fw] - y2x
    return torch.mean(robust_lossfun(diff, rou, scaling))


@functools.lru_cache(maxsize=64)
def _down_plan(Tx, Ty, H, W, psz, strides, macro, f):
    """gpnn_down's static plan (the JAX package's `_down_plan`): fitted
    sizes at the downsampled scale, crop starts at both scales, and the
    full-resolution fold weight (clipped at 1e-10) and mask (weight > 0)."""
    (pt, p, _), (st, s, _) = psz, strides
    if p < s:
        raise ValueError("gpnn_down needs patch_size >= stride")
    hd, wd = H // f, W // f
    fhd = fit_patch_size(hd, p, s)
    fwd = fit_patch_size(wd, p, s)
    ftx = fit_patch_size(Tx, pt, st)
    fty = fit_patch_size(Ty, pt, st)
    fh, fw = fhd * f, fwd * f
    macro = fit_patch_size(min(macro, fhd, fwd), p, s)
    hs = _macro_starts(fhd, macro, p, s)
    ws = _macro_starts(fwd, macro, p, s)
    nL = n_patches(macro, p, s)                  # low-res patches per axis
    span = (nL * f - 1) * s + p                  # full-res crop extent
    off = (p * (f - 1)) // 2                     # centre patches on parents
    hs_full = tuple(min(h0 * f + off, fh - span) for h0 in hs)
    ws_full = tuple(min(w0 * f + off, fw - span) for w0 in ws)
    w_crop = fold_weight((ftx, span, span), psz, (st, s, s))
    weight = np.zeros((ftx, fh, fw), np.float32)
    for h0 in hs_full:
        for w0 in ws_full:
            weight[:, h0:h0 + span, w0:w0 + span] += w_crop
    mask = (weight > 0).astype(np.float32)
    return (fhd, fwd, ftx, fty, fh, fw, macro, tuple(hs), tuple(ws),
            nL, span, hs_full, ws_full, np.clip(weight, 1e-10, None), mask)


def down_plans(Tx, Ty, H, W, psz, strides, macro_block, factor):
    """gpnn_down's two crop plans: (low, full, mask).  low: the macro
    blocks of the video downsampled by `factor` (the search; its weight is
    unused); full: the full-resolution crops of the fold, span x span,
    whose f x f patch columns share their low-resolution parent's index
    (`nn_fold`'s parent mode); mask (fit_tx, fit_h, fit_w) f32, 0 where no
    patch folds."""
    (fhd, fwd, ftx, fty, fh, fw, macro, hs, ws, _, span, hs_full, ws_full,
     weight, mask) = _down_plan(Tx, Ty, H, W, psz, strides, macro_block,
                                factor)
    low = CropPlan(psz, strides, hs, ws, (macro, macro), (ftx, fhd, fwd),
                   fty, None)
    full = CropPlan(psz, strides, hs_full, ws_full, (span, span),
                    (ftx, fh, fw), fty, weight)
    return low, full, mask


def resize_hw(v, h, w):
    """jax.image.resize(v, (C, T, h, w), "linear") of v (C, T, H, W): the
    antialiased triangle weights (`core/resize.py:weight_matrix`) in v's
    dtype, H contracted, rounded to v's dtype, then W (a bf16 v stays
    bf16, as the JAX package resizes it)."""
    out = v
    for axis, n in ((2, h), (3, w)):
        if out.shape[axis] == n:
            continue
        wm = torch.from_numpy(weight_matrix(out.shape[axis], n)) \
            .to(v.dtype).to(device=v.device, dtype=torch.float32)
        eq = "cthw,hH->ctHw" if axis == 2 else "cthw,wW->cthW"
        out = torch.einsum(eq, out.float(), wm).to(v.dtype)
    return out.contiguous()


def gpnn_downsample_loss(x, y, *, patch_size=7, patcht_size=7, stride=2,
                         stridet=2, alpha=1e10, rou=0, scaling=0.2,
                         macro_block=64, factor=1, dist_fn="mse",
                         fast_nn_dist=False, nn_bf16=False, **_):
    """'gpnn_down' (ref utils_vid.py:352-434): the NN indices found on the
    video downsampled by `factor` (K11, mse or ssim, on `down_plans`' low
    crops), each full-resolution patch taking its low-resolution parent's
    index (patch i of an axis has parent i // factor; the full-resolution
    crops are offset by (p (f - 1)) // 2 so patches centre on their
    parents), the selected full-resolution y patches folded (K12's parent
    mode).  Voxels no patch covers are left out of the loss.  With factor
    <= 1 it is `gpnn_lowmem_loss`.  fast_nn_dist does not apply (the JAX
    package searches with `nn_indices`)."""
    if factor <= 1:
        return gpnn_lowmem_loss(
            x, y, patch_size=patch_size, patcht_size=patcht_size,
            stride=stride, stridet=stridet, alpha=alpha, rou=rou,
            scaling=scaling, macro_block=macro_block, dist_fn=dist_fn,
            fast_nn_dist=fast_nn_dist, nn_bf16=nn_bf16)
    f = int(factor)
    psz = (patcht_size, patch_size, patch_size)
    strides = (stridet, stride, stride)
    C = x.shape[0]
    low, full, mask = down_plans(x.shape[1], y.shape[1], x.shape[2],
                                 x.shape[3], psz, strides, macro_block, f)
    ftx, fh, fw = full.fit
    _, fhd, fwd = low.fit
    with torch.no_grad():
        xs, ys = _nn_cast(x.detach()[:, :ftx, :fh, :fw],
                          y.detach()[:, :full.fit_ty, :fh, :fw], nn_bf16)
        nn = nn_argmin(resize_hw(xs, fhd, fwd), resize_hw(ys, fhd, fwd), low,
                       _norm_alpha(alpha), dist_fn)
        y2x = nn_fold(ys.contiguous(), nn, full, parent=f)
    m = torch.from_numpy(mask).to(x.device)[None]
    diff = (x[:, :ftx, :fh, :fw] - y2x) * m      # robust(0) == 0 outside
    return torch.sum(robust_lossfun(diff, rou, scaling)) / (torch.sum(m) * C)


def video_mse_loss(x, y, **_):
    """'mse' (ref utils_vid.py:437-440)."""
    f = min(x.shape[1], y.shape[1])
    return torch.mean((x[:, :f] - y[:, :f]) ** 2)


def video_avg_loss(x, y, **_):
    """'avg': match the temporal means (ref utils_vid.py:443-445)."""
    return torch.mean((torch.mean(x, dim=1) - torch.mean(y, dim=1)) ** 2)


LOSS_FNS = {
    "gpnn": gpnn_direct_loss,
    "gpnn_lm": gpnn_lowmem_loss,
    "gpnn_down": gpnn_downsample_loss,
    "mse": video_mse_loss,
    "avg": video_avg_loss,
}
