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

* K11 `nn_argmin` (``csrc/nn_argmin.cu``): the search, `_pairwise_sqdist`
  + `nn_indices_from_dist` of the JAX package, with no patch tensor and
  no distance matrix in device memory;
* K12 `nn_fold` (``csrc/nn_fold.cu``): selection, fold, crop overlap-add
  and the division by the fold weight, one thread per output voxel;
* K18 `nn_band_argmin` (``csrc/nn_argmin.cu``): the temporally decomposed
  search (`banded_temporal_dist` of the JAX package): per-frame patch
  distances, their banded sums over the pt frames of a temporal patch,
  the argmin of every row and, for the eval, of every column;
* K19 `nn_band_err` (``csrc/nn_band_err.cu``): the eval's summed
  |selected - source| of one direction of K18's search
  (``eval/nnmse.py``).

The crops are `gpnn_lowmem_loss`'s macro blocks (clamped starts, all of
one size) or, for `gpnn_direct_loss`, one crop covering the fitted frame;
the eval's macro blocks are `lowmem_plan`'s too.  ``--fast_nn_dist``
(`fast_nn_dist=True`) searches with K18 where the JAX package takes
`_nn_retarget_temporal`: the "mse" distance and pt > 1.  Only the "mse"
patch distance is ported; "ssim", SWD and `gpnn_down` raise at the
trainer's start-up (`train/stage2.py`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from videoloop3d_torch import kernels

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


def normalized_dist(dist, alpha=None):
    """The (B, n, m) distances, each column divided by (alpha + its
    minimum over n) when alpha is given (the JAX package's
    `nn_indices_from_dist` before its argmin); NaN propagates through the
    minimum."""
    if alpha is None:
        return dist
    return dist / (alpha + torch.amin(dist, dim=1, keepdim=True))


def _fitted(x, y, plan):
    """x and y cut to the plan's fitted extent."""
    ft, fh, fw = plan.fit
    return x[:, :ft, :fh, :fw], y[:, :plan.fit_ty, :fh, :fw]


def _crops(x, plan):
    mh, mw = plan.crop_hw
    return [x[..., h0:h0 + mh, w0:w0 + mw] for h0 in plan.hs
            for w0 in plan.ws]


def nn_dist_plain(x, y, plan, alpha=None):
    """The distances K11 minimizes: (n_crops, nh * nw, ntx, nty) f32, per
    crop and spatial patch column, between every temporal x patch and
    every temporal y patch (`normalized_dist` when alpha is given).
    x (C, Tx, H, W), y (C, Ty, H, W), f32 or bf16."""
    out = []
    for xc, yc in zip(*(_crops(t, plan) for t in _fitted(x, y, plan))):
        Xp = extract_patches_3d(xc, plan.psz, plan.strides)
        Yp = extract_patches_3d(yc, plan.psz, plan.strides)
        ntx, nh, nw, dim = Xp.shape
        Xf = Xp.reshape(ntx, nh * nw, dim).transpose(0, 1)
        Yf = Yp.reshape(Yp.shape[0], nh * nw, dim).transpose(0, 1)
        out.append(normalized_dist(_pairwise_sqdist(Xf, Yf), alpha))
    return torch.stack(out)


def nn_argmin_plain(x, y, plan, alpha=None):
    """Plain version of K11.  Returns (n_crops, nh * nw, ntx) int32: for
    every crop, spatial patch column and temporal x patch, the index of
    its nearest temporal y patch in the same column: `nn_dist_plain`'s
    argmin, the first NaN, else the first minimum (`jnp.argmin`'s and
    `torch.argmin`'s rule)."""
    return torch.argmin(nn_dist_plain(x, y, plan, alpha), dim=3).to(
        torch.int32)


def nn_fold_plain(y, nn, plan):
    """Plain version of K12.  y (C, Ty, H, W) f32 or bf16; nn from
    `nn_argmin`.  Returns y2x (C, fit_tx, fit_h, fit_w) f32: the selected
    y patches folded per crop, the crops added, divided by plan.weight."""
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


def nn_band_err_plain(x, y, plan, nn, reverse=False):
    """Plain version of K19.  (n_crops,) f32: per crop, the sum over the
    spatial columns, the source's temporal patches i, their frames k < pt
    and the per-frame patch channels of |target[nn(i) * st + k] -
    source[i * st + k]|; the source is x and nn K18's rows, or with
    reverse y and K18's cols."""
    (pt, _, _), (st, _, _) = plan.psz, plan.strides
    src, tar = _fitted(x, y, plan)
    if reverse:
        src, tar = tar, src
    ns = nn.shape[2]
    nt = plan.grid[0] if reverse else plan.grid[1]
    sums = []
    for ci, (sc, tc) in enumerate(zip(_crops(src, plan), _crops(tar, plan))):
        A = _frame_patches(sc, plan).float()
        B = _frame_patches(tc, plan).float()
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


def _argmin_smem(plan, d):
    ntx, nty = plan.grid[:2]
    # offsets of x and y (2 d ints), two staged 32 x 65 chunks, the
    # norms and column minima, the (ntx, nty) distances
    return 4 * (2 * d + 2 * 32 * 65 + ntx + 2 * nty + ntx * nty)


def nn_argmin(x, y, plan, alpha=None):
    """K11: the nearest temporal y patch of every temporal x patch, per
    crop and spatial patch column (`nn_argmin_plain`'s function).  x
    (C, Tx, H, W) and y (C, Ty, H, W) contiguous, both f32 or both bf16
    (widened per product, f32 sums); alpha None or a float (the
    completeness normalization).  Returns (n_crops, nh * nw, ntx) int32."""
    _check_nn_inputs("nn_argmin", x, y, plan)
    if x.device.type == "cpu":
        return nn_argmin_plain(x, y, plan, alpha)
    C, Tx, H, W = x.shape
    ntx, nty, nh, nw = plan.grid
    d = C * int(np.prod(plan.psz))
    smem = _argmin_smem(plan, d)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"nn_argmin: {ntx} x {nty} patches of dim {d} need "
                         f"{smem} B of shared memory (limit {_SMEM_LIMIT})")
    n_crops = len(plan.hs) * len(plan.ws)
    nn = torch.empty((n_crops, nh * nw, ntx), dtype=torch.int32,
                     device=x.device)
    err = kernels.library().vl3d_nn_argmin(
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), C, Tx,
        y.shape[1], H, W, _plan_ints(plan), int(alpha is not None),
        float(alpha or 0.0), smem, nn.data_ptr(),
        kernels.stream_ptr(x.device))
    kernels.LAUNCHES["nn_argmin"] += 1
    kernels.check_launch("nn_argmin", err)
    return nn


def _band_smem(plan, d):
    ntx, nty = plan.grid[:2]
    fx, fy = plan.fit[0], plan.fit_ty
    # offsets of x and y (2 d ints), two staged 32 x 65 chunks, the norms,
    # the column minima, the (fx, fy) per-frame and (ntx, nty) banded
    # distances
    return 4 * (2 * d + 2 * 32 * 65 + fx + fy + nty + fx * fy + ntx * nty)


def nn_band_argmin(x, y, plan, alpha=None, scale_by_pt=False,
                   both_directions=False):
    """K18: `nn_band_argmin_plain`'s function, with no patch tensor and no
    distance matrix in device memory.  x (C, Tx, H, W) and y (C, Ty, H, W)
    contiguous, both f32 or both bf16 (widened per product, f32 sums);
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
    n_crops = len(plan.hs) * len(plan.ws)
    rows = torch.empty((n_crops, nh * nw, ntx), dtype=torch.int32,
                       device=x.device)
    cols = torch.empty((n_crops, nh * nw, nty), dtype=torch.int32,
                       device=x.device) if both_directions else None
    err = kernels.library().vl3d_nn_band_argmin(
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), C, Tx,
        y.shape[1], H, W, _plan_ints(plan), int(scale_by_pt),
        int(alpha is not None), float(alpha or 0.0), smem, rows.data_ptr(),
        cols.data_ptr() if both_directions else None,
        kernels.stream_ptr(x.device))
    kernels.LAUNCHES["nn_band_argmin"] += 1
    kernels.check_launch("nn_band_argmin", err)
    return rows, cols


# K19 keeps its offsets, indices and partial sums in static-size shared
# memory
_ERR_SMEM_LIMIT = 48 * 1024


def nn_band_err(x, y, plan, nn, reverse=False):
    """K19: `nn_band_err_plain`'s per-crop sums (n_crops,) f32, summed in a
    fixed order in f32 (bf16 inputs widened), with no atomics.  nn: K18's
    rows, or its cols with reverse."""
    _check_nn_inputs("nn_band_err", x, y, plan)
    ntx, nty, nh, nw = plan.grid
    ns = nty if reverse else ntx
    n_crops = len(plan.hs) * len(plan.ws)
    kernels.check_tensor("nn_band_err.nn", nn, x.device, dtype=torch.int32,
                         shape=(n_crops, nh * nw, ns))
    if x.device.type == "cpu":
        return nn_band_err_plain(x, y, plan, nn, reverse)
    C, _, H, W = x.shape
    d = C * plan.psz[1] * plan.psz[2]
    if 4 * (2 * d + ns + 256) > _ERR_SMEM_LIMIT \
            or ns * plan.psz[0] * d >= 2 ** 31:
        raise ValueError(f"nn_band_err: {ns} patches of {plan.psz[0]} "
                         f"frames of dim {d} exceed the kernel's limits")
    src, tar = (y, x) if reverse else (x, y)
    partial = torch.empty(n_crops * nh * nw, dtype=torch.float32,
                          device=x.device)
    out = torch.empty(n_crops, dtype=torch.float32, device=x.device)
    err = kernels.library().vl3d_nn_band_err(
        src.data_ptr(), tar.data_ptr(), int(x.dtype == torch.bfloat16), C,
        src.shape[1], tar.shape[1], H, W, _plan_ints(plan), ns,
        nn.data_ptr(), partial.data_ptr(), out.data_ptr(),
        kernels.stream_ptr(x.device))
    kernels.LAUNCHES["nn_band_err"] += 1
    kernels.check_launch("nn_band_err", err)
    return out


def nn_fold(y, nn, plan):
    """K12: y2x (C, fit_tx, fit_h, fit_w) f32, `nn_fold_plain`'s function:
    for every voxel, the sum over the crops and patches covering it of the
    selected y patch's voxel (the same pixel, frame nn * st + the
    in-patch offset), divided by the number of such patches.  Sums run in
    a fixed order in f32 (bf16 y is widened), with no atomics."""
    dev = y.device
    kernels.check_tensor("nn_fold.y", y, dev, dtype=_NN_DTYPES)
    ntx, _, nh, nw = plan.grid
    kernels.check_tensor("nn_fold.nn", nn, dev, dtype=torch.int32,
                         shape=(len(plan.hs) * len(plan.ws), nh * nw, ntx))
    if dev.type == "cpu":
        return nn_fold_plain(y, nn, plan)
    C, Ty, H, W = y.shape
    ft, fh, fw = plan.fit
    out = torch.empty((C, ft, fh, fw), dtype=torch.float32, device=dev)
    err = kernels.library().vl3d_nn_fold(
        y.data_ptr(), nn.data_ptr(), int(y.dtype == torch.bfloat16), C, Ty,
        H, W, _plan_ints(plan), ft, fh, fw, out.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.LAUNCHES["nn_fold"] += 1
    kernels.check_launch("nn_fold", err)
    return out


# ---------------------------------------------------------------------------
# retarget and the public losses (registry: ref MPV.py:131-138)
# ---------------------------------------------------------------------------

def nn_retarget(x, y, plan, alpha=None, fast_nn_dist=False):
    """y2x (C, fit_tx, fit_h, fit_w) f32 for the crops of `plan` (K11 +
    K12; with fast_nn_dist and pt > 1 `_nn_retarget_temporal`, as the JAX
    package's rule).  x, y are detached (C, T, H, W) tensors."""
    x, y = x.contiguous(), y.contiguous()
    if fast_nn_dist and plan.psz[0] > 1:
        return _nn_retarget_temporal(x, y, plan, alpha)
    return nn_fold(y, nn_argmin(x, y, plan, alpha), plan)


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


def _check_dist(dist_fn):
    if dist_fn != "mse":
        raise NotImplementedError(
            f"patch distance '{dist_fn}' is not ported yet (ROADMAP Queue "
            "A, item 8: off-path losses)")


def gpnn_lowmem_retarget(x, y, patch_size=7, patcht_size=7, stride=2,
                         stridet=2, alpha=None, macro_block=64,
                         fast_nn_dist=False):
    """Macro-block NN retarget.  x (C, Tx, H, W) render (loop-padded), y
    (C, Ty, H, W) video.  Returns (y2x (C, fit_tx, fit_h, fit_w) f32,
    weight-normalized, (fit_tx, fit_h, fit_w))."""
    psz = (patcht_size, patch_size, patch_size)
    strides = (stridet, stride, stride)
    plan = lowmem_plan(x.shape[1], y.shape[1], x.shape[2], x.shape[3], psz,
                       strides, macro_block)
    return nn_retarget(x, y, plan, alpha, fast_nn_dist), plan.fit


def gpnn_lowmem_loss(x, y, *, patch_size=7, patcht_size=7, stride=2,
                     stridet=2, alpha=1e10, rou=0, scaling=0.2,
                     macro_block=64, dist_fn="mse", fast_nn_dist=False,
                     nn_bf16=False, **_):
    """'gpnn_lm', the default stage-2 looping loss.  x (C, Tx, H, W)
    render (gradients flow); y (C, Ty, H, W) video.  The target is built
    without gradient; the loss is mean(robust(x - y2x))."""
    _check_dist(dist_fn)
    with torch.no_grad():
        xs, ys = _nn_cast(x.detach(), y.detach(), nn_bf16)
        y2x, (ft, fh, fw) = gpnn_lowmem_retarget(
            xs, ys, patch_size=patch_size, patcht_size=patcht_size,
            stride=stride, stridet=stridet, alpha=_norm_alpha(alpha),
            macro_block=macro_block, fast_nn_dist=fast_nn_dist)
    diff = x[:, :ft, :fh, :fw] - y2x
    return torch.mean(robust_lossfun(diff, rou, scaling))


def gpnn_direct_loss(x, y, *, patch_size=7, patcht_size=7, stride=1,
                     stridet=1, alpha=1e10, rou=0, scaling=0.2,
                     dist_fn="mse", fast_nn_dist=False, nn_bf16=False,
                     **_):
    """'gpnn': the whole-patch NN of one crop covering the fitted frame
    (ref utils_vid.py:265-287)."""
    _check_dist(dist_fn)
    psz = (patcht_size, patch_size, patch_size)
    strides = (stridet, stride, stride)
    plan = direct_plan(x.shape[1], y.shape[1], x.shape[2], x.shape[3], psz,
                       strides)
    ft, fh, fw = plan.fit
    with torch.no_grad():
        xs, ys = _nn_cast(x.detach(), y.detach(), nn_bf16)
        y2x = nn_retarget(xs, ys, plan, _norm_alpha(alpha), fast_nn_dist)
    diff = x[:, :ft, :fh, :fw] - y2x
    return torch.mean(robust_lossfun(diff, rou, scaling))


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
    "mse": video_mse_loss,
    "avg": video_avg_loss,
}
