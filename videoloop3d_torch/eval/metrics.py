"""Image metrics: masked PSNR / SSIM / MSE and the dynamics error
(counterpart of ``videoloop3d_tpu/eval/metrics.py``; numpy and scipy on
the host, as there).

Parity: reference evaluations/metrics.py:15-89 — images are scaled to
[-1, 1], multiplied by the mask, metrics computed on the full frame and
renormalized by the mask pixel count (PSNR gets the
-10*log10(HW/npix) correction; the SSIM map is mask-averaged).
SSIM matches skimage.structural_similarity defaults (uniform 7x7
window, K1=0.01, K2=0.03, unbiased covariances, gaussian off).
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def ssim_map(a, b, data_range=2.0, win=7):
    """Full SSIM map, skimage-default algorithm.  a, b: (H, W, C)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win * win
    cov_norm = NP / (NP - 1)

    def f(x):
        return np.stack([uniform_filter(x[..., c], size=win)
                         for c in range(x.shape[-1])], axis=-1)

    ux, uy = f(a), f(b)
    uxx, uyy, uxy = f(a * a), f(b * b), f(a * b)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    num = (2 * ux * uy + C1) * (2 * vxy + C2)
    den = (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2)
    return num / den


def compute_img_metric(im1, im2, metric="mse", mask=None, range01=True):
    """im1, im2: (B, H, W, 3) float; mask: (Bm, H, W) or (Bm, H, W, 1)
    broadcast over the batch.  Returns the batch-mean metric value."""
    im1 = np.asarray(im1, np.float64)
    im2 = np.asarray(im2, np.float64)
    if range01:
        im1 = im1 * 2 - 1
        im2 = im2 * 2 - 1
    im1 = np.clip(im1, -1, 1)
    im2 = np.clip(im2, -1, 1)
    if mask is not None:
        mask = np.asarray(mask, np.float64)
        if mask.ndim == 3:
            mask = mask[..., None]
        im1 = im1 * mask
        im2 = im2 * mask

    B, H, W, _ = im1.shape
    vals = []
    for i in range(B):
        m = mask[i % len(mask)] if mask is not None else None
        if metric == "mse":
            v = np.mean((im1[i] - im2[i]) ** 2)
            if m is not None:
                v = v * H * W / m[..., 0].sum()
        elif metric == "psnr":
            mse = np.mean((im1[i] - im2[i]) ** 2)
            v = 10 * np.log10(4.0 / max(mse, 1e-12))
            if m is not None:
                v = v - 10 * np.log10(H * W / m[..., 0].sum())
        elif metric == "ssim":
            smap = ssim_map(im1[i], im2[i])
            if m is not None:
                v = (smap * m).sum() / m.sum() / 3
            else:
                v = smap.mean()
        else:
            raise ValueError(metric)
        vals.append(v)
    return float(np.mean(vals))


def dynamics_error(gt_video, pred_video):
    """Temporal std-map MSE (ref script_evaluate_ours.py:169-179).

    Inputs (F, H, W, 3) in [0, 255] — matching the reference, the std
    maps are on the 0-255 scale, so the squared error is O(1-1e3) for
    natural clips (a per-pixel std mismatch of ~12/255 gives ~144).
    """
    stdg = np.std(np.asarray(gt_video, np.float64), axis=0)
    stdp = np.std(np.asarray(pred_video, np.float64), axis=0)
    return float(np.mean((stdg - stdp) ** 2))
