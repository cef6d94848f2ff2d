"""NNMSE metric: 3-D patch nearest-neighbour error between two videos
(counterpart of ``videoloop3d_tpu/eval/nnmse.py``).

The training loss's machinery as a metric: mean |NN(src -> tar) - src|
over macro blocks, and the Loop Quality metric (the NN error of the
seam-straddling window against the ground truth).  Parity: reference
evaluations/NNMSE.py:7-58 and script_evaluate_ours.py:205-222.

The search is temporally decomposed as in the JAX package
(`_block_err_fn`): temporal patches at stride st share all but st frames,
so their distances are banded sums of per-frame patch distances.  The
macro blocks are `losses/patch_nn.py:lowmem_plan`'s crops (JAX's
`_nnerr_impl` computes the same fitted sizes and clamped starts), read in
place: K18 (`nn_band_argmin`) finds both directions' nearest patches in
one launch and K19 (`nn_band_err`) sums each direction's selected-patch
error per crop; the CPU runs their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from videoloop3d_torch.losses import patch_nn as P


def compute_nnerr(src, tar, patch_size=7, stride=2, patcht_size=7,
                  stridet=2, macro_block=65, *, device):
    """src, tar: (3, F, H, W) float arrays.  Mean L1 between every source
    patch and its temporal NN target patch, averaged over macro blocks,
    computed on `device`."""
    fwd, _ = _nnerr_impl(src, tar, patch_size, stride, patcht_size, stridet,
                         macro_block, False, device)
    return fwd


def compute_nnerr_pair(src, tar, patch_size=7, stride=2, patcht_size=7,
                       stridet=2, macro_block=65, *, device):
    """(compute_nnerr(src, tar), compute_nnerr(tar, src)) from one search:
    the reverse direction's distances are the transpose of the forward
    ones (the evaluator's nnf/nnb columns)."""
    return _nnerr_impl(src, tar, patch_size, stride, patcht_size, stridet,
                       macro_block, True, device)


def _nnerr_impl(src, tar, patch_size, stride, patcht_size, stridet,
                macro_block, pair, device):
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    x, y = dev(src), dev(tar)
    C, Tx, H, W = x.shape
    plan = P.lowmem_plan(Tx, y.shape[1], H, W,
                         (patcht_size, patch_size, patch_size),
                         (stridet, stride, stride), macro_block)
    ntx, nty, nh, nw = plan.grid
    # per crop: sum / (pt * columns * patches * dim) is sel_err's mean
    per = patcht_size * nh * nw * C * patch_size * patch_size
    rows, cols = P.nn_band_argmin(x, y, plan, both_directions=pair)

    def err(nn, reverse, n):
        sums = P.nn_band_err(x, y, plan, nn, reverse).cpu().numpy()
        return float(np.mean(sums.astype(np.float64) / (per * n)))

    fwd = err(rows, False, ntx)
    return fwd, (err(cols, True, nty) if pair else None)


def loop_quality(pred, gt, patch_size, stride, patcht_size, stridet,
                 macro_block=65, *, device):
    """NN error of the window straddling the loop seam against the ground
    truth (ref script_evaluate_ours.py:216-220)."""
    pred = np.asarray(pred)
    seam = np.concatenate(
        [pred[:, -patcht_size + 1:], pred[:, :patcht_size - 1]], axis=1)
    return compute_nnerr(seam, gt, patch_size, stride, patcht_size, stridet,
                         macro_block, device=device)
