"""Geometry / appearance regularizers of the stage-1 model (counterpart of
``videoloop3d_tpu/losses/regularizers.py``, ref MPI.py:602-650).

The reference computes these on a per-pixel fragment stack whose layer
count may be truncated and rescales by ``num_layers / mpi_d``; the dense
plane axis here always has D layers, and empty layers add zero to every
term, so the normalizations are the same.

Every |.| here is `_abs`, whose derivative at 0 is +1 as ``jnp.abs``'s
is (torch.abs gives 0 there).  Exact zeros do reach these terms: a
scratch stage-2 start gives every texel the same alpha, so neighbouring
alphas and disparities are equal.
"""
from __future__ import annotations

import math

import torch

from videoloop3d_torch.core.activations import clip


class _Abs(torch.autograd.Function):
    """|x| with ``jnp.abs``'s derivative: g where x >= 0, -g elsewhere.  A
    Function, not ``torch.where(x >= 0, x, -x)``, whose select and its
    backward make several more passes over the (D, h, w, F, 3) stacks of
    an unfused stage-2 step than ``torch.abs`` does (``PERF.md`` §6)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x):
    """|x|, with the JAX package's derivative +1 at x = 0."""
    return _Abs.apply(x)


def sparsity_loss(alpha, n_planes, eps=1e-6, plane_axis=-3):
    """L1/L2 ratio of per-pixel alpha stacks along the plane axis
    (ref MPI.py:603-607)."""
    l1 = torch.sum(_abs(alpha), dim=plane_axis)
    l2 = clip(torch.sqrt(torch.sum(alpha * alpha, dim=plane_axis)), eps)
    return torch.mean(l1 / l2) / math.sqrt(n_planes)


def content_smooth_loss(x, h_axis=-3, w_axis=-2):
    """Mean |spatial gradient| of per-plane content over the given H/W
    axes (default layout (..., D, H, W, C); ref MPI.py:609-623)."""
    dx = torch.mean(_abs(torch.diff(x, dim=w_axis)))
    dy = torch.mean(_abs(torch.diff(x, dim=h_axis)))
    return dx + dy


def depth_smooth_loss(disp, rgb=None, edge_scale=4.0):
    """Disparity smoothness, edge-aware when rgb is given (ref
    MPI.py:625-637).  disp (B, H, W); rgb (B, H, W, 3) or None."""
    gx = _abs(disp[:, 1:, :-1] - disp[:, 1:, 1:])
    gy = _abs(disp[:, :-1, 1:] - disp[:, 1:, 1:])
    grad = gx + gy
    if rgb is None:
        return torch.mean(grad)
    ex = torch.sum(_abs(rgb[:, 1:, :-1] - rgb[:, 1:, 1:]), dim=-1)
    ey = torch.sum(_abs(rgb[:, :-1, 1:] - rgb[:, 1:, 1:]), dim=-1)
    weight = clip(1.0 - (ex + ey) * edge_scale, 0.0)
    return torch.mean(grad * weight)


def density_loss(alpha_sum):
    """Push total per-pixel opacity toward 1 (ref MPI.py:647-650)."""
    return torch.mean(_abs(alpha_sum - 1.0))
