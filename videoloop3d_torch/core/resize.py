"""Linear resize of tile textures (counterpart of
``jax.image.resize(x, shape, "linear")`` as ``videoloop3d_tpu/models/mpv.py``
uses it in ``lod``).

JAX's "linear" resize is a separable contraction with one weight matrix
per resized axis: a triangle kernel, widened by 1/scale when the axis
shrinks (antialiasing), each output column normalised to sum 1.  The
matrices are built here in numpy float32 with JAX's operation order and
applied with `torch.einsum`.  ``torch.nn.functional.interpolate`` is not
used: its antialiased weights are not guaranteed to match at the edges.
"""
from __future__ import annotations

import numpy as np
import torch


def weight_matrix(in_size, out_size):
    """(in_size, out_size) float32 weights: out[j] = sum_i x[i] * W[i, j]
    (``jax._src.image.scale.compute_weight_mat`` with the triangle kernel,
    antialias on, translation 0)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize_tiles(x, out_hw):
    """Resize the texel axes (1, 2) of tiles x (N, th, tw, ...) to out_hw
    (nth, ntw).  Computes in float32 and returns x's dtype; an axis whose
    size does not change is left alone, as in JAX."""
    N, th, tw = x.shape[:3]
    nth, ntw = out_hw
    rest = x.shape[3:]
    y = x.float().reshape(N, th, tw, -1)
    if nth != th:
        wh = torch.from_numpy(weight_matrix(th, nth)).to(y.device)
        y = torch.einsum("nhwk,hH->nHwk", y, wh)
    if ntw != tw:
        ww = torch.from_numpy(weight_matrix(tw, ntw)).to(y.device)
        y = torch.einsum("nhwk,wW->nhWk", y, ww)
    return y.reshape((N, nth, ntw) + rest).to(x.dtype).contiguous()
