"""Alpha compositing of a front-to-back layer stack (counterpart of
``videoloop3d_tpu/render/composite.py``; ref utils_mpi.py:92-132,
overcompose / overcomposeNto0).

The layer axis is ordered FRONT (nearest) to BACK here; the models store
their planes far to near and composite them with
``render/renderer.py:composite_planes``.
"""
from __future__ import annotations

import torch


def composite_front_to_back(alpha, content):
    """Over-composite a stack of semi-transparent layers.

    alpha (..., L): opacity per layer, layer 0 nearest; content (..., L,
    C).  Returns (out (..., C), blend_weight (..., L)), the weights
    w_i = a_i * prod_{j<i} (1 - a_j)."""
    trans = torch.cumprod(1.0 - alpha, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    w = alpha * trans
    return torch.sum(content * w[..., None], dim=-2), w
