"""Activation table for atlas texels (counterpart of
``videoloop3d_tpu/core/activations.py``).

The port supports the shipped ``rgb_activate = alpha_activate =
sigmoid``; other names raise until ROADMAP Queue A item 4 ports them.
"""
from __future__ import annotations

import torch

ALPHA_INIT_VAL = -3.0          # ref MPI.py:21-33

ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
}


def get_activation(name):
    if name not in ACTIVATIONS:
        raise NotImplementedError(
            f"activation '{name}' is not ported yet (ROADMAP Queue A, "
            "item 4: the non-sigmoid activations)")
    return ACTIVATIONS[name]
