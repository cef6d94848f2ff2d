"""Activation table for atlas texels (counterpart of
``videoloop3d_tpu/core/activations.py``; ref MPI.py:21-33).

Every name of the JAX table, with JAX's gradients: ``jnp.clip``'s
derivative is 0.5 at either bound (it is ``minimum(maximum(x, lo), hi)``
and JAX splits a tie of ``maximum``/``minimum`` evenly), where
``torch.clamp``'s is 1, so ``clamp`` and ``unsigmoid`` clip through
`clip`, whose backward takes 0.5 at ties.  ``clamp_g`` is the clipped value
with the identity gradient.  ``softplus`` is ``logaddexp(x - 1, 0)``, as
``jax.nn.softplus`` (torch's ``F.softplus`` turns linear above 20).
"""
from __future__ import annotations

import torch

ALPHA_INIT_VAL = -3.0          # ref MPI.py:21-33


class _Clip(torch.autograd.Function):
    """clip(x, lo, hi) with JAX's derivative: 1 inside, 0.5 at a bound,
    0 outside; a bound that is None is absent."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = torch.ones_like(x, dtype=torch.bool)
        tie = torch.zeros_like(inside)
        for bound, within in zip(ctx.bounds, (torch.gt, torch.lt)):
            if bound is not None:
                inside &= within(x, bound)
                tie |= x == bound
        return g * (inside.to(g.dtype) + 0.5 * tie.to(g.dtype)), None, None


def clip(x, lo=None, hi=None):
    """``jnp.clip(x, lo, hi)`` for lo < hi, value and gradient; lo or hi
    None leaves that side open (``jnp.clip(x, lo, None)``)."""
    return _Clip.apply(x, lo, hi)


def _unsigmoid(x):
    x = clip(x, 1e-6, 1 - 1e-6)
    return torch.log(x / (1 - x))


def _clamp_grad_passthrough(x):
    return x + (torch.clamp(x, 0.0, 1.0) - x).detach()


def _softplus(x):
    return torch.logaddexp(x - 1, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "unsigmoid": _unsigmoid,
    "exp": torch.exp,
    "none": lambda x: x,
    "sigmoid1": lambda x: 1.002 / (torch.exp(-x) + 1) - 0.001,
    "softplus": _softplus,
    "tanh": torch.tanh,
    "clamp": lambda x: clip(x, 0.0, 1.0),
    "clamp_g": _clamp_grad_passthrough,
    "plus05": lambda x: x + 0.5,
}


def get_activation(name):
    if name not in ACTIVATIONS:
        raise KeyError(f"unknown activation '{name}'")
    return ACTIVATIONS[name]
