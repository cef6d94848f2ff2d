"""Optimizers with per-parameter-group learning rates (counterpart of
``videoloop3d_tpu/train/optimizer.py``, ref MPI.py:122-152).

One `torch.optim` group per named parameter: Adam (eps outside the sqrt,
bias correction; the JAX package's Adam reproduces it) or SGD with
momentum 0.9.  The ``verts`` group runs at ``lrate * optimize_verts_gain``;
every other one, the NeX / MLP decoder's leaves (``decoder/l0/w``, ...)
included, at ``lrate``.  (The JAX trainer means the same: its lr tree
gives ``decoder`` one scalar, ``build_lr_tree``; but ``adam_update`` maps
it against the decoder's dict and raises "Expected dict", so the JAX
package cannot take a step of ``nex_rgb`` or ``mlp_alpha``.)
The base lr comes from `lr_schedule` and is set before every step
(`set_lr`).  The optimizers update the parameter tensors in place.
"""
from __future__ import annotations

import torch

from videoloop3d_torch.models.checkpoint import flat_params


def lr_schedule(step, base_lr, decay_rate=0.1, decay_steps_k=30):
    """Exponential decay: lr * decay_rate**(step / (decay_steps_k*1000)).
    Parity: MPI.py:143-152 (get_lrate)."""
    return base_lr * decay_rate ** (step / (decay_steps_k * 1000.0))


def make_group_fn(verts_gain):
    """Returns param-name -> lr multiplier (group assignment)."""
    def group(name):
        return verts_gain if name == "verts" else 1.0
    return group


def trainable(params):
    """Make every leaf of the params dict (nested decoder included) a
    tensor that requires grad; returns the flat {name: tensor}."""
    flat = flat_params(params)
    for t in flat.values():
        t.requires_grad_(True)
    return flat


def make_optimizer(name, params, group_fn, eps=1e-8):
    """A torch optimizer over the dict `params` (name -> leaf tensor, or a
    nested dict of them: `flat_params` names), one group per name
    carrying its lr multiplier as ``gain``."""
    groups = [{"params": [t], "name": k, "gain": float(group_fn(k)),
               "lr": 0.0} for k, t in flat_params(params).items()]
    if name == "adam":
        return torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999), eps=eps)
    if name == "sgd":
        return torch.optim.SGD(groups, lr=0.0, momentum=0.9)
    raise ValueError(f"unrecognized optimizer {name}")


def start_param(optimizer, param):
    """Give `param`, which had no gradient so far, the optimizer state the
    JAX package's optimizer holds for it: one step counter for all
    parameters, moments zero (a parameter outside the loss gets zero
    gradients there, which leave them zero).  So Adam's bias correction
    of param's first update uses the steps taken since the optimizer was
    built, not 1.  SGD needs nothing: its first momentum equals JAX's.
    A no-op before the first step."""
    if not isinstance(optimizer, torch.optim.Adam):
        return
    steps = [s["step"] for s in optimizer.state.values() if "step" in s]
    if not steps:
        return
    step = max(steps, key=float)
    optimizer.state[param] = {
        "step": step.clone(),
        "exp_avg": torch.zeros_like(param,
                                    memory_format=torch.preserve_format),
        "exp_avg_sq": torch.zeros_like(param,
                                       memory_format=torch.preserve_format)}


def set_lr(optimizer, base_lr):
    """Set every group's lr to base_lr times its gain."""
    for g in optimizer.param_groups:
        g["lr"] = base_lr * g["gain"]
