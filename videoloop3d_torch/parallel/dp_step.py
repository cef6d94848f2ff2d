"""Data-parallel training steps (counterpart of
``videoloop3d_tpu/parallel/dp_step.py``): each dp rank computes the
backward of its own row of the global patch batch, then ONE collective a
step, an all_reduce of one flat f32 buffer holding every gradient leaf
and metric (the JAX step's single psum), gives every rank the batch mean:
sum(g w) / sum(w) over the rows when the batch carries a row weight
``wt`` (0 for a filler row, which so contributes nothing), else the mean
over the rows.  Then the port's optimizer (``train/optimizer.py``, Adam
or SGD, unchanged) takes the same step on every rank, so the replicated
parameters stay equal.  A rank's torch.Generator is seeded from (seed,
dp rank) (``distributed.fold_seed``): the counterpart of the JAX step's
``fold_in(rng, axis_index("dp"))``.
"""
from __future__ import annotations

import torch



def optimizer_params(optimizer):
    """The optimizer's parameter tensors in group order (the same on
    every rank)."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def reduce_step(optimizer, metrics, comm, wt=None):
    """All-reduce the gradients of the optimizer's parameters and the
    metrics over comm in one flat f32 buffer, in place: the weighted mean
    sum(x w) / sum(w) when wt (this rank's row weight) is given, else the
    mean over the ranks.  Returns the reduced metrics
    (detached tensors).  Parameters without a gradient stay without one
    (they have none on any rank)."""
    params = [p for p in optimizer_params(optimizer) if p.grad is not None]
    keys = sorted(metrics)
    dev = params[0].device if params else None
    vals = [torch.as_tensor(metrics[k], dtype=torch.float32).reshape(1)
            .to(dev) for k in keys]
    if comm.size == 1:
        return {k: v[0].detach() for k, v in zip(keys, vals)}
    parts = [p.grad.reshape(-1) for p in params] + vals
    if wt is not None:
        w = torch.tensor([float(wt)], dtype=torch.float32, device=dev)
        parts = [q * w for q in parts] + [w]
    buf = comm.all_reduce(torch.cat(parts), inplace=True)
    if wt is not None:
        buf = buf[:-1] / buf[-1]
    else:
        buf = buf / comm.size
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(buf[off:off + n].view_as(p))
        off += n
    return {k: buf[off + i].detach() for i, k in enumerate(keys)}


def make_dp_stage1_step(model, args, ph, pw, grid):
    """The dp stage-1 step (JAX ``make_dp_stage1_step``): the stage-1 step
    on this rank's row (the row weight in batch["wt"] under
    ``--shard_views``), reduced over dp before the optimizer's step."""
    from videoloop3d_torch.train.stage1 import make_train_step
    return make_train_step(model, args, ph, pw, grid)


def make_dp_stage2_step(model, args, ph, pw, losscfg, grid):
    """The dp stage-2 step (JAX ``make_dp_stage2_step``): the stage-2 step
    on this rank's patch (the row weight in batch["wt"] when given),
    reduced over dp before the optimizer's step.  Returns (step,
    opt_init)."""
    from videoloop3d_torch.train.stage2 import make_stage2_step
    return make_stage2_step(model, args, ph, pw, losscfg, grid)
