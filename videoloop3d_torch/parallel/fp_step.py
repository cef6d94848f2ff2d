"""Frame-parallel (sequence-parallel) stage-2 step (counterpart of
``videoloop3d_tpu/parallel/fp_step.py``).

The video's time axis is this model's sequence: a frame renders on its
own, and the looping losses couple frames only within a temporal patch
(pt frames).  So each fp rank holds its own Fl = F / S frames of the
dynamic atlas (``distributed.shard_params_by_frames``) and renders them,
and ring collectives over the fp group cover the coupling:

* gpnn (`sharded_gpnn_lowmem`): the NN target carries no gradient.  A
  rank takes the next rank's first pt - 1 frames (the halo; the ring's
  wrap is the loop-closure pad), searches its query patches (K11, with
  alpha against the column minima over every rank's patches: K11's
  minima mode, a MIN all_reduce, its given-minima mode), folds them
  undivided (K12's numerator mode), sends the pt - 1 frames its fold
  spills past its end to the next rank, then divides;
* swd (`sharded_swd`): the halo carries gradient (`_Halo`), each rank
  projects its frames (K24, K26 in the backward) and the projected
  columns are all-gathered (`_GatherCols`; the temporal sort does not
  care about their order), then sorted (K25).

Each loss returns the global value with the exact gradient of its rank's
frames.  `make_fp_stage2_step` then sums the replicated parameters'
gradients over fp and takes the dp mean (or weighted mean) of every
gradient; ``atlas_dyn``'s gradient and Adam state stay local.

Constraints (as the JAX package's): stridet == 1, F % S == 0 and
F / S >= pt - 1.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from videoloop3d_torch.losses import patch_nn as pnl
from videoloop3d_torch.losses import swd
from videoloop3d_torch.parallel.dp_step import optimizer_params, reduce_step
from videoloop3d_torch.train import common, optimizer as opt_lib


def spatial_weight(plan):
    """The fold weight of the plan's crops over (fit_h, fit_w), clipped at
    1e-10 (JAX ``_spatial_plan``'s): the spatial factor of plan.weight."""
    (_, p, _), (_, s, _) = plan.psz, plan.strides
    mh, mw = plan.crop_hw
    _, fh, fw = plan.fit
    prof_h = pnl._fold_profile_1d(mh, p, s)
    prof_w = pnl._fold_profile_1d(mw, p, s)
    weight = np.zeros((fh, fw), np.float32)
    for h0 in plan.hs:
        for w0 in plan.ws:
            weight[h0:h0 + mh, w0:w0 + mw] += np.outer(prof_h, prof_w)
    return np.clip(weight, 1e-10, None)


def _global_value(local, comm):
    """local (a scalar with gradient) with the value of its sum over the
    group and local's gradient."""
    total = comm.all_reduce(local.detach())
    return local + (total - local.detach())


def sharded_gpnn_lowmem(x_scaled, y, *, patch_size, patcht_size, stride,
                        alpha, rou, scaling, macro_block, comm, frm_num,
                        nn_bf16=False):
    """Frame-sharded gpnn_lm ("gpnn" with macro_block None) loss.

    x_scaled: (3, Fl, h, w) this rank's rendered frames (gain applied,
    gradients flow); y: (3, Ty, h, w) the whole video.  Returns the
    single-device loss of the loop-padded video, with the gradient of
    this rank's frames."""
    C, Fl, H, W = x_scaled.shape
    pt = patcht_size
    pad = pt - 1
    S = comm.size
    if Fl * S != frm_num or Fl < pad:
        raise ValueError(f"fp gpnn: {Fl} frames a rank x {S} ranks for "
                         f"{frm_num} frames, pt {pt}")
    psz = (pt, patch_size, patch_size)
    strides = (1, stride, stride)
    fh = pnl.fit_patch_size(H, patch_size, stride)
    fw = pnl.fit_patch_size(W, patch_size, stride)
    x_fit = x_scaled[:, :, :fh, :fw]
    first = comm.index == 0
    with torch.no_grad():
        xs = x_fit.detach().contiguous()
        # the halo: the next rank's first pad frames (ring wrap = loop pad)
        x_ext = torch.cat([xs, comm.shift(xs[:, :pad], 1)], 1) if pad \
            else xs
        ys = y.detach()[:, :, :fh, :fw].contiguous()
        T = Fl + pad
        plan = pnl.direct_plan(T, ys.shape[1], fh, fw, psz, strides) \
            if macro_block is None else \
            pnl.lowmem_plan(T, ys.shape[1], fh, fw, psz, strides, macro_block)
        xq, yq = pnl._nn_cast(x_ext.contiguous(), ys, nn_bf16)
        if alpha is None:
            nn = pnl.nn_argmin(xq, yq, plan)                     # K11
        else:
            cmin = comm.all_reduce(pnl.nn_argmin_colmin(xq, yq, plan),
                                   "min", inplace=True)          # K11 minima
            nn = pnl.nn_argmin_given(xq, yq, plan, alpha, cmin)  # K11 given
        canvas = pnl.nn_fold(yq, nn, plan, numer=True)           # K12 numer
        recv = None
        if pad:
            # the fold's spill rides the ring forward
            recv = comm.shift(canvas[:, Fl:].contiguous(), -1)
            if not first:
                canvas[:, :pad] += recv
        sw = torch.from_numpy(spatial_weight(plan)).to(xs.device)
        li = torch.arange(Fl, device=xs.device)
        wt = (torch.clamp(li + 1, max=pt) if first
              else torch.full_like(li, pt)).float()
        y2x = canvas[:, :Fl] / (wt[None, :, None, None] * sw[None, None])
    n_terms = C * (S * Fl + pad) * fh * fw
    local = torch.sum(pnl.robust_lossfun(x_fit - y2x, rou, scaling))
    if pad and first:
        wt_pad = torch.arange(pad, 0, -1, device=xs.device).float()
        y2x_pad = recv / (wt_pad[None, :, None, None] * sw[None, None])
        local = local + torch.sum(pnl.robust_lossfun(
            x_fit[:, :pad] - y2x_pad, rou, scaling))
    return _global_value(local / n_terms, comm)


class _Halo(torch.autograd.Function):
    """The next rank's first frames; the backward returns their cotangent
    to that rank, which adds it to its first frames."""

    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm.shift(t.contiguous(), 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.shift(g.contiguous(), -1), None


class _GatherCols(torch.autograd.Function):
    """(P, L, Fl) projected columns -> (P, L, S Fl), every rank's in rank
    order; the backward sums the gathered cotangent over the ranks and
    keeps this rank's slice."""

    @staticmethod
    def forward(ctx, px, comm):
        ctx.comm = comm
        g = comm.all_gather(px.contiguous())               # (S, P, L, Fl)
        S, P, L, Fl = g.shape
        return g.permute(1, 2, 0, 3).reshape(P, L, S * Fl)

    @staticmethod
    def backward(ctx, gy):
        comm = ctx.comm
        P, L, n = gy.shape
        g = gy.reshape(P, L, comm.size, n // comm.size).permute(2, 0, 1, 3)
        return comm.all_reduce(g.contiguous())[comm.index], None


class _Project(torch.autograd.Function):
    """K24's projection columns (P, L, cf) of 2 x - 1; backward K26."""

    @staticmethod
    def forward(ctx, x, rand, psz, strides):
        v = (x.detach().float() * 2 - 1).contiguous()
        ctx.save_for_backward(rand)
        ctx.geom = (tuple(x.shape), psz, strides)
        return swd.swd_project(v, rand, psz, strides)

    @staticmethod
    def backward(ctx, g):
        rand, = ctx.saved_tensors
        shape, psz, strides = ctx.geom
        return swd.swd_project_grad(g.contiguous(), rand, shape, psz,
                                    strides), None, None, None


class _SortL1(torch.autograd.Function):
    """K25's sorted-column L1 of ox against oy; backward its gradient."""

    @staticmethod
    def forward(ctx, ox, oy, map_x, map_y):
        loss, gx = swd.swd_sort_l1(ox.detach().contiguous(), oy, map_x,
                                   map_y)
        ctx.save_for_backward(gx)
        return loss

    @staticmethod
    def backward(ctx, g):
        gx, = ctx.saved_tensors
        return gx * g, None, None, None


def sharded_swd(x_scaled, y, draws, *, patch_size, patcht_size, stride,
                stridet, num_proj, comm, frm_num):
    """Frame-sharded sliced-Wasserstein loss: equal to
    ``losses/swd.py:swd_3d_loss`` of the loop-padded video (the default
    branch), with the gradient of this rank's frames.  x_scaled (3, Fl,
    h, w) (gradients flow), y (3, Ty, h, w); draws: `swd.swd_draws`' of
    the global column lengths, the same on every fp rank."""
    if stridet != 1:
        raise ValueError("fp swd needs stridet == 1")
    C, Fl, H, W = x_scaled.shape
    pt = patcht_size
    pad = pt - 1
    S = comm.size
    if Fl * S != frm_num or Fl < max(pad, 1):
        raise ValueError(f"fp swd: {Fl} frames a rank x {S} ranks for "
                         f"{frm_num} frames, pt {pt}")
    x = x_scaled
    if pad:
        x = torch.cat([x, _Halo.apply(x[:, :pad], comm)], 1)
    rand = draws["rand"]
    if tuple(rand.shape) != (num_proj, C, pt, patch_size, patch_size):
        raise ValueError(f"fp swd: projections {tuple(rand.shape)}")
    rand = swd.normalized_projections(rand.to(x.device))
    psz = (pt, patch_size, patch_size)
    strides = (1, stride, stride)
    px = _Project.apply(x, rand, psz, strides)                     # K24
    ox = _GatherCols.apply(px, comm)
    with torch.no_grad():
        oy = swd.swd_project((y.detach().float() * 2 - 1).contiguous(),
                             rand, psz, strides)                   # K24
    map_x, map_y = swd._match_maps(ox.shape[2], oy.shape[2],
                                   draws.get("perm"), ox.device)
    loss = _SortL1.apply(ox, oy, map_x, map_y)                     # K25
    # every rank computes the same loss from the gathered columns, so the
    # gather's backward sums S equal cotangents: divide the gradient by
    # S, keep the value
    return loss / S + (loss - loss / S).detach()


def fp_supports(losscfg, isloop=True):
    """(ok, reason-if-not) — whether the fp (frame-sharded) step covers
    this loss config.  The trainer warns and falls back to dp when not."""
    if not isloop:
        return False, "fp sharding's ring-halo wrap IS the loop pad; " \
                      "non-loop (--mpv_isloop off) configs run dp-only"
    name = losscfg.get("loss_name")
    if name == "swd":
        if losscfg.get("stridet", 1) != 1:
            return False, "fp swd requires stridet == 1"
        return True, ""
    if name not in ("gpnn_lm", "gpnn"):
        return False, "fp sharding implements the gpnn_lm/gpnn + swd " \
                      "losses (mse/avg are trivially cheap dp-only; " \
                      "gpnn_down's pre-NN temporal downsample couples " \
                      "frames across shard boundaries beyond the " \
                      "patcht-1 ring halo, so it stays dp-only)"
    if losscfg.get("stridet", 1) != 1:
        return False, "fp sharding requires stridet == 1"
    if losscfg.get("dist_fn", "mse") != "mse":
        return False, "fp sharding implements the mse patch distance"
    return True, ""


def make_fp_stage2_step(model, args, ph, pw, losscfg, grid):
    """Stage-2 step over the (dp, fp) grid: a patch a dp row, frames over
    fp.  Returns (step, opt_init); step(params, optimizer, batch, lr,
    weights, gen=None) takes this rank's params (``atlas_dyn`` holding
    its Fl frames) and its dp row's patch (batch as the dp step takes
    it).  gen: the dp row's generator, the same on each of its fp ranks."""
    S = grid.n_fp
    Fl = model.frm_num // S
    if Fl * S != model.frm_num:
        raise ValueError(f"--mesh_fp {S} does not divide {model.frm_num} "
                         "frames")
    ok, why = fp_supports(losscfg, isloop=model.isloop)
    if not ok:
        raise ValueError(why)
    from videoloop3d_torch.train.stage2 import resolve_video
    cfg = dict(losscfg)
    loss_name = cfg.pop("loss_name")
    loss_gain = float(cfg.pop("loss_gain", 1.0))
    if loss_name == "gpnn":
        cfg["macro_block"] = None        # one crop over the fitted frame
    alpha = pnl._norm_alpha(cfg["alpha"])
    pt = cfg["patcht_size"]
    num_proj = int(cfg.get("num_proj", 256))
    group_fn = opt_lib.make_group_fn(args.optimize_verts_gain)
    local_model = copy.copy(model)       # renders this rank's frames
    local_model.frm_num = Fl

    def opt_init(params):
        opt_lib.trainable(params)
        return opt_lib.make_optimizer(args.optimizer, params, group_fn,
                                      eps=6e-8)

    def loss_fn(p, batch, weights, gen):
        rgb, variables = local_model.render(
            p, ph, pw, batch["extrin"], batch["intrin"], None,
            training=True, gen=gen, draws=batch.get("draws"))
        x = rgb.permute(3, 0, 1, 2)                         # (3, Fl, h, w)
        if args.scale_invariant:
            rgb_avg = grid.fp.all_reduce(
                torch.mean(rgb.detach(), dim=0), inplace=True) / S
            x = x * common.scale_invariant_gain(
                torch.mean(batch["video"], dim=0), rgb_avg)
        y = batch["video"].permute(3, 0, 1, 2)
        if loss_name == "swd":
            draws = (batch.get("draws") or {}).get("swd")
            if draws is None:
                draws = swd.swd_draws(
                    gen, num_proj, x.shape[0], pt, cfg["patch_size"],
                    swd.swd_n_short(model.frm_num, y.shape[1] - pt + 1))
            main = sharded_swd(
                x, y, draws, patch_size=cfg["patch_size"], patcht_size=pt,
                stride=cfg["stride"], stridet=cfg["stridet"],
                num_proj=num_proj, comm=grid.fp, frm_num=model.frm_num)
        else:
            main = sharded_gpnn_lowmem(
                x, y, patch_size=cfg["patch_size"], patcht_size=pt,
                stride=cfg["stride"], alpha=alpha, rou=cfg["rou"],
                scaling=cfg["scaling"], macro_block=cfg["macro_block"],
                comm=grid.fp, frm_num=model.frm_num,
                nn_bf16=cfg.get("nn_bf16", False))
        main = main * loss_gain
        # the regularizers are means over this rank's frames: the global
        # term is their fp mean, whose gradient here is 1 / S of theirs
        extras = local_model.training_extras(variables, loss_gain)
        total = main + sum(weights[k] * v / S for k, v in extras.items())
        return total, main, extras

    def step(params, optimizer, batch, lr, weights, gen=None):
        wt = batch.get("wt")
        b = resolve_video(batch, ph, pw)
        optimizer.zero_grad(set_to_none=True)
        total, main, extras = loss_fn(params, b, weights, gen)
        total.backward()
        # replicated params gather gradient from every rank's frames, and
        # the extras' values are the fp mean: one fp all_reduce of both
        rep = [q for q in optimizer_params(optimizer)
               if q.grad is not None and q is not params["atlas_dyn"]]
        keys = sorted(extras)
        vals = [torch.as_tensor(extras[k]).float().reshape(1) for k in keys]
        if S > 1:
            buf = grid.fp.all_reduce(torch.cat(
                [q.grad.reshape(-1) for q in rep]
                + [v.detach().to(main.device) for v in vals]),
                inplace=True)
            off = 0
            for q in rep:
                q.grad.copy_(buf[off:off + q.numel()].view_as(q))
                off += q.numel()
            vals = list(buf[off:] / S)
        metrics = {"swd": main.detach()}
        loss = main.detach()
        for k, v in zip(keys, vals):
            metrics[k] = v.reshape(()).detach()
            loss = loss + weights[k] * metrics[k]
        metrics["loss"] = loss
        metrics = reduce_step(optimizer, metrics, grid.dp, wt)
        opt_lib.set_lr(optimizer, lr)
        optimizer.step()
        return metrics

    return step, opt_init
