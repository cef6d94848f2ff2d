"""The port's frame-parallel layer (``videoloop3d_torch/parallel/fp_step.py``)
against the single-device losses and the JAX package's fp step, with the
tolerances of ``tests/test_fp_sharding.py``.

Two gloo processes (this file run as a script, ``_worker``) each take
half of the frames: the ring-halo'd, fold-spilled gpnn_lm loss with alpha
off and on (K11's minima and given-minima modes, K12's numerator mode,
their plain versions here), the swd loss with its gradient through the
halo and the gathered columns, and one SGD step of the fp stage-2 step.
The test process holds them against JAX's single-device loop-padded
losses, the port's single-device step and JAX's ``make_fp_stage2_step``
on a (dp 1, fp 2) virtual CPU mesh.  The K11/K12 modes' plain versions
are held against the current K11/K12 at one rank.
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_parallel import (CPU, GEOM, LOSSCFG, _ext, _ref, _scene,
                                 launch)
from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.losses import patch_nn as jpnl
from videoloop3d_tpu.losses.swd import swd_3d_loss as jax_swd
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPMeshVid
from videoloop3d_tpu.parallel.fp_step import make_fp_stage2_step
from videoloop3d_tpu.parallel.mesh import make_mesh
from videoloop3d_tpu.train.stage2 import make_stage2_step as jax_step

F, H, W = 8, 20, 24
SWD_KW = dict(patch_size=5, patcht_size=3, stride=2, stridet=1, num_proj=16)
FP_ARGV = GEOM + ["--mpv_frm_num", "8", "--mpv_isloop", "--scale_invariant",
                  "--init_std", "0.02", "--rgb_smooth_loss_weight", "0.2",
                  "--a_smooth_loss_weight", "0.2", "--optimizer", "sgd"]
S2_KEYS = ("sparsity", "rgb_smooth", "a_smooth", "d_smooth", "density")
ALPHAS = {"alpha_off": None, "alpha_on": 0.01}
LR = 0.1


def _gpnn_kw():
    return {k: LOSSCFG[k] for k in ("patch_size", "patcht_size", "stride",
                                    "rou", "scaling", "macro_block")}


def fp_inputs():
    rng = np.random.default_rng(0)
    out = {"gx": rng.random((3, F, H, W)).astype(np.float32),
           "gy": rng.random((3, F, H, W)).astype(np.float32)}
    rng = np.random.default_rng(2)
    out["sx"] = rng.random((3, F, H, W)).astype(np.float32)
    out["sy"] = rng.random((3, F, H, W)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    pt, p = SWD_KW["patcht_size"], SWD_KW["patch_size"]
    out["rand"] = np.array(jax.random.normal(
        key, (SWD_KW["num_proj"], 3, pt, p, p)))
    n_x, n_y = F, F - pt + 1            # loop-padded x: F temporal patches
    short = min(n_x, n_y)
    out["perm"] = np.array(jax.random.permutation(key, short)).astype(
        np.int64)
    sc = _scene(2, F)
    jm = JaxMPMeshVid(jax_parse(FP_ARGV), 24, 32, _ref(sc), sc["intrins"][0],
                      float(sc["bds"][0]), float(sc["bds"][1]))
    for k, v in jm.init_params(0).items():
        out[f"p/{k}"] = np.asarray(v)
    out["extrin"] = _ext(sc["poses"][0])[None]
    out["intrin"] = sc["intrins"][:1].astype(np.float32)
    out["video"] = sc["videos"][0].astype(np.float32)
    return out


def _torch_model():
    from videoloop3d_torch.config import parse_args_with_configs as tparse
    from videoloop3d_torch.models.mpv import MPMeshVid
    sc = _scene(2, F)
    args = tparse(FP_ARGV + ["--gpu_num", "0"])
    return args, MPMeshVid(args, 24, 32, _ref(sc), sc["intrins"][0],
                           float(sc["bds"][0]), float(sc["bds"][1]),
                           device=CPU)


def _batch(inp):
    return {"extrin": torch.from_numpy(inp["extrin"]),
            "intrin": torch.from_numpy(inp["intrin"]),
            "video": torch.from_numpy(inp["video"])}


def _worker(workdir, rank, world, init):
    from videoloop3d_torch.parallel import distributed as dist
    from videoloop3d_torch.parallel import fp_step as tfp
    dist.init_distributed(CPU, init, world, rank)
    grid = dist.make_mesh(n_dp=1, n_fp=world)
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    fl = F // world
    sl = slice(rank * fl, (rank + 1) * fl)
    out = {}
    for tag, alpha in ALPHAS.items():
        x = torch.from_numpy(inp["gx"][:, sl].copy()).requires_grad_(True)
        loss = tfp.sharded_gpnn_lowmem(
            x, torch.from_numpy(inp["gy"]), alpha=alpha, comm=grid.fp,
            frm_num=F, **_gpnn_kw())
        loss.backward()
        out[f"{tag}/loss"] = loss.detach().numpy()
        out[f"{tag}/grad"] = x.grad.numpy()
    x = torch.from_numpy(inp["sx"][:, sl].copy()).requires_grad_(True)
    draws = {"rand": torch.from_numpy(inp["rand"]),
             "perm": torch.from_numpy(inp["perm"])}
    loss = tfp.sharded_swd(x, torch.from_numpy(inp["sy"]), draws, comm=grid.fp,
                           frm_num=F, **SWD_KW)
    loss.backward()
    out["swd/loss"] = loss.detach().numpy()
    out["swd/grad"] = x.grad.numpy()
    # one SGD step of the fp stage-2 step on this rank's frames
    args, model = _torch_model()
    step, opt_init = tfp.make_fp_stage2_step(model, args, 24, 32, LOSSCFG,
                                             grid)
    full = {k[2:]: torch.from_numpy(v.copy()) for k, v in inp.items()
            if k.startswith("p/")}
    params = dist.shard_params_by_frames(full, grid)
    m = step(params, opt_init(params), _batch(inp), LR,
             {k: 0.2 for k in S2_KEYS})
    for k, v in dist.gather_for_host(params, grid).items():
        out[f"step/{k}"] = v.numpy()
    out["step/loss"] = np.float32(m["loss"])
    np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def fp_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("fp")
    inp = fp_inputs()
    np.savez(d / "inputs.npz", **inp)
    launch(lambda i, init: [sys.executable, __file__, "worker", str(d),
                            str(i), "2", init], 2, d)
    return inp, [dict(np.load(d / f"out{i}.npz")) for i in range(2)]


def _jax_gpnn(x, y, alpha):
    pad = LOSSCFG["patcht_size"] - 1
    x_pad = jnp.concatenate([x, x[:, :pad]], axis=1)
    return jpnl.gpnn_lowmem_loss(
        x_pad, y, patch_size=LOSSCFG["patch_size"],
        patcht_size=LOSSCFG["patcht_size"], stride=LOSSCFG["stride"],
        stridet=1, alpha=1e10 if alpha is None else alpha,
        rou=LOSSCFG["rou"], scaling=LOSSCFG["scaling"],
        macro_block=LOSSCFG["macro_block"])


@pytest.mark.parametrize("case", list(ALPHAS))
def test_torch_sharded_gpnn_matches_single_device(fp_run, case):
    """The ring-halo'd, fold-spilled, pad-wrapped loss on 2 ranks equals
    JAX's single-device loop-padded gpnn_lm within 2e-4 relative (with
    alpha, the column minima run over both ranks' patches), and the ranks'
    gradients, concatenated, JAX's single-device gradient within 1e-5."""
    inp, outs = fp_run
    alpha = ALPHAS[case]
    want, want_g = jax.value_and_grad(_jax_gpnn)(
        jnp.asarray(inp["gx"]), jnp.asarray(inp["gy"]), alpha)
    for o in outs:
        np.testing.assert_allclose(o[f"{case}/loss"], float(want), rtol=2e-4)
    got = np.concatenate([o[f"{case}/grad"] for o in outs], axis=1)
    np.testing.assert_allclose(got, np.asarray(want_g), atol=1e-5)


def test_torch_sharded_swd_matches_single_device(fp_run):
    """The halo'd, all-gathered swd on 2 ranks: value within 2e-5 of JAX's
    single-device loop-padded swd_3d_loss on the same key, and the ranks'
    gradients (through the halo and the gather), concatenated, JAX's within
    1e-5."""
    inp, outs = fp_run
    key = jax.random.PRNGKey(7)
    pad = SWD_KW["patcht_size"] - 1

    def single(xv):
        x_pad = jnp.concatenate([xv, xv[:, :pad]], axis=1)
        return jax_swd(x_pad, jnp.asarray(inp["sy"]), key, **SWD_KW)

    want, want_g = jax.value_and_grad(single)(jnp.asarray(inp["sx"]))
    for o in outs:
        np.testing.assert_allclose(o["swd/loss"], float(want), rtol=2e-5)
    got = np.concatenate([o["swd/grad"] for o in outs], axis=1)
    np.testing.assert_allclose(got, np.asarray(want_g), atol=1e-5)


def _check_step(got, want, p0):
    """tests/test_fp_sharding.py:163-183's rule: a residual under 0.25 of
    the update, and the bulk gradient scale within 1e-3 of 1."""
    if want.size == 0:
        return
    upd = np.abs(want - p0).max()
    assert np.abs(got - want).max() < max(0.25 * upd, 1e-7), \
        (np.abs(got - want).max(), upd)
    if upd == 0.0:
        return
    g_got, g_want = (p0 - got).ravel(), (p0 - want).ravel()
    big = np.abs(g_want) > np.abs(g_want).max() * 1e-3
    assert abs(np.median(g_got[big] / g_want[big]) - 1.0) < 1e-3


def test_torch_fp_step_matches_single_device(fp_run):
    """One SGD step of the fp step (2 ranks of 4 frames): the gathered
    params follow the port's single-device step by the rule of
    tests/test_fp_sharding.py, and the loss is within 2e-4 relative."""
    from videoloop3d_torch.train.stage2 import make_stage2_step
    inp, outs = fp_run
    args, model = _torch_model()
    step, opt_init = make_stage2_step(model, args, 24, 32, LOSSCFG)
    params = {k[2:]: torch.from_numpy(v.copy()) for k, v in inp.items()
              if k.startswith("p/")}
    m = step(params, opt_init(params), _batch(inp), LR,
             {k: 0.2 for k in S2_KEYS})
    for k, v in params.items():
        np.testing.assert_array_equal(outs[0][f"step/{k}"],
                                      outs[1][f"step/{k}"])
        _check_step(outs[0][f"step/{k}"], v.detach().numpy(),
                    inp[f"p/{k}"])
    np.testing.assert_allclose(outs[0]["step/loss"], float(m["loss"]),
                               rtol=2e-4)


def test_torch_fp_step_matches_jax(fp_run):
    """The same step against JAX's make_fp_stage2_step on a (dp 1, fp 2)
    mesh (and so against JAX's single-device step, which that one
    follows), by the same rule."""
    inp, outs = fp_run
    args = jax_parse(FP_ARGV)
    sc = _scene(2, F)
    jm = JaxMPMeshVid(args, 24, 32, _ref(sc), sc["intrins"][0],
                      float(sc["bds"][0]), float(sc["bds"][1]))
    params = {k[2:]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith("p/")}
    weights = {k: jnp.asarray(0.2, jnp.float32) for k in S2_KEYS}
    step, init = make_fp_stage2_step(jm, args, 24, 32, LOSSCFG,
                                     make_mesh(n_dp=1, n_fp=2),
                                     param_keys=tuple(params))
    p, _, m = step(jax.tree.map(jnp.copy, params), init(params),
                   {"extrin": jnp.asarray(inp["extrin"]),
                    "intrin": jnp.asarray(inp["intrin"]),
                    "video": jnp.asarray(inp["video"][None])},
                   jnp.asarray(LR), weights, jax.random.PRNGKey(0))
    s_step, s_init = jax_step(jm, args, 24, 32, LOSSCFG)
    ps, _, ms = s_step(jax.tree.map(jnp.copy, params), s_init(params),
                       {"extrin": jnp.asarray(inp["extrin"]),
                        "intrin": jnp.asarray(inp["intrin"]),
                        "video": jnp.asarray(inp["video"])},
                       jnp.asarray(LR), weights, jax.random.PRNGKey(0))
    for k in params:
        _check_step(outs[0][f"step/{k}"], np.asarray(p[k]), inp[f"p/{k}"])
        _check_step(outs[0][f"step/{k}"], np.asarray(ps[k]), inp[f"p/{k}"])
    np.testing.assert_allclose(outs[0]["step/loss"], float(m["loss"]),
                               rtol=2e-4)


def _plan_inputs(seed=3):
    from videoloop3d_torch.losses import patch_nn as tpnl
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((3, 10, 20, 24)).astype(np.float32))
    y = torch.from_numpy(rng.random((3, 8, 20, 24)).astype(np.float32))
    plan = tpnl.lowmem_plan(10, 8, 20, 24, (3, 3, 3), (1, 2, 2), 17)
    return x, y, plan


def test_torch_nn_modes_at_one_rank_are_k11_and_k12():
    """A rank that passes its own column minima gets K11's indices bit for
    bit (the given-minima mode), the minima mode's values are JAX's column
    minima of its distances within 1e-6, and the numerator mode divided
    by the plan's weight is K12 bit for bit (plain versions, the CPU
    route of the wrappers)."""
    from videoloop3d_torch.losses import patch_nn as tpnl
    x, y, plan = _plan_inputs()
    cmin = tpnl.nn_argmin_colmin(x, y, plan)
    for alpha in (0.0, 0.01):
        np.testing.assert_array_equal(
            tpnl.nn_argmin_given(x, y, plan, alpha, cmin).numpy(),
            tpnl.nn_argmin(x, y, plan, alpha).numpy())
    # JAX's distances of the first crop, its column minima over x
    xc = jnp.asarray(x.numpy()[:, :, :17, :17])
    yc = jnp.asarray(y.numpy()[:, :, :17, :17])
    Xp = jpnl.extract_patches_3d(xc, (3, 3, 3), (1, 2, 2))
    Yp = jpnl.extract_patches_3d(yc, (3, 3, 3), (1, 2, 2))
    ntx, nh, nw = Xp.shape[:3]
    Xf = Xp.reshape(ntx, nh * nw, -1).transpose(1, 0, 2)
    Yf = Yp.reshape(Yp.shape[0], nh * nw, -1).transpose(1, 0, 2)
    jmin = np.asarray(jnp.min(jpnl._pairwise_sqdist(Xf, Yf), axis=1))
    np.testing.assert_allclose(cmin[0].numpy(), jmin, atol=1e-6)
    nn = tpnl.nn_argmin(x, y, plan, None)
    num = tpnl.nn_fold(y, nn, plan, numer=True)
    np.testing.assert_array_equal(
        (num / torch.from_numpy(plan.weight)).numpy(),
        tpnl.nn_fold(y, nn, plan).numpy())


def test_torch_fp_supports_matches_jax():
    """fp_supports gives JAX's verdict and reason for every loss name,
    stridet, distance and loop setting."""
    from videoloop3d_torch.parallel.fp_step import fp_supports as t_sup
    from videoloop3d_tpu.parallel.fp_step import fp_supports as j_sup
    for name in ("gpnn_lm", "gpnn", "gpnn_down", "swd", "mse", "avg"):
        for stridet in (1, 2):
            for dist_fn in ("mse", "ssim"):
                for isloop in (True, False):
                    cfg = {"loss_name": name, "stridet": stridet,
                           "dist_fn": dist_fn}
                    assert t_sup(cfg, isloop) == j_sup(cfg, isloop)


def test_torch_frame_sharding_roundtrip():
    """shard_params_by_frames / gather_params_by_frames on a grid of one
    rank are the identity, and the frame slices of fp ranks tile the
    frames in rank order."""
    from videoloop3d_torch.parallel import distributed as dist
    grid = dist.make_mesh()
    p = {"atlas_dyn": torch.arange(2 * 3 * 3 * 8 * 4.0).reshape(
        2, 3, 3, 8, 4), "verts": torch.zeros(2, 5, 7)}
    assert dist.gather_params_by_frames(
        dist.shard_params_by_frames(p, grid), grid) is p
    slices = []
    for r in range(4):
        g = dist.Grid(1, 4, 0, r, grid.dp, grid.fp)
        slices.append(dist.frame_slice(8, g))
    assert slices == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="do not divide"):
        dist.frame_slice(7, dist.Grid(1, 2, 0, 0, grid.dp, grid.fp))


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
