"""The port's stage-1 train step and trainer CLI against the JAX package,
on the CPU, on both composite routes (the shipped unfused chain and
``--fused_render``): one step from JAX's parameters, a 2-epoch
``tools/train_3d.main`` run on a synthetic scene, the auto-resume from a
JAX-written checkpoint, and the SIGTERM exit."""
import json
import os
import shutil
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models.mpmesh import MPMesh as JaxMPMesh
from videoloop3d_tpu.tools import train_3d as jax_train_3d
from videoloop3d_tpu.train import stage1 as JS1
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.models import checkpoint as tck
from videoloop3d_torch.models.mpmesh import MPMesh as TorchMPMesh
from videoloop3d_torch.tools import train_3d
from videoloop3d_torch.train import common as TC
from videoloop3d_torch.train import stage1 as TS1

CPU = torch.device("cpu")
ROUTES = {"shipped": [], "fused": ["--fused_render"]}


def _step_setup(route):
    argv = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
            "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "6",
            "--scale_invariant", "--learn_loop_mask", "--fast_stage1_grad",
            "--sparsity_loss_weight", "0.004",
            "--rgb_smooth_loss_weight", "0.2",
            "--a_smooth_loss_weight", "0.5", "--d_smooth_loss_weight", "0.1",
            "--l_smooth_loss_weight", "0.1", "--density_loss_weight", "0.02",
            "--lrate", "0.1"] + ROUTES[route]
    H, W = 24, 32
    intrin = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                      np.float32)
    ja, ta = jax_parse(argv), torch_parse(argv)
    jm = JaxMPMesh(ja, H, W, np.eye(4), intrin, 1.5, 6.0)
    tm = TorchMPMesh(ta, H, W, np.eye(4), intrin, 1.5, 6.0, device=CPU)
    p = {k: np.asarray(v) for k, v in jm.init_params(1).items()}
    rng = np.random.default_rng(0)
    p["atlas"] = rng.standard_normal(p["atlas"].shape).astype(np.float32)
    p["atlas_mask"] = rng.standard_normal(
        p["atlas_mask"].shape).astype(np.float32)
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, :3, 3] = [0.1, -0.05, 0.02]
    batch = {"extrin": ext, "intrin": intrin[None].copy(),
             "rgb": rng.random((1, H, W, 3), dtype=np.float32),
             "loopmask": (rng.random((1, H, W)) < 0.5).astype(np.float32)}
    weights = {k: 0.3 for k in JS1.STAGE1_WEIGHT_KEYS}
    return ja, ta, jm, tm, p, batch, weights, (H, W)


@pytest.mark.parametrize("route", list(ROUTES))
def test_stage1_step_matches_jax(route):
    """From JAX's parameters with --fast_stage1_grad: the loss and every
    metric within 1e-5 relative, the atlas and atlas_mask gradients within
    1e-5 * max|g|, and the parameters after one Adam step (lr 0.1) within
    1e-5 on >= 99.9% of entries.  Adam's first update is about
    lr * sign(g), so an entry whose gradient is roundoff-sized may step
    the other way."""
    ja, ta, jm, tm, p, batch, weights, (H, W) = _step_setup(route)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jloss = JS1.make_stage1_loss_fn(jm, ja, H, W)
    (_, jmet), jg = jax.jit(jax.value_and_grad(
        lambda q: jloss(q, jb, weights, None), has_aux=True))(jp)

    tp = tck.params_from_numpy(p, CPU)
    step, opt_init, keys = TS1.make_train_step(tm, ta, H, W)
    assert keys == JS1.STAGE1_WEIGHT_KEYS
    opt = opt_init(tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, tmet = TS1.make_stage1_loss_fn(tm, ta, H, W)(tp, tb, weights)
    total.backward()
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k].detach()), float(jmet[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    for k in ("atlas", "atlas_mask"):
        a = np.asarray(jg[k])
        assert np.abs(tp[k].grad.numpy() - a).max() <= 1e-5 * np.abs(a).max()

    jstep, jinit, _ = JS1.make_train_step(jm, ja, H, W)
    jp2, _, _ = jstep(jp, jinit(jp), jb, jnp.asarray(0.1, jnp.float32),
                      {k: jnp.asarray(v, jnp.float32)
                       for k, v in weights.items()}, jax.random.PRNGKey(0))
    tp2 = tck.params_from_numpy(p, CPU)
    metrics = step(tp2, opt_init(tp2), tb, 0.1, weights)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    for k in ("atlas", "atlas_mask", "verts"):
        close = np.isclose(tp2[k].detach().numpy(), np.asarray(jp2[k]),
                           rtol=0, atol=1e-5)
        assert close.mean() >= 0.999, (k, close.mean())


def _argv(root, exp, route, n_iters=2):
    return ["--datadir", os.path.join(root, "scene"),
            "--expdir", os.path.join(root, exp), "--expname", "s",
            "--factor", "1", "--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
            "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "4",
            "--atlas_grid_h", "2", "--patch_h_size", "24",
            "--patch_w_size", "32", "--patch_h_stride", "16",
            "--patch_w_stride", "24", "--lrate", "0.1",
            "--lrate_decay", "100", "--N_iters", str(n_iters),
            "--i_weights", "1", "--i_video", "1000", "--i_img", "1",
            "--i_print", "1000", "--scale_invariant", "--learn_loop_mask",
            "--add_intrin_noise", "--fast_stage1_grad",
            "--sparsity_loss_weight", "0.004",
            "--rgb_smooth_loss_weight", "0.2",
            "--a_smooth_loss_weight", "0.5", "--density_loss_weight", "0.02",
            "--density_loss_epoch", "1", "--seed", "1", "--mesh_devices", "1",
            "--gpu_num", "0"] + ROUTES[route]


def _series(rundir, tag):
    out = []
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["tag"] == f"stage1/{tag}":
                out.append((r["step"], r["value"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The synthetic scene and JAX's 2-epoch run of each route."""
    root = str(tmp_path_factory.mktemp("s1"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VL3D_DATA_CACHE", "off")
        scene = jsyn.make_scene(n_views=3, h=24, w=32, n_frames=6, seed=0)
        jsyn.write_llff_dir(scene, os.path.join(root, "scene"), factor=1)
        for route in ROUTES:
            jax_train_3d.main(_argv(root, f"jax_{route}", route))
        yield root


# the per-step loss tolerance of a 2-epoch run (6 Adam steps at lr 0.1):
# the first step's loss agrees to 1e-5; later steps inherit Adam's
# sign sensitivity (see test_stage1_step_matches_jax).  On the fused
# route the two packages stay within 1e-4; on the shipped route JAX's
# autodiff of the unfused chain moves a few roundoff-sized gradients
# to the other side of zero, and its losses from step 2 on sit ~1e-3
# from the port's, which stays within 1e-4 of JAX's fused route.
TRAJ_RTOL = {"shipped": 3e-3, "fused": 1e-4}


@pytest.mark.parametrize("route", list(ROUTES))
def test_train_3d_matches_jax(runs, route):
    train_3d.main(_argv(runs, f"torch_{route}", route))
    t_dir = os.path.join(runs, f"torch_{route}", "s")
    j_dir = os.path.join(runs, f"jax_{route}", "s")
    t_loss, j_loss = _series(t_dir, "loss"), _series(j_dir, "loss")
    assert [s for s, _ in t_loss] == [s for s, _ in j_loss] == list(range(6))
    t_v = np.array([v for _, v in t_loss])
    j_v = np.array([v for _, v in j_loss])
    assert abs(t_v[0] - j_v[0]) <= 1e-5 * abs(j_v[0])
    np.testing.assert_allclose(t_v, j_v, rtol=TRAJ_RTOL[route])
    psnr = [v for _, v in _series(t_dir, "psnr")]
    assert psnr[-1] > psnr[0]
    assert sorted(f for f in os.listdir(t_dir) if f.startswith("ckpt")) == \
        ["ckpt_epoch_0000.npz", "ckpt_epoch_0001.npz"]
    loaded = jck.load_checkpoint(os.path.join(t_dir, "ckpt_epoch_0001.npz"))
    assert loaded["meta"]["extra"]["epoch_i"] == 1
    assert set(loaded["params"]) == {"atlas", "atlas_mask", "verts"}
    assert _series(t_dir, "warm_step_ms")


def test_train_3d_patch_batch_matches_jax(runs):
    """``--patch_batch 2`` (two patches a step, the loss their mean) on
    the fused route: 3 steps in 2 epochs, the four logged losses (loss,
    mse, loop_bce and psnr) within test_train_3d_matches_jax's relative
    tolerance of JAX's."""
    argv = ["--patch_batch", "2"]
    jax_train_3d.main(_argv(runs, "jax_pb2", "fused") + argv)
    train_3d.main(_argv(runs, "torch_pb2", "fused") + argv)
    for tag in ("loss", "mse", "loop_bce", "psnr"):
        t = _series(os.path.join(runs, "torch_pb2", "s"), tag)
        j = _series(os.path.join(runs, "jax_pb2", "s"), tag)
        assert [s for s, _ in t] == [s for s, _ in j] == [0, 1, 2]
        np.testing.assert_allclose([v for _, v in t], [v for _, v in j],
                                   rtol=TRAJ_RTOL["fused"])


def test_port_auto_resumes_a_jax_checkpoint(runs):
    """JAX's epoch-0 checkpoint auto-resumes in the port at epoch 1; the
    resumed epoch's losses equal JAX's own resume from the same file
    (fused route, 1e-4)."""
    src = os.path.join(runs, "jax_fused", "s", "ckpt_epoch_0000.npz")
    for pkg in ("jax", "torch"):
        d = os.path.join(runs, f"resume_{pkg}", "s")
        os.makedirs(d)
        shutil.copy(src, d)
    jax_train_3d.main(_argv(runs, "resume_jax", "fused"))
    model, params, rundir = train_3d.main(_argv(runs, "resume_torch",
                                                "fused"))
    t_loss = _series(rundir, "loss")
    j_loss = _series(os.path.join(runs, "resume_jax", "s"), "loss")
    assert [s for s, _ in t_loss] == [s for s, _ in j_loss] == [3, 4, 5]
    np.testing.assert_allclose([v for _, v in t_loss],
                               [v for _, v in j_loss], rtol=1e-4)
    j_end = jck.load_checkpoint(os.path.join(runs, "resume_jax", "s",
                                             "ckpt_epoch_0001.npz"))
    for k in ("atlas", "atlas_mask"):
        close = np.isclose(params[k].detach().numpy(), j_end["params"][k],
                           rtol=0, atol=1e-4)
        assert close.mean() >= 0.999


def test_train_3d_sigterm_checkpoints_exits_75_and_resumes(runs,
                                                           monkeypatch):
    """SIGTERM during epoch 1 stops at the next step, checkpoints epoch 0
    and exits 75; a rerun resumes at epoch 1 and finishes.  The
    --profile_steps window writes a torch.profiler trace."""
    ticks = []
    tick = TC.Profiler.tick

    def tick_and_term(self):
        tick(self)
        ticks.append(1)
        if len(ticks) == 4:                 # the first step of epoch 1
            # what a SIGTERM runs: the handler the trainer installed
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    monkeypatch.setattr(TC.Profiler, "tick", tick_and_term)
    argv = _argv(runs, "sigterm", "fused") + ["--profile_steps", "1:2"]
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        train_3d.main(argv)
    assert exc.value.code == 75
    rundir = os.path.join(runs, "sigterm", "s")
    assert sorted(f for f in os.listdir(rundir) if f.startswith("ckpt")) == \
        ["ckpt_epoch_0000.npz"]
    assert signal.getsignal(signal.SIGTERM) is before
    assert os.path.isfile(os.path.join(rundir, "profile", "trace.json"))
    monkeypatch.setattr(TC.Profiler, "tick", tick)
    train_3d.main(argv)
    assert [s for s, _ in _series(rundir, "loss")] == [0, 1, 2, 3, 3, 4, 5]
