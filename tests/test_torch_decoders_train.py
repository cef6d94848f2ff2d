"""The view-dependent decoders through the PyTorch port's trainers and
tools against the JAX package, on the CPU: ``train_3d`` with the direct ->
SH event inside a 3-epoch run and its resume, a dense stage-2 step of a
scratch rgb_sh MTV, and README's quick start with ``--direct2sh_epoch``
(``train_3d`` through the event and the cull, ``train_3dvid`` adopting
rgb_sh, ``render_video``, ``evaluate``, ``export_mesh``), whose renders
and export are held to the JAX package's on the same checkpoint."""
import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.eval.evaluate import evaluate as jax_evaluate
from videoloop3d_tpu.eval.evaluate import load_mpv_from_run as jax_load_mpv
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.tools import export_mesh as jexport
from videoloop3d_tpu.tools import train_3d as jax_train_3d
from videoloop3d_tpu.train import stage2 as JS2
from videoloop3d_torch.config import parse_args_with_configs
from videoloop3d_torch.core import cameras
from videoloop3d_torch.data import llff, synthetic
from videoloop3d_torch.data.video import to8b
from videoloop3d_torch.eval.evaluate import load_mpv_from_run
from videoloop3d_torch.models import checkpoint as tck
from videoloop3d_torch.tools import (evaluate, export_mesh, render_video,
                                     train_3d, train_3dvid)
from videoloop3d_torch.train import optimizer as TO
from videoloop3d_torch.train import stage2 as TS2
from videoloop3d_torch.train.stage2 import render_eval

from test_torch_eval import _assert_tables_close, _table
from test_torch_export import _assert_exports_match
from test_torch_stage1_sparse import _argv as _s1_argv
from test_torch_stage1_sparse import _series

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S1 = os.path.join(REPO, "configs", "debug_synthetic_s1.txt")
S2 = os.path.join(REPO, "configs", "debug_synthetic_s2.txt")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sh"))
    jsyn.write_llff_dir(jsyn.make_scene(n_views=3, h=24, w=32, n_frames=6,
                                        seed=0),
                        os.path.join(root, "scene"), factor=1)
    return root


# the unfused chain's trajectories: JAX's autodiff moves a few
# roundoff-sized gradients to the other side of zero, and the losses from
# the second step on sit up to ~1e-3 apart (tests/test_torch_stage1_train.py)
TRAJ_RTOL = 3e-3


def test_train_3d_direct2sh_event_matches_jax(scene, monkeypatch):
    """--direct2sh_epoch 1 in a 3-epoch run (``--fused_render``: the
    direct epoch fused, the rgb_sh epochs on the unfused chain): the
    losses of both packages, the first within 1e-5; the checkpoints of
    epochs 1 and 2 are 13-channel rgb_sh ones; a rerun to 4 epochs
    resumes as rgb_sh in both packages, from each other's checkpoint."""
    monkeypatch.setenv("VL3D_DATA_CACHE", "off")
    ev = ["--direct2sh_epoch", "1", "--fused_render"]
    jax_train_3d.main(_s1_argv(scene, "ev_jax", 3, ev))
    model, params, rundir = train_3d.main(_s1_argv(scene, "ev_torch", 3, ev))
    assert model.cfg.rgb_mlp_type == "rgb_sh"
    assert params["atlas"].shape[-1] == 13
    jdir = os.path.join(scene, "ev_jax", "s")
    t_loss, j_loss = _series(rundir, "loss"), _series(jdir, "loss")
    assert [s for s, _ in t_loss] == [s for s, _ in j_loss] == list(range(9))
    t_v, j_v = [v for _, v in t_loss], [v for _, v in j_loss]
    assert abs(t_v[0] - j_v[0]) <= 1e-5 * abs(j_v[0])
    np.testing.assert_allclose(t_v, j_v, rtol=TRAJ_RTOL)
    assert _series(rundir, "warm_step_ms_rgb_sh")
    for e in (1, 2):
        for d in (rundir, jdir):
            ck = jck.load_checkpoint(os.path.join(d, f"ckpt_epoch_{e:04d}.npz"))
            assert ck["meta"]["extra"]["rgb_mlp_type"] == "rgb_sh"
            assert ck["params"]["atlas"].shape[-1] == 13
    for src, dst in ((rundir, "res_jax"), (jdir, "res_torch")):
        os.makedirs(os.path.join(scene, dst, "s"))
        shutil.copy(os.path.join(src, "ckpt_epoch_0002.npz"),
                    os.path.join(scene, dst, "s"))
    jax_train_3d.main(_s1_argv(scene, "res_jax", 4, ev))
    model, _, rdir = train_3d.main(_s1_argv(scene, "res_torch", 4, ev))
    assert model.cfg.rgb_mlp_type == "rgb_sh"
    r_t = _series(rdir, "loss")
    r_j = _series(os.path.join(scene, "res_jax", "s"), "loss")
    assert [s for s, _ in r_t] == [s for s, _ in r_j] == [9, 10, 11]
    np.testing.assert_allclose([v for _, v in r_t], [v for _, v in r_j],
                               rtol=TRAJ_RTOL)


def test_stage2_dense_sh_step(scene):
    """One stage-2 loss of a scratch (dense) rgb_sh MTV: the JAX model's
    init_params and render through K16/K17's plain versions, metrics
    within 1e-5 relative and the atlas gradient within 1e-5 * max|g|."""
    from test_torch_stage2_train import _argv as _s2_argv
    from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPMeshVid
    from videoloop3d_torch.models.mpv import MPMeshVid as TorchMPMeshVid
    argv = _s2_argv(scene, "x", ["--mpi_h_scale", "1.0", "--mpi_w_scale",
                                 "1.0", "--init_std", "1.0", "--init_from",
                                 "", "--rgb_mlp_type", "rgb_sh"])
    ja, ta = jax_parse(argv), parse_args_with_configs(argv)
    H, W = 24, 32
    intr = np.array([[28.0, 0, 16], [0, 28.0, 12], [0, 0, 1]], np.float32)
    jm = JaxMPMeshVid(ja, H, W, np.eye(4), intr, 1.5, 6.0)
    tm = TorchMPMeshVid(ta, H, W, np.eye(4), intr, 1.5, 6.0, device=CPU)
    jp, tp = jm.init_params(1), tm.init_params(1)
    np.testing.assert_array_equal(tp["atlas_dyn"].numpy(),
                                  np.asarray(jp["atlas_dyn"]))
    assert tp["atlas_dyn"].shape[-1] == 13
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = [0.1, -0.05, 0.02]
    video = np.random.default_rng(3).random((6, H, W, 3)).astype(np.float32)
    batch = {"extrin": ext[None], "intrin": intr[None], "video": video}
    weights = {k: 0.3 for k in TS2.STAGE2_WEIGHT_KEYS}
    cfg = JS2.loss_config_from_args(ja, ref=False)
    jloss = JS2.make_patch_loss_fn(jm, ja, H, W, cfg)
    (_, jmet), jg = jax.jit(jax.value_and_grad(
        lambda q: jloss(q, {k: jnp.asarray(v) for k, v in batch.items()},
                        {k: jnp.asarray(v, jnp.float32)
                         for k, v in weights.items()}, None),
        has_aux=True))(jp)
    TO.trainable(tp)
    total, tmet = TS2.make_patch_loss_fn(tm, ta, H, W, cfg)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, weights)
    total.backward()
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    a = np.asarray(jg["atlas_dyn"])
    assert np.abs(a).max() > 0
    assert np.abs(tp["atlas_dyn"].grad.numpy() - a).max() <= \
        1e-5 * np.abs(a).max()


def test_sh_quick_start_through_the_port(tmp_path, monkeypatch):
    """README's quick start with --direct2sh_epoch 1: an rgb_sh sparse
    stage-1 checkpoint, train_3dvid adopting rgb_sh, then render_video,
    evaluate and export_mesh of the SH MTV.  The JAX package renders the
    same checkpoint (told --rgb_mlp_type rgb_sh: its restore keeps the
    arguments' decoder) within 1e-5, scores the port's renders to the
    port's table, and exports as the port does (it activates the atlas's
    first four channels)."""
    monkeypatch.delenv("VL3D_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("VL3D_DATA_CACHE", "off")
    prefix = str(tmp_path)
    synthetic.write_llff_dir(
        synthetic.make_scene(n_views=3, h=45, w=80, n_frames=6),
        os.path.join(prefix, "data", "synthetic"), 1)
    common = ["--prefix", prefix, "--gpu_num", "0", "--mesh_devices", "1",
              "--patch_h_size", "45", "--patch_w_size", "80"]
    train_3d.main(["--config", S1, *common, "--N_iters", "3",
                   "--sparsify_epoch", "2", "--direct2sh_epoch", "1"])
    ck = tck.load_checkpoint(os.path.join(
        prefix, "mpis", "debug_synthetic", "ckpt_epoch_0002.npz"))
    assert ck["meta"]["is_sparse"]
    assert ck["meta"]["extra"]["rgb_mlp_type"] == "rgb_sh"
    assert ck["params"]["atlas_dyn"].shape[-1] == 13
    s2 = ["--config", S2, *common,
          "--init_from", "mpis/debug_synthetic/ckpt_epoch_0002.npz",
          "--mpv_frm_num", "6"]
    # the full-resolution level (the third of this scene's pyramid), one
    # epoch
    model, _, rundir = train_3dvid.main(
        s2 + ["--pyr_init_level", "2", "--pyr_num_epoch", "1",
              "--i_img", "1"])
    assert model.cfg.rgb_mlp_type == "rgb_sh"
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        losses = [json.loads(l)["value"] for l in f
                  if json.loads(l)["tag"] == "stage2/loss"]
    assert losses and np.isfinite(losses).all()
    frames = render_video.main(s2 + ["--v", "0"])
    assert np.stack(frames).shape == (6, 45, 80, 3)
    table = evaluate.main(s2)
    assert np.isfinite(table["nnf"]).all()
    out = export_mesh.main(s2)

    args = parse_args_with_configs(s2)
    _, _, sc = llff.load_mv_videos(os.path.join(prefix, args.datadir),
                                   factor=1, bd_factor=(args.near_factor,
                                                        args.far_factor),
                                   recenter=True)
    ref = cameras.pose_to_extrinsic(cameras.average_pose(sc["poses"])[:, :4])
    near, far = float(sc["bds"].min()), float(sc["bds"].max())
    model, params, _, _ = load_mpv_from_run(
        args, 45, 80, ref, sc["intrins"][0], near, far, device=CPU)
    assert model.cfg.rgb_mlp_type == "rgb_sh"
    jm, jp, _, _ = jax_load_mpv(jax_parse(s2 + ["--rgb_mlp_type", "rgb_sh"]),
                                45, 80, ref, sc["intrins"][0], near, far)
    ext = cameras.pose_to_extrinsic(sc["poses"])
    preds = tmp_path / "preds"
    preds.mkdir()
    for v in range(3):
        t = render_eval(model, params, 45, 80, ext[v:v + 1],
                        sc["intrins"][v:v + 1], np.arange(6), chunk=3)
        j, _ = jm.render(jp, 45, 80, jnp.asarray(ext[v:v + 1], jnp.float32),
                         jnp.asarray(sc["intrins"][v:v + 1], jnp.float32),
                         jnp.arange(6))
        assert np.abs(t - np.asarray(j)).max() <= 1e-5 * max(
            1.0, np.abs(np.asarray(j)).max())
        np.save(preds / f"view{v:02d}.npy", to8b(t))
    jax_evaluate(jax_parse(s2), pred_dir=str(preds))
    _assert_tables_close(_table(table["path"]),
                         _table(str(preds / "eval_metrics.txt")))
    jexport.main(s2 + ["--mesh_folder", "meshes_jax"])
    # dynamic frames only where the cull kept dynamic tiles
    n_dyn = int((ck["tile_map_dyn"] >= 0).sum())
    _assert_exports_match(out, os.path.join(prefix, "meshes_jax",
                                            "debug_synthetic"),
                          6 if n_dyn else 0)
