"""The stage-2 trainer of the PyTorch port against the JAX package, on the
CPU: one `make_stage2_step` (loss, metrics, gradients and the parameters
after Adam) for the reference-view (alpha 0) and the other-view loss
config, f32 and under --fp16; the `train_3dvid` CLI over two pyramid
levels, its auto-resume, stage-2 checkpoints that cross-load with the
JAX package in both directions, --fast_nn_dist and its ref-view override,
the swd loss (one step with JAX's draws fed in, and the CLI with a
checkpoint JAX renders), gpnn_down with the ssim distance (the CLI
against JAX's), and each start-up refusal.  Inputs are made with numpy
and handed to both packages."""
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
from videoloop3d_tpu.core import cameras as jcam
from videoloop3d_tpu.data import llff as jllff
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.data.patches import VideoPatchDataset as JVideoDS
from videoloop3d_tpu.losses import patch_nn as JPN
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models.mpmesh import MPMesh as JaxMPMesh
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPMeshVid
from videoloop3d_tpu.tools import train_3dvid as jax_train_3dvid
from videoloop3d_tpu.train import stage1 as JS1
from videoloop3d_tpu.train import stage2 as JS2
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.losses import patch_nn as TPN
from videoloop3d_torch.models.mpv import MPMeshVid as TorchMPMeshVid
from videoloop3d_torch.tools import train_3dvid
from videoloop3d_torch.train import common as TC
from videoloop3d_torch.train import stage2 as TS2

CPU = torch.device("cpu")
GEOM = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2", "--mpi_h_verts",
        "5", "--mpi_w_verts", "7", "--mpi_d", "4", "--atlas_grid_h", "2"]


def _argv(root, exp, extra=()):
    """tests/test_stage2.py's tiny configuration (4 planes, 6 frames,
    24x32 patches, the 0.75 pyramid down to 16 px: two levels), with the
    shipped loss shapes cut to size (3x3x3 other view; 3x5x5 standing in
    for the 3x11x11 ref view, alpha 0 as shipped)."""
    return ["--datadir", os.path.join(root, "scene"),
            "--expdir", os.path.join(root, exp), "--expname", "s",
            "--factor", "1", *GEOM,
            "--mpv_frm_num", "6", "--mpv_isloop",
            "--patch_h_size", "24", "--patch_w_size", "32",
            "--patch_h_stride", "16", "--patch_w_stride", "24",
            "--lrate", "0.3", "--lrate_decay", "100", "--lrate_adaptive",
            "--pyr_minimal_dim", "16", "--pyr_num_epoch", "1",
            "--pyr_factor", "0.75", "--i_weights", "100",
            "--i_video", "1000", "--i_img", "1", "--i_print", "1000",
            "--scale_invariant", "--add_intrin_noise",
            "--loss_name", "gpnn_lm", "--loss_name_ref", "gpnn_lm",
            "--swd_patch_size", "3", "--swd_patcht_size", "3",
            "--swd_stride", "2", "--swd_stridet", "1",
            "--swd_alpha", "10000", "--swd_rou", "-2", "--swd_scaling", "0.1",
            "--swd_patch_size_ref", "5", "--swd_patcht_size_ref", "3",
            "--swd_stride_ref", "2", "--swd_stridet_ref", "1",
            "--swd_alpha_ref", "0", "--swd_rou_ref", "-2",
            "--swd_scaling_ref", "0.1", "--swd_loss_gain_ref", "3.5",
            "--swd_macro_block", "17", "--loss_ref_idx", "0",
            "--rgb_smooth_loss_weight", "0.2", "--a_smooth_loss_weight", "0.2",
            "--sparsity_loss_weight", "0.01", "--density_loss_weight", "0.05",
            "--d_smooth_loss_weight", "0.1",
            "--seed", "1", "--mesh_devices", "1", "--gpu_num", "0",
            "--init_from", os.path.join(root, "s1", "ckpt_epoch_0002.npz"),
            *extra]


def _scene_geometry(root):
    args = jax_parse(_argv(root, "x"))
    videos, _, scene = jllff.load_mv_videos(
        os.path.join(root, "scene"), factor=1,
        bd_factor=(args.near_factor, args.far_factor), recenter=True)
    return args, videos, scene


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A synthetic 3-view scene and a sparse stage-1 checkpoint built
    directly with the JAX package: 50% static and 30% dynamic tiles of
    random texels on the trainer's geometry.  Seeded pixel noise keeps
    the scene's temporal patches apart: its static regions would make
    exact ties among the NN candidates, which the two packages' GEMMs
    (summing in another order) break differently."""
    root = str(tmp_path_factory.mktemp("stage2"))
    scene = jsyn.make_scene(n_views=3, h=24, w=32, n_frames=6, seed=0)
    noise = np.random.default_rng(5).normal(0.0, 0.03, scene["videos"].shape)
    scene["videos"] = np.clip(scene["videos"] + noise, 0.0, 1.0)
    jsyn.write_llff_dir(scene, os.path.join(root, "scene"), factor=1)
    args, _, sc = _scene_geometry(root)
    H, W = sc["hw"]
    ref = jcam.pose_to_extrinsic(jcam.average_pose(sc["poses"])[:, :4])
    m = JaxMPMesh(args, H, W, ref, sc["intrins"].mean(0),
                  float(sc["bds"].min()), float(sc["bds"].max()))
    g = m.geom
    rng = np.random.default_rng(11)
    r = rng.random((g.n_planes, g.n_tiles_h, g.n_tiles_w))
    tm_s = np.full(r.shape, -1, np.int32)
    tm_d = np.full(r.shape, -1, np.int32)
    tm_s[r < 0.5] = np.arange((r < 0.5).sum(), dtype=np.int32)
    tm_d[r >= 0.7] = np.arange((r >= 0.7).sum(), dtype=np.int32)
    th, tw = g.default_tile_texels()
    m.is_sparse, m.has_dyn = True, True
    m.tile_map_static, m.tile_map_dyn, m.tile_hw = tm_s, tm_d, (th, tw)

    def tiles(n):
        t = rng.standard_normal((n, th, tw, 4)).astype(np.float32)
        t[..., 3] = rng.uniform(-4.0, 2.0, t.shape[:3])
        return t

    p = {"atlas": tiles(int((r < 0.5).sum())),
         "atlas_dyn": tiles(int((r >= 0.7).sum())),
         "verts": g.vertex_grid().astype(np.float32)}
    JS1.save_stage1_checkpoint(os.path.join(root, "s1", "ckpt_epoch_0002.npz"),
                               m, p, epoch=2)
    return root


def _models(root, extra):
    """Both packages' MPMeshVid from the stage-1 checkpoint, at the full
    level, and the full-level dataset."""
    argv = _argv(root, "x", extra)
    ja, ta = jax_parse(argv), torch_parse(argv)
    _, videos, sc = _scene_geometry(root)
    H, W = sc["hw"]
    ref = jcam.pose_to_extrinsic(jcam.average_pose(sc["poses"])[:, :4])
    near, far = float(sc["bds"].min()), float(sc["bds"].max())
    ck_path = os.path.join(root, "s1", "ckpt_epoch_0002.npz")
    jm = JaxMPMeshVid(ja, H, W, ref, sc["intrins"][0], near, far)
    jp = jm.init_from_stage1(jck.load_checkpoint(ck_path))
    tm = TorchMPMeshVid(ta, H, W, ref, sc["intrins"][0], near, far,
                        device=CPU)
    tp = tm.init_from_stage1(jck.load_checkpoint(ck_path))
    cfgs = [JS2.loss_config_from_args(ja, ref=v == 0) for v in range(3)]
    ds = JVideoDS((H, W), videos, (ja.patch_h_size, ja.patch_w_size),
                  (ja.patch_h_stride, ja.patch_w_stride), sc["poses"],
                  sc["intrins"], cfgs)
    return ja, ta, jm, jp, tm, tp, ds


STEP_CASES = {"ref_f32": (0, ()), "other_f32": (2, ()),
              "ref_bf16": (0, ("--fp16", "--fast_stage2_grad")),
              "other_bf16": (2, ("--fp16", "--fast_stage2_grad"))}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_stage2_step_matches_jax(setup, case, monkeypatch):
    """One make_stage2_step on one patch: loss and every metric within
    1e-5 relative of JAX's, the atlas and atlas_dyn gradients within
    1e-5 * max|g| (one bf16 ulp, 2^-7 * max|g|, under --fp16: bf16
    texels, whose gradients both packages sum in f32 and round once to
    bf16, JAX with its per-tile adjoint), and the parameters after Adam
    as described below.  Under --fp16 the NN search and target run in
    bf16 too; the JAX package's CPU route folds that bf16 target in bf16,
    its TPU route (`fold_patches_flat`) and the port in f32, so the JAX
    fold here takes f32 patches, as on the TPU."""
    fold = JPN.fold_patches_3d
    monkeypatch.setattr(JPN, "fold_patches_3d",
                        lambda p, *a: fold(p.astype(jnp.float32), *a))
    view, extra = STEP_CASES[case]
    bf16 = "--fp16" in extra
    ja, ta, jm, jp, tm, tp, ds = _models(setup, list(extra))
    item = ds[view * (len(ds) // 3)]
    ph, pw = ds.patch_size
    cfg = item["losscfg"]
    assert (cfg["alpha"] == 0) == (view == 0) and cfg["nn_bf16"] == bf16
    intrin = item["intrin"].copy()
    intrin[:2, 2] += [0.3, -0.2]
    batch = {"extrin": jcam.pose_to_extrinsic(item["pose"])[None]
             .astype(np.float32),
             "intrin": intrin[None].astype(np.float32),
             "video": ds.get_video(item)}
    weights = {k: 0.3 for k in TS2.STAGE2_WEIGHT_KEYS}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jw = {k: jnp.asarray(v, jnp.float32) for k, v in weights.items()}
    jloss = JS2.make_patch_loss_fn(jm, ja, ph, pw, cfg)
    (_, jmet), jg = jax.jit(jax.value_and_grad(
        lambda q: jloss(q, jb, jw, None), has_aux=True))(jp)
    jstep, jinit = JS2.make_stage2_step(jm, ja, ph, pw, cfg)
    lr = 0.05
    jnew, _, _ = jstep(jp, jinit(jp), jb, jnp.asarray(lr, jnp.float32), jw,
                       jax.random.PRNGKey(0))

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    step, opt_init = TS2.make_stage2_step(tm, ta, ph, pw, cfg)
    before = {k: v.clone() for k, v in tp.items()}
    opt = opt_init(tp)
    tmet = step(tp, opt, tb, lr, weights)
    assert set(tmet) == set(jmet) == {"swd", "loss", "sparsity",
                                      "rgb_smooth", "a_smooth", "density",
                                      "d_smooth"}
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    gtol = 2.0 ** -7 if bf16 else 1e-5
    eps = 6e-8
    for k in ("atlas", "atlas_dyn"):
        a = np.asarray(jg[k])
        g = tp[k].grad.numpy()
        assert np.abs(a).max() > 0
        assert np.abs(g - a).max() <= gtol * np.abs(a).max(), k
        # Adam's first step moves each texel by lr * g / (|g| + eps): the
        # port's update is that of its own gradient (optimizer parity)...
        # (to 4 ulps of the largest texel: the two optimizers round the
        # same formula in another order)
        p0 = before[k].numpy()
        ulps = 4 * np.spacing(np.abs(p0).max())
        new = tp[k].detach().numpy()
        own = p0 - lr * g / (np.abs(g) + eps)
        assert np.abs(new - own).max() <= ulps, k
        # ...and JAX's where the step is insensitive to the gradients'
        # last digits (|g| far above eps); elsewhere both stay within lr
        firm = np.minimum(np.abs(a), np.abs(g)) > 1e3 * eps
        assert firm.sum() > 100
        diff = np.abs(new - np.asarray(jnew[k]))
        assert diff[firm].max() <= 1e-5 * lr + ulps, k
        assert diff.max() <= 2 * lr, k
    np.testing.assert_array_equal(tp["verts"].detach().numpy(),
                                  np.asarray(jnew["verts"]))


def _series(rundir, tag):
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows
            if r["tag"] == f"stage2/{tag}"]


def _copy_ckpt(src, root, exp):
    d = os.path.join(root, exp, "s")
    os.makedirs(d)
    shutil.copy(src, d)


def test_train_3dvid_matches_jax_and_resumes_across_packages(setup):
    """Both CLIs from the same sparse stage-1 checkpoint over the two
    levels (one epoch each, 3 + 3 steps): the same loss series within 1e-4
    relative, and the same ckpt_l1_epoch_0000.npz layout (tile maps, tile
    size, frame count, extra metadata).  Then each package auto-resumes
    the other's checkpoint with --pyr_num_epoch 2 at level 1, epoch 1:
    both losses finite and within 1e-4 relative of each other.

    The ref view runs at alpha 1e4 (off) here: at the shipped alpha 0
    each distance is divided by its column minimum, which the expanded
    form (|x|^2 + |y|^2 - 2 x.y) computes with cancellation, so the
    nearest patch among near-equal candidates depends on the summation
    order, which differs between the packages (one flip moved a loss by
    8e-4 here).  The step test holds alpha 0 on one patch."""
    root = setup
    alpha = ["--swd_alpha_ref", "10000"]
    jax_train_3dvid.main(_argv(root, "jax", alpha))
    model, params, rundir = train_3dvid.main(_argv(root, "torch", alpha))
    assert model.is_sparse and params["atlas_dyn"].ndim == 5
    jdir = os.path.join(root, "jax", "s")
    t_loss, j_loss = _series(rundir, "loss"), _series(jdir, "loss")
    assert [s for s, _ in t_loss] == [s for s, _ in j_loss] == \
        list(range(6))
    assert np.isfinite([v for _, v in t_loss]).all()
    np.testing.assert_allclose([v for _, v in t_loss],
                               [v for _, v in j_loss], rtol=1e-4)
    assert _series(rundir, "warm_step_ms_l1")
    name = "ckpt_l1_epoch_0000.npz"
    t = jck.load_checkpoint(os.path.join(rundir, name))
    j = jck.load_checkpoint(os.path.join(jdir, name))
    assert t["meta"]["stage"] == j["meta"]["stage"] == "mpv"
    for key in ("is_sparse", "has_dyn", "tile_hw", "frm_num", "extra",
                "param_keys", "geometry"):
        assert t["meta"][key] == j["meta"][key], key
    for k in ("tile_map_static", "tile_map_dyn"):
        np.testing.assert_array_equal(t[k], j[k])
    for k in t["params"]:
        assert t["params"][k].shape == j["params"][k].shape
        assert t["params"][k].dtype == np.float32
    assert t["params"]["atlas_dyn"].shape[3] == 6

    more = alpha + ["--pyr_num_epoch", "2"]
    _copy_ckpt(os.path.join(rundir, name), root, "res_jax")
    _copy_ckpt(os.path.join(jdir, name), root, "res_torch")
    jax_train_3dvid.main(_argv(root, "res_jax", more))
    model, _, rundir2 = train_3dvid.main(_argv(root, "res_torch", more))
    r_t = _series(rundir2, "loss")
    r_j = _series(os.path.join(root, "res_jax", "s"), "loss")
    assert [s for s, _ in r_t] == [s for s, _ in r_j] == list(range(6, 9))
    assert np.isfinite([v for _, v in r_t + r_j]).all()
    np.testing.assert_allclose([v for _, v in r_t], [v for _, v in r_j],
                               rtol=1e-4)
    for d in (rundir2, os.path.join(root, "res_jax", "s")):
        meta = jck.load_checkpoint(os.path.join(
            d, "ckpt_l1_epoch_0001.npz"))["meta"]
        assert (meta["extra"]["pyr_i"], meta["extra"]["epoch_i"]) == (1, 1)


def test_train_3dvid_pyr_init_level_and_fp16(setup, capsys):
    """--pyr_init_level 1 under --fp16 --fast_stage2_grad: one level, the
    route lines printed, finite losses, and a checkpoint the JAX model
    restores and renders."""
    model, params, rundir = train_3dvid.main(_argv(
        setup, "fp16", ["--pyr_init_level", "1", "--fp16",
                        "--fast_stage2_grad"]))
    out = capsys.readouterr().out
    assert "--fast_stage2_grad set: the port's K9/K10" in out
    assert "keeps the training render's activations" in out
    loss = _series(rundir, "loss")
    assert [s for s, _ in loss] == list(range(3))
    assert np.isfinite([v for _, v in loss]).all()
    ck = jck.load_checkpoint(os.path.join(rundir, "ckpt_l1_epoch_0000.npz"))
    args, _, sc = _scene_geometry(setup)
    jm = JaxMPMeshVid(args, *sc["hw"], np.eye(4), sc["intrins"][0], 1.0,
                      6.0)
    jp = jm.restore_checkpoint(ck)
    rgb, _ = jm.render(jp, *sc["hw"], np.eye(4, dtype=np.float32)[None],
                       sc["intrins"][:1], jnp.asarray([0, 5]))
    assert np.isfinite(np.asarray(rgb)).all()


def test_train_3dvid_sigterm_checkpoints_exits_75_and_resumes(setup,
                                                              monkeypatch):
    """SIGTERM during level 0's epoch 1 stops at the next step,
    checkpoints epoch 0 of level 0 and exits 75; a rerun resumes at level
    0, epoch 1 and finishes both levels.  The --profile_steps window
    writes a torch.profiler trace."""
    ticks = []
    tick = TC.Profiler.tick

    def tick_and_term(self):
        tick(self)
        ticks.append(1)
        if len(ticks) == 4:                 # the first step of epoch 1
            # what a SIGTERM runs: the handler the trainer installed
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    monkeypatch.setattr(TC.Profiler, "tick", tick_and_term)
    argv = _argv(setup, "sigterm", ["--pyr_num_epoch", "2",
                                    "--profile_steps", "1:2"])
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        train_3dvid.main(argv)
    assert exc.value.code == 75
    rundir = os.path.join(setup, "sigterm", "s")
    assert sorted(f for f in os.listdir(rundir) if f.startswith("ckpt")) == \
        ["ckpt_l0_epoch_0000.npz"]
    meta = jck.load_checkpoint(os.path.join(rundir,
                                            "ckpt_l0_epoch_0000.npz"))["meta"]
    assert (meta["extra"]["pyr_i"], meta["extra"]["epoch_i"]) == (0, 0)
    assert signal.getsignal(signal.SIGTERM) is before
    assert os.path.isfile(os.path.join(rundir, "profile", "trace.json"))
    monkeypatch.setattr(TC.Profiler, "tick", tick)
    train_3dvid.main(argv)
    assert [s for s, _ in _series(rundir, "loss")] == list(range(13))
    assert os.path.isfile(os.path.join(rundir, "ckpt_l1_epoch_0001.npz"))


@pytest.mark.parametrize("flags", [["--fast_nn_dist"],
                                   ["--fast_nn_dist_ref", "on"]],
                         ids=["fast_nn_dist", "fast_nn_dist_ref"])
def test_train_3dvid_fast_nn_dist_matches_jax(setup, flags, monkeypatch):
    """--fast_nn_dist (both views) and --fast_nn_dist_ref on (the ref view
    only) search with K18's plain version in the port and with
    `_nn_retarget_temporal` in the JAX package: both CLIs over the two
    levels give the same loss series within 1e-4 relative, at alpha off
    for the ref view (see the test above), and the port's search runs
    once per step of a view that takes it."""
    calls = []
    band = TPN.nn_band_argmin
    monkeypatch.setattr(TPN, "nn_band_argmin",
                        lambda *a, **k: calls.append(1) or band(*a, **k))
    alpha = ["--swd_alpha_ref", "10000", *flags]
    exp = flags[0].strip("-")
    jax_train_3dvid.main(_argv(setup, f"jax_{exp}", alpha))
    _, _, rundir = train_3dvid.main(_argv(setup, f"torch_{exp}", alpha))
    t_loss = _series(rundir, "loss")
    j_loss = _series(os.path.join(setup, f"jax_{exp}", "s"), "loss")
    assert [s for s, _ in t_loss] == [s for s, _ in j_loss] == \
        list(range(6))
    np.testing.assert_allclose([v for _, v in t_loss],
                               [v for _, v in j_loss], rtol=1e-4)
    # two levels of 3 steps; the ref view (view 0) takes one of each 3
    assert len(calls) == (6 if flags == ["--fast_nn_dist"] else 2)


REFUSALS = {
    "decoder": (["--rgb_mlp_type", "rgb_sh"], None),
    "two_devices": (["--mesh_devices", "2"], "does not match the 1 process"),
    "shard_views": (["--shard_views"], None),
    "mesh_fp": (["--mesh_fp", "2"], None),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_train_3dvid_refuses_unported(setup, case):
    """Every option of the JAX package is ported.  An rgb_sh scratch
    start, --shard_views and --mesh_fp 2 in one process (item None: one
    process owns every view; a grid of one rank has no frame axis, as the
    JAX package's single-device run) pass the start-up check and train a
    step-free run of zero epochs.  --mesh_devices 2 in one process raises
    the world-size mismatch, a ValueError, before any work (no run
    directory is made)."""
    extra, item = REFUSALS[case]
    exp = f"refuse_{case}"
    if item is None:
        model, params, _ = train_3dvid.main(_argv(
            setup, exp, extra + ["--init_from", "", "--pyr_num_epoch", "0"]))
        want = "rgb_sh" if case == "decoder" else "direct"
        assert model.cfg.rgb_mlp_type == want
        assert params["atlas_dyn"].shape[-1] == (13 if want == "rgb_sh"
                                                 else 4)
        return
    with pytest.raises(ValueError, match=item):
        train_3dvid.main(_argv(setup, exp, extra))
    assert not os.path.exists(os.path.join(setup, exp))


SWD = ["--loss_name", "swd", "--loss_name_ref", "swd", "--swd_num_proj",
       "32"]


@pytest.mark.parametrize("view", [0, 2], ids=["ref", "other"])
def test_stage2_swd_step_matches_jax(setup, view):
    """One patch under the swd loss (the ref view's 3x5x5 patches at
    stride 2 and gain 3.5, the other view's 3x3x3): JAX's loss function on
    a key, the port's with the projections and permutation JAX draws from
    that key fed in batch["draws"]["swd"]; the loss and every metric
    within 1e-5 relative, the atlas and atlas_dyn gradients within 1e-5 *
    max|g|."""
    from videoloop3d_torch.losses import swd as TSW
    ja, ta, jm, jp, tm, tp, ds = _models(setup, SWD)
    item = ds[view * (len(ds) // 3)]
    ph, pw = ds.patch_size
    cfg = item["losscfg"]
    assert cfg["loss_name"] == "swd" and cfg["num_proj"] == 32
    batch = {"extrin": jcam.pose_to_extrinsic(item["pose"])[None]
             .astype(np.float32),
             "intrin": item["intrin"][None].astype(np.float32),
             "video": ds.get_video(item)}
    weights = {k: 0.3 for k in TS2.STAGE2_WEIGHT_KEYS}
    key = jax.random.PRNGKey(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jw = {k: jnp.asarray(v, jnp.float32) for k, v in weights.items()}
    jloss = JS2.make_patch_loss_fn(jm, ja, ph, pw, cfg)
    (_, jmet), jg = jax.value_and_grad(
        lambda q: jloss(q, jb, jw, key), has_aux=True)(jp)
    pt, p = cfg["patcht_size"], cfg["patch_size"]
    F = batch["video"].shape[0]
    n_short = TSW.swd_n_short(F, F - pt + 1)      # the loop pad: x is longer
    assert n_short > 0
    draws = {"rand": torch.from_numpy(np.array(
        jax.random.normal(key, (32, 3, pt, p, p)))),
        "perm": torch.from_numpy(np.array(
            jax.random.permutation(key, n_short)))}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["draws"] = {"swd": draws}
    for t in tp.values():
        t.requires_grad_(True)
    total, tmet = TS2.make_patch_loss_fn(tm, ta, ph, pw, cfg)(tp, tb,
                                                               weights)
    total.backward()
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("atlas", "atlas_dyn"):
        a = np.asarray(jg[k])
        assert np.abs(a).max() > 0
        assert np.abs(tp[k].grad.numpy() - a).max() <= 1e-5 * np.abs(a).max()


def test_train_3dvid_swd_and_its_checkpoint_in_jax(setup, capsys):
    """train_3dvid with the swd loss on both views (its draws from the
    trainer's generator): the two levels' 6 steps with finite losses, the
    swd metric logged, and a checkpoint the JAX model restores and
    renders."""
    model, params, rundir = train_3dvid.main(_argv(setup, "swd", SWD))
    loss = _series(rundir, "loss")
    assert [s for s, _ in loss] == list(range(6))
    assert np.isfinite([v for _, v in loss]).all()
    assert np.isfinite([v for _, v in _series(rundir, "swd")]).all()
    assert "swd=" in capsys.readouterr().out
    ck = jck.load_checkpoint(os.path.join(rundir, "ckpt_l1_epoch_0000.npz"))
    args, _, sc = _scene_geometry(setup)
    jm = JaxMPMeshVid(args, *sc["hw"], np.eye(4), sc["intrins"][0], 1.0,
                      6.0)
    jp = jm.restore_checkpoint(ck)
    rgb, _ = jm.render(jp, *sc["hw"], np.eye(4, dtype=np.float32)[None],
                       sc["intrins"][:1], jnp.asarray([0, 3]))
    assert np.isfinite(np.asarray(rgb)).all()


def test_train_3dvid_gpnn_down_ssim_matches_jax(setup, monkeypatch):
    """--loss_name_ref gpnn_down --swd_factor_ref 2 (the search on the
    half-resolution patch, the parent fold) with --swd_dist_fn ssim on the
    other views: both CLIs over the two levels give the same loss series
    within 1e-4 relative, at alpha off for the ref view (see above); the
    port searches under ssim on the other views' steps and folds by
    parents on the ref view's."""
    calls = []
    search, fold = TPN.nn_argmin, TPN.nn_fold
    monkeypatch.setattr(TPN, "nn_argmin", lambda *a, **k: calls.append(
        ("ssim", a[4] if len(a) > 4 else "mse")) or search(*a, **k))
    monkeypatch.setattr(TPN, "nn_fold", lambda *a, **k: calls.append(
        ("parent", k.get("parent", 1))) or fold(*a, **k))
    extra = ["--swd_alpha_ref", "10000", "--loss_name_ref", "gpnn_down",
             "--swd_factor_ref", "2", "--swd_dist_fn", "ssim"]
    jax_train_3dvid.main(_argv(setup, "jax_down", extra))
    _, _, rundir = train_3dvid.main(_argv(setup, "torch_down", extra))
    t_loss = _series(rundir, "loss")
    j_loss = _series(os.path.join(setup, "jax_down", "s"), "loss")
    assert [s for s, _ in t_loss] == [s for s, _ in j_loss] == \
        list(range(6))
    np.testing.assert_allclose([v for _, v in t_loss],
                               [v for _, v in j_loss], rtol=1e-4)
    # two levels of 3 steps; the ref view (view 0) takes one of each 3
    assert calls.count(("ssim", "ssim")) == 4
    assert calls.count(("ssim", "mse")) == 2
    assert calls.count(("parent", 2)) == 2


@pytest.mark.parametrize("extra", [["--loss_name", "swdx"],
                                   ["--swd_dist_fn_ref", "l1"]],
                         ids=["loss_name", "dist_fn"])
def test_train_3dvid_rejects_unknown_loss_and_distance(setup, extra):
    """A looping loss or patch distance that neither package has raises
    ValueError naming it, before any work."""
    exp = f"unknown_{extra[0].strip('-')}"
    with pytest.raises(ValueError, match=extra[1]):
        train_3dvid.main(_argv(setup, exp, extra))
    assert not os.path.exists(os.path.join(setup, exp))
