"""The evaluation slice of the PyTorch port against the JAX package, on the
CPU: the image metrics, Q9's banded sum, NNMSE and Loop Quality (on
random-float and u8-valued clips, temporal strides 1 and 2, unequal frame
counts), LPIPS with each backbone and SVFID with seeded local weights, and
`evaluate` through both packages' CLIs, on pre-rendered loops and on a
sparse mpv checkpoint written by the JAX package.  Inputs are made with
numpy and handed to both packages.

Tolerances: numpy code copied from the JAX package is held to equality;
the NN metrics to 1e-5 relative on random floats (a near tie may break
otherwise in the two packages' GEMMs; random data has none within 1e-6)
and 1e-6 on u8-valued clips (their per-frame distances are exact
integers below 2^24 in f32 at these sizes); LPIPS and the C3D features to
1e-5 relative (f32 convolutions summed in another order); SVFID to 1e-4
(a matrix square root of those features); eval_metrics.txt to 1e-5
relative on every finite value.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.data.video import to8b
from videoloop3d_tpu.eval import evaluate as JE
from videoloop3d_tpu.eval import lpips as JL
from videoloop3d_tpu.eval import metrics as JM
from videoloop3d_tpu.eval import nnmse as JN
from videoloop3d_tpu.eval import svfid as JS
from videoloop3d_tpu.losses import patch_nn as JPN
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPV
from videoloop3d_tpu.train import stage2 as jstage2
from videoloop3d_torch.eval import lpips as TL
from videoloop3d_torch.eval import metrics as TM
from videoloop3d_torch.eval import nnmse as TN
from videoloop3d_torch.eval import svfid as TS
from videoloop3d_torch.losses import patch_nn as TPN
from videoloop3d_torch.tools import evaluate as tevaluate

CPU = torch.device("cpu")


def test_image_metrics_equal_jax():
    """PSNR / SSIM / MSE with and without a mask, the SSIM map and the
    dynamics error: the same float64 numpy code, equal values."""
    rng = np.random.default_rng(0)
    a = rng.random((3, 20, 24, 3))
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    mask = (rng.random((1, 20, 24)) < 0.6).astype(np.float32)
    np.testing.assert_array_equal(TM.ssim_map(a[0], b[0]),
                                  JM.ssim_map(a[0], b[0]))
    for metric in ("mse", "psnr", "ssim"):
        for m in (None, mask):
            assert TM.compute_img_metric(a, b, metric, m) == \
                JM.compute_img_metric(a, b, metric, m)
    assert TM.dynamics_error(a * 255, b * 255) == \
        JM.dynamics_error(a * 255, b * 255)


@pytest.mark.parametrize("pt,st,fx,fy", [(7, 1, 50, 50), (3, 2, 11, 9),
                                         (5, 1, 8, 12), (1, 1, 4, 6)])
def test_banded_temporal_dist_equals_jax(pt, st, fx, fy):
    """The banded sum adds the same f32 slices in the same order: equal."""
    d1 = np.random.default_rng(1).random((5, fx, fy)).astype(np.float32)
    ntx, nty = (fx - pt) // st + 1, (fy - pt) // st + 1
    got = TPN.banded_temporal_dist_plain(torch.from_numpy(d1), pt, st, ntx,
                                         nty)
    want = np.asarray(JPN.banded_temporal_dist(d1, pt, st, ntx, nty))
    assert got.shape == (5, ntx, nty)
    np.testing.assert_array_equal(got.numpy(), want)


def _clips(kind, seed):
    """(3, 10, 28, 32) and (3, 9, 28, 32) clips; u8-valued ones repeat a
    stretch of frames (exact ties among the target patches)."""
    rng = np.random.default_rng(seed)
    if kind == "float":
        return (rng.random((3, 10, 28, 32), dtype=np.float32),
                rng.random((3, 9, 28, 32), dtype=np.float32))
    src = rng.integers(0, 256, (3, 10, 28, 32)).astype(np.float32)
    tar = rng.integers(0, 256, (3, 9, 28, 32)).astype(np.float32)
    tar[:, 5:] = tar[:, 1:5]
    return src, tar


@pytest.mark.parametrize("scale", [(5, 2, 4, 1), (3, 2, 3, 2), (7, 3, 2, 2)],
                         ids=lambda s: "p{}s{}pt{}st{}".format(*s))
@pytest.mark.parametrize("kind", ["float", "u8"])
def test_nnerr_and_loop_quality_match_jax(kind, scale):
    """compute_nnerr, compute_nnerr_pair (both directions from one
    search) and loop_quality against JAX's, with macro blocks of 17."""
    src, tar = _clips(kind, 2)
    rtol = 1e-5 if kind == "float" else 1e-6
    want_pair = JN.compute_nnerr_pair(src, tar, *scale, macro_block=17)
    got_pair = TN.compute_nnerr_pair(src, tar, *scale, macro_block=17,
                                     device=CPU)
    np.testing.assert_allclose(got_pair, want_pair, rtol=rtol)
    assert TN.compute_nnerr(src, tar, *scale, macro_block=17,
                            device=CPU) == got_pair[0]
    np.testing.assert_allclose(
        TN.loop_quality(src, tar, *scale, macro_block=17, device=CPU),
        JN.loop_quality(src, tar, *scale, macro_block=17), rtol=rtol)
    assert TN.compute_nnerr(src, src, *scale, macro_block=17,
                            device=CPU) == 0.0


_LPIPS_NETS = {
    "alex": [(oc, 3 if i == 0 else JL._ALEX_CFG[i - 1][0], k)
             for i, (oc, k, _, _) in enumerate(JL._ALEX_CFG)],
    "vgg": [(oc, ic, 3) for oc, ic in zip(
        [c for s in JL._VGG_STAGES for c in s],
        [3] + [c for s in JL._VGG_STAGES for c in s][:-1])],
    "squeeze": [(64, 3, 3)],
}


def _lpips_weights(path, net, seed=0):
    """Seeded weights of the JAX package's .npz layout for `net`."""
    rng = np.random.default_rng(seed)

    def conv(oc, ic, k):
        return (rng.normal(0, (2.0 / (ic * k * k)) ** 0.5,
                           (oc, ic, k, k)).astype(np.float32),
                rng.normal(0, 0.01, oc).astype(np.float32))

    out = {"net": np.array(net)}
    for i, (oc, ic, k) in enumerate(_LPIPS_NETS[net]):
        out[f"conv{i}/w"], out[f"conv{i}/b"] = conv(oc, ic, k)
    if net == "squeeze":
        ic = 64
        for i, (sq, ex) in enumerate(JL._SQUEEZE_FIRES):
            for part, shape in (("squeeze", (sq, ic, 1)),
                                ("expand1x1", (ex, sq, 1)),
                                ("expand3x3", (ex, sq, 3))):
                out[f"fire{i}/{part}/w"], out[f"fire{i}/{part}/b"] = \
                    conv(*shape)
            ic = 2 * ex
    for i, c in enumerate(JL._CHNS[net]):
        out[f"lin{i}/w"] = np.abs(rng.normal(0, 0.1, (1, c, 1, 1))).astype(
            np.float32)
    np.savez(path, **out)
    return path


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_matches_jax(tmp_path, net):
    """The network on frame pairs, the min-over-frames video metric (each
    frame's features computed once) and the sliding-window metric, with
    unequal clip lengths; gated off without weights."""
    assert not TL.LPIPS(str(tmp_path / "none.npz"), device=CPU).available
    path = _lpips_weights(str(tmp_path / f"{net}.npz"), net)
    jn, tn = JL.LPIPS(path), TL.LPIPS(path, device=CPU)
    assert tn.available and tn.net == net
    rng = np.random.default_rng(3)
    a = rng.random((2, 3, 48, 64)).astype(np.float32) * 2 - 1
    b = rng.random((2, 3, 48, 64)).astype(np.float32) * 2 - 1
    np.testing.assert_allclose(tn(a, b), jn(a, b), rtol=1e-5)
    assert float(tn(a, a)[0]) == 0.0
    gt = (rng.random((5, 48, 64, 3)) * 255).astype(np.float32)
    pred = np.clip(gt[[2, 0, 4]] + rng.normal(0, 20, (3, 48, 64, 3)), 0, 255)
    np.testing.assert_allclose(TL.compute_lpips(tn, pred, gt),
                               JL.compute_lpips(jn, pred, gt), rtol=1e-5)
    for p, g in ((pred, gt), (gt, pred), (gt[:3], pred)):
        np.testing.assert_allclose(
            TL.compute_lpips_slidewindow(tn, p, g),
            JL.compute_lpips_slidewindow(jn, p, g), rtol=1e-5)


def test_svfid_matches_jax(tmp_path):
    """C3D features of a 32-frame 32x32 clip (pool5's (0, 1, 1) padding
    included) and the SVFID of two clips; gated off without weights."""
    assert not TS.C3DFeatures(str(tmp_path / "none.npz"),
                              device=CPU).available
    rng = np.random.default_rng(4)
    out, ic = {}, 3
    for i, (oc, _, _) in enumerate(TS._C3D_CFG):
        out[f"conv{i}/w"] = rng.normal(0, (2.0 / (27 * ic)) ** 0.5,
                                       (oc, ic, 3, 3, 3)).astype(np.float32)
        out[f"conv{i}/b"] = rng.normal(0, 0.01, oc).astype(np.float32)
        ic = oc
    path = str(tmp_path / "c3d.npz")
    np.savez(path, **out)
    jn, tn = JS.C3DFeatures(path), TS.C3DFeatures(path, device=CPU)
    a = (rng.random((32, 32, 32, 3)) * 255).astype(np.float32)
    b = np.clip(a[::-1] + rng.normal(0, 30, a.shape), 0, 255)
    x = np.moveaxis(a, -1, 0)[None]
    f_t, f_j = tn(x), jn(x)
    assert f_t.shape == f_j.shape == (1, 512, 2, 2, 2)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-5,
                               atol=1e-5 * np.abs(f_j).max())
    np.testing.assert_allclose(TS.svfid(tn, a, b), JS.svfid(jn, a, b),
                               rtol=1e-4)


H, W, D, F = 64, 96, 6, 8


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 2-view 64x96 synthetic scene of 8 frames, seeded alex LPIPS
    weights, and a sparse mpv checkpoint written by the JAX package
    (random tiles on a 6-plane geometry)."""
    root = tmp_path_factory.mktemp("eval")
    sc = jsyn.make_scene(n_views=2, h=H, w=W, n_frames=F, seed=0)
    jsyn.write_llff_dir(sc, str(root / "scene"), factor=1)
    _lpips_weights(str(root / "alex.npz"), "alex", seed=7)
    intrin = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]],
                      np.float32)
    args = jax_parse(["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
                      "--mpi_h_verts", "4", "--mpi_w_verts", "5",
                      "--mpi_d", str(D), "--mpv_frm_num", str(F)])
    g = JaxMPV(args, H, W, np.eye(4, dtype=np.float32), intrin, 1.5,
               6.0).geom
    r = np.random.default_rng(5).random((g.n_planes, g.n_tiles_h,
                                         g.n_tiles_w))
    tm_s = np.full(r.shape, -1, np.int32)
    tm_d = np.full(r.shape, -1, np.int32)
    tm_s[r < 0.5] = np.arange((r < 0.5).sum(), dtype=np.int32)
    tm_d[r > 0.6] = np.arange((r > 0.6).sum(), dtype=np.int32)
    th, tw = g.default_tile_texels()
    rng = np.random.default_rng(11)
    params = {
        "atlas": rng.standard_normal(((r < 0.5).sum(), th, tw, 4))
        .astype(np.float32),
        "atlas_dyn": rng.standard_normal(((r > 0.6).sum(), th, tw, F, 4))
        .astype(np.float32)}
    jck.save_checkpoint(str(root / "runs" / "mtv" / "ckpt_000001.npz"),
                        geom=g, params=params, stage="mpv", is_sparse=True,
                        has_dyn=True, tile_map_static=tm_s,
                        tile_map_dyn=tm_d, tile_hw=(th, tw), frm_num=F)
    return root


def _argv(root, extra=()):
    return ["--datadir", str(root / "scene"), "--expdir", str(root / "runs"),
            "--expname", "mtv", "--factor", "1", "--mpv_frm_num", str(F),
            "--seed", "1", "--gpu_num", "0", *extra]


def _table(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [ln.split(", ") for ln in lines[1:]]


def _assert_tables_close(got, want):
    """Equal headers and row names; every value within 1e-5 relative
    (NaN and +-inf where the other has the same)."""
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])
    for rg, rw in zip(got[1], want[1]):
        assert rg[0] == rw[0] and len(rg) == len(rw)
        g = np.array([float(v) for v in rg[1:]])
        w = np.array([float(v) for v in rw[1:]])
        np.testing.assert_allclose(g, w, rtol=1e-5, equal_nan=True)


def test_evaluate_pred_dir_matches_jax(scene, tmp_path, monkeypatch):
    """Both packages' evaluate CLIs score the same pre-rendered loops
    (the ground truth with seeded noise and a frame roll), LPIPS on."""
    monkeypatch.setenv("VL3D_LPIPS_WEIGHTS", str(scene / "alex.npz"))
    from videoloop3d_tpu.data import llff
    videos, _, _ = llff.load_mv_videos(str(scene / "scene"), factor=1,
                                       bd_factor=(1.0, 1.0), recenter=True)
    preds = tmp_path / "preds"
    preds.mkdir()
    rng = np.random.default_rng(1)
    for v in range(2):
        gt = np.roll(np.asarray(videos[v]).astype(np.int32), 2, axis=0)
        noisy = np.clip(gt + rng.integers(-6, 7, gt.shape), 0, 255)
        np.save(preds / f"view{v:02d}.npy", noisy.astype(np.uint8))
    jdir = str(tmp_path / "jax")
    shutil.copytree(preds, jdir)
    from videoloop3d_tpu.tools import evaluate as jevaluate
    jevaluate.main(_argv(scene, ["--pred_dir", jdir]))
    out = tevaluate.main(_argv(scene, ["--pred_dir", str(preds)]))
    assert out["path"] == str(preds / "eval_metrics.txt")
    got = _table(out["path"])
    _assert_tables_close(got, _table(os.path.join(jdir, "eval_metrics.txt")))
    names = got[0].split(", ")
    assert names[-2:] == ["psnr_full", "ssim_full"] and len(names) == 20
    assert all(np.isfinite(float(got[1][0][names.index(k)]))
               for k in ("nnf", "nnb", "lpips", "lpips_sw", "loop"))


def test_evaluate_checkpoint_matches_jax(scene, tmp_path, monkeypatch):
    """The port's evaluate CLI on the JAX-written checkpoint (its own
    render, K1-K4's plain versions here) against the JAX package's
    evaluate scoring those same renders (1e-5), and those renders within
    one u8 step of the JAX package's render of the checkpoint except on at
    most 0.1% of the values (f32 reassociation at quantization steps, as
    in the render slice)."""
    monkeypatch.setenv("VL3D_LPIPS_WEIGHTS", str(scene / "alex.npz"))
    out = tevaluate.main(_argv(scene))
    assert out["path"] == str(scene / "runs" / "mtv" / "eval_metrics.txt")
    got = _table(out["path"])

    from videoloop3d_tpu.core import cameras
    from videoloop3d_tpu.data import llff
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.eval.evaluate import load_mpv_from_run
    from videoloop3d_torch.train.stage2 import render_eval
    args = parse_args_with_configs(_argv(scene))
    _, _, sc = llff.load_mv_videos(str(scene / "scene"), factor=1,
                                   bd_factor=(args.near_factor,
                                              args.far_factor),
                                   recenter=True)
    ref = cameras.pose_to_extrinsic(cameras.average_pose(sc["poses"])[:, :4])
    near, far = float(sc["bds"].min()), float(sc["bds"].max())
    tm, tp, _, _ = load_mpv_from_run(args, H, W, ref, sc["intrins"][0], near,
                                     far, device=CPU)
    jm, jp, _, _ = JE.load_mpv_from_run(jax_parse(_argv(scene)), H, W, ref,
                                        sc["intrins"][0], near, far)
    ext = cameras.pose_to_extrinsic(sc["poses"])
    preds = tmp_path / "preds"
    preds.mkdir()
    for v in range(2):
        view = (ext[v:v + 1], sc["intrins"][v:v + 1], np.arange(F))
        t8 = to8b(render_eval(tm, tp, H, W, *view, chunk=2))
        j8 = to8b(jstage2.render_eval(jm, jp, H, W, *view, chunk=2))
        diff = np.abs(t8.astype(np.int16) - j8)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        np.save(preds / f"view{v:02d}.npy", t8)
    JE.evaluate(jax_parse(_argv(scene)), pred_dir=str(preds))
    _assert_tables_close(got, _table(str(preds / "eval_metrics.txt")))


def test_evaluate_skip_and_gates(scene, tmp_path, monkeypatch):
    """--skip leaves a group's columns at their defaults, and LPIPS and
    SVFID without weights are NaN (SVFID only with --with_svfid)."""
    monkeypatch.setenv("VL3D_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    monkeypatch.setenv("VL3D_C3D_WEIGHTS", str(tmp_path / "none.npz"))
    preds = tmp_path / "preds"
    preds.mkdir()
    for v in range(2):
        np.save(preds / f"view{v:02d}.npy", np.full((F, H, W, 3), 128,
                                                    np.uint8))
    out = tevaluate.main(_argv(scene, ["--pred_dir", str(preds), "--skip",
                                       "nnmse,loopq,static",
                                       "--with_svfid"]))
    assert np.isnan(out["lpips"]).all() and np.isnan(out["svfid"]).all()
    assert out["psnr"] == [0.0, 0.0] and np.isnan(out["psnr_full"]).all()
    assert out["nnf"] == [[0.0, 0.0, 0.0]] * 2
    assert out["dyn"][0] > 0
