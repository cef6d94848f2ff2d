"""Parts of the PyTorch port's stage-2 trainer against the JAX package, on
the CPU: the tile resize of `lod` against `jax.image.resize`,
`VideoPatchDataset`, `loss_config_from_args`, `pyramid_schedule`, the
sparse model's `lod`, and the dynamic-atlas gradient K10 (plain version
and the `sample_tiles` autograd route) and K9 on bf16 tiles against
JAX's `make_tile_adjoint` gradients.  Inputs are made with numpy and
handed to both packages."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_stage1_sparse import _tile_setup
from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.data import patches as JP
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPMeshVid
from videoloop3d_tpu.render import adjoint as ADJ
from videoloop3d_tpu.render import sample as JS
from videoloop3d_tpu.train import stage2 as JS2
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.core.resize import resize_tiles
from videoloop3d_torch.data import patches as TP
from videoloop3d_torch.models.mpv import MPMeshVid as TorchMPMeshVid
from videoloop3d_torch.render import sample as TS
from videoloop3d_torch.train import stage2 as TS2

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sizes", [(12, 9), (9, 12), (17, 12), (12, 2),
                                   ((12, 17), (9, 12))])
@pytest.mark.parametrize("ndim", [4, 5])
def test_resize_tiles_matches_jax_image_resize(sizes, ndim):
    """The antialiased linear resize within 1e-6 of jax.image.resize,
    downsampling and upsampling, 4-D static and 5-D dynamic tiles, in f32
    and, rounded back to the input dtype, bf16 (within one bf16 ulp: the
    f32 sums may straddle a rounding boundary)."""
    a, b = sizes
    (ah, aw), (bh, bw) = (a, a) if np.isscalar(a) else a, \
        (b, b) if np.isscalar(b) else b
    shape = (5, ah, aw, 4) if ndim == 4 else (3, ah, aw, 6, 4)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    out = (shape[0], bh, bw) + shape[3:]
    j = np.asarray(jax.image.resize(jnp.asarray(x), out, "linear"))
    t = resize_tiles(torch.from_numpy(x), (bh, bw))
    assert t.shape == out and t.dtype == torch.float32
    assert np.abs(t.numpy() - j).max() <= 1e-6
    xb = jnp.asarray(x, jnp.bfloat16)
    jb = jax.image.resize(xb.astype(jnp.float32), out, "linear").astype(
        jnp.bfloat16)
    tb = resize_tiles(torch.from_numpy(np.asarray(xb.astype(jnp.float32)))
                      .to(torch.bfloat16), (bh, bw))
    assert tb.dtype == torch.bfloat16
    jb = np.asarray(jb.astype(jnp.float32))
    assert (np.abs(tb.float().numpy() - jb) <= 2.0 ** -7 * np.abs(jb)).all()


def test_video_patch_dataset_matches_jax():
    """Patch grid, padding, per-item geometry and loss config, and the
    host crops equal JAX's, at a level below the video size (resized) and
    at one smaller than a patch (one whole-image patch)."""
    rng = np.random.default_rng(1)
    videos = [rng.integers(0, 256, (5, 30, 44, 3), dtype=np.uint8)
              for _ in range(3)]
    poses = rng.standard_normal((3, 3, 4)).astype(np.float32)
    intrins = np.repeat(np.array([[[40.0, 0, 22], [0, 40.0, 15], [0, 0, 1]]],
                                 np.float32), 3, axis=0)
    cfgs = [{"loss_name": "gpnn_lm", "v": i} for i in range(3)]
    for hw in ((24, 33), (12, 16)):
        args = (hw, videos, (16, 20), (8, 10), poses, intrins, cfgs)
        j, t = JP.VideoPatchDataset(*args), TP.VideoPatchDataset(*args)
        assert len(t) == len(j)
        assert (t.patch_size, t.pad) == (tuple(j.patch_size), tuple(j.pad))
        for i in range(len(j)):
            a, b = t[i], j[i]
            assert a["wh_start"] == tuple(b["wh_start"])
            assert (a["view"], a["losscfg"]) == (b["view"], b["losscfg"])
            np.testing.assert_array_equal(a["pose"], b["pose"])
            np.testing.assert_allclose(a["intrin"], b["intrin"], rtol=1e-6)
            np.testing.assert_array_equal(t.get_video(a), j.get_video(b))
        for vt, vj in zip(t.videos, j.videos):
            np.testing.assert_array_equal(vt, vj)
    with pytest.raises(ValueError, match="loss configs"):
        TP.VideoPatchDataset((24, 33), videos, (16, 20), (8, 10), poses,
                             intrins, cfgs[:2])


CONFIG_CASES = {
    "shipped": [],
    "fp16": ["--fp16"],
    "fp16_nn_f32": ["--fp16", "--nn_bf16", "off"],
    "nn_bf16": ["--nn_bf16", "on"],
    "fast_nn_ref": ["--fast_nn_dist_ref", "on"],
    "fast_nn_other_off": ["--fast_nn_dist", "--fast_nn_dist_other", "off"],
}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_loss_config_matches_jax(case):
    argv = ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
            *CONFIG_CASES[case]]
    ja, ta = jax_parse(argv), torch_parse(argv)
    for ref in (False, True):
        assert TS2.loss_config_from_args(ta, ref) == \
            JS2.loss_config_from_args(ja, ref)


@pytest.mark.parametrize("argv", [
    [], ["--pyr_minimal_dim", "16", "--pyr_factor", "0.5"],
    ["--pyr_minimal_dim", "-1", "--pyr_stage", "2,5", "--N_iters", "9"],
    ["--pyr_minimal_dim", "-1", "--N_iters", "4"]])
@pytest.mark.parametrize("hw", [(360, 640), (24, 32), (270, 480)])
def test_pyramid_schedule_matches_jax(argv, hw):
    base = ["--config", os.path.join(REPO, "configs", "mpv_base.txt")]
    ja, ta = jax_parse(base + argv), torch_parse(base + argv)
    t, j = TS2.pyramid_schedule(ta, *hw), JS2.pyramid_schedule(ja, *hw)
    assert [(f, tuple(s), n) for f, s, n in t] == \
        [(f, tuple(s), n) for f, s, n in j]


def test_lod_matches_jax():
    """`lod` down the pyramid and back up from the stored base: the same
    tile size and the resized static and dynamic tiles within 1e-6 of the
    JAX model's; an unchanged size returns the params as they are."""
    argv = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2", "--mpi_h_verts",
            "5", "--mpi_w_verts", "7", "--mpi_d", "4", "--mpv_frm_num", "3"]
    intrin = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    jm = JaxMPMeshVid(jax_parse(argv), 24, 32, np.eye(4), intrin, 1.5, 6.0)
    tm = TorchMPMeshVid(torch_parse(argv), 24, 32, np.eye(4), intrin, 1.5,
                        6.0, device=CPU)
    rng = np.random.default_rng(2)
    g = jm.geom
    tm_s = np.where(rng.random((4, g.n_tiles_h, g.n_tiles_w)) < 0.5, 0, -1)
    tm_d = np.where(tm_s < 0, 0, -1)
    tm_s[tm_s >= 0] = np.arange((tm_s >= 0).sum())
    tm_d[tm_d >= 0] = np.arange((tm_d >= 0).sum())
    p = {"atlas": rng.standard_normal(((tm_s >= 0).sum(), 13, 17, 4)),
         "atlas_dyn": rng.standard_normal(((tm_d >= 0).sum(), 13, 17, 3,
                                           4))}
    ckpt = {"meta": {"is_sparse": True, "tile_hw": [13, 17], "frm_num": 3,
                     "extra": {}},
            "geom": g, "params": {k: v.astype(np.float32)
                                  for k, v in p.items()},
            "tile_map_static": tm_s.astype(np.int32),
            "tile_map_dyn": tm_d.astype(np.int32)}
    jp, tp = jm.restore_checkpoint(ckpt), tm.restore_checkpoint(ckpt)
    for factor in (0.5625, 0.75, 1.0, 1.0):
        same = tm.tile_hw == (max(int(13 * factor), 2),
                              max(int(17 * factor), 2))
        jp, tp_new = jm.lod(jp, factor), tm.lod(tp, factor)
        assert (tp_new is tp) == same
        tp = tp_new
        assert tm.tile_hw == tuple(jm.tile_hw)
        for k in ("atlas", "atlas_dyn"):
            assert tp[k].shape == jp[k].shape
            assert np.abs(tp[k].numpy() - np.asarray(jp[k])).max() <= 1e-6


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["partial", "oblique", "edges", "empty"])
@pytest.mark.parametrize("ndim", [5, 4], ids=["K10_dynamic", "K9_static"])
def test_tile_grads_match_jax_adjoint(ndim, case, bf16):
    """The atlas gradient of `sample_tiles` (K10's plain version for 5-D
    tile-major tiles, K9's for 4-D) and `bilinear_tiles_tilemajor_grad_
    plain` against JAX's make_tile_adjoint gradient and jax.grad of
    bilinear_tiles_tilemajor, in f32 within 1e-5 * max|g|.  For bf16
    tiles both packages sum in f32 and round once to bf16: the gradient
    is bf16 and within one bf16 ulp (2^-7 * max|g|) of JAX's."""
    geom, tile_map, k, u, v, M, tiles, ct, hw = _tile_setup(case, seed=3)
    if ndim == 5:
        rng = np.random.default_rng(4)
        tiles = rng.standard_normal(tiles.shape[:3] + (5, 4)).astype(
            np.float32)
        ct = rng.standard_normal(k.shape + (5, 4)).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jt = jnp.asarray(tiles, jdt)
    jk, ju, jv, jct = (jnp.asarray(a) for a in (k, u, v, ct))
    samp = ADJ.make_tile_adjoint(ADJ.tile_positions(tile_map),
                                 geom.tile_span,
                                 ADJ.tile_window_for(geom, hw))
    jg_adj = np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(samp(t, jk, ju, jv, M)[0] * jct)))(jt)
        .astype(jnp.float32))
    jfwd = JS.bilinear_tiles_tilemajor if ndim == 5 else JS.bilinear_tiles
    jvals = np.asarray(jfwd(jt, jk, ju, jv)[0])

    tdt = torch.bfloat16 if bf16 else torch.float32
    tt = torch.from_numpy(np.asarray(jt.astype(jnp.float32))).to(tdt)
    tt.requires_grad_(True)
    tk, tu, tv, tct = (torch.from_numpy(a) for a in (k, u, v, ct))
    vals, valid = TS.sample_tiles(tt, tk, tu, tv)
    assert torch.equal(valid, tk >= 0)
    assert np.abs(vals.detach().numpy() - jvals).max() <= 1e-6
    (vals * tct).sum().backward()
    assert tt.grad.dtype == tdt and tt.grad.shape == tiles.shape
    scale = np.abs(jg_adj).max(initial=0.0)
    tol = (2.0 ** -7 if bf16 else 1e-5) * scale
    assert np.abs(tt.grad.float().numpy() - jg_adj).max(initial=0.0) <= tol
    plain = (TS.bilinear_tiles_tilemajor_grad_plain if ndim == 5
             else TS.bilinear_tiles_grad_plain)(tct, tk, tu, tv, tiles.shape)
    assert plain.dtype == torch.float32
    if bf16:
        np.testing.assert_array_equal(tt.grad.float().numpy(),
                                      plain.to(torch.bfloat16).float()
                                      .numpy())
    else:
        jg_auto = np.asarray(jax.grad(
            lambda t: jnp.sum(jfwd(t, jk, ju, jv)[0] * jct))(jt))
        for g in (plain.numpy(), tt.grad.numpy()):
            assert np.abs(g - jg_auto).max(initial=0.0) <= tol
            assert np.abs(g - jg_adj).max(initial=0.0) <= tol
    if case == "empty":
        assert tt.grad.numel() == 0
