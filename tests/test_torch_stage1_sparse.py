"""Tile culling and the stage-1 sparse phase of the PyTorch port against
the JAX package, on the CPU: `tile_cull` and `apply_tile_cull`, the
packed-tile sampler K2 with its gradient K9 (plain versions) against
``jax.grad`` of JAX's `bilinear_tiles` and JAX's per-tile adjoint, the
port's lookup against JAX's blocked training lookup, the sparse MPMesh
render and loss, and the `train_3d` CLI through the cull and across
checkpoints of both packages.  Inputs are made with numpy and handed to
both packages."""
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.core import cameras as jcam
from videoloop3d_tpu.core.activations import ACTIVATIONS
from videoloop3d_tpu.data import llff as jllff
from videoloop3d_tpu.data import patches as JP
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models import sparsify as JSP
from videoloop3d_tpu.models.geometry import MPIGeometry as JGeom
from videoloop3d_tpu.models.mpmesh import MPMesh as JaxMPMesh
from videoloop3d_tpu.render import adjoint as ADJ
from videoloop3d_tpu.render import renderer as JR
from videoloop3d_tpu.render import sample as JS
from videoloop3d_tpu.tools import train_3d as jax_train_3d
from videoloop3d_tpu.train import common as JC
from videoloop3d_tpu.train import stage1 as JS1
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.models import checkpoint as tck
from videoloop3d_torch.models import sparsify as TSP
from videoloop3d_torch.models.mpmesh import MPMesh as TorchMPMesh
from videoloop3d_torch.render import renderer as TR
from videoloop3d_torch.render import sample as TS
from videoloop3d_torch.tools import train_3d
from videoloop3d_torch.train import stage1 as TS1

CPU = torch.device("cpu")
INIT = -3.0                      # ALPHA_INIT_VAL of both packages


def _argv(root, exp, n_iters, extra=()):
    """The trainer's tiny shipped-route configuration (5x7 vertices, 4
    planes, 24x32 patches, --fast_stage1_grad)."""
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
            "--sparsify_alpha_thresh", "0.05", "--gpu_num", "0", *extra]


def _series(rundir, tag):
    import json
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows
            if r["tag"] == f"stage1/{tag}"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A synthetic scene and JAX's 1-epoch dense run on it."""
    root = str(tmp_path_factory.mktemp("sparse"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VL3D_DATA_CACHE", "off")
        scene = jsyn.make_scene(n_views=3, h=24, w=32, n_frames=6, seed=0)
        jsyn.write_llff_dir(scene, os.path.join(root, "scene"), factor=1)
        jax_train_3d.main(_argv(root, "jax_dense", 1))
        yield root


def _structured(geom, seed, mask=True):
    """Dense params whose tiles are partly culled and partly dynamic: a
    random alpha level and loop level per tile plus texel noise, with 10%
    of the texels left at the exact init value (never touched)."""
    rng = np.random.default_rng(seed)
    D, Ht, Wt = geom.n_planes, geom.mpi_h, geom.mpi_w
    sy, sx = geom.tile_span
    ti = np.minimum((np.arange(Ht) / sy).astype(int), geom.n_tiles_h - 1)
    tj = np.minimum((np.arange(Wt) / sx).astype(int), geom.n_tiles_w - 1)

    def field(lo, hi):
        lvl = rng.uniform(lo, hi, (D, geom.n_tiles_h, geom.n_tiles_w))
        f = lvl[:, ti][:, :, tj] + rng.normal(0, 0.3, (D, Ht, Wt))
        f[rng.random(f.shape) < 0.1] = INIT
        return f.astype(np.float32)

    atlas = rng.random((D, Ht, Wt, 4), dtype=np.float32)
    atlas[..., 3] = field(-9.0, 0.0)
    p = {"atlas": atlas, "verts": rng.standard_normal(
        (D * (geom.n_tiles_h + 1) * (geom.n_tiles_w + 1), 3)).astype(
            np.float32)}
    if mask:
        p["atlas_mask"] = field(-4.0, 4.0)[..., None]
    return p


def _tiny_geoms():
    argv = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
            "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "4",
            "--learn_loop_mask"]
    intrin = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    jm = JaxMPMesh(jax_parse(argv), 24, 32, np.eye(4), intrin, 1.5, 6.0)
    tm = TorchMPMesh(torch_parse(argv), 24, 32, np.eye(4), intrin, 1.5, 6.0,
                     device=CPU)
    return jm, tm


CULL_CASES = {
    "random_mask_rm0": ("random", True, 0),
    "random_nomask_rm2": ("random", False, 2),
    "trained_rm0": ("trained", True, 0),
    "trained_rm2": ("trained", True, 2),
}


@pytest.mark.parametrize("case", list(CULL_CASES))
def test_tile_cull_matches_jax(trained, case):
    """Identical tile maps, keep and dynamic fractions and tile size; the
    packed tiles within 1e-6 (the same float64 resample)."""
    src, mask, rm = CULL_CASES[case]
    if src == "random":
        jm, tm = _tiny_geoms()
        jgeom, tgeom = jm.geom, tm.geom
        params = _structured(jgeom, 3, mask)
    else:
        path = os.path.join(trained, "jax_dense", "s", "ckpt_epoch_0000.npz")
        jgeom = jck.load_checkpoint(path)["geom"]
        loaded = tck.load_checkpoint(path)
        tgeom, params = loaded["geom"], loaded["params"]
        assert (params["atlas"][..., 3] == INIT).any()
    kw = dict(erode_num=2, alpha_thresh=0.05, rm_first_layers=rm)
    j = JSP.tile_cull(params, jgeom, ACTIVATIONS["sigmoid"], **kw)
    t = TSP.tile_cull({k: torch.from_numpy(v) for k, v in params.items()},
                      tgeom, torch.sigmoid, **kw)
    for k in ("tile_map_static", "tile_map_dyn"):
        assert t[k].dtype == np.int32
        np.testing.assert_array_equal(t[k], j[k])
    assert (t["keep_frac"], t["dyn_frac"], t["tile_hw"]) == \
        (j["keep_frac"], j["dyn_frac"], tuple(j["tile_hw"]))
    for k in ("static_tiles", "dyn_tiles"):
        assert t[k].shape == j[k].shape
        assert np.abs(t[k] - j[k]).max(initial=0.0) <= 1e-6
    if rm:
        assert (t["tile_map_static"][-rm:] < 0).all()
    if src == "random":
        assert 0.1 < t["keep_frac"] < 0.9
        assert (t["dyn_frac"] > 0.1) == mask


def test_apply_tile_cull_matches_jax():
    """The port's MPMesh enters the sparse phase with the JAX model's
    state (int32 tensor maps on its device, tile size) and the same
    params: the packed tiles, the verts, and no loop mask."""
    jm, tm = _tiny_geoms()
    p = _structured(jm.geom, 4)
    jp, jinfo = JSP.apply_tile_cull(jm, {k: jnp.asarray(v)
                                         for k, v in p.items()},
                                    ACTIVATIONS["sigmoid"], alpha_thresh=0.05)
    tp, tinfo = TSP.apply_tile_cull(tm, tck.params_from_numpy(p, CPU),
                                    torch.sigmoid, alpha_thresh=0.05)
    assert set(tp) == set(jp) == {"atlas", "atlas_dyn", "verts"}
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6)
    assert tm.is_sparse and tm.has_dyn and tm.tile_hw == tuple(jm.tile_hw)
    for a, b in ((tm.tile_map_static, jm.tile_map_static),
                 (tm.tile_map_dyn, jm.tile_map_dyn)):
        assert a.dtype == torch.int32 and a.device == CPU
        np.testing.assert_array_equal(a.numpy(), b)
    assert tinfo["keep_frac"] == jinfo["keep_frac"]


def _tile_setup(case, seed=0, h=20, w=26):
    """A 3-plane geometry with 2x3 tiles (tests/test_adjoint.py), a view,
    a partly culled tile map and the lookup of every sample."""
    rng = np.random.default_rng(seed)
    intrin = np.array([[25.0, 0, w / 2], [0, 25.0, h / 2], [0, 0, 1]],
                      np.float32)
    km = intrin.copy()
    km[0, 0] *= 1.6
    km[1, 1] *= 1.6
    km[0, 2], km[1, 2] = 20, 16
    geom = JGeom(
        n_planes=3, mpi_h=int(h * 1.6) + 10, mpi_w=int(w * 1.6) + 12,
        n_tiles_h=2, n_tiles_w=3, near=1.5, far=6.0, depths=(5.0, 3.0, 2.0),
        ref_intrin_mpi=tuple(tuple(float(v) for v in r) for r in km),
        ref_extrin=tuple(tuple(float(v) for v in r) for r in np.eye(4)))
    angle = 0.25 if case == "oblique" else 0.06
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                   [-np.sin(angle), 0, np.cos(angle)]]
    ext[:3, 3] = [0.15, -0.08, 0.05]
    ext, intrin = jnp.asarray(ext)[None], jnp.asarray(intrin)[None]
    tile_map = np.full((3, 2, 3), -1, np.int32)
    if case != "empty":
        keep = rng.random(tile_map.shape) < 0.7
        tile_map[keep] = np.arange(keep.sum(), dtype=np.int32)
    th, tw = geom.default_tile_texels()
    coords = JR.warp_coordinates(geom, ext, intrin, h, w)
    k, fu, fv = JR.tile_lookup(geom, jnp.asarray(tile_map), coords)
    k = np.array(k[0])
    u = np.array(fu[0] * (tw - 1))
    v = np.array(fv[0] * (th - 1))
    if case == "edges":                 # clamped at all four tile edges
        for i, (uu, vv) in enumerate(((-2.5, None), (tw + 1.5, None),
                                      (None, -0.7), (None, th + 0.4),
                                      (tw - 1.0, th - 1.0))):
            sel = np.zeros(k.shape, bool)
            sel.reshape(-1)[i::6] = True
            if uu is not None:
                u[sel] = uu
            if vv is not None:
                v[sel] = vv
    M = ADJ.forward_projection(geom.depths_np(), geom.ref_intrin_mpi_np(),
                               ext, intrin)[0]
    n = int((tile_map >= 0).sum())
    tiles = rng.standard_normal((n, th, tw, 4)).astype(np.float32)
    ct = rng.standard_normal(k.shape + (4,)).astype(np.float32)
    return geom, tile_map, k, u, v, M, tiles, ct, (h, w)


@pytest.mark.parametrize("case", ["partial", "oblique", "edges", "empty"])
def test_tile_sampler_and_grad_match_jax(case):
    """K2's values within 1e-6 of JAX's bilinear_tiles; the atlas gradient
    of `sample_tiles` (K9's plain version under autograd) and
    `bilinear_tiles_grad_plain` within 1e-5 * max|g| of jax.grad of
    bilinear_tiles and of make_tile_adjoint's backward (partial culling,
    an oblique view, samples clamped at tile edges, k = -1, N = 0)."""
    geom, tile_map, k, u, v, M, tiles, ct, hw = _tile_setup(case)
    assert (k < 0).any() and ((k >= 0).any() or case == "empty")
    jk, ju, jv, jct = (jnp.asarray(a) for a in (k, u, v, ct))

    def j_auto(t):
        return jnp.sum(JS.bilinear_tiles(t, jk, ju, jv)[0] * jct)

    samp = ADJ.make_tile_adjoint(ADJ.tile_positions(tile_map),
                                 geom.tile_span,
                                 ADJ.tile_window_for(geom, hw))

    def j_adj(t):
        return jnp.sum(samp(t, jk, ju, jv, M)[0] * jct)

    jvals = np.asarray(JS.bilinear_tiles(jnp.asarray(tiles), jk, ju, jv)[0])
    jgrads = [np.asarray(jax.jit(jax.grad(f))(jnp.asarray(tiles)))
              for f in (j_auto, j_adj)]

    tt = torch.tensor(tiles, requires_grad=True)
    tk, tu, tv, tct = (torch.from_numpy(a) for a in (k, u, v, ct))
    vals, valid = TS.sample_tiles(tt, tk, tu, tv)
    (vals * tct).sum().backward()
    plain = TS.bilinear_tiles_grad_plain(tct, tk, tu, tv, tiles.shape)
    assert torch.equal(valid, tk >= 0)
    assert np.abs(vals.detach().numpy() - jvals).max() <= 1e-6
    for g in (tt.grad.numpy(), plain.numpy()):
        assert g.shape == tiles.shape and g.dtype == np.float32
        for jg in jgrads:
            scale = np.abs(jg).max(initial=0.0)
            assert np.abs(g - jg).max(initial=0.0) <= 1e-5 * scale
    if case == "empty":
        assert tt.grad.numel() == 0
    # samples with k < 0 may carry non-finite coordinates: they read and
    # add nothing
    bad = k < 0
    u2, v2 = u.copy(), v.copy()
    u2[bad], v2[bad] = np.nan, np.inf
    g2 = TS.bilinear_tiles_grad(tct, tk, torch.from_numpy(u2),
                                torch.from_numpy(v2), tiles.shape)
    assert torch.equal(g2, plain)


class _PlainTileSample(torch.autograd.Function):
    """bilinear_tiles_plain with bilinear_tiles_grad_plain as its
    backward, for gradcheck."""

    @staticmethod
    def forward(ctx, tiles, k, u, v):
        ctx.save_for_backward(k, u, v)
        ctx.shape = tiles.shape
        return TS.bilinear_tiles_plain(tiles, k, u, v)[0]

    @staticmethod
    def backward(ctx, g):
        k, u, v = ctx.saved_tensors
        return (TS.bilinear_tiles_grad_plain(g, k, u, v, ctx.shape),
                None, None, None)


def test_tile_grad_plain_gradcheck():
    """float64 gradcheck of K9's plain version against finite differences
    of K2's plain version (clamped samples and k = -1 included)."""
    rng = np.random.default_rng(7)
    shape = (3, 4, 5)
    k = torch.from_numpy(rng.integers(-1, 4, shape).astype(np.int32))
    u = torch.from_numpy(rng.uniform(-1.0, 5.5, shape))
    v = torch.from_numpy(rng.uniform(-1.0, 4.5, shape))
    tiles = torch.from_numpy(rng.standard_normal((4, 4, 5, 2))
                             ).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: _PlainTileSample.apply(t, k, u, v), (tiles,))


def _trainer_geometry(root):
    """The JAX trainer's scene, dataset and model geometry."""
    argv = _argv(root, "x", 1)
    args = jax_parse(argv)
    videos, _, scene = jllff.load_mv_videos(
        os.path.join(root, "scene"), factor=1,
        bd_factor=(args.near_factor, args.far_factor), recenter=True)
    H, W = scene["hw"]
    ds = JP.ImagePatchDataset(
        (H, W), videos, (args.patch_h_size, args.patch_w_size),
        (args.patch_h_stride, args.patch_w_stride), scene["poses"],
        scene["intrins"], args.vid2img_mode)
    ref = jcam.pose_to_extrinsic(jcam.average_pose(scene["poses"])[:, :4])
    bds = scene["bds"]
    jm = JaxMPMesh(args, H, W, ref, scene["intrins"].mean(0),
                   float(bds.min()), float(bds.max()))
    tm = TorchMPMesh(torch_parse(argv), H, W, ref, scene["intrins"].mean(0),
                     float(bds.min()), float(bds.max()), device=CPU)
    return ds, jm, tm


def test_lookup_matches_blocked_jax(trained):
    """The port's lookup against JAX's blocked training lookup with spans
    from lookup_span_bound over the trainer's views and patch origins:
    on the same coordinates, k equal and fu, fv within 1e-6; through K1's
    plain version from the homographies, k equal off tile edges (one ulp
    of the warp flips a tile there) and fu, fv within 1e-4 relative."""
    ds, jm, tm = _trainer_geometry(trained)
    g = jm.geom
    p = _structured(g, 5)
    info = JSP.tile_cull(p, g, ACTIVATIONS["sigmoid"], alpha_thresh=0.05)
    tm_s, tm_d = info["tile_map_static"], info["tile_map_dyn"]
    ref_inv = np.linalg.inv(g.ref_extrin_np())
    exts = np.stack([jcam.pose_to_extrinsic(p_) @ ref_inv
                     for p_ in ds.poses]).astype(np.float32)
    ph, pw = ds.patch_size
    spans = JR.lookup_span_bound(g, exts, ds.intrins, ph, pw, ds.origins)
    assert spans[0] * spans[1] < g.n_tiles_h * g.n_tiles_w
    rng = np.random.default_rng(0)
    sy, sx = g.tile_span
    for i in range(0, len(ds), 4):
        it = ds[i]
        ext = (jcam.pose_to_extrinsic(it["pose"]) @ ref_inv)[None].astype(
            np.float32)
        intr = JC.jitter_intrinsic(it["intrin"], rng)[None].astype(
            np.float32)
        jc = JR.warp_coordinates(g, jnp.asarray(ext), jnp.asarray(intr),
                                 ph, pw)
        jks, jkd, jfu, jfv = JR.tile_lookup2_blocked(g, tm_s, tm_d, jc, spans)
        tc = TR.WarpCoords(*(torch.from_numpy(np.array(a)) for a in jc))
        tks, tkd, tfu, tfv = TR.tile_lookup2_blocked(
            tm.geom, torch.from_numpy(tm_s), torch.from_numpy(tm_d), tc,
            spans)
        np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
        np.testing.assert_array_equal(tkd.numpy(), np.asarray(jkd))
        valid = np.asarray(jc.valid)
        for a, b in ((tfu, jfu), (tfv, jfv)):
            assert np.abs(a.numpy() - np.asarray(b))[valid].max() <= 1e-6
        G = TR.homographies(tm.geom, torch.from_numpy(ext),
                            torch.from_numpy(intr)).contiguous()
        kc, kks, kkd, kfu, kfv = TR.warp_lookup(
            G, torch.from_numpy(tm_s), torch.from_numpy(tm_d), ph, pw,
            (g.mpi_h, g.mpi_w), g.tile_span)
        x, y = np.asarray(jc.x), np.asarray(jc.y)
        edge = ((np.abs(x - np.round(x / sx) * sx) < 1e-3)
                | (np.abs(y - np.round(y / sy) * sy) < 1e-3)
                | (np.abs(x) < 1e-3) | (np.abs(y) < 1e-3)
                | (np.abs(x - (g.mpi_w - 1)) < 1e-3)
                | (np.abs(y - (g.mpi_h - 1)) < 1e-3))
        assert (kks.numpy() == np.asarray(jks))[~edge].all()
        assert (kkd.numpy() == np.asarray(jkd))[~edge].all()
        sel = valid & ~edge
        for a, b in ((kfu, jfu), (kfv, jfv)):
            d = np.abs(a.numpy() - np.asarray(b))
            assert (d <= 1e-4 * np.maximum(np.abs(np.asarray(b)), 1.0))[
                sel].all()


def _sparse_models(fast):
    """The JAX and port MPMesh in the sparse phase on the same random
    maps (50% static, 30% dynamic), random packed tiles and one batch."""
    argv = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
            "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "6",
            "--scale_invariant", "--learn_loop_mask",
            "--sparsity_loss_weight", "0.004",
            "--rgb_smooth_loss_weight", "0.2",
            "--a_smooth_loss_weight", "0.5", "--d_smooth_loss_weight", "0.1",
            "--l_smooth_loss_weight", "0.1", "--density_loss_weight", "0.02"]
    argv += ["--fast_stage1_grad"] if fast else []
    H, W = 24, 32
    intrin = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                      np.float32)
    ja, ta = jax_parse(argv), torch_parse(argv)
    jm = JaxMPMesh(ja, H, W, np.eye(4), intrin, 1.5, 6.0)
    tm = TorchMPMesh(ta, H, W, np.eye(4), intrin, 1.5, 6.0, device=CPU)
    g = jm.geom
    r = np.random.default_rng(8).random((g.n_planes, g.n_tiles_h,
                                         g.n_tiles_w))
    tm_s = np.full(r.shape, -1, np.int32)
    tm_d = np.full(r.shape, -1, np.int32)
    tm_s[r < 0.5] = np.arange((r < 0.5).sum(), dtype=np.int32)
    tm_d[r >= 0.7] = np.arange((r >= 0.7).sum(), dtype=np.int32)
    th, tw = g.default_tile_texels()
    jm.is_sparse, jm.has_dyn = True, True
    jm.tile_map_static, jm.tile_map_dyn, jm.tile_hw = tm_s, tm_d, (th, tw)
    tm.set_sparse(tm_s, tm_d, (th, tw))
    rng = np.random.default_rng(6)
    p = {"atlas": rng.standard_normal((int((r < 0.5).sum()), th, tw, 4)),
         "atlas_dyn": rng.standard_normal((int((r >= 0.7).sum()), th, tw,
                                           4)),
         "verts": g.vertex_grid()}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, :3, 3] = [0.1, -0.05, 0.02]
    batch = {"extrin": ext, "intrin": intrin[None].copy(),
             "rgb": rng.random((1, H, W, 3), dtype=np.float32),
             "loopmask": (rng.random((1, H, W)) < 0.5).astype(np.float32)}
    return ja, ta, jm, tm, p, batch, (H, W)


@pytest.mark.parametrize("fast", [True, False], ids=["fast_grad", "scatter"])
def test_sparse_step_matches_jax(fast):
    """The sparse-phase stage-1 loss (no loop-mask loss or l_smooth) and
    every metric within 1e-5 relative of JAX's, the atlas and atlas_dyn
    gradients within 1e-5 * max|g|, with --fast_stage1_grad (JAX's
    per-tile adjoint) on and off (its scatter); and the sparse eval
    render within 1e-5."""
    ja, ta, jm, tm, p, batch, (H, W) = _sparse_models(fast)
    weights = {k: 0.3 for k in JS1.STAGE1_WEIGHT_KEYS}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jloss = JS1.make_stage1_loss_fn(jm, ja, H, W)
    (_, jmet), jg = jax.jit(jax.value_and_grad(
        lambda q: jloss(q, jb, weights, None), has_aux=True))(jp)
    tp = tck.params_from_numpy(p, CPU)
    for t in tp.values():
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, tmet = TS1.make_stage1_loss_fn(tm, ta, H, W)(tp, tb, weights)
    total.backward()
    assert set(tmet) == set(jmet) and "l_smooth" not in tmet
    assert float(tmet["loop_bce"]) == 0.0
    for k in jmet:
        np.testing.assert_allclose(torch.as_tensor(tmet[k]).item(),
                                   float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("atlas", "atlas_dyn"):
        a = np.asarray(jg[k])
        assert np.abs(a).max() > 0
        assert np.abs(tp[k].grad.numpy() - a).max() <= 1e-5 * np.abs(a).max()
    jr = jm.forward(jp, H, W, jb["extrin"], jb["intrin"])[0]
    with torch.no_grad():
        tr = tm.forward(tp, H, W, batch["extrin"], batch["intrin"])[0]
    assert tr.shape == (1, H, W, 3)
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 1e-5


def _copy_ckpt(src, root, exp):
    d = os.path.join(root, exp, "s")
    os.makedirs(d)
    shutil.copy(src, d)


def test_train_3d_culls_and_resumes_across_packages(trained, monkeypatch):
    """Both packages resume the same JAX dense checkpoint (epoch 0, with
    partly culled, partly dynamic params) and cull at epoch 1: identical
    tile maps in the written sparse checkpoints, and the two sparse
    epochs' losses within 1e-4 relative.  Then JAX auto-resumes the
    port's sparse checkpoint and the port JAX's, at epoch 3: both losses
    finite and within 1e-4 relative of each other.  (The unfused chain's
    dense trajectories drift to ~1e-3 through Adam's sign sensitivity,
    tests/test_torch_stage1_train.py; these 9 sparse steps from one
    checkpoint agreed to 1e-6.)"""
    monkeypatch.setenv("VL3D_DATA_CACHE", "off")
    root = trained
    src = os.path.join(root, "jax_dense", "s", "ckpt_epoch_0000.npz")
    loaded = jck.load_checkpoint(src)
    p = dict(loaded["params"])
    s = _structured(loaded["geom"], 9)
    p["atlas"] = s["atlas"]
    p["atlas_mask"] = s["atlas_mask"]
    crafted = os.path.join(root, "crafted", "ckpt_epoch_0000.npz")
    jck.save_checkpoint(crafted, geom=loaded["geom"], params=p, stage="mpi",
                        extra_meta=loaded["meta"]["extra"])
    cull = ["--sparsify_epoch", "1"]
    for pkg in ("jax", "torch"):
        _copy_ckpt(crafted, root, f"cull_{pkg}")
    jax_train_3d.main(_argv(root, "cull_jax", 3, cull))
    # the port also writes the sparse previews after epoch 2 (previews
    # draw no random numbers, so the losses are unaffected)
    model, params, rundir = train_3d.main(
        _argv(root, "cull_torch", 3, cull + ["--i_video", "3"]))
    assert model.is_sparse and set(params) == {"atlas", "atlas_dyn", "verts"}
    names = os.listdir(rundir)
    for prefix in ("texture_epoch_0002_static.png", "texture_epoch_0002_dyn",
                   "mesh_epoch_0002.obj", "mesh_epoch_0002_dyn.obj",
                   "epoch_0002_rgb"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert not any(n.startswith("loopable_epoch") for n in names)
    jdir = os.path.join(root, "cull_jax", "s")
    for e in (1, 2):
        t = jck.load_checkpoint(os.path.join(rundir,
                                             f"ckpt_epoch_{e:04d}.npz"))
        j = jck.load_checkpoint(os.path.join(jdir, f"ckpt_epoch_{e:04d}.npz"))
        assert t["meta"]["is_sparse"] and t["meta"]["has_dyn"]
        assert t["meta"]["tile_hw"] == j["meta"]["tile_hw"]
        assert set(t["params"]) == set(j["params"])
        for k in ("tile_map_static", "tile_map_dyn"):
            assert t[k].dtype == np.int32
            np.testing.assert_array_equal(t[k], j[k])
    n_s = int((t["tile_map_static"] >= 0).sum())
    n_d = int((t["tile_map_dyn"] >= 0).sum())
    assert n_s > 0 and n_d > 0 and n_s + n_d < t["tile_map_dyn"].size
    t_loss, j_loss = _series(rundir, "loss"), _series(jdir, "loss")
    assert [s_ for s_, _ in t_loss] == [s_ for s_, _ in j_loss] == \
        list(range(3, 9))
    np.testing.assert_allclose([v for _, v in t_loss],
                               [v for _, v in j_loss], rtol=1e-4)
    assert _series(rundir, "warm_step_ms_sparse")

    _copy_ckpt(os.path.join(rundir, "ckpt_epoch_0002.npz"), root, "res_jax")
    _copy_ckpt(os.path.join(jdir, "ckpt_epoch_0002.npz"), root, "res_torch")
    jax_train_3d.main(_argv(root, "res_jax", 4, cull))
    model, _, rundir2 = train_3d.main(_argv(root, "res_torch", 4, cull))
    assert model.is_sparse
    r_t = _series(rundir2, "loss")
    r_j = _series(os.path.join(root, "res_jax", "s"), "loss")
    assert [s_ for s_, _ in r_t] == [s_ for s_, _ in r_j] == [9, 10, 11]
    assert np.isfinite([v for _, v in r_t + r_j]).all()
    np.testing.assert_allclose([v for _, v in r_t], [v for _, v in r_j],
                               rtol=1e-4)
    for d in (rundir2, os.path.join(root, "res_jax", "s")):
        assert jck.load_checkpoint(os.path.join(
            d, "ckpt_epoch_0003.npz"))["meta"]["is_sparse"]
