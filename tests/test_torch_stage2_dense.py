"""The dense stage-2 phase of the PyTorch port against the JAX package, on
the CPU, at a small size (D = 4 planes of 24x32 texels, F = 6 frames):
the frame-stacked plane sampler Q10 (K16/K17's plain versions) against
`bilinear_planes_tilemajor` and its `jax.vjp`; the scratch `init_params`;
the dense `lod`; a dense training render with its regularizers and
gradients, and the eval render; one scratch `make_stage2_step`; dense
checkpoints rendered across the packages' `render_video` CLIs; and the
`train_3dvid` CLI from scratch and from a dense stage-1 checkpoint, with
a resume across packages.  Inputs are made with numpy and handed to both
packages.

The dense phase takes neither --compact_hits nor --fused_render, in
either package: the tests set both (as configs/mpv_base.txt does) and
the results must not change."""
import dataclasses
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_render_slice import _assert_u8_close, _read_frames
from test_torch_stage2_train import _argv, _series
from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.core import cameras as jcam
from videoloop3d_tpu.data import llff as jllff
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.data.patches import VideoPatchDataset as JVideoDS
from videoloop3d_tpu.export import mesh_export as JME
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models.mpmesh import MPMesh as JaxMPMesh
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPMeshVid
from videoloop3d_tpu.render import sample as JS
from videoloop3d_tpu.tools import render_video as jrv
from videoloop3d_tpu.tools import train_3dvid as jax_train_3dvid
from videoloop3d_tpu.train import stage1 as JS1
from videoloop3d_tpu.train import stage2 as JS2
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.core import resize
from videoloop3d_torch.models.mpv import MPMeshVid as TorchMPMeshVid
from videoloop3d_torch.render import sample as TS
from videoloop3d_torch.tools import render_video as trv
from videoloop3d_torch.tools import train_3dvid
from videoloop3d_torch.train import stage2 as TS2

CPU = torch.device("cpu")
# 24x32 texel planes over the 24x32 views, and scratch texels N(0, 1):
# at the default init_std 0 every texel is equal, every rendered patch
# too, and the NN searches of the two packages break those exact ties by
# their summation order; the shipped route's flags, which the dense phase
# ignores
DENSE = ["--mpi_h_scale", "1.0", "--mpi_w_scale", "1.0", "--init_std", "1.0"]
SHIPPED = ["--compact_hits", "--fused_render"]


def _dargv(root, exp, extra=()):
    """test_torch_stage2_train's tiny configuration on 24x32 planes, from
    scratch unless extra names an --init_from."""
    return _argv(root, exp, DENSE + ["--init_from", ""] + list(extra))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A synthetic 3-view scene (24x32, 6 frames, seeded pixel noise as in
    test_torch_stage2_train) and a dense stage-1 checkpoint written by the
    JAX package (random texels, alphas spread over the sigmoid, a loop
    mask)."""
    root = str(tmp_path_factory.mktemp("dense"))
    scene = jsyn.make_scene(n_views=3, h=24, w=32, n_frames=6, seed=0)
    noise = np.random.default_rng(5).normal(0.0, 0.03, scene["videos"].shape)
    scene["videos"] = np.clip(scene["videos"] + noise, 0.0, 1.0)
    jsyn.write_llff_dir(scene, os.path.join(root, "scene"), factor=1)
    args, _, sc = _scene(root)
    ref = jcam.pose_to_extrinsic(jcam.average_pose(sc["poses"])[:, :4])
    m = JaxMPMesh(jax_parse(_dargv(root, "x", ["--learn_loop_mask"])),
                  *sc["hw"], ref, sc["intrins"].mean(0),
                  float(sc["bds"].min()), float(sc["bds"].max()))
    p = {k: np.asarray(v) for k, v in m.init_params(2).items()}
    rng = np.random.default_rng(12)
    p["atlas"] = rng.standard_normal(p["atlas"].shape).astype(np.float32)
    p["atlas"][..., 3] = rng.uniform(-4.0, 2.0, p["atlas"].shape[:3])
    JS1.save_stage1_checkpoint(
        os.path.join(root, "s1d", "ckpt_epoch_0002.npz"), m, p, epoch=2)
    return root


def _scene(root):
    args = jax_parse(_dargv(root, "x"))
    videos, _, scene = jllff.load_mv_videos(
        os.path.join(root, "scene"), factor=1,
        bd_factor=(args.near_factor, args.far_factor), recenter=True)
    return args, videos, scene


def _models(root, extra=()):
    """Both packages' MPMeshVid on the scene (no parameters yet)."""
    argv = _dargv(root, "x", extra)
    ja, ta = jax_parse(argv), torch_parse(argv)
    _, videos, sc = _scene(root)
    H, W = sc["hw"]
    ref = jcam.pose_to_extrinsic(jcam.average_pose(sc["poses"])[:, :4])
    near, far = float(sc["bds"].min()), float(sc["bds"].max())
    jm = JaxMPMeshVid(ja, H, W, ref, sc["intrins"][0], near, far)
    tm = TorchMPMeshVid(ta, H, W, ref, sc["intrins"][0], near, far,
                        device=CPU)
    return ja, ta, jm, tm, sc, videos


def _random_params(g, F, seed):
    """Dense params of geometry g: texels N(0, 1), alphas spread from
    fully transparent to opaque."""
    rng = np.random.default_rng(seed)
    dyn = rng.standard_normal((g.n_planes, g.mpi_h, g.mpi_w, F, 4)).astype(
        np.float32)
    dyn[..., 3] = rng.uniform(-4.0, 2.0, dyn.shape[:4])
    return {"atlas": np.zeros((0, 1, 1, 4), np.float32), "atlas_dyn": dyn,
            "verts": g.vertex_grid().astype(np.float32)}


def _edge_coords(rng, D, n, Ht, Wt):
    """(D, n) coordinates that cross every edge of the plane and land
    exactly on it (0, size - 1), on the corners' outside (-1, size) and
    between."""
    x = rng.uniform(-2.5, Wt + 1.5, (D, n)).astype(np.float32)
    y = rng.uniform(-2.5, Ht + 1.5, (D, n)).astype(np.float32)
    edges_x = np.array([0, Wt - 1, -1, Wt, -0.5, Wt - 0.5, Wt - 1.25, 0.25],
                       np.float32)
    edges_y = np.array([0, Ht - 1, -1, Ht, -0.5, Ht - 0.5, Ht - 1.25, 0.25],
                       np.float32)
    x[:, :8] = edges_x
    y[:, 8:16] = edges_y
    x[:, 16:24] = edges_x
    y[:, 16:24] = edges_y[::-1]
    return x, y


@pytest.mark.parametrize("ts", [None, [4, 0, 2, 2]], ids=["all", "ts"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bilinear_planes_tilemajor_matches_jax(dtype, ts):
    """Q10: K16's plain version (and the CPU wrapper) against
    `bilinear_planes_tilemajor` after the frame gather ``tex[..., ts, :]``
    (within 1e-6), and the atlas gradient of `sample_planes_tilemajor`
    (K17's plain version, rounded once to the texel dtype) against
    `jax.vjp` of that function over all frames: within 1e-6 * max|g| in
    f32, 2^-7 * max|g| in bf16 (JAX adds in bf16, the port in f32 and
    rounds once)."""
    D, Ht, Wt, F, C = 4, 24, 32, 6, 4
    rng = np.random.default_rng(0)
    tex = rng.standard_normal((D, Ht, Wt, F, C)).astype(np.float32)
    x, y = _edge_coords(rng, D, 200, Ht, Wt)
    sel = np.arange(F) if ts is None else np.asarray(ts)
    ct = rng.standard_normal((D, 200, len(sel), C)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jt = jnp.asarray(tex, jdt)

    def jfwd(t):
        return JS.bilinear_planes_tilemajor(t[..., sel, :], jnp.asarray(x),
                                            jnp.asarray(y))[0]

    jv, vjp = jax.vjp(jfwd, jt)
    jg = np.asarray(vjp(jnp.asarray(ct))[0].astype(jnp.float32))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tt = torch.from_numpy(np.asarray(jt.astype(jnp.float32))).to(tdt)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tts = None if ts is None else torch.tensor(ts, dtype=torch.int32)
    for fn in (TS.bilinear_planes_tilemajor_plain,
               TS.bilinear_planes_tilemajor):
        got = fn(tt, tx, ty, tts)
        assert got.dtype == torch.float32 and got.shape == jv.shape
        assert np.abs(got.numpy() - np.asarray(jv)).max() <= 1e-6
    # the gradient over all frames: the cotangent of the selected frames
    # added into their frames (a frame selected twice gets both)
    ct_all = torch.zeros((D, 200, F, C)).index_add_(
        2, torch.as_tensor(sel), torch.from_numpy(ct))
    t = tt.clone().requires_grad_(True)
    (TS.sample_planes_tilemajor(t, tx, ty) * ct_all).sum().backward()
    plain = TS.bilinear_planes_tilemajor_grad_plain(ct_all, tx, ty, tex.shape)
    assert t.grad.dtype == tdt and plain.dtype == torch.float32
    scale = np.abs(jg).max()
    tol = (2.0 ** -7 if dtype == "bf16" else 1e-6) * scale
    assert np.abs(t.grad.float().numpy() - jg).max() <= tol
    np.testing.assert_array_equal(t.grad.float().numpy(),
                                  plain.to(tdt).float().numpy())
    if dtype == "f32":
        assert np.abs(plain.numpy() - jg).max() <= tol
    with pytest.raises(RuntimeError, match="requires grad"):
        TS.sample_planes_tilemajor(t, tx, ty, torch.tensor([0],
                                                           dtype=torch.int32))


def test_init_params_matches_jax(root):
    """The scratch start: every array bit for bit the JAX package's (the
    port draws one plane at a time from the same stream)."""
    _, _, jm, tm, _, _ = _models(root)
    jp, tp = jm.init_params(3), tm.init_params(3)
    assert set(tp) == set(jp) == {"atlas", "atlas_dyn", "verts"}
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert tp["atlas_dyn"].shape == (4, 24, 32, 6, 4)
    assert tp["atlas"].shape == (0, 1, 1, 4)
    assert not tm.is_sparse and tm.geom == tm.base_geom


@pytest.mark.parametrize("chunk", [None, 1], ids=["one_slice", "per_plane"])
def test_dense_lod_matches_jax(root, chunk, monkeypatch):
    """`lod` of the dense stack down the pyramid and back up: the resized
    stack within 1e-6 of JAX's and the same scaled geometry; an unchanged
    size returns the params as they are.  The resize runs as one slice of
    the plane axis, or one plane per slice (as at full width)."""
    if chunk is not None:
        monkeypatch.setattr(resize, "CHUNK_BYTES", chunk)
    _, _, jm, tm, _, _ = _models(root)
    jp, tp = jm.init_params(4), tm.init_params(4)
    for factor in (0.5625, 0.75, 1.0, 1.0):
        same = (tm.geom.mpi_h, tm.geom.mpi_w) == (int(24 * factor),
                                                  int(32 * factor))
        jp, tp_new = jm.lod(jp, factor), tm.lod(tp, factor)
        assert (tp_new is tp) == same
        tp = tp_new
        assert dataclasses.asdict(tm.geom) == dataclasses.asdict(jm.geom)
        assert tp["atlas_dyn"].shape == jp["atlas_dyn"].shape
        assert np.abs(tp["atlas_dyn"].numpy()
                      - np.asarray(jp["atlas_dyn"])).max() <= 1e-6
    assert dataclasses.asdict(tm.base_geom) == dataclasses.asdict(jm.base_geom)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_render_matches_jax(root, dtype):
    """A dense training render under the shipped route's flags, which the
    dense phase ignores (a slot bound set as well): rgb, alpha, disparity,
    the plane stacks and `training_extras` within 1e-5 of JAX's, the atlas
    gradient of a loss over all of them within 1e-5 * max|g| (2^-7 under
    --fp16, bf16 texels); and the eval render of three frames within
    1e-5."""
    extra = SHIPPED + (["--fp16"] if dtype == "bf16" else [])
    _, _, jm, tm, sc, _ = _models(root, extra)
    jm.compact_slots = tm.compact_slots = 2
    p = _random_params(jm.geom, 6, 6)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, :3, 3] = [0.06, -0.03, 0.02]
    intr = sc["intrins"][:1].astype(np.float32)
    H, W = sc["hw"]
    rng = np.random.default_rng(7)
    ct = rng.standard_normal((6, H, W, 3)).astype(np.float32)

    def jloss(q):
        rgb, var = jm.render(q, H, W, ext, intr, None, training=True)
        extras = jm.training_extras(var, 3.5)
        return (jnp.sum(rgb * ct) + sum(extras.values()),
                (rgb, var, extras))

    (_, (jrgb, jvar, jex)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    rgb, var = tm.render(tp, H, W, ext, intr, None, training=True)
    extras = tm.training_extras(var, 3.5)
    assert set(extras) == set(jex)
    ((rgb * torch.from_numpy(ct)).sum() + sum(extras.values())).backward()
    pairs = [(rgb, jrgb)] + [(var[k], jvar[k]) for k in
                             ("alpha", "disp", "alpha_planes", "rgb_planes",
                              "blend_weight")]
    pairs += [(extras[k], jex[k]) for k in jex]
    for a, b in pairs:
        assert a.shape == b.shape
        assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-5
    a = np.asarray(jg["atlas_dyn"])
    tol = (2.0 ** -7 if dtype == "bf16" else 1e-5) * np.abs(a).max()
    assert np.abs(tp["atlas_dyn"].grad.numpy() - a).max() <= tol
    assert tp["atlas"].grad is None
    ts = [5, 0, 3]
    jr, _ = jm.render(jp, H, W, ext, intr, jnp.asarray(ts))
    with torch.inference_mode():
        tr, tv = tm.render(tp, H, W, ext, intr, ts)
    assert tr.shape == (3, H, W, 3) and set(tv) == {"alpha"}
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 1e-5


@pytest.mark.parametrize("view", [0, 2], ids=["ref", "other"])
def test_scratch_step_matches_jax(root, view):
    """One make_stage2_step from the scratch start on one patch, for the
    reference-view (alpha 0) and the other-view loss config: loss and
    metrics within 1e-5 relative of JAX's, the atlas gradient within
    1e-5 * max|g|, the parameters after Adam as in
    test_torch_stage2_train."""
    ja, ta, jm, tm, sc, videos = _models(root, SHIPPED)
    jp, tp = jm.init_params(1), tm.init_params(1)
    H, W = sc["hw"]
    cfgs = [JS2.loss_config_from_args(ja, ref=v == 0) for v in range(3)]
    ds = JVideoDS((H, W), videos, (ja.patch_h_size, ja.patch_w_size),
                  (ja.patch_h_stride, ja.patch_w_stride), sc["poses"],
                  sc["intrins"], cfgs)
    item = ds[view * (len(ds) // 3)]
    ph, pw = ds.patch_size
    cfg = item["losscfg"]
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
    tmet = step(tp, opt_init(tp), tb, lr, weights)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    a = np.asarray(jg["atlas_dyn"])
    g = tp["atlas_dyn"].grad.numpy()
    assert np.abs(a).max() > 0
    assert np.abs(g - a).max() <= 1e-5 * np.abs(a).max()
    eps = 6e-8
    p0 = before["atlas_dyn"].numpy()
    ulps = 4 * np.spacing(np.abs(p0).max())
    new = tp["atlas_dyn"].detach().numpy()
    assert np.abs(new - (p0 - lr * g / (np.abs(g) + eps))).max() <= ulps
    firm = np.minimum(np.abs(a), np.abs(g)) > 1e3 * eps
    assert firm.sum() > 100
    diff = np.abs(new - np.asarray(jnew["atlas_dyn"]))
    assert diff[firm].max() <= 1e-5 * lr + ulps
    assert diff.max() <= 2 * lr
    for k in ("atlas", "verts"):
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(jnew[k]))


def _render_argv(root, exp, name, extra=()):
    return ["--datadir", os.path.join(root, "scene"), "--expdir",
            os.path.join(root, exp), "--expname", name, "--factor", "1",
            "--mpv_frm_num", "6", "--gpu_num", "0", "--v", "0", "--t",
            "0:6", "--type", "seq", *extra]


def _write_run(root, exp, case):
    """One run directory per package holding the same dense checkpoint:
    a JAX-written mpv one, the fixture's JAX-written stage-1 one, or a
    port-written mpv one."""
    for pkg in ("jax", "torch"):
        os.makedirs(os.path.join(root, exp, pkg))
    if case == "jax_stage1":
        src = os.path.join(root, "s1d", "ckpt_epoch_0002.npz")
    else:
        src = os.path.join(root, exp, "ckpt_l1_epoch_0000.npz")
        _, _, jm, tm, sc, _ = _models(root)
        p = _random_params(jm.geom, 6, 9)
        meta = (1, 0, 0, 0, 1.0, sc["hw"])
        if case == "jax_mpv":
            JS2.save_stage2_checkpoint(src, jm, p, *meta)
        else:
            TS2.save_stage2_checkpoint(src, tm, p, *meta)
    for pkg in ("jax", "torch"):
        shutil.copy(src, os.path.join(root, exp, pkg))


@pytest.mark.parametrize("fp16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["jax_mpv", "jax_stage1", "torch_mpv"])
def test_dense_checkpoints_render_across_packages(root, case, fp16):
    """A dense checkpoint, mpv or stage 1 (broadcast over the 6 frames),
    written by either package, rendered by both `render_video` CLIs
    (fixed view 0, frames 0-5): the same frames within one u8 step except
    on at most 0.1% of the pixels, and not a constant image."""
    exp = f"render_{case}_{fp16}"
    _write_run(root, exp, case)
    extra = ["--fp16"] if fp16 else []
    jrv.main(_render_argv(root, exp, "jax", extra))
    frames = trv.main(_render_argv(root, exp, "torch", extra))
    jf = _read_frames(os.path.join(root, exp, "jax", "renderonly"))
    tf = _read_frames(os.path.join(root, exp, "torch", "renderonly"))
    assert tf.shape == (6, 24, 32, 3) and tf.std() > 1.0
    np.testing.assert_array_equal(np.stack(frames), tf)
    _assert_u8_close(tf, jf)


@pytest.mark.parametrize("case", ["scratch", "dense_init"])
def test_train_3dvid_dense_matches_jax(root, case):
    """Both CLIs over the two levels (one epoch each, 3 + 3 steps) from
    scratch or from the dense stage-1 checkpoint, under the shipped
    route's flags: the same loss series within 1e-4 relative and the same
    dense ckpt_l1_epoch_0000.npz layout.  From scratch, each package then
    auto-resumes the other's checkpoint with --pyr_num_epoch 2: losses
    finite and within 1e-4 relative of each other.  The ref view runs at
    alpha off, as in test_torch_stage2_train (near ties of the NN
    search)."""
    extra = SHIPPED + ["--swd_alpha_ref", "10000"]
    if case == "dense_init":
        extra += ["--init_from", os.path.join(root, "s1d",
                                              "ckpt_epoch_0002.npz")]
    jax_train_3dvid.main(_dargv(root, f"jax_{case}", extra))
    model, params, rundir = train_3dvid.main(_dargv(root, f"torch_{case}",
                                                    extra))
    assert not model.is_sparse and params["atlas_dyn"].shape == (4, 24, 32,
                                                                 6, 4)
    jdir = os.path.join(root, f"jax_{case}", "s")
    t_loss, j_loss = _series(rundir, "loss"), _series(jdir, "loss")
    assert [s for s, _ in t_loss] == [s for s, _ in j_loss] == \
        list(range(6))
    assert np.isfinite([v for _, v in t_loss]).all()
    np.testing.assert_allclose([v for _, v in t_loss],
                               [v for _, v in j_loss], rtol=1e-4)
    name = "ckpt_l1_epoch_0000.npz"
    t = jck.load_checkpoint(os.path.join(rundir, name))
    j = jck.load_checkpoint(os.path.join(jdir, name))
    for key in ("stage", "is_sparse", "has_dyn", "tile_hw", "frm_num",
                "extra", "param_keys", "geometry"):
        assert t["meta"][key] == j["meta"][key], key
    assert t["tile_map_static"] is None and t["tile_map_dyn"] is None
    for k in t["params"]:
        assert t["params"][k].shape == j["params"][k].shape
    if case != "scratch":
        return
    more = extra + ["--pyr_num_epoch", "2"]
    for src, dst in ((rundir, "res_jax"), (jdir, "res_torch")):
        d = os.path.join(root, dst, "s")
        os.makedirs(d)
        shutil.copy(os.path.join(src, name), d)
    jax_train_3dvid.main(_dargv(root, "res_jax", more))
    _, _, rundir2 = train_3dvid.main(_dargv(root, "res_torch", more))
    r_t = _series(rundir2, "loss")
    r_j = _series(os.path.join(root, "res_jax", "s"), "loss")
    assert [s for s, _ in r_t] == [s for s, _ in r_j] == list(range(6, 9))
    assert np.isfinite([v for _, v in r_t + r_j]).all()
    np.testing.assert_allclose([v for _, v in r_t], [v for _, v in r_j],
                               rtol=1e-4)


def test_train_3dvid_dense_preview(root):
    """A dense run's i_video artifacts: the spiral frames and the mesh
    preview of every tile as the dynamic mesh, byte for byte the JAX
    package's `save_mesh_preview` of `full_tile_map`."""
    model, _, rundir = train_3dvid.main(_dargv(
        root, "preview", ["--pyr_init_level", "1", "--i_video", "1"]))
    ref = os.path.join(root, "preview_ref")
    JME.save_mesh_preview(model.geom, None, JME.full_tile_map(model.geom),
                          ref)
    with open(os.path.join(rundir, "mesh_l1_0000_dyn.obj")) as a, \
            open(ref + "_dyn.obj") as b:
        assert a.read() == b.read()
    assert not os.path.exists(os.path.join(rundir, "mesh_l1_0000.obj"))
    assert any(f.startswith("l1_0000_rgb") for f in os.listdir(rundir))
